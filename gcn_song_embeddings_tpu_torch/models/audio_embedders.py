"""Audio embedding networks (OpenL3, VGGish, MusicNN) as ``nn.Module``s.

The port of the JAX package's ``models/audio_embedders.py``.  Each net
runs NCHW with OIHW convolution weights; its weights are held under the
JAX tree's dotted names (``block0.conv0.w`` is the module
``block0.conv0``'s ``weight``), so one ``.npz`` serves both packages:
``save_weights`` writes the JAX layout (HWIO convolutions, fc ``[din,
dout]``) and ``load_tree(net, load_weights(path))`` reads it
(``params_from_jax``).

Without weights a net is seeded random-init (He-normal from a CPU
``torch.Generator``, so the same seed gives the same weights on every
device; the JAX package draws from threefry, so its random-init features
differ by design) and ``warn_untrained`` says the features are untrained.

The nets and their front ends compute in true f32: every forward turns
TF32 off for its convolutions and matrix products and restores the
caller's setting (``ops.knn.exact_f32``).  Nine stacked TF32
convolutions would err ~1e-3, the whole tolerance of the checks.  Under
the matmul precision policy (``utils.precision``) the convolutions and
dense layers run in one or three bf16 passes, the bias added in f32
after, as the JAX package's run at its default precision on the TPU;
batch norm, pooling and activations stay f32.

Shapes follow the published models:

  OpenL3 (mel128 / music / 512): 48 kHz, 1 s windows every 2 s; mel
    n_fft 2048, hop 242, 128 mels, center-padded -> [128, 199] dB
    (ref-max, 80 dB floor); input BN, conv blocks [64,64] [128,128]
    [256,256] [512,512] (3x3 same + BN + ReLU, none after the last conv)
    with 2x2 max-pools between blocks, then a (16, 24) max-pool -> 512.
  VGGish (AudioSet, 128): 16 kHz, 0.96 s patches of 96 frames x 64
    log-mel bands (400-sample symmetric Hann window, 512-point FFT,
    magnitude, 125-7500 Hz, log(mel + 0.01)); convs 64, 128, 256x2,
    512x2 with 2x2 pools, an (H, W, C) flatten, fc 4096-4096-128 (ReLU).
  MusicNN (MTT_musicnn, 753 max_pool): 16 kHz, 3 s patches of 187 frames
    x 96 log-mels; timbral and temporal front-end convs (ReLU before BN,
    TF 'SAME' time padding, asymmetric for even kernels), three residual
    midend convs, temporal max / mean pools, interleaved backend.

The checkpoint converters (``convert_openl3``, ``convert_vggish``,
``convert_musicnn``) are numpy over a state_dict or a TF variable dict and
give the JAX package's trees array for array.
"""

from __future__ import annotations

import re
import sys

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gcn_song_embeddings_tpu_torch.features import (
    SAMPLE_RATE,
    frontend_tables,
    mel_power,
    resample_linear,
)
from gcn_song_embeddings_tpu_torch.ops.agg import (
    conv2d,
    linear,
    policy_passes,
)
from gcn_song_embeddings_tpu_torch.ops.knn import exact_f32
from gcn_song_embeddings_tpu_torch.utils.device import resolve_device


class BatchNorm(nn.Module):
    """Inference batch norm over dim 1: ``(x - mean) / sqrt(var + eps) *
    gamma + beta``; the four statistics are buffers under the JAX names."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.register_buffer("gamma", torch.ones(channels))
        self.register_buffer("beta", torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = 1.0 / torch.sqrt(self.var + self.eps)
        return ((x - self.mean.view(shape)) * inv.view(shape)
                * self.gamma.view(shape) + self.beta.view(shape))


def _he_normal_(net: nn.Module, seed: int) -> nn.Module:
    """He-normal weights (std sqrt(2 / fan_in)) and zero biases for every
    convolution and linear layer, drawn in module order from a CPU
    generator seeded with ``seed``."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen)
                                 * float(np.sqrt(2.0 / fan_in)))
                mod.bias.zero_()
    return net


class _Net(nn.Module):
    @classmethod
    def build(cls, seed: int = 0, device=None) -> "_Net":
        """The net, seeded random-init, in eval mode on ``device``."""
        dev = resolve_device(device)
        return _he_normal_(cls(), seed).to(dev).eval()


def _conv(mod: nn.Conv2d, x: torch.Tensor, passes: int | None
          ) -> torch.Tensor:
    """``mod(x)``, or in ``passes`` bf16 passes where given (the matmul
    precision policy), the bias added in f32 after."""
    if passes is None:
        return mod(x)
    return conv2d(x, mod.weight, passes, bias=mod.bias, stride=mod.stride,
                  padding=mod.padding, dilation=mod.dilation,
                  groups=mod.groups)


def _linear(mod: nn.Linear, x: torch.Tensor, passes: int | None
            ) -> torch.Tensor:
    """``mod(x)``, or in ``passes`` bf16 passes where given."""
    if passes is None:
        return mod(x)
    return linear(x, mod.weight, mod.bias, passes)


def run_net(net: nn.Module, x: torch.Tensor, **kwargs) -> torch.Tensor:
    """``net(x)`` without autograd."""
    with torch.inference_mode():
        return net(x, **kwargs)


# ----------------------------------------------------- weights <-> .npz


def flatten_params(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> {dotted name: array} (the ``.npz`` layout)."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_params(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def unflatten_params(flat: dict) -> dict:
    tree: dict = {}
    for name, v in flat.items():
        parts = name.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(v)
    return tree


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """A JAX weight tree -> the net's state_dict: ``w`` becomes ``weight``
    (HWIO convolutions -> OIHW, fc ``[din, dout]`` -> ``[dout, din]``),
    ``b`` becomes ``bias``, batch-norm statistics keep their names."""
    out = {}
    for name, v in flatten_params(tree).items():
        prefix, leaf = name.rsplit(".", 1)
        v = np.asarray(v, dtype=np.float32)
        if leaf == "w":
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
            name = f"{prefix}.weight"
        elif leaf == "b":
            name = f"{prefix}.bias"
        out[name] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def _jax_leaf(name: str, v: np.ndarray) -> tuple[str, np.ndarray]:
    """A state_dict entry -> its JAX name and layout (the inverse of
    ``params_from_jax``)."""
    prefix, leaf = name.rsplit(".", 1)
    if leaf == "weight":
        v = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T
        name = f"{prefix}.w"
    elif leaf == "bias":
        name = f"{prefix}.b"
    return name, np.ascontiguousarray(v)


def tree_from_net(net: nn.Module) -> dict:
    """The net's weights as a JAX tree (numpy, JAX layouts)."""
    return unflatten_params(dict(
        _jax_leaf(name, t.detach().cpu().numpy())
        for name, t in net.state_dict().items()))


def load_tree(net: nn.Module, tree: dict) -> nn.Module:
    """Load a JAX weight tree into ``net`` (every name must match)."""
    net.load_state_dict(params_from_jax(tree), strict=True)
    return net


def save_weights(params, path: str) -> None:
    """Write a net's weights (or a JAX tree) as an ``.npz`` in the JAX
    package's layout."""
    tree = tree_from_net(params) if isinstance(params, nn.Module) else params
    np.savez(path, **flatten_params(tree))


def load_weights(path: str) -> dict:
    with np.load(path) as z:
        return unflatten_params({k: z[k] for k in z.files})


def template_tree(net_cls) -> dict:
    """A zero tree of the net's JAX names and shapes (built on the meta
    device, so no weights are allocated)."""
    with torch.device("meta"):
        net = net_cls()
    return unflatten_params(dict(
        _jax_leaf(name, np.zeros(tuple(t.shape), np.float32))
        for name, t in net.state_dict().items()))


_warned: set = set()


def warn_untrained(name: str) -> None:
    if name not in _warned:
        _warned.add(name)
        print(f"WARNING: {name} running with RANDOM-INIT weights — features "
              "are untrained structured projections. Pass weights_path= "
              "(npz from the official release) for real embeddings.",
              file=sys.stderr)


def _host_resample(clips: np.ndarray, sr: int, target: int) -> np.ndarray:
    clips = np.atleast_2d(np.asarray(clips, dtype=np.float32))
    if sr != target:
        clips = np.stack([resample_linear(c, sr, target) for c in clips])
    return clips


def _patches(logmel: torch.Tensor, frames: int) -> tuple[torch.Tensor, int]:
    """[B, F, M] -> ([B*P, frames, M] non-overlapping patches, P), zero
    frames appended when F < frames."""
    n_frames = logmel.shape[1]
    n_patches = max(n_frames // frames, 1)
    if n_frames < frames:
        logmel = F.pad(logmel, (0, 0, 0, frames - n_frames))
    patches = logmel[:, :n_patches * frames]
    return patches.reshape(-1, frames, logmel.shape[2]), n_patches


# ---------------------------------------------------------------- OpenL3

OPENL3_SR = 48_000
OPENL3_NFFT = 2048
OPENL3_HOP = 242
OPENL3_MELS = 128
OPENL3_FRAMES = 199  # 1 + floor(48000 / 242), center-padded
_L3_BLOCKS = ((1, 64), (64, 128), (128, 256), (256, 512))


class _L3Block(nn.Module):
    def __init__(self, cin: int, cout: int, last: bool):
        super().__init__()
        self.conv0 = nn.Conv2d(cin, cout, 3, padding=1)
        self.bn0 = BatchNorm(cout)
        self.conv1 = nn.Conv2d(cout, cout, 3, padding=1)
        # the final conv (audio_embedding_layer) has no BN after it
        self.bn1 = None if last else BatchNorm(cout)

    def forward(self, x, passes=None):
        x = F.relu(self.bn0(_conv(self.conv0, x, passes)))
        x = _conv(self.conv1, x, passes)
        if self.bn1 is not None:
            x = F.max_pool2d(F.relu(self.bn1(x)), 2)
        return x


class OpenL3Net(_Net):
    """The L3-Net audio subnetwork (torchopenl3 mel128/music/512): an
    input BN, four conv blocks and a (16, 24) max-pool: [B, 128, 199] dB
    mel windows -> [B, 512]."""

    def __init__(self):
        super().__init__()
        self.bn_in = BatchNorm(1)
        for bi, (cin, cout) in enumerate(_L3_BLOCKS):
            setattr(self, f"block{bi}", _L3Block(cin, cout, bi == 3))

    def forward(self, mel_db: torch.Tensor) -> torch.Tensor:
        passes = policy_passes(mel_db)
        with exact_f32():
            x = self.bn_in(mel_db[:, None])
            for bi in range(len(_L3_BLOCKS)):
                x = getattr(self, f"block{bi}")(x, passes)
            return F.max_pool2d(x, (16, 24)).reshape(x.shape[0], -1)


def openl3_mel_windows(clips: np.ndarray, sr: int = SAMPLE_RATE,
                       window_s: float = 1.0, hop_s: float = 2.0,
                       device=None) -> tuple[torch.Tensor, int]:
    """[B, samples] at ``sr`` -> ([B*W, 128, 199] mel-dB windows on the
    device, W windows a clip): resampled to 48 kHz on the host, 1 s
    windows every ``hop_s``, the OpenL3 mel front end, dB scaled to the
    window's maximum with an 80 dB floor (kapre's amplitude_to_decibel)."""
    dev = resolve_device(device)
    clips = _host_resample(clips, sr, OPENL3_SR)
    win = int(OPENL3_SR * window_s)
    hop = int(OPENL3_SR * hop_s)
    x = torch.as_tensor(clips, device=dev)
    if x.shape[1] < win:
        x = F.pad(x, (0, win - x.shape[1]))
    wins = x.unfold(1, win, hop)                          # [B, W, win]
    n_win = wins.shape[1]
    fb, window = frontend_tables(OPENL3_MELS, OPENL3_NFFT, OPENL3_SR, dev)
    mel = mel_power(wins.reshape(-1, win), fb, window, OPENL3_NFFT,
                    OPENL3_HOP, center=True)              # [BW, F, mels]
    mel = mel.transpose(1, 2)[:, :, :OPENL3_FRAMES]
    if mel.shape[2] < OPENL3_FRAMES:
        mel = F.pad(mel, (0, OPENL3_FRAMES - mel.shape[2]))
    db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    db = db - db.amax(dim=(1, 2), keepdim=True)
    return torch.clamp(db, min=-80.0), n_win


# ---------------------------------------------------------------- VGGish

VGGISH_SR = 16_000
VGGISH_MELS = 64
VGGISH_FRAMES = 96
_VGG_CONVS = ((1, 64), (64, 128), (128, 256), (256, 256), (256, 512),
              (512, 512))
_VGG_LAYOUT = ((0,), (1,), (2, 3), (4, 5))  # conv indices per pool group


class VGGishNet(_Net):
    """AudioSet VGGish: [B, 96, 64] log-mel patches -> [B, 128]."""

    def __init__(self):
        super().__init__()
        for i, (cin, cout) in enumerate(_VGG_CONVS):
            setattr(self, f"conv{i}", nn.Conv2d(cin, cout, 3, padding=1))
        self.fc0 = nn.Linear(6 * 4 * 512, 4096)
        self.fc1 = nn.Linear(4096, 4096)
        self.fc2 = nn.Linear(4096, 128)

    def forward(self, log_mel: torch.Tensor) -> torch.Tensor:
        passes = policy_passes(log_mel)
        with exact_f32():
            x = log_mel[:, None]
            for group in _VGG_LAYOUT:
                for ci in group:
                    x = F.relu(_conv(getattr(self, f"conv{ci}"), x, passes))
                x = F.max_pool2d(x, 2)
            # VGGish flattens (H, W, C): permute, or fc0 reads scrambled
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
            x = F.relu(_linear(self.fc0, x, passes))
            x = F.relu(_linear(self.fc1, x, passes))
            return F.relu(_linear(self.fc2, x, passes))


def vggish_log_mel_patches(clips: np.ndarray, sr: int = SAMPLE_RATE,
                           device=None) -> tuple[torch.Tensor, int]:
    """[B, samples] at ``sr`` -> ([B*P, 96, 64] log-mel patches on the
    device, P patches a clip): 16 kHz, Google's mel_features convention (a
    400-sample symmetric Hann window, 160 hop, frames zero-padded to a
    512-point FFT, magnitude, 125-7500 Hz), log(mel + 0.01), 0.96 s
    patches."""
    dev = resolve_device(device)
    clips = _host_resample(clips, sr, VGGISH_SR)
    n_fft, win_length, hop = 512, 400, 160
    fb, window = frontend_tables(VGGISH_MELS, n_fft, VGGISH_SR, dev,
                                 fmin=125.0, fmax=7500.0,
                                 win_length=win_length, periodic=False)
    mel = mel_power(torch.as_tensor(clips, device=dev), fb, window, n_fft,
                    hop, center=False, power=1.0)         # [B, F, 64]
    return _patches(torch.log(mel + 0.01), VGGISH_FRAMES)


# ------------------------------------------------- checkpoint conversion
# A PyTorch state_dict (torchopenl3 audio model, torchvggish) onto the
# JAX trees, matched by ORDERED KIND + SHAPE, not by name: releases
# disagree on naming, but the architecture fixes the order of conv /
# batch-norm / fc tensors (torch conv OIHW -> HWIO, fc [out, in] ->
# [in, out]).  CLI: ``python -m
# gcn_song_embeddings_tpu_torch.convert_audio_weights``.


def _iter_source_tensors(state_dict):
    """(name, numpy array) in insertion order, without 0-d buffers such as
    num_batches_tracked."""
    for name, t in state_dict.items():
        arr = np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                         else t)
        if arr.ndim == 0:
            continue
        yield name, arr


def collect_streams(state_dict, bn_names=("bn", "batchnorm", "batch_norm",
                                          "running_")):
    """Split a state_dict into ordered streams, pairing conv and fc weights
    with the 1-D bias that follows them and BN statistics with their
    layer."""
    conv, fc, bn = [], [], []
    items = list(_iter_source_tensors(state_dict))
    i = 0
    while i < len(items):
        name, arr = items[i]
        low = name.lower()
        if arr.ndim == 4:                       # conv weight (+ maybe bias)
            w = arr.transpose(2, 3, 1, 0)
            b = None
            if i + 1 < len(items) and items[i + 1][1].ndim == 1 and \
                    "bias" in items[i + 1][0].lower() and \
                    items[i + 1][1].shape[0] == w.shape[3]:
                b = items[i + 1][1]
                i += 1
            conv.append((w, b))
        elif arr.ndim == 2:                     # fc weight (+ maybe bias)
            w = arr.T
            b = None
            if i + 1 < len(items) and items[i + 1][1].ndim == 1 and \
                    items[i + 1][1].shape[0] == w.shape[1]:
                b = items[i + 1][1]
                i += 1
            fc.append((w, b))
        elif arr.ndim == 1 and any(k in low for k in bn_names):
            # torch BN order: weight, bias, running_mean, running_var
            beta, mean, var = (items[i + 1][1], items[i + 2][1],
                               items[i + 3][1])
            i += 3
            bn.append({"gamma": arr, "beta": beta, "mean": mean, "var": var})
        i += 1
    return conv, fc, bn


def _fill_conv(slot, conv_stream):
    w, b = conv_stream.pop(0)
    if w.shape != slot["w"].shape:
        raise ValueError(f"conv weight {w.shape}, expected "
                         f"{slot['w'].shape}")
    slot["w"] = w.astype(np.float32)
    if b is not None:
        slot["b"] = b.astype(np.float32)


def _fill_bn(slot, bn_stream):
    p = bn_stream.pop(0)
    for k in ("gamma", "beta", "mean", "var"):
        if p[k].shape != slot[k].shape:
            raise ValueError(f"BN {k} {p[k].shape}, expected "
                             f"{slot[k].shape}")
        slot[k] = p[k].astype(np.float32)


def convert_openl3(state_dict) -> dict:
    """A torchopenl3 audio-model state_dict (keras-named
    ``batch_normalization_1..8``, ``conv2d_1..7``,
    ``audio_embedding_layer``) onto the OpenL3 tree."""
    params = template_tree(OpenL3Net)
    conv, _fc, bn = collect_streams(state_dict)
    if len(conv) != 8 or len(bn) != 8:
        raise ValueError(f"expected 8 convs and 8 BN layers, found "
                         f"{len(conv)} and {len(bn)}")
    _fill_bn(params["bn_in"], bn)
    for bi in range(4):
        blk = params[f"block{bi}"]
        _fill_conv(blk["conv0"], conv)
        _fill_bn(blk["bn0"], bn)
        _fill_conv(blk["conv1"], conv)
        if bi < 3:
            _fill_bn(blk["bn1"], bn)
    return params


def convert_vggish(state_dict) -> dict:
    """A torchvggish state_dict onto the VGGish tree."""
    params = template_tree(VGGishNet)
    conv, fc, _bn = collect_streams(state_dict)
    if len(conv) != 6 or len(fc) != 3:
        raise ValueError(f"expected 6 convs and 3 fc layers, found "
                         f"{len(conv)} and {len(fc)}")
    for i in range(6):
        _fill_conv(params[f"conv{i}"], conv)
    for i in range(3):
        _fill_conv(params[f"fc{i}"], fc)
    return params


def _tf_layer_records(variables) -> list:
    """TF-1 checkpoint variables grouped into per-layer records by name
    prefix (``model/conv2d_3/kernel`` + ``.../bias``), natural-sorted by
    prefix (tf.layers appends ``_<n>`` in creation order)."""
    by_prefix: dict = {}
    for name, arr in variables.items():
        arr = np.asarray(arr)
        if "/" not in name:
            continue
        prefix, leaf = name.rsplit("/", 1)
        by_prefix.setdefault(prefix, {})[leaf.lower()] = arr

    def natkey(prefix):
        return [int(t) if t.isdigit() else t
                for t in re.split(r"(\d+)", prefix)]

    records = []
    for prefix in sorted(by_prefix, key=natkey):
        leaves = by_prefix[prefix]
        rec = {"prefix": prefix, "leaves": leaves}
        if "kernel" in leaves or "weights" in leaves or "w" in leaves:
            k = leaves.get("kernel", leaves.get("weights", leaves.get("w")))
            rec["kind"] = "conv" if k.ndim == 4 else "dense"
            rec["w"] = k
            rec["b"] = leaves.get("bias", leaves.get("biases",
                                                     leaves.get("b")))
        elif "gamma" in leaves or "moving_mean" in leaves:
            rec["kind"] = "bn"
            rec["bn"] = {
                "gamma": leaves.get("gamma"),
                "beta": leaves.get("beta"),
                "mean": leaves.get("moving_mean", leaves.get("mean")),
                "var": leaves.get("moving_variance",
                                  leaves.get("variance", leaves.get("var"))),
            }
        else:
            continue
        records.append(rec)
    return records


def _take_by_shape(records, kind, shape, used):
    """The first unconsumed record of ``kind`` whose kernel shape (or BN
    gamma shape) is ``shape``."""
    for i, rec in enumerate(records):
        if i in used or rec.get("kind") != kind:
            continue
        if kind in ("conv", "dense") and tuple(rec["w"].shape) != shape:
            continue
        if kind == "bn" and rec["bn"]["gamma"].shape != shape:
            continue
        used.add(i)
        return rec
    raise ValueError(f"no unconsumed {kind} variable of shape {shape} in "
                     f"checkpoint (prefixes: "
                     f"{[r['prefix'] for r in records]})")


# ---------------------------------------------------------------- MusicNN

MUSICNN_SR = 16_000
MUSICNN_MELS = 96
MUSICNN_FRAMES = 187          # 3 s at 16 kHz, hop 256
# the MTT_musicnn layer spec, transcribed from jordipons/musicnn
# models.py (build_musicnn: frontend 'timbral_temporal' num_filt=1.6,
# midend 64, backend 200/50), as the JAX package states it
MUSICNN_SPEC: dict = {
    "bn_eps": 1e-3,
    "input_frames": 187, "input_mels": 96,
    "conv_order": "conv_relu_then_bn",
    "timbral": ((7, 38, 204), (7, 67, 204)),       # (kt, kf, ch)
    "temporal": ((128, 51), (64, 51), (32, 51)),   # (kt, ch) creation order
    "midend": {"n_layers": 3, "kt": 7, "ch": 64, "residual_from": 1},
    "backend": {"pools": ("max", "mean"), "flatten": "interleaved",
                "penultimate": 200, "classes": 50},
}
_MCNN_TIMBRAL = MUSICNN_SPEC["timbral"]
_MCNN_TEMPORAL = MUSICNN_SPEC["temporal"]
_MCNN_MID_CH = MUSICNN_SPEC["midend"]["ch"]
MUSICNN_FRONT = (sum(c for _, _, c in _MCNN_TIMBRAL)
                 + sum(c for _, c in _MCNN_TEMPORAL))           # 561
MUSICNN_POOL = MUSICNN_FRONT + MUSICNN_SPEC["midend"]["n_layers"] \
    * _MCNN_MID_CH                                              # 753
MUSICNN_PENULT = MUSICNN_SPEC["backend"]["penultimate"]
_MCNN_CLASSES = MUSICNN_SPEC["backend"]["classes"]
MUSICNN_TAPS = {"max_pool": MUSICNN_POOL, "mean_pool": MUSICNN_POOL,
                "penultimate": MUSICNN_PENULT, "taggram": _MCNN_CLASSES}


def tf_same_pad(k: int) -> tuple[int, int]:
    """TF 'SAME' padding for stride 1: (k-1)//2 before, k//2 after
    (asymmetric for even kernels)."""
    return ((k - 1) // 2, k // 2)


class _ConvBN(nn.Module):
    """Conv (VALID, after an explicit TF 'SAME' pad along time), ReLU,
    then BN: tf.layers runs the activation inside the conv."""

    def __init__(self, cin: int, cout: int, kt: int, kf: int, eps: float):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, (kt, kf))
        self.bn = BatchNorm(cout, eps)
        self.pad = tf_same_pad(kt)

    def forward(self, x, passes=None):
        # F.pad lists the last dim first: (mel, mel, time before, after)
        x = F.pad(x, (0, 0) + self.pad)
        return self.bn(F.relu(_conv(self.conv, x, passes)))


class MusicNNNet(_Net):
    """MTT_musicnn: [B, 187, 96] log-mel patches -> the ``feature`` tap:
    'max_pool' [B, 753], 'mean_pool' [B, 753], 'penultimate' [B, 200] or
    'taggram' [B, 50]."""

    def __init__(self):
        super().__init__()
        eps = MUSICNN_SPEC["bn_eps"]
        self.bn_in = BatchNorm(1, eps)
        for i, (kt, kf, ch) in enumerate(_MCNN_TIMBRAL):
            setattr(self, f"timbral{i}", _ConvBN(1, ch, kt, kf, eps))
        for i, (kt, ch) in enumerate(_MCNN_TEMPORAL):
            setattr(self, f"temporal{i}", _ConvBN(1, ch, kt, 1, eps))
        mid = MUSICNN_SPEC["midend"]
        for i in range(mid["n_layers"]):
            cin = MUSICNN_FRONT if i == 0 else _MCNN_MID_CH
            setattr(self, f"mid{i}", _ConvBN(cin, _MCNN_MID_CH, mid["kt"], 1,
                                             eps))
        self.bn_pool = BatchNorm(2 * MUSICNN_POOL, eps)
        self.dense = nn.Linear(2 * MUSICNN_POOL, MUSICNN_PENULT)
        self.bn_dense = BatchNorm(MUSICNN_PENULT, eps)
        self.dense_out = nn.Linear(MUSICNN_PENULT, _MCNN_CLASSES)

    def forward(self, log_mel: torch.Tensor,
                feature: str = "max_pool") -> torch.Tensor:
        if feature not in MUSICNN_TAPS:
            raise ValueError(f"feature {feature!r}: one of "
                             f"{sorted(MUSICNN_TAPS)}")
        passes = policy_passes(log_mel)
        with exact_f32():
            x = self.bn_in(log_mel[:, None])              # [B, 1, T, M]
            feats = []
            for i in range(len(_MCNN_TIMBRAL)):
                # timbral: VALID in mel, max over the mel left after it
                feats.append(getattr(self, f"timbral{i}")(x, passes)
                             .amax(dim=3))
            for i in range(len(_MCNN_TEMPORAL)):
                # temporal: [k, 1] over the whole normalized spectrogram,
                # then the max over every mel band
                feats.append(getattr(self, f"temporal{i}")(x, passes)
                             .amax(dim=3))
            front = torch.cat(feats, dim=1)               # [B, 561, T]
            mid = MUSICNN_SPEC["midend"]
            mids = []
            h = front
            for i in range(mid["n_layers"]):
                h = getattr(self, f"mid{i}")(h[:, :, :, None],
                                             passes)[:, :, :, 0]
                if i >= mid["residual_from"]:
                    h = h + mids[-1]
                mids.append(h)
            full = torch.cat([front] + mids, dim=1)       # [B, 753, T]
            mx = full.amax(dim=2)
            if feature == "max_pool":
                return mx
            mn = full.mean(dim=2)
            if feature == "mean_pool":
                return mn
            # the backend's flatten interleaves (max_c, mean_c)
            flat = self.bn_pool(torch.stack([mx, mn], dim=-1)
                                .reshape(mx.shape[0], -1))
            pen = self.bn_dense(F.relu(_linear(self.dense, flat, passes)))
            if feature == "penultimate":
                return pen
            return torch.sigmoid(_linear(self.dense_out, pen, passes))


def musicnn_log_mel_patches(clips: np.ndarray, sr: int = SAMPLE_RATE,
                            device=None) -> tuple[torch.Tensor, int]:
    """[B, samples] at ``sr`` -> ([B*P, 187, 96] log-mel patches on the
    device, P patches a clip): 16 kHz, n_fft 512, hop 256, 96 mels,
    center-padded (librosa's framing), log10(max(mel, 1e-10) + 1e-6),
    non-overlapping 3 s patches."""
    dev = resolve_device(device)
    clips = _host_resample(clips, sr, MUSICNN_SR)
    n_fft, hop = 512, 256
    fb, window = frontend_tables(MUSICNN_MELS, n_fft, MUSICNN_SR, dev)
    mel = mel_power(torch.as_tensor(clips, device=dev), fb, window, n_fft,
                    hop, center=True)
    logmel = torch.log10(torch.clamp(mel, min=1e-10) + 1e-6)
    return _patches(logmel, MUSICNN_FRAMES)


def convert_musicnn(variables) -> dict:
    """A musicnn TF-1 checkpoint's variables (name -> array, HWIO kernels)
    onto the MusicNN tree, matched by (kind, shape) in natural prefix
    order.  Raises ValueError naming the tensor that does not line up."""
    params = template_tree(MusicNNNet)
    records = _tf_layer_records(variables)
    used: set = set()

    def fill_conv(slot, shape, transpose=None):
        rec = _take_by_shape(records, "conv", shape, used)
        w = rec["w"] if transpose is None else rec["w"].transpose(transpose)
        if w.shape != slot["conv"]["w"].shape:
            raise ValueError(f"{rec['prefix']}: kernel {w.shape}, expected "
                             f"{slot['conv']['w'].shape}")
        slot["conv"]["w"] = w.astype(np.float32)
        if rec.get("b") is not None:
            slot["conv"]["b"] = rec["b"].astype(np.float32)

    def fill_bn(slot, ch):
        rec = _take_by_shape(records, "bn", (ch,), used)
        for k in ("gamma", "beta", "mean", "var"):
            arr = rec["bn"][k]
            if arr is None:
                raise ValueError(f"BN layer {rec['prefix']} missing {k}")
            if arr.shape != slot[k].shape:
                raise ValueError(f"BN layer {rec['prefix']}: {k} "
                                 f"{arr.shape}, expected {slot[k].shape}")
            slot[k] = arr.astype(np.float32)

    def fill_fc(slot, shape):
        rec = _take_by_shape(records, "dense", shape, used)
        slot["w"] = rec["w"].astype(np.float32)
        if rec.get("b") is not None:
            slot["b"] = rec["b"].astype(np.float32)

    fill_bn(params["bn_in"], 1)
    for i, (kt, kf, ch) in enumerate(_MCNN_TIMBRAL):
        fill_conv(params[f"timbral{i}"], (kt, kf, 1, ch))
        fill_bn(params[f"timbral{i}"]["bn"], ch)
    for i, (kt, ch) in enumerate(_MCNN_TEMPORAL):
        fill_conv(params[f"temporal{i}"], (kt, 1, 1, ch))
        fill_bn(params[f"temporal{i}"]["bn"], ch)
    # midend kernels in the checkpoint carry features in the WIDTH dim
    # ([7, C, 1, 64]); the tree keeps them in the channel dim
    fill_conv(params["mid0"], (7, MUSICNN_FRONT, 1, _MCNN_MID_CH),
              (0, 2, 1, 3))
    fill_bn(params["mid0"]["bn"], _MCNN_MID_CH)
    for name in ("mid1", "mid2"):
        fill_conv(params[name], (7, _MCNN_MID_CH, 1, _MCNN_MID_CH),
                  (0, 2, 1, 3))
        fill_bn(params[name]["bn"], _MCNN_MID_CH)
    fill_bn(params["bn_pool"], 2 * MUSICNN_POOL)
    fill_fc(params["dense"], (2 * MUSICNN_POOL, MUSICNN_PENULT))
    fill_bn(params["bn_dense"], MUSICNN_PENULT)
    fill_fc(params["dense_out"], (MUSICNN_PENULT, _MCNN_CLASSES))
    return params


def musicnn_params_to_tf_variables(params: dict, scope: str = "") -> dict:
    """The inverse of ``convert_musicnn``: a TF-1 style name -> array dict
    under the MTT_musicnn checkpoint's tf.layers names, midend kernels in
    the checkpoint's [7, C, 1, 64] layout."""
    out: dict = {}
    count = {"conv2d": 0, "batch_normalization": 0, "dense": 0}
    pre = f"{scope}/" if scope else ""

    def name(kind):
        n = count[kind]
        count[kind] += 1
        return f"{pre}{kind}" + ("" if n == 0 else f"_{n}")

    def put_conv(slot, transpose=None):
        w = np.asarray(slot["conv"]["w"])
        p = name("conv2d")
        out[f"{p}/kernel"] = w if transpose is None else w.transpose(transpose)
        out[f"{p}/bias"] = np.asarray(slot["conv"]["b"])

    def put_bn(slot):
        p = name("batch_normalization")
        out[f"{p}/gamma"] = np.asarray(slot["gamma"])
        out[f"{p}/beta"] = np.asarray(slot["beta"])
        out[f"{p}/moving_mean"] = np.asarray(slot["mean"])
        out[f"{p}/moving_variance"] = np.asarray(slot["var"])

    def put_fc(slot):
        p = name("dense")
        out[f"{p}/kernel"] = np.asarray(slot["w"])
        out[f"{p}/bias"] = np.asarray(slot["b"])

    put_bn(params["bn_in"])
    for i in range(len(_MCNN_TIMBRAL)):
        put_conv(params[f"timbral{i}"])
        put_bn(params[f"timbral{i}"]["bn"])
    for i in range(len(_MCNN_TEMPORAL)):
        put_conv(params[f"temporal{i}"])
        put_bn(params[f"temporal{i}"]["bn"])
    for mid in ("mid0", "mid1", "mid2"):
        put_conv(params[mid], transpose=(0, 2, 1, 3))
        put_bn(params[mid]["bn"])
    put_bn(params["bn_pool"])
    put_fc(params["dense"])
    put_bn(params["bn_dense"])
    put_fc(params["dense_out"])
    return out
