"""Audio features: clip IO, the DSP front end and the feature embedders.

The port of the JAX package's ``features.py`` (reference
generate_node_features.py): load, resample and cut or pad 30 s clips;
batched incremental per-track feature generation with a skip list; the
embedders ``RandomFeatures`` (512), ``MFCC`` (40) and the CNNs ``OpenL3``
(512), ``VGGish`` (128) and ``MusicNN`` (753, ``models.audio_embedders``).

Clip IO is host numpy and bit-equal to the JAX package: ``.wav`` through
the stdlib ``wave`` module, raw ``.npy`` waveforms, and every other
extension through the native FFmpeg decoder (``native.audiodec``).  The
mel filterbank, the Hann windows and the DCT matrix are numpy copies, so
they are bit-equal too.  The DSP runs on the device as plain tensor ops:
framing (``unfold``), window, ``torch.fft.rfft`` (in float64),
magnitude or power, then the mel projection as one f32 matrix product;
log, then the DCT for MFCC.  Products run in true f32 (TF32 off,
``ops.knn.exact_f32``).

Every embedder that computes on a device takes ``device`` (default
``cuda``: it raises where there is no card, see ``utils.device``).
"""

from __future__ import annotations

import functools
import os
import sys
import wave

import numpy as np
import torch

from gcn_song_embeddings_tpu_torch.ops.knn import exact_f32
from gcn_song_embeddings_tpu_torch.utils.device import resolve_device

SAMPLE_RATE = 16000
CLIP_SAMPLES = 480000  # 30 s (generate_node_features.py:40-77)


# ------------------------------------------------------------------ audio IO


def load_clip(path: str, sr: int = SAMPLE_RATE,
              n_samples: int = CLIP_SAMPLES) -> np.ndarray:
    """Load audio -> mono float32 [n_samples] at ``sr``, cut or zero-padded.

    ``.wav`` is read by the stdlib ``wave`` module (8, 16 and 32-bit PCM,
    channels averaged, linearly resampled to ``sr``); ``.npy`` is a raw
    waveform taken to be at ``sr`` already (a 2-D one is averaged over its
    second axis); every other extension decodes through the native FFmpeg
    decoder, which downmixes and resamples in C."""
    if path.endswith(".npy"):
        y = np.load(path).astype(np.float32)
        if y.ndim == 2:
            y = y.mean(axis=1)
    elif path.endswith(".wav"):
        with wave.open(path, "rb") as w:
            rate = w.getframerate()
            raw = w.readframes(w.getnframes())
            width = w.getsampwidth()
            dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
            y = np.frombuffer(raw, dtype=dtype).astype(np.float32)
            if width == 1:
                y = (y - 128.0) / 128.0
            else:
                y = y / float(np.iinfo(dtype).max)
            if w.getnchannels() > 1:
                y = y.reshape(-1, w.getnchannels()).mean(axis=1)
        if rate != sr:
            y = resample_linear(y, rate, sr)
    else:
        from gcn_song_embeddings_tpu_torch.native import audiodec

        if not audiodec.native_available():
            raise ValueError(
                f"unsupported audio format: {path!r} — compressed clips "
                f"need the native decoder (native/audiodec.cc, built at "
                f"first use where g++ and the system FFmpeg development "
                f"libraries exist); alternatively convert clips to .wav or "
                f"raw .npy waveforms")
        y = audiodec.decode(path, sr)
    if y.shape[0] >= n_samples:
        return y[:n_samples]
    return np.pad(y, (0, n_samples - y.shape[0]))


def resample_linear(y: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Linear-interpolation resampler (host numpy)."""
    n_out = int(round(len(y) * sr_out / sr_in))
    x_out = np.linspace(0.0, len(y) - 1, n_out)
    return np.interp(x_out, np.arange(len(y)), y).astype(np.float32)


# ------------------------------------------------ front-end tables (numpy)


def mel_filterbank(n_mels: int, n_fft: int, sr: int,
                   fmin: float = 0.0, fmax: float | None = None
                   ) -> np.ndarray:
    """Triangular mel filterbank [n_mels, n_fft//2 + 1] built like
    torchaudio's ``melscale_fbanks`` defaults (HTK mel scale, norm=None):
    triangles in continuous frequency over the rfft bin centers
    ``linspace(0, sr/2, n_fft//2 + 1)``; ``fmin``/``fmax`` bound the band
    edges (VGGish uses 125-7500 Hz)."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64)
                                 / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    fmax = sr / 2 if fmax is None else fmax
    all_freqs = np.linspace(0.0, sr / 2, n_fft // 2 + 1)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax),
                                  n_mels + 2))
    f_diff = np.diff(f_pts)                              # [n_mels + 1]
    slopes = f_pts[None, :] - all_freqs[:, None]         # [n_bins, n_mels+2]
    down = -slopes[:, :-2] / f_diff[None, :-1]           # rising edge
    up = slopes[:, 2:] / f_diff[None, 1:]                # falling edge
    fb = np.maximum(0.0, np.minimum(down, up))           # [n_bins, n_mels]
    return fb.T.astype(np.float32)


def hann_window(n_fft: int) -> np.ndarray:
    """Periodic Hann window (``torch.hann_window``'s default)."""
    return np.hanning(n_fft + 1)[:-1].astype(np.float32)


def dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix [n_out, n_in]."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    mat = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in))
    mat *= np.sqrt(2.0 / n_in)
    mat[0] *= np.sqrt(0.5)
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=8)
def frontend_tables(n_mels: int, n_fft: int, sr: int, device: torch.device,
                    fmin: float = 0.0, fmax: float | None = None,
                    win_length: int | None = None, periodic: bool = True
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(filterbank [n_mels, n_fft//2 + 1], window [win_length]) on
    ``device``, built once per configuration.  ``periodic=False`` is the
    symmetric ``np.hanning`` window (VGGish's)."""
    n_win = win_length or n_fft
    window = (hann_window(n_win) if periodic
              else np.hanning(n_win).astype(np.float32))
    fb = mel_filterbank(n_mels, n_fft, sr, fmin=fmin, fmax=fmax)
    return (torch.as_tensor(fb, device=device),
            torch.as_tensor(window, device=device))


# ---------------------------------------------------------- device DSP


def reflect_pad(clips: torch.Tensor, pad: int) -> torch.Tensor:
    """``np.pad(mode="reflect")`` of each row by ``pad`` on both sides, for
    any pad length (``F.pad``'s reflect mode refuses a pad as long as the
    row): the indices come from numpy itself."""
    idx = np.pad(np.arange(clips.shape[1]), pad, mode="reflect")
    return clips[:, torch.as_tensor(idx, device=clips.device)]


def mel_power(clips: torch.Tensor, fb: torch.Tensor, window: torch.Tensor,
              n_fft: int, hop: int, center: bool = False,
              power: float = 2.0) -> torch.Tensor:
    """[B, samples] -> [B, frames, n_mels] mel spectrum.

    ``center=True`` reflect-pads n_fft//2 on each side (torchaudio's
    framing, which also takes clips shorter than n_fft).  ``power=2``
    projects the power spectrum, ``power=1`` the magnitude (VGGish).  A
    ``window`` shorter than ``n_fft`` frames with the window's length and
    zero-pads each frame to ``n_fft`` before the rfft."""
    win = window.shape[0]
    n = clips.shape[1]
    if center:
        clips = reflect_pad(clips, n_fft // 2)
        n_frames = 1 + (n + 2 * (n_fft // 2) - win) // hop
    else:
        n_frames = 1 + (n - win) // hop
    if n_frames < 1:
        raise ValueError(
            f"clip too short: {n} samples < window={win} with center=False "
            f"(pad the clip, or use center=True framing)")
    # the rfft runs in float64: a low-energy bin's power (log-mel of
    # 1e-6 scale) from an f32 rfft errs up to ~0.7 of the 1e-4 bar
    frames = clips.unfold(1, win, hop)[:, :n_frames].double() \
        * window.double()
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1).abs()
    del frames
    if power != 1.0:
        spec = spec ** power
    with exact_f32():
        return spec.float() @ fb.t()


def melspectrogram(clips: np.ndarray, sr: int = SAMPLE_RATE,
                   n_mels: int = 64, n_fft: int = 1024, hop: int = 512,
                   center: bool = True, device=None) -> np.ndarray:
    """[B, samples] -> [B, n_mels, frames] dB mel "images", min-max
    normalized to [0, 1] per clip (the reference's ``get_melspec``,
    generate_node_features.py:33-38, 79-86: MelSpectrogram(n_fft=1024,
    hop=512, n_mels=64), AmplitudeToDB without a top_db clamp, minmax)."""
    dev = resolve_device(device)
    clips = np.atleast_2d(np.asarray(clips, dtype=np.float32))
    fb, window = frontend_tables(n_mels, n_fft, sr, dev)
    mel = mel_power(torch.as_tensor(clips, device=dev), fb, window, n_fft,
                    hop, center=center)
    db = (10.0 * torch.log10(torch.clamp(mel, min=1e-10))).transpose(1, 2)
    lo = db.amin(dim=(1, 2), keepdim=True)
    hi = db.amax(dim=(1, 2), keepdim=True)
    return ((db - lo) / torch.clamp(hi - lo, min=1e-12)).cpu().numpy()


# ------------------------------------------------------------- embedders


class Embedder:
    """Base feature embedder: ``embed_batch(clips [B, samples]) -> [B, d]``
    (numpy in, numpy out)."""

    name = "base"
    dim = 0

    def embed_batch(self, clips: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class RandomFeatures(Embedder):
    """Per-clip random features (reference RandomFeatures(512),
    generate_node_features.py:275-282), deterministic in call order:
    numpy's ``default_rng(seed)``, bit-equal to the JAX package."""

    name = "random"

    def __init__(self, dim: int = 512, seed: int = 0):
        self.dim = dim
        self.rng = np.random.default_rng(seed)

    def embed_batch(self, clips: np.ndarray) -> np.ndarray:
        return self.rng.normal(size=(clips.shape[0], self.dim)
                               ).astype(np.float32)


class MFCC(Embedder):
    """Mean-pooled MFCCs over the 30 s clip (reference
    generate_features_mfcc, generate_node_features.py:285-314).

    The whole batch runs at once: ``generate_features``' 512-clip batch
    frames into [512, 938, 2048] float64 (7.9 GB) and an rfft of the same
    size on the device."""

    name = "mfcc"

    def __init__(self, n_mfcc: int = 40, n_fft: int = 2048, hop: int = 512,
                 n_mels: int = 128, sr: int = SAMPLE_RATE, device=None):
        self.device = resolve_device(device)
        self.dim = n_mfcc
        self.n_fft = n_fft
        self.hop = hop
        self._fb, self._window = frontend_tables(n_mels, n_fft, sr,
                                                 self.device)
        self._dct = torch.as_tensor(dct_matrix(n_mfcc, n_mels),
                                    device=self.device)

    def embed_batch(self, clips: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(clips, dtype=np.float32),
                            device=self.device)
        mel = mel_power(x, self._fb, self._window, self.n_fft, self.hop)
        logmel = torch.log(mel + 1e-10)
        with exact_f32():
            mfcc = logmel @ self._dct.t()
        return mfcc.mean(dim=1).cpu().numpy()


class _NetEmbedder(Embedder):
    """A CNN over front-end windows or patches: clips go through the
    front end and the net ``clips_per_chunk`` at a time (a 30 s clip
    expands to 15-31 windows, whose first-layer activations alone would
    take tens of GB for a 512-clip batch), then the mean over each clip's
    windows."""

    label = ""

    def __init__(self, build, weights_path, seed, clips_per_chunk, device):
        from gcn_song_embeddings_tpu_torch.models import audio_embedders

        self._ae = audio_embedders
        self.device = resolve_device(device)
        self.clips_per_chunk = clips_per_chunk
        self.net = build(seed=seed, device=self.device)
        if weights_path:
            audio_embedders.load_tree(self.net,
                                      audio_embedders.load_weights(
                                          weights_path))
        else:
            audio_embedders.warn_untrained(self.label)

    def windows(self, clips: np.ndarray) -> tuple[torch.Tensor, int]:
        raise NotImplementedError

    def forward(self, windows: torch.Tensor) -> torch.Tensor:
        return self._ae.run_net(self.net, windows)

    def embed_batch(self, clips: np.ndarray) -> np.ndarray:
        clips = np.atleast_2d(np.asarray(clips, dtype=np.float32))
        if clips.shape[0] == 0:
            return np.zeros((0, self.dim), np.float32)
        out = []
        for s in range(0, clips.shape[0], self.clips_per_chunk):
            wins, n_win = self.windows(clips[s:s + self.clips_per_chunk])
            emb = self.forward(wins)
            out.append(emb.reshape(-1, n_win, emb.shape[1]).mean(dim=1)
                       .cpu().numpy())
        return np.concatenate(out, axis=0)


class OpenL3(_NetEmbedder):
    """L3-Net audio embedder (torchopenl3 mel128/music/512; 1 s windows
    every 2 s, mean-pooled, generate_node_features.py:209-229).
    ``weights_path`` loads an ``.npz`` in the JAX package's layout (either
    package's ``save_weights``, or ``convert_audio_weights``); without it
    the net is seeded random-init and a one-time warning says the features
    are untrained."""

    name = "openl3"
    dim = 512
    label = "OpenL3"

    def __init__(self, weights_path: str | None = None, seed: int = 0,
                 window_s: float = 1.0, hop_s: float = 2.0,
                 clips_per_chunk: int = 8, device=None):
        from gcn_song_embeddings_tpu_torch.models import audio_embedders

        self.window_s, self.hop_s = window_s, hop_s
        super().__init__(audio_embedders.OpenL3Net.build, weights_path, seed,
                         clips_per_chunk, device)

    def windows(self, clips):
        return self._ae.openl3_mel_windows(clips, window_s=self.window_s,
                                           hop_s=self.hop_s,
                                           device=self.device)


class VGGish(_NetEmbedder):
    """AudioSet VGGish (128-d) over 0.96 s log-mel patches, mean-pooled.
    Named ``vggish`` (``features_vggish/``): the reference's commented-out
    ``Vggish2`` is musicnn's MTT_vgg pool5, another model."""

    name = "vggish"
    dim = 128
    label = "VGGish"

    def __init__(self, weights_path: str | None = None, seed: int = 0,
                 clips_per_chunk: int = 16, device=None):
        from gcn_song_embeddings_tpu_torch.models import audio_embedders

        super().__init__(audio_embedders.VGGishNet.build, weights_path, seed,
                         clips_per_chunk, device)

    def windows(self, clips):
        return self._ae.vggish_log_mel_patches(clips, device=self.device)


class MusicNN(_NetEmbedder):
    """MTT_musicnn over 3 s log-mel patches, mean-pooled
    (generate_node_features.py:251-271).  ``feature`` is the tap:
    'max_pool' (753-d, the reference's), 'mean_pool' (753),
    'penultimate' (200) or 'taggram' (50)."""

    name = "musicnn"
    label = "MusicNN"

    def __init__(self, weights_path: str | None = None, seed: int = 0,
                 clips_per_chunk: int = 16, feature: str = "max_pool",
                 device=None):
        from gcn_song_embeddings_tpu_torch.models import audio_embedders

        self.feature = feature
        self.dim = audio_embedders.MUSICNN_TAPS[feature]
        super().__init__(audio_embedders.MusicNNNet.build, weights_path, seed,
                         clips_per_chunk, device)

    def windows(self, clips):
        return self._ae.musicnn_log_mel_patches(clips, device=self.device)

    def forward(self, windows):
        return self._ae.run_net(self.net, windows, feature=self.feature)


def generate_features(dataset_dir: str, embedder: Embedder,
                      clip_dir: str | None = None, batch_size: int = 512,
                      out_dir: str | None = None,
                      verbose: bool = True) -> str:
    """Batched incremental feature generation with a per-track skip list
    (reference generate_features, generate_node_features.py:88-203):
    writes ``<dataset>/features_<name>/<track_id>.npy`` for every track
    without one, then the consolidated ``features_<name>.npy`` in
    ``tracks.json`` order.  Returns the per-track directory.

    Clips are ``<clip_dir>/<track_id>.wav`` or ``.npy`` (default
    ``<dataset>/clips``); a track without one gets the features of a zero
    clip.  The matrix is read back with ``data.graph.load_feature_dir``
    (the native threaded reader where it builds)."""
    import json

    from gcn_song_embeddings_tpu_torch.data.graph import load_feature_dir

    with open(os.path.join(dataset_dir, "tracks.json"), encoding="utf-8") as f:
        tracks = list(json.load(f))
    clip_dir = clip_dir or os.path.join(dataset_dir, "clips")
    out_dir = out_dir or os.path.join(dataset_dir,
                                      f"features_{embedder.name}")
    os.makedirs(out_dir, exist_ok=True)

    todo = [t for t in tracks
            if not os.path.isfile(os.path.join(out_dir, t + ".npy"))]
    for start in range(0, len(todo), batch_size):
        batch_ids = todo[start:start + batch_size]
        clips = np.zeros((len(batch_ids), CLIP_SAMPLES), dtype=np.float32)
        for i, tid in enumerate(batch_ids):
            for ext in (".wav", ".npy"):
                p = os.path.join(clip_dir, tid + ext)
                if os.path.isfile(p):
                    clips[i] = load_clip(p)
                    break
        vecs = embedder.embed_batch(clips)
        for i, tid in enumerate(batch_ids):
            np.save(os.path.join(out_dir, tid + ".npy"), vecs[i])
        if verbose:
            print(f"features: {min(start + batch_size, len(todo))}"
                  f"/{len(todo)} done", file=sys.stderr)

    # the consolidated matrix through the port's threaded reader: 100,000
    # np.load calls take minutes on a slow file system
    mat = load_feature_dir(out_dir, tracks)
    np.save(os.path.join(dataset_dir, f"features_{embedder.name}.npy"), mat)
    return out_dir
