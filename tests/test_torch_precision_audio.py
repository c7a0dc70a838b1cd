"""The matmul precision policy's reach into the audio features
(``features.py``: the mel and MFCC DCT products) and the three audio
nets (``models/audio_embedders.py``: the convolutions and dense layers
of OpenL3, VGGish and MusicNN) against the JAX package at the TPU's
numerics, on the CPU.

The JAX side runs through ``tests/tpu_numerics.py``'s jaxpr evaluator:
its ``einsum``s and ``conv_general_dilated``s and ``@``s at the default
precision are rounded as the TPU rounds them at ``default`` (one bf16
pass) or ``high`` (three).  The nets run at their published widths on
seeded numpy weights in the JAX layout, carried across by the port's
converter (``load_tree``), batch norm with non-trivial statistics.

Tolerances, relative (Frobenius).  MFCC at ``default`` 1e-3: its DCT
rounds an f32 intermediate again, and two orders of f32 sums can round
an entry to neighbouring bf16 values, 2^-8 apart; at ``high`` 1e-4, the
bar of the unrounded MFCC test (tests/test_torch_features.py), since the
port's rfft runs in float64 and JAX's in f32.  The nets in f32: at
``high`` 2e-5, a flip there moving only the lo part, by at most 2^-16
of the entry; at ``default`` 1e-2, since flips accumulate through eight
or nine stacked layers: the port's f32 forward lies 1.3e-3 (OpenL3) and
2.9e-3 (VGGish) from its own float64 forward of the same rounding, as
far as from JAX's, and the unrounded forward lies only 4e-3 to 5e-3
away.  So what decides the nets is the float64 test: both packages in
float64 with the same rounding agree within 1e-6, where one product
rounded on one side only parts them by ~1e-3.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu import features as JF
from gcn_song_embeddings_tpu.models import audio_embedders as J
from gcn_song_embeddings_tpu_torch import features as F
from gcn_song_embeddings_tpu_torch.models import audio_embedders as P
from gcn_song_embeddings_tpu_torch.ops import agg
from gcn_song_embeddings_tpu_torch.utils import precision
from torch_threads import one_torch_thread  # noqa: F401
from tpu_numerics import tpu_eval

CPU = torch.device("cpu")
VALUES = {"default": 1, "high": 3}
TOL = {"default": 1e-2, "high": 2e-5}
MFCC_TOL = {"default": 1e-3, "high": 1e-4}
# (port net, JAX forward of (params, x), input [frames, mels])
NETS = {
    "openl3": (P.OpenL3Net, lambda p, x: J.openl3_forward(p, x),
               (P.OPENL3_MELS, P.OPENL3_FRAMES)),
    "vggish": (P.VGGishNet, lambda p, x: J.vggish_forward(p, x),
               (P.VGGISH_FRAMES, P.VGGISH_MELS)),
    "musicnn": (P.MusicNNNet,
                lambda p, x: J.musicnn_forward(p, x, feature="taggram"),
                (P.MUSICNN_FRAMES, P.MUSICNN_MELS)),
}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _clips(seconds=2.0, seed=0):
    sr = F.SAMPLE_RATE
    t = np.arange(int(seconds * sr)) / sr
    rng = np.random.default_rng(seed)
    return np.stack([
        0.5 * np.sin(2 * np.pi * 440 * t) + 1e-2 * rng.normal(size=t.shape),
        0.3 * np.sin(2 * np.pi * 1760 * t) * np.sin(2 * np.pi * 3 * t)
        + 1e-2 * rng.normal(size=t.shape),
        rng.normal(size=t.shape) * 0.1]).astype(np.float32)


def _jax_mfcc(clips, passes, n_mfcc=40):
    m = JF.MFCC(n_mfcc=n_mfcc)
    return np.asarray(tpu_eval(
        lambda c, fb, dct, w: JF._mfcc_batch_jax(c, fb, dct, w, m.n_fft,
                                                 m.hop, n_mfcc), passes)(
        jnp.asarray(clips), jnp.asarray(m._fb), jnp.asarray(m._dct),
        jnp.asarray(m._window)))


@pytest.mark.parametrize("value", list(VALUES))
def test_mfcc_matches_jax_at_tpu_numerics(value):
    """MFCC-40 of three 2 s clips (its mel product and DCT rounded)
    against the JAX package's ``_mfcc_batch_jax`` run at the TPU's
    numerics, within MFCC_TOL; not the unrounded bits."""
    clips = _clips()
    want = _jax_mfcc(clips, VALUES[value])
    with precision.override(value):
        got = F.MFCC(device=CPU).embed_batch(clips)
    assert got.shape == want.shape == (3, 40)
    assert _rel(got, want) <= MFCC_TOL[value]
    assert not np.array_equal(got, F.MFCC(device=CPU).embed_batch(clips))


def _tree(name, seed=0):
    """Seeded weights for the net in the JAX package's layout: He-normal
    kernels, small biases, batch norm with spread statistics."""
    rng = np.random.default_rng(seed)
    flat = P.flatten_params(P.template_tree(NETS[name][0]))
    out = {}
    for k, v in sorted(flat.items()):
        leaf = k.rsplit(".", 1)[1]
        if leaf == "w":
            fan_in = int(np.prod(v.shape[:-1]))
            v = rng.standard_normal(v.shape, dtype=np.float32) * np.float32(
                np.sqrt(2.0 / fan_in))
        elif leaf in ("b", "beta", "mean"):
            v = rng.normal(scale=0.1, size=v.shape).astype(np.float32)
        else:   # gamma, var
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        out[k] = v
    return P.unflatten_params(out)


@pytest.fixture(scope="module")
def nets():
    """name -> (JAX tree, the port's net on it, one input)."""
    out = {}
    for i, name in enumerate(NETS):
        tree = _tree(name, seed=i)
        x = np.random.default_rng(10 + i).normal(
            size=(1, *NETS[name][2])).astype(np.float32)
        with torch.device("meta"):         # no init: the tree replaces it
            net = NETS[name][0]()
        out[name] = (tree, P.load_tree(net.to_empty(device=CPU), tree).eval(),
                     x)
    return out


@pytest.mark.parametrize("value", list(VALUES))
@pytest.mark.parametrize("name", list(NETS))
def test_net_matches_jax_at_tpu_numerics(name, value, nets):
    """One forward of the net (MusicNN to its taggram, so both dense
    layers run) against the JAX package's forward run at the TPU's
    numerics, within TOL; not the unrounded bits."""
    tree, net, x = nets[name]
    want = np.asarray(tpu_eval(NETS[name][1], VALUES[value])(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x)))
    kw = {"feature": "taggram"} if name == "musicnn" else {}
    with precision.override(value):
        got = P.run_net(net, torch.from_numpy(x), **kw).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL[value]
    assert not np.array_equal(got, P.run_net(net, torch.from_numpy(x),
                                             **kw).numpy())


def test_unset_features_and_nets_are_the_f32_ops(nets, monkeypatch):
    """With the variable unset nothing is rounded, and MFCC, the mel
    front end and the nets give the bits of the ops they ran before the
    policy reached them: ``@`` for the mel and DCT products, each
    ``nn.Conv2d`` and ``nn.Linear`` module's own forward (which the nets
    call unset)."""
    def refuse(*a, **k):
        raise AssertionError("an operand was rounded with the policy unset")

    clips = _clips(seed=1)
    outs = {}
    for patched in (False, True):
        with monkeypatch.context() as mp, precision.override(None):
            if patched:   # the parent's ops in place of the helpers
                mp.setattr(agg, "bf16_round", refuse)
                mp.setattr(F, "matmul", lambda a, b, passes: a @ b)
                mp.setattr(P, "_conv", lambda mod, x, passes: mod(x))
                mp.setattr(P, "_linear", lambda mod, x, passes: mod(x))
            run = [F.MFCC(device=CPU).embed_batch(clips),
                   F.melspectrogram(clips, device=CPU)]
            for name, (_, net, x) in nets.items():
                kw = {"feature": "taggram"} if name == "musicnn" else {}
                run.append(P.run_net(net, torch.from_numpy(x),
                                     **kw).numpy())
            outs[patched] = run
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(NETS))
def test_net_in_float64_rounds_where_jax_rounds(name, nets):
    """The same forward at ``default`` in float64 on both sides (the
    products of the same bf16-rounded operands, every sum near exact):
    within 1e-6, so each convolution and dense layer the JAX package
    rounds, and no other product, is rounded in the port (one product
    rounded on one side only parts them by ~1e-3).  ``high`` rounds the
    same products (its three-pass sums: tests/
    test_torch_precision_evaluator.py)."""
    tree, net, x = nets[name]
    with jax.enable_x64(True):
        want = np.asarray(tpu_eval(NETS[name][1], 1)(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                   tree), jnp.asarray(x, jnp.float64)))
    kw = {"feature": "taggram"} if name == "musicnn" else {}
    net64 = copy.deepcopy(net).double()
    with precision.override("default"):
        got = P.run_net(net64, torch.from_numpy(x).double(), **kw).numpy()
    assert _rel(got, want) <= 1e-6
