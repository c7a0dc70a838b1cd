"""The port's OpenL3, VGGish and MusicNN nets, their front ends, weight
files and checkpoint converters vs the JAX package, on the CPU.

Every net runs at its published width.  Random init cannot match (JAX
draws threefry), so JAX's seed-0 weights are carried across
(``params_from_jax``, or an ``.npz`` written by JAX's ``save_weights``).
Tolerances: the forwards rtol 1e-3 / atol 1e-3 (the bar of
``tests/test_audio_cross_framework.py``); the front ends rtol 1e-4 /
atol 1e-4, atol 1e-3 for OpenL3's dB mel; the committed goldens at
``tests/test_audio_golden.py``'s own bars.  The converters are held in
``tests/test_torch_audio_convert.py``.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu import features as JF
from gcn_song_embeddings_tpu.models import audio_embedders as J
from gcn_song_embeddings_tpu_torch import features as F
from gcn_song_embeddings_tpu_torch.models import audio_embedders as P
from gcn_song_embeddings_tpu_torch.ops.knn import exact_f32
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
NET = {"rtol": 1e-3, "atol": 1e-3}
NETS = {"openl3": (P.OpenL3Net, J.init_openl3),
        "vggish": (P.VGGishNet, J.init_vggish),
        "musicnn": (P.MusicNNNet, J.init_musicnn)}


@pytest.fixture(scope="module")
def jax_trees():
    return {name: init(seed=0) for name, (_, init) in NETS.items()}


def _port_net(name, tree):
    return P.load_tree(NETS[name][0].build(device=CPU), tree)


def _assert_trees_equal(a, b):
    fa, fb = J._flatten_params(a), P.flatten_params(b)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), fb[k], err_msg=k)


def _clips(seconds, seed=0):
    sr = F.SAMPLE_RATE
    t = np.arange(int(seconds * sr)) / sr
    rng = np.random.default_rng(seed)
    return np.stack([
        0.5 * np.sin(2 * np.pi * 440 * t) + 1e-3 * rng.normal(size=t.shape),
        0.3 * np.sin(2 * np.pi * 1760 * t) * np.sin(2 * np.pi * 3 * t)
        + 1e-3 * rng.normal(size=t.shape)]).astype(np.float32)


@pytest.mark.parametrize("name", sorted(NETS))
def test_template_tree_has_the_jax_names_and_shapes(name, jax_trees):
    fa = J._flatten_params(jax_trees[name])
    fb = P.flatten_params(P.template_tree(NETS[name][0]))
    assert set(fa) == set(fb)
    assert all(np.asarray(fa[k]).shape == fb[k].shape for k in fa)


INPUTS = {"openl3": (-30.0, 15.0, (2, 128, 199)),
          "vggish": (0.0, 1.0, (3, 96, 64)),
          "musicnn": (0.0, 1.0, (2, 187, 96))}
FORWARDS = [("openl3", None), ("vggish", None),
            ("musicnn", "max_pool"), ("musicnn", "mean_pool"),
            ("musicnn", "penultimate"), ("musicnn", "taggram")]


@pytest.mark.parametrize("name,tap", FORWARDS,
                         ids=[f"{n}-{t}" if t else n for n, t in FORWARDS])
def test_forward_matches_jax_on_carried_weights(name, tap, jax_trees):
    mean, std, shape = INPUTS[name]
    x = np.random.default_rng(1).normal(mean, std, shape).astype(np.float32)
    tree = jax_trees[name]
    net = _port_net(name, tree)
    kw = {"feature": tap} if tap else {}
    got = P.run_net(net, torch.from_numpy(x), **kw).numpy()
    fwd = {"openl3": J.openl3_forward, "vggish": J.vggish_forward,
           "musicnn": J.musicnn_forward}[name]
    want = np.asarray(fwd(tree, x, **kw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **NET)


FRONTENDS = {"openl3": (P.openl3_mel_windows, J.openl3_mel_windows, 1e-3),
             "vggish": (P.vggish_log_mel_patches, J.vggish_log_mel_patches,
                        1e-4),
             "musicnn": (P.musicnn_log_mel_patches,
                         J.musicnn_log_mel_patches, 1e-4)}


@pytest.mark.parametrize("name", sorted(FRONTENDS))
@pytest.mark.parametrize("sr", [16000, 22050])
def test_frontend_matches_jax(name, sr):
    port, jax_, atol = FRONTENDS[name]
    clips = _clips(6.2 * sr / F.SAMPLE_RATE, seed=sr)
    got, n_got = port(clips, sr=sr, device=CPU)
    want, n_want = jax_(clips, sr=sr)
    assert n_got == n_want and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=atol)


@pytest.fixture(scope="module")
def golden():
    spec = importlib.util.spec_from_file_location(
        "make_audio_golden",
        os.path.join(REPO, "scripts", "make_audio_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with np.load(os.path.join(REPO, "tests", "golden",
                              "audio_golden.npz")) as z:
        return mod.golden_clip(), {k: z[k] for k in z.files}


GOLDEN = {"openl3": ("openl3_mel", "openl3_n_win", 1e-3),
          "vggish": ("vggish_patches", "vggish_n_patches", 1e-4),
          "musicnn": ("musicnn_patches", "musicnn_n_patches", 1e-4)}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_reproduces_the_committed_golden(name, golden, jax_trees):
    clip, g = golden
    key, n_key, atol = GOLDEN[name]
    windows, n = FRONTENDS[name][0](clip, sr=22_050, device=CPU)
    assert n == int(g[n_key])
    np.testing.assert_allclose(windows.numpy(), g[key], rtol=1e-4,
                               atol=atol)
    emb = P.run_net(_port_net(name, jax_trees[name]), windows).numpy()
    np.testing.assert_allclose(emb, g[f"{name}_emb"], rtol=1e-3, atol=1e-2)


def test_weight_files_load_in_both_packages(tmp_path, jax_trees):
    net = P.OpenL3Net.build(seed=3, device=CPU)
    path = str(tmp_path / "port.npz")
    P.save_weights(net, path)
    jtree = J.load_weights(path)
    _assert_trees_equal(jtree, P.tree_from_net(net))
    x = np.random.default_rng(4).normal(-30, 15, (1, 128, 199)).astype(
        np.float32)
    np.testing.assert_allclose(P.run_net(net, torch.from_numpy(x)).numpy(),
                               np.asarray(J.openl3_forward(jtree, x)), **NET)
    jpath = str(tmp_path / "jax.npz")
    J.save_weights(jax_trees["musicnn"], jpath)
    _assert_trees_equal(jax_trees["musicnn"], P.load_weights(jpath))


EMBEDDERS = {"openl3": (F.OpenL3, JF.OpenL3, 3.0, {}),
             "vggish": (F.VGGish, JF.VGGish, 2.5, {}),
             "musicnn": (F.MusicNN, JF.MusicNN, 6.5, {}),
             "musicnn_penultimate": (F.MusicNN, JF.MusicNN, 6.5,
                                     {"feature": "penultimate"})}


@pytest.mark.parametrize("name", sorted(EMBEDDERS))
def test_embedder_matches_jax_with_shared_weights(tmp_path, name,
                                                  jax_trees):
    port_cls, jax_cls, seconds, kw = EMBEDDERS[name]
    path = str(tmp_path / "w.npz")
    J.save_weights(jax_trees[name.split("_")[0]], path)
    clips = _clips(seconds, seed=7)
    port = port_cls(weights_path=path, clips_per_chunk=1, device=CPU, **kw)
    got = port.embed_batch(clips)
    want = jax_cls(weights_path=path, **kw).embed_batch(clips)
    assert got.shape == want.shape == (2, port.dim)
    np.testing.assert_allclose(got, want, **NET)
    assert not np.allclose(got[0], got[1])
    assert port.embed_batch(clips[:0]).shape == (0, port.dim)


def test_random_init_is_seeded(monkeypatch, capsys):
    monkeypatch.setattr(P, "_warned", set())
    a = F.OpenL3(seed=1, device=CPU)
    assert "OpenL3 running with RANDOM-INIT" in capsys.readouterr().err
    b = F.OpenL3(seed=1, device=CPU)
    assert capsys.readouterr().err == ""          # one warning a net
    c = P.OpenL3Net.build(seed=2, device=CPU)
    for (name, ta), tb, tc in zip(a.net.state_dict().items(),
                                  b.net.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(ta, tb), name
        if name.endswith("weight"):
            assert not torch.equal(ta, tc), name
            fan_in = ta[0].numel()
            assert abs(float(ta.std()) - np.sqrt(2.0 / fan_in)) \
                < 0.1 * np.sqrt(2.0 / fan_in)


def test_forward_turns_tf32_off_and_restores_it():
    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x):
            seen.append((torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
            return x

    net = P.VGGishNet()
    net.fc2 = Probe()
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        P.run_net(net, torch.zeros(1, 96, 64))
        assert seen == [(False, False)]
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        with exact_f32():
            assert not torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before
