"""The port's checkpoint converters vs the JAX package's, on the CPU.

From the torch oracles of ``tests/test_audio_cross_framework.py`` (the
torchopenl3 and torchvggish nets, random BN statistics included) and its
MTT_musicnn variables, the port's converters give trees array-equal to
JAX's, and the port's forward on those trees equals the oracle's (and
the TF oracle's, where TensorFlow is installed) at rtol 1e-3 / atol 1e-3,
the bar of the cross-framework test.  Both converter entry points write
the same arrays.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu.models import audio_embedders as J
from gcn_song_embeddings_tpu_torch import convert_audio_weights
from gcn_song_embeddings_tpu_torch.models import audio_embedders as P
from test_audio_cross_framework import (
    _rng_bn,
    _tf_musicnn_vars,
    _TorchOpenL3Audio,
    _TorchVGGish,
)
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
NET = {"rtol": 1e-3, "atol": 1e-3}
NETS = {"openl3": P.OpenL3Net, "vggish": P.VGGishNet,
        "musicnn": P.MusicNNNet}


def _port_net(name, tree):
    return P.load_tree(NETS[name].build(device=CPU), tree)


def _assert_trees_equal(a, b):
    fa, fb = J._flatten_params(a), P.flatten_params(b)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), fb[k], err_msg=k)


def _openl3_oracle():
    torch.manual_seed(0)
    net = _TorchOpenL3Audio().eval()
    rng = np.random.default_rng(2)
    for mod in net.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            _rng_bn(rng, mod)
    return net


def _vggish_oracle():
    torch.manual_seed(0)
    return _TorchVGGish().eval()


ORACLES = {"openl3": (_openl3_oracle, J.convert_openl3, P.convert_openl3,
                      (-30.0, 15.0, (2, 128, 199))),
           "vggish": (_vggish_oracle, J.convert_vggish, P.convert_vggish,
                      (0.0, 1.0, (3, 96, 64)))}


@pytest.mark.parametrize("name", sorted(ORACLES))
def test_converter_tree_equals_jax_and_forward_equals_the_oracle(name):
    make, jconvert, convert, (mean, std, shape) = ORACLES[name]
    oracle = make()
    tree = convert(oracle.state_dict())
    _assert_trees_equal(jconvert(oracle.state_dict()), tree)
    x = np.random.default_rng(3).normal(mean, std, shape).astype(np.float32)
    with torch.no_grad():
        want = oracle(torch.from_numpy(x)[:, None]).numpy()
    got = P.run_net(_port_net(name, tree), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **NET)


def test_musicnn_converter_tree_equals_jax_and_forward():
    variables = _tf_musicnn_vars(seed=0)
    tree = P.convert_musicnn(variables)
    jtree = J.convert_musicnn(variables)
    _assert_trees_equal(jtree, tree)
    x = np.random.default_rng(3).normal(0, 1, (2, 187, 96)).astype(
        np.float32)
    net = _port_net("musicnn", tree)
    for tap in P.MUSICNN_TAPS:
        np.testing.assert_allclose(
            P.run_net(net, torch.from_numpy(x), feature=tap).numpy(),
            np.asarray(J.musicnn_forward(jtree, x, tap)), **NET)


def test_musicnn_matches_the_tf_oracle():
    pytest.importorskip("tensorflow")
    from test_audio_cross_framework import _tf_musicnn_forward

    variables = _tf_musicnn_vars(seed=0)
    net = _port_net("musicnn", P.convert_musicnn(variables))
    x = np.random.default_rng(3).normal(0, 1, (2, 187, 96)).astype(
        np.float32)
    ref_max, ref_pen, ref_tag = _tf_musicnn_forward(variables, x)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(P.run_net(net, xt).numpy(), ref_max, **NET)
    np.testing.assert_allclose(P.run_net(net, xt, feature="penultimate")
                               .numpy(), ref_pen, rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(P.run_net(net, xt, feature="taggram")
                               .numpy(), ref_tag, rtol=1e-3, atol=1e-4)


def test_musicnn_tf_variables_roundtrip_equal_to_jax():
    tree = J.init_musicnn(seed=3)
    port_vars = P.musicnn_params_to_tf_variables(tree, scope="model")
    jax_vars = J.musicnn_params_to_tf_variables(tree, scope="model")
    assert list(port_vars) == list(jax_vars)
    for k in jax_vars:
        np.testing.assert_array_equal(port_vars[k], jax_vars[k], err_msg=k)
    names = list(port_vars)
    np.random.default_rng(0).shuffle(names)
    _assert_trees_equal(tree, P.convert_musicnn({n: port_vars[n]
                                                 for n in names}))


def test_musicnn_converter_rejects_another_variant():
    tfvars = P.musicnn_params_to_tf_variables(J.init_musicnn(seed=0))
    bad = {k: (v[:, :-1] if k.endswith("dense/kernel") else v)
           for k, v in tfvars.items()}
    with pytest.raises(ValueError, match="dense"):
        P.convert_musicnn(bad)


@pytest.mark.parametrize("model", ["openl3", "musicnn"])
def test_converter_scripts_write_equal_files(tmp_path, model):
    """``scripts/convert_audio_weights.py`` (JAX) and the port's
    ``convert_audio_weights`` (no JAX; ``tests/test_torch_imports.py``
    imports it with JAX blocked) write the same arrays from the same
    checkpoint."""
    if model == "openl3":
        src = str(tmp_path / "sd.pt")
        torch.save(_openl3_oracle().state_dict(), src)
    else:
        src = str(tmp_path / "tfvars.npz")
        np.savez(src, **_tf_musicnn_vars(seed=1))
    jax_out, port_out = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                 "convert_audio_weights.py"),
                    model, src, jax_out], cwd=REPO, check=True,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"),
                   capture_output=True, timeout=300)
    convert_audio_weights.main([model, src, port_out])
    _assert_trees_equal(P.load_weights(jax_out), P.load_weights(port_out))
