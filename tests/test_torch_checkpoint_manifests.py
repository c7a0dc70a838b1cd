"""The port's converters against the manifests of the real checkpoints.

Mirror of ``tests/test_checkpoint_manifests.py`` for the port's
``convert_openl3``, ``convert_vggish`` and ``convert_musicnn``: the
committed manifests of the public checkpoints (``tests/golden/
manifest_*.json``: the variable names and shapes of torchopenl3
mel128/music/512, torchvggish and MTT_musicnn) are filled with a distinct
arange pattern per tensor, so every model slot is checked by value,
layout transposes included, on the real repeated-shape layouts.  The
converted trees drive the port's nets at the advertised shapes, and each
equals the JAX package's converter output on the same filled manifest,
leaf for leaf.
"""

import json
import os

import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu.models import audio_embedders as J
from gcn_song_embeddings_tpu_torch.models import audio_embedders as P
from torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")
MANIFESTS = {"openl3": "manifest_torchopenl3_mel128_music_512.json",
             "vggish": "manifest_torchvggish.json",
             "musicnn": "manifest_mtt_musicnn.json"}
CONVERTERS = {"openl3": (J.convert_openl3, P.convert_openl3),
              "vggish": (J.convert_vggish, P.convert_vggish),
              "musicnn": (J.convert_musicnn, P.convert_musicnn)}


def _manifest(name):
    with open(os.path.join(HERE, "golden", MANIFESTS[name])) as f:
        return json.load(f)["entries"]


def _fill(entries):
    """name -> arange tensor; distinct offset per variable so any
    misrouted tensor is detected by value, not just shape."""
    out = {}
    for i, (name, shape) in enumerate(entries):
        n = int(np.prod(shape)) if shape else 1
        out[name] = (np.arange(n, dtype=np.float32) + 1000.0 * i).reshape(
            shape if shape else ())
    return out


def _run(net_cls, params, x, **kwargs):
    net = P.load_tree(net_cls.build(device=CPU), params)
    return P.run_net(net, torch.from_numpy(x), **kwargs)


@pytest.mark.parametrize("name", sorted(MANIFESTS))
def test_converted_tree_equals_jax_leaf_for_leaf(name):
    jconvert, convert = CONVERTERS[name]
    sd = _fill(_manifest(name))
    got = P.flatten_params(convert(dict(sd)))
    want = J._flatten_params(jconvert(dict(sd)))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)


# ------------------------------------------------------------- torchopenl3

def test_openl3_manifest_maps():
    sd = _fill(_manifest("openl3"))
    params = P.convert_openl3(sd)

    # conv k (torch OIHW) lands HWIO in block order; the 8th conv is
    # audio_embedding_layer
    conv_names = [f"conv2d_{k}.weight" for k in range(1, 8)] + \
        ["audio_embedding_layer.weight"]
    slots = []
    for bi in range(4):
        slots += [params[f"block{bi}"]["conv0"], params[f"block{bi}"]["conv1"]]
    for name, slot in zip(conv_names, slots):
        np.testing.assert_array_equal(
            slot["w"], sd[name].transpose(2, 3, 1, 0), err_msg=name)
        np.testing.assert_array_equal(
            slot["b"], sd[name.replace("weight", "bias")], err_msg=name)

    # BN k: 1 -> input, 2..8 -> after convs 1..7; NO BN after the last conv
    bn_slots = [params["bn_in"]]
    for bi in range(4):
        bn_slots.append(params[f"block{bi}"]["bn0"])
        if bi < 3:
            bn_slots.append(params[f"block{bi}"]["bn1"])
    assert "bn1" not in params["block3"]
    for k, slot in zip(range(1, 9), bn_slots):
        np.testing.assert_array_equal(
            slot["gamma"], sd[f"batch_normalization_{k}.weight"])
        np.testing.assert_array_equal(
            slot["mean"], sd[f"batch_normalization_{k}.running_mean"])

    # converted tree drives the forward at the advertised shapes
    x = np.zeros((2, P.OPENL3_MELS, P.OPENL3_FRAMES), np.float32)
    assert _run(P.OpenL3Net, params, x).shape == (2, 512)


def test_openl3_manifest_rejects_missing_bn():
    entries = [e for e in _manifest("openl3")
               if not e[0].startswith("batch_normalization_8")]
    with pytest.raises(ValueError, match="8 BN"):
        P.convert_openl3(_fill(entries))


# -------------------------------------------------------------- torchvggish

def test_vggish_manifest_maps():
    sd = _fill(_manifest("vggish"))
    params = P.convert_vggish(sd)

    conv_idx = [0, 3, 6, 8, 11, 13]
    for i, k in enumerate(conv_idx):
        np.testing.assert_array_equal(
            params[f"conv{i}"]["w"],
            sd[f"features.{k}.weight"].transpose(2, 3, 1, 0))
        np.testing.assert_array_equal(
            params[f"conv{i}"]["b"], sd[f"features.{k}.bias"])
    for i, k in enumerate((0, 2, 4)):
        np.testing.assert_array_equal(
            params[f"fc{i}"]["w"], sd[f"embeddings.{k}.weight"].T)
        np.testing.assert_array_equal(
            params[f"fc{i}"]["b"], sd[f"embeddings.{k}.bias"])

    x = np.zeros((2, P.VGGISH_FRAMES, P.VGGISH_MELS), np.float32)
    assert _run(P.VGGishNet, params, x).shape == (2, 128)


# -------------------------------------------------------------- MTT_musicnn

def test_musicnn_manifest_maps():
    tfvars = _fill(_manifest("musicnn"))
    # TF checkpoint readers return an unordered map — shuffle to prove the
    # converter rebuilds creation order from the auto-name suffixes alone
    names = list(tfvars)
    np.random.default_rng(0).shuffle(names)
    params = P.convert_musicnn({n: tfvars[n] for n in names})

    # conv routing incl. the same-shape midend pair, with the [7,C,1,64]
    # -> [7,1,C,64] width->channel transpose
    np.testing.assert_array_equal(params["timbral0"]["conv"]["w"],
                                  tfvars["conv2d/kernel"])
    np.testing.assert_array_equal(params["timbral1"]["conv"]["w"],
                                  tfvars["conv2d_1/kernel"])
    for i, k in enumerate((2, 3, 4)):  # temporal 128/64/32 creation order
        np.testing.assert_array_equal(params[f"temporal{i}"]["conv"]["w"],
                                      tfvars[f"conv2d_{k}/kernel"])
    for name, k in (("mid0", 5), ("mid1", 6), ("mid2", 7)):
        np.testing.assert_array_equal(
            params[name]["conv"]["w"],
            tfvars[f"conv2d_{k}/kernel"].transpose(0, 2, 1, 3))

    # BN routing: same-shape groups (2x204, 3x51, 3x64) resolve by
    # creation order
    bn_map = [("bn_in", 0), ("timbral0", 1), ("timbral1", 2),
              ("temporal0", 3), ("temporal1", 4), ("temporal2", 5),
              ("mid0", 6), ("mid1", 7), ("mid2", 8),
              ("bn_pool", 9), ("bn_dense", 10)]
    for slot_name, k in bn_map:
        slot = params[slot_name]
        if "bn" in slot:
            slot = slot["bn"]
        suffix = "" if k == 0 else f"_{k}"
        np.testing.assert_array_equal(
            slot["gamma"], tfvars[f"batch_normalization{suffix}/gamma"],
            err_msg=slot_name)
        np.testing.assert_array_equal(
            slot["var"],
            tfvars[f"batch_normalization{suffix}/moving_variance"],
            err_msg=slot_name)

    np.testing.assert_array_equal(params["dense"]["w"],
                                  tfvars["dense/kernel"])
    np.testing.assert_array_equal(params["dense_out"]["w"],
                                  tfvars["dense_1/kernel"])

    x = np.zeros((2, P.MUSICNN_FRAMES, P.MUSICNN_MELS), np.float32)
    assert _run(P.MusicNNNet, params, x).shape == (2, P.MUSICNN_POOL)
    assert _run(P.MusicNNNet, params, x, feature="penultimate").shape \
        == (2, P.MUSICNN_PENULT)
    assert _run(P.MusicNNNet, params, x, feature="taggram").shape == (2, 50)


def test_musicnn_manifest_tolerates_optimizer_slots():
    """Real checkpoints may carry optimizer slot variables; the converter
    must route around them, not misassign them."""
    tfvars = _fill(_manifest("musicnn"))
    tfvars["conv2d/kernel/Adam"] = np.zeros((7, 38, 1, 204), np.float32)
    tfvars["conv2d/kernel/Adam_1"] = np.zeros((7, 38, 1, 204), np.float32)
    tfvars["global_step"] = np.int64(12345)
    params = P.convert_musicnn(tfvars)
    np.testing.assert_array_equal(params["timbral0"]["conv"]["w"],
                                  tfvars["conv2d/kernel"])


def test_musicnn_emitter_matches_manifest():
    """musicnn_params_to_tf_variables emits exactly the manifest's
    name->shape map (the committed manifest and the code can't drift
    apart silently)."""
    entries = _manifest("musicnn")
    tree = P.tree_from_net(P.MusicNNNet.build(seed=0, device=CPU))
    emitted = P.musicnn_params_to_tf_variables(tree)
    want = {name: tuple(shape) for name, shape in entries}
    got = {name: tuple(arr.shape) for name, arr in emitted.items()}
    assert got == want
