"""Port's PinSage model, checkpoint loading and the whole slice vs JAX.

Params are made by the JAX package's ``init_pinsage`` and carried across
with ``params_from_numpy``; every output is held at atol 1e-5.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gcn_song_embeddings_tpu.config import RunConfig as JRunConfig
from gcn_song_embeddings_tpu.data.device import (
    DeviceGraph as JDeviceGraph,
    apply_colisten_config as j_apply_colisten,
)
from gcn_song_embeddings_tpu.models import pinsage as jp
from gcn_song_embeddings_tpu.ops.ppr import (
    precompute_neighborhoods as j_precompute,
)
from gcn_song_embeddings_tpu.utils.checkpoint import save_pytree
from gcn_song_embeddings_tpu_torch import cli
from gcn_song_embeddings_tpu_torch.models import pinsage as tp
from gcn_song_embeddings_tpu_torch.utils.checkpoint import (
    load_jax_checkpoint,
    params_from_numpy,
)

ATOL = 1e-5
L, T, IN, HID, OUT = 2, 3, 32, 16, 8


def _jax_params(seed=0, in_dim=IN, hidden=HID, out=OUT, n_layers=L):
    return jp.init_pinsage(jax.random.PRNGKey(seed), n_layers, in_dim,
                           hidden, out)


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _nbhds(n, t, seed=0):
    rng = np.random.default_rng(seed)
    w = np.sort(rng.random((n, t)).astype(np.float32), axis=1)[:, ::-1]
    w[::7, t // 2:] = 0.0                  # zero-weight tails
    w[5] = 0.0                             # an all-zero neighborhood
    return np.ascontiguousarray(w), rng.integers(0, n, (n, t)).astype(np.int32)


def test_params_from_numpy_keeps_layouts():
    jparams = _jax_params()
    port = params_from_numpy(_numpy_tree(jparams))
    assert len(port.layers) == L
    for pl, jl in zip(port.layers, jparams.layers):
        for f in ("Wq", "bq", "Ww", "bw"):
            np.testing.assert_array_equal(getattr(pl, f).detach().numpy(),
                                          np.asarray(getattr(jl, f)))
    assert tuple(port.layers[0].Wq.shape) == (HID, IN)
    assert tuple(port.layers[1].Ww.shape) == (OUT, OUT + HID)
    for f in ("G1_w", "G1_b", "G2_w"):
        np.testing.assert_array_equal(getattr(port, f).detach().numpy(),
                                      np.asarray(getattr(jparams, f)))


def test_init_pinsage_shapes_and_ranges():
    p = tp.init_pinsage(torch.Generator().manual_seed(0), L, IN, HID, OUT)
    a = np.sqrt(6.0 / (IN + HID))
    assert tuple(p.layers[0].Wq.shape) == (HID, IN)
    assert float(p.layers[0].Wq.detach().abs().max()) <= a
    assert tuple(p.layers[1].Ww.shape) == (OUT, OUT + HID)
    assert torch.all(p.layers[1].bq == 0.3) and torch.all(p.G1_b == 0.3)


def test_conv_and_head_match_jax():
    jparams = _jax_params(1)
    port = params_from_numpy(_numpy_tree(jparams))
    rng = np.random.default_rng(1)
    b = 37
    h_self = rng.normal(size=(b, IN)).astype(np.float32)
    h_nb = rng.normal(size=(b, T, IN)).astype(np.float32)
    nb_w = rng.random((b, T)).astype(np.float32)
    nb_w[2] = 0.0
    with torch.inference_mode():
        got = tp.conv_apply(port.layers[0], torch.from_numpy(h_self),
                            torch.from_numpy(h_nb), torch.from_numpy(nb_w))
        head = tp.head_apply(port, got)
    want = jp.conv_apply(jparams.layers[0], jnp.asarray(h_self),
                         jnp.asarray(h_nb), jnp.asarray(nb_w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(head.numpy(),
                               np.asarray(jp.head_apply(jparams, want)),
                               atol=ATOL)


def test_frontier_fullgraph_and_embed_all_match_jax():
    n = 90
    jparams = _jax_params(2)
    port = params_from_numpy(_numpy_tree(jparams))
    feats = np.random.default_rng(2).normal(size=(n, IN)).astype(np.float32)
    w, nodes = _nbhds(n, T + 2)
    nodeset = np.asarray([0, 5, 17, 89, 17], np.int32)
    tf, tw, tn = (torch.from_numpy(a) for a in (feats, w, nodes))
    jf, jw, jn = (jnp.asarray(a) for a in (feats, w, nodes))
    with torch.inference_mode():
        fwd = tp.pinsage_forward(port, tf, tw, tn, torch.from_numpy(nodeset),
                                 L, T)
        full = tp.fullgraph_embeddings(port, tf, tw, tn, L, T)
        blocks = tp.fullgraph_embeddings(port, tf, tw, tn, L, T,
                                         block_rows=37)
    emb = tp.embed_all(port, tf, tw, tn, n, L, T)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(jp.pinsage_forward(
        jparams, jf, jw, jn, jnp.asarray(nodeset), L, T)), atol=ATOL)
    want_full = np.asarray(jp.fullgraph_embeddings(jparams, jf, jw, jn, L, T))
    np.testing.assert_allclose(full.numpy(), want_full, atol=ATOL)
    np.testing.assert_allclose(blocks.numpy(), want_full, atol=ATOL)
    want_emb = np.asarray(jp.embed_all(jparams, jf, jw, jn, n, L, T))
    np.testing.assert_allclose(emb.numpy(), want_emb, atol=ATOL)
    np.testing.assert_allclose(fwd.numpy(), emb.numpy()[nodeset], atol=ATOL)


def test_load_jax_trainer_checkpoint(tmp_path):
    jparams = _jax_params(3)
    path = str(tmp_path / "state.npz")
    save_pytree(path, {"params": jparams,
                       "opt_state": optax.adam(1e-3).init(jparams)},
                scalars={"epochs_done": 2, "batches_done": 0})
    port = load_jax_checkpoint(path)
    ref = params_from_numpy(_numpy_tree(jparams))
    for a, b in zip(port.parameters(), ref.parameters()):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    with np.load(path) as z:
        partial = {k: z[k] for k in z.files if "G2_w" not in k}
    np.savez(str(tmp_path / "broken.npz"), **partial)
    with pytest.raises(KeyError, match="G2_w"):
        load_jax_checkpoint(str(tmp_path / "broken.npz"))


def test_whole_slice_embed_matches_jax(dataset_dir, tmp_path):
    """The port's `embed` CLI on the fixture dataset, with the JAX package's
    neighborhoods artifact (shared cache file) and a JAX-trained checkpoint,
    gives JAX's embed_all output."""
    from gcn_song_embeddings_tpu.data import SongGraph as JSongGraph

    ds = str(tmp_path / "ds")
    shutil.copytree(dataset_dir, ds)
    cfg = JRunConfig.recommended()
    g = JSongGraph(ds, features_file=os.path.join(ds, "features.npy"))
    train_pos, _ = g.load_positives_split(os.path.join(ds, "positives.json"))
    dg, nb_path = j_apply_colisten(JDeviceGraph.from_graph(g), train_pos,
                                   cfg.walk, g.nbhds_path)
    nb_w, nb_n = j_precompute(dg, cfg.walk, nb_path, seed=0)
    jparams = _jax_params(4, in_dim=g.features.shape[1],
                          hidden=cfg.model.hidden_dim,
                          out=cfg.model.out_dim, n_layers=cfg.model.n_layers)
    ckpt = str(tmp_path / "state.npz")
    save_pytree(ckpt, {"params": jparams,
                       "opt_state": optax.adam(1e-3).init(jparams)})
    want = np.asarray(jp.embed_all(
        jparams, jnp.asarray(g.features), jnp.asarray(nb_w),
        jnp.asarray(nb_n), g.n_items, cfg.model.n_layers, cfg.model.T))

    out = str(tmp_path / "emb.npy")
    cli.main(["embed", "--dataset", ds, "--out", out, "--checkpoint", ckpt,
              "--device", "cpu"])
    got = np.load(out)
    assert got.shape == (g.n_items, cfg.model.out_dim)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_cli_synth_and_seeded_embed(tmp_path):
    ds = str(tmp_path / "ds")
    cli.main(["synth", "--dataset", ds, "--n-tracks", "120",
              "--n-collections", "30", "--n-positives", "400",
              "--feature-dim", "16", "--seed", "1"])
    out = str(tmp_path / "emb.npy")
    cli.main(["embed", "--dataset", ds, "--out", out, "--device", "cpu"])
    emb = np.load(out)
    assert emb.shape == (120, 128) and np.isfinite(emb).all()
    # the sweep's cache is reused and the seeded init repeats
    again = cli.embed_dataset(ds, device="cpu")
    np.testing.assert_array_equal(again, emb)


def test_packed_tables_fullgraph_rule_and_blocks_match_jax():
    """pack_nbhds (and its numpy twin, and the unpacking gather),
    fullgraph_wins, pinsage_forward_fullgraph and embed_all's "blocks"
    strategy against the JAX package's."""
    n = 90
    jparams = _jax_params(5)
    port = params_from_numpy(_numpy_tree(jparams))
    feats = np.random.default_rng(5).normal(size=(n, IN)).astype(np.float32)
    w, nodes = _nbhds(n, T + 2, seed=5)
    tf, tw, tn = (torch.from_numpy(a) for a in (feats, w, nodes))
    jf, jw, jn = (jnp.asarray(a) for a in (feats, w, nodes))
    want = np.asarray(jp.pack_nbhds(jw, jn, T))
    np.testing.assert_array_equal(tp.pack_nbhds(tw, tn, T).numpy(), want)
    np.testing.assert_array_equal(tp.pack_nbhds_np(w, nodes, T), want)
    ids = torch.tensor([4, 5, 89, 4])
    got_w, got_n = tp.packed_nbhd_gather(tp.pack_nbhds(tw, tn, T), T)(ids)
    np.testing.assert_array_equal(got_w.numpy(), w[ids.numpy(), :T])
    np.testing.assert_array_equal(got_n.numpy(), nodes[ids.numpy(), :T])
    for rows, items, layers, t in ((384, 100_000, 2, 10), (12288, 20_000, 2,
                                                          3), (3, 5, 1, 1)):
        assert tp.fullgraph_wins(rows, items, layers, t) == jp.fullgraph_wins(
            rows, items, layers, t)
    nodeset = np.asarray([0, 5, 17, 89, 17], np.int32)
    with torch.inference_mode():
        full = tp.pinsage_forward_fullgraph(port, tf, tw, tn,
                                            torch.from_numpy(nodeset), L, T)
    np.testing.assert_allclose(full.numpy(), np.asarray(
        jp.pinsage_forward_fullgraph(jparams, jf, jw, jn,
                                     jnp.asarray(nodeset), L, T)), atol=ATOL)
    blocks = tp.embed_all(port, tf, tw, tn, n, L, T, batch_size=32,
                          strategy="blocks")
    np.testing.assert_allclose(blocks.numpy(), np.asarray(jp.embed_all(
        jparams, jf, jw, jn, n, L, T, batch_size=32, blocks_per_call=2,
        strategy="blocks")), atol=ATOL)
    with pytest.raises(ValueError, match="strategy"):
        tp.embed_all(port, tf, tw, tn, n, L, T, strategy="scan")
