"""Port's config, dataset, graph and device-graph layers vs the JAX package."""

import dataclasses
import filecmp
import os

import numpy as np
import pytest

from gcn_song_embeddings_tpu.config import RunConfig as JRunConfig
from gcn_song_embeddings_tpu.config import WalkConfig as JWalkConfig
from gcn_song_embeddings_tpu.data import make_synthetic_dataset as j_synth
from gcn_song_embeddings_tpu.data.device import (
    apply_colisten_config as j_apply_colisten,
    augment_with_colisten as j_augment,
)
from gcn_song_embeddings_tpu.ops.walks import fused_walk_tables as j_tables
from gcn_song_embeddings_tpu_torch.config import RunConfig, WalkConfig
from gcn_song_embeddings_tpu_torch.data.device import (
    DeviceGraph,
    apply_colisten_config,
    augment_with_colisten,
)
from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
from gcn_song_embeddings_tpu_torch.data.synth import make_synthetic_dataset
from gcn_song_embeddings_tpu_torch.ops.walks import fused_walk_tables

_ARRAYS = ("i2c_indptr", "i2c_indices", "c2i_indptr", "c2i_indices")


def _assert_same_graph(port: DeviceGraph, jax_graph) -> None:
    for name in _ARRAYS:
        a = getattr(port, name).numpy()
        b = np.asarray(getattr(jax_graph, name))
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert port.n_edges == jax_graph.n_edges


def test_config_matches_jax():
    assert dataclasses.asdict(RunConfig.recommended()) == \
        dataclasses.asdict(JRunConfig.recommended())
    assert dataclasses.asdict(RunConfig()) == dataclasses.asdict(JRunConfig())
    rec = RunConfig.recommended()
    assert (rec.walk.colisten_copies, rec.walk.n_hops, rec.walk.alpha,
            rec.walk.t_precompute) == (1, 500, 0.85, 100)
    assert (rec.model.T, rec.model.in_dim, rec.model.hidden_dim,
            rec.model.out_dim, rec.model.n_layers) == (10, 512, 512, 128, 2)
    assert RunConfig.from_json(JRunConfig.recommended().to_json()) == rec


def test_synthetic_dataset_byte_identical(tmp_path):
    kw = dict(n_tracks=150, n_collections=40, n_clusters=5,
              tracks_per_collection=8, n_positives=300, feature_dim=12,
              seed=3)
    a = make_synthetic_dataset(str(tmp_path / "port"), **kw)
    b = j_synth(str(tmp_path / "jax"), **kw)
    names = sorted(os.listdir(b))
    assert sorted(os.listdir(a)) == names
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name


def test_song_graph_matches_jax(graph, dataset_dir):
    g = SongGraph(dataset_dir,
                  features_file=os.path.join(dataset_dir, "features.npy"))
    assert (g.n_items, g.n_cols, g.track_ids) == (graph.n_items, graph.n_cols,
                                                  graph.track_ids)
    for a, b in ((g.i2c, graph.i2c), (g.c2i, graph.c2i)):
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.degrees(), b.degrees())
    np.testing.assert_array_equal(g.features, graph.features)
    pos = os.path.join(dataset_dir, "positives.json")
    for a, b in zip(g.load_positives_split(pos),
                    graph.load_positives_split(pos)):
        np.testing.assert_array_equal(a, b)


def test_device_graph_matches_jax(graph, device_graph):
    _assert_same_graph(DeviceGraph.from_graph(graph, "cpu"), device_graph)
    arrays = [np.asarray(getattr(device_graph, n)) for n in _ARRAYS]
    dg = DeviceGraph.from_arrays(*arrays, device="cpu")
    _assert_same_graph(dg, device_graph)
    assert (dg.n_items, dg.n_cols) == (device_graph.n_items,
                                       device_graph.n_cols)


@pytest.mark.parametrize("copies", [1, 2])
def test_colisten_augmentation_matches_jax(graph, device_graph, positives,
                                           copies):
    port = augment_with_colisten(DeviceGraph.from_graph(graph, "cpu"),
                                 positives, copies)
    _assert_same_graph(port, j_augment(device_graph, positives, copies))


@pytest.mark.parametrize("overrides", [
    {}, {"n_hops": 200, "t_precompute": 12}, {"alpha": 0.5},
    {"parallel_chains": 5}, {"colisten_copies": 0}])
def test_colisten_config_cache_naming_matches_jax(graph, device_graph,
                                                  positives, overrides):
    kw = {"colisten_copies": 1, **overrides}
    port_g, port_path = apply_colisten_config(
        DeviceGraph.from_graph(graph, "cpu"), positives, WalkConfig(**kw),
        "/data/ds/neighborhoods.npz")
    jax_g, jax_path = j_apply_colisten(device_graph, positives,
                                       JWalkConfig(**kw),
                                       "/data/ds/neighborhoods.npz")
    assert port_path == jax_path
    _assert_same_graph(port_g, jax_g)


def test_fused_walk_tables_match_jax(graph, device_graph, positives):
    aug = j_augment(device_graph, positives, 1)
    port = fused_walk_tables(augment_with_colisten(
        DeviceGraph.from_graph(graph, "cpu"), positives, 1))
    for a, b in zip(port, j_tables(aug)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
