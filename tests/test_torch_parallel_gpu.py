"""The multi-device layer on the card: a two-rank gloo world on the first
GPU (NCCL takes one rank a GPU), its gathers bit-equal to indexing with
the backward equal to one process's, and 3-step sharded trajectories
(frontier with K3, full-graph with K2) within rtol 1e-4 / atol 1e-5 of
the single-process ``train_step`` on the same card and batches.

Marked ``gpu``: they skip (with a reason) where no CUDA device is
present, deciding inside a fixture.  They import nothing of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_parallel_gpu.py
"""

import numpy as np
import pytest
import torch

from gcn_song_embeddings_tpu_torch.config import (
    RunConfig,
    config_with_overrides,
)
from gcn_song_embeddings_tpu_torch.models.pinsage import init_pinsage
from gcn_song_embeddings_tpu_torch.train.trainer import (
    TrainTables,
    make_optimizer,
    train_step,
)
from gcn_song_embeddings_tpu_torch.utils.checkpoint import (
    params_from_numpy,
    params_to_numpy,
)
from torch_dist import run_world

pytestmark = pytest.mark.gpu

TRAJ = dict(rtol=1e-4, atol=1e-5)
TOY = {"model.in_dim": 32, "model.hidden_dim": 32, "model.out_dim": 16,
       "train.batch_size": 64, "train.lr": 1e-3, "train.margin": 0.1}
TRAINERS = [("frontier", {**TOY, "train.fullgraph_forward": "off"}),
            ("fullgraph", {**TOY, "train.fullgraph_forward": "on"})]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def world(card, tmp_path_factory):
    rng = np.random.default_rng(0)
    n = 256
    feat = rng.normal(size=(n, 32)).astype(np.float32)
    nb_n = rng.integers(0, n, size=(n, 8)).astype(np.int32)
    nb_w = np.sort(rng.random((n, 8)).astype(np.float32), axis=1)[:, ::-1]
    pos = rng.integers(0, n, size=(1024, 2)).astype(np.int32)
    gen = torch.Generator().manual_seed(0)
    params = params_to_numpy(init_pinsage(gen, 2, 32, 32, 16))
    p = {"table": rng.normal(size=(64, 5)).astype(np.float32),
         "ids": rng.integers(0, 64, size=(2, 19)).astype(np.int32),
         "grads": rng.normal(size=(2, 19, 5)).astype(np.float32),
         "toy": (feat, np.ascontiguousarray(nb_w), nb_n, pos),
         "params": params, "trainers": TRAINERS,
         "batches": [rng.integers(0, n, (64, 3)).astype(np.int32)
                     for _ in range(3)]}
    return p, run_world(tmp_path_factory.mktemp("gpu"), 2, "gpu_checks", p,
                        device="cuda")


def test_gathers_on_the_card(world):
    p, results = world
    table = torch.from_numpy(p["table"]).requires_grad_(True)
    loss = sum((table[torch.from_numpy(p["ids"][r]).long()]
                * torch.from_numpy(p["grads"][r])).sum() for r in range(2))
    loss.backward()
    for form in ("scatter", "ring"):
        grads = []
        for rank, out in enumerate(results):
            got, grad = out[("gather", form)]
            np.testing.assert_array_equal(got, p["table"][p["ids"][rank]])
            grads.append(grad)
        np.testing.assert_allclose(np.concatenate(grads), table.grad.numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,over", TRAINERS)
def test_sharded_trajectory_on_the_card(world, card, name, over):
    p, results = world
    cfg = config_with_overrides(RunConfig(), over)
    feat, nb_w, nb_n, _ = p["toy"]
    params = params_from_numpy(p["params"], card)
    opt = make_optimizer(params, cfg.train)
    tables = TrainTables.build(feat, nb_w, nb_n, cfg.model.T, card)
    losses = [float(train_step(params, opt, torch.from_numpy(b).to(card),
                               tables, cfg.train, cfg.model,
                               name == "fullgraph")[0]) for b in p["batches"]]
    got_losses, leaves, (k3, k2) = results[0][("train", name)]
    np.testing.assert_allclose(got_losses, losses, **TRAJ)
    for leaf, want in params.leaves():
        np.testing.assert_allclose(leaves[leaf], want.detach().cpu().numpy(),
                                   **TRAJ, err_msg=leaf)
    assert (k3 > 0) if name == "frontier" else (k2 > 0)
