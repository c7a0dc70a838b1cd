"""Multi-process ``torch.distributed`` worlds for the port's tests, on
the CPU over gloo (not a test module).

``run_world(tmp_path, world, worker, payload)`` pickles ``payload``,
starts ``world`` processes of this file (``python torch_dist.py WORKER
RANK WORLD DIR``), each of which joins a gloo world through a
``file://`` store in ``DIR`` (no port, so parallel test workers never
collide), runs ``WORKERS[WORKER](rank, world, payload, DIR)`` on one
torch thread and pickles its result.  A rank that fails or outlives the
timeout takes the others down.  This module imports neither JAX nor the
JAX package, so the children never load them: the tests compute JAX's
side in their own process and pass numpy arrays.

``torchrun(nproc, module, args)`` starts ``python -m
torch.distributed.run --standalone`` on a module of the port (a CLI
verb), on the CPU, one torch thread a rank; ``stop`` ends it and every
rank.
"""

from __future__ import annotations

import os
import pickle
import signal
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _cpu_env() -> dict:
    env = {**os.environ, "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": os.pathsep.join(
               [REPO, os.environ.get("PYTHONPATH", "")])}
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(var, None)
    return env


def torchrun(nproc: int, module: str, args: list, log: str
             ) -> subprocess.Popen:
    """``torchrun --standalone --nproc_per_node nproc -m module *args``
    with its output (every rank's) in ``log``, each line written there as
    a rank prints it."""
    with open(log, "w") as f:
        return subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(nproc), "-m", module, *args],
            stdout=f, stderr=subprocess.STDOUT,
            env={**_cpu_env(), "PYTHONUNBUFFERED": "1"}, cwd=REPO)


def _children(pid: int) -> list[int]:
    """The processes whose parent is ``pid`` (Linux ``/proc``)."""
    out = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    stat = f.read()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                out.append(int(entry))
    return out


def stop(proc: subprocess.Popen, grace: float = 30.0) -> None:
    """End torchrun and its ranks.  torchrun starts each rank in a
    session of its own, so a signal to torchrun's group misses them; on
    SIGTERM torchrun takes them down itself.  Past ``grace`` the ranks
    and torchrun are killed."""
    if proc.poll() is None:
        ranks = _children(proc.pid)
        proc.terminate()
        try:
            proc.wait(timeout=grace)
        except subprocess.TimeoutExpired:
            for pid in ranks + [proc.pid]:
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
    proc.wait()


def torchrun_to_end(nproc: int, module: str, args: list, log: str,
                    timeout: float = 300.0) -> str:
    """``torchrun`` run to its end: its output, or AssertionError with it
    where it failed or outlived ``timeout``."""
    proc = torchrun(nproc, module, args, log)
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        stop(proc)
    with open(log) as f:
        text = f.read()
    if proc.returncode != 0:
        raise AssertionError(f"torchrun {module} {args} exited "
                             f"{proc.returncode}:\n{text[-6000:]}")
    return text


def run_world(tmp_path, world: int, worker: str, payload,
              timeout: float = 300.0, device: str = "cpu") -> list:
    """Each rank's pickled result, in rank order.  ``device="cuda"`` puts
    every rank on the first GPU, still over gloo (NCCL takes one rank a
    GPU)."""
    d = str(tmp_path)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    env = {**_cpu_env(), "WORLD_DEVICE": device}
    if device != "cpu":
        env.pop("CUDA_VISIBLE_DEVICES")
        if "CUDA_VISIBLE_DEVICES" in os.environ:
            env["CUDA_VISIBLE_DEVICES"] = os.environ["CUDA_VISIBLE_DEVICES"]
    logs = [open(os.path.join(d, f"log_{r}.txt"), "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), worker, str(r),
         str(world), d], stdout=logs[r], stderr=subprocess.STDOUT, env=env,
        cwd=REPO) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = []
        for r in bad:
            with open(os.path.join(d, f"log_{r}.txt")) as f:
                tails.append(f"--- rank {r} (exit {procs[r].returncode}):\n"
                             + f.read()[-4000:])
        raise AssertionError("world failed:\n" + "\n".join(tails))
    out = []
    for r in range(world):
        with open(os.path.join(d, f"result_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def same_up_to_ties(w, n, w_ref, n_ref, atol: float = 1e-6) -> int:
    """Two rankings ([B, k] scores sorted descending, and their ids) are
    one up to ties: the scores agree within ``atol`` at every position
    (-inf where the other has -inf), and each run of tied finite scores
    (neighbors within ``atol`` in either ranking) that ends before the
    last position holds the same ids in both.  Returns the ids left
    unchecked: those of a run that reaches position k - 1 (its members
    may go on past k) and the -inf fills."""
    import numpy as np

    w, w_ref = np.asarray(w, np.float64), np.asarray(w_ref, np.float64)
    np.testing.assert_allclose(w, w_ref, atol=atol, rtol=0)
    unchecked = 0
    for wi, ri, ni, mi in zip(w, w_ref, n, n_ref):
        finite = np.isfinite(ri)
        unchecked += int((~finite).sum())
        k = int(finite.sum())
        start = 0
        for i in range(1, k + 1):
            if i < k and (abs(wi[i] - wi[i - 1]) <= atol
                          or abs(ri[i] - ri[i - 1]) <= atol):
                continue
            if i == len(wi) and start < i:       # the run reaches k - 1
                unchecked += i - start
            elif sorted(ni[start:i]) != sorted(mi[start:i]):
                raise AssertionError(
                    f"ids differ in positions {start}..{i - 1}: "
                    f"{list(ni[start:i])} vs {list(mi[start:i])}")
            start = i
    return unchecked


# ------------------------------------------------------------- workers

def _np(t):
    return t.detach().cpu().numpy()


def _leaves(params) -> dict:
    return {name: _np(p) for name, p in params.leaves()}


def parallel_checks(rank: int, world: int, p: dict, d: str) -> dict:
    """tests/test_torch_parallel.py's port side, on a world of 4."""
    import warnings

    import torch

    from gcn_song_embeddings_tpu_torch.config import (
        RunConfig,
        WalkConfig,
        config_with_overrides,
    )
    from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
    from gcn_song_embeddings_tpu_torch.ops.ppr import (
        precompute_neighborhoods_multichip,
    )
    from gcn_song_embeddings_tpu_torch.parallel.gather import (
        sharded_table_gather,
        sharded_table_gather_ring,
    )
    from gcn_song_embeddings_tpu_torch.parallel.mesh import (
        make_mesh,
        pad_to_multiple,
    )
    from gcn_song_embeddings_tpu_torch.parallel.train_step import (
        ShardedTrainer,
    )
    from gcn_song_embeddings_tpu_torch.parallel.walks_sharded import (
        make_sharded_walker,
        make_sharded_walker_fused,
        precompute_neighborhoods_partitioned,
        shard_graph,
        shard_graph_fused,
    )
    from gcn_song_embeddings_tpu_torch.ops.ppr import seeded_generator
    from gcn_song_embeddings_tpu_torch.utils.checkpoint import (
        params_from_numpy,
    )

    out = {}
    # -- gathers: f32 (with the backward) and int32 tables, both forms
    for shape in ((1, 4), (2, 2)):
        mesh = make_mesh(*shape)
        g, gi, group = mesh.n_graph, mesh.graph_index, mesh.graph_group
        res = {}
        for name, table in (("f32", p["table"]), ("i32", p["itable"])):
            rows = pad_to_multiple(table.shape[0], g) // g
            full = torch.zeros((rows * g,) + table.shape[1:],
                               dtype=torch.from_numpy(table).dtype)
            full[:table.shape[0]] = torch.from_numpy(table)
            ids = torch.from_numpy(p["ids"][rank])
            for form, fn in (("scatter", sharded_table_gather),
                             ("ring", sharded_table_gather_ring)):
                local = full[gi * rows:(gi + 1) * rows].clone()
                if name == "f32":
                    local.requires_grad_(True)
                got = fn(local, ids, group)
                res[(name, form)] = _np(got)
                if name == "f32":
                    (got * torch.from_numpy(p["grads"][rank])).sum().backward()
                    res[(name, form, "grad")] = _np(local.grad)
        out[("gather", shape)] = res

    # -- edge-partitioned walkers on a (2, 2) mesh, fed JAX's uniforms
    mesh = make_mesh(2, 2)
    dg = DeviceGraph.from_arrays(*p["csr"], "cpu")
    sg, sgf = shard_graph(dg, mesh), shard_graph_fused(dg, mesh)
    w = p["walk_nodes"].shape[0] // world
    nodes = torch.from_numpy(p["walk_nodes"][rank * w:(rank + 1) * w])
    for (fused, chains), u in p["walk_u"].items():
        make = make_sharded_walker_fused if fused else make_sharded_walker
        walker = make(mesh, sgf if fused else sg, p["n_hops"], p["alpha"],
                      n_chains=chains)
        out[("walk", fused, chains)] = _np(walker(
            nodes, torch.from_numpy(u[rank])))

    # -- sweeps: multi-device (blocks dealt round-robin), partitioned
    wcfg = WalkConfig(**p["walk_cfg"])
    out["multichip"] = precompute_neighborhoods_multichip(
        dg, wcfg, os.path.join(d, "multichip.npz"), seed=0)
    part_u = p["part_u"]
    out["partitioned"] = precompute_neighborhoods_partitioned(
        dg, wcfg, mesh, os.path.join(d, "partitioned.npz"), seed=0,
        uniforms=lambda start, r, n: torch.from_numpy(part_u[(start, r)]))
    out["partitioned_own"] = precompute_neighborhoods_partitioned(
        dg, WalkConfig(**{**p["walk_cfg"], "fused_tables": False}), mesh,
        seed=3)

    # -- sharded training, fed JAX's batches and initial params
    feats, nb_w, nb_n, pos = p["toy"]
    for name, over, gather_impl in p["trainers"]:
        cfg = config_with_overrides(RunConfig(), over)
        tr = ShardedTrainer(mesh, cfg, feats.shape[0], feats, (nb_w, nb_n),
                            pos, gather_impl=gather_impl,
                            params=params_from_numpy(p["jparams"]))
        losses = tr.train_chunk(3, batches=[b[rank] for b in
                                            p["batches"][name]])
        out[("train", name)] = (losses, _leaves(tr.params),
                                tr.embed(batch_size=64), tr.fullgraph)
    # train.dtype="bfloat16" does not apply to the sharded step: it
    # trains in f32 after one warning, as the JAX package's
    for name, over, gather_impl in p["trainers"][:2]:
        cfg = config_with_overrides(RunConfig(), {
            **over, "train.dtype": "bfloat16"})
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tr = ShardedTrainer(mesh, cfg, feats.shape[0], feats,
                                (nb_w, nb_n), pos, gather_impl=gather_impl,
                                params=params_from_numpy(p["jparams"]))
        losses = tr.train_chunk(3, batches=[b[rank] for b in
                                            p["batches"][name]])
        out[("train_bf16", name)] = (losses, _leaves(tr.params),
                                     [str(w.message) for w in caught])

    # -- the port's own draws: hard negatives through the sharded table,
    #    the hn_start_epoch gate, and a resume in the middle of an epoch
    base = {"model.in_dim": 32, "model.hidden_dim": 32,
            "model.out_dim": 16, "train.batch_size": 64, "train.lr": 1e-3,
            "train.margin": 0.1, "train.batches_per_epoch": 3}
    hard = config_with_overrides(RunConfig(), {
        **base, "train.hard_negatives": True, "train.hn_min": 2,
        "train.hn_max": 7})
    tr = ShardedTrainer(mesh, hard, feats.shape[0], feats, (nb_w, nb_n), pos)
    shared = seeded_generator([9, 0], mesh.device)
    own = seeded_generator([9, 0, rank], mesh.device)
    out["hard_batch"] = _np(tr.sample(shared, own))
    gated = config_with_overrides(hard, {"train.hn_start_epoch": 1})
    tr = ShardedTrainer(mesh, gated, feats.shape[0], feats, (nb_w, nb_n),
                        pos)
    out["gated_batches"] = [_np(tr.sample(shared, own))]
    tr.opt.count = 3                          # one epoch done
    out["gated_batches"].append(_np(tr.sample(shared, own)))
    exact = config_with_overrides(RunConfig(), {
        **base, "train.exact_batch_sampling": True})
    tr = ShardedTrainer(mesh, exact, feats.shape[0], feats, (nb_w, nb_n),
                        pos)
    out["exact_batch"] = _np(tr.sample(shared, own))

    cfg = config_with_overrides(RunConfig(), base)
    path = os.path.join(d, "state.npz")
    full = ShardedTrainer(mesh, cfg, feats.shape[0], feats, (nb_w, nb_n),
                          pos)
    full_losses = list(full.train_chunk(2)) + list(full.train_chunk(2))
    half = ShardedTrainer(mesh, cfg, feats.shape[0], feats, (nb_w, nb_n),
                          pos)
    half.train_chunk(2)
    half.save(path)
    resumed = ShardedTrainer(mesh, cfg, feats.shape[0], feats, (nb_w, nb_n),
                             pos)
    loaded = resumed.load(path)
    progress = (resumed.batches_done, resumed.epoch)
    resumed_losses = list(resumed.train_chunk(2))
    out["resume"] = dict(
        loaded=loaded, progress=progress, full_losses=full_losses,
        resumed_losses=resumed_losses, full=_leaves(full.params),
        resumed=_leaves(resumed.params), half=_leaves(half.params),
        path=path)
    return out


def serve_checks(rank: int, world: int, p: dict, d: str) -> dict:
    """tests/test_torch_serve_sharded.py's port side: every index form
    and gather schedule, the refusals, and (``p["http"]``) one HTTP
    session served by rank 0 while the other ranks follow, each wait on
    rank 0 longer than the serving group's timeout."""
    import json
    import threading
    import urllib.error
    import urllib.request
    from datetime import timedelta

    import numpy as np

    from gcn_song_embeddings_tpu_torch.parallel import multihost
    from gcn_song_embeddings_tpu_torch.parallel.mesh import make_mesh
    from gcn_song_embeddings_tpu_torch.parallel.serve_sharded import (
        ShardedServeIndex,
        ShardedServingFrontend,
    )
    from gcn_song_embeddings_tpu_torch.serve import serve

    mesh = make_mesh(n_dp=1)
    emb, nbhds, rows, k = p["emb"], p["nbhds"], p["rows"], p["k"]
    out = {}
    for quantized in (False, True):
        for impl in ("psum_scatter", "ring"):
            idx = ShardedServeIndex(emb, mesh, nbhds=nbhds,
                                    quantized=quantized, k_cap=p["k_cap"],
                                    gather_impl=impl)
            out[("knn", quantized, impl)] = idx.knn_rows(rows, k)
            out[("hybrid", quantized, impl)] = idx.hybrid_knn_rows(rows, k)
            every = np.arange(idx.n)
            out[("every", quantized, impl)] = idx.knn_rows(every, idx.k_cap)
    out["k_cap"] = idx.k_cap
    errors = []
    for call in (lambda: idx.knn_rows(np.array([idx.n])),
                 lambda: idx.knn_rows(np.array([], np.int32)),
                 lambda: ShardedServeIndex(emb, mesh).hybrid_knn_rows([0])):
        try:
            call()
        except (IndexError, ValueError) as e:
            errors.append(type(e).__name__)
    out["errors"] = errors
    if not p.get("http"):
        return out
    # rank 0 keeps the others waiting longer than the serving group's
    # timeout twice: at the barrier while it works alone, then in
    # ``follow`` before the first request
    mesh = make_mesh(n_dp=1, timeout=timedelta(seconds=p["group_timeout_s"]))
    if rank == 0:
        time.sleep(p["idle_s"])
    multihost.wait_for_rank_0()
    idx = ShardedServeIndex(emb, mesh, nbhds=nbhds, k_cap=p["k_cap"])
    if rank != 0:
        idx.follow()
        return out
    front = ShardedServingFrontend(idx, track_ids=p["track_ids"],
                                   tracks_meta=p["meta"])
    server = serve(front, port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    http = {}
    try:
        t = time.monotonic()
        time.sleep(p["idle_s"])
        http["idle_s"] = time.monotonic() - t
        def get(path):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                        timeout=60) as r:
                return json.loads(r.read())

        http["health"] = get("/healthz")
        http["one"] = get(f"/knn?track={p['track_ids'][3]}&k=5")
        http["batch"] = get("/knn?indices=1,2,3&k=4")
        http["embed"] = get(f"/embed?track={p['track_ids'][3]}")
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/add",
            data=json.dumps({"tracks": [{"track": "new", "embedding":
                                         [0.0] * emb.shape[1]}]}).encode())
        try:
            urllib.request.urlopen(req, timeout=60)
        except urllib.error.HTTPError as e:
            http["add"] = (e.code, json.loads(e.read()))
    finally:
        server.shutdown()
        server.server_close()
        front.close()
    out["http"] = http
    return out


def gpu_checks(rank: int, world: int, p: dict, d: str) -> dict:
    """tests/test_torch_parallel_gpu.py's ranks: the gathers and 3-step
    trajectories on the card (gloo), with the kernels' launch counts."""
    import torch

    from gcn_song_embeddings_tpu_torch.config import (
        RunConfig,
        config_with_overrides,
    )
    from gcn_song_embeddings_tpu_torch.ops import agg, dma_agg
    from gcn_song_embeddings_tpu_torch.parallel.gather import (
        sharded_table_gather,
        sharded_table_gather_ring,
    )
    from gcn_song_embeddings_tpu_torch.parallel.mesh import make_mesh
    from gcn_song_embeddings_tpu_torch.parallel.train_step import (
        ShardedTrainer,
    )
    from gcn_song_embeddings_tpu_torch.utils.checkpoint import (
        params_from_numpy,
    )

    mesh = make_mesh(1, world)
    dev = mesh.device
    table = torch.from_numpy(p["table"]).to(dev)
    rows = table.shape[0] // world
    out = {}
    for form, fn in (("scatter", sharded_table_gather),
                     ("ring", sharded_table_gather_ring)):
        local = table[rank * rows:(rank + 1) * rows].clone().requires_grad_()
        got = fn(local, torch.from_numpy(p["ids"][rank]).to(dev),
                 mesh.graph_group)
        (got * torch.from_numpy(p["grads"][rank]).to(dev)).sum().backward()
        out[("gather", form)] = (_np(got), _np(local.grad))
    feats, nb_w, nb_n, pos = p["toy"]
    for name, over in p["trainers"]:
        cfg = config_with_overrides(RunConfig(), over)
        tr = ShardedTrainer(mesh, cfg, feats.shape[0], feats, (nb_w, nb_n),
                            pos, params=params_from_numpy(p["params"]))
        before = (dma_agg.launches, agg.launches)
        b = cfg.train.batch_size // world
        losses = tr.train_chunk(3, batches=[
            bt[rank * b:(rank + 1) * b] for bt in p["batches"]])
        out[("train", name)] = (losses, _leaves(tr.params),
                                (dma_agg.launches - before[0],
                                 agg.launches - before[1]))
    return out


def scaling_checks(rank: int, world: int, p: dict, d: str) -> dict:
    """tests/test_torch_scaling_bench.py's ranks.  Every rank lays out
    each mesh of ``p["meshes"]`` ({name: (ranks or None, n_dp, n_graph,
    train)}) and, on each mesh it belongs to that has ``train``, trains
    ``p["runs"]`` (3 steps on the given batches, or on the trainer's own
    draws), checkpoints with ``save`` and embeds; then, with
    ``p["bench"]``, runs ``scaling_bench.run`` with those flags in this
    world."""
    import argparse

    from gcn_song_embeddings_tpu_torch import scaling_bench
    from gcn_song_embeddings_tpu_torch.config import (
        RunConfig,
        config_with_overrides,
    )
    from gcn_song_embeddings_tpu_torch.parallel.mesh import make_mesh
    from gcn_song_embeddings_tpu_torch.parallel.train_step import (
        ShardedTrainer,
    )

    feats, nb_w, nb_n, pos = p["toy"]
    out = {}
    meshes = {name: make_mesh(n_dp, n_graph, ranks=ranks)
              for name, (ranks, n_dp, n_graph, _) in p["meshes"].items()}
    for name, mesh in meshes.items():
        out[("mesh", name)] = None if mesh is None else (
            mesh.rank, mesh.shape, mesh.group is None)
        if mesh is None or not p["meshes"][name][3]:
            continue
        for run, (over, batches) in p["runs"].items():
            cfg = config_with_overrides(RunConfig(), over)
            tr = ShardedTrainer(mesh, cfg, feats.shape[0], feats,
                                (nb_w, nb_n), pos)
            b = cfg.train.batch_size // mesh.n_dev
            mine = None if batches is None else [
                bt[mesh.rank * b:(mesh.rank + 1) * b] for bt in batches]
            losses = tr.train_chunk(3, batches=mine)
            path = os.path.join(d, f"{name}_{run}_state.npz")
            tr.save(path)
            out[(name, run)] = (losses, _leaves(tr.params),
                                tr.embed(batch_size=16), os.path.isfile(path))
    if p.get("bench"):
        out["bench"] = scaling_bench.run(argparse.Namespace(**p["bench"]),
                                         log=lambda *a: None)
    return out


WORKERS = {"parallel_checks": parallel_checks, "serve_checks": serve_checks,
           "gpu_checks": gpu_checks, "scaling_checks": scaling_checks}


def _main() -> None:
    worker, rank, world, d = (sys.argv[1], int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    sys.path.insert(0, HERE)
    import torch

    torch.set_num_threads(1)
    from gcn_song_embeddings_tpu_torch.parallel import multihost

    with open(os.path.join(d, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    device = os.environ.get("WORLD_DEVICE", "cpu")
    multihost.initialize_multihost(
        f"file://{os.path.join(d, 'store')}", world, rank,
        device="cuda:0" if device == "cuda" else "cpu", backend="gloo",
        timeout_s=120)
    try:
        result = WORKERS[worker](rank, world, payload, d)
    finally:
        multihost.shutdown()
    with open(os.path.join(d, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    _main()
