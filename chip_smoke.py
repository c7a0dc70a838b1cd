#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), turns TF32 off.
2. Builds every CUDA kernel of the port from ``csrc/`` (one ``nvcc`` per
   source, all started together) and prints ``ptxas -v``'s register and
   shared-memory lines.
3. Drives the port's main path at the README's 100k scale with its
   launch counters set to 0: a 100k-track synthetic dataset (512-d
   features), ``SongGraph`` -> co-listen augmentation -> all-node PPR
   sweep (kernel K1) -> full-catalog ``embed_all`` of the full-width
   ``RunConfig.recommended()`` model from a seeded init (kernel K2) ->
   ``emb.npy`` -> HTTP serving of the hybrid ranker, live-walk (K1 per
   batch) and cached-head, answering single and batched queries.  Fails
   unless every kernel was launched.
   Then the walk-side refresh, with the counters set to 0 again: the
   graph gains 50 seeded random co-listen pairs and
   ``refresh_neighborhoods`` re-sweeps the origins they can reach (K1),
   saving under the augmented graph's cache meta; fails unless K1 ran,
   every unaffected row equals the sweep's bit for bit and
   ``precompute_neighborhoods`` on the augmented graph serves the saved
   artifact unchanged.  Prints the affected share and ``refresh_s``
   beside ``sweep_s`` (and the refresh without its cache write).
4. Drives the training path with the counters set to 0 again: ``cli
   train`` of the same full-width model on the same dataset and cached
   sweep, 2 epochs x 25 batches of 128 triples in chunks of 20 (so a
   chunk crosses the epoch boundary), frontier forward (kernel K3, with
   the aggregation's backward), then ``emb.npy`` (K2) served through the
   cached-head hybrid.  Fails unless K2, K3 and the backward ran, the 50
   metric rows are finite, the loss fell, the rate stepped x0.95 at batch
   25 and a second trainer resumes at epoch 2 with the same embeddings,
   and unless the backward took its frontier form there, without a CSR.
5. Three-step checks from the seeded init on the same batches:
   ``fullgraph_forward`` on (K2 forward + backward at N=100k) against off
   (K3), every parameter at rtol 1e-4 / atol 1e-5; the card against the
   CPU (the plain versions), losses, G1_w and embeddings as
   tests/test_trainer.py holds them.  Then the train step's wall at B=128
   and a ``torch.profiler`` pass over it (device busy share, launches).
   Then, with the counters set to 0 again, the 16-bit phases, bf16 then
   f16: ``cli train --set train.dtype="bfloat16"`` (``"float16"``) on
   the same schedule (run ``smoke_bf16``, ``smoke_f16``; K3's 16-bit form
   on the deepest layer) and ``cli embed`` of its checkpoint: 50 finite
   rows with a falling loss, f32 master leaves and Adam moments, the
   embed within 1e-4 of the CPU path on 64 nodes; then (counters at 0) 3
   frontier steps on the card against the CPU (tests/test_torch_bf16.py's
   and test_torch_f16.py's bars) and 3 full-graph steps (K2's 16-bit
   form, forward and backward); the step's wall and profile in every
   dtype and both forwards.  Then the tail (counters at 0):
   ``explore.crawl_walk_counts`` from 4 tracks of the catalog (K1),
   ``profiling.Timer`` phases on CUDA events, a ``profiling.
   device_profile`` trace, the recommendation lists and figure of 3
   queries from the f32 and bf16 runs' embeddings.
6. Holds ``embed_all`` at N=100k to one K2 projection per layer, at its
   default block and at ``block_rows=32_768`` alike (same embeddings
   within 1e-5).  (The eval path runs in step 13, on the roster.)
7. Drives the int8 serving path on the trained ``emb.npy`` with the
   counters set to 0 again: the int8 ``EmbeddingIndex`` and the int8
   cached-head and live-walk (K1) ``HybridIndex`` answer single and batched
   HTTP requests; 16 tracks are added and 4 removed through ``POST /add``
   and ``/remove`` (the added ones found through their own embeddings,
   the removed ones gone, ``compact()`` leaving the answers unchanged);
   the served table is quantized with stochastic rounding (kernel K4).
   Then int8 scores on the card are held bit-equal to the CPU's, the
   int8-vs-f32 top-10 overlap and the device bytes of both tables are
   printed, and K4 is held to its plain version (``torch.equal``) and to
   the stochastic quantizer's contract (tests/test_quantize.py:40-48).
8. Right after step 3, drives ``prepare`` and ``all`` with the counters
   set to 0 again, on a 10,000-track dataset made as the main one is
   (graph.json, tracks.json, collections.json; cut from 100k for the
   time limit): ``cli prepare --features random --gen-positives``
   (10,000 per-track feature files, the consolidated matrix, the PPR
   sweep with K1 under ``WalkConfig()``, walk positives), then ``cli
   all`` (the same prepare, ``train`` cut as in step 4, ``eval`` of
   Random, PageRank (K1) and its own ``PinSage:<run>`` row at K=100).
   Fails unless K1 ran once a sweep block (3) in
   prepare and never in all's prepare or train (the cache and the
   per-track files are reused), ``features_random.npy`` is bit-equal to a
   numpy replay of ``RandomFeatures(512, seed=0)``, every walk pair lies
   in its origin's top 3 with weight > 0 and equals
   ``generate_walk_positives`` on the written cache, all rewrote the same
   positives.json and its PinSage row's hit@100 beats Random's.
9. Then audio features at the nets' published widths: a 256-track catalog
   with seeded 30 s clips (half 22,050 Hz ``.wav``, half 16 kHz
   ``.npy``), ``cli prepare --features`` mfcc, openl3, vggish and musicnn
   (random init), each timed; for 2 clips, each front end and embedder
   on the card against the port's CPU path (mel front ends rtol 1e-4 /
   atol 1e-4, OpenL3's dB mel atol 1e-3, embeddings rtol 1e-3 / atol
   1e-3); the MFCC batch's peak device memory at 512 clips; an mp3 round
   trip where the FFmpeg decoder was built.  Prints a ``prepare_checks``
   line.
10. Holds each kernel against its plain PyTorch version on the card at the
   paths' shapes (K1 at the sweep's (the refresh's too), alpha 0.85 and
   0, at the live-walk requests' B=1 and B=4 and at eval's PageRank
   block of 1000 (the Hybrid head's too), each timed with its own bound;
   K1 and K4 bit-identical, K2 and K3 within 1e-4
   absolute, K2's Wq split, projection and gather-mean each against its
   own plain version; the aggregation's backward within GRAD_RTOL of
   float64 autograd at its f32 leaky_relu slopes, any entry whose slope
   differs in float64 within BRANCH_ATOL of 0, beside the f32 plain
   version's own error, and its kernels equal to their twins bit for
   bit: the frontier form at the frontier steps' shapes, whose ids are
   the identity (also equal to the table twin over the CSR of the
   ``arange``), the table form elsewhere and on ids with rows named up
   to 100,000 times (``hub_timing``, in 0, 1 and 3 bf16 passes), and
   the frontier form over K2's projected table at the frontier steps'
   shapes, the sharded full-graph step's ``conv_apply``
   (``frontier_k2_holds``, in 0, 1 and 3 bf16 passes)), logs
   K2's and K3's max error against float64 beside the plain version's,
   and times kernel, plain version and a library yardstick with CUDA
   events, back to back on the device (K2 also against a project-once
   library composition); each kernel's ``host_ms`` is its time per call
   as the host issues them, its wrapper included.  K2's
   and K3's bounds count their products on the TF32 tensor cores in
   three passes (3xTF32); ``bound_f32_simt_ms`` keeps the f32 one.  The
   bf16 and f16 forms (K3 at the deepest conv of a 16-bit step, K2 at
   both full-graph layers on 16-bit tables and weights) are held within
   1e-4 of their plain versions and, against float64 on the same 16-bit
   inputs, within 4x the plain version's error; their bounds count one
   pass on the 16-bit tensor cores; K2's 16-bit rows carry their tiling,
   projection and gather one by one (``parts``) and the gather's L2
   read rate beside the same gather over ids in table order.
11. Right after the int8 path, the multi-device layer (``parallel/``)
   with the counters set to 0 again in each process, held to two
   single-process runs of 3 steps from one seeded init on 3 global
   batches of 128: ``one`` (each batch whole) and ``halves`` (each
   rank's 64-row half alone, its loss over 2, the gradients summed).
   (a) A world of one on NCCL in this process: the multi-device sweep
   with K1, bit-equal to the main path's; ``ShardedTrainer`` 3 frontier
   steps with K3 and 3 full-graph steps with K2 against ``one`` (losses
   and every parameter at TRAJ, each step's gradients at GRAD_RTOL; a
   parameter whose gradient entries differ beyond GRAD_RTOL is counted,
   not held); the full-catalog sharded embed (K3) within 2e-4 of
   ``embed_all`` of the same parameters.  (c) The sharded verbs as
   worlds of one: ``cli train --mesh-graph 1`` (its ``state.npz``
   through ``cli embed`` within 2e-4), then ``serve --sharded`` f32,
   ``--int8`` and ``--hybrid --cached-head`` in processes of their own,
   one request each equal up to ties to the single-process index.
   (b) Two ranks of this script (``--sharded-rank``) under ``torchrun``
   on the one card over gloo (NCCL takes one rank a GPU), each counting
   its own launches: both gathers bit-equal to indexing, the
   multi-device sweep bit-equal to the main path's artifact, the fused
   partitioned sweep's top-T bit-equal to K1's walks on the same
   uniforms, the same two 3-step runs against ``halves``, 4,096 ids
   embedded within 2e-4, sharded f32 / int8 / cached-head hybrid kNN of
   64 queries over a seeded 100k x 128 table equal to the single-process
   indexes up to ties (tied runs as sets; the ids left unchecked are
   counted), and one HTTP request through rank 0.  Prints a
   ``sharded_checks`` line (checks, walls, backends); NCCL across cards
   stays unverified.  Then, in the same world after its checks, with the
   counters set to 0 again, ``scaling_bench.run`` over the sub-meshes of
   the first 1 and 2 ranks (``make_mesh(ranks=...)``; rank 1 idles
   through size 1), 10 timed steps a size: the JAX script's keys, finite
   positive edges/s, K3 and its backward on both ranks (two gloo ranks
   on one card: the efficiency measures gloo, not scaling).
12. Right after the sharded path, the hard benchmark with the counters
   set to 0 again: ``hard_bench.run`` at its defaults (the hard
   generator's 20,000 tracks, seed 0; PPR sweep with K1, 10 x 500
   frontier steps at B=128 with K3 and its backward, ``embed`` with K2),
   margin 0.1, whose model is also ``serve_int8_quality``'s margin-0.1
   row; then that script's margin-1e-5 model on the same dataset and
   cache.  Fails unless PinSage reaches 1.5x raw-feature kNN on hit@100
   and mrr@1000, the margin-0.1 model's int8 drops are at most 0.02
   (hit@100) and 0.05 (MRR), and ``rank_eval`` and ``int8_rank_eval`` on
   the card are within 1e-3 of the CPU, and then holds K1, K3 (with its
   backward) and K2 to their plain versions at the shapes this phase gave
   them; prints a ``hard_checks`` line (both margins' f32 and int8
   metrics beside the JAX package's recorded ones, the kernels at the
   phase's shapes, the phase walls) after the card line.
13. Right after the hard phase, on its dataset, PPR cache and both
   models, the co-listen A/B cut (``colisten_ab``) with the counters set
   to 0 again: ``colisten_ab.run`` for cf_als, cf_bpr (TrackTrackCF on
   the train split) and the PPR controls ppr_plain and ppr_co1 (top-1000
   lists of 1000-hop walks over the plain and co-listen augmented graph,
   blocks of 2,048, K1), plain10 from the hard phase's margin-1e-5 model
   (its config, checked) and co1_T10 cut to AB_EPOCHS = 4 of its 30
   epochs (10 until PR 23; the co-listen sweep with K1, 2,000 frontier
   steps at T=10 with K3 and its backward, the embed with K2); fails
   unless co1_T10 reaches 1.5x
   plain10 on hit@100, ppr_co1 2x ppr_plain on hit@10, and co1_T10 passes
   ppr_co1 and cf_als on hit@500.  Then 3 steps and the embed of the
   co1_T20 and co1_T10_d512 configs (T=20; hidden 1024, out 512), each
   counted, and the new shapes held to their plain versions: K1 at the
   ppr_co1 control's first and padded last block (B=2,048, H=1,000,
   top-1000 equal to the arm's lists), K3 with its backward at both
   aggregations of a frontier step and K2 with the backward at both
   ``embed_all`` layers of each (K2_ATOL, GRAD_RTOL).  Then, with the
   counters set to 0 again, the eval path on the roster: ``SongGraph``
   through the native ``graph.json`` reader (timed beside the ``json``
   module's time for the same file), then ``hard_roster``'s ``cli eval``
   of every row of the JAX CLI at K = ROSTER_K = 500 over the hard
   catalog (the CLI's 1000 until PR 23; Random, PageRank and PageRankCo
   with K1, JaccardFast, Node2Vec with skip-gram cut to 1 epoch, the four
   CF rows, GraphSAGE, GAT and GCN cut to ROSTER_GNN_STEPS = 400 of their
   1,500 steps (until PR 23 uncut), Features, the
   PinSage rows ``pinsage_hard`` (the margin-0.1 model) and
   ``pinsage_hard_co`` (the cut co1_T10) and ``Hybrid:pinsage_hard_co``,
   whose walk head runs K1), counting K1's launches by row.  Fails unless
   K1 ran, both CSVs hold finite rows and every kNN cache is [N, K]
   (JaccardFast's [N, K - 1]); then ALS on the card against the CPU,
   node2vec walks on the card from CPU draws against the CPU's (every
   step an edge), the BPR and LMF scatter-adds of duplicate ids against
   float64 and each GNN row's falling loss; ``rank_eval`` on the card
   over all test pairs must give the margin-0.1 PinSage row's hit@10 and
   hit@100 within 1e-3 of the CSV's and the kNN ids of 256 of its
   queries on the card must equal a CPU f32 recompute up to ties within
   1e-6; and the roster's orderings (JAX's table's) must hold: the
   Hybrid row at least its PinSage row on hr@100 and PageRankCo on
   hr@500, PageRankCo over PageRank on hr@10, and PageRank, both
   TrackTrackCf rows and the co-listen PinSage row over Features over
   Random on hr@100.  Prints an ``eval_walls`` line and, after the card
   line, a ``colisten_checks`` line (the A/B rows beside JAX's, the
   ratios, both roster tables, the walls); the kernels line gains the
   five new-shape rows.  Between the new shapes and the roster's eval,
   the matmul precision policy (``GCN_TPU_MATMUL_PRECISION``, set in the
   process by ``utils.precision.override``): co1_T10_wide at full width
   (hidden 1024, out 256, T=10) on the A/B's data, 3 steps from one
   seeded init on the same batches and ``embed_all``, unset, ``default``
   and ``high``, the counters set to 0 before each (``run_precision_path``:
   unset runs K3 and K2 in 3xTF32 only, ``default`` / ``high`` their
   bf16x1 / bf16x3 forms and the backward in the same passes only; the
   final loss within 1e-2 of the f32 one and not equal to it at
   ``default``, ``high``'s embeddings nearer the f32 ones than
   ``default``'s; kNN, ``rank_eval`` and the f32 and int8 serving indexes
   over one table bit-equal under every value), then each bf16x form
   held against its plain version at those shapes
   (``hold_precision_kernels``: within K2_ATOL, within 4x a pass the
   plain version's error against float64 of the same rounded function, the
   backward within GRAD_RTOL of float64 autograd of it, or within 1.25x
   of the plain version's own distance where that is larger), and, at
   Din 1,024 (60 nodes x T=10 over a seeded 20,000-row table, H 1024:
   ``hold_deep_din``), K3 and K2 in both passes and on a bf16 table
   against float64 at the same bar, where the 16-bit core's promoted
   sums are what holds it.  The same phase holds the policy's reach outside PinSage (``run_precision_reach``):
   3 ``GNNCore`` steps each for sage, gat and gcn at the roster's widths,
   one 20-step skip-gram chunk at the roster's shapes, MFCC of 8 clips and
   one VGGish forward, unset, ``default`` and ``high``, each held against
   the same run on the CPU at the CPU tests' tolerances (REACH_TOL), then
   unset again, bit-equal to the first unset run, and ``default`` off
   every unset output's bits.  Prints a ``precision_checks`` line after
   the card line; the kernels line gains the four bf16x rows.
14. Right after the co-listen phase, the repository tools, each with the
   counters set to 0 again: ``grid_refschedule.run`` with the colisten
   schedule on a copy of the hard phase's dataset and PPR caches (the
   module's hard catalog byte for byte), cut to co-listen 0 and 1 at T=3,
   margin 1e-5, lr 1e-3, 1 x 500 (K3 and its backward, K2 in the
   embeds): JAX's keys sorted by MRR, the co-listen config above the
   plain one; the ref schedule's first 4-layer config on the main path's
   catalog (512-d, its plain graph swept in memory with K1), 3 steps (K3
   at L=4) and the embed (K2 over four layers); ``fullgraph_bench.run``
   at its batch sizes with chunks of 5 and 25 and no 1M embed (K3 in the
   off arms, K2 and its backward in the on arms), printing
   ``auto_picks_winner`` for each B.  Then K3 with its backward at every
   aggregation of the 4-layer step and of fullgraph_bench's B=4,096
   frontier step, against their plain versions.  Prints a
   ``tools_checks`` line (the grid rows, fullgraph_bench's JSON,
   scaling_bench's, the walls) after the card line; the kernels line
   gains the two new K3 rows.
15. Right after the tools, the bench module with the counters set to 0
   again: ``bench.run`` cut to ``BENCH_ARGV`` (chunks of 10 / 50 at the
   headline B=128 step, K3 and its backward; 2 / 10 at the FLOP-bound
   step, L=4, hidden 1024, B=4,096, full graph, in f32 with K2 and its
   backward, in bf16 with K2's 16-bit form, and on contiguous ids; one
   repetition; the gather and stream yardsticks).  Fails unless its JSON
   has an uncut run's keys, ``edges_per_step`` is 5,760, every value is
   finite and positive, both shares of the card's bound are at most
   1.05, the contiguous control ran, every kernel of the path ran and
   ``BENCH_BASELINE.json`` is unchanged; then holds K3 with its backward
   at the headline step's two aggregations, K2 with its backward and
   K2's bf16 form at the FLOP-bound step's four layers, and the two
   yardsticks (against float64 sums) to their plain versions.  Prints a
   ``bench_checks`` line after the card line; the kernels line gains the
   five bench rows.
16. Right after the bench, the 1M catalog with the counters set to 0
   again, in one work dir (``run_1m_path``): ``scale_demo`` with the
   co-listen capstone's command (``SCALE_1M_ARGV``: the hard generator
   at 1,000,000 tracks, 250,000 playlists, 1,000,000 positives, 128-d
   features; ``RunConfig()`` at full width, T=10, co-listen 1, 3 x 500
   frontier steps with K3 and its backward, the PPR sweep of the
   ~14.2M-edge augmented graph with K1, the full-graph embed with K2 in
   ``block_rows`` blocks), ``refresh_1m`` on the trainer's standing
   artifact (100 and 1,000 new pairs, K1), ``hybrid_1m`` over a seeded
   32,768 of the unique test queries (K2 in the resume's embed, K1 for
   the walk lists) and ``serve_bench`` over a 1,000,000 x 128 catalog in
   f32, int8 and cached-head hybrid form, 20 queries a client (K1 in the
   head's sweep), then K4 on the int8 run's served table; launches
   counted by path.  The dataset is written in a process of its own
   (``start_1m_dataset``) from the start of the run.  Fails unless
   every kernel ran on its path (the embed gathering each layer in more
   than one block), PinSage reaches HARD_BAR x raw-feature kNN on hit@100
   and mrr@1000, the hybrid is at least the walk row on hit@10/100/500,
   every unaffected row of each refresh equals the standing artifact,
   the refresh's TV is within TV_GAP of the seed noise's, and 64 served
   f32 answers equal an exact top-10 on the card up to ties
   (``check_1m``); then holds K1 (the sweep's first block and the
   hybrid's first query block, their top-T equal to the artifact's and
   the walk lists'), K2 at N=1M, K3 with its backward at the 1M step and
   K4 on the 1M x 128 table to their plain versions
   (``hold_1m_kernels``).  Prints a ``scale_1m_checks`` line (phase
   walls, peak device bytes, the served tables' device bytes, the int8
   top-10 overlap, JAX's 1M readings beside) after the card line; the
   kernels line gains the five 1M rows.
17. Checks the outputs: finite embeddings of the expected shape that match
   the port's CPU path on a small node set, well-formed responses, and
   the ``embed`` CLI reproducing the same embeddings.

Ends with the card line, one ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.  Exits non-zero (and prints no result)
when no CUDA device is present or any phase fails.
"""

from __future__ import annotations

import atexit
import copy
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

# the card's data-sheet peaks (dense, SXM), the package's one copy
from gcn_song_embeddings_tpu_torch.bench import (  # noqa: E402
    H100_BF16_FLOPS,
    H100_FP32_FLOPS,
    H100_HBM_BYTES,
    H100_TF32_FLOPS,
)

REPO = os.path.dirname(os.path.abspath(__file__))
K2_ATOL = 1e-4  # f32 sums of Din products in another order: ~1e-6 expected
# the aggregation's backward: the relative Frobenius error of each
# gradient against autograd through the plain version in float64.  One
# entry of pre within f32 rounding of 0 takes the other leaky_relu slope
# than in float64 and moves dWq by ~2e-4 of its norm at the train step's
# shapes; the backward and the plain version reach pre through products
# of other row counts (cuBLAS picks its kernel by shape), so either may
# carry such an entry (measured on the card: 1e-7 to 2.6e-4 for both)
GRAD_RTOL = 1e-3
# so at a shape where some entry takes another slope in the backward's
# f32 projection than in float64, the float64 reference takes each
# entry's slope from that f32 projection (``plain_at_slopes``), and every
# such entry must lie within BRANCH_ATOL of 0 (f32 rounding of a Din-term
# sum); elsewhere the reference is float64 autograd through the plain
# version as it stands.  At the bench's B=128 step one entry at |pre| =
# 1.6e-7 took the other slope on the card and moved dWq by 1.5e-3 of its
# norm against the float64 slope
BRANCH_ATOL = 1e-5
TRAJ = {"rtol": 1e-4, "atol": 1e-5}  # tests/test_trainer.py's 3-step bar
TRAIN_EPOCHS, TRAIN_BATCHES, TRAIN_CHUNK = 2, 25, 20
# tests/test_torch_bf16.py's and test_torch_f16.py's bars for 16-bit
# training against a reference: losses within 1e-3 relative, master
# leaves within one ulp of the dtype plus 2 lr (Adam moves an entry by at
# most about lr a step)
LOSS_RTOL16 = 1e-3
ULP16 = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}  # one ulp, relative
N_CRAWLS, N_EXPORTS = 4, 3

# the README's 100k scale: ~1M directed playlist edges
N_TRACKS, N_COLLECTIONS, TRACKS_PER_COLLECTION = 100_000, 25_000, 20
N_POSITIVES, FEATURE_DIM = 200_000, 512
SERVE_HOPS, QUERY_K = 1000, 10
N_ADDED, N_REMOVED, QUANT_SEED = 16, 4, 3
N_REFRESH_PAIRS, REFRESH_SEED = 50, 11
# the hard benchmark (hard_bench's and serve_int8_quality's defaults):
# PinSage / raw features at least HARD_BAR on hit@100 and mrr@1000 (the
# bar of tests/test_hard_synth.py), the int8 drops of the margin-0.1 model
# at most HARD_INT8_DROP, rank_eval card vs CPU within RANK_EVAL_ATOL
HARD_BAR = 1.5
HARD_INT8_DROP = {"hit100_rel_drop": 0.02, "mrr_rel_drop": 0.05}
RANK_EVAL_ATOL = 1e-3
# the JAX package's readings, for reference only.  RESULTS.md:214-219
# (hard_bench at 20,000 tracks) was read on the hard generator before
# commit 76cdaed changed it, so its features row is not this dataset's;
# results/serve_int8.json was read on the current one, and its margin-0.1
# f32 row is hard_bench's config, so it is divided by this run's features
# row (check_hard)
JAX_HARD = {
    "results_md_older_generator": {"pinsage_over_features_hit100": 3.96,
                                   "pinsage_over_features_mrr": 7.7},
    "serve_int8_margin_0.1_f32": {"hit@100": 0.26521, "mrr@1000": 0.03948},
    "int8_rel_drop": {"margin_0.1": {"hit100": 0.0018, "mrr": 0.0071},
                      "margin_1e-5": {"hit100": 0.98, "mrr": 0.9672}}}


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 2,
            queued: bool = True) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events.  ``queued``: a sleep kernel (~30 ms) holds the stream while
    the calls are queued, so the events time them back to back on the
    device and not the host's rate of issuing them.  Without it the time
    is per call as the host issues them, the wrapper's host work
    included: the ``host_ms`` of a kernel row, where a wrapper that
    outlasts its kernel shows."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def get_json(url: str):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, json.loads(r.read())


def post_json(url: str, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def check_neighbors(nbrs, query_row: int, k: int) -> None:
    ids = [n["index"] for n in nbrs]
    if len(ids) != k or len(set(ids)) != k or query_row in ids:
        raise AssertionError(f"bad neighbor list for row {query_row}: {ids}")
    if not all(isinstance(n["score"], float) for n in nbrs):
        raise AssertionError("non-float scores")


def serve_queries(serve, index, graph, rows, updates=None) -> dict:
    """Serve ``index`` on 127.0.0.1 in a thread, answer single and batched
    requests, check each response's shape, then run ``updates(base_url,
    walls)`` against the same server if given; returns request walls
    (ms)."""
    server = serve(index, host="127.0.0.1", port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{port}"
    walls = {}
    try:
        code, res = get_json(f"{base}/healthz")
        if code != 200 or res["tracks"] != graph.n_items:
            raise AssertionError(f"healthz: {code} {res}")
        for i, row in enumerate(rows[:3]):
            tid = graph.track_ids[row]
            t = time.perf_counter()
            code, res = get_json(f"{base}/knn?track={tid}&k={QUERY_K}")
            walls[f"single_{i}_ms"] = (time.perf_counter() - t) * 1e3
            if code != 200 or res["query"] != tid:
                raise AssertionError(f"knn track={tid}: {code}")
            check_neighbors(res["neighbors"], row, QUERY_K)
        tids = ",".join(graph.track_ids[r] for r in rows)
        t = time.perf_counter()
        code, res = get_json(f"{base}/knn?tracks={tids}&k={QUERY_K}")
        walls[f"batch{len(rows)}_ms"] = (time.perf_counter() - t) * 1e3
        if code != 200 or len(res["neighbors"]) != len(rows):
            raise AssertionError(f"knn tracks=: {code}")
        for row, nbrs in zip(rows, res["neighbors"]):
            check_neighbors(nbrs, row, QUERY_K)
        if updates is not None:
            updates(base, walls)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise RuntimeError("HTTP server thread did not stop")
    return walls


def online_updates(index, graph, rows, twins):
    """``POST /add`` of the ``twins`` embeddings (pairs of near-equal
    random vectors, 16 new tracks) and ``POST /remove`` of the 4 queries'
    current top neighbors, on a served int8 ``EmbeddingIndex``; then
    ``compact()``.  Checks that each added track is found through its own
    embedding (``/embed`` returns it, its twin is its top neighbor at
    cosine ~1), that the removed tracks are gone, and that ``compact()``
    leaves the catalog queries' answers unchanged (ids and scores) and
    each added track's twin first.  Returns the function the server
    runs."""
    import numpy as np

    new_ids = [f"added_{i}" for i in range(len(twins))]
    pair = [i ^ 1 for i in range(len(twins))]

    def timed(walls, name, fn):
        t = time.perf_counter()
        out = fn()
        walls[name] = (time.perf_counter() - t) * 1e3
        return out

    def answers(base, tids):
        out = {}
        for tid in tids:
            code, res = get_json(f"{base}/knn?track={tid}&k={QUERY_K}")
            if code != 200:
                raise AssertionError(f"knn track={tid}: {code}")
            out[tid] = res["neighbors"]
        return out

    def run(base, walls):
        code, res = timed(walls, "add_ms", lambda: post_json(
            f"{base}/add", {"tracks": [
                {"track": tid, "embedding": v.tolist(), "name": tid}
                for tid, v in zip(new_ids, twins)]}))
        if code != 200 or res["rows"] != list(range(graph.n_items,
                                                    graph.n_items
                                                    + len(twins))):
            raise AssertionError(f"add: {code} {res}")
        for i, tid in enumerate(new_ids):
            _, emb = get_json(f"{base}/embed?track={tid}")
            unit = twins[i] / np.linalg.norm(twins[i])
            if not np.allclose(emb["embedding"], unit, atol=1e-6):
                raise AssertionError(f"/embed of {tid} is not its own")
        before = timed(walls, "added_knn_ms", lambda: answers(base,
                                                              new_ids))
        for i, tid in enumerate(new_ids):
            top = before[tid][0]
            if top["track"] != new_ids[pair[i]] or top["score"] < 0.999:
                raise AssertionError(f"{tid}: top neighbor {top}, not its "
                                     f"twin {new_ids[pair[i]]}")
        query_tids = [graph.track_ids[r] for r in rows]
        gone = [next(o["track"] for o in nbrs if o["track"] not in query_tids)
                for nbrs in answers(base, query_tids).values()]
        code, res = timed(walls, "remove_ms", lambda: post_json(
            f"{base}/remove", {"tracks": gone}))
        _, health = get_json(f"{base}/healthz")
        if code != 200 or health["removed"] != len(set(gone)):
            raise AssertionError(f"remove: {code} {res} {health}")
        for tid in gone:
            try:
                get_json(f"{base}/knn?track={tid}&k={QUERY_K}")
            except urllib.error.HTTPError as e:
                if e.code != 400:
                    raise
            else:
                raise AssertionError(f"removed {tid} still resolves")
        after_remove = answers(base, query_tids + new_ids)
        for tid, nbrs in after_remove.items():
            if len(nbrs) != QUERY_K or set(gone) & {n["track"]
                                                    for n in nbrs}:
                raise AssertionError(f"{tid}: a removed track is served")
        t = time.perf_counter()
        index.compact()
        walls["compact_s"] = time.perf_counter() - t
        after_compact = answers(base, query_tids + new_ids)
        for tid in query_tids:
            if after_compact[tid] != after_remove[tid]:
                raise AssertionError(f"{tid}: compact() changed the answer")
        # an added track's own list holds other added tracks, scored in
        # exact f32 before compact() and in int8 after it, so entries with
        # near-equal scores may change places; its twin stays first
        moved = 0
        for i, tid in enumerate(new_ids):
            ids = [n["track"] for n in after_remove[tid]]
            now = [n["track"] for n in after_compact[tid]]
            if now[0] != new_ids[pair[i]]:
                raise AssertionError(f"{tid}: after compact() its top "
                                     f"neighbor is {now[0]}")
            moved += ids != now
        walls["added_lists_reordered_by_compact"] = moved
        log(f"int8 online updates: {len(new_ids)} added (each twin's top "
            f"neighbor, cosine >= 0.999), {len(gone)} removed; compact() "
            f"in {walls['compact_s']:.3f} s left the {len(query_tids)} "
            f"catalog queries' answers unchanged and every twin first "
            f"({moved} of the added tracks' lists reordered)")

    return run


def run_int8_path(dev, st, tr_st) -> dict:
    """The int8 serving path, as a user runs it, on the trained
    ``emb.npy``: the int8 ``EmbeddingIndex`` (with adds, removals and
    compact through HTTP), the int8 cached-head and live-walk (K1)
    ``HybridIndex`` answering HTTP requests, and the served table
    quantized with stochastic rounding (K4).  Returns its walls and what
    the checks after it need."""
    import numpy as np
    import torch

    from gcn_song_embeddings_tpu_torch import serve as serve_mod
    from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
    from gcn_song_embeddings_tpu_torch.ops.quant_kernel import (
        quantize_rows_stochastic,
    )

    graph, emb, rows = st.graph, tr_st.emb, st.rows
    meta = dict(track_ids=graph.track_ids, tracks_meta=graph.tracks)
    walls = {}
    sync(torch, dev)
    t = time.perf_counter()
    index = serve_mod.EmbeddingIndex(emb, quantized=True, device=dev,
                                     **meta)
    sync(torch, dev)
    walls["index_build_s"] = time.perf_counter() - t
    rng = np.random.default_rng(5)
    twins = np.repeat(rng.normal(size=(N_ADDED // 2, emb.shape[1])), 2,
                      axis=0).astype(np.float32)
    twins += 1e-3 * rng.normal(size=twins.shape).astype(np.float32)
    walls["embedding"] = serve_queries(
        serve_mod.serve, index, graph, rows,
        updates=online_updates(index, graph, rows, twins))
    cached = serve_mod.HybridIndex(emb, nbhds=(st.nb_w, st.nb_n),
                                   quantized=True, device=dev, **meta)
    walls["cached"] = serve_queries(serve_mod.serve, cached, graph, rows)
    t = time.perf_counter()
    live = serve_mod.HybridIndex(
        emb, DeviceGraph.from_graph(graph, dev), train_pairs=st.train_pos,
        colisten_copies=st.cfg.walk.colisten_copies, n_hops=SERVE_HOPS,
        quantized=True, device=dev, **meta)
    walls["live_index_build_s"] = time.perf_counter() - t
    walls["live"] = serve_queries(serve_mod.serve, live, graph, rows)
    # the served table, quantized with stochastic rounding (K4)
    table = torch.as_tensor(cached.unit_host, device=dev)
    sync(torch, dev)
    t = time.perf_counter()
    stochastic = quantize_rows_stochastic(table, seed=QUANT_SEED)
    sync(torch, dev)
    walls["stochastic_quantize_ms"] = (time.perf_counter() - t) * 1e3
    return {"walls": walls, "cached": cached, "table": table,
            "stochastic": stochastic}


def check_int8(torch, st, tr_st, it) -> dict:
    """The int8 path's outputs on the card: scores of 64 query rows
    bit-equal to the CPU's on the same table (ids equal up to ties), the
    device bytes of the int8 and f32 tables, and the int8-vs-f32 top-10
    overlap over 256 rows on the served table and on a random one of the
    same shape."""
    import numpy as np

    from gcn_song_embeddings_tpu_torch import serve as serve_mod
    from gcn_song_embeddings_tpu_torch.ops.quantize import int8_scores

    cached, dev = it["cached"], it["table"].device
    values, scales = cached.q_values, cached.q_scales
    n = cached.n
    rows = np.arange(0, n, n // 64)[:64]
    q = torch.as_tensor(cached.unit_host[rows])
    got = int8_scores(values, scales, q.to(dev))[:, :n]
    want = int8_scores(values.cpu(), scales.cpu(), q)[:, :n]
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"int8 scores on the card differ from the "
                             f"CPU's in {int((got.cpu() != want).sum())} "
                             f"entries")
    gw, gn = torch.topk(got, QUERY_K, dim=1)
    ww, wn = torch.topk(want, QUERY_K, dim=1)
    if not torch.equal(gw.cpu(), ww):
        raise AssertionError("int8 top-k scores differ between card and CPU")
    for i in range(len(rows)):
        for score in ww[i].unique()[1:]:          # the lowest may be cut
            if set(gn[i][gw[i] == score].tolist()) != set(
                    wn[i][ww[i] == score].tolist()):
                raise AssertionError(f"int8 top-k ids of row {rows[i]} "
                                     f"differ beyond ties")
    log(f"int8 scores of {len(rows)} rows x {n} tracks: card == CPU bit "
        f"for bit; top-{QUERY_K} ids equal up to ties")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    int8_index = serve_mod.EmbeddingIndex(tr_st.emb, quantized=True,
                                          device=dev)
    torch.cuda.synchronize()
    int8_bytes = torch.cuda.memory_allocated() - base
    f32_index = serve_mod.EmbeddingIndex(tr_st.emb, device=dev)
    torch.cuda.synchronize()
    f32_bytes = torch.cuda.memory_allocated() - base - int8_bytes
    log(f"int8 index: {int8_bytes} device bytes vs f32 {f32_bytes} "
        f"({f32_bytes / int8_bytes:.2f}x)")
    out = {"int8_scores_bit_equal_rows": len(rows),
           "int8_device_bytes": int8_bytes, "f32_device_bytes": f32_bytes}
    # the overlap on the served embeddings, and on a random unit table of
    # the same shape: int8 resolves cosines ~1e-3 apart, not ~1e-6
    random = np.random.default_rng(9).normal(
        size=tr_st.emb.shape).astype(np.float32)
    for name, pair in (("trained", (int8_index, f32_index)),
                       ("random", tuple(serve_mod.EmbeddingIndex(
                           random, quantized=q, device=dev)
                           for q in (True, False)))):
        out[f"top10_{name}"] = top10_overlap(pair, n)
        log(f"int8 vs f32 top-{QUERY_K} on the {name} table: "
            f"{out[f'top10_{name}']}")
    return out


def top10_overlap(indexes, n: int) -> dict:
    """The int8 index's top-10 against the f32 index's over 256 rows, with
    the f32 lists' mean 1st and 10th cosines and the mean gap from the
    10th to the 11th, the margin int8 rounding has to keep."""
    import numpy as np

    rows = np.arange(0, n, n // 256)[:256]
    a, b = (ix.knn_rows(rows, QUERY_K + 1) for ix in indexes)
    return {
        "overlap": float(np.mean([
            len({o["index"] for o in x[:QUERY_K]}
                & {o["index"] for o in y[:QUERY_K]}) / QUERY_K
            for x, y in zip(a, b)])),
        "f32_cos_1st": float(np.mean([y[0]["score"] for y in b])),
        "f32_cos_10th": float(np.mean([y[QUERY_K - 1]["score"] for y in b])),
        "f32_gap_10th_11th": float(np.mean([
            y[QUERY_K - 1]["score"] - y[QUERY_K]["score"] for y in b])),
    }


def measure_k1(torch, walk_kernel, tables, shapes, launches) -> dict:
    """K1 at each of ``shapes`` ((name, origins, alpha, uniforms)):
    ``torch.equal`` to its plain version, then its device time, its time
    per call as the host launches it, its plain version's time and its
    byte bound."""
    from gcn_song_embeddings_tpu_torch.ops.walks import (
        walks_from_fused_tables,
    )

    origin_ext, i2c_ext, c2i_ext = tables
    rows, err = [], 0
    for name, nodes, alpha, uniforms in shapes:
        hops, b = uniforms.shape[:2]
        got = walk_kernel.restart_walks(tables, nodes, hops, alpha, uniforms)
        want = walks_from_fused_tables(tables, nodes, hops, alpha, uniforms)
        err = max(err, int((got.long() - want.long()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"K1 trace differs from the plain walker "
                                 f"at {name}: {int((got != want).sum())} "
                                 f"entries")

        def run():
            return walk_kernel.walk_hops_cuda(tables, nodes, uniforms, alpha)

        row = {"shape": name, "ms": cuda_ms(torch, run, reps=50),
               "host_ms": cuda_ms(torch, run, reps=50, queued=False),
               "plain_ms": cuda_ms(torch, lambda: walks_from_fused_tables(
                   tables, nodes, hops, alpha, uniforms), reps=3, warmup=1)}
        nbytes = (uniforms.numel() * 4 + hops * b * 4 + b * 4
                  + min(origin_ext.numel() * 4, b * 8)
                  + min(i2c_ext.numel() * 4, hops * b * 8)
                  + min(c2i_ext.numel() * 4, hops * b * 12))
        row["bound_ms"] = nbytes / H100_HBM_BYTES * 1e3
        log(f"K1 at {name}: == plain walker; {json.dumps(row)}")
        rows.append(row)
    main = rows[0]
    return {
        "name": "K1 restart-walk hop (walk_kernel.restart_walks)",
        "route": "cuda", "source": walk_kernel.SOURCE,
        "replaces": walk_kernel.REPLACES,
        "launches": sum(launches.values()), "launches_by_path": launches,
        "max_abs_err": float(err),
        **{key: main[key] for key in ("ms", "host_ms", "plain_ms",
                                      "bound_ms")},
        "bound_by": "bytes", "library_ms": None,
        "shape": main["shape"], "shapes": rows,
    }


def measure_k4(torch, quant_kernel, table, stochastic, launches) -> dict:
    """K4 on the served table: ``torch.equal`` to its plain version
    (values and scales), the contract of tests/test_quantize.py:40-48
    (scales of ``quantize_rows`` at rtol 1e-6, at most one level from
    it, mean dequantization error below 1e-4), and its times."""
    from gcn_song_embeddings_tpu_torch.ops.quantize import quantize_rows

    values, scales = stochastic
    pv, ps = quant_kernel.quantize_rows_stochastic_plain(table, QUANT_SEED)
    if not (torch.equal(values, pv) and torch.equal(scales, ps)):
        raise AssertionError(f"K4 differs from its plain version: "
                             f"{int((values != pv).sum())} values, "
                             f"{int((scales != ps).sum())} scales")
    dv, ds = quantize_rows(table)
    if not torch.allclose(scales, ds, rtol=1e-6, atol=0):
        raise AssertionError("K4 scales differ from quantize_rows'")
    moved = (values.int() - dv.int()).abs()
    bias = float((values.float() * scales[:, None] - table).mean())
    if int(moved.max()) > 1 or not abs(bias) < 1e-4:
        raise AssertionError(f"K4 contract: max level move "
                             f"{int(moved.max())}, mean error {bias}")
    n, d = table.shape
    share = float((moved != 0).float().mean())
    log(f"K4 at {n} x {d} (seed {QUANT_SEED}): == plain version; scales == "
        f"quantize_rows' ({bool(torch.equal(scales, ds))}); "
        f"{share:.4f} of the levels moved one step from round-to-nearest; "
        f"mean dequantization error {bias:.3g}")
    nbytes = 4.0 * n * d + 1.0 * n * d + 4.0 * n
    return {
        "name": "K4 stochastic int8 row quantizer "
                "(quant_kernel.quantize_rows_stochastic)",
        "route": "cuda", "source": quant_kernel.SOURCE,
        "replaces": quant_kernel.REPLACES,
        "launches": sum(launches.values()), "launches_by_path": launches,
        "max_abs_err": float(max(int((values.int() - pv.int()).abs().max()),
                                 float((scales - ps).abs().max()))),
        "ms": cuda_ms(torch, lambda: quant_kernel.quantize_rows_cuda(
            table, QUANT_SEED), reps=50),
        "host_ms": cuda_ms(torch, lambda: quant_kernel.quantize_rows_cuda(
            table, QUANT_SEED), reps=50, queued=False),
        "plain_ms": cuda_ms(torch, lambda: quant_kernel.
                            quantize_rows_stochastic_plain(table, QUANT_SEED),
                            reps=5),
        "bound_ms": nbytes / H100_HBM_BYTES * 1e3, "bound_by": "bytes",
        "library_ms": None,
        "levels_moved_share": share, "mean_dequant_error": bias,
        "shape": f"the served unit table, N={n} d={d}, seed {QUANT_SEED}",
    }


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run_main_path(dev, work: str, n_tracks: int = N_TRACKS,
                  n_collections: int = N_COLLECTIONS,
                  n_positives: int = N_POSITIVES,
                  feature_dim: int = FEATURE_DIM):
    """The port's main path, as a user runs it: dataset -> graph ->
    co-listen augmentation -> PPR sweep -> embed_all -> emb.npy -> hybrid
    HTTP serving (live-walk and cached-head).  Returns its state."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from gcn_song_embeddings_tpu_torch import serve as serve_mod
    from gcn_song_embeddings_tpu_torch.config import RunConfig
    from gcn_song_embeddings_tpu_torch.data.device import (
        DeviceGraph,
        apply_colisten_config,
    )
    from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
    from gcn_song_embeddings_tpu_torch.data.synth import (
        make_synthetic_dataset,
    )
    from gcn_song_embeddings_tpu_torch.models.pinsage import (
        embed_all,
        init_pinsage,
    )
    from gcn_song_embeddings_tpu_torch.ops import walk_kernel
    from gcn_song_embeddings_tpu_torch.ops.ppr import (
        precompute_neighborhoods,
    )

    shutil.rmtree(work, ignore_errors=True)
    ds = os.path.join(work, "dataset")
    t = time.perf_counter()
    make_synthetic_dataset(ds, n_tracks=n_tracks, n_collections=n_collections,
                           tracks_per_collection=TRACKS_PER_COLLECTION,
                           n_positives=n_positives, feature_dim=feature_dim,
                           seed=0)
    walls = {"make_dataset_s": time.perf_counter() - t}
    log(f"dataset: {n_tracks} tracks, {n_collections} collections x "
        f"{TRACKS_PER_COLLECTION}, {n_positives} positives, "
        f"{feature_dim}-d features in {walls['make_dataset_s']:.1f} s")

    cfg = RunConfig.recommended()
    mcfg = cfg.model
    t = time.perf_counter()
    graph = SongGraph(ds, features_file=os.path.join(ds, "features.npy"))
    train_pos, _ = graph.load_positives_split(
        os.path.join(ds, "positives.json"))
    dg, nb_path = apply_colisten_config(DeviceGraph.from_graph(graph, dev),
                                        train_pos, cfg.walk,
                                        graph.nbhds_path)
    sync(torch, dev)
    walls["load_graph_s"] = time.perf_counter() - t

    t = time.perf_counter()
    nb_w, nb_n = precompute_neighborhoods(dg, cfg.walk, nb_path, seed=0)
    walls["sweep_s"] = time.perf_counter() - t
    sweep_walk_launches = walk_kernel.launches
    log(f"sweep: {graph.n_items} origins x {cfg.walk.n_hops} hops over "
        f"{dg.n_edges} directed edges (co-listen augmented) in "
        f"{walls['sweep_s']:.3f} s")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_pinsage(gen, mcfg.n_layers, graph.features.shape[1],
                          mcfg.hidden_dim, mcfg.out_dim, mcfg.bias_init)
    feats = torch.as_tensor(graph.features, device=dev)
    nbw_d = torch.as_tensor(nb_w, device=dev)
    nbn_d = torch.as_tensor(nb_n, device=dev)
    sync(torch, dev)
    t = time.perf_counter()
    emb_d = embed_all(params, feats, nbw_d, nbn_d, graph.n_items,
                      mcfg.n_layers, mcfg.T)
    sync(torch, dev)
    walls["embed_s"] = time.perf_counter() - t
    emb = emb_d.cpu().numpy()
    emb_path = os.path.join(work, "emb.npy")
    np.save(emb_path, emb)
    log(f"embed: {emb.shape} in {walls['embed_s']:.3f} s -> {emb_path}")

    rows = [3, 17, n_tracks // 2, n_tracks - 1]
    t = time.perf_counter()
    live = serve_mod.HybridIndex(
        np.load(emb_path), DeviceGraph.from_graph(graph, dev),
        train_pairs=train_pos, colisten_copies=cfg.walk.colisten_copies,
        n_hops=SERVE_HOPS, track_ids=graph.track_ids,
        tracks_meta=graph.tracks, device=dev)
    walls["live_index_build_s"] = time.perf_counter() - t
    walls["live"] = serve_queries(serve_mod.serve, live, graph, rows)
    cached = serve_mod.HybridIndex(
        np.load(emb_path), nbhds=(nb_w, nb_n), track_ids=graph.track_ids,
        tracks_meta=graph.tracks, device=dev)
    walls["cached"] = serve_queries(serve_mod.serve, cached, graph, rows)
    sync(torch, dev)
    return SimpleNamespace(
        ds=ds, cfg=cfg, graph=graph, dg=dg, nb_w=nb_w, nb_n=nb_n,
        params=params, feats=feats, nbw_d=nbw_d, nbn_d=nbn_d, emb=emb,
        rows=rows, cached=cached, train_pos=train_pos, walls=walls,
        sweep_walk_launches=sweep_walk_launches, nb_path=nb_path)


def run_refresh_path(dev, st, work: str):
    """The walk-side refresh, as a user runs it after new co-listens: the
    main path's (co-listen augmented) graph gains ``N_REFRESH_PAIRS``
    seeded random pairs (cross-cluster for 15 in 16 of them), and
    ``refresh_neighborhoods`` re-sweeps the origins they can reach with
    K1, saving under the augmented graph's cache meta.  Returns its
    state."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from gcn_song_embeddings_tpu_torch.data.device import (
        augment_with_colisten,
    )
    from gcn_song_embeddings_tpu_torch.ops.ppr import (
        affected_origins,
        refresh_neighborhoods,
    )

    n = st.graph.n_items
    rng = np.random.default_rng(REFRESH_SEED)
    pairs = np.stack([rng.choice(n, N_REFRESH_PAIRS, replace=False),
                      rng.choice(n, N_REFRESH_PAIRS, replace=False)], 1)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    aug = augment_with_colisten(st.dg, pairs, 1)
    aff = affected_origins(st.nb_w, st.nb_n, pairs, n)
    log(f"refresh: {len(pairs)} new co-listen pairs, {len(aff)} of {n} "
        f"origins affected (share {len(aff) / n:.4f})")
    path = os.path.join(work, "refreshed_neighborhoods.npz")
    sync(torch, dev)
    t = time.perf_counter()
    new_w, new_n = refresh_neighborhoods(aug, st.cfg.walk, st.nb_w, st.nb_n,
                                         pairs, path=path, seed=0)
    sync(torch, dev)
    walls = {"refresh_s": time.perf_counter() - t,
             "sweep_s": st.walls["sweep_s"],
             "affected_share": len(aff) / n}
    log(f"refresh: {len(aff)} origins re-swept and saved in "
        f"{walls['refresh_s']:.3f} s (the full sweep: "
        f"{st.walls['sweep_s']:.3f} s)")
    return SimpleNamespace(aug=aug, pairs=pairs, aff=aff, new_w=new_w,
                           new_n=new_n, path=path, walls=walls)


def check_refresh(torch, walk_kernel, st, rf) -> dict:
    """The refreshed artifact: every unaffected row bit-equal to the
    sweep's, the affected rows re-walked, and ``precompute_neighborhoods``
    on the augmented graph serving the saved file unchanged (no K1
    launch); then the refresh timed again without its cache write."""
    import numpy as np

    from gcn_song_embeddings_tpu_torch.ops.ppr import (
        precompute_neighborhoods,
        refresh_neighborhoods,
    )

    keep = np.setdiff1d(np.arange(st.graph.n_items), rf.aff)
    if not (np.array_equal(rf.new_w[keep], st.nb_w[keep])
            and np.array_equal(rf.new_n[keep], st.nb_n[keep])):
        raise AssertionError("refresh changed unaffected rows")
    moved = int((rf.new_n[rf.aff] != st.nb_n[rf.aff]).any(axis=1).sum())
    before = walk_kernel.launches
    served_w, served_n = precompute_neighborhoods(rf.aug, st.cfg.walk,
                                                  rf.path, seed=0)
    if walk_kernel.launches != before or not (
            np.array_equal(served_w, rf.new_w)
            and np.array_equal(served_n, rf.new_n)):
        raise AssertionError("precompute_neighborhoods on the augmented "
                             "graph did not serve the refreshed artifact")
    torch.cuda.synchronize()
    t = time.perf_counter()
    refresh_neighborhoods(rf.aug, st.cfg.walk, st.nb_w, st.nb_n, rf.pairs,
                          seed=0)
    torch.cuda.synchronize()
    out = {**rf.walls, "refresh_without_cache_write_s":
           time.perf_counter() - t, "affected": len(rf.aff),
           "affected_rows_changed": moved, "unaffected_rows_equal": True,
           "served_back": True}
    log(f"refresh checks: {json.dumps(out)}")
    return out


def train_config(work: str):
    """``RunConfig.recommended()`` at full width, cut to 2 epochs x 25
    batches in chunks of 20, written where ``cli train --config`` reads
    it."""
    import dataclasses

    from gcn_song_embeddings_tpu_torch.config import RunConfig

    cfg = RunConfig.recommended("smoke")
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, epochs=TRAIN_EPOCHS, batches_per_epoch=TRAIN_BATCHES,
        checkpoint_every_batches=TRAIN_CHUNK))
    path = os.path.join(work, "train_config.json")
    with open(path, "w") as f:
        f.write(cfg.to_json())
    return cfg, path


def run_train_path(dev, st, work: str):
    """The training path, as a user runs it: ``cli train`` on the main
    path's dataset (its cached sweep is reused), then the trained
    ``emb.npy`` served through the cached-head hybrid.  Returns its
    state."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from gcn_song_embeddings_tpu_torch import cli
    from gcn_song_embeddings_tpu_torch import serve as serve_mod

    cfg, cfg_path = train_config(work)
    runs = os.path.join(work, "runs")
    t = time.perf_counter()
    cli.main(["train", "--dataset", st.ds, "--run-dir", runs,
              "--run-name", cfg.run_name, "--config", cfg_path,
              "--device", str(dev)])
    sync(torch, dev)
    walls = {"train_s": time.perf_counter() - t}
    run_dir = os.path.join(runs, cfg.run_name)
    emb_path = os.path.join(run_dir, "emb.npy")
    index = serve_mod.HybridIndex(
        np.load(emb_path), nbhds=(st.nb_w, st.nb_n),
        track_ids=st.graph.track_ids, tracks_meta=st.graph.tracks,
        device=dev)
    walls["trained_cached"] = serve_queries(serve_mod.serve, index,
                                            st.graph, st.rows)
    sync(torch, dev)
    return SimpleNamespace(cfg=cfg, run_dir=run_dir, emb=np.load(emb_path),
                           n_items=st.graph.n_items, walls=walls)


def check_training_run(tr_st) -> None:
    """The run's output and metrics: finite embeddings of every track, 50
    finite metric rows, a falling loss, the rate stepping x0.95 at the
    epoch boundary."""
    import numpy as np

    with open(os.path.join(tr_st.run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    total = TRAIN_EPOCHS * TRAIN_BATCHES
    if tr_st.emb.shape != (tr_st.n_items, tr_st.cfg.model.out_dim) or not (
            np.isfinite(tr_st.emb).all()):
        raise AssertionError(f"trained embeddings: shape {tr_st.emb.shape}, "
                             f"finite {np.isfinite(tr_st.emb).all()}")
    if len(rows) != total:
        raise AssertionError(f"metrics.jsonl has {len(rows)} rows, "
                             f"expected {total}")
    loss = np.array([r["Train Loss"] for r in rows])
    gnorm = np.array([r["Gradient Norm"] for r in rows])
    rate = np.array([r["Learning Rate"] for r in rows])
    if not (np.isfinite(loss).all() and np.isfinite(gnorm).all()):
        raise AssertionError("non-finite loss or gradient norm")
    first, last = float(loss[:10].mean()), float(loss[-10:].mean())
    log(f"train: loss first 10 {first:.5f} -> last 10 {last:.5f}, grad "
        f"norm {gnorm[0]:.4g} -> {gnorm[-1]:.4g}, rate {rate[0]:.6g} -> "
        f"{rate[-1]:.6g}")
    if not last < first:
        raise AssertionError(f"loss did not fall: {first} -> {last}")
    lr = tr_st.cfg.train.lr
    if not (np.allclose(rate[:TRAIN_BATCHES], lr, rtol=1e-6)
            and np.allclose(rate[TRAIN_BATCHES:], lr * tr_st.cfg.train.decay,
                            rtol=1e-6)):
        raise AssertionError(f"rate does not step at batch "
                             f"{TRAIN_BATCHES}: {rate.tolist()}")
    if [r["epoch"] for r in rows] != [e for e in range(TRAIN_EPOCHS)
                                      for _ in range(TRAIN_BATCHES)]:
        raise AssertionError("metrics rows carry the wrong epochs")


def three_step_checks(torch, trainer) -> dict:
    """3 steps from the trainer's seeded init on the same batches.

    Full-graph forward (K2 + backward) against the frontier forward (K3)
    on the card, two ways.  Step by step: before each frontier step, one
    full-graph step from the same parameters and Adam state, its loss at
    rtol 1e-4 and every parameter after it at rtol 1e-4 / atol 1e-5 of
    the frontier step's.  And as two 3-step runs, each on its own, held
    as the card is held against the CPU: the per-step losses at rtol
    1e-4, G1_w at rtol 1e-4 / atol 1e-5 and the embeddings of 64 nodes
    at rtol 1e-3 / atol 1e-4 (tests/test_trainer.py's comparison), every
    leaf's difference logged.  Not every leaf of the two runs at 1e-5:
    their gradients differ in the order of their sums, and where an
    element's gradient is ~1e-11 in one and 0 in the other, Adam's eps
    turns that into a 1e-6 update difference, which at a later step can
    move an entry of pre within 2e-7 of 0 to the other leaky_relu slope
    in one run and a row of the deepest Wq by ~1.6e-4 (at the 100k step
    two entries do; ``scripts/three_step_flip_probe.py`` shows the
    step-1 slopes equal and the gradients within ~2e-11).  The card
    against the CPU's plain versions the same way: the two devices round
    ``pre = h[nb] Wq^T + bq`` differently (the card's slopes are its
    kernels' 3xTF32 sums), so entries of ``pre`` within an ulp of 0 take
    the other slope, and Adam's normalisation turns those gradient
    differences into visible ones in the deepest layer's Wq and bq; the
    count of such entries at step 1 is logged.  Returns the largest
    differences."""
    import copy

    import numpy as np

    from gcn_song_embeddings_tpu_torch.models.pinsage import (
        init_pinsage,
        pinsage_forward,
    )
    from gcn_song_embeddings_tpu_torch.ops import agg
    from gcn_song_embeddings_tpu_torch.ops.ppr import block_generator
    from gcn_song_embeddings_tpu_torch.train.trainer import (
        TrainTables,
        make_optimizer,
        train_step,
    )

    tcfg, mcfg = trainer.cfg.train, trainer.cfg.model
    gen = block_generator(12345, 0, trainer.device)
    batches = [trainer.sample(gen) for _ in range(3)]
    # the trainer's own init (train.seed), as tests/test_trainer.py starts
    # both of its runs
    seeded = torch.Generator(device=trainer.device)
    seeded.manual_seed(tcfg.seed)
    init = init_pinsage(seeded, mcfg.n_layers, mcfg.in_dim, mcfg.hidden_dim,
                        mcfg.out_dim, mcfg.bias_init)
    probe = torch.arange(0, trainer.n, trainer.n // 64)[:64]

    def run(params, tables, batches, fullgraph, stepwise=None):
        """The run's losses, leaves and probe embeddings; with
        ``stepwise`` a dict, a full-graph step from each step's starting
        state held to this run's step, its largest leaf differences
        recorded there."""
        opt = make_optimizer(params, tcfg)
        losses = []
        for i, b in enumerate(batches):
            if stepwise is not None:
                fg_params, fg_opt = copy.deepcopy((params, opt))
                fg_loss = float(train_step(fg_params, fg_opt, b, tables, tcfg,
                                           mcfg, True)[0])
            losses.append(float(train_step(params, opt, b, tables, tcfg,
                                           mcfg, fullgraph)[0]))
            if stepwise is None:
                continue
            fg = dict(fg_params.leaves())
            np.testing.assert_allclose(
                fg_loss, losses[-1], rtol=TRAJ["rtol"],
                err_msg=f"fullgraph_on_vs_off step {i + 1}: loss")
            for name, p in params.leaves():
                a = fg[name].detach().cpu().numpy()
                want = p.detach().cpu().numpy()
                np.testing.assert_allclose(
                    a, want, **TRAJ,
                    err_msg=f"fullgraph_on_vs_off step {i + 1}: {name}")
                stepwise[name] = max(stepwise.get(name, 0.0),
                                     float(np.abs(a - want).max()))
            del fg_params, fg_opt, fg
        with torch.inference_mode():
            emb = pinsage_forward(params, tables.features, tables.nbhd_w,
                                  tables.nbhd_n,
                                  probe.to(tables.features.device),
                                  mcfg.n_layers, mcfg.T).cpu().numpy()
        leaves = {name: p.detach().cpu().numpy()
                  for name, p in params.leaves()}
        return losses, leaves, emb

    before = agg.backward_launches["stream"]
    stepwise = {}
    off = run(copy.deepcopy(init), trainer.tables, batches, False, stepwise)
    on = run(copy.deepcopy(init), trainer.tables, batches, True)
    sync(torch, trainer.device)
    out = {"k2_backward_launches": agg.backward_launches["stream"] - before,
           "fullgraph_on_vs_off_stepwise": stepwise}
    if out["k2_backward_launches"] == 0:
        raise AssertionError("the full-graph steps never ran K2's backward")
    log(f"three steps, fullgraph_on_vs_off step by step: held, max |diff| "
        f"per leaf {stepwise}")
    cpu_tables = TrainTables(*(t.cpu() for t in trainer.tables))
    cpu = run(copy.deepcopy(init).cpu(), cpu_tables,
              [b.cpu() for b in batches], False)
    for name, a, b in (("fullgraph_on_vs_off", on, off),
                       ("gpu_vs_cpu", off, cpu)):
        worst = {leaf: float(np.abs(a[1][leaf] - b[1][leaf]).max())
                 for leaf in a[1]}
        log(f"three steps, {name}: losses {a[0]} vs {b[0]}; max |diff| per "
            f"leaf {worst}; embeddings max |diff| "
            f"{float(np.abs(a[2] - b[2]).max()):.3g}")
        np.testing.assert_allclose(a[0], b[0], rtol=TRAJ["rtol"],
                                   err_msg=f"{name}: losses")
        np.testing.assert_allclose(a[1]["G1_w"], b[1]["G1_w"], **TRAJ,
                                   err_msg=f"{name}: G1_w")
        np.testing.assert_allclose(a[2], b[2], rtol=1e-3, atol=1e-4,
                                   err_msg=f"{name}: embeddings")
        out[name] = worst
        log(f"three steps, {name}: held, max |diff| "
            f"{max(worst.values()):.3g}")

    # entries of the deepest conv's pre whose sign the two devices'
    # rounding disagrees on, at step 1
    layer, table, ids, _, _ = step_conv_inputs(torch, trainer,
                                               batches[0])[0]
    Wq, bq = init.layers[0].Wq.detach(), init.layers[0].bq.detach()
    with torch.no_grad():
        rows = table[ids.reshape(-1).long()]
        pre_gpu = torch.addmm(bq, rows, Wq.t()) >= 0
        pre_cpu = torch.addmm(bq.cpu(), rows.cpu(), Wq.t().cpu()) >= 0
    out["leaky_slope_flips_step1"] = int((pre_gpu.cpu() != pre_cpu).sum())
    log(f"three steps: {out['leaky_slope_flips_step1']} of "
        f"{pre_cpu.numel()} entries of the deepest conv's pre change sign "
        f"between the card's and the CPU's rounding at step 1")
    return out


def step_conv_inputs(torch, trainer, batch):
    """The aggregations of one frontier train step on ``batch``, with the
    step's own tables, deepest first: (layer, table, ids, weights,
    need_dh) for the deepest conv (over the gathered feature rows, no
    dh), then each conv above it over the output of the one below; the
    table is the frontier's neighbor rows (those past its m self rows),
    node i's at rows i T .., as ``forward_with_gather`` aggregates it."""
    from gcn_song_embeddings_tpu_torch.models.pinsage import conv_from_table

    mcfg, tables = trainer.cfg.model, trainer.tables
    T, L = mcfg.T, mcfg.n_layers
    nodes = torch.cat([batch[:, 0], batch[:, 1], batch[:, 2]]).long()
    frontiers = [nodes]
    for _ in range(L):
        f = frontiers[-1]
        frontiers.append(torch.cat([f, tables.nbhd_n[f, :T].reshape(-1)
                                    .long()]))

    def ids(m):
        return torch.arange(m * T, dtype=torch.int32,
                            device=nodes.device).reshape(m, T)

    table = tables.features[frontiers[L]]
    shapes = []
    for level in reversed(range(L)):
        f = frontiers[level]
        m = len(f)
        layer = trainer.params.layers[L - 1 - level]
        w = tables.nbhd_w[f, :T].contiguous()
        shapes.append((layer, table[m:], ids(m), w, level < L - 1))
        if level:
            with torch.no_grad():
                table = conv_from_table(layer, table[:m], table[m:], ids(m),
                                        w, mode="dma")
    return shapes


def agg_work(torch, nb_idx, nb_wt, din: int, hdim: int, n_rows: int,
             backward: bool = False, need_dh: bool = False, elem: int = 4,
             mode: str = "stream"):
    """(operations, bytes) the aggregation needs on this data: each
    distinct weighted id projected once (+bq, leaky_relu), each weighted
    entry's multiply-add, one divide per output; inputs read once, output
    written once (table rows and Wq, and their gradients, of ``elem``
    bytes, the rest f32).
    The backward takes its slopes from the forward's residual (mode
    "stream": the distinct rows of K2's projected table; "dma": K3's bit
    an entry and column), so it recomputes no projection: each weighted
    entry's term (x c, the slope, + onto its row's sum S), dbq over S's
    distinct rows, and dWq (and dh) as products over them; it reads the
    incoming gradient, the distinct rows of h, the residual, ids and
    weights (and Wq for dh) once, writes S once and the gradients once."""
    b, t = nb_idx.shape
    live = nb_wt != 0
    distinct = int(nb_idx[live].unique().numel())
    entries = int(live.sum())
    if not backward:
        flops = (2.0 * distinct * (din + 1) * hdim + 2.0 * entries * hdim
                 + b * hdim)
        nbytes = (elem * (distinct * din + hdim * din)
                  + 4.0 * (2 * b * t + hdim + b * hdim))
        return flops, nbytes, distinct, entries
    products = 2 if need_dh else 1
    flops = (products * 2.0 * distinct * din * hdim
             + 3.0 * entries * hdim + distinct * hdim)
    residual = 4.0 * distinct * hdim if mode == "stream" else b * t * hdim / 8
    nbytes = (4.0 * (b * hdim + 2 * b * t + distinct * hdim + hdim)
              + elem * (distinct * din + hdim * din
                        + (hdim * din + n_rows * din if need_dh else 0))
              + residual)
    return flops, nbytes, distinct, entries


def bwd_rows_work(torch, nb_idx, nb_wt, hdim: int, n_rows: int,
                  mode: str, passes=None):
    """(operations, bytes) of the backward's row sums alone (``agg.
    agg_bwd_rows``, or ``agg.agg_bwd_frontier`` where the ids are the
    identity): each weighted entry's multiply, slope and add; the
    incoming gradient, the weights, the residual and (table form) the
    CSR's offsets and entries and the entries' c read once, S (two part
    sums in three passes) written once."""
    b, t = nb_idx.shape
    entries = int((nb_wt != 0).sum())
    residual = (4.0 * n_rows * hdim if mode == "stream"
                else b * t * hdim / 8)
    index = (0 if is_identity(torch, nb_idx, n_rows)
             else 2 * b * t + n_rows + 1)
    return (3.0 * entries * hdim,
            4.0 * (b * hdim + b * t + index
                   + (2 if passes == 3 else 1) * n_rows * hdim) + residual)


def is_identity(torch, ids, n_rows: int) -> bool:
    """Whether entry e of ids [B, T] is table row e of the n_rows = B T
    (the frontier forward's ids, whose backward takes the frontier
    form)."""
    return n_rows == ids.numel() and torch.equal(
        ids.reshape(-1), torch.arange(ids.numel(), dtype=ids.dtype,
                                      device=ids.device))


def bound(flops: float, nbytes: float, products: float = 0.0,
          rate: float = H100_TF32_FLOPS, passes: int = 3):
    """(ms, what bounds it): the larger of the bytes over HBM's rate and
    the operations over the peak rate of their type: ``products`` (of
    ``flops``) on the tensor cores at ``rate``, ``passes`` each (3xTF32
    by default; one bf16 pass), the rest as f32 outside them."""
    ops_ms = (passes * products / rate
              + (flops - products) / H100_FP32_FLOPS) * 1e3
    bytes_ms = nbytes / H100_HBM_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def float64_error(torch, agg, h, ids, wts, Wq, bq, got, plain, passes=None):
    """Max |error| of the kernel's and the plain f32 version's outputs
    against the aggregation in float64 (each table row projected once,
    the T weighted rows summed one at a time, so no [B, T, H] tensor;
    with ``passes`` the products of the same bf16-rounded operands)."""
    proj = agg.project_table_plain(h.double(), Wq.double(), bq.double(),
                                   passes)
    w64 = wts.double()
    ref = torch.zeros(got.shape, dtype=torch.float64, device=got.device)
    for t in range(ids.shape[1]):
        ref += w64[:, t, None] * proj[ids[:, t].long()]
    del proj
    if wts.dtype in agg.SIXTEEN:
        # 16-bit weights: the function's denominator is their sum rounded
        # to their type (the JAX package's), taken exactly as it is
        ref /= agg._denominator(wts).double()
    else:
        w_sum = w64.sum(dim=1, keepdim=True)
        ref /= torch.where(w_sum == 0.0, torch.ones_like(w_sum), w_sum)
    return (float((got.double() - ref).abs().max()),
            float((plain.double() - ref).abs().max()))


def k2_parts(torch, agg, h, ids, wts, Wq, bq, got) -> dict:
    """K2's three kernels, each held against its plain version and timed
    beside it: the Wq split (bit for bit), the projection and the
    gather-mean (max |diff|; the gather against ``gather_mean_plain`` of
    the kernel's own projection)."""
    hdim = Wq.shape[0]
    big, small = agg.split_wq(Wq)
    want = [agg.tile_wq_plain(x) for x in agg.tf32_split(Wq)]
    if not (torch.equal(big.view(torch.int32), want[0].view(torch.int32))
            and torch.equal(small.view(torch.int32),
                            want[1].view(torch.int32))):
        raise AssertionError("the Wq split kernel differs from tf32_split")
    proj = agg.project_table(h, big, small, bq)
    rows = agg.slabs_to_rows(proj, hdim)
    proj_err = float((rows - agg.project_table_plain(h, Wq, bq))
                     .abs().max())
    out = torch.empty_like(got)
    mean = agg.gather_mean(proj, ids, wts, out)
    mean_err = float((mean - agg.gather_mean_plain(rows, ids, wts))
                     .abs().max())
    if not (proj_err <= K2_ATOL and mean_err <= K2_ATOL
            and torch.equal(mean, got)):
        raise AssertionError(f"K2 parts: projection {proj_err}, "
                             f"gather-mean {mean_err}")
    return {
        "split": {"max_abs_err": 0.0,
                  "ms": cuda_ms(torch, lambda: agg.split_wq(Wq), reps=10),
                  "plain_ms": cuda_ms(torch, lambda: [
                      agg.tile_wq_plain(x) for x in agg.tf32_split(Wq)],
                      reps=3)},
        "project": {"max_abs_err": proj_err,
                    "ms": cuda_ms(torch, lambda: agg.project_table(
                        h, big, small, bq), reps=5),
                    "plain_ms": cuda_ms(torch, lambda: agg.
                                        project_table_plain(h, Wq, bq),
                                        reps=3)},
        "gather_mean": {"max_abs_err": mean_err,
                        "ms": cuda_ms(torch, lambda: agg.gather_mean(
                            proj, ids, wts, out), reps=5),
                        "plain_ms": cuda_ms(torch, lambda: agg.
                                            gather_mean_plain(rows, ids,
                                                              wts), reps=3)},
    }


def backward_timing(torch, agg, mode, layer, table, ids, wts, need_dh,
                    passes=None) -> dict:
    """The aggregation's backward at one shape: ``err`` and ``plain_err``
    (each gradient's relative Frobenius error, of ConvAggregate's and of
    autograd through the plain version, against autograd through the
    plain version in float64, at the forward's residual slopes where some
    entry's differs from float64's: ``branch_slopes``), ``flips`` (such
    entries), ``ms`` (back to back on the device), ``host_ms`` (per call
    as issued), ``plain_ms`` (autograd through the plain version), and
    ``hold_backward_twin``'s keys, with the inputs that need a gradient
    in the train step (Wq and bq; h too where it is an activation).  With
    ``passes`` the forward is the precision policy's bf16x form and the
    reference the same function (bf16-rounded operands and cotangents) in
    float64."""
    from gcn_song_embeddings_tpu_torch.utils import precision

    def leaves(dtype):
        # copies: the table may be an inference-mode tensor
        h = table.detach().to(dtype, copy=True).requires_grad_(need_dh)
        Wq = layer.Wq.detach().to(dtype, copy=True).requires_grad_()
        bq = layer.bq.detach().to(dtype, copy=True).requires_grad_()
        return h, Wq, bq, ((h, Wq, bq) if need_dh else (Wq, bq))

    gen = torch.Generator(device=table.device)
    gen.manual_seed(7)
    cot = torch.randn((ids.shape[0], layer.Wq.shape[0]),
                      device=table.device, generator=gen)
    h, Wq, bq, inputs = leaves(torch.float64)
    slope, flips = branch_slopes(torch, agg, mode, table, ids, wts,
                                 layer.Wq.detach(), layer.bq.detach(), h,
                                 Wq, bq, passes)
    ref = torch.autograd.grad(
        agg.conv_aggregate_plain(h, ids, wts.double(), Wq, bq, passes)
        if slope is None else
        plain_at_slopes(torch, agg, h, ids, wts.double(), Wq, bq, slope,
                        passes),
        inputs, cot.double())
    del slope
    h, Wq, bq, inputs = leaves(torch.float32)
    value = {None: None, 1: "default", 3: "high"}[passes]
    # the frontier forward's ids state the identity, as the model does
    nb = None if is_identity(torch, ids, table.shape[0]) else ids
    with precision.override(value):
        out = agg.conv_aggregate(h, nb, wts, Wq, bq, mode=mode)
    plain = agg.conv_aggregate_plain(h, ids, wts, Wq, bq, passes)
    got = torch.autograd.grad(out, inputs, cot, retain_graph=True)
    want = torch.autograd.grad(plain, inputs, cot, retain_graph=True)

    def error(grads):
        return [float(torch.linalg.vector_norm(g.double() - r)
                      / torch.linalg.vector_norm(r))
                for g, r in zip(grads, ref)]

    err, plain_err = error(got), error(want)
    del ref, got, want
    timing = {"err": err, "plain_err": plain_err, "flips": flips}
    timing.update(hold_backward_twin(torch, agg, mode, layer, table, ids,
                                     wts, cot, passes))

    def grad():
        return torch.autograd.grad(out, inputs, cot, retain_graph=True)

    timing["ms"] = cuda_ms(torch, grad, reps=5)
    timing["host_ms"] = cuda_ms(torch, grad, reps=5, queued=False)
    timing["plain_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
        plain, inputs, cot, retain_graph=True), reps=3)
    return timing


def hold_backward_twin(torch, agg, mode, layer, table, ids, wts, dagg,
                       passes=None) -> dict:
    """The backward's kernels against their plain twins on the inputs
    ``ConvAggregate.backward`` gives them at this shape (the weights, the
    residual of the forward of ``mode``, the incoming gradient ``dagg``):
    where the ids are the identity (the frontier forward's) the frontier
    form (``agg.agg_bwd_frontier``) against ``agg_bwd_frontier_plain`` and
    against the table twin over the CSR of the ``arange``; else the table
    form (``agg.agg_bwd_rows`` over ``agg.backward_csr``, equal to
    ``backward_csr_plain``'s) against ``agg_bwd_rows_plain``.  S's parts
    equal bit for bit (the twins sum in the kernels' order), so within
    1e-6 of max |S|; dbq (the kernel's per-block partials, then one sum)
    within 1e-6 of each column's sum of |S| (of its parts' in bf16
    passes).  Returns ``form``, ``twin_err`` (max |kernel - twin| over S),
    ``twin_dbq_err`` (the largest such share of dbq), ``kernel_ms`` (the
    form's kernels alone) and ``csr_ms`` (the CSR kernels; 0 in the
    frontier form, which builds none)."""
    Wq, bq = layer.Wq.detach(), layer.bq.detach()
    n = table.shape[0]
    frontier = is_identity(torch, ids, n)
    with torch.no_grad():
        _, res = agg.conv_aggregate_cuda(table, ids, wts, Wq, bq, mode, None,
                                         passes, residual=True)
        dagg = dagg.contiguous()
        table_twin = agg.agg_bwd_rows_plain(
            *agg.backward_csr_plain(ids, n), wts, dagg, res, passes)
        if frontier:
            args = (wts, dagg, res, passes)
            csr_same = True

            def kernel():
                return agg.agg_bwd_frontier(*args)
            want, want_dbq = agg.agg_bwd_frontier_plain(*args)
            same_as_table = all(torch.equal(a, b) for a, b in zip(
                want, table_twin[0]))
        else:
            offsets, entries = agg.backward_csr(ids, n)
            csr_same = all(torch.equal(a, b) for a, b in zip(
                (offsets, entries), agg.backward_csr_plain(ids, n)))
            args = (offsets, entries, wts, dagg, res, passes)

            def kernel():
                return agg.agg_bwd_rows(*args)
            want, want_dbq = table_twin
            same_as_table = True
        del table_twin
        parts, dbq = kernel()
        same = all(torch.equal(g, r) for g, r in zip(parts, want))
        err = max(float((g - r).abs().max()) for g, r in zip(parts, want))
        scale = max(float(r.abs().max()) for r in want)
        sums = sum(r.abs().sum(dim=0) for r in want)
        dbq_err = float(((dbq - want_dbq).abs()
                         / sums.clamp_min(1e-30)).max())
        del want, sums
    form = "frontier" if frontier else "table"
    log(f"{agg.MODES[mode]} backward kernel ({form} form) vs its twin at "
        f"B={ids.shape[0]} T={ids.shape[1]} H={Wq.shape[0]} (table {n} "
        f"rows{f', {passes} bf16 passes' if passes else ''}): CSR equal "
        f"{csr_same}, S bit-equal {same} (frontier twin = table twin "
        f"{same_as_table}), max |diff| {err:.3g} (max |S| {scale:.3g}); "
        f"dbq {dbq_err:.3g} of its column sums of |S|")
    if not (csr_same and same and same_as_table and err <= 1e-6 * scale
            and dbq_err <= 1e-6):
        raise AssertionError(f"the backward kernels differ from their "
                             f"twins: CSR equal {csr_same}, S equal {same}, "
                             f"frontier twin = table twin {same_as_table}, "
                             f"{err} (max |S| {scale}), dbq {dbq_err}")
    out = {"form": form, "twin_err": err, "twin_dbq_err": dbq_err,
           "kernel_ms": cuda_ms(torch, kernel, reps=5),
           "csr_ms": 0.0 if frontier else cuda_ms(
               torch, lambda: agg.backward_csr(ids, n), reps=5)}
    del parts, dbq, res, args
    return out


def frontier_k2_holds(torch, agg, shapes) -> list:
    """The backward of K2 over ids the caller states as the identity (the
    sharded full-graph step's ``conv_apply``: ``agg_bwd_frontier_kernel``
    with K2's projected table as its slopes) at each frontier step shape
    of ``shapes`` (``step_conv_inputs``), in 0, 1 and 3 bf16 passes:
    ``hold_backward_twin``'s keys for each, with ``B`` and ``passes``."""
    gen = torch.Generator(device=shapes[0][1].device)
    gen.manual_seed(7)
    out = []
    for layer, table, ids, wts, _ in shapes:
        for passes in (None, 1, 3):
            cot = torch.randn((ids.shape[0], layer.Wq.shape[0]),
                              device=table.device, generator=gen)
            out.append({"B": ids.shape[0], "passes": passes or 0,
                        **hold_backward_twin(torch, agg, "stream", layer,
                                             table, ids, wts, cot, passes)})
    return out


# rows named this many times in ``hub_timing``'s ids: hubs of a power-law
# catalog's walks, the first past the order kernel's RANK_MAX of 128 and
# its sort's tiles of 2048 (csrc/agg_bwd.cu)
HUB_RUNS = (100_000, 10_000, 3000, 300)


def hub_timing(torch, agg, n: int, t: int, hdim: int) -> dict:
    """The backward's CSR and table form on the full-graph step's n x t
    ids (every node's t neighbors) with rows named HUB_RUNS times at
    random places (the rest uniform over the other rows), beside the same
    on uniform ids: the CSR held equal to the stable sort's
    (``backward_csr_plain``), the table form's kernels (``agg_bwd_rows``
    over a random K2 residual, f32 weights and incoming gradient [n,
    hdim]) equal to their chunked twin bit for bit in 0, 1 and 3 bf16
    passes, each timed back to back (``csr_ms``, and ``kernel_ms`` at
    f32)."""
    import numpy as np

    rng = np.random.default_rng(11)
    flat = rng.integers(len(HUB_RUNS), n, n * t)
    places = rng.permutation(n * t)
    at = 0
    for row, k in enumerate(HUB_RUNS):
        flat[places[at:at + k]] = row
        at += k
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    wts = torch.rand((n, t), device=dev, generator=gen)
    dagg = torch.randn((n, hdim), device=dev, generator=gen)
    res = torch.randn((-(-hdim // agg.SLAB), n, agg.SLAB), device=dev,
                      generator=gen)
    out = {"hub_runs": list(HUB_RUNS)}
    for name, ids in (("hubs", flat),
                      ("uniform", rng.integers(0, n, n * t))):
        ids = torch.as_tensor(ids.reshape(n, t).astype(np.int32), device=dev)
        csr = agg.backward_csr(ids, n)
        if not all(torch.equal(a, b) for a, b in zip(
                csr, agg.backward_csr_plain(ids, n))):
            raise AssertionError(f"the backward's CSR on the {name} ids "
                                 f"differs from the stable sort's")
        for passes in (None, 1, 3):
            parts, dbq = agg.agg_bwd_rows(*csr, wts, dagg, res, passes)
            want, want_dbq = agg.agg_bwd_rows_plain(*csr, wts, dagg, res,
                                                    passes)
            same = all(torch.equal(a, b) for a, b in zip(parts, want))
            dbq_err = float(((dbq - want_dbq).abs() / sum(
                r.abs().sum(dim=0) for r in want).clamp_min(1e-30)).max())
            del parts, want
            if not (same and dbq_err <= 1e-6):
                raise AssertionError(f"the table form on the {name} ids in "
                                     f"{passes or 0} passes: S equal to its "
                                     f"twin {same}, dbq {dbq_err}")
        out[f"csr_{name}_ms"] = cuda_ms(
            torch, lambda: agg.backward_csr(ids, n), reps=5)
        out[f"kernel_{name}_ms"] = cuda_ms(
            torch, lambda: agg.agg_bwd_rows(*csr, wts, dagg, res), reps=5)
    log(f"the backward at the full graph's {n} x {t} ids with rows named "
        f"{list(HUB_RUNS)} times: the table form equal to its twin in 0, 1 "
        f"and 3 passes; CSR (equal to the stable sort's) "
        f"{out['csr_hubs_ms']:.4f} ms (uniform ids "
        f"{out['csr_uniform_ms']:.4f}), row kernel "
        f"{out['kernel_hubs_ms']:.4f} ms (uniform "
        f"{out['kernel_uniform_ms']:.4f})")
    return out


def recomputed_pre(torch, agg, h, Wq, bq, passes=None):
    """h Wq^T + bq as one ``addmm``, or in ``passes`` bf16 passes."""
    if passes is None:
        return torch.addmm(bq, h, Wq.t())
    return agg._passes_product(h, Wq.t(), passes) + bq


def branch_slopes(torch, agg, mode, table, ids, wts, Wq32, bq32, h64, Wq64,
                  bq64, passes=None):
    """([B*T, H] float64 leaky_relu slopes of the gathered entries as the
    aggregation's backward takes them, from the residual of the forward
    of ``mode`` (``agg.conv_aggregate_slopes``; in ``passes`` bf16 passes
    where given), or None where every slope is float64's; the number of
    entries whose slope differs from float64's).  Fails unless each such
    entry lies within BRANCH_ATOL of 0."""
    flat = ids.reshape(-1).long()
    with torch.no_grad():
        kept = agg.conv_aggregate_slopes(table, ids, wts, Wq32.float(),
                                         bq32.float(), mode, passes)
        pre64 = recomputed_pre(torch, agg, h64, Wq64, bq64, passes)[flat]
        differ = kept != (pre64 >= 0)
        flips = int(differ.sum())
        worst = float(pre64[differ].abs().max()) if flips else 0.0
        del pre64, differ
        slope = torch.where(kept, 1.0, 0.01).double() if flips else None
    if not worst <= BRANCH_ATOL:
        raise AssertionError(f"{flips} entries take another leaky_relu "
                             f"slope in f32 than in float64, one at |pre| "
                             f"{worst} > {BRANCH_ATOL}")
    return slope, flips


def plain_at_slopes(torch, agg, h, ids, wts, Wq, bq, slope, passes=None):
    """The plain aggregation with each gathered entry's leaky_relu slope
    given (``slope`` [B*T, H]): differentiable in h, Wq and bq (in
    ``passes`` bf16 passes where given, ``agg.matmul``)."""
    b, t = ids.shape
    pre = (torch.addmm(bq, h, Wq.t()) if passes is None
           else agg.matmul(h, Wq.t(), passes) + bq)[ids.reshape(-1).long()]
    q = (pre * slope).reshape(b, t, -1)
    return (wts[:, :, None] * q).sum(dim=1) / agg._denominator(wts)


# the backward's keys of ``measure_aggregation``'s dict, summed over its
# shapes (``*_err`` the largest, ``bwd_branch_flips`` a count)
BWD_KEYS = ("bwd_ms", "bwd_host_ms", "bwd_plain_ms", "bwd_kernel_ms",
            "bwd_csr_ms", "bwd_flops", "bwd_bytes", "bwd_kernel_flops",
            "bwd_kernel_bytes", "bwd_err", "bwd_plain_err", "bwd_twin_err",
            "bwd_twin_dbq_err", "bwd_branch_flips")


def add_backward(torch, out, bw, ids, wts, din, hdim, n, need_dh, mode,
                 passes=None, elem=4) -> None:
    """Add one shape's ``backward_timing`` ``bw`` and the work the
    backward and its row kernel need there to ``out``'s BWD_KEYS."""
    for key in ("ms", "host_ms", "plain_ms", "kernel_ms", "csr_ms"):
        out[f"bwd_{key}"] += bw[key]
    forms = out.setdefault("bwd_forms", [])
    if bw["form"] not in forms:
        forms.append(bw["form"])
    out["bwd_err"] = max(out["bwd_err"], *bw["err"])
    out["bwd_plain_err"] = max(out["bwd_plain_err"], *bw["plain_err"])
    out["bwd_twin_err"] = max(out["bwd_twin_err"], bw["twin_err"])
    out["bwd_twin_dbq_err"] = max(out["bwd_twin_dbq_err"],
                                  bw["twin_dbq_err"])
    out["bwd_branch_flips"] += bw["flips"]
    flops, nbytes, _, _ = agg_work(torch, ids, wts, din, hdim, n,
                                   backward=True, need_dh=need_dh, elem=elem,
                                   mode=mode)
    out["bwd_flops"] += flops
    out["bwd_bytes"] += nbytes
    flops, nbytes = bwd_rows_work(torch, ids, wts, hdim, n, mode, passes)
    out["bwd_kernel_flops"] += flops
    out["bwd_kernel_bytes"] += nbytes


def measure_aggregation(torch, agg, mode, shapes, with_backward=True):
    """Hold the aggregation of ``mode`` against its plain version at each
    (layer, table, ids, weights, need_dh) of ``shapes`` and time it:
    forward (kernel, plain, gather + einsum yardstick; max |diff| within
    K2_ATOL) and backward (ConvAggregate's and autograd through the plain
    version, both held against float64 autograd), summed over the shapes,
    with the work each needs on this data, and each output's max error
    against float64.  Mode "stream" also times the project-once library
    yardstick and holds K2's three kernels to their plain versions
    (``parts``)."""
    import torch.nn.functional as F

    out = {"ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "flops": 0.0, "products": 0.0, "bytes": 0.0, "err": 0.0,
           "err64": 0.0, "plain_err64": 0.0, **dict.fromkeys(BWD_KEYS, 0.0)}
    if mode == "stream":
        out["library_project_once_ms"] = 0.0
        out["parts"] = {}
    kernel = agg.MODES[mode]
    for layer, h, ids, wts, need_dh in shapes:
        Wq, bq = layer.Wq.detach(), layer.bq.detach()
        n, din = h.shape
        hdim = Wq.shape[0]
        with torch.inference_mode():
            got = agg.conv_aggregate(h, ids, wts, Wq, bq, mode=mode)
            want = agg.conv_aggregate_plain(h, ids, wts, Wq, bq)
            err = float((got - want).abs().max())
            log(f"{kernel} B={ids.shape[0]} T={ids.shape[1]} Din={din} "
                f"H={hdim} (table {n} rows): max |diff| {err:.3g}")
            if not err <= K2_ATOL:
                raise AssertionError(f"{kernel} differs from the plain "
                                     f"version by {err} > {K2_ATOL}")
            out["err"] = max(out["err"], err)
            err64, plain_err64 = float64_error(torch, agg, h, ids, wts, Wq,
                                               bq, got, want)
            log(f"{kernel} max |error| against float64: kernel "
                f"{err64:.3g}, plain f32 version {plain_err64:.3g}")
            out["err64"] = max(out["err64"], err64)
            out["plain_err64"] = max(out["plain_err64"], plain_err64)
            del got, want
            out["slopes_ms"] = out.get("slopes_ms", 0.0) + slopes_ms(
                torch, agg, mode, h, ids, wts, Wq, bq)
            out["ms"] += cuda_ms(torch, lambda: agg.conv_aggregate(
                h, ids, wts, Wq, bq, mode=mode), reps=5)
            out["host_ms"] += cuda_ms(torch, lambda: agg.conv_aggregate(
                h, ids, wts, Wq, bq, mode=mode), reps=5, queued=False)
            out["plain_ms"] += cuda_ms(torch, lambda: agg.conv_aggregate_plain(
                h, ids, wts, Wq, bq), reps=3)
            out["library_ms"] += cuda_ms(torch, lambda: torch.einsum(
                "btd,hd->bth", h[ids.long()], Wq), reps=3)
            if mode == "stream":
                out["library_project_once_ms"] += cuda_ms(
                    torch, lambda: project_once_library(torch, F, h, ids, wts,
                                                        Wq, bq), reps=3)
                got = agg.conv_aggregate(h, ids, wts, Wq, bq, mode=mode)
                for name, part in k2_parts(torch, agg, h, ids, wts, Wq, bq,
                                           got).items():
                    acc = out["parts"].setdefault(
                        name, {"max_abs_err": 0.0, "ms": 0.0,
                               "plain_ms": 0.0})
                    acc["max_abs_err"] = max(acc["max_abs_err"],
                                             part["max_abs_err"])
                    acc["ms"] += part["ms"]
                    acc["plain_ms"] += part["plain_ms"]
        flops, nbytes, distinct, entries = agg_work(torch, ids, wts, din,
                                                    hdim, n)
        out["flops"] += flops
        out["products"] += 2.0 * distinct * din * hdim
        out["bytes"] += nbytes
        log(f"{kernel} work: {distinct} distinct weighted ids of "
            f"{ids.numel()} entries ({entries} weighted)")
        if not with_backward:
            continue
        bw = backward_timing(torch, agg, mode, layer, h, ids, wts, need_dh)
        errs, plain_errs, flips = bw["err"], bw["plain_err"], bw["flips"]
        names = ("dh", "dWq", "dbq") if need_dh else ("dWq", "dbq")
        log(f"{kernel} backward vs float64 autograd"
            + (f" at the f32 slopes ({flips} entries within {BRANCH_ATOL} "
               f"of 0 slope otherwise in float64)" if flips else "")
            + ", relative Frobenius error: " + ", ".join(
                f"{g} {e:.3g} (f32 plain {p:.3g})"
                for g, e, p in zip(names, errs, plain_errs)))
        if not max(errs) <= GRAD_RTOL:
            raise AssertionError(f"{kernel} backward error {max(errs)} > "
                                 f"{GRAD_RTOL}")
        add_backward(torch, out, bw, ids, wts, din, hdim, n, need_dh, mode)
    return out


def slopes_ms(torch, agg, mode, h, ids, wts, Wq, bq, passes=None) -> float:
    """K3's forward with its slope residual on (``conv_aggregate_cuda(...,
    residual=True)``, what a train step's forward runs): its ms, after
    holding its output equal bit for bit to the flag-off forward's.  0.0
    for K2 (mode "stream"), whose residual is the table it projects
    anyway."""
    if mode != "dma":
        return 0.0

    def on():
        return agg.conv_aggregate_cuda(h, ids, wts, Wq, bq, mode, None,
                                       passes, residual=True)

    if not torch.equal(on()[0], agg.conv_aggregate_cuda(
            h, ids, wts, Wq, bq, mode, None, passes)):
        raise AssertionError("K3 with its slope residual differs from K3 "
                             "without it")
    return cuda_ms(torch, on, reps=5)


def project_once_library(torch, F, h, ids, wts, Wq, bq):
    """K2's function from library calls, the table projected once:
    ``torch.addmm`` + leaky_relu, then a gather and the weighted mean."""
    proj = F.leaky_relu(torch.addmm(bq, h, Wq.t()), 0.01)
    w_sum = wts.sum(dim=1, keepdim=True)
    denom = torch.where(w_sum == 0.0, torch.ones_like(w_sum), w_sum)
    return torch.einsum("bt,bth->bh", wts,
                        proj[ids.long()]) / denom


def kernel_row(name, source, replaces, launches_by_path, bwd_launches, m,
               shape) -> dict:
    """One entry of the ``kernels`` line, with the backward's row
    (``backward_row``) under ``backward``.  ``bound_ms`` counts the
    products on the TF32 tensor cores in three passes;
    ``bound_f32_simt_ms`` is the bound with every operation as f32
    outside them."""
    bound_ms, bound_by = bound(m["flops"], m["bytes"], m["products"])
    simt_ms, _ = bound(m["flops"], m["bytes"])
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": sum(launches_by_path.values()),
        "launches_by_path": launches_by_path, "max_abs_err": m["err"],
        "ms": m["ms"], "host_ms": m["host_ms"], "plain_ms": m["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": m["library_ms"],
        **({"ms_with_slopes": m["slopes_ms"]} if m.get("slopes_ms") else {}),
        "bound_f32_simt_ms": simt_ms,
        **({"library_project_once_ms": m["library_project_once_ms"]}
           if "library_project_once_ms" in m else {}),
        "max_abs_err_vs_float64": m["err64"],
        "plain_max_abs_err_vs_float64": m["plain_err64"],
        "backward": backward_row(name, bwd_launches, m, shape),
        "shape": shape,
        **({"parts": m["parts"]} if "parts" in m else {}),
    }


# the kernels of each form of the backward (csrc/agg_bwd.cu) that a
# backward row's ``kernel_ms`` times
BWD_KERNELS = {"frontier": "agg_bwd_frontier_kernel",
               "table": "weights_kernel, agg_bwd_hub_kernel, agg_bwd_kernel"}


def backward_row(name, launches, m, shape) -> dict:
    """The ``kernels`` line's row of the aggregation's backward at the
    shapes of ``m`` (``measure_aggregation``'s BWD_KEYS): ``ms`` and
    ``host_ms`` the whole of ``ConvAggregate.backward`` (the frontier
    kernel of csrc/agg_bwd.cu, or the CSR and the table form's kernels;
    the products), ``form`` which ran, ``plain_ms`` autograd
    through the plain version, ``bound_ms`` the gradient's work at f32
    outside the tensor cores (its products run in true f32),
    ``max_abs_err`` the kernel against its twin; ``kernel_ms`` the row
    kernel alone beside its own bound."""
    from gcn_song_embeddings_tpu_torch.ops import agg

    bound_ms, bound_by = bound(m["bwd_flops"], m["bwd_bytes"])
    kernel_bound_ms, kernel_bound_by = bound(m["bwd_kernel_flops"],
                                             m["bwd_kernel_bytes"])
    return {
        "name": f"aggregation backward (agg.ConvAggregate.backward) at "
                f"the shapes of: {name}",
        "route": "cuda", "source": agg.BWD_SOURCE,
        "replaces": agg.BWD_REPLACES, "launches": launches,
        "max_abs_err": m["bwd_twin_err"],
        "twin_dbq_share_err": m["bwd_twin_dbq_err"],
        "ms": m["bwd_ms"], "host_ms": m["bwd_host_ms"],
        "plain_ms": m["bwd_plain_ms"], "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "form": "+".join(m.get("bwd_forms", [])),
        "kernels": "+".join(BWD_KERNELS[f] for f in m.get("bwd_forms", [])),
        "kernel_ms": m["bwd_kernel_ms"], "kernel_bound_ms": kernel_bound_ms,
        "kernel_bound_by": kernel_bound_by, "csr_ms": m["bwd_csr_ms"],
        "rel_err_vs_float64": m["bwd_err"],
        "plain_rel_err_vs_float64": m["bwd_plain_err"],
        "entries_at_another_slope_in_float64": m["bwd_branch_flips"],
        "shape": shape}


def backward_rows(results) -> list:
    """The backward rows nested in ``results``' rows, as rows of their
    own (each forward row keeps the name of its backward's); a backward
    that was not timed is dropped."""
    rows = []
    for row in results:
        bwd = row.get("backward")
        if isinstance(bwd, dict) and "source" in bwd:
            if bwd["ms"]:
                rows.append(bwd)
                row["backward"] = bwd["name"]
            else:
                row.pop("backward")
    return rows


def time_train_steps(torch, trainer, reps: int = 10, profiled: int = 5,
                     fullgraph: bool = False):
    """Train steps at B=128 (the frontier forward, or with ``fullgraph``
    the full-graph one) in the trainer's dtype from a copy of its params,
    after two warm-up steps: the synchronized wall per step over ``reps``
    steps, then ``torch.profiler`` over ``profiled`` more: device busy time
    per step, the idle share of the profiled wall (the profiler's own host
    cost is in it), device launches per step and the kernels that take the
    most device time.  Returns (ms per step, profile)."""
    import copy

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gcn_song_embeddings_tpu_torch.ops.ppr import block_generator
    from gcn_song_embeddings_tpu_torch.train.trainer import (
        make_optimizer,
        train_step,
    )

    from gcn_song_embeddings_tpu_torch.ops import agg

    tcfg, mcfg = trainer.cfg.train, trainer.cfg.model
    params = copy.deepcopy(trainer.params)
    opt = make_optimizer(params, tcfg)
    gen = block_generator(999, 0, trainer.device)
    batches = [trainer.sample(gen) for _ in range(2 + reps + profiled)]

    def bwd_counts():
        return {"frontier": agg.bwd_frontier_launches,
                "table": agg.bwd_launches, "csr": agg.csr_launches}

    def run(batches) -> float:
        t = time.perf_counter()
        for b in batches:
            train_step(params, opt, b, trainer.tables, tcfg, mcfg,
                       fullgraph)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / len(batches)

    run(batches[:2])
    before = bwd_counts()
    step_ms = run(batches[2:2 + reps])
    bwd_launches = {k: (n - before[k]) / reps
                    for k, n in bwd_counts().items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = run(batches[2 + reps:])
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]

    def dev_ms(e):
        return getattr(e, "self_device_time_total", 0.0) / 1e3 / profiled

    busy = sum(dev_ms(e) for e in device)
    top = sorted(device, key=dev_ms, reverse=True)[:8]
    return step_ms, {
        "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy,
        "idle_share": 1.0 - busy / wall_ms,
        "device_launches_per_step": sum(e.count for e in device) / profiled,
        "backward_launches_per_step": bwd_launches,
        "top_kernels_ms_per_step": {e.key[:80]: dev_ms(e) for e in top}}


def short16(dtype: str) -> str:
    """"bfloat16" -> "bf16", "float16" -> "f16": the forms' names."""
    return {"bfloat16": "bf16", "float16": "f16"}[dtype]


def run_train_path16(dev, st, work: str, dtype: str):
    """A 16-bit training path, as a user runs it: ``cli train --set
    train.dtype=...`` (bfloat16 or float16) on the f32 training path's
    schedule and the main path's dataset (frontier forward: K3's 16-bit
    form on the deepest layer), then ``cli embed`` of its checkpoint.
    Returns its state."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from gcn_song_embeddings_tpu_torch import cli
    from gcn_song_embeddings_tpu_torch.config import config_with_overrides

    name = short16(dtype)
    cfg, cfg_path = train_config(work)
    cfg = config_with_overrides(cfg.replace(run_name=f"smoke_{name}"),
                                {"train.dtype": dtype})
    runs = os.path.join(work, "runs")
    t = time.perf_counter()
    cli.main(["train", "--dataset", st.ds, "--run-dir", runs,
              "--run-name", cfg.run_name, "--config", cfg_path,
              "--set", f'train.dtype="{dtype}"', "--device", str(dev)])
    sync(torch, dev)
    walls = {f"train_{name}_s": time.perf_counter() - t}
    run_dir = os.path.join(runs, cfg.run_name)
    out = os.path.join(work, f"emb_{name}_cli.npy")
    t = time.perf_counter()
    cli.main(["embed", "--dataset", st.ds, "--out", out, "--checkpoint",
              os.path.join(run_dir, "state.npz"), "--device", str(dev)])
    walls[f"embed_{name}_cli_s"] = time.perf_counter() - t
    return SimpleNamespace(cfg=cfg, run_dir=run_dir, walls=walls,
                           emb=np.load(os.path.join(run_dir, "emb.npy")),
                           cli_emb=np.load(out), n_items=st.graph.n_items)


def check_run16(torch, st, bf) -> dict:
    """A 16-bit run: 50 finite metric rows with a falling loss, every
    master leaf and Adam moment of its state.npz in f32, its config.json
    saying its dtype, and ``cli embed`` of its checkpoint on the card
    within 1e-4 of the port's CPU path (``pinsage_forward`` on 64 nodes
    from the same leaves) and equal to the run's own emb.npy."""
    import numpy as np

    from gcn_song_embeddings_tpu_torch.config import RunConfig
    from gcn_song_embeddings_tpu_torch.models.pinsage import pinsage_forward
    from gcn_song_embeddings_tpu_torch.utils.checkpoint import (
        load_jax_checkpoint,
    )

    dtype = bf.cfg.train.dtype
    name = short16(dtype)
    with open(os.path.join(bf.run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    loss = np.array([r["Train Loss"] for r in rows])
    first, last = float(loss[:10].mean()), float(loss[-10:].mean())
    log(f"train {name}: loss first 10 {first:.5f} -> last 10 {last:.5f}")
    if not (len(rows) == TRAIN_EPOCHS * TRAIN_BATCHES
            and np.isfinite(loss).all() and last < first):
        raise AssertionError(f"{name} run: {len(rows)} rows, losses {loss}")
    with np.load(os.path.join(bf.run_dir, "state.npz")) as z:
        kinds = {k: z[k].dtype for k in z.files
                 if k.startswith(("['params']", "adam.m", "adam.v"))}
    if not kinds or any(d != np.float32 for d in kinds.values()):
        raise AssertionError(f"{name} checkpoint leaves not f32: {kinds}")
    with open(os.path.join(bf.run_dir, "config.json")) as f:
        if RunConfig.from_json(f.read()).train.dtype != dtype:
            raise AssertionError(f"the {name} run's config.json lost its "
                                 f"dtype")
    mcfg = bf.cfg.model
    probe = torch.arange(0, bf.n_items, bf.n_items // 64)[:64].to(
        torch.int32)
    params = load_jax_checkpoint(os.path.join(bf.run_dir, "state.npz"))
    with torch.inference_mode():
        ref = pinsage_forward(params, st.feats.cpu(), st.nbw_d.cpu(),
                              st.nbn_d.cpu(), probe, mcfg.n_layers,
                              mcfg.T).numpy()
    cpu_err = float(np.abs(bf.cli_emb[probe.numpy()] - ref).max())
    own_err = float(np.abs(bf.cli_emb - bf.emb).max())
    log(f"cli embed of the {name} run (card) vs the CPU path on 64 nodes: "
        f"max |diff| {cpu_err:.3g}; vs the run's emb.npy {own_err:.3g}")
    if not (cpu_err <= 1e-4 and own_err <= 1e-6
            and bf.cli_emb.shape == (bf.n_items, mcfg.out_dim)):
        raise AssertionError(f"{name} run's embeddings: {cpu_err}, "
                             f"{own_err}")
    return {"loss_first10": first, "loss_last10": last,
            "f32_leaves": len(kinds), "cli_embed_vs_cpu": cpu_err,
            "cli_embed_vs_run": own_err}


def three_step_checks16(torch, trainer) -> dict:
    """3 steps in the trainer's 16-bit dtype from its seeded init on the
    same batches: the frontier forward (K3's 16-bit form) on the card
    against the CPU's plain versions (losses within LOSS_RTOL16, every
    master leaf within one ulp of the dtype plus 2 lr), then the
    full-graph forward (K2's 16-bit form in both layers, forward and
    backward) on the card: finite losses, f32 masters, and its losses
    beside the frontier's (they differ by design: the full graph stores
    each layer's output in 16 bits, the frontier keeps it f32; held
    within 1e-2).  Returns the worst differences and the three runs'
    losses."""
    import copy

    import numpy as np

    from gcn_song_embeddings_tpu_torch.models.pinsage import init_pinsage
    from gcn_song_embeddings_tpu_torch.ops.ppr import block_generator
    from gcn_song_embeddings_tpu_torch.train.trainer import (
        TrainTables,
        make_optimizer,
        train_step,
    )

    tcfg, mcfg = trainer.cfg.train, trainer.cfg.model
    name = short16(tcfg.dtype)
    gen = block_generator(12345, 0, trainer.device)
    batches = [trainer.sample(gen) for _ in range(3)]
    seeded = torch.Generator(device=trainer.device)
    seeded.manual_seed(tcfg.seed)
    init = init_pinsage(seeded, mcfg.n_layers, mcfg.in_dim, mcfg.hidden_dim,
                        mcfg.out_dim, mcfg.bias_init)

    def run(params, tables, batches, fullgraph):
        opt = make_optimizer(params, tcfg)
        losses = [float(train_step(params, opt, b, tables, tcfg, mcfg,
                                   fullgraph)[0]) for b in batches]
        return losses, {leaf: p.detach().cpu().numpy()
                        for leaf, p in params.leaves()}

    card = run(copy.deepcopy(init), trainer.tables, batches, False)
    sync(torch, trainer.device)
    cpu_tables = TrainTables(*(t.cpu() for t in trainer.tables))
    cpu = run(copy.deepcopy(init).cpu(), cpu_tables,
              [b.cpu() for b in batches], False)
    worst = {leaf: float(np.abs(card[1][leaf] - cpu[1][leaf]).max())
             for leaf in card[1]}
    log(f"{name} three steps, card vs cpu: losses {card[0]} vs {cpu[0]}; "
        f"max |diff| per leaf {worst}")
    np.testing.assert_allclose(card[0], cpu[0], rtol=LOSS_RTOL16,
                               err_msg=f"{name} card vs cpu: losses")
    for leaf in card[1]:
        np.testing.assert_allclose(card[1][leaf], cpu[1][leaf],
                                   rtol=ULP16[tcfg.dtype], atol=2 * tcfg.lr,
                                   err_msg=f"{name} card vs cpu: {leaf}")
    full = run(copy.deepcopy(init), trainer.tables, batches, True)
    sync(torch, trainer.device)
    log(f"{name} three steps, full graph (card): losses {full[0]}")
    if not (np.isfinite(full[0]).all()
            and all(v.dtype == np.float32 for v in full[1].values())):
        raise AssertionError(f"{name} full-graph steps: {full[0]}")
    np.testing.assert_allclose(full[0], card[0], rtol=1e-2,
                               err_msg=f"{name} full graph vs frontier")
    return {"card_vs_cpu": worst, "frontier_losses": card[0],
            "cpu_losses": cpu[0], "fullgraph_losses": full[0]}


def step_shapes16(torch, trainer, st, dtype):
    """The 16-bit kernels' shapes on this data in ``dtype`` (torch's):
    K3's at the deepest conv of a frontier step (the gathered 16-bit
    feature rows, f32 weights, 16-bit Wq) and K2's at both full-graph
    layers over the catalog (the 16-bit features, then the first layer's
    output stored in 16 bits; 16-bit weights).  Each entry is (table,
    ids, weights, Wq, bq)."""
    from gcn_song_embeddings_tpu_torch.models.pinsage import (
        cast_params,
        conv_from_table,
    )
    from gcn_song_embeddings_tpu_torch.ops.ppr import block_generator

    mcfg = trainer.cfg.model
    pc = cast_params(trainer.params, dtype)
    layer, table, ids, wts, _ = step_conv_inputs(
        torch, trainer, trainer.sample(block_generator(4242, 0,
                                                       trainer.device)))[0]
    k3 = [(table.to(dtype), ids, wts, pc.layers[0].Wq.detach(),
           pc.layers[0].bq.detach().float())]
    nb_idx = st.nbn_d[:, :mcfg.T].to(torch.int32).contiguous()
    nb_wt = st.nbw_d[:, :mcfg.T].to(dtype).contiguous()
    feats = st.feats.to(dtype)
    with torch.inference_mode():
        h1 = conv_from_table(pc.layers[0], feats, feats, nb_idx,
                             nb_wt).to(dtype)
    k2 = [(table, nb_idx, nb_wt, pc.layers[l].Wq.detach(),
           pc.layers[l].bq.detach().float())
          for l, table in enumerate((feats, h1))]
    return k3, k2


def k2_parts16(torch, agg, h, ids, wts, Wq, bq, got) -> dict:
    """K2's 16-bit kernels one by one, each held against its plain version
    and timed beside it: the Wq tiling (bit for bit), the projection and
    the gather-mean (max |diff|), with the gather's L2 read rate, beside
    the same gather-mean over the same projection with ids that walk the
    table in order (node b reads rows T b .. T b + T - 1), and beside
    ``agg.l2_read_probe`` streaming one 25.6 MB slab of P through L2 as
    many times as the gather reads slab rows: the rate at which this
    card's L2 serves a plain streaming read of that many bytes."""
    tile, project = agg.tile_wq16, agg.project_table16
    hdim = Wq.shape[0]
    tiles = tile(Wq)
    if not torch.equal(tiles.view(torch.int16),
                       agg.tile_wq_plain(Wq).view(torch.int16)):
        raise AssertionError("the 16-bit Wq tiling differs from "
                             "tile_wq_plain")
    proj = project(h, tiles, bq)
    rows = agg.slabs_to_rows(proj, hdim)
    proj_err = float((rows - agg.project_table_plain(h, Wq, bq))
                     .abs().max())
    out = torch.empty_like(got)
    mean = agg.gather_mean(proj, ids, wts, out)
    mean_err = float((mean - agg.gather_mean_plain(rows, ids, wts))
                     .abs().max())
    if not (proj_err <= K2_ATOL and mean_err <= K2_ATOL
            and torch.equal(mean, got)):
        raise AssertionError(f"K2 16-bit parts: projection {proj_err}, "
                             f"gather-mean {mean_err}")
    b, t = ids.shape
    seq = (torch.arange(b * t, device=ids.device, dtype=torch.int32)
           % h.shape[0]).reshape(b, t)
    # the L2 probe: one slab of P (25.6 MB at the 100k catalog), read as
    # many times as the gather reads slab rows
    bytes_read = 4.0 * b * t * proj.shape[0] * 64
    slab = proj[0]
    passes = max(1, round(bytes_read / (4.0 * slab.numel())))
    return {
        "tile": {"max_abs_err": 0.0,
                 "ms": cuda_ms(torch, lambda: tile(Wq), reps=10),
                 "plain_ms": cuda_ms(torch, lambda: agg.tile_wq_plain(Wq),
                                     reps=3)},
        "project": {"max_abs_err": proj_err,
                    "ms": cuda_ms(torch, lambda: project(h, tiles, bq),
                                  reps=5),
                    "plain_ms": cuda_ms(torch, lambda: agg.
                                        project_table_plain(h, Wq, bq),
                                        reps=3)},
        "gather_mean": {"max_abs_err": mean_err,
                        "ms": cuda_ms(torch, lambda: agg.gather_mean(
                            proj, ids, wts, out), reps=5),
                        "plain_ms": cuda_ms(torch, lambda: agg.
                                            gather_mean_plain(rows, ids,
                                                              wts), reps=3),
                        "table_order_ms": cuda_ms(
                            torch, lambda: agg.gather_mean(proj, seq, wts,
                                                           out), reps=5),
                        "bytes_read": bytes_read,
                        "l2_probe_ms": cuda_ms(
                            torch, lambda: agg.l2_read_probe(slab, passes),
                            reps=5),
                        "l2_probe_bytes": 4.0 * slab.numel() * passes},
    }


def backward_timing16(torch, agg, mode, h, ids, wts, Wq, bq,
                      need_dh) -> dict:
    """The aggregation's backward at one 16-bit shape (16-bit h and Wq, f32
    bq): ``hold_backward_twin``'s keys (the kernel against its twin on
    the 16-bit forward's residual and weights); ``err`` and ``plain_err``,
    each gradient's relative Frobenius error, of ConvAggregate's and of
    autograd through the plain version on the same 16-bit inputs, against
    float64 autograd of the plain version on their exact upcasts at the
    slopes of the forward's residual, ConvAggregate's held within the
    larger of 4x the plain version's and GRAD_RTOL (its dh and dWq are
    rounded to 16 bits once, the plain version's at every step); ``ms``,
    ``host_ms`` and ``plain_ms`` as ``backward_timing``'s."""
    from types import SimpleNamespace

    gen = torch.Generator(device=h.device)
    gen.manual_seed(7)
    cot = torch.randn((ids.shape[0], Wq.shape[0]), device=h.device,
                      generator=gen)
    timing = hold_backward_twin(torch, agg, mode,
                                SimpleNamespace(Wq=Wq, bq=bq), h, ids, wts,
                                cot)

    def leaves(dtype=None):
        hh, wq, b = (x.detach().to(dtype or x.dtype, copy=True)
                     for x in (h, Wq, bq))
        hh.requires_grad_(need_dh)
        wq.requires_grad_()
        b.requires_grad_()
        return hh, wq, b, ((hh, wq, b) if need_dh else (wq, b))

    with torch.no_grad():
        slope = torch.where(agg.conv_aggregate_slopes(h, ids, wts, Wq, bq,
                                                      mode), 1.0,
                            0.01).double()
    hh, wq, b, inputs = leaves(torch.float64)
    ref = torch.autograd.grad(
        plain_at_slopes(torch, agg, hh, ids, wts.double(), wq, b, slope),
        inputs, cot.double())
    del slope
    hh, wq, b, inputs = leaves()
    nb = None if is_identity(torch, ids, h.shape[0]) else ids
    out = agg.conv_aggregate(hh, nb, wts, wq, b, mode=mode)
    plain = agg.conv_aggregate_plain(hh, ids, wts, wq, b)

    def error(grads):
        return [float(torch.linalg.vector_norm(g.double() - r)
                      / torch.linalg.vector_norm(r))
                for g, r in zip(grads, ref)]

    err = error(torch.autograd.grad(out, inputs, cot, retain_graph=True))
    plain_err = error(torch.autograd.grad(plain, inputs, cot,
                                          retain_graph=True))
    del ref
    names = ("dh", "dWq", "dbq") if need_dh else ("dWq", "dbq")
    log(f"{agg.MODES[mode]} {agg._form(h.dtype)} backward vs float64 "
        f"autograd at the residual's slopes, relative Frobenius error: "
        + ", ".join(f"{g} {e:.3g} (plain {p:.3g})"
                    for g, e, p in zip(names, err, plain_err)))
    for g, e, p in zip(names, err, plain_err):
        if not e <= max(4 * p, GRAD_RTOL):
            raise AssertionError(f"{agg.MODES[mode]} "
                                 f"{agg._form(h.dtype)} backward {g} errs "
                                 f"{e} against float64, > 4x the plain "
                                 f"version's {p} and > {GRAD_RTOL}")

    def grad():
        return torch.autograd.grad(out, inputs, cot, retain_graph=True)

    timing.update(err=err, plain_err=plain_err, flips=0,
                  ms=cuda_ms(torch, grad, reps=5),
                  host_ms=cuda_ms(torch, grad, reps=5, queued=False),
                  plain_ms=cuda_ms(torch, lambda: torch.autograd.grad(
                      plain, inputs, cot, retain_graph=True), reps=3))
    return timing


def measure_aggregation16(torch, agg, mode, shapes, need_dh=None) -> dict:
    """Hold a 16-bit form of the aggregation of ``mode`` against its plain
    version at each (table, ids, weights, Wq, bq) of ``shapes`` (max
    |diff| within K2_ATOL; 16-bit products are exact in f32, so only the
    order of the f32 sums differs; the error against float64 on the same
    16-bit inputs within 4x the plain version's) and time it: kernel
    (``ms`` back to back on the device, ``host_ms`` as the host issues
    it), plain version and the library yardstick (one ``torch.einsum`` of
    the gathered 16-bit rows with the 16-bit Wq), summed over the shapes,
    with the work each needs on this data (16-bit rows and Wq of 2
    bytes).  Mode "stream" also holds K2's 16-bit kernels to their plain
    versions one by one and times them (``parts``, with the gather's L2
    read rates).  With ``need_dh`` (whether each shape's dh is taken, as
    in the train step) the backward is held and timed at each shape too
    (``backward_timing16``), into ``measure_aggregation``'s BWD_KEYS."""
    out = {"ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "flops": 0.0, "products": 0.0, "bytes": 0.0, "err": 0.0,
           "err64": 0.0, "plain_err64": 0.0}
    if need_dh is not None:
        out.update(dict.fromkeys(BWD_KEYS, 0.0))
    if mode == "stream":
        out["parts"] = {}
    for i, (h, ids, wts, Wq, bq) in enumerate(shapes):
        kernel = f"{agg.MODES[mode]} {agg._form(h.dtype)}"
        n, din = h.shape
        hdim = Wq.shape[0]
        with torch.inference_mode():
            got = agg.conv_aggregate(h, ids, wts, Wq, bq, mode=mode)
            want = agg.conv_aggregate_plain(h, ids, wts, Wq, bq)
            err = float((got - want).abs().max())
            log(f"{kernel} B={ids.shape[0]} T={ids.shape[1]} Din={din} "
                f"H={hdim} (table {n} rows, weights {wts.dtype}): max "
                f"|diff| {err:.3g}")
            if not err <= K2_ATOL:
                raise AssertionError(f"{kernel} differs from the plain "
                                     f"version by {err} > {K2_ATOL}")
            err64, plain_err64 = float64_error(torch, agg, h, ids, wts, Wq,
                                               bq, got, want)
            log(f"{kernel} max |error| against float64: kernel "
                f"{err64:.3g}, plain version {plain_err64:.3g}")
            if not err64 <= 4 * plain_err64:
                raise AssertionError(f"{kernel} errs {err64} against "
                                     f"float64, > 4x the plain version's "
                                     f"{plain_err64}")
            out["err"] = max(out["err"], err)
            out["err64"] = max(out["err64"], err64)
            out["plain_err64"] = max(out["plain_err64"], plain_err64)
            if mode == "stream":
                for name, part in k2_parts16(torch, agg, h, ids, wts, Wq,
                                             bq, got).items():
                    acc = out["parts"].setdefault(name, {})
                    for key, value in part.items():
                        acc[key] = (max(acc.get(key, 0.0), value)
                                    if key == "max_abs_err"
                                    else acc.get(key, 0.0) + value)
            del got, want
            out["slopes_ms"] = out.get("slopes_ms", 0.0) + slopes_ms(
                torch, agg, mode, h, ids, wts, Wq, bq)
            out["ms"] += cuda_ms(torch, lambda: agg.conv_aggregate(
                h, ids, wts, Wq, bq, mode=mode), reps=5)
            out["host_ms"] += cuda_ms(torch, lambda: agg.conv_aggregate(
                h, ids, wts, Wq, bq, mode=mode), reps=5, queued=False)
            out["plain_ms"] += cuda_ms(torch, lambda: agg.
                                       conv_aggregate_plain(h, ids, wts, Wq,
                                                            bq), reps=3)
            out["library_ms"] += cuda_ms(torch, lambda: torch.einsum(
                "btd,hd->bth", h[ids.long()], Wq), reps=3)
        flops, nbytes, distinct, _ = agg_work(torch, ids, wts, din, hdim, n,
                                              elem=2)
        out["flops"] += flops
        out["products"] += 2.0 * distinct * din * hdim
        out["bytes"] += nbytes
        if need_dh is not None:
            bw = backward_timing16(torch, agg, mode, h, ids, wts, Wq, bq,
                                   need_dh[i])
            add_backward(torch, out, bw, ids, wts, din, hdim, n, need_dh[i],
                         mode, elem=2)
    if mode == "stream":
        g = out["parts"]["gather_mean"]
        g["read_TBps"] = g["bytes_read"] / (g["ms"] * 1e9)
        g["table_order_read_TBps"] = g["bytes_read"] / (g["table_order_ms"]
                                                        * 1e9)
        g["l2_probe_read_TBps"] = g["l2_probe_bytes"] / (g["l2_probe_ms"]
                                                         * 1e9)
    return out


def kernel_row16(name, source, replaces, launches_by_path, bwd_launches,
                 m, shape) -> dict:
    """One 16-bit entry of the ``kernels`` line: its products bound on the
    16-bit tensor cores (one pass each, 989 TFLOP/s for bf16 and f16
    alike); its backward's row (``backward_row``) where ``m`` timed it."""
    bound_ms, bound_by = bound(m["flops"], m["bytes"], m["products"],
                               H100_BF16_FLOPS, passes=1)
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": sum(launches_by_path.values()),
        "launches_by_path": launches_by_path, "max_abs_err": m["err"],
        "ms": m["ms"], "host_ms": m["host_ms"], "plain_ms": m["plain_ms"],
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": m["library_ms"],
        **({"ms_with_slopes": m["slopes_ms"]} if m.get("slopes_ms") else {}),
        "max_abs_err_vs_float64": m["err64"],
        "plain_max_abs_err_vs_float64": m["plain_err64"],
        "backward": (backward_row(name, bwd_launches, m, shape)
                     if "bwd_ms" in m else
                     {"route": "cuda, csrc/agg_bwd.cu (the slopes of the "
                               "forward's f32 sums; held on the card by "
                               "tests/test_torch_agg_backward_gpu.py and "
                               "at the 16-bit train steps' shapes, not "
                               "timed at these)",
                      "launches_on_16bit_paths": bwd_launches}),
        "shape": shape,
        **({"parts": m["parts"]} if "parts" in m else {}),
    }


def run_tail_path(dev, st, tr_st, bf, work: str) -> dict:
    """The tail modules on the card, as a user calls them: the embedding
    crawl's walks (``explore.crawl_walk_counts``, K1) from N_CRAWLS tracks
    of the 100k catalog, ``profiling.Timer`` phases timed with CUDA
    events, a ``profiling.device_profile`` trace written under the work
    directory, and the recommendation lists and figure of N_EXPORTS
    queries from the f32 and the bf16 trained embeddings
    (``qualitative.export_recommendation_lists``).  Returns its walls,
    launches and checks."""
    import numpy as np
    import torch

    from gcn_song_embeddings_tpu_torch.data import explore
    from gcn_song_embeddings_tpu_torch.evals import qualitative
    from gcn_song_embeddings_tpu_torch.ops import walk_kernel
    from gcn_song_embeddings_tpu_torch.ops.knn import knn_from_emb
    from gcn_song_embeddings_tpu_torch.utils import profiling

    graph = st.graph
    timer = profiling.Timer()
    emb = {"PinSage": torch.as_tensor(tr_st.emb, device=dev),
           "PinSage bf16": torch.as_tensor(bf.emb, device=dev)}
    crawl_rows = st.rows[:N_CRAWLS]
    before = walk_kernel.launches
    with timer.phase("crawl", sync_value=emb["PinSage"]):
        crawls = {q: explore.crawl_walk_counts(graph, q, top=10, device=dev)
                  for q in crawl_rows}
    crawl_walks = walk_kernel.launches - before
    queries = np.asarray(st.rows[:N_EXPORTS])
    knn = {}
    trace_dir = os.path.join(work, "tail_trace")
    with profiling.device_profile(trace_dir) as prof:
        for name, table in emb.items():
            with timer.phase(f"knn {name}", sync_value=table):
                w, n = knn_from_emb(table, queries=queries, k=10)
            full_w = np.zeros((graph.n_items, 10), np.float32)
            full_n = np.zeros((graph.n_items, 10), np.int32)
            full_w[queries], full_n[queries] = w, n
            knn[name] = (full_w, full_n)
    device_us = sum(getattr(e, "self_device_time_total", 0.0)
                    for e in prof.key_averages())
    traces = os.listdir(trace_dir)
    out_root = os.path.join(work, "examples")
    t = time.perf_counter()
    qualitative.export_recommendation_lists(graph, queries, knn, k=5,
                                            out_root=out_root)
    export_s = time.perf_counter() - t
    lists = 0
    for q in queries:
        song = graph.tracks[graph.track_ids[int(q)]]["name"]
        for name in knn:
            with open(os.path.join(out_root, song, name, "list.json")) as f:
                lst = json.load(f)
            if len(lst) != 6 or lst[0]["title"] != song:
                raise AssertionError(f"list of {q} / {name}: {lst}")
            lists += 1
        with open(os.path.join(out_root, song, "figure.tex")) as f:
            if "<title_" in f.read():
                raise AssertionError(f"figure of {q} left placeholders")
    bad = {q: c for q, c in crawls.items()
           if not c or any(n == q or s <= 0 for n, s in c)}
    if bad or crawl_walks != len(crawl_rows):
        raise AssertionError(f"crawl: {crawl_walks} K1 launches for "
                             f"{len(crawl_rows)} crawls; bad lists {bad}")
    if not (len(traces) == 1 and device_us > 0
            and all(v > 0 for v in timer.times.values())):
        raise AssertionError(f"profiling: traces {traces}, device "
                             f"{device_us} us, timer {timer.times}")
    overlap = float(np.mean([len(set(knn["PinSage"][1][q][:10])
                                 & set(knn["PinSage bf16"][1][q][:10]))
                             / 10 for q in queries]))
    log(f"tail: {len(crawl_rows)} crawls ({crawl_walks} K1 launches), "
        f"{lists} lists exported in {export_s:.3f} s, trace {traces[0]} "
        f"({device_us / 1e3:.3f} ms on the device), timer {timer.times}; "
        f"top-10 overlap of the f32 and bf16 runs' lists {overlap:.2f}")
    return {"walls": {**{f"{k}_s": v for k, v in timer.times.items()},
                      "export_s": export_s},
            "crawl_walks": crawl_walks,
            "checks": {"crawls": {str(q): c[:3] for q, c in crawls.items()},
                       "lists": lists, "trace": traces[0],
                       "trace_device_ms": device_us / 1e3,
                       "f32_bf16_top10_overlap": overlap}}


EVAL_K, EVAL_QUERIES = 100, 256
NODE2VEC_EPOCHS = 1  # cut from the default 10 (PERF.md section 4)
# the roster eval's GNN rows (GraphSAGE, GAT, GCN) cut from 1,500 steps,
# and its lists from the CLI's K=1000 (the roster's orderings read hr@10,
# hr@100 and hr@500; mrr and the low-degree / low-co columns then stop
# at rank 500), for the script's time limit (PERF.md section 4)
ROSTER_GNN_STEPS = 400
ROSTER_K = 500


def count_walk_launches(walk_kernel, models) -> dict:
    """Wrap each model's ``train`` and ``knn`` so the K1 launches they
    make are added to the returned {row: launches} as they run."""
    counts = dict.fromkeys(models, 0)
    for name, model in models.items():
        for method in ("train", "knn"):
            call = getattr(model, method)

            def counted(*args, _call=call, _name=name, **kw):
                before = walk_kernel.launches
                try:
                    return _call(*args, **kw)
                finally:
                    counts[_name] += walk_kernel.launches - before

            setattr(model, method, counted)
    return counts


def read_csv_rows(path: str) -> dict:
    """A results CSV -> {model: {column: float}}."""
    import csv

    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return {r[0]: {c: float(x) for c, x in zip(rows[0][1:], r[1:])}
            for r in rows[1:]}


def check_eval(torch, dev, ev) -> dict:
    """The eval path's outputs: both CSVs hold a finite row per model, each
    kNN cache is [N, K] (JaccardFast's [N, K - 1]); ``rank_eval`` on the
    card over every test pair against the full catalog gives the PinSage
    row's hit@10 and hit@100 within 1e-3 of the list-based table's; the kNN
    ids of 256 PinSage queries on the card equal a CPU f32 recompute up to
    ties within 1e-6."""
    import numpy as np

    from gcn_song_embeddings_tpu_torch.evals.device_eval import rank_eval
    from gcn_song_embeddings_tpu_torch.ops.knn import knn_from_emb

    graph = ev.graph
    tables = {name: read_csv_rows(os.path.join(ev.eval_dir, name))
              for name in ("results_accuracy.csv", "results_beyond.csv")}
    for name, table in tables.items():
        if sorted(table) != sorted(ev.models) or not all(
                np.isfinite(v) for row in table.values()
                for v in row.values()):
            raise AssertionError(f"{name}: rows {list(table)}, not all "
                                 f"finite")
    for model in ev.models:
        with np.load(os.path.join(ev.eval_dir, "knn", model + ".npz")) as z:
            shape = z["knn_n"].shape
        # JaccardFast drops its top-k's column 0, as the reference does
        k = ev.k - 1 if model == "JaccardFast" else ev.k
        if shape != (graph.n_items, k):
            raise AssertionError(f"knn/{model}.npz has shape {shape}")
    acc = tables["results_accuracy.csv"]
    _, test_pos = graph.load_positives_split(
        os.path.join(graph.base_dir, "positives.json"))
    out = {"accuracy": acc, "beyond": tables["results_beyond.csv"],
           "rank_eval": {}}
    for model, emb in ((ev.pinsage, ev.emb),
                       ("Features", np.load(os.path.join(
                           graph.base_dir, "features.npy")))):
        sync(torch, dev)
        t = time.perf_counter()
        got = rank_eval(emb, test_pos, device=dev)
        sync(torch, dev)
        got["s"] = time.perf_counter() - t
        diff = {k: abs(got[f"hit@{k}"] - acc[model][f"hr (k={k})"])
                for k in (10, 100)}
        got["diff_vs_lists"] = diff
        out["rank_eval"][model] = got
        log(f"rank_eval {model} over {len(test_pos)} test pairs x "
            f"{graph.n_items} tracks on the card in {got['s']:.3f} s: "
            f"{json.dumps(got)}")
        if model == ev.pinsage and not max(diff.values()) <= 1e-3:
            raise AssertionError(f"rank_eval and the kNN lists disagree "
                                 f"for {model}: {diff}")
    queries = np.arange(0, graph.n_items, graph.n_items // EVAL_QUERIES)
    queries = queries[:EVAL_QUERIES]
    gw, gn = knn_from_emb(ev.emb, queries, k=ev.k, device=dev)
    cw, cn = knn_from_emb(ev.emb, queries, k=ev.k, device="cpu")
    # "equal up to ties": in each place the card's id and the CPU's have
    # exact (float64) cosines within 1e-6 of each other, so ids differ
    # only by a swap inside a near-tie (the self-drop's included) or at
    # the list's end
    e = np.asarray(ev.emb, dtype=np.float64)
    e = e / np.linalg.norm(e, axis=1, keepdims=True)

    def exact(ids):
        return np.einsum("qd,qkd->qk", e[queries], e[ids])

    score_err = float(np.abs(gw - cw).max())
    own_err = float(np.abs(exact(gn) - exact(cn)).max())
    differ = gn != cn
    if not (score_err <= 1e-6 and own_err <= 1e-6):
        raise AssertionError(f"card kNN differs from the CPU's: scores "
                             f"{score_err}, the card ids' own cosines "
                             f"{own_err}, {int(differ.sum())} ids differ")
    out["knn_card_vs_cpu"] = {"queries": len(queries),
                              "max_score_diff": score_err,
                              "max_own_cosine_diff": own_err,
                              "ids_differing_within_ties": int(differ.sum())}
    log(f"kNN of {len(queries)} PinSage queries, card vs CPU f32: "
        f"{json.dumps(out['knn_card_vs_cpu'])}")
    return out


def check_project_once(torch, agg, st) -> dict:
    """``embed_all`` at N=100k launches K2's projection once per layer;
    with ``block_rows=32_768`` it gathers in 4 blocks a layer and gives
    the same embeddings within 1e-5."""
    from gcn_song_embeddings_tpu_torch.models.pinsage import embed_all

    mcfg = st.cfg.model
    args = (st.params, st.feats, st.nbw_d, st.nbn_d, st.graph.n_items,
            mcfg.n_layers, mcfg.T)
    out = {}
    embs = []
    for block_rows in (131_072, 32_768):
        before = dict(agg.kernel_launches)
        embs.append(embed_all(*args, block_rows=block_rows))
        torch.cuda.synchronize()
        counts = {k: agg.kernel_launches[k] - before[k] for k in before}
        blocks = -(-st.graph.n_items // block_rows)
        if counts != {"split": mcfg.n_layers, "project": mcfg.n_layers,
                      "gather_mean": mcfg.n_layers * blocks}:
            raise AssertionError(f"embed_all at block_rows={block_rows}: "
                                 f"{counts}")
        out[f"block_rows_{block_rows}"] = counts
    out["max_abs_diff"] = float((embs[0] - embs[1]).abs().max())
    log(f"embed_all at N={st.graph.n_items}: {json.dumps(out)}")
    if not out["max_abs_diff"] <= 1e-5:
        raise AssertionError(f"blocked embed_all differs: {out}")
    return out


def rel_err(np, a, b) -> float:
    """The largest difference relative to the largest reference entry."""
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def f64_bpr_step(np, m, X, Y, u, i, r, j):
    """One BPR step of ``m`` in float64 with ``np.add.at`` (every
    duplicate id's update summed)."""
    X, Y = X.copy(), Y.copy()
    xu, yi, yj = X[u], Y[i], Y[j]
    z = (1.0 / (1.0 + np.exp(np.sum(xu * (yi - yj), 1))))[:, None]
    for T, ids, g in ((X, u, z * (yi - yj) - m.reg * xu),
                      (Y, i, z * xu - m.reg * yi),
                      (Y, j, -z * xu - m.reg * yj)):
        np.add.at(T, ids, m.lr * g)
    return X, Y


def f64_lmf_step(np, m, X, Y, u, i, r, jneg):
    """One LMF step of ``m`` in float64: AdaGrad accumulators from 1, each
    batch's g*g added before its update reads them."""
    X, Y = X.copy(), Y.copy()
    GX, GY = np.ones_like(X), np.ones_like(Y)
    xu, yi = X[u], Y[i]
    gpos = (r - (1.0 + r) / (1.0 + np.exp(-np.sum(xu * yi, 1))))[:, None]
    un = np.tile(u, 2)
    xn, yn = X[un], Y[jneg]
    gneg = -(1.0 / (1.0 + np.exp(-np.sum(xn * yn, 1))))[:, None] / m.neg_prop
    for T, G, ids, g in ((X, GX, u, gpos * yi - m.reg * xu),
                         (Y, GY, i, gpos * xu - m.reg * yi),
                         (X, GX, un, gneg * yn), (Y, GY, jneg, gneg * xn)):
        np.add.at(G, ids, g * g)
        np.add.at(T, ids, m.lr * g / np.sqrt(G[ids]))
    return X, Y


def check_eval_rows(torch, dev, ev) -> dict:
    """Card-side checks of the eval rows' plain-PyTorch paths: ``ALS.fit``
    on the card against the CPU at a small size (within 1e-4 of the largest
    factor); node2vec walks of 4096 starts over the Node2Vec row's alias
    graph, on the card from draws made on the CPU, equal to the CPU's
    walks with every step an edge of the projection; the BPR and LMF steps
    on a batch of heavily duplicated ids equal to a float64 reference
    within the rounding of their f32 additions (the most repeated id's
    count x 2^-24 x the largest entry); each GNN row's loss falling (the
    first 100 steps' mean above the last 100's)."""
    import numpy as np
    import scipy.sparse as sp

    from gcn_song_embeddings_tpu_torch.models.baselines.mf import (
        ALS,
        BPR,
        LMF,
    )
    from gcn_song_embeddings_tpu_torch.ops.node2vec import (
        draw_walks,
        node2vec_walks,
    )
    from gcn_song_embeddings_tpu_torch.ops.ppr import seeded_generator

    out = {}
    rng = np.random.default_rng(5)
    dense = (rng.random((2000, 1500)) < 0.01) * rng.uniform(
        0.5, 3.0, (2000, 1500))
    mat = sp.csr_matrix(dense.astype(np.float32))
    fits = []
    for d in (dev, "cpu"):
        m = ALS(factors=128, iterations=3, seed=1, device=d)
        m.fit(mat)
        fits.append(m)
    out["als_card_vs_cpu"] = {
        "user_rel_err": rel_err(np, fits[0].user_factors,
                                fits[1].user_factors),
        "item_rel_err": rel_err(np, fits[0].item_factors,
                                fits[1].item_factors)}
    if not max(out["als_card_vs_cpu"].values()) <= 1e-4:
        raise AssertionError(f"ALS card vs CPU: {out['als_card_vs_cpu']}")

    g = ev.built["Node2Vec"].alias
    g_cpu = type(g)(*(t.cpu() for t in g))
    n = g.n
    starts = torch.arange(n)[::max(n // 4096, 1)][:4096]
    draws = draw_walks(len(starts), 20, 3, seeded_generator([6], "cpu"))
    card = node2vec_walks(g, starts.to(dev), 20, 2.0, 0.5,
                          type(draws)(*(t.to(dev) for t in draws))).cpu()
    cpu = node2vec_walks(g_cpu, starts, 20, 2.0, 0.5, draws)
    if not torch.equal(card, cpu):
        raise AssertionError(f"node2vec walks: card differs from the CPU "
                             f"in {int((card != cpu).sum())} entries")
    indptr, indices = g_cpu.indptr.numpy(), g_cpu.indices.numpy()
    edge_keys = np.repeat(np.arange(n, dtype=np.int64),
                          np.diff(indptr)) * n + indices
    w = cpu.numpy()
    steps = w[:, :-1].astype(np.int64) * n + w[:, 1:]
    stuck = (np.diff(indptr)[w[:, :-1]] == 0) & (w[:, :-1] == w[:, 1:])
    off_edge = int((~(np.isin(steps, edge_keys) | stuck)).sum())
    out["node2vec_walks_card_vs_cpu"] = {
        "walks": list(card.shape), "equal": True, "off_edge_steps": off_edge}
    if off_edge:
        raise AssertionError(f"node2vec walks leave the projection's edges "
                             f"{off_edge} times")

    X = rng.normal(0, 0.3, (64, 32)).astype(np.float32)
    Y = rng.normal(0, 0.3, (48, 32)).astype(np.float32)
    u, i = rng.integers(0, 6, 4096), rng.integers(0, 5, 4096)
    j, r = rng.integers(0, 7, 8192), rng.uniform(0.5, 2, 4096)
    r = r.astype(np.float32)
    X64, Y64 = X.astype(np.float64), Y.astype(np.float64)
    errs = {}
    for model, neg in ((BPR(factors=32, learning_rate=1e-4), j[:4096]),
                       (LMF(factors=32, learning_rate=1e-3), j)):
        state = model.start(torch.tensor(X, device=dev),
                            torch.tensor(Y, device=dev))
        model.step(state, *(torch.as_tensor(a, device=dev)
                            for a in (u, i, r, neg)))
        ref = (f64_bpr_step if isinstance(model, BPR) else f64_lmf_step)(
            np, model, X64, Y64, u, i, r, neg)
        err = max(float(np.abs(got.cpu().numpy() - want).max())
                  for got, want in zip(state, ref))
        # the rounding of the f32 additions: each of the most repeated
        # id's adds rounds at most half an ulp of the largest entry
        dups = max(np.bincount(a).max() for a in (u, i, neg))
        tol = dups * 2.0 ** -24 * max(float(np.abs(w).max()) for w in ref)
        errs[type(model).__name__] = {"max_abs_err": err, "tolerance": tol,
                                      "most_repeated_id": int(dups)}
        if not err <= tol:
            raise AssertionError(f"scatter-adds of duplicate ids: {errs}")
    out["duplicate_id_scatter_adds_vs_float64"] = errs

    losses = {}
    for row in ("GraphSAGE", "GAT", "GCN"):
        loss = ev.built[row].model.losses
        losses[row] = {"first_100": float(loss[:100].mean()),
                       "last_100": float(loss[-100:].mean()),
                       "steps": len(loss)}
        if not losses[row]["last_100"] < losses[row]["first_100"]:
            raise AssertionError(f"{row} loss did not fall: {losses[row]}")
    out["gnn_losses"] = losses
    log(f"eval rows on the card: {json.dumps(out)}")
    return out


# ---- prepare and all, and the audio features ---------------------------
PREPARE_RUN = "smoke_all"
# prepare and all run on a quarter of the main path's catalog: at 100k
# their 100,000 per-track feature files took 150-350 s of the script's
# time limit on an H100 host's file system
PREPARE_TRACKS, PREPARE_COLLECTIONS, PREPARE_POSITIVES = 10_000, 2_500, 20_000
AUDIO_TRACKS, AUDIO_COLLECTIONS, AUDIO_SEED = 256, 64, 5
AUDIO_DIMS = {"mfcc": 40, "openl3": 512, "vggish": 128, "musicnn": 753}
# the card against the port's CPU path: mel front ends (OpenL3's dB mel
# at atol 1e-3, the JAX golden test's bar) and embeddings
FRONT_TOL = {"rtol": 1e-4, "atol": 1e-4}
OPENL3_MEL_TOL = {"rtol": 1e-4, "atol": 1e-3}
EMB_TOL = {"rtol": 1e-3, "atol": 1e-3}
MFCC_BATCH = 512  # generate_features' batch: its frames' device memory


class stage_walks:
    """Count K1's launches inside each of ``cli``'s stage commands while
    ``cli all`` runs them: {command name: launches}."""

    def __init__(self, cli, walk_kernel, names):
        self.cli, self.walk_kernel, self.names = cli, walk_kernel, names
        self.counts = dict.fromkeys(names, 0)

    def __enter__(self):
        self.saved = {n: getattr(self.cli, n) for n in self.names}
        for name, fn in self.saved.items():
            def counted(args, _fn=fn, _name=name):
                before = self.walk_kernel.launches
                try:
                    return _fn(args)
                finally:
                    self.counts[_name] += self.walk_kernel.launches - before

            setattr(self.cli, name, counted)
        return self.counts

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.cli, name, fn)


def run_prepare_path(dev, work: str):
    """``cli prepare --features random --gen-positives`` and then ``cli
    all`` (prepare -> train -> eval) on a ``PREPARE_TRACKS`` dataset made
    as the main path's is (graph.json, tracks.json and collections.json
    only: prepare writes the features and positives.json).  ``all``
    trains with the training path's cut and evaluates Random, PageRank
    and its own ``PinSage:<run>`` row at K=100.  Returns its state."""
    from types import SimpleNamespace

    import torch

    from gcn_song_embeddings_tpu_torch import cli
    from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
    from gcn_song_embeddings_tpu_torch.data.synth import (
        make_synthetic_dataset,
    )
    from gcn_song_embeddings_tpu_torch.ops import walk_kernel

    src = os.path.join(work, "prepare_source")
    make_synthetic_dataset(src, n_tracks=PREPARE_TRACKS,
                           n_collections=PREPARE_COLLECTIONS,
                           tracks_per_collection=TRACKS_PER_COLLECTION,
                           n_positives=PREPARE_POSITIVES,
                           feature_dim=FEATURE_DIM, seed=0)
    ds = os.path.join(work, "prepare_dataset")
    os.makedirs(ds)
    for name in ("graph.json", "tracks.json", "collections.json"):
        shutil.copy(os.path.join(src, name), ds)
    shutil.rmtree(src)
    common = ["--dataset", ds, "--features", "random", "--gen-positives",
              "--seed", "0", "--device", str(dev)]
    t = time.perf_counter()
    prepare_walls = cli.main(["prepare", *common])
    sync(torch, dev)
    walls = {"prepare_s": time.perf_counter() - t, **prepare_walls}
    prepare_k1 = walk_kernel.launches
    pos_path = os.path.join(ds, "positives.json")
    with open(pos_path, "rb") as f:
        positives = f.read()
    pos_stamp = os.stat(pos_path).st_mtime_ns
    runs, eval_dir = os.path.join(work, "runs_all"), os.path.join(
        work, "eval_all")
    with stage_walks(cli, walk_kernel, ("cmd_prepare", "cmd_train",
                                        "cmd_eval")) as stages:
        t = time.perf_counter()
        all_walls = cli.main([
            "all", *common, "--run-dir", runs, "--run-name", PREPARE_RUN,
            "--set", f"train.epochs={TRAIN_EPOCHS}",
            "--set", f"train.batches_per_epoch={TRAIN_BATCHES}",
            "--set", f"train.checkpoint_every_batches={TRAIN_CHUNK}",
            "--k", str(EVAL_K), "--eval-dir", eval_dir,
            "--models", "Random", "PageRank", f"PinSage:{PREPARE_RUN}"])
        sync(torch, dev)
    walls["all_s"] = time.perf_counter() - t
    walls["all"] = all_walls
    log(f"prepare (random features, sweep, walk positives) in "
        f"{walls['prepare_s']:.1f} s ({json.dumps(prepare_walls)}); all in "
        f"{walls['all_s']:.1f} s; K1 launches: prepare {prepare_k1}, all "
        f"by stage {json.dumps(stages)}")
    return SimpleNamespace(ds=ds, runs=runs, eval_dir=eval_dir, walls=walls,
                           prepare_k1=prepare_k1, all_k1=dict(stages),
                           positives=positives, pos_stamp=pos_stamp,
                           graph=SongGraph(ds))


def check_prepare(pp) -> dict:
    """``prepare``'s and ``all``'s outputs: K1 ran once a sweep block in
    prepare and never in ``all``'s prepare or train (the cache
    and the per-track files are reused); ``features_random.npy`` bit-equal
    to a numpy replay of ``RandomFeatures(512, seed=0)`` over 512-row
    batches; every walk pair (a, b) has b in a's top 3 with weight > 0 and
    the pairs are ``generate_walk_positives`` on the written cache; ``all``
    rewrote the same positives.json; its emb.npy is finite and both CSVs
    hold a PinSage row whose hit@100 beats Random's."""
    import numpy as np

    from gcn_song_embeddings_tpu_torch.config import WalkConfig
    from gcn_song_embeddings_tpu_torch.data.positives import (
        generate_walk_positives,
    )

    n = pp.graph.n_items
    sweep_blocks = -(-n // WalkConfig().batch_walkers)
    if pp.prepare_k1 != sweep_blocks:
        raise AssertionError(f"prepare launched K1 {pp.prepare_k1} times, "
                             f"not {sweep_blocks}")
    if pp.all_k1["cmd_prepare"] or pp.all_k1["cmd_train"]:
        raise AssertionError(f"all re-swept: {pp.all_k1}")
    feats = np.load(os.path.join(pp.ds, "features_random.npy"))
    rng = np.random.default_rng(0)
    replay = np.concatenate([rng.normal(size=(min(512, n - s), 512))
                             .astype(np.float32) for s in range(0, n, 512)])
    if feats.shape != (n, 512) or not np.array_equal(feats, replay):
        raise AssertionError(f"features_random.npy {feats.shape} is not "
                             f"RandomFeatures(512, seed=0)'s")
    with np.load(os.path.join(pp.ds, "neighborhoods.npz")) as z:
        weights, nodes = z["weights"], z["nodes"]
    ids = pp.graph.track_ids
    row = {t: i for i, t in enumerate(ids)}
    pairs = json.loads(pp.positives)
    want = generate_walk_positives((weights, nodes), n, seed=0)
    if pairs != [{"a": ids[p["a"]], "b": ids[p["b"]]} for p in want]:
        raise AssertionError("positives.json is not generate_walk_positives "
                             "on the written neighborhoods")
    a = np.array([row[p["a"]] for p in pairs])
    b = np.array([row[p["b"]] for p in pairs])
    top = (nodes[a, :3] == b[:, None]) & (weights[a, :3] > 0)
    if not top.any(axis=1).all():
        raise AssertionError("a walk pair outside its origin's top 3")
    pos_path = os.path.join(pp.ds, "positives.json")
    with open(pos_path, "rb") as f:
        rewritten = f.read()
    if os.stat(pos_path).st_mtime_ns <= pp.pos_stamp or \
            rewritten != pp.positives:
        raise AssertionError("all did not rewrite the same positives.json")
    emb = np.load(os.path.join(pp.runs, PREPARE_RUN, "emb.npy"))
    if emb.shape != (n, 128) or not np.isfinite(emb).all():
        raise AssertionError(f"all's emb.npy: {emb.shape}")
    acc = read_csv_rows(os.path.join(pp.eval_dir, "results_accuracy.csv"))
    beyond = read_csv_rows(os.path.join(pp.eval_dir, "results_beyond.csv"))
    pinsage = f"PinSage:{PREPARE_RUN}"
    if set(acc) != {"Random", "PageRank", pinsage} or set(beyond) != set(acc):
        raise AssertionError(f"all's CSV rows: {sorted(acc)}, "
                             f"{sorted(beyond)}")
    hit = {m: acc[m]["hr (k=100)"] for m in acc}
    if not hit[pinsage] > hit["Random"]:
        raise AssertionError(f"all's PinSage hit@100 {hit[pinsage]} does not "
                             f"beat Random's {hit['Random']}")
    out = {"prepare_k1_launches": pp.prepare_k1, "all_k1_by_stage":
           pp.all_k1, "features_random_bit_equal": True,
           "walk_pairs": len(pairs), "pairs_in_top3": True,
           "positives_rewritten_equal": True, "hit_at_100": hit}
    log(f"prepare checks: {json.dumps(out)}")
    return out


def write_audio_catalog(work: str) -> str:
    """A 256-track catalog (``make_synthetic_dataset``) with a seeded 30 s
    clip per track: three partials and a noise floor; even tracks as
    22,050 Hz int16 ``.wav`` (prepare resamples them), odd tracks as
    16 kHz ``.npy``."""
    import wave

    import numpy as np

    from gcn_song_embeddings_tpu_torch.data.synth import (
        make_synthetic_dataset,
    )

    ds = os.path.join(work, "audio_dataset")
    make_synthetic_dataset(ds, n_tracks=AUDIO_TRACKS,
                           n_collections=AUDIO_COLLECTIONS,
                           n_positives=4 * AUDIO_TRACKS, feature_dim=8,
                           seed=AUDIO_SEED, write_features=False)
    with open(os.path.join(ds, "tracks.json")) as f:
        ids = list(json.load(f))
    clip_dir = os.path.join(ds, "clips")
    os.makedirs(clip_dir)
    rng = np.random.default_rng(AUDIO_SEED)
    for i, tid in enumerate(ids):
        sr = 22_050 if i % 2 == 0 else 16_000
        t = np.arange(30 * sr, dtype=np.float64) / sr
        freqs = rng.uniform(80.0, 4000.0, 3)
        amps = rng.uniform(0.05, 0.3, 3)
        y = sum(a * np.sin(2 * np.pi * f * t) for f, a in zip(freqs, amps))
        y = (y * (1.0 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.2, 4.0) * t))
             / 2.0 + 1e-3 * rng.standard_normal(t.shape)).astype(np.float32)
        if i % 2:
            np.save(os.path.join(clip_dir, f"{tid}.npy"), y)
            continue
        with wave.open(os.path.join(clip_dir, f"{tid}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes((np.clip(y, -1, 1) * 32767).astype(np.int16)
                          .tobytes())
    return ds


def worst(np, got, want, tol) -> dict:
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want)
    ratio = float((err / (tol["atol"] + tol["rtol"] * np.abs(want))).max())
    return {"max_abs_err": float(err.max()), "worst_err_over_tol": ratio}


def run_audio_path(dev, work: str) -> dict:
    """``cli prepare --features mfcc``, ``openl3``, ``vggish`` and
    ``musicnn`` (random init) over a 256-clip catalog, each timed; then,
    for 2 of its clips (a .wav and a .npy), each front end and embedder on
    the card against the port's own CPU path; the MFCC batch's peak
    device memory at generate_features' 512 clips; and, where the FFmpeg
    decoder was built, an mp3 round trip through ``load_clip``.  Returns
    the walls and checks."""
    import numpy as np
    import torch

    from gcn_song_embeddings_tpu_torch import cli
    from gcn_song_embeddings_tpu_torch import features as F
    from gcn_song_embeddings_tpu_torch.models import audio_embedders as ae
    from gcn_song_embeddings_tpu_torch.native import audiodec

    t = time.perf_counter()
    ds = write_audio_catalog(work)
    walls = {"write_clips_s": time.perf_counter() - t}
    for name, dim in AUDIO_DIMS.items():
        t = time.perf_counter()
        cli.main(["prepare", "--dataset", ds, "--features", name,
                  "--device", str(dev)])
        sync(torch, dev)
        walls[f"features_{name}_s"] = time.perf_counter() - t
        mat = np.load(os.path.join(ds, f"features_{name}.npy"))
        if mat.shape != (AUDIO_TRACKS, dim) or not np.isfinite(mat).all():
            raise AssertionError(f"features_{name}.npy: {mat.shape}")
    log(f"audio features over {AUDIO_TRACKS} clips: "
        f"{json.dumps(walls)}")

    cpu = torch.device("cpu")
    with open(os.path.join(ds, "tracks.json")) as f:
        ids = list(json.load(f))[:2]
    clips = np.stack([F.load_clip(os.path.join(ds, "clips", tid + ext))
                      for tid, ext in zip(ids, (".wav", ".npy"))])
    checks = {}
    fronts = {"openl3_mel": (ae.openl3_mel_windows, OPENL3_MEL_TOL),
              "vggish_patches": (ae.vggish_log_mel_patches, FRONT_TOL),
              "musicnn_patches": (ae.musicnn_log_mel_patches, FRONT_TOL)}
    for name, (fn, tol) in fronts.items():
        got, _ = fn(clips, device=dev)
        want, _ = fn(clips, device=cpu)
        checks[name] = worst(np, got.cpu(), want, tol)
    checks["melspectrogram"] = worst(
        np, F.melspectrogram(clips, device=dev),
        F.melspectrogram(clips, device=cpu), FRONT_TOL)
    nets = {"mfcc": lambda d: F.MFCC(device=d),
            "openl3": lambda d: F.OpenL3(device=d),
            "vggish": lambda d: F.VGGish(device=d),
            "musicnn": lambda d: F.MusicNN(device=d)}
    for name, make in nets.items():
        checks[f"{name}_emb"] = worst(np, make(dev).embed_batch(clips),
                                      make(cpu).embed_batch(clips), EMB_TOL)
    bad = {k: v for k, v in checks.items() if v["worst_err_over_tol"] > 1}
    if bad:
        raise AssertionError(f"card vs CPU beyond the bars: {bad}")

    # frame memory of the MFCC batch at generate_features' 512 clips
    batch = np.zeros((MFCC_BATCH, F.CLIP_SAMPLES), np.float32)
    batch[:, :16000] = clips[0, :16000]
    mfcc = F.MFCC(device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    mfcc.embed_batch(batch)
    torch.cuda.synchronize()
    walls["mfcc_512_clips_s"] = time.perf_counter() - t
    checks["mfcc_512_clips_peak_bytes"] = \
        torch.cuda.max_memory_allocated() - base

    checks["decoder_built"] = audiodec.native_available()
    if checks["decoder_built"]:
        sr = 32_000
        tone = (0.5 * np.sin(2 * np.pi * 523.25 * np.arange(3 * sr) / sr)
                ).astype(np.float32)
        path = os.path.join(work, "tone.mp3")
        audiodec.encode_mp3(path, tone, sr)
        y = F.load_clip(path)
        head = y[: 2 * F.SAMPLE_RATE]
        spec = np.abs(np.fft.rfft(head * np.hanning(len(head))))
        peak = float(np.fft.rfftfreq(len(head), 1.0 / F.SAMPLE_RATE)
                     [spec.argmax()])
        if y.shape != (F.CLIP_SAMPLES,) or abs(peak - 523.25) > 3.0 or \
                np.abs(y[-F.SAMPLE_RATE:]).max() != 0.0:
            raise AssertionError(f"mp3 round trip: {y.shape}, peak {peak}")
        checks["mp3_peak_hz"] = peak
    log(f"audio checks (card vs CPU): {json.dumps(checks)}")
    return {"walls": walls, "checks": checks}


# ---- the sharded path: parallel/ on a world of 1 (NCCL) and 2 (gloo) ----

SHARDED_STEPS = 3
SHARDED_PROBE = 4096       # ids the two-rank world embeds (1 block)
SHARDED_ROWS = 64          # kNN queries held against one process's
PART_WALKERS = 50_000      # the partitioned sweep's block (25,000 a rank)
SHARDED_TIMEOUT_S = 480
SERVE_START_S = 240        # a `serve --sharded` process's start, at most
SCALING_STEPS = 10         # scaling_bench's steps a size (timed after as
#                            many of warm-up), in the two-rank world
SHARDED_EMB_SEED = 21      # the sharded kNN's table: seeded normal rows,
#                            apart enough that few scores tie (the
#                            seeded-init model's top cosines crowd near 1)
SHARDED_SERVES = {"f32": [], "int8": ["--int8"],
                  "hybrid": ["--hybrid", "--cached-head"]}


def sharded_serving_table(n_items: int, dim: int = 128):
    import numpy as np

    return np.random.default_rng(SHARDED_EMB_SEED).normal(
        size=(n_items, dim)).astype(np.float32)


def kernel_modules() -> dict:
    from gcn_song_embeddings_tpu_torch.ops import (
        agg,
        dma_agg,
        quant_kernel,
        walk_kernel,
    )

    return {"walk": walk_kernel, "agg": agg, "dma_agg": dma_agg,
            "quant": quant_kernel}


def reset_kernel_counts() -> None:
    from gcn_song_embeddings_tpu_torch.ops import agg, dma_agg

    for mod in kernel_modules().values():
        mod.launches = 0
    agg.launches_bf16 = dma_agg.launches_bf16 = 0
    agg.launches_f16 = dma_agg.launches_f16 = 0
    agg.launches_bf16x1 = dma_agg.launches_bf16x1 = 0
    agg.launches_bf16x3 = dma_agg.launches_bf16x3 = 0
    agg.bwd_launches = agg.csr_launches = agg.bwd_frontier_launches = 0
    for counts in (agg.backward_launches, agg.kernel_launches,
                   agg.kernel_launches_bf16, agg.kernel_launches_f16,
                   agg.kernel_launches_bf16x1, agg.kernel_launches_bf16x3,
                   agg.probe_launches):
        for key in counts:
            counts[key] = 0


def kernel_counts() -> dict:
    from gcn_song_embeddings_tpu_torch.ops import agg, dma_agg

    counts = {name: mod.launches for name, mod in kernel_modules().items()}
    for form in ("bf16", "f16", "bf16x1", "bf16x3"):
        counts[f"agg_{form}"] = getattr(agg, f"launches_{form}")
        counts[f"dma_agg_{form}"] = getattr(dma_agg, f"launches_{form}")
        counts.update({f"agg_{form}_{name}": n for name, n in getattr(
            agg, f"kernel_launches_{form}").items()})
    counts.update({f"agg_backward_{mode}": n
                   for mode, n in agg.backward_launches.items()})
    counts.update({f"agg_{name}": n
                   for name, n in agg.kernel_launches.items()})
    counts["agg_bwd_rows"] = agg.bwd_launches
    counts["agg_bwd_csr"] = agg.csr_launches
    counts["agg_bwd_frontier"] = agg.bwd_frontier_launches
    counts.update({f"probe_{name}": n
                   for name, n in agg.probe_launches.items()})
    return counts


def no_csr_on(counts: dict, path: str) -> None:
    """A path of frontier steps only: the backward's frontier form and no
    CSR (each conv's ids are the identity)."""
    if counts["agg_bwd_csr"] or counts["agg_bwd_rows"]:
        raise AssertionError(f"{path} built {counts['agg_bwd_csr']} CSRs and "
                             f"ran the table form {counts['agg_bwd_rows']} "
                             f"times: its frontier steps state the identity")


def frontier_backward(profile: dict, what: str) -> None:
    """``time_train_steps``' frontier step: one frontier-form backward a
    conv, no CSR and no table form."""
    per = profile["backward_launches_per_step"]
    log(f"{what}: {profile['device_launches_per_step']} launches a step, "
        f"the backward's {per}")
    if per["csr"] or per["table"] or not per["frontier"]:
        raise AssertionError(f"{what} ran the backward's CSR or table form: "
                             f"{per}")


def sharded_config(fullgraph: str):
    """``RunConfig.recommended()`` at full width (in 512, hidden 512, out
    128, T=10, B=128, 500 hops) with ``train.fullgraph_forward``."""
    import dataclasses

    from gcn_song_embeddings_tpu_torch.config import RunConfig

    cfg = RunConfig.recommended("sharded")
    return cfg.replace(train=dataclasses.replace(
        cfg.train, fullgraph_forward=fullgraph))


def leaves_np(params) -> dict:
    """A copy of each leaf (on the CPU ``.numpy()`` would share memory
    with the parameter that Adam goes on updating in place)."""
    return {name: p.detach().cpu().numpy().copy()
            for name, p in params.leaves()}


def sharded_reference(dev, st, work: str) -> dict:
    """The single-process runs every sharded run is held to, for the
    frontier and the full-graph forward: 3 Adam steps from one seeded
    init on 3 global batches of 128, two ways.  ``one``: each batch
    whole, as ``train_step`` takes it (a world of one's arithmetic).
    ``halves``: each batch as a world of two computes it, the loss of
    each 64-row half over 2 and the two halves' gradients summed, at the
    shapes each rank sees.  ``one_again`` repeats ``one``: the spread of
    one process's own runs.  Each keeps its losses, each step's gradients
    and its parameters after 3 steps.  Writes the init (``save_state``)
    and the batches for the ranks."""
    import copy

    import numpy as np
    import torch

    from gcn_song_embeddings_tpu_torch.models.pinsage import init_pinsage
    from gcn_song_embeddings_tpu_torch.ops.ppr import block_generator
    from gcn_song_embeddings_tpu_torch.train.sampler import sample_batch
    from gcn_song_embeddings_tpu_torch.train.trainer import (
        TrainTables,
        make_optimizer,
        triple_loss,
    )
    from gcn_song_embeddings_tpu_torch.utils.checkpoint import save_state

    cfg = sharded_config("off")
    mcfg, tcfg = cfg.model, cfg.train
    tables = TrainTables.build(st.feats, st.nbw_d, st.nbn_d, mcfg.T, dev)
    gen = block_generator(777, 0, dev)
    positives = torch.as_tensor(st.train_pos, dtype=torch.int32, device=dev)
    batches = [sample_batch(gen, positives, st.nbn_d, tcfg.batch_size,
                            st.graph.n_items) for _ in range(SHARDED_STEPS)]
    seeded = torch.Generator(device=dev)
    seeded.manual_seed(tcfg.seed)
    init = init_pinsage(seeded, mcfg.n_layers, st.feats.shape[1],
                        mcfg.hidden_dim, mcfg.out_dim, mcfg.bias_init)
    ref = {"init": init, "batches": batches}
    for mode in ("off", "on"):
        ref[mode] = {}
        for name, parts in (("one", 1), ("halves", 2), ("one_again", 1)):
            params = copy.deepcopy(init)
            opt = make_optimizer(params, tcfg)
            losses, steps = [], []
            for bt in batches:
                loss, grads = 0.0, None
                for part in bt.chunk(parts):
                    part_loss = triple_loss(params, tables, part, tcfg, mcfg,
                                            mode == "on")[0] / parts
                    g = torch.autograd.grad(part_loss, opt.params)
                    grads = g if grads is None else [
                        a + b for a, b in zip(grads, g)]
                    loss = loss + part_loss.detach()
                steps.append({leaf: x.cpu().numpy() for (leaf, _), x in zip(
                    init.leaves(), grads)})
                opt.step(grads)
                losses.append(float(loss))
            ref[mode][name] = {"losses": losses, "grads": steps,
                               "leaves": leaves_np(params)}
    sync(torch, dev)
    d = os.path.join(work, "sharded")
    os.makedirs(d, exist_ok=True)
    np.save(os.path.join(d, "batches.npy"),
            np.stack([b.cpu().numpy() for b in batches]))
    save_state(os.path.join(d, "init.npz"), init,
               make_optimizer(init, tcfg), {})
    return ref


def hold_sharded_run(np, name, losses, grads, leaves, ref) -> dict:
    """A sharded 3-step run against one process's run of the same
    arithmetic (``sharded_reference``): the 3 losses at TRAJ, each step's
    gradients at GRAD_RTOL (relative Frobenius, the aggregation
    backward's bar), and every parameter after 3 steps at TRAJ where the
    two runs' gradients agree.  An entry whose gradient differs by more
    than GRAD_RTOL of its size at some step is counted (at most 1 % of a
    leaf) and its move logged, not held: upstream a pre-activation within
    rounding of 0, summed in another order, took the other leaky_relu
    slope (the effect GRAD_RTOL's comment describes), or the entry's own
    sum cancels to rounding; Adam then moves it by up to lr whatever the
    gradient's size.  The full-graph backward sums in an order that
    varies from run to run, so one process's runs differ so as well
    (``one_again``)."""
    np.testing.assert_allclose(losses, ref["losses"], **TRAJ,
                               err_msg=f"{name}: losses")
    grad_err = [{leaf: float(np.linalg.norm(g[leaf] - want)
                             / max(np.linalg.norm(want), 1e-30))
                 for leaf, want in g_ref.items()}
                for g, g_ref in zip(grads, ref["grads"])]
    bad = [(i, leaf) for i, errs in enumerate(grad_err)
           for leaf, e in errs.items() if not e <= GRAD_RTOL]
    if bad:
        raise AssertionError(f"{name}: gradients beyond relative error "
                             f"{GRAD_RTOL} (step, leaf): {bad}")
    out = {"grad_rel_err": max(max(e.values()) for e in grad_err),
           "param_max_diff": 0.0, "param_max_diff_held": 0.0,
           "entries_gradients_differ": 0, "entries_beyond_traj": 0}
    for leaf, want in ref["leaves"].items():
        differ = np.zeros(want.shape, bool)
        for g, g_ref in zip(grads, ref["grads"]):
            differ |= (np.abs(g[leaf] - g_ref[leaf])
                       > GRAD_RTOL * np.abs(g_ref[leaf]))
        diff = np.abs(leaves[leaf] - want)
        beyond = diff > TRAJ["atol"] + TRAJ["rtol"] * np.abs(want)
        out["param_max_diff"] = max(out["param_max_diff"], float(diff.max()))
        out["param_max_diff_held"] = max(
            out["param_max_diff_held"], float(diff[~differ].max(initial=0)))
        out["entries_gradients_differ"] += int(differ.sum())
        out["entries_beyond_traj"] += int(beyond.sum())
        for idx in list(zip(*np.nonzero(beyond)))[:2]:
            log(f"{name}: {leaf}{list(map(int, idx))} moved "
                f"{float(diff[idx]):.3g}; gradients by step "
                f"{[float(g[leaf][idx]) for g in grads]} vs "
                f"{[float(g[leaf][idx]) for g in ref['grads']]}")
        if (beyond & ~differ).any() or differ.sum() > 0.01 * differ.size:
            raise AssertionError(
                f"{name}: {leaf} after 3 steps beyond TRAJ at "
                f"{int((beyond & ~differ).sum())} entries whose gradients "
                f"agree; gradients differ at {int(differ.sum())} of "
                f"{differ.size}")
    log(f"three sharded steps, {name}: losses {list(map(float, losses))} "
        f"vs {ref['losses']}; gradients' largest relative error by step "
        f"{[max(e.values()) for e in grad_err]}; {json.dumps(out)}")
    return out


def run_spread(np, ref, a: str, b: str) -> dict:
    """Run ``a`` of ``sharded_reference`` against run ``b``: parameters
    after 3 steps (largest move, entries beyond TRAJ) and the largest
    relative error of a step's gradients."""
    ra, rb = ref[a], ref[b]
    return {
        "param_max_diff": max(float(np.abs(ra["leaves"][k] - v).max())
                              for k, v in rb["leaves"].items()),
        "entries_beyond_traj": sum(int((np.abs(ra["leaves"][k] - v) > (
            TRAJ["atol"] + TRAJ["rtol"] * np.abs(v))).sum())
            for k, v in rb["leaves"].items()),
        "grad_rel_err": max(float(np.linalg.norm(ga[k] - v)
                                  / max(np.linalg.norm(v), 1e-30))
                            for ga, gb in zip(ra["grads"], rb["grads"])
                            for k, v in gb.items())}


def same_up_to_ties(np, name, w, n, w_ref, n_ref, atol=1e-6) -> dict:
    """Two rankings ([B, k] scores sorted descending, and their ids) are
    one up to ties: the scores agree within ``atol`` at every position
    (-inf where the other has -inf), and each run of tied finite scores
    (neighbors within ``atol`` in either ranking) that ends before the
    last position holds the same ids in both.  Returns the ids checked,
    and those left unchecked: a run that reaches position k - 1 (its
    members may go on past k), and the -inf fills."""
    w, w_ref = np.asarray(w, np.float64), np.asarray(w_ref, np.float64)
    np.testing.assert_allclose(w, w_ref, atol=atol, rtol=0,
                               err_msg=f"{name}: scores")
    out = {"checked": 0, "unchecked_tie_at_k": 0, "unchecked_fills": 0}
    for wi, ri, ni, mi in zip(w, w_ref, n, n_ref):
        k = int(np.isfinite(ri).sum())
        out["unchecked_fills"] += len(ri) - k
        start = 0
        for i in range(1, k + 1):
            if i < k and (abs(wi[i] - wi[i - 1]) <= atol
                          or abs(ri[i] - ri[i - 1]) <= atol):
                continue
            if i == len(wi):
                out["unchecked_tie_at_k"] += i - start
            elif sorted(ni[start:i]) != sorted(mi[start:i]):
                raise AssertionError(f"{name}: ids differ in positions "
                                     f"{start}..{i - 1}")
            else:
                out["checked"] += i - start
            start = i
    return out


def sharded_steps(tr, batches) -> tuple[list, list]:
    """One ``tr.step`` a batch, each step's global loss and gradients
    kept (the gradients on the host, by leaf name)."""
    names = [name for name, _ in tr.params.leaves()]
    losses, steps = [], []
    for bt in batches:
        loss, grads = tr.gradients(bt)
        tr.opt.step(grads)
        losses.append(float(loss))
        steps.append({n: g.cpu().numpy() for n, g in zip(names, grads)})
    return losses, steps


def run_sharded_world1(dev, st, ref) -> dict:
    """(a) A world of one on NCCL, driven as ``train --mesh-graph 1``
    drives it: the multi-device sweep (a world of one sweeps alone, K1),
    for the frontier (K3) and the full-graph (K2) forward the gradients
    of the reference's first batch and 3 steps on its batches from its
    init, then 5 more frontier steps timed (the group's first collectives
    are behind them), and the full-catalog sharded embed (K3).  Launch
    counts are read right after the path; the checks follow (the
    embeddings against ``embed_all`` of the same parameters)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from gcn_song_embeddings_tpu_torch.models.pinsage import embed_all
    from gcn_song_embeddings_tpu_torch.ops.ppr import (
        precompute_neighborhoods_multichip,
    )
    from gcn_song_embeddings_tpu_torch.parallel import multihost
    from gcn_song_embeddings_tpu_torch.parallel.mesh import make_mesh
    from gcn_song_embeddings_tpu_torch.parallel.train_step import (
        ShardedTrainer,
    )

    multihost.initialize_multihost(num_processes=1, device=dev)
    try:
        mesh = make_mesh(n_graph=1)
        backend = dist.get_backend()
        walls, runs = {}, {}
        reset_kernel_counts()
        t = time.perf_counter()
        w, n = precompute_neighborhoods_multichip(st.dg, st.cfg.walk, None,
                                                  seed=0)
        walls["multichip_sweep_s"] = time.perf_counter() - t
        for mode in ("off", "on"):
            tr = ShardedTrainer(mesh, sharded_config(mode), st.graph.n_items,
                                st.graph.features, (st.nb_w, st.nb_n),
                                st.train_pos, params=ref["init"])
            sync(torch, dev)
            t = time.perf_counter()
            losses, grads = sharded_steps(tr, ref["batches"])
            sync(torch, dev)
            walls[f"train_step_ms_{mode}_first3"] = (
                (time.perf_counter() - t) * 1e3 / SHARDED_STEPS)
            runs[mode] = (losses, grads, leaves_np(tr.params), tr)
        tr = runs["off"][3]
        t = time.perf_counter()
        tr.train_chunk(5, batches=ref["batches"][:1] * 5)
        sync(torch, dev)
        walls["train_step_ms_off"] = (time.perf_counter() - t) * 1e3 / 5
        t = time.perf_counter()
        emb = tr.embed()
        sync(torch, dev)
        walls["embed_s"] = time.perf_counter() - t
        counts = kernel_counts()
    finally:
        multihost.shutdown()
    checks = {"backend": backend,
              "sweep_bit_equal": bool(np.array_equal(w, st.nb_w)
                                      and np.array_equal(n, st.nb_n))}
    for mode in ("off", "on"):
        checks[f"train_{mode}"] = hold_sharded_run(
            np, f"world 1, fullgraph {mode}", *runs[mode][:3],
            ref[mode]["one"])
        checks[f"train_{mode}"]["one_process_twice"] = run_spread(
            np, ref[mode], "one_again", "one")
    mcfg = st.cfg.model
    want = embed_all(tr.params, st.feats, st.nbw_d, st.nbn_d,
                     st.graph.n_items, mcfg.n_layers, mcfg.T).cpu().numpy()
    checks["embed_max_diff"] = float(np.abs(emb - want).max())
    if not checks["sweep_bit_equal"]:
        raise AssertionError("world of 1: multi-device sweep differs")
    if not checks["embed_max_diff"] <= 2e-4:
        raise AssertionError(f"world of 1: embeddings {checks}")
    return {"checks": checks, "walls": walls, "counts": counts}


def _stop(proc, grace: float = 30.0) -> None:
    """End ``proc``: SIGTERM, on which torchrun takes down its ranks
    (each in a session of its own, out of reach of a signal to its
    group), then SIGKILL past ``grace`` to it and its children."""
    import signal

    if proc.poll() is None:
        ranks = []
        for entry in filter(str.isdigit, os.listdir("/proc")):
            try:
                with open(f"/proc/{entry}/stat") as f:
                    if int(f.read().rsplit(")", 1)[1].split()[1]) == proc.pid:
                        ranks.append(int(entry))
            except OSError:
                continue
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


def run_sharded_cli(dev, st, work: str) -> dict:
    """(c) The sharded verbs as a user runs them, each a world of one on
    NCCL: ``cli train --mesh-graph 1`` on the main dataset (its cached
    sweep, 3 steps at full width, the catalog's sharded embed; launches
    read right after), its ``state.npz`` embedded by the single-process
    ``cli embed``; then ``serve --sharded`` (f32, ``--int8``, ``--hybrid
    --cached-head``) on its ``emb.npy``, each in a process of its own,
    all three started together, one batched request each held against
    the single-process index that ``serve`` builds for the same flags."""
    import socket

    import numpy as np
    import torch

    from gcn_song_embeddings_tpu_torch import cli
    from gcn_song_embeddings_tpu_torch import serve as serve_mod

    _, cfg_path = train_config(work)
    runs = os.path.join(work, "runs_sharded")
    walls = {}
    reset_kernel_counts()
    t = time.perf_counter()
    cli.main(["train", "--dataset", st.ds, "--run-dir", runs,
              "--run-name", "mesh1", "--config", cfg_path, "--mesh-graph",
              "1", "--set", "train.epochs=1", "--set",
              f"train.batches_per_epoch={SHARDED_STEPS}", "--device",
              str(dev)])
    sync(torch, dev)
    walls["cli_train_s"] = time.perf_counter() - t
    counts = kernel_counts()
    run = os.path.join(runs, "mesh1")
    emb_path = os.path.join(run, "emb.npy")
    emb = np.load(emb_path)
    out = os.path.join(work, "emb_mesh1_embed.npy")
    cli.main(["embed", "--dataset", st.ds, "--out", out, "--checkpoint",
              os.path.join(run, "state.npz"), "--device", str(dev)])
    checks = {"cli_train_embed_max_diff": float(np.abs(
        np.load(out) - emb).max())}
    with np.load(os.path.join(run, "state.npz")) as z:
        checks["cli_train_adam_count"] = int(z["adam.count"])
    if not (checks["cli_train_embed_max_diff"] <= 2e-4
            and checks["cli_train_adam_count"] == SHARDED_STEPS
            and emb.shape == (st.graph.n_items, st.cfg.model.out_dim)):
        raise AssertionError(f"cli train --mesh-graph 1: {checks}, "
                             f"emb {emb.shape}")

    rows = [int(r) for r in st.rows][:4]
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([REPO,
                                          os.environ.get("PYTHONPATH", "")])}
    procs, answers = {}, {}
    try:
        for kind, flags in SHARDED_SERVES.items():
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            logf = open(os.path.join(work, f"serve_sharded_{kind}.log"), "w")
            procs[kind] = (port, logf, subprocess.Popen(
                [sys.executable, "-m", "gcn_song_embeddings_tpu_torch.serve",
                 "--sharded", "--emb", emb_path, "--dataset", st.ds,
                 "--port", str(port), "--device", str(dev), *flags],
                stdout=logf, stderr=subprocess.STDOUT, env=env, cwd=REPO))
        t = time.perf_counter()
        deadline = time.monotonic() + SERVE_START_S
        for kind, (port, logf, proc) in procs.items():
            base = f"http://127.0.0.1:{port}"
            while kind not in answers:
                if proc.poll() is not None or time.monotonic() > deadline:
                    logf.flush()
                    with open(logf.name) as f:
                        raise AssertionError(
                            f"serve --sharded {kind} ended {proc.poll()}:\n"
                            f"{f.read()[-6000:]}")
                try:
                    get_json(f"{base}/healthz")
                except (urllib.error.URLError, ConnectionError):
                    time.sleep(0.5)
                    continue
                walls[f"serve_{kind}_up_s"] = time.perf_counter() - t
                url = (f"{base}/knn?indices={','.join(map(str, rows))}"
                       f"&k={QUERY_K}")
                get_json(url)                       # the batcher's first
                t1 = time.perf_counter()
                code, body = get_json(url)
                walls[f"serve_{kind}_request_ms"] = (
                    (time.perf_counter() - t1) * 1e3)
                answers[kind] = (code, body["neighbors"])
    finally:
        for _, logf, proc in procs.values():
            _stop(proc)
            logf.close()
    for kind, (code, got) in answers.items():
        if kind == "hybrid":
            ix = serve_mod.HybridIndex(emb, nbhds=(st.nb_w, st.nb_n),
                                       device=dev)
        else:
            ix = serve_mod.EmbeddingIndex(emb, quantized=kind == "int8",
                                          device=dev)
        want = ix.knn_rows(np.asarray(rows), QUERY_K)
        if code != 200 or [len(r) for r in got] != [len(r) for r in want]:
            raise AssertionError(f"serve --sharded {kind}: {code}, "
                                 f"{[len(r) for r in got]}")
        w, n, w_ref, n_ref = ([[o[f] for o in r] for r in rs]
                              for rs, f in ((got, "score"), (got, "index"),
                                            (want, "score"),
                                            (want, "index")))
        checks[f"serve_{kind}"] = same_up_to_ties(
            np, f"serve --sharded {kind}", w, n, w_ref, n_ref, atol=2e-6)
    log(f"sharded verbs, a world of one: {json.dumps(checks)}; walls "
        f"{json.dumps(walls)}")
    return {"checks": checks, "walls": walls, "counts": counts}


def run_sharded_world2(work: str, st) -> list:
    """(b) Two ranks of ``chip_smoke.py --sharded-rank DIR`` under
    ``torchrun`` on the one card, over gloo; returns each rank's report.
    torchrun takes both down when one fails; past ``SHARDED_TIMEOUT_S``
    ``_stop`` ends torchrun and both ranks."""
    d = os.path.join(work, "sharded")
    with open(os.path.join(d, "problem.json"), "w") as f:
        json.dump({"dataset": st.ds, "nbhds": st.nb_path,
                   "device": "cuda:0" if st.feats.is_cuda else "cpu"}, f)
    path = os.path.join(d, "ranks.log")
    with open(path, "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", os.path.abspath(__file__),
             "--sharded-rank", d], stdout=logf, stderr=subprocess.STDOUT,
            env={**os.environ, "OMP_NUM_THREADS": "1"}, cwd=REPO)
        try:
            proc.wait(timeout=SHARDED_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            pass
        finally:
            _stop(proc)
    with open(path) as f:
        text = f.read()
    for line in text.splitlines()[-24:]:
        log(f"  [ranks] {line}")
    if proc.returncode != 0:
        raise AssertionError(f"the two-rank world exited {proc.returncode}:"
                             f"\n{text[-6000:]}")
    out = []
    for r in range(2):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def sharded_rank_main(d: str) -> int:
    """One rank (torchrun's ``RANK``) of the two-rank gloo world on the
    card: drives the sharded path (gathers, multi-device and partitioned
    sweeps, 3 frontier and 3 full-graph steps, the probe's embed, f32 /
    int8 / hybrid sharded kNN, one HTTP request through rank 0), reads
    its launch counts, then checks what it can alone (gathers and the
    sweeps, bit for bit) and leaves the rest to the parent: rank 0 writes
    each run's parameters with ``save_state``, and its arrays."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from gcn_song_embeddings_tpu_torch.config import RunConfig
    from gcn_song_embeddings_tpu_torch.data.device import (
        DeviceGraph,
        apply_colisten_config,
    )
    from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
    from gcn_song_embeddings_tpu_torch.models.pinsage import pack_nbhds_np
    from gcn_song_embeddings_tpu_torch.ops.ppr import (
        precompute_neighborhoods_multichip,
        seeded_generator,
        visit_counts_topt,
    )
    from gcn_song_embeddings_tpu_torch.ops.walk_kernel import restart_walks
    from gcn_song_embeddings_tpu_torch.ops.walks import (
        draw_uniforms,
        fused_walk_tables,
    )
    from gcn_song_embeddings_tpu_torch.parallel import multihost
    from gcn_song_embeddings_tpu_torch.parallel.gather import (
        sharded_table_gather,
        sharded_table_gather_ring,
    )
    from gcn_song_embeddings_tpu_torch.parallel.mesh import make_mesh
    from gcn_song_embeddings_tpu_torch.parallel.serve_sharded import (
        ShardedServeIndex,
        ShardedServingFrontend,
    )
    from gcn_song_embeddings_tpu_torch.parallel.train_step import (
        ShardedTrainer,
    )
    from gcn_song_embeddings_tpu_torch.parallel.walks_sharded import (
        precompute_neighborhoods_partitioned,
    )
    from gcn_song_embeddings_tpu_torch import scaling_bench
    from gcn_song_embeddings_tpu_torch import serve as serve_mod
    from gcn_song_embeddings_tpu_torch.utils.checkpoint import (
        load_jax_checkpoint,
        save_state,
    )

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(d, "problem.json")) as f:
        problem = json.load(f)
    dev = torch.device(problem["device"])
    rank = multihost.initialize_multihost(device=dev, backend="gloo",
                                          timeout_s=300)
    try:
        backend = dist.get_backend()
        cfg = RunConfig.recommended()
        ds = problem["dataset"]
        graph = SongGraph(ds, features_file=os.path.join(ds, "features.npy"))
        train_pos, _ = graph.load_positives_split(
            os.path.join(ds, "positives.json"))
        dg, _ = apply_colisten_config(DeviceGraph.from_graph(graph, dev),
                                      train_pos, cfg.walk, None)
        with np.load(problem["nbhds"]) as z:
            nb_w, nb_n = z["weights"], z["nodes"]
        batches = np.load(os.path.join(d, "batches.npy"))
        init = load_jax_checkpoint(os.path.join(d, "init.npz"), dev)
        mesh = make_mesh(n_graph=2)
        n_items, b = graph.n_items, batches.shape[1] // 2
        feats = torch.as_tensor(graph.features, device=dev)
        packed = torch.as_tensor(pack_nbhds_np(nb_w, nb_n, cfg.model.T),
                                 device=dev)
        walls, got = {}, {}

        def timed(name, fn):
            sync(torch, dev)
            t = time.perf_counter()
            out = fn()
            sync(torch, dev)
            walls[name] = time.perf_counter() - t
            return out

        reset_kernel_counts()
        # -- the path -----------------------------------------------------
        rows_local = n_items // 2
        ids = torch.as_tensor(np.random.default_rng(rank).integers(
            0, n_items, 8192), dtype=torch.int32, device=dev)
        for name, table in (("features", feats), ("packed", packed)):
            local = table[rank * rows_local:(rank + 1) * rows_local]
            got[name] = [fn(local, ids, mesh.graph_group) for fn in (
                sharded_table_gather, sharded_table_gather_ring)]
        mc_w, mc_n = timed("multichip_sweep_s", lambda: (
            precompute_neighborhoods_multichip(dg, cfg.walk, None, seed=0)))
        pcfg = dataclasses.replace(cfg.walk, batch_walkers=PART_WALKERS)
        pw, pn = timed("partitioned_sweep_s", lambda: (
            precompute_neighborhoods_partitioned(dg, pcfg, mesh, None,
                                                 seed=0)))
        runs = {}
        for mode in ("off", "on"):
            tr = ShardedTrainer(mesh, sharded_config(mode), n_items,
                                graph.features, (nb_w, nb_n), train_pos,
                                params=init)
            mine = [torch.as_tensor(bt[rank * b:(rank + 1) * b],
                                    device=dev) for bt in batches]
            losses, grads = timed(f"train_{mode}_s",
                                  lambda: sharded_steps(tr, mine))
            walls[f"train_step_ms_{mode}"] = (
                walls.pop(f"train_{mode}_s") * 1e3 / SHARDED_STEPS)
            runs[mode] = (tr, losses, grads)
        probe = np.arange(0, n_items, max(1, n_items // SHARDED_PROBE))[
            :SHARDED_PROBE]
        emb = timed("embed_s", lambda: runs["off"][0].embed(ids=probe))
        served = sharded_serving_table(n_items)
        qrows = np.arange(0, n_items, max(1, n_items // SHARDED_ROWS))[
            :SHARDED_ROWS]
        knn = {}
        for kind, quantized in (("f32", False), ("int8", True),
                                ("hybrid", False)):
            idx = timed(f"index_{kind}_s", lambda: ShardedServeIndex(
                served, mesh, nbhds=(nb_w, nb_n) if kind == "hybrid"
                else None, quantized=quantized))
            fn = idx.hybrid_knn_rows if kind == "hybrid" else idx.knn_rows
            knn[kind] = timed(f"knn_{kind}_batch{SHARDED_ROWS}_s",
                              lambda: fn(qrows, 100))
        http = None
        if rank == 0:
            front = ShardedServingFrontend(idx, track_ids=graph.track_ids,
                                           tracks_meta=graph.tracks)
            server = serve_mod.serve(front, host="127.0.0.1", port=0)
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            try:
                url = (f"http://127.0.0.1:{server.server_address[1]}"
                       f"/knn?index={int(qrows[5])}&k={QUERY_K}")
                get_json(url)                       # the batcher's first
                t = time.perf_counter()
                code, res = get_json(url)
                walls["request_ms"] = (time.perf_counter() - t) * 1e3
                http = {"code": code, "ids": [o["index"]
                                              for o in res["neighbors"]]}
            finally:
                server.shutdown()
                server.server_close()
                front.close()
                thread.join(timeout=30)
        else:
            idx.follow()
        counts = kernel_counts()
        # -- checks this rank can make alone (launches no longer count) --
        checks = {"backend": backend}
        for name, table in (("features", feats), ("packed", packed)):
            want = table[ids.long()]
            checks[f"gather_{name}_bit_equal"] = all(
                bool(torch.equal(g, want)) for g in got[name])
        checks["multichip_sweep_bit_equal"] = bool(
            np.array_equal(mc_w, nb_w) and np.array_equal(mc_n, nb_n))
        tables = fused_walk_tables(dg)
        chains = 1
        per = PART_WALKERS // 2
        ok = True
        for start in range(0, n_items, PART_WALKERS):
            first = start + rank * per
            nodes = torch.arange(first, first + per, dtype=torch.int32,
                                 device=dev) % n_items
            u = draw_uniforms(pcfg.n_hops // chains, per,
                              seeded_generator([0, start, rank], dev))
            w1, n1 = visit_counts_topt(restart_walks(
                tables, nodes, pcfg.n_hops, pcfg.alpha, u), nodes,
                pcfg.t_precompute)
            keep = max(0, min(per, n_items - first))
            ok &= (np.array_equal(n1[:keep].cpu().numpy(),
                                  pn[first:first + keep])
                   and np.array_equal(w1[:keep].cpu().numpy(),
                                      pw[first:first + keep]))
        checks["partitioned_topt_bit_equal"] = bool(ok)
        if http is not None:
            checks["http_code"] = http["code"]
            w5, n5 = knn["hybrid"][0][5], knn["hybrid"][1][5]
            checks["http_equals_collective"] = http["ids"] == [
                int(x) for x, s in zip(n5, w5) if np.isfinite(s)][:QUERY_K]
        # -- scaling_bench's mesh sizes 1 and 2 in this world, counted
        #    apart (rank 1 idles through size 1)
        reset_kernel_counts()
        t = time.perf_counter()
        scaling = scaling_bench.run(scaling_bench.parse_args(
            ["--steps", str(SCALING_STEPS)]), log=lambda *a: None)
        walls["scaling_bench_s"] = time.perf_counter() - t
        report = {"rank": rank, "checks": checks, "walls": walls,
                  "counts": counts, "scaling": scaling,
                  "scaling_counts": kernel_counts()}
        if rank == 0:
            arrays = {"emb": emb, "probe": probe, "qrows": qrows}
            for mode, (tr, losses, grads) in runs.items():
                save_state(os.path.join(d, f"{mode}_state.npz"), tr.params,
                           tr.opt, {})
                arrays[f"{mode}/losses"] = losses
                for i, step in enumerate(grads):
                    for name, g in step.items():
                        arrays[f"{mode}/grad{i}/{name}"] = g
            for kind, (w, n) in knn.items():
                arrays[f"knn/{kind}/w"], arrays[f"knn/{kind}/n"] = w, n
            np.savez(os.path.join(d, "rank0.npz"), **arrays)
    finally:
        multihost.shutdown()
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    return 0


def check_sharded_world2(dev, st, ref, reports, work: str) -> dict:
    """(b)'s checks against one process on the card: every rank's own
    checks held, both 3-step runs against one process's ``halves`` run
    (``hold_sharded_run``), the probe's embeddings within 2e-4 of
    ``embed_all`` of rank 0's parameters, f32 / int8 / hybrid kNN equal
    to the single-process indexes up to ties, the HTTP answer equal to
    the collective's."""
    import numpy as np

    from gcn_song_embeddings_tpu_torch import serve as serve_mod
    from gcn_song_embeddings_tpu_torch.models.pinsage import embed_all
    from gcn_song_embeddings_tpu_torch.utils.checkpoint import (
        load_jax_checkpoint,
    )

    d = os.path.join(work, "sharded")
    checks = {f"rank{r['rank']}": r["checks"] for r in reports}
    for r in reports:
        bad = [k for k, v in r["checks"].items() if v is False]
        if bad:
            raise AssertionError(f"rank {r['rank']} failed {bad}")
    if reports[0]["checks"].get("http_code") != 200:
        raise AssertionError(f"HTTP through rank 0: {reports[0]['checks']}")
    with np.load(os.path.join(d, "rank0.npz")) as z:
        arr = {k: z[k] for k in z.files}
    params = {}
    for mode in ("off", "on"):
        params[mode] = load_jax_checkpoint(
            os.path.join(d, f"{mode}_state.npz"), dev)
        grads = [{k[len(f"{mode}/grad{i}/"):]: v for k, v in arr.items()
                  if k.startswith(f"{mode}/grad{i}/")}
                 for i in range(SHARDED_STEPS)]
        leaves = leaves_np(params[mode])
        checks[f"train_{mode}"] = hold_sharded_run(
            np, f"world 2, fullgraph {mode}", arr[f"{mode}/losses"], grads,
            leaves, ref[mode]["halves"])
        checks[f"train_{mode}"]["param_max_diff_whole_batches"] = max(
            float(np.abs(leaves[k] - v).max())
            for k, v in ref[mode]["one"]["leaves"].items())
        checks[f"train_{mode}"]["halves_vs_whole_batches"] = run_spread(
            np, ref[mode], "halves", "one")
    # the rank's embeddings against embed_all of the same parameters
    mcfg = st.cfg.model
    want = embed_all(params["off"], st.feats, st.nbw_d, st.nbn_d,
                     st.graph.n_items, mcfg.n_layers, mcfg.T).cpu().numpy()
    err = float(np.abs(arr["emb"] - want[arr["probe"]]).max())
    checks["embed_max_diff"] = err
    if not err <= 2e-4:
        raise AssertionError(f"world 2: embeddings differ by {err}")
    qrows = arr["qrows"]
    ties = {}
    for kind in ("f32", "int8", "hybrid"):
        table = sharded_serving_table(st.graph.n_items)
        if kind == "hybrid":
            ix = serve_mod.HybridIndex(table, nbhds=(st.nb_w, st.nb_n),
                                       device=dev)
        else:
            ix = serve_mod.EmbeddingIndex(table, quantized=kind == "int8",
                                          device=dev)
        out = ix.knn_rows(qrows, 100)
        w_ref = np.array([[o["score"] for o in r] for r in out])
        n_ref = np.array([[o["index"] for o in r] for r in out])
        w, n = arr[f"knn/{kind}/w"], arr[f"knn/{kind}/n"]
        ties[kind] = same_up_to_ties(np, f"sharded {kind} kNN", w, n, w_ref,
                                     n_ref, atol=2e-6)
    checks["knn_ids"] = ties
    return checks


def check_scaling(reports) -> dict:
    """``scaling_bench`` in the two-rank world: rank 0 has sizes 1 (mesh
    1 x 1) and 2 (1 x 2) with the JAX script's keys, finite positive
    edges/s and efficiency against size 1; rank 1 took part in size 2
    only; both ranks launched K3 and its backward.  The efficiency of
    two gloo ranks sharing one card measures gloo through the host, not
    scaling."""
    import math

    out = reports[0]["scaling"]
    keys = {"mesh", "step_ms", "edges_per_s", "scaling_efficiency"}
    if sorted(k for k in out if k.isdigit()) != ["1", "2"] or [
            out[k]["mesh"] for k in ("1", "2")] != [
            {"dp": 1, "graph": 1}, {"dp": 1, "graph": 2}]:
        raise AssertionError(f"scaling_bench sizes: {out}")
    for k in ("1", "2"):
        e = out[k].get("edges_per_s")
        if set(out[k]) != keys or not (math.isfinite(e) and e > 0):
            raise AssertionError(f"scaling_bench size {k}: {out[k]}")
    if [k for k in reports[1]["scaling"] if k.isdigit()] != ["2"]:
        raise AssertionError(f"rank 1's sizes: {reports[1]['scaling']}")
    for r in reports:
        c = r["scaling_counts"]
        if not (c["dma_agg"] and c["agg_backward_dma"]):
            raise AssertionError(f"scaling_bench, rank {r['rank']}: K3 or "
                                 f"its backward never launched: {c}")
    log(f"scaling_bench (two gloo ranks on one card, not a scaling "
        f"result): {json.dumps(out)}")
    return {**out, "note": "two gloo ranks sharing one card: the "
            "efficiency measures gloo through the host, not scaling"}


def run_sharded_path(dev, st, work: str) -> dict:
    """The sharded phase: the single-process reference, (a) a world of
    one on NCCL in this process, (c) the sharded CLI verbs as worlds of
    one, (b) two ranks on gloo over the card under torchrun."""
    ref = sharded_reference(dev, st, work)
    one = run_sharded_world1(dev, st, ref)
    need = ("walk", "dma_agg", "agg", "agg_backward_dma",
            "agg_backward_stream")
    missing = [k for k in need if one["counts"][k] == 0]
    if missing:
        raise AssertionError(f"world of 1: kernels never launched {missing}")
    import torch

    verbs = run_sharded_cli(dev, st, work)
    missing = [k for k in ("dma_agg", "agg_backward_dma")
               if verbs["counts"][k] == 0]
    if missing:
        raise AssertionError(f"cli train --mesh-graph 1: kernels never "
                             f"launched {missing}")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    reports = run_sharded_world2(work, st)
    two_s = time.perf_counter() - t
    for r in reports:
        missing = [k for k in need if r["counts"][k] == 0]
        if missing:
            raise AssertionError(f"world of 2, rank {r['rank']}: kernels "
                                 f"never launched {missing}")
    two = check_sharded_world2(dev, st, ref, reports, work)
    two["scaling_bench"] = check_scaling(reports)
    out = {
        "checks": {"nccl_world1": one["checks"],
                   "nccl_cli_world1": verbs["checks"], "gloo_world2": two},
        "walls": {"nccl_world1": one["walls"],
                  "nccl_cli_world1": verbs["walls"],
                  "gloo_world2": {"total_s": two_s,
                                  **{f"rank{r['rank']}": r["walls"]
                                     for r in reports}}},
        "backends": {"nccl_world1": one["checks"]["backend"],
                     "nccl_cli_world1": "nccl",
                     "gloo_world2": reports[0]["checks"]["backend"],
                     "gloo_transport": "host-staged CUDA tensors"},
        "counts": {"nccl_world1": one["counts"],
                   "nccl_cli_world1": verbs["counts"],
                   **{f"gloo_rank{r['rank']}": r["counts"]
                      for r in reports}},
        "scaling_counts": {k: sum(r["scaling_counts"][k] for r in reports)
                           for k in reports[0]["scaling_counts"]},
        "unverified": "NCCL across two or more cards",
    }
    return out


def run_hard_path(dev, work: str, argv=()) -> dict:
    """The hard benchmark on ``dev``: ``hard_bench.run`` at its defaults
    (20,000 tracks, seed 0, margin 0.1, 10 x 500; ``argv`` adds flags),
    then ``serve_int8_quality``'s two rows: f32 and int8 metrics of that
    model and of a margin-1e-5 model trained on the same dataset and
    cache for as many epochs, and ``rank_eval`` and ``int8_rank_eval`` of
    the first model on the card and the CPU."""
    import numpy as np

    from gcn_song_embeddings_tpu_torch import hard_bench
    from gcn_song_embeddings_tpu_torch import serve_int8_quality as iq
    from gcn_song_embeddings_tpu_torch.evals.device_eval import rank_eval

    hard = os.path.join(work, "hard")
    shutil.rmtree(hard, ignore_errors=True)
    args = hard_bench.parse_args(["--work-dir", hard, "--device", str(dev),
                                  *argv])
    hb = hard_bench.run(args, log)
    log(json.dumps({"hard_bench": hb.summary}))
    walls = {f"{k}_s": v for k, v in hb.times.items()}
    # The margin-0.1 row is hard_bench's model: JAX's serve_int8_quality
    # trains that row with the same config (RunConfig() with 10 epochs of
    # 500 batches, margin 0.1, lr 1e-3, walk.batch_walkers 8192, seed 0)
    # on the same dataset (the hard generator at these defaults, seed 0)
    # and split, so training it again would repeat this run.
    t = time.perf_counter()
    rows = {"margin_0.1": iq.quality_row(hb.emb, hb.test_pos, dev)}
    walls["int8_quality_margin_0.1_s"] = time.perf_counter() - t
    t = time.perf_counter()
    cfg = iq.margin_config("margin_1e-5", 1e-5, 1e-3, args.epochs,
                           args.batches_per_epoch)
    emb_1e5 = iq.train_embed(hb.dg, hb.graph, hb.train_pos, cfg, hard,
                             hb.ds_path, verbose=False)
    walls["train_embed_margin_1e-5_s"] = time.perf_counter() - t
    t = time.perf_counter()
    rows["margin_1e-5"] = iq.quality_row(emb_1e5, hb.test_pos, dev)
    walls["int8_quality_margin_1e-5_s"] = time.perf_counter() - t
    t = time.perf_counter()
    cpu = rank_eval(hb.emb, hb.test_pos, hit_ks=(10, 100, 500), mrr_k=1000,
                    batch=4096, device="cpu")
    walls["rank_eval_cpu_s"] = time.perf_counter() - t
    int8 = {"card": iq.int8_rank_eval(hb.emb, hb.test_pos, device=dev),
            "cpu": iq.int8_rank_eval(hb.emb, hb.test_pos, device="cpu")}
    shape = (hb.graph.n_items, cfg.model.out_dim)
    for name, emb in (("margin_0.1", hb.emb), ("margin_1e-5", emb_1e5)):
        if emb.shape != shape or not np.isfinite(emb).all():
            raise AssertionError(f"hard {name} embeddings: shape "
                                 f"{emb.shape}, finite "
                                 f"{np.isfinite(emb).all()}")
    return {"summary": hb.summary, "metrics": hb.metrics, "rows": rows,
            "rank_eval_cpu": cpu, "int8_rank_eval": int8, "walls": walls,
            "bench": hb, "emb_1e5": emb_1e5, "cfg_1e5": cfg,
            "config": {"tracks": hb.graph.n_items,
                       "test_pairs": int(len(hb.test_pos)),
                       "epochs": args.epochs,
                       "batches_per_epoch": args.batches_per_epoch}}


def hold_hard_kernels(torch, hb) -> dict:
    """The hard path's kernels against their plain versions at the shapes
    it gave them (``measure_k1`` and ``measure_aggregation`` raise on a
    difference): K1 at the first sweep block (``walk.batch_walkers``
    origins, the sweep's uniforms), K3 and its backward at both
    aggregations of one frontier step of the trained margin-0.1 model
    (Din 128 and 512, T = ``model.T``), K2 at both ``embed_all`` layers
    of every track; and that model's embeddings of a node subset (K2 on
    the card) against the CPU's plain frontier forward within K2_ATOL.
    Returns the ``hard_checks`` line's payload for them."""
    import copy

    import numpy as np

    from gcn_song_embeddings_tpu_torch.models.pinsage import (
        conv_from_table,
        pinsage_forward,
    )
    from gcn_song_embeddings_tpu_torch.ops import agg, walk_kernel
    from gcn_song_embeddings_tpu_torch.ops.ppr import block_generator
    from gcn_song_embeddings_tpu_torch.ops.walks import (
        draw_uniforms,
        fused_walk_tables,
    )

    trainer = hb.trainer
    dev, cfg, mcfg = trainer.device, trainer.cfg, trainer.cfg.model
    tables, layers = trainer.tables, trainer.params.layers
    b, hops, alpha = (min(cfg.walk.batch_walkers, trainer.n),
                      cfg.walk.n_hops, cfg.walk.alpha)
    k1 = measure_k1(torch, walk_kernel, fused_walk_tables(hb.dg), [(
        f"hard sweep block B={b} H={hops} alpha={alpha}",
        torch.arange(b, dtype=torch.int32, device=dev), alpha,
        draw_uniforms(hops, b, block_generator(cfg.train.seed, 0, dev)))],
        {})
    step_shapes = step_conv_inputs(torch, trainer, trainer.sample(
        block_generator(4242, 0, dev)))
    k3 = measure_aggregation(torch, agg, "dma", step_shapes)
    nb_idx = tables.nbhd_n[:, :mcfg.T].to(torch.int32).contiguous()
    nb_wt = tables.nbhd_w[:, :mcfg.T].contiguous()
    with torch.inference_mode():
        h1 = conv_from_table(layers[0], tables.features, tables.features,
                             nb_idx, nb_wt)
    k2 = measure_aggregation(torch, agg, "stream", [
        (layers[0], tables.features, nb_idx, nb_wt, False),
        (layers[1], h1, nb_idx, nb_wt, True)], with_backward=False)
    probe = np.arange(0, trainer.n, 157)
    with torch.inference_mode():
        want = pinsage_forward(
            copy.deepcopy(trainer.params).cpu(), tables.features.cpu(),
            tables.nbhd_w.cpu(), tables.nbhd_n.cpu(),
            torch.as_tensor(probe, dtype=torch.int32), mcfg.n_layers,
            mcfg.T).numpy()
    embed_err = float(np.abs(hb.emb[probe] - want).max())
    log(f"hard embed_all (K2) of {len(probe)} rows vs the CPU's plain "
        f"frontier forward: max |diff| {embed_err:.3g}")
    if not embed_err <= K2_ATOL:
        raise AssertionError(f"hard embeddings differ from the CPU's by "
                             f"{embed_err} > {K2_ATOL}")
    return {
        "K1": {key: k1[key] for key in ("shape", "max_abs_err", "ms",
                                        "plain_ms", "bound_ms")},
        "K3": {"shape": (f"frontier step, {step_shapes[0][2].shape[0]} and "
                         f"{step_shapes[1][2].shape[0]} nodes x T={mcfg.T}, "
                         f"Din {step_shapes[0][1].shape[1]} and "
                         f"{step_shapes[1][1].shape[1]}"),
               "max_abs_err": k3["err"], "bwd_rel_err": k3["bwd_err"],
               **{key: k3[key] for key in ("ms", "plain_ms", "bwd_ms",
                                           "bwd_plain_ms")}},
        "K2": {"shape": (f"embed_all, {trainer.n} nodes x T={mcfg.T}, Din "
                         f"{tables.features.shape[1]} and {h1.shape[1]}"),
               "max_abs_err": k2["err"],
               **{key: k2[key] for key in ("ms", "plain_ms", "parts")}},
        "embed_card_vs_cpu_max_abs": embed_err, "atol": K2_ATOL,
        "grad_rtol": GRAD_RTOL,
    }


def check_hard(hp) -> dict:
    """The hard path's bars: PinSage / features at least HARD_BAR on
    hit@100 and mrr@1000, the margin-0.1 int8 drops within
    HARD_INT8_DROP, ``rank_eval`` and ``int8_rank_eval`` of the margin-0.1
    model card vs CPU within RANK_EVAL_ATOL.
    Returns the ``hard_checks`` line's payload."""
    feat, ps = hp["metrics"]["features"], hp["metrics"]["pinsage"]
    ratios = {"hit@100": ps["hit@100"] / feat["hit@100"],
              "mrr@1000": ps["mrr@1000"] / feat["mrr@1000"]}
    low = {k: v for k, v in ratios.items() if not v >= HARD_BAR}
    if low:
        raise AssertionError(f"PinSage / features below {HARD_BAR} on the "
                             f"hard benchmark: {low} (features {feat}, "
                             f"PinSage {ps})")
    row = hp["rows"]["margin_0.1"]
    over = {k: row[k] for k, bar in HARD_INT8_DROP.items()
            if not row[k] <= bar}
    if over:
        raise AssertionError(f"int8 drops of the margin-0.1 model over "
                             f"{HARD_INT8_DROP}: {over} ({row})")
    card_cpu = max(abs(ps[k] - hp["rank_eval_cpu"][k]) for k in ps)
    i8 = hp["int8_rank_eval"]
    card_cpu8 = max(abs(i8["card"][k] - i8["cpu"][k]) for k in i8["card"])
    if not max(card_cpu, card_cpu8) <= RANK_EVAL_ATOL:
        raise AssertionError(f"rank_eval on the card {ps} vs the CPU "
                             f"{hp['rank_eval_cpu']}: {card_cpu}; int8 "
                             f"{i8}: {card_cpu8}")
    jax_row = JAX_HARD["serve_int8_margin_0.1_f32"]
    return {"config": hp["config"], "features": feat, "pinsage": ps,
            "pinsage_over_features": ratios, "bar": HARD_BAR,
            "jax_serve_int8_row_over_features": {
                k: v / feat[k] for k, v in jax_row.items()},
            "int8_rows": hp["rows"], "int8_drop_bars": HARD_INT8_DROP,
            "rank_eval_card_vs_cpu_max_abs": card_cpu,
            "int8_rank_eval_card_vs_cpu_max_abs": card_cpu8,
            "jax_reference": JAX_HARD, "walls": hp["walls"]}


# ---- the co-listen A/B and the full roster (colisten_ab, hard_roster) ----
# on the hard phase's dataset, PPR cache and both models.  Cuts for the
# script's time limit, each run uncut as a command of its own (README): the
# A/B runs AB_RUN_ARMS, plain10 (the hard phase's margin-1e-5 model, the
# arm's config) and co1_T10 at AB_EPOCHS of its 30 epochs; co1_T20 and
# co1_T10_d512 take NEW_SHAPE_STEPS steps of their configs; the roster's
# eval scores pinsage_hard (the hard phase's margin-0.1 model, that run's
# config) and pinsage_hard_co (the cut co1_T10, that run's config) at
# ROSTER_K, with Node2Vec at NODE2VEC_EPOCHS and the GNN rows at
# ROSTER_GNN_STEPS (AB_EPOCHS 10, K 1000 and 1,500 GNN steps until PR 23)
AB_RUN_ARMS = ("cf_als", "cf_bpr", "ppr_plain", "ppr_co1")
AB_EPOCHS = 4
NEW_SHAPE_ARMS = ("co1_T20", "co1_T10_d512")
NEW_SHAPE_STEPS = 3
ROSTER_CO = "pinsage_hard_co"
# the A/B's bars (JAX's rows clear each with a wide margin): co1_T10 over
# plain10 on hit@100 (JAX 0.618 at 30 epochs / 0.280), ppr_co1 over
# ppr_plain on hit@10 (0.381 / 0.118), co1_T10 over ppr_co1 and cf_als on
# hit@500 (0.858 / 0.688, 0.549)
AB_BARS = (("co1_T10", "plain10", "hit@100", 1.5),
           ("ppr_co1", "ppr_plain", "hit@10", 2.0),
           ("co1_T10", "ppr_co1", "hit@500", 1.0),
           ("co1_T10", "cf_als", "hit@500", 1.0))
# the JAX package's rows (results/colisten_ab.jsonl, 30 x 500 unless the arm
# names another schedule), for reference only
JAX_AB = {
    "cf_als": {"hit@10": 0.19032, "hit@100": 0.47646, "hit@500": 0.54866,
               "mrr@1000": 0.07413},
    "cf_bpr": {"hit@10": 0.26198, "hit@100": 0.445, "hit@500": 0.50517,
               "mrr@1000": 0.09558},
    "ppr_plain": {"hit@10": 0.11801, "hit@100": 0.41109, "hit@500": 0.50188,
                  "mrr@1000": 0.06111},
    "ppr_co1": {"hit@10": 0.38106, "hit@100": 0.662, "hit@500": 0.6879,
                "mrr@1000": 0.19407},
    "plain10": {"hit@10": 0.09432, "hit@100": 0.28016, "hit@500": 0.64717,
                "mrr@1000": 0.04256},
    "co1_T10": {"hit@10": 0.34057, "hit@100": 0.61762, "hit@500": 0.85747,
                "mrr@1000": 0.12924}}


def run_colisten_path(dev, hp, work: str) -> dict:
    """The A/B, cut, on the hard phase's data: ``colisten_ab.run`` for the
    CF rows and the PPR controls (their top-1000 lists and K1 launches
    kept), plain10 from the hard phase's margin-1e-5 model (the arm's
    config; not trained again) and co1_T10 at AB_EPOCHS epochs through
    the module's trainer (its co-listen sweep with K1, K3 and its
    backward every step, the embed with K2), each row appended to the
    A/B's JSON lines.  Returns its state."""
    import dataclasses

    import numpy as np

    from gcn_song_embeddings_tpu_torch import colisten_ab as ab
    from gcn_song_embeddings_tpu_torch.ops import walk_kernel

    hb = hp["bench"]
    data = ab.Data(hb.graph, hb.dg, hb.train_pos, hb.test_pos, hb.ds_path)
    ab_work = os.path.join(work, "colisten_ab")
    shutil.rmtree(ab_work, ignore_errors=True)
    walls, lists = {}, []
    ppr_lists = ab.ppr_lists

    def kept(graph, n_items, **kw):
        before = walk_kernel.launches
        knn = ppr_lists(graph, n_items, **kw)
        lists.append({"graph": graph, "knn": knn,
                      "launches": walk_kernel.launches - before})
        return knn

    args = ab.parse_args(["--work-dir", ab_work, "--arms",
                          ",".join(AB_RUN_ARMS), "--device", str(dev)])
    out = os.path.join(ab_work, "colisten_ab.jsonl")
    t = time.perf_counter()
    ab.ppr_lists = kept
    try:
        rows = ab.run(args, log, data=data)
    finally:
        ab.ppr_lists = ppr_lists
    walls["cf_and_ppr_arms_s"] = time.perf_counter() - t
    if sorted(rows) != sorted(AB_RUN_ARMS) or len(lists) != 2:
        raise AssertionError(f"A/B arms run: {sorted(rows)}, PPR lists "
                             f"{len(lists)}")

    def same(a, b):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        a.pop("run_name"), b.pop("run_name")
        return a == b

    overrides = dict(ab.ARMS)["plain10"]
    if not same(ab.arm_config("plain10", overrides), hp["cfg_1e5"]):
        raise AssertionError("plain10's config is not the hard phase's "
                             "margin-1e-5 model's")
    t = time.perf_counter()
    rows["plain10"] = ab.emit(out, "plain10", ab.score(
        hp["emb_1e5"], data.test_pos, dev), {
            "reused": "the hard phase's margin-1e-5 model",
            "overrides": overrides}, log)
    walls["plain10_eval_s"] = time.perf_counter() - t

    overrides = {**dict(ab.ARMS)["co1_T10"], "train.epochs": AB_EPOCHS}
    cfg = ab.arm_config("co1_T10", overrides)
    t = time.perf_counter()
    trainer = ab.pinsage_trainer(data, cfg, ab_work, verbose=False)
    walls["co1_T10_precompute_s"] = time.perf_counter() - t
    t = time.perf_counter()
    trainer.train()
    walls["co1_T10_train_s"] = time.perf_counter() - t
    t = time.perf_counter()
    emb = trainer.embed()
    rows["co1_T10"] = ab.emit(out, "co1_T10", ab.score(
        emb, data.test_pos, dev), {
            "precompute_s": round(walls["co1_T10_precompute_s"], 1),
            "train_s": round(walls["co1_T10_train_s"], 1),
            "embed_eval_s": round(time.perf_counter() - t, 1),
            "overrides": overrides}, log)
    walls["co1_T10_embed_eval_s"] = time.perf_counter() - t
    if emb.shape != (data.graph.n_items, cfg.model.out_dim) or not (
            np.isfinite(emb).all()):
        raise AssertionError(f"co1_T10 embeddings: shape {emb.shape}")
    return {"rows": rows, "lists": lists, "trainer": trainer, "emb": emb,
            "data": data, "walls": walls, "out": out, "work": ab_work,
            "steps": cfg.train.epochs * cfg.train.batches_per_epoch}


def check_colisten(ab_state) -> dict:
    """The A/B's bars (AB_BARS) on its rows; the rows beside JAX's.
    Returns the ``colisten_checks`` line's payload."""
    rows = ab_state["rows"]
    ratios, low = {}, {}
    for num, den, metric, bar in AB_BARS:
        ratio = rows[num][metric] / max(rows[den][metric], 1e-12)
        key = f"{num}/{den} {metric}"
        ratios[key] = ratio
        if not (ratio >= bar if bar > 1.0 else ratio > bar):
            low[key] = (ratio, bar)
    log(f"co-listen A/B (cut): {json.dumps(ratios)}")
    if low:
        raise AssertionError(f"A/B bars missed: {low} ({rows})")
    metrics = ("hit@10", "hit@100", "hit@500", "mrr@1000")
    return {"rows": {arm: {k: row[k] for k in metrics}
                     for arm, row in rows.items()},
            "ratios": ratios, "bars": [list(b) for b in AB_BARS],
            "co1_T10_epochs": AB_EPOCHS, "jax_rows": JAX_AB,
            "walls": dict(ab_state["walls"])}


def run_new_shape(dev, ab_state, arm: str) -> dict:
    """NEW_SHAPE_STEPS steps of ``arm``'s config (T=20, or hidden 1024 and
    out 512) on the A/B's data and co-listen cache, then its embed:
    K3 and its backward every step at the arm's shapes, K2 in the embed.
    Returns the trainer and the wall."""
    import numpy as np

    from gcn_song_embeddings_tpu_torch import colisten_ab as ab
    from gcn_song_embeddings_tpu_torch.config import config_with_overrides
    from gcn_song_embeddings_tpu_torch.train.trainer import PinSageTrainer

    cfg = config_with_overrides(
        ab.arm_config(arm, dict(ab.ARMS)[arm]),
        {"train.epochs": 1, "train.batches_per_epoch": NEW_SHAPE_STEPS})
    data = ab_state["data"]
    g = data.graph
    t = time.perf_counter()
    trainer = PinSageTrainer(
        data.dg, g.n_items, g.features, data.train_pos, cfg=cfg,
        base_run_dir=os.path.join(ab_state["work"], "shapes"),
        nbhds_path=os.path.join(data.ds_path, "neighborhoods.npz"),
        log=False, load_save=False, verbose=False)
    if trainer.fullgraph:
        raise AssertionError(f"{arm} trains full-graph at {g.n_items} rows")
    trainer.train()
    emb = trainer.embed()
    wall = time.perf_counter() - t
    if emb.shape != (g.n_items, cfg.model.out_dim) or not np.isfinite(
            emb).all():
        raise AssertionError(f"{arm} embeddings: shape {emb.shape}")
    log(f"{arm}: {NEW_SHAPE_STEPS} steps and the embed in {wall:.2f} s")
    return {"trainer": trainer, "wall_s": wall}


def hold_colisten_kernels(torch, ab_state, shapes: dict) -> list:
    """The phase's new shapes against their plain versions: K1 at the
    ppr_co1 control's first block and its padded last block (B=2048,
    H=1000 over the augmented hard graph; their top-1000 equal to the
    arm's lists), and for each NEW_SHAPE_ARMS trainer K3 with its backward
    at both aggregations of one frontier step and K2 (with the backward)
    at both ``embed_all`` layers (``measure_aggregation``: K2_ATOL,
    GRAD_RTOL).  Returns the kernels line's rows."""
    import numpy as np

    from gcn_song_embeddings_tpu_torch import colisten_ab as ab
    from gcn_song_embeddings_tpu_torch.models.pinsage import conv_from_table
    from gcn_song_embeddings_tpu_torch.ops import agg, dma_agg, walk_kernel
    from gcn_song_embeddings_tpu_torch.ops.ppr import (
        block_generator,
        visit_counts_topt,
    )
    from gcn_song_embeddings_tpu_torch.ops.walks import (
        draw_uniforms,
        fused_walk_tables,
        walks_from_fused_tables,
    )

    rows = []
    co = ab_state["lists"][1]
    graph, knn = co["graph"], co["knn"]
    dev, n = graph.device, graph.n_items
    tables = fused_walk_tables(graph)
    b, hops, k = ab.PPR_BLOCK, ab.PPR_HOPS, ab.PPR_K
    k1_shapes = []
    for start in (0, (n - 1) // b * b):
        stop = min(start + b, n)
        ids = np.full((b,), stop - 1, np.int32)
        ids[:stop - start] = np.arange(start, stop, dtype=np.int32)
        nodes = torch.as_tensor(ids, device=dev)
        u = draw_uniforms(hops, b, block_generator(0, start, dev))
        _, nb = visit_counts_topt(walks_from_fused_tables(
            tables, nodes, hops, ab.PPR_ALPHA, u), nodes, k)
        if not np.array_equal(nb[:stop - start].cpu().numpy(),
                              knn[start:stop]):
            raise AssertionError(f"ppr_co1's lists of block {start} differ "
                                 f"from the plain walker's top-{k}")
        k1_shapes.append((f"ppr_co1 control block at {start} B={b} "
                          f"({stop - start} origins) H={hops} alpha="
                          f"{ab.PPR_ALPHA}, top-{k}, {graph.n_edges} "
                          f"directed edges", nodes, ab.PPR_ALPHA, u))
    row = measure_k1(torch, walk_kernel, tables, k1_shapes, {
        arm: lst["launches"] for arm, lst in zip(
            ("colisten_ab_ppr_plain", "colisten_ab_ppr_co1"),
            ab_state["lists"])})
    row["name"] += " at the A/B's PPR control blocks"
    rows.append(row)
    log(f"A/B K1: both control blocks' top-{k} == ppr_co1's lists")

    for arm, st in shapes.items():
        trainer, counts = st["trainer"], st["launches"]
        mcfg, t_nb = trainer.cfg.model, trainer.tables
        step_shapes = step_conv_inputs(torch, trainer, trainer.sample(
            block_generator(4242, 0, dev)))
        k3 = measure_aggregation(torch, agg, "dma", step_shapes)
        rows.append(kernel_row(
            f"K3 fused 3xTF32 gather + Q-MLP + weighted mean "
            f"(agg.conv_aggregate, mode dma) at {arm}", dma_agg.SOURCE,
            dma_agg.REPLACES, {f"{arm}_steps": counts["dma_agg"]},
            counts["agg_backward_dma"], k3,
            f"both aggregations of a frontier step at B="
            f"{trainer.cfg.train.batch_size} over the hard graph: "
            f"{step_shapes[0][2].shape[0]} nodes x T={mcfg.T}, Din="
            f"{step_shapes[0][1].shape[1]} and "
            f"{step_shapes[1][2].shape[0]} nodes x T={mcfg.T}, Din="
            f"{step_shapes[1][1].shape[1]}; H={mcfg.hidden_dim}"))
        nb_idx = t_nb.nbhd_n[:, :mcfg.T].to(torch.int32).contiguous()
        nb_wt = t_nb.nbhd_w[:, :mcfg.T].contiguous()
        layers = trainer.params.layers
        with torch.inference_mode():
            h1 = conv_from_table(layers[0], t_nb.features, t_nb.features,
                                 nb_idx, nb_wt)
        k2 = measure_aggregation(torch, agg, "stream", [
            (layers[0], t_nb.features, nb_idx, nb_wt, False),
            (layers[1], h1, nb_idx, nb_wt, True)])
        row = kernel_row(
            f"K2 3xTF32 Q-MLP of every table row, then gather + weighted "
            f"mean (agg.conv_aggregate, mode stream) at {arm}", agg.SOURCE,
            agg.REPLACES, {f"{arm}_embed": counts["agg"]}, 0, k2,
            f"both embed_all layers, N={trainer.n} T={mcfg.T}: Din="
            f"{t_nb.features.shape[1]} and {h1.shape[1]}, H="
            f"{mcfg.hidden_dim}; backward at the same shapes (a full-graph "
            f"step's); P scratch {trainer.n * mcfg.hidden_dim * 4} bytes")
        row["header"] = agg.HEADER
        rows.append(row)
        del h1
    return rows

# the precision policy's phase: co1_T10_wide at full width (hidden 1024,
# out 256, T=10) on the A/B's data, PRECISION_STEPS steps from one init on
# the same batches and the embed, unset (f32) and at each value
PRECISION_ARM = "co1_T10_wide"
PRECISION_STEPS = 3
PRECISION_VALUES = {"unset": None, "default": 1, "high": 3}
# |first step's loss at a value - the f32 one| over the arm's margin, at
# most: the same init, so only the forward's rounding differs, and the
# loss is a mean of cosine differences near the margin (1e-5), which one
# bf16 pass moves by ~1e-7 on these unit rows
PRECISION_LOSS_MARGINS = 0.1
PRECISION_RANK_ROWS = 256  # served and kNN query rows held bit-equal


def _ranking_outputs(torch, dev, emb, test_pos) -> list:
    """kNN, ``rank_eval`` and the f32 and int8 serving indexes' answers
    over one table: what the precision policy must leave alone."""
    import numpy as np

    from gcn_song_embeddings_tpu_torch.evals.device_eval import rank_eval
    from gcn_song_embeddings_tpu_torch.ops.knn import knn_from_emb
    from gcn_song_embeddings_tpu_torch.serve import EmbeddingIndex

    table = emb.cpu().numpy()
    rows = np.arange(PRECISION_RANK_ROWS)
    w, n = knn_from_emb(table, queries=rows, k=100, device=dev)
    served = [[(o["index"], o["score"]) for r in EmbeddingIndex(
        table, quantized=q, device=dev).knn_rows(rows, 10) for o in r]
        for q in (False, True)]
    return [w, n, rank_eval(table, test_pos, device=dev), served]


# the policy's reach outside PinSage (the GNN rows, node2vec's skip-gram,
# MFCC, the audio nets), each run on the card and on the CPU from the same
# inputs at every value.  The GNN rows at the roster's widths (hidden and
# out 128, 10 samples) on a seeded graph of REACH_NODES nodes with 128-d
# features, REACH_GNN_STEPS steps of batch REACH_GNN_BATCH; one chunk of
# REACH_SG_STEPS skip-gram steps at the roster's shapes (dim 128, batch
# 8,192, 5 negatives); MFCC-40 of REACH_CLIPS 30 s clips; VGGish on
# REACH_PATCHES patches of seeded weights
REACH_NODES = 1000
REACH_GNN_STEPS = 3
REACH_GNN_BATCH = 128
REACH_SG_STEPS = 20
REACH_CLIPS = 8
REACH_PATCHES = 4
# card vs CPU at the CPU tests' tolerances (tests/test_torch_precision_
# gnn.py, _audio.py): relative Frobenius.  Unset and default 1e-3 (an f32
# intermediate rounded again: neighbouring bf16 values are 2^-8 apart;
# unset within it); high 2e-5 (a flip moves the lo part only, 2^-16).
# MFCC unset and high 1e-4 (tests/test_torch_features.py's bar); the deep
# net at default 1e-2 (flips accumulate through nine stacked layers).  A
# GNN row's first loss (the same init and draws) within 1e-5 relative.
REACH_TOL = {"unset": 1e-3, "default": 1e-3, "high": 2e-5}
REACH_MFCC_TOL = {"unset": 1e-4, "default": 1e-3, "high": 1e-4}
REACH_NET_TOL = {"unset": 1e-3, "default": 1e-2, "high": 2e-5}


def _reach_inputs():
    """The reach checks' seeded inputs, on the CPU: the GNN graph and
    features, each layer's initial parameters and draws, skip-gram's
    walks, initial W_in and draws, the clips and VGGish's patches."""
    import numpy as np
    import torch

    from gcn_song_embeddings_tpu_torch.models import gnnlib
    from gcn_song_embeddings_tpu_torch.models.baselines.node2vec import (
        SkipgramDraws,
        skipgram_steps,
    )
    from gcn_song_embeddings_tpu_torch.ops.ppr import seeded_generator

    rng = np.random.default_rng(2718)
    n = REACH_NODES
    deg = rng.integers(0, 20, n)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    indices = rng.integers(0, n, indptr[-1]).astype(np.int64)
    feats = rng.normal(size=(n, 128)).astype(np.float32)
    gnn = {}
    for layer in ("sage", "gat", "gcn"):
        core = gnnlib.GNNCore(layer=layer, hidden_dim=128, out_dim=128,
                              n_sample=10, batch=REACH_GNN_BATCH,
                              device="cpu")
        core._gen = seeded_generator([core.seed, 1], "cpu")
        gnn[layer] = (core.init_params(128, 128, torch.device("cpu")),
                      [core.draws(s, n, None)
                       for s in range(REACH_GNN_STEPS)])
    # 820 walks of 20 at context 10 make REACH_SG_STEPS steps of 8,192
    n_sg, batch = 20_000, 8192
    walks = rng.integers(0, n_sg, (820, 20)).astype(np.int64)
    if skipgram_steps(820, 20, 10, 1, batch) != REACH_SG_STEPS:
        raise AssertionError("the skip-gram chunk's walks give another "
                             "number of steps")
    gen = torch.Generator().manual_seed(3)
    sg_draws = [SkipgramDraws(
        torch.randint(0, walks.shape[0], (batch,), generator=gen),
        torch.randint(0, 20, (batch,), generator=gen),
        torch.randint(1, 11, (batch,), generator=gen),
        torch.rand((batch,), generator=gen),
        torch.randint(0, n_sg, (batch, 5), generator=gen))
        for _ in range(REACH_SG_STEPS)]
    W_in = (torch.rand((n_sg, 128), generator=gen) - 0.5) / 128
    t = np.arange(480_000) / 16_000
    clips = np.stack([
        0.3 * np.sin(2 * np.pi * (110 * (k + 1)) * t)
        + 0.05 * rng.normal(size=t.shape)
        for k in range(REACH_CLIPS)]).astype(np.float32)
    patches = rng.normal(size=(REACH_PATCHES, 96, 64)).astype(np.float32)
    return {"graph": (indptr, indices, feats), "gnn": gnn,
            "skipgram": (walks, n_sg, W_in, sg_draws), "clips": clips,
            "patches": patches}


def _reach_run(dev, inp, vggish) -> dict:
    """The reach checks' outputs on ``dev`` under the current policy:
    each GNN row's losses, first-step gradients and final parameters,
    skip-gram's W_in after its chunk, MFCC of the clips, VGGish of the
    patches; all as CPU numpy."""
    import torch

    from gcn_song_embeddings_tpu_torch import features as F
    from gcn_song_embeddings_tpu_torch.models import audio_embedders as P
    from gcn_song_embeddings_tpu_torch.models import gnnlib
    from gcn_song_embeddings_tpu_torch.models.baselines.node2vec import (
        train_skipgram,
    )

    def to(tree):   # a copy: fit trains its parameters in place
        if isinstance(tree, torch.Tensor):
            return tree.to(dev, copy=True)
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        return type(tree)(*map(to, tree)) if hasattr(tree, "_fields") \
            else type(tree)(map(to, tree))

    out = {}
    indptr, indices, feats = inp["graph"]
    for layer, (init, draws) in inp["gnn"].items():
        core = gnnlib.GNNCore(layer=layer, hidden_dim=128, out_dim=128,
                              n_sample=10, steps=REACH_GNN_STEPS,
                              batch=REACH_GNN_BATCH, device=dev)
        core.init_params = lambda i, o, d, init=init: to(init)
        core.draws = lambda step, n, pool, draws=draws: to(draws[step])
        core.fit(indptr, indices, feats, REACH_NODES)
        params = to(init)
        leaves = [t.requires_grad_() for lp in params.values()
                  for t in lp.values()]
        grads = torch.autograd.grad(core.loss(params, to(draws[0])), leaves)
        out[f"gnn_{layer}_losses"] = core.losses
        out[f"gnn_{layer}_grads"] = [g.cpu().numpy() for g in grads]
        out[f"gnn_{layer}_params"] = [t.cpu().numpy()
                                      for lp in core._params.values()
                                      for t in lp.values()]
    walks, n_sg, W_in, sg_draws = inp["skipgram"]
    out["skipgram_W_in"] = train_skipgram(
        torch.as_tensor(walks, device=dev), n_sg, dim=128, context=10,
        negatives=5, epochs=1, batch=8192, W_in=W_in.to(dev),
        draws=lambda step: to(sg_draws[step]))
    out["mfcc"] = F.MFCC(device=dev).embed_batch(inp["clips"])
    out["vggish"] = P.run_net(
        vggish.to(dev), torch.as_tensor(inp["patches"], device=dev)
    ).cpu().numpy()
    return out


def _rel(got, want) -> float:
    """The relative Frobenius distance of ``got`` from ``want``."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _reach_holds(value, got, want, w_in) -> dict:
    """The card's reach outputs at ``value`` against the CPU's: each
    distance beside its bar; raises where one passes it."""
    tol = REACH_TOL[value]
    holds = {}
    for layer in ("sage", "gat", "gcn"):
        g, w = got[f"gnn_{layer}_losses"], want[f"gnn_{layer}_losses"]
        holds[f"gnn_{layer}_first_loss"] = (_rel(g[:1], w[:1]), 1e-5)
        holds[f"gnn_{layer}_losses"] = (_rel(g, w), tol)
        holds[f"gnn_{layer}_grads"] = (max(
            _rel(a, b) for a, b in zip(got[f"gnn_{layer}_grads"],
                                       want[f"gnn_{layer}_grads"])), tol)
    holds["skipgram_update"] = (_rel(got["skipgram_W_in"] - w_in,
                                     want["skipgram_W_in"] - w_in), tol)
    holds["mfcc"] = (_rel(got["mfcc"], want["mfcc"]),
                     REACH_MFCC_TOL[value])
    holds["vggish"] = (_rel(got["vggish"], want["vggish"]),
                       REACH_NET_TOL[value])
    bad = {k: v for k, v in holds.items() if not v[0] <= v[1]}
    if bad:
        raise AssertionError(f"precision reach at {value}: card vs CPU "
                             f"(distance, bar) {bad}")
    return holds


def run_precision_reach(dev) -> dict:
    """The matmul precision policy outside PinSage on the card: a few
    ``GNNCore`` steps for sage, gat and gcn, one skip-gram chunk, MFCC of
    a batch of clips and one VGGish forward (``_reach_run``), unset, at
    ``default`` and at ``high``, each held against the same run on the CPU
    at the same value (``_reach_holds``), then unset again on the card,
    bit-equal to the first unset run; ``default`` must change each
    output's bits.  Deterministic algorithms (warn only) for the card's
    runs, so skip-gram's scatter-adds repeat.  Returns the holds and the
    walls."""
    import numpy as np
    import torch

    from gcn_song_embeddings_tpu_torch.models import audio_embedders as P
    from gcn_song_embeddings_tpu_torch.utils import precision

    t0 = time.perf_counter()
    inp = _reach_inputs()
    nets = {"cpu": P.VGGishNet.build(seed=0, device="cpu")}
    nets["card"] = copy.deepcopy(nets["cpu"]).to(dev)
    w_in = inp["skipgram"][2].numpy()
    det = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    runs, holds, walls = {}, {}, {"inputs_s": time.perf_counter() - t0}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for value in ("unset", "default", "high", "unset_again"):
            name = None if value.startswith("unset") else value
            with precision.override(name):
                t = time.perf_counter()
                runs[value] = _reach_run(dev, inp, nets["card"])
                sync(torch, dev)
                walls[f"{value}_card_s"] = time.perf_counter() - t
                if value == "unset_again":
                    break
                t = time.perf_counter()
                want = _reach_run(torch.device("cpu"), inp, nets["cpu"])
                walls[f"{value}_cpu_s"] = time.perf_counter() - t
            holds[value] = _reach_holds(value, runs[value], want, w_in)
    finally:
        torch.use_deterministic_algorithms(det[0], warn_only=det[1])
    def same_bits(a, b):   # an array, or a list of them (gradients)
        if isinstance(a, list):
            return all(np.array_equal(x, y) for x, y in zip(a, b))
        return np.array_equal(a, b)

    again = [k for k, v in runs["unset"].items()
             if not same_bits(v, runs["unset_again"][k])]
    same = [k for k, v in runs["unset"].items()
            if same_bits(v, runs["default"][k])]
    if again or same:
        raise AssertionError(f"precision reach: unset rerun not bit-equal "
                             f"{again}; default left the bits of {same}")
    walls["phase_s"] = time.perf_counter() - t0
    out = {"holds": holds, "unset_rerun_bit_equal": True, "walls": walls}
    log(f"precision reach: {json.dumps(out)}")
    return out


def run_precision_path(dev, ab_state) -> dict:
    """The matmul precision policy (``utils.precision``) on the card, as
    ``GCN_TPU_MATMUL_PRECISION`` sets it for a process: PRECISION_ARM's
    config on the A/B's data and co-listen cache, PRECISION_STEPS train
    steps from the trainer's seeded init on the same batches and then
    ``embed_all``, once for each of PRECISION_VALUES with the counters
    set to 0 before it (unset: K3 and K2 in 3xTF32; default / high: their
    bf16x1 / bf16x3 forms, with the backward in the same passes), then
    the step's wall and device time at that value (``time_train_steps``,
    after the counts are read).  Then
    kNN, ``rank_eval`` and both serving indexes over the unset run's
    table under each value.  Returns the runs, their counts and the
    checks."""
    import copy

    import numpy as np

    from gcn_song_embeddings_tpu_torch import colisten_ab as ab
    from gcn_song_embeddings_tpu_torch.config import config_with_overrides
    from gcn_song_embeddings_tpu_torch.models.pinsage import embed_all
    from gcn_song_embeddings_tpu_torch.ops.ppr import block_generator
    from gcn_song_embeddings_tpu_torch.train.trainer import (
        PinSageTrainer,
        make_optimizer,
        train_step,
    )
    from gcn_song_embeddings_tpu_torch.utils import precision

    import torch

    t0 = time.perf_counter()
    cfg = config_with_overrides(
        ab.arm_config(PRECISION_ARM, dict(ab.ARMS)[PRECISION_ARM]),
        {"train.epochs": 1, "train.batches_per_epoch": PRECISION_STEPS})
    data = ab_state["data"]
    g = data.graph
    trainer = PinSageTrainer(
        data.dg, g.n_items, g.features, data.train_pos, cfg=cfg,
        base_run_dir=os.path.join(ab_state["work"], "precision"),
        nbhds_path=os.path.join(data.ds_path, "neighborhoods.npz"),
        log=False, load_save=False, verbose=False)
    if trainer.fullgraph:
        raise AssertionError(f"{PRECISION_ARM} trains full-graph")
    tcfg, mcfg, tables = cfg.train, cfg.model, trainer.tables
    gen = block_generator(2718, 0, trainer.device)
    batches = [trainer.sample(gen) for _ in range(PRECISION_STEPS)]
    init = copy.deepcopy(trainer.params)
    runs = {}
    for value, passes in PRECISION_VALUES.items():
        params = copy.deepcopy(init)
        opt = make_optimizer(params, tcfg)
        reset_kernel_counts()
        t = time.perf_counter()
        with precision.override(None if passes is None else value):
            losses = [float(train_step(params, opt, b, tables, tcfg, mcfg,
                                       False)[0]) for b in batches]
            steps_s = time.perf_counter() - t
            emb = embed_all(params, tables.features, tables.nbhd_w,
                            tables.nbhd_n, trainer.n, mcfg.n_layers, mcfg.T)
        sync(torch, dev)
        counts = kernel_counts()
        # the step's wall and device time at this value (B=128, frontier)
        with precision.override(None if passes is None else value):
            step_ms, profile = time_train_steps(torch, trainer, reps=20,
                                                profiled=5)
        runs[value] = {"losses": losses, "emb": emb, "counts": counts,
                       "steps_s": steps_s, "step_ms": step_ms,
                       "profile": profile}
        launched = {k: n for k, n in counts.items() if n}
        log(f"precision {value}: losses {losses}, {PRECISION_STEPS} steps "
            f"{steps_s:.3f} s, launches {json.dumps(launched)}")
        if not (np.isfinite(losses).all() and emb.shape == (
                trainer.n, mcfg.out_dim) and bool(torch.isfinite(emb).all())):
            raise AssertionError(f"precision {value}: losses {losses}, "
                                 f"embeddings {tuple(emb.shape)}")
        form = "" if passes is None else f"_bf16x{passes}"
        need = [f"dma_agg{form}", f"agg_backward_dma{form}", f"agg{form}"]
        need += ([f"agg_bf16x{passes}_tile", f"agg_bf16x{passes}_project"]
                 if passes else ["agg_split", "agg_project"])
        missing = [k for k in need if counts[k] == 0]
        others = [k for k in ("dma_agg", "agg", *(
            f"{m}_bf16x{p}" for m in ("dma_agg", "agg") for p in (1, 3)))
                  if counts[k] and k not in need]
        if missing or others:
            raise AssertionError(f"precision {value}: kernels never "
                                 f"launched {missing}, other forms "
                                 f"launched {others}")
    f32 = runs["unset"]
    checks = {"losses": {v: r["losses"] for v, r in runs.items()}}
    for value in ("default", "high"):
        checks[f"{value}_first_loss_diff_over_margin"] = abs(
            runs[value]["losses"][0] - f32["losses"][0]) / tcfg.margin
        checks[f"{value}_emb_rel_diff"] = float(
            torch.linalg.vector_norm(runs[value]["emb"] - f32["emb"])
            / torch.linalg.vector_norm(f32["emb"]))
    log(f"precision: {json.dumps(checks)}")
    if not (runs["default"]["losses"][-1] != f32["losses"][-1]
            and max(checks[f"{v}_first_loss_diff_over_margin"]
                    for v in ("default", "high")) <= PRECISION_LOSS_MARGINS
            and checks["high_emb_rel_diff"] < checks["default_emb_rel_diff"]):
        raise AssertionError(f"the policy's steps: {checks}")
    # ranking reads no policy: bit-equal under every value
    test = data.test_pos[:4096]
    want = _ranking_outputs(torch, dev, f32["emb"], test)
    for value in ("default", "high"):
        with precision.override(value):
            got = _ranking_outputs(torch, dev, f32["emb"], test)
        same = [np.array_equal(got[0], want[0]),
                np.array_equal(got[1], want[1]), got[2] == want[2],
                got[3] == want[3]]
        if not all(same):
            raise AssertionError(f"ranking under {value} differs (kNN "
                                 f"weights, ids, rank_eval, serving): "
                                 f"{same}")
    checks["ranking_bit_equal"] = True
    checks["rank_eval"] = want[2]
    # the policy's reach outside PinSage, card vs CPU at every value
    checks["reach"] = run_precision_reach(dev)
    checks["phase_s"] = time.perf_counter() - t0
    return {"trainer": trainer, "batch": batches[0], "runs": runs,
            "checks": checks}


def measure_aggregation_bf16x(torch, agg, mode, shapes, passes) -> dict:
    """Hold the aggregation of ``mode`` in its bf16x form (``passes``
    bf16 passes on an f32 table) against its plain version at each
    (layer, table, ids, weights, need_dh) of ``shapes``: max |diff|
    within K2_ATOL (the products of the same rounded operands are exact
    in f32 on both sides, only the order of the f32 sums differs), the
    error against float64 of the same rounded function within 4x the
    plain version's a pass (the tensor cores sum every pass into the one
    accumulator, less carefully than an FMA: K3-bf16x3 erred 4.1x at
    Din 256 on the H100), the backward against float64 autograd of the
    same function within GRAD_RTOL or, where the plain version's own f32
    backward is further than that, within 1.25x of it (the rounded
    function is discontinuous: f32 and float64 round a cotangent entry
    near a bf16 boundary to neighbours 2^-8 apart, and at the 20,000-row
    embed both sit 1.7e-3 from float64 in dWq); timed as
    ``measure_aggregation`` times (``ms``, ``host_ms``, plain, backward),
    the library yardstick a bf16 cast of the table and Wq, the gather
    and one ``einsum`` (three einsums of the hi / lo casts for three
    passes).  Mode "stream" also
    holds K2's tiling bit for bit and its projection (``parts``)."""
    from gcn_song_embeddings_tpu_torch.utils import precision

    value = {1: "default", 3: "high"}[passes]
    out = {"ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "flops": 0.0, "products": 0.0, "bytes": 0.0, "err": 0.0,
           "err64": 0.0, "plain_err64": 0.0, **dict.fromkeys(BWD_KEYS, 0.0)}
    if mode == "stream":
        out["parts"] = {"tile": {"max_abs_err": 0.0, "ms": 0.0},
                        "project": {"max_abs_err": 0.0, "ms": 0.0,
                                    "plain_ms": 0.0}}
    kernel = f"{agg.MODES[mode]} {agg.BF16X[passes]}"

    def run(h, ids, wts, Wq, bq):
        with precision.override(value):
            return agg.conv_aggregate(h, ids, wts, Wq, bq, mode=mode)

    def library(h, ids, wts, Wq, bq):
        if passes == 1:
            return torch.einsum("btd,hd->bth", h.bfloat16()[ids.long()],
                                Wq.bfloat16())
        (hh, hl), (wh, wl) = (
            tuple(x.bfloat16() for x in agg.bf16_split3(t)) for t in (h, Wq))
        rows_h, rows_l = hh[ids.long()], hl[ids.long()]
        return (torch.einsum("btd,hd->bth", rows_h, wl)
                + torch.einsum("btd,hd->bth", rows_l, wh)
                + torch.einsum("btd,hd->bth", rows_h, wh))

    for layer, h, ids, wts, need_dh in shapes:
        Wq, bq = layer.Wq.detach(), layer.bq.detach()
        n, din = h.shape
        hdim = Wq.shape[0]
        with torch.inference_mode():
            got = run(h, ids, wts, Wq, bq)
            want = agg.conv_aggregate_plain(h, ids, wts, Wq, bq, passes)
            err = float((got - want).abs().max())
            err64, plain_err64 = float64_error(torch, agg, h, ids, wts, Wq,
                                               bq, got, want, passes)
            log(f"{kernel} B={ids.shape[0]} T={ids.shape[1]} Din={din} "
                f"H={hdim} (table {n} rows): max |diff| {err:.3g}; "
                f"against float64 kernel {err64:.3g}, plain {plain_err64:.3g}")
            if not (err <= K2_ATOL and err64 <= 4 * passes * plain_err64):
                raise AssertionError(f"{kernel}: max |diff| {err} (bar "
                                     f"{K2_ATOL}), against float64 {err64} "
                                     f"(plain {plain_err64})")
            out["err"] = max(out["err"], err)
            out["err64"] = max(out["err64"], err64)
            out["plain_err64"] = max(out["plain_err64"], plain_err64)
            if mode == "stream":
                hi, lo = agg.tile_wq_bf16x(Wq, passes)
                want_hi, want_lo = (agg.tile_wq_plain(x.bfloat16())
                                    for x in agg.bf16_split3(Wq))
                if not (torch.equal(hi.view(torch.int16),
                                    want_hi.view(torch.int16))
                        and (lo is None or torch.equal(
                            lo.view(torch.int16),
                            want_lo.view(torch.int16)))):
                    raise AssertionError(f"{kernel}: the Wq tiling differs "
                                         f"from tile_wq_plain")
                rows = agg.slabs_to_rows(agg.project_table_bf16x(
                    h, hi, lo, bq, passes), hdim)
                perr = float((rows - agg.project_table_plain(
                    h, Wq, bq, passes)).abs().max())
                if not perr <= K2_ATOL:
                    raise AssertionError(f"{kernel} projection: {perr}")
                parts = out["parts"]
                parts["project"]["max_abs_err"] = max(
                    parts["project"]["max_abs_err"], perr)
                parts["tile"]["ms"] += cuda_ms(torch, lambda: agg.
                                               tile_wq_bf16x(Wq, passes),
                                               reps=10)
                parts["project"]["ms"] += cuda_ms(
                    torch, lambda: agg.project_table_bf16x(h, hi, lo, bq,
                                                           passes), reps=5)
                parts["project"]["plain_ms"] += cuda_ms(
                    torch, lambda: agg.project_table_plain(h, Wq, bq,
                                                           passes), reps=3)
                del rows, hi, lo
            del got, want
            out["slopes_ms"] = out.get("slopes_ms", 0.0) + slopes_ms(
                torch, agg, mode, h, ids, wts, Wq, bq, passes)
            out["ms"] += cuda_ms(torch, lambda: run(h, ids, wts, Wq, bq),
                                 reps=5)
            out["host_ms"] += cuda_ms(torch, lambda: run(h, ids, wts, Wq,
                                                         bq),
                                      reps=5, queued=False)
            out["plain_ms"] += cuda_ms(torch, lambda: agg.
                                       conv_aggregate_plain(h, ids, wts, Wq,
                                                            bq, passes),
                                       reps=3)
            out["library_ms"] += cuda_ms(torch, lambda: library(
                h, ids, wts, Wq, bq), reps=3)
        flops, nbytes, distinct, _ = agg_work(torch, ids, wts, din, hdim, n)
        out["flops"] += flops
        out["products"] += 2.0 * distinct * din * hdim
        out["bytes"] += nbytes
        bw = backward_timing(torch, agg, mode, layer, h, ids, wts, need_dh,
                             passes)
        errs, plain_errs, flips = bw["err"], bw["plain_err"], bw["flips"]
        log(f"{kernel} backward vs float64 autograd of the rounded "
            f"function: relative Frobenius {errs} (f32 plain {plain_errs}; "
            f"{flips} entries at another slope)")
        if not all(e <= max(GRAD_RTOL, 1.25 * p)
                   for e, p in zip(errs, plain_errs)):
            raise AssertionError(f"{kernel} backward errors {errs} against "
                                 f"float64, the plain version's "
                                 f"{plain_errs} (bar {GRAD_RTOL})")
        add_backward(torch, out, bw, ids, wts, din, hdim, n, need_dh, mode,
                     passes)
    return out


def kernel_row_bf16x(name, source, replaces, launches_by_path, bwd_launches,
                     m, shape, passes) -> dict:
    """One bf16x entry of the ``kernels`` line: its products bound on the
    bf16 tensor cores at ``passes`` passes each; the backward (its row
    sums rounded in the same passes) bound as the f32 one."""
    row = kernel_row(name, source, replaces, launches_by_path, bwd_launches,
                     m, shape)
    row["bound_ms"], row["bound_by"] = bound(
        m["flops"], m["bytes"], m["products"], H100_BF16_FLOPS, passes)
    row["backward"]["bf16_passes"] = passes
    row["bf16_passes"] = passes
    row.pop("bound_f32_simt_ms")
    return row


# the 100k main step's layer 0 as a bf16x aggregation: nodes (of T rows)
# gathered from a seeded f32 table of that many rows, Din, H
L0_100K = {"nodes": 4224, "rows": 100_000, "din": 512, "hdim": 512}


def l0_100k_shapes(torch, dev, T: int) -> list:
    """The 100k main step's deepest aggregation as a bf16x problem: 4,224
    nodes x T ids drawn from a seeded 100,000 x 512 f32 table on ``dev``,
    seeded weights, Wq and bq, in ``measure_aggregation_bf16x``'s shape
    list."""
    from types import SimpleNamespace

    g = torch.Generator(device=dev).manual_seed(100_000)
    m, n, din, h = (L0_100K[k] for k in ("nodes", "rows", "din", "hdim"))
    table = torch.randn((n, din), device=dev, generator=g)
    ids = torch.randint(0, n, (m, T), device=dev, generator=g,
                        dtype=torch.int32)
    wts = torch.rand((m, T), device=dev, generator=g)
    layer = SimpleNamespace(
        Wq=torch.randn((h, din), device=dev, generator=g) * 0.05,
        bq=torch.full((h,), 0.01, device=dev))
    return [(layer, table, ids, wts, False)]


# a deep aggregation for the 16-bit core's promoted sums, where one
# tensor-core accumulator a row missed the float64 bar before them: nodes
# x T ids over a seeded table of that many rows x Din f32, H
DEEP_DIN = {"nodes": 60, "T": 10, "rows": 20_000, "din": 1024, "hdim": 1024}


def hold_deep_din(torch, agg, dev, form: str) -> dict:
    """K3 and K2 in ``form`` (``bf16x1`` / ``bf16x3``: an f32 table in one
    or three bf16 passes; ``bf16``: the table and Wq cast to bf16) at
    DEEP_DIN, each against its plain version (within K2_ATOL) and against
    float64 of the same rounded function (``float64_error``: within 4x a
    pass the plain version's max error).  Returns both kernels' errors."""
    from gcn_song_embeddings_tpu_torch.utils import precision

    passes = {"bf16x1": 1, "bf16x3": 3}.get(form)
    g = torch.Generator(device=dev).manual_seed(DEEP_DIN["din"])
    n, m, t, din, h = (DEEP_DIN[k] for k in ("rows", "nodes", "T", "din",
                                             "hdim"))
    table = torch.randn((n, din), device=dev, generator=g)
    ids = torch.randint(0, n, (m, t), device=dev, generator=g,
                        dtype=torch.int32)
    wts = torch.rand((m, t), device=dev, generator=g)
    Wq = torch.randn((h, din), device=dev, generator=g) * 0.05
    bq = torch.full((h,), 0.3, device=dev)
    if passes is None:
        table, Wq = table.bfloat16(), Wq.bfloat16()
    out = {"nodes": m, "T": t, "din": din, "hdim": h, "table_rows": n}
    value = {1: "default", 3: "high"}.get(passes)
    for mode in ("dma", "stream"):
        with torch.inference_mode():
            with precision.override(value):
                got = agg.conv_aggregate(table, ids, wts, Wq, bq, mode=mode)
            plain = agg.conv_aggregate_plain(table, ids, wts, Wq, bq, passes)
            err = float((got - plain).abs().max())
            err64, plain_err64 = float64_error(torch, agg, table, ids, wts,
                                               Wq, bq, got, plain, passes)
        kernel = f"{agg.MODES[mode]} {form} at Din {din}, {m} nodes"
        log(f"{kernel}: max |diff| {err:.3g}; against float64 kernel "
            f"{err64:.3g}, plain {plain_err64:.3g}")
        if not (err <= K2_ATOL and err64 <= 4 * (passes or 1) * plain_err64):
            raise AssertionError(f"{kernel}: max |diff| {err} (bar "
                                 f"{K2_ATOL}), against float64 {err64} "
                                 f"(plain {plain_err64})")
        out[agg.MODES[mode]] = {"max_abs_err": err, "err64": err64,
                                "plain_err64": plain_err64}
    return out


def hold_precision_kernels(torch, pp) -> list:
    """K3's bf16x forms with their backward at both aggregations of
    PRECISION_ARM's frontier step and at the 100k main step's layer 0
    (``l0_100k_shapes``, Din 512), and K2's at both
    ``embed_all`` layers over the 20,000-track catalog, each against its
    plain version (``measure_aggregation_bf16x``).  K3's rows carry the
    grid each aggregation took (``dma_agg.card_schedule``).  Both forms of
    K3 and K2, and the bf16 table form of both, are also held at Din 1,024
    against float64 (``hold_deep_din``; the rows' ``deep_din``, the bf16
    table's under the one-pass rows).  Returns the kernels line's rows."""
    from gcn_song_embeddings_tpu_torch.models.pinsage import conv_from_table
    from gcn_song_embeddings_tpu_torch.ops import agg, dma_agg

    trainer = pp["trainer"]
    mcfg, t_nb = trainer.cfg.model, trainer.tables
    step = step_conv_inputs(torch, trainer, pp["batch"])
    nb_idx = t_nb.nbhd_n[:, :mcfg.T].to(torch.int32).contiguous()
    nb_wt = t_nb.nbhd_w[:, :mcfg.T].contiguous()
    layers = trainer.params.layers
    with torch.inference_mode():
        h1 = conv_from_table(layers[0], t_nb.features, t_nb.features,
                             nb_idx, nb_wt)
    embed = [(layers[0], t_nb.features, nb_idx, nb_wt, False),
             (layers[1], h1, nb_idx, nb_wt, True)]
    rows = []
    for value, passes in (("default", 1), ("high", 3)):
        form = agg.BF16X[passes]
        counts = pp["runs"][value]["counts"]
        k3 = measure_aggregation_bf16x(torch, agg, "dma", step, passes)
        rows.append(kernel_row_bf16x(
            f"K3 {form} fused gather + Q-MLP + weighted mean of an f32 "
            f"table in {passes} bf16 pass{'es' if passes > 1 else ''} "
            f"(GCN_TPU_MATMUL_PRECISION={value})", dma_agg.SOURCE,
            dma_agg.REPLACES, {f"precision_{value}_steps":
                               counts[f"dma_agg_{form}"]},
            counts[f"agg_backward_dma_{form}"], k3,
            f"both aggregations of {PRECISION_ARM}'s frontier step at B="
            f"{trainer.cfg.train.batch_size}: {step[0][2].shape[0]} nodes "
            f"x T={mcfg.T}, Din={step[0][1].shape[1]} and "
            f"{step[1][2].shape[0]} nodes x T={mcfg.T}, Din="
            f"{step[1][1].shape[1]}; H={mcfg.hidden_dim}", passes))
        rows[-1]["header"] = agg.HEADER
        rows[-1]["schedule"] = [dma_agg.card_schedule(
            "dma", ids.shape[0], tab.shape[1], mcfg.hidden_dim,
            ids.shape[1], passes) for _, tab, ids, _, _ in step]
        l0 = l0_100k_shapes(torch, step[0][1].device, mcfg.T)
        at = kernel_row_bf16x(
            "", "", "", {}, 0,
            measure_aggregation_bf16x(torch, agg, "dma", l0, passes),
            f"the 100k main step's layer 0: {L0_100K['nodes']} nodes x T="
            f"{mcfg.T} ids drawn from a seeded {L0_100K['rows']} x "
            f"{L0_100K['din']} f32 table, H={L0_100K['hdim']}", passes)
        for key in ("name", "route", "source", "replaces", "launches",
                    "launches_by_path", "bf16_passes"):
            at.pop(key)
        _, tab, ids, _, _ = l0[0]
        at["schedule"] = dma_agg.card_schedule(
            "dma", ids.shape[0], tab.shape[1], L0_100K["hdim"],
            ids.shape[1], passes)
        del tab, ids
        rows[-1]["at_100k_layer0"] = at
        del l0
        deep = hold_deep_din(torch, agg, step[0][1].device, form)
        rows[-1]["deep_din"] = deep["K3"]
        if passes == 1:
            deep16 = hold_deep_din(torch, agg, step[0][1].device, "bf16")
        k2 = measure_aggregation_bf16x(torch, agg, "stream", embed, passes)
        row = kernel_row_bf16x(
            f"K2 {form} Q-MLP of every row of an f32 table in {passes} bf16 "
            f"pass{'es' if passes > 1 else ''}, then gather + weighted mean "
            f"(GCN_TPU_MATMUL_PRECISION={value})", agg.SOURCE, agg.REPLACES,
            {f"precision_{value}_embed": counts[f"agg_{form}"]}, 0, k2,
            f"both embed_all layers of {PRECISION_ARM}, N={trainer.n} T="
            f"{mcfg.T}: Din={t_nb.features.shape[1]} and {h1.shape[1]}, H="
            f"{mcfg.hidden_dim}; backward at the same shapes", passes)
        row["header"] = agg.HEADER
        for name in ("tile", "project"):
            row["parts"][name]["launches"] = counts[f"agg_{form}_{name}"]
        row["deep_din"] = deep["K2"]
        if passes == 1:
            rows[-1]["deep_din_bf16_table"] = deep16["K3"]
            row["deep_din_bf16_table"] = deep16["K2"]
        rows.append(row)
    del h1
    return rows


def run_eval_path(dev, hp, ab_state, work: str):
    """The eval path, as a user runs it, on the roster: ``SongGraph`` of
    the hard dataset through the native ``graph.json`` reader (timed
    beside the ``json`` module's reading of the same file), then
    ``hard_roster``'s ``cli eval`` of every row of the JAX CLI at
    ROSTER_K over ``pinsage_hard`` (the hard phase's margin-0.1 model)
    and ``pinsage_hard_co`` (the A/B's co1_T10) with ``--hybrid-runs
    pinsage_hard_co`` (its ``cmd_eval`` body: ``eval_models`` then
    ``run_eval``, with node2vec cut to ``NODE2VEC_EPOCHS`` and the GNN
    rows to ``ROSTER_GNN_STEPS``); K1 walks for
    PageRank, PageRankCo and the Hybrid row's head; each table timed as
    the run builds it.  Then one cache's read and compressed write, timed
    again (the part of ``eval_s`` outside the rows' own times that runs on
    writer threads during the run).  Returns its state (``pinsage`` and
    ``emb``: the row ``check_eval`` holds, pinsage_hard's)."""
    from types import SimpleNamespace

    import numpy as np

    from gcn_song_embeddings_tpu_torch import cli, hard_roster
    from gcn_song_embeddings_tpu_torch.data.graph import SongGraph
    from gcn_song_embeddings_tpu_torch.evals import tables
    from gcn_song_embeddings_tpu_torch.native import jsongraph
    from gcn_song_embeddings_tpu_torch.ops import walk_kernel

    ds = hp["bench"].ds_path
    roster = os.path.join(work, "roster")
    runs = os.path.join(roster, "runs")
    shutil.rmtree(roster, ignore_errors=True)
    run_embs = {"pinsage_hard": hp["bench"].emb, ROSTER_CO: ab_state["emb"]}
    for name, emb in run_embs.items():
        os.makedirs(os.path.join(runs, name))
        np.save(os.path.join(runs, name, "emb.npy"), emb)
    walls = {}
    t = time.perf_counter()
    graph = SongGraph(ds, features_file=os.path.join(ds, "features.npy"))
    walls["load_graph_s"] = time.perf_counter() - t
    if graph.edge_reader != "native":
        raise AssertionError(f"graph.json read by {graph.edge_reader!r}, "
                             f"not the native scanner")
    path = os.path.join(ds, "graph.json")
    t = time.perf_counter()
    jsongraph.load_edges(path, graph.index_map)
    walls["native_edges_s"] = time.perf_counter() - t
    t = time.perf_counter()
    src, dst = jsongraph.load_edges_json(path, graph.index_map)
    walls["json_module_edges_s"] = time.perf_counter() - t
    if not (np.array_equal(src, graph._edges_from)
            and np.array_equal(dst, graph._edges_to)):
        raise AssertionError("native and json edge readers disagree")
    log(f"SongGraph ({graph.edge_reader} edges, tracks.json and "
        f"collections.json by the json module, CSR build): "
        f"{walls['load_graph_s']:.3f} s; graph.json's {len(src)} edges: "
        f"native {walls['native_edges_s']:.3f} s, json module "
        f"{walls['json_module_edges_s']:.3f} s")

    # the margin-0.1 row's table is held against rank_eval: the co-listen
    # run's margin 1e-5 crowds its cosines within f32 rounding of each
    # other (int8 cannot resolve them, PR 12), where a list's order and
    # the tie-fair average rank may part
    pinsage = "PinSage:pinsage_hard"
    eval_dir = os.path.join(roster, "baselines")
    args = cli.parser().parse_args(hard_roster.eval_argv(
        ds, runs, eval_dir, list(run_embs), [ROSTER_CO], str(dev))
        + ["--k", str(ROSTER_K)])
    t = time.perf_counter()
    eval_graph = cli.load_graph(args.dataset, args.features)
    models = cli.eval_models(args, eval_graph, dev)
    models["Node2Vec"].epochs = NODE2VEC_EPOCHS
    for row in ("GraphSAGE", "GAT", "GCN"):
        models[row].kwargs["steps"] = ROSTER_GNN_STEPS
    row_walks = count_walk_launches(walk_kernel, models)

    def timed(name, table):
        def build(*a, **kw):
            t0 = time.perf_counter()
            out = table(*a, **kw)
            walls[name] = time.perf_counter() - t0
            return out
        return build

    # run_eval imports the table builders when it is called
    builders = (tables.compute_results_table,
                tables.compute_beyond_accuracy_table)
    tables.compute_results_table = timed("accuracy_table_s", builders[0])
    tables.compute_beyond_accuracy_table = timed("beyond_table_s",
                                                 builders[1])
    try:
        cli.run_eval(args, eval_graph, models, dev)
    finally:
        (tables.compute_results_table,
         tables.compute_beyond_accuracy_table) = builders
    walls["eval_s"] = time.perf_counter() - t
    log(f"eval: {len(models)} rows at K={args.k} in {walls['eval_s']:.1f} "
        f"s; K1 launches by row: "
        f"{json.dumps({k: v for k, v in row_walks.items() if v})}")
    # the part of eval_s outside the models' own times and the tables,
    # timed again here on the same caches: one kNN cache's read and
    # compressed write (the PinSage row's; every [N, K] cache has the
    # same size)
    t = time.perf_counter()
    with np.load(os.path.join(eval_dir, "knn", pinsage + ".npz")) as z:
        arrays = dict(z)
    walls["one_knn_cache_read_s"] = time.perf_counter() - t
    t = time.perf_counter()
    np.savez_compressed(os.path.join(roster, "knn_rewrite.npz"), **arrays)
    walls["one_knn_cache_write_s"] = time.perf_counter() - t
    return SimpleNamespace(graph=graph, eval_dir=eval_dir, pinsage=pinsage,
                           emb=hp["bench"].emb, k=args.k,
                           models=tuple(models), built=models,
                           row_walks=row_walks, walls=walls)


def check_roster(ev) -> dict:
    """The roster table's orderings (those of JAX's
    results/hard_roster_accuracy.csv): the Hybrid row at least its
    PinSage row on hr@100 and PageRankCo on hr@500, PageRankCo over
    PageRank on hr@10, and PageRank, both TrackTrackCf rows and the
    co-listen PinSage row over Features over Random on hr@100.  Returns
    both tables."""
    acc = read_csv_rows(os.path.join(ev.eval_dir, "results_accuracy.csv"))
    beyond = read_csv_rows(os.path.join(ev.eval_dir, "results_beyond.csv"))
    hybrid, pinsage = f"Hybrid:{ROSTER_CO}", f"PinSage:{ROSTER_CO}"

    def hr(row, k):
        return acc[row][f"hr (k={k})"]

    missed = []
    for a, b, k, strict in ((hybrid, pinsage, 100, False),
                            (hybrid, "PageRankCo", 500, False),
                            ("PageRankCo", "PageRank", 10, True),
                            ("Features", "Random", 100, True),
                            *((row, "Features", 100, True) for row in (
                                "PageRank", "TrackTrackCfALS",
                                "TrackTrackCfBPR", pinsage))):
        if not (hr(a, k) > hr(b, k) if strict else hr(a, k) >= hr(b, k)):
            missed.append(f"{a} {hr(a, k)} vs {b} {hr(b, k)} at hr@{k}")
    if missed:
        raise AssertionError(f"roster orderings missed: {missed}")
    log(f"roster orderings hold over {len(acc)} rows at K={ev.k}")
    return {"accuracy": acc, "beyond": beyond, "k": ev.k}


# ---- the repository tools (grid_refschedule, fullgraph_bench) ------------
# on the hard phase's dataset and PPR caches (the plain one and the co-listen
# phase's; grid_refschedule's hard catalog is that dataset byte for byte,
# tests/test_torch_grid_refschedule.py).  Cuts for the script's time limit,
# each run uncut as a command of its own (README): the grid's colisten
# schedule to TOOLS_GRID at 1 x 500, the ref schedule's first 4-layer point
# (its grid id 0.0.0.1) to REF_L4_STEPS steps and its embed on the main
# path's uniform catalog (512-d features, as the ref schedule's uniform
# catalog has; the hard one's are 128-d), fullgraph_bench to chunks of 5
# and 25 batches without the 1M embed
TOOLS_GRID = {"train.margin": [1e-5], "train.lr": [1e-3],
              "walk.colisten_copies": [0, 1], "model.T": [3]}
TOOLS_GRID_CUT = {"train.epochs": 1, "train.batches_per_epoch": 500}
REF_L4 = {"train.margin": 0.1, "train.lr": 1e-4,
          "train.hard_negatives": False, "model.n_layers": 4}
REF_L4_STEPS = 3
FG_ARGV = ("--skip-embed", "--chunk-small", "5", "--chunk-large", "25")
FG_HOLD_B = 4096          # the frontier step whose K3 shapes are held


def run_tools_path(dev, st, hp, work: str) -> dict:
    """The tools on ``dev``, each with the launch counters set to 0 first:
    ``grid_refschedule.run`` (colisten schedule, hard) on a copy of the
    hard phase's dataset and caches, cut to TOOLS_GRID (K3 and its
    backward every step, K2 in each embed); the ref schedule's 4-layer
    config on the main path's catalog (its plain graph's sweep with K1,
    in memory), REF_L4_STEPS steps (K3 at L=4) and the embed (K2 over
    four layers); ``fullgraph_bench.run`` with FG_ARGV (K3 in the off
    arms, K2 and its backward in the on arms).  Fails unless the grid
    wrote JAX's keys sorted by MRR with the co-listen config above the
    plain one, every kernel of each path ran and every output is finite.
    Returns its state."""
    import math

    import numpy as np
    import torch

    from gcn_song_embeddings_tpu_torch import fullgraph_bench as fb
    from gcn_song_embeddings_tpu_torch import grid_refschedule as gr
    from gcn_song_embeddings_tpu_torch.config import (
        RunConfig,
        config_with_overrides,
    )
    from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
    from gcn_song_embeddings_tpu_torch.train.trainer import PinSageTrainer

    hb = hp["bench"]
    tools = os.path.join(work, "tools")
    shutil.rmtree(tools, ignore_errors=True)
    grid_work = os.path.join(tools, "grid")
    ds = os.path.join(grid_work, "ds")
    shutil.copytree(hb.ds_path, ds)
    with open(os.path.join(ds, "dataset_kind.txt"), "w") as f:
        f.write("hard")
    walls, counts = {}, {}

    reset_kernel_counts()
    t = time.perf_counter()
    results = gr.run(gr.parse_args([
        "--schedule", "colisten", "--dataset-kind", "hard", "--work-dir",
        grid_work, "--device", str(dev)]), log,
        base_overrides=TOOLS_GRID_CUT, grid=TOOLS_GRID)
    sync(torch, dev)
    walls["grid_s"] = time.perf_counter() - t
    counts["grid"] = kernel_counts()
    with open(os.path.join(grid_work, "grid_search_colisten_hard.json")) as f:
        written = json.load(f)
    mrr = {r["params"]["walk.colisten_copies"]: r["mrr"] for r in written}
    if (written != results or [set(r) for r in written]
            != [{"id", "params", "mrr", "hit_rate"}] * 2
            or [r["mrr"] for r in written]
            != sorted((r["mrr"] for r in written), reverse=True)
            or not all(math.isfinite(r["mrr"]) for r in written)
            or not mrr[1] > mrr[0]):
        raise AssertionError(f"grid: {written}")
    log(f"grid (colisten, hard, cut): {json.dumps(written)}")

    reset_kernel_counts()
    t = time.perf_counter()
    if gr.schedule("ref", "uniform")[2]["model.n_layers"] != [2, 4]:
        raise AssertionError("the ref schedule has no 4-layer point")
    cfg = config_with_overrides(RunConfig(run_name="ref_L4"), {
        **REF_L4, "train.epochs": 1,
        "train.batches_per_epoch": REF_L4_STEPS})
    g = st.graph
    l4 = PinSageTrainer(DeviceGraph.from_graph(g, dev), g.n_items,
                        g.features, st.train_pos, cfg=cfg,
                        base_run_dir=os.path.join(tools, "runs"),
                        log=False, load_save=False, verbose=False)
    if l4.fullgraph:
        raise AssertionError("the 4-layer config trains full-graph")
    l4.train()
    emb = l4.embed()
    sync(torch, dev)
    walls["ref_L4_steps_and_embed_s"] = time.perf_counter() - t
    counts["grid_ref_L4"] = kernel_counts()
    if emb.shape != (g.n_items, cfg.model.out_dim) or not np.isfinite(
            emb).all():
        raise AssertionError(f"ref L=4 embeddings: shape {emb.shape}")

    reset_kernel_counts()
    t = time.perf_counter()
    fg = fb.run(fb.parse_args([*FG_ARGV, "--device", str(dev)]), log)
    walls["fullgraph_bench_s"] = time.perf_counter() - t
    counts["fullgraph_bench"] = kernel_counts()
    log(f"fullgraph_bench (cut): {json.dumps(fg)}")
    log(f"fullgraph_bench: auto picks the measured winner "
        f"{json.dumps(fg['auto_picks_winner'])}")
    bad = [k for k, v in fg.items() if k.endswith("_ms")
           and not (math.isfinite(v) and v > 0)]
    sizes = {f"B{b}" for b in fb.parse_args(list(FG_ARGV)).batches}
    if bad or set(fg["auto_picks_winner"]) != sizes:
        raise AssertionError(f"fullgraph_bench: {fg}")
    need = {"grid": ("dma_agg", "agg_backward_dma", "agg"),
            "grid_ref_L4": ("walk", "dma_agg", "agg_backward_dma", "agg"),
            "fullgraph_bench": ("dma_agg", "agg_backward_dma", "agg",
                                "agg_backward_stream")}
    for path, names in need.items():
        missing = [k for k in names if counts[path][k] == 0]
        if missing:
            raise AssertionError(f"{path}: kernels never launched {missing}")
        log(f"launches on the {path} path: {counts[path]}")
    return {"grid": written, "fullgraph_bench": fg, "ref_L4": l4,
            "counts": counts, "walls": walls}


def hold_tools_kernels(torch, tools) -> list:
    """K3 with its backward at the tools' new shapes against their plain
    versions (``measure_aggregation``: K2_ATOL, GRAD_RTOL): every
    aggregation of one frontier step of the ref schedule's 4-layer config
    and of fullgraph_bench's B=FG_HOLD_B step on its own data.  Returns
    the kernels line's rows."""
    import types

    import numpy as np

    from gcn_song_embeddings_tpu_torch import fullgraph_bench as fb
    from gcn_song_embeddings_tpu_torch.ops import agg, dma_agg
    from gcn_song_embeddings_tpu_torch.ops.ppr import block_generator
    from gcn_song_embeddings_tpu_torch.train.trainer import (
        TrainTables,
        sample_train_batch,
    )

    l4, counts = tools["ref_L4"], tools["counts"]
    dev = l4.device
    rows = []
    features, nb_n, nb_w, positives = fb.bench_data(
        np.random.default_rng(0), fb.parse_args([]).tracks)
    tables = TrainTables.build(features, nb_w, nb_n, fb.T, dev)
    cfg = fb.strategy_config(FG_HOLD_B, "off")
    fg = types.SimpleNamespace(cfg=cfg, tables=tables,
                               params=fb.seeded_params(dev, fb.FEAT))
    batch = sample_train_batch(block_generator(4242, 0, dev),
                               torch.as_tensor(positives, device=dev),
                               tables, cfg.train, len(features), 0)
    for name, trainer, b, path in (
            ("the ref schedule's 4-layer step", l4, None, "grid_ref_L4"),
            (f"fullgraph_bench's B={FG_HOLD_B} frontier step", fg, batch,
             "fullgraph_bench")):
        if b is None:
            b = trainer.sample(block_generator(4242, 0, dev))
        mcfg = trainer.cfg.model
        shapes = step_conv_inputs(torch, trainer, b)
        k3 = measure_aggregation(torch, agg, "dma", shapes)
        rows.append(kernel_row(
            f"K3 fused 3xTF32 gather + Q-MLP + weighted mean "
            f"(agg.conv_aggregate, mode dma) at {name}", dma_agg.SOURCE,
            dma_agg.REPLACES, {f"{path}_steps": counts[path]["dma_agg"]},
            counts[path]["agg_backward_dma"], k3,
            f"every aggregation of a frontier step at B="
            f"{trainer.cfg.train.batch_size}, L={mcfg.n_layers}, T="
            f"{mcfg.T}, H={mcfg.hidden_dim}: " + ", ".join(
                f"{ids.shape[0]} nodes Din={table.shape[1]} (table "
                f"{table.shape[0]} rows)" for _, table, ids, _, _ in shapes)))
        del shapes
        torch.cuda.empty_cache()
    return rows


# ---- the bench module (bench.py's throughput, FLOP-bound and roofline
# measurement), cut: chunks of 10 / 50 at the headline, 2 / 10 at the
# FLOP-bound shape, one repetition (the probes at their own rep counts)
BENCH_ARGV = ("--chunk-small", "10", "--chunk-large", "50",
              "--fb-chunk-small", "2", "--fb-chunk-large", "10",
              "--reps", "1")
# the keys of an uncut run (no --skip-probes, no --fresh-baseline)
BENCH_KEYS = {
    "metric", "value", "unit", "vs_baseline", "warmup_s", "kernel_build",
    "warm_step_ms", "edges_per_step", "flopbound_tflops",
    "flopbound_mfu_vs_ceiling", "flopbound_bound_ms", "flopbound_step_ms",
    "flopbound_bf16_tflops", "flopbound_bf16_mfu_vs_ceiling",
    "flopbound_bf16_bound_ms", "flopbound_bf16_step_ms",
    "flopbound_contig_step_ms", "flopbound_roofline_ratio",
    "roofline_pred_ms", "hbm_stream_gbps", "gather_mrows_per_s",
    "gather_wide_row_ratio", "gather_bf16_row_ratio", "flopbound_config",
    "platform", "card"}
BENCH_SHARE_MAX = 1.05   # a share of the bound above this: the count errs
BENCH_EDGES = 5760       # bench.py's edges_per_step at B=128, L=2, T=3


def positive_leaves(value) -> bool:
    """Every number in ``value`` (nested dicts) finite and > 0, every
    string non-empty, nothing None."""
    import math

    if isinstance(value, dict):
        return all(positive_leaves(v) for v in value.values())
    if isinstance(value, str):
        return bool(value)
    return (isinstance(value, (int, float)) and not isinstance(value, bool)
            and math.isfinite(value) and value > 0)


def run_bench_path(dev) -> dict:
    """``bench.run`` on ``dev`` cut to BENCH_ARGV, with the launch counters
    set to 0 first: the headline step (K3 and its backward), the FLOP-bound
    step in f32 (K2 and its backward), in bf16 (K2's 16-bit form) and on
    contiguous ids, the gather and stream yardsticks.  Fails unless its
    JSON has an uncut run's keys, ``edges_per_step`` is BENCH_EDGES, every
    value is finite and positive, both shares of the bound are at most
    BENCH_SHARE_MAX, the contiguous control ran, every kernel of the path
    ran and ``BENCH_BASELINE.json`` is byte for byte as it was."""
    import torch

    from gcn_song_embeddings_tpu_torch import bench

    with open(bench.BASELINE_PATH, "rb") as f:
        baseline = f.read()
    reset_kernel_counts()
    t = time.perf_counter()
    out = bench.run(bench.parse_args([*BENCH_ARGV, "--device", str(dev)]))
    sync(torch, dev)
    wall = time.perf_counter() - t
    counts = kernel_counts()
    log(f"bench (cut): {json.dumps(out)}")
    with open(bench.BASELINE_PATH, "rb") as f:
        baseline_kept = f.read() == baseline
    need = ("dma_agg", "agg_backward_dma", "agg", "agg_split", "agg_project",
            "agg_gather_mean", "agg_backward_stream", "agg_bf16",
            "agg_bf16_project", "agg_backward_stream_bf16", "probe_gather",
            "probe_l2")
    checks = {
        "keys_as_uncut": set(out) == BENCH_KEYS,
        "edges_per_step": out.get("edges_per_step") == BENCH_EDGES,
        "finite_and_positive": positive_leaves(out),
        "shares_at_most_1.05": all(
            out.get(k, 2.0) <= BENCH_SHARE_MAX
            for k in ("flopbound_mfu_vs_ceiling",
                      "flopbound_bf16_mfu_vs_ceiling")),
        "contiguous_control_ran": out.get("flopbound_contig_step_ms", 0) > 0,
        "baseline_file_unchanged": baseline_kept,
        "kernels_launched": all(counts[k] > 0 for k in need)}
    log(f"launches on the bench path: {counts}")
    if not all(checks.values()):
        raise AssertionError(f"bench: {checks}; {out}")
    return {"bench": out, "checks": checks, "counts": counts,
            "walls": {"bench_s": wall}}


def probe_row(torch, name, kernel, plain, read, library, nbytes, flops,
              launches, shape) -> dict:
    """A yardstick's entry of the ``kernels`` line: its 0-d sum held
    against the float64 sum of what it reads (``read`` [the entries in
    float64]: within 1e-6 of the sum of their magnitudes), its times
    beside its plain version's and the library call's, and its bound."""
    from gcn_song_embeddings_tpu_torch.ops import agg

    got = float(kernel())
    want, scale = float(read.sum()), float(read.abs().sum())
    err = abs(got - want)
    log(f"{name}: {got:.6g} vs float64 {want:.6g}, |diff| / sum|x| "
        f"{err / scale:.3g}")
    if not err <= 1e-6 * scale:
        raise AssertionError(f"{name} differs from the float64 sum by "
                             f"{err} (sum |x| {scale})")
    bound_ms, bound_by = bound(flops, nbytes)
    return {"name": name, "route": "cuda", "source": agg.SOURCE,
            "replaces": "none (not a port kernel: a yardstick of bench.py)",
            "launches": launches, "launches_by_path": {"bench": launches},
            "max_abs_err": err, "rel_err_of_abs_sum": err / scale,
            "ms": cuda_ms(torch, kernel, reps=10),
            "host_ms": cuda_ms(torch, kernel, reps=10, queued=False),
            "plain_ms": cuda_ms(torch, plain, reps=3),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": cuda_ms(torch, library, reps=10),
            "shape": shape}


def hold_bench_kernels(torch, bp, dev) -> list:
    """The kernels at the bench's shapes against their plain versions:
    K3 with its backward at both aggregations of a headline step (B=128,
    T=3, Din 512 then 128, H 512), K2 with its backward and K2's bf16
    form at the four full-graph layers of the FLOP-bound step (N=20,000,
    T=3, Din 512 then 256, H 1024), and the two yardsticks (one gather
    pass of 60,000 random rows of a 20,000 x 1024 f32 table; one read of
    the 256 MiB stream array).  Returns the kernels line's rows."""
    import types

    import numpy as np
    import torch.nn.functional as F

    from gcn_song_embeddings_tpu_torch import bench
    from gcn_song_embeddings_tpu_torch.models.pinsage import (
        cast_params,
        conv_from_table,
        init_pinsage,
    )
    from gcn_song_embeddings_tpu_torch.ops import agg, dma_agg
    from gcn_song_embeddings_tpu_torch.ops.ppr import block_generator
    from gcn_song_embeddings_tpu_torch.train.trainer import (
        TrainTables,
        sample_train_batch,
    )

    counts = bp["counts"]
    features, nb_w, nb_n, positives = bench.build_problem()
    n = len(features)
    rows = []

    def seeded(mcfg):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return init_pinsage(gen, mcfg.n_layers, bench.FEAT_DIM,
                            mcfg.hidden_dim, mcfg.out_dim)

    cfg = bench.headline_config()
    tables = TrainTables.build(features, nb_w, nb_n, bench.T, dev)
    step = types.SimpleNamespace(cfg=cfg, tables=tables,
                                 params=seeded(cfg.model))
    batch = sample_train_batch(block_generator(4242, 0, dev),
                               torch.as_tensor(positives, device=dev),
                               tables, cfg.train, n, 0)
    shapes = step_conv_inputs(torch, step, batch)
    k3 = measure_aggregation(torch, agg, "dma", shapes)
    rows.append(kernel_row(
        "K3 fused 3xTF32 gather + Q-MLP + weighted mean "
        "(agg.conv_aggregate, mode dma) at the bench's headline step",
        dma_agg.SOURCE, dma_agg.REPLACES,
        {"bench_headline": counts["dma_agg"]}, counts["agg_backward_dma"],
        k3, "both aggregations of a frontier step at B=128, L=2, T=3, "
        "H=512: " + ", ".join(
            f"{ids.shape[0]} nodes Din={table.shape[1]} (table "
            f"{table.shape[0]} rows)" for _, table, ids, _, _ in shapes)))
    del shapes, step

    fb = bench.flopbound_config().model
    params = seeded(fb)
    nb_idx = tables.nbhd_n[:, :bench.T].contiguous()
    nb_wt = tables.nbhd_w[:, :bench.T].contiguous()
    shapes, h = [], tables.features
    with torch.inference_mode():
        for l, layer in enumerate(params.layers):
            shapes.append((layer, h, nb_idx, nb_wt, l > 0))
            h = conv_from_table(layer, h, h, nb_idx, nb_wt)
    k2 = measure_aggregation(torch, agg, "stream", shapes)
    shape = (f"the {fb.n_layers} full-graph layers of the FLOP-bound step, "
             f"N={n} T={bench.T}: Din=" + ", ".join(
                 str(x[1].shape[1]) for x in shapes)
             + f", H={fb.hidden_dim}")
    rows.append(kernel_row(
        "K2 3xTF32 Q-MLP of every table row, then gather + weighted mean "
        "(agg.conv_aggregate, mode stream) at the bench's FLOP-bound step",
        agg.SOURCE, agg.REPLACES,
        {"bench_flopbound_f32_and_contig": counts["agg"]},
        counts["agg_backward_stream"], k2,
        shape + "; backward at the same shapes (dh after the first layer)"))
    rows[-1]["header"] = agg.HEADER
    del shapes

    pc = cast_params(params, torch.bfloat16)
    wt16 = nb_wt.to(torch.bfloat16)
    shapes16, h = [], tables.features.to(torch.bfloat16)
    with torch.inference_mode():
        for layer in pc.layers:
            shapes16.append((h, nb_idx, wt16, layer.Wq.detach(),
                             layer.bq.detach().float()))
            h = conv_from_table(layer, h, h, nb_idx, wt16).to(torch.bfloat16)
    k2_16 = measure_aggregation16(torch, agg, "stream", shapes16)
    rows.append(kernel_row16(
        "K2 bf16 Q-MLP of every table row, then gather + weighted mean "
        "(agg.conv_aggregate on a bf16 table, mode stream) at the bench's "
        "FLOP-bound step", agg.SOURCE, agg.REPLACES,
        {"bench_flopbound_bf16": counts["agg_bf16"]},
        counts["agg_backward_stream_bf16"], k2_16,
        shape + "; bf16 rows (each layer's output stored in bf16), Wq and "
        "weights"))
    rows[-1]["header"] = agg.HEADER
    del shapes16, h, params, pc
    torch.cuda.empty_cache()

    d, n_idx = 1024, n * bench.T
    rng = np.random.default_rng(7)
    idx = torch.as_tensor(rng.integers(0, n, n_idx).astype(np.int32),
                          device=dev)
    table = torch.as_tensor(np.random.default_rng(8).normal(
        size=(n, d)).astype(np.float32), device=dev)
    bag = torch.zeros(1, dtype=torch.long, device=dev)
    rows.append(probe_row(
        torch, "gather_probe_kernel (agg.gather_read_probe): one pass of "
        "random rows summed, never written back",
        lambda: agg.gather_read_probe(table, idx, 1),
        lambda: agg.gather_read_probe_plain(table, idx, 1),
        table.double()[idx.long()],
        lambda: F.embedding_bag(idx, table, bag, mode="sum"),
        4.0 * (n * d + n_idx), float(n_idx * d), counts["probe_gather"],
        f"{n_idx} random rows (ids of bench.py's draw) of a {n} x {d} f32 "
        f"table, one pass; library: one embedding_bag sum"))
    del table
    x = torch.rand(bench.STREAM_MIB * 1024 * 1024 // 4, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(3))
    rows.append(probe_row(
        torch, "l2_probe_kernel (agg.l2_read_probe): one read of an "
        "array larger than L2", lambda: agg.l2_read_probe(x, 1).sum(),
        lambda: x.sum(dtype=torch.float32), x.double(),
        lambda: x.sum(), 4.0 * x.numel(), float(x.numel()),
        counts["probe_l2"],
        f"{bench.STREAM_MIB} MiB f32, one pass; library: torch.sum"))
    del x
    torch.cuda.empty_cache()
    return rows

# ---- the 1M-track catalog (scale_demo, refresh_1m, hybrid_1m, serve_bench)
# scale_demo's co-listen capstone (RESULTS.md:713-716) with its 1,000,000
# positives and 128-d features (results/scale_1m_co.out)
SCALE_1M_ARGV = ("--hard", "--tracks", "1000000", "--collections", "250000",
                 "--positives", "1000000", "--feature-dim", "128",
                 "--colisten-copies", "1", "--T", "10")
# cuts for the script's time limit, each run uncut as a command of its own
# (README): the refresh at 100 and 1,000 new pairs (not 10,000), the
# hybrid's lists for a seeded sample of the unique test queries (scored on
# all their pairs), serving 20 queries a client (not 50)
REFRESH_1M_COUNTS = "100,1000"
HYBRID_1M_QUERIES = 32_768
SERVE_1M_TRACKS = 1_000_000
SERVE_1M_LOAD = ("--queries", "20", "--clients", "8")
SERVE_1M_FORMS = {"f32": (), "int8": ("--int8",),
                  "hybrid_cached": ("--hybrid", "--cached-head")}
EXACT_ROWS = 64       # f32 answers held against an exact top-k on the card
TV_GAP = 0.01         # |TV(refresh, full) - TV(seed noise)| at most this
# the JAX package's readings at 1M (a TPU's), for reference only
JAX_1M = {
    "scale_1m_co": {"pinsage": {"hit@100": 0.47833, "hit@500": 0.71468,
                                "mrr@1000": 0.08004},
                    "features": {"hit@100": 0.06859, "hit@500": 0.35077,
                                 "mrr@1000": 0.00526},
                    "pinsage_over_features_hit100": 6.974},
    "hybrid_1m": {name: dict(zip(("hit@10", "hit@100", "hit@500",
                                  "mrr@1000"), row))
                  for name, row in (("walk", (0.38293, 0.67899, 0.78379,
                                              0.18972)),
                                    ("embedding", (0.21003, 0.47463,
                                                   0.73763, 0.08758)),
                                    ("hybrid", (0.38293, 0.67921, 0.85461,
                                                0.1899)))},
    "refresh_1m": {"affected_frac": {"100": 0.01903, "1000": 0.18244,
                                     "10000": 0.85683},
                   "tv_refresh_vs_full": 0.29233, "tv_seed_noise": 0.29246},
}


def start_1m_dataset(root: str, scale_argv=SCALE_1M_ARGV):
    """Write the 1M phase's dataset into ``<root>/ds`` in a process of its
    own (``scale_demo.make_dataset``: host numpy and JSON, no device)
    while the earlier phases run; ``run_1m_path`` waits for it and its
    ``scale_demo`` reuses the complete dataset.  Its wall goes to
    ``<root>/synth_s``, its output to ``<root>/synth.log``."""
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    code = ("import sys, time\n"
            "from gcn_song_embeddings_tpu_torch import scale_demo\n"
            "t = time.perf_counter()\n"
            "scale_demo.make_dataset(scale_demo.parse_args(sys.argv[2:]),\n"
            "                        sys.argv[1] + '/ds')\n"
            "with open(sys.argv[1] + '/synth_s', 'w') as f:\n"
            "    f.write(repr(time.perf_counter() - t))\n")
    with open(os.path.join(root, "synth.log"), "w") as out:
        return subprocess.Popen(
            [sys.executable, "-c", code, root, *scale_argv], cwd=REPO,
            stdout=out, stderr=subprocess.STDOUT,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def run_1m_path(dev, root: str, scale_argv=SCALE_1M_ARGV,
                refresh_counts: str = REFRESH_1M_COUNTS,
                serve_tracks: int = SERVE_1M_TRACKS,
                serve_argv=SERVE_1M_LOAD, hybrid_queries=HYBRID_1M_QUERIES,
                synth=None) -> dict:
    """The 1M catalog as a user runs it, in the work dir ``root``:
    ``scale_demo`` (synth -> graph -> PPR sweep of the co-listen augmented
    graph (K1) -> 3 x 500 frontier steps (K3 and its backward) ->
    full-graph embed (K2) -> ``rank_eval`` of PinSage and of the raw
    features), then ``refresh_1m`` on its standing artifact (K1),
    ``hybrid_1m`` on its finished run for ``hybrid_queries`` unique test
    queries (None: all; K2 in the resume's embed, K1 for the walk lists),
    and ``serve_bench`` over a 1M x 128 catalog in f32, int8 and
    cached-head hybrid form (K1 in the head's sweep), then K4 on the int8
    run's served table.  ``synth``: the ``start_1m_dataset`` process
    writing the dataset, waited for here (None: ``scale_demo`` writes it
    into a fresh ``root``).  Launches are counted by path
    (``scale_demo``'s by its phases); the peak device memory is the
    phase's."""
    import contextlib

    import torch

    from gcn_song_embeddings_tpu_torch import (
        hybrid_1m,
        refresh_1m,
        scale_demo,
        serve_bench,
    )
    from gcn_song_embeddings_tpu_torch.evals.device_eval import unit_rows
    from gcn_song_embeddings_tpu_torch.ops.quant_kernel import (
        quantize_rows_stochastic,
    )
    from gcn_song_embeddings_tpu_torch.utils.profiling import Timer

    counts, last = {}, kernel_counts()

    def mark(path):
        nonlocal last
        now = kernel_counts()
        acc = counts.setdefault(path, dict.fromkeys(now, 0))
        for key in now:
            acc[key] += now[key] - last[key]
        last = now

    class CountingTimer(Timer):
        """``scale_demo``'s timer, counting launches by its phases."""

        @contextlib.contextmanager
        def phase(self, name, sync_value=None):
            with super().phase(name, sync_value):
                yield
            mark(name)

    walls = {}
    if synth is None:
        shutil.rmtree(root, ignore_errors=True)
    else:
        t = time.perf_counter()
        if synth.wait() != 0:
            with open(os.path.join(root, "synth.log")) as f:
                raise AssertionError(f"the 1M dataset's process failed: "
                                     f"{f.read()[-3000:]}")
        walls["synth_waited_s"] = time.perf_counter() - t
        with open(os.path.join(root, "synth_s")) as f:
            walls["synth_s"] = float(f.read())
    sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    sd = scale_demo.run(scale_demo.parse_args(
        [*scale_argv, "--work-dir", root, "--device", str(dev)]), log,
        timer=CountingTimer())
    walls["scale_demo_s"] = time.perf_counter() - t
    walls["scale_demo"] = sd.times
    log(json.dumps({"scale_demo": sd.summary}))

    t = time.perf_counter()
    rf = refresh_1m.run(refresh_1m.parse_args(
        ["--work-dir", root, "--pair-counts", refresh_counts,
         "--device", str(dev)]), data=sd.data, log=log)
    mark("refresh")
    walls["refresh_1m_s"] = time.perf_counter() - t
    walls["refresh_standing_load_s"] = rf.standing_s
    log(json.dumps({"refresh_1m": rf.result}))

    t = time.perf_counter()
    hy = hybrid_1m.run(hybrid_1m.parse_args(
        ["--work-dir", root, "--device", str(dev)]), data=sd.data, log=log,
        query_sample=hybrid_queries)
    mark("hybrid")
    walls["hybrid_1m_s"] = time.perf_counter() - t
    walls["hybrid_1m"] = hy.walls
    log(json.dumps({"hybrid_1m": hy.result}))

    serving = {}
    for form, extra in SERVE_1M_FORMS.items():
        t = time.perf_counter()
        serving[form] = serve_bench.run(serve_bench.parse_args(
            ["--tracks", str(serve_tracks), *extra, *serve_argv,
             "--device", str(dev)]), log)
        mark("int8" if form == "int8" else "serve")
        walls[f"serve_bench_{form}_s"] = time.perf_counter() - t
        log(json.dumps({f"serve_bench_{form}": serving[form].summary}))
    # the int8 run's served table, quantized with stochastic rounding (K4)
    table = torch.as_tensor(unit_rows(serving["int8"].emb), device=dev)
    sync(torch, dev)
    t = time.perf_counter()
    stochastic = quantize_rows_stochastic(table, seed=QUANT_SEED)
    sync(torch, dev)
    mark("int8")
    walls["stochastic_quantize_ms"] = (time.perf_counter() - t) * 1e3
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    # the launches on each path (scale_demo's by its phases), nonzero only
    named = {"precompute": "sweep", "train": "train", "embed": "embed",
             "refresh": "refresh", "hybrid": "hybrid", "serve": "serve",
             "int8": "int8"}
    by_path = {named[p]: {k: n for k, n in counts.get(p, {}).items() if n}
               for p in named}
    other = {p: {k: n for k, n in c.items() if n}
             for p, c in counts.items() if p not in named}
    return {"scale": sd, "refresh": rf, "hybrid": hy, "serving": serving,
            "table": table, "stochastic": stochastic, "walls": walls,
            "counts": by_path, "other_counts": other,
            "peak_device_bytes": peak, "work": root}


def exact_topk_check(torch, np, emb, answers, dev, n_rows: int,
                     k: int) -> dict:
    """The served f32 answers of ``n_rows`` queries against an exact f32
    top-k of the same catalog on ``dev`` (the query masked), up to ties."""
    from gcn_song_embeddings_tpu_torch.evals.device_eval import unit_rows
    from gcn_song_embeddings_tpu_torch.ops.knn import exact_f32

    rows = sorted(answers)[:n_rows]
    unit = torch.as_tensor(unit_rows(emb), device=dev)
    r = torch.as_tensor(rows, device=dev)
    with exact_f32():
        sims = unit[r] @ unit.t()
    sims[torch.arange(len(rows), device=dev), r] = float("-inf")
    w, n = torch.topk(sims, k, dim=1)
    got_n = np.array([answers[q][0] for q in rows])
    got_w = np.array([answers[q][1] for q in rows])
    out = same_up_to_ties(np, "served f32 answers vs exact top-k",
                          got_w, got_n, w.cpu().numpy(), n.cpu().numpy())
    return {"rows": len(rows), **out}


def check_1m(torch, dev, p) -> dict:
    """The 1M phase's bars: every kernel launched on its path (and the
    full-graph embed in more than one ``block_rows`` block a layer),
    PinSage / raw features at least HARD_BAR on hit@100 and mrr@1000, the
    hybrid at least the walk row on hit@10/100/500, every unaffected row
    of each refresh equal to the standing artifact and the refresh's TV
    within TV_GAP of the seed noise's, the f32 answers equal to an exact
    top-k up to ties; the int8 answers' top-10 overlap with f32 is
    printed.  Returns the ``scale_1m_checks`` line's payload."""
    import inspect

    import numpy as np

    from gcn_song_embeddings_tpu_torch.models.pinsage import embed_all

    need = {"sweep": "walk", "train": "dma_agg", "embed": "agg",
            "refresh": "walk", "hybrid": "walk", "serve": "walk",
            "int8": "quant"}
    missing = {path: key for path, key in need.items()
               if not p["counts"][path].get(key)}
    if not p["counts"]["train"].get("agg_backward_dma"):
        missing["train"] = "agg_backward_dma"
    if missing:
        raise AssertionError(f"1M phase: kernels never launched {missing}")
    sd = p["scale"]
    n = sd.data.graph.n_items
    n_layers = sd.trainer.cfg.model.n_layers
    block_rows = inspect.signature(embed_all).parameters[
        "block_rows"].default
    blocks = -(-n // block_rows)
    gathers = p["counts"]["embed"].get("agg_gather_mean", 0)
    if not (blocks > 1 and gathers == n_layers * blocks):
        raise AssertionError(f"the 1M embed gathered in {gathers} launches, "
                             f"not {n_layers} layers x {blocks} blocks of "
                             f"{block_rows}")
    feat, ps = sd.metrics["features"], sd.metrics["pinsage"]
    ratios = {k: ps[k] / feat[k] for k in ("hit@100", "mrr@1000")}
    log(f"1M learning: raw features {feat}; PinSage {ps}; PinSage / "
        f"features {ratios} (JAX at 1M: "
        f"{JAX_1M['scale_1m_co']['pinsage_over_features_hit100']}x on "
        f"hit@100, features {JAX_1M['scale_1m_co']['features']})")
    low = {k: v for k, v in ratios.items() if not v >= HARD_BAR}
    if low:
        raise AssertionError(f"1M PinSage / features below {HARD_BAR}: {low}")
    rows = p["hybrid"].rows
    behind = {k: (rows["hybrid"][k], rows["walk"][k])
              for k in ("hit@10", "hit@100", "hit@500")
              if not rows["hybrid"][k] >= rows["walk"][k]}
    if behind:
        raise AssertionError(f"1M hybrid behind the walk row: {behind}")
    rf = p["refresh"]
    if not all(rf.unaffected_equal.values()):
        raise AssertionError(f"refresh changed unaffected rows: "
                             f"{rf.unaffected_equal}")
    tv_gap = abs(rf.result["tv_refresh_vs_full"]
                 - rf.result["tv_seed_noise"])
    if not tv_gap <= TV_GAP:
        raise AssertionError(f"refresh TV {rf.result['tv_refresh_vs_full']} "
                             f"vs seed noise {rf.result['tv_seed_noise']}: "
                             f"gap {tv_gap} > {TV_GAP}")
    serving = p["serving"]
    f32 = serving["f32"]
    exact = exact_topk_check(torch, np, f32.emb, f32.answers, dev,
                             EXACT_ROWS, 10)
    int8 = serving["int8"].answers
    common = sorted(set(f32.answers) & set(int8))
    overlap = float(np.mean([len(set(f32.answers[q][0])
                                 & set(int8[q][0])) / 10 for q in common]))
    log(f"1M serving: f32 answers of {exact['rows']} queries == exact top-10 "
        f"up to ties ({exact}); int8 top-10 overlap with f32 over "
        f"{len(common)} queries {overlap:.4f}")
    return {
        "config": {"argv": list(SCALE_1M_ARGV), "tracks": n,
                   "edges": sd.summary["n_edges"],
                   "test_pairs": int(len(sd.data.test_pos)),
                   "refresh_pair_counts": REFRESH_1M_COUNTS,
                   "hybrid_queries": int(len(p["hybrid"].queries)),
                   "hybrid_test_pairs": p["hybrid"].result["n_test_pairs"],
                   "serve_tracks": SERVE_1M_TRACKS},
        "launches_by_path": p["counts"], "other_launches": p["other_counts"],
        "embed_blocks": {"block_rows": block_rows, "blocks_a_layer": blocks,
                         "gather_launches": gathers},
        "features": feat, "pinsage": ps, "pinsage_over_features": ratios,
        "bar": HARD_BAR, "hybrid_rows": rows,
        "refresh": {**rf.result, "unaffected_equal": rf.unaffected_equal,
                    "tv_gap": tv_gap, "tv_gap_bar": TV_GAP},
        "serving": {form: {**b.summary, "table_device_bytes": b.table_bytes,
                           "setup_s": b.setup}
                    for form, b in serving.items()},
        "serving_exact_topk": exact, "int8_top10_overlap": overlap,
        "peak_device_bytes": p["peak_device_bytes"],
        "jax_reference": JAX_1M, "walls": p["walls"],
    }


def hold_1m_kernels(torch, p) -> dict:
    """The 1M phase's kernels against their plain versions at its shapes:
    K1 (``measure_k1``, ``torch.equal``) at the first block of the sweep
    of the augmented 1M graph (B=8192, H=500, the sweep's uniforms; its
    top-100 equal to the standing artifact's rows) and at the hybrid's
    first query block (B=4096, H=1000, its uniforms; the top-1000 of the
    plain trace equal to the hybrid's walk lists); K2 at both embed layers
    of all 1M rows in ``block_rows`` blocks (the plain version block by
    block) within K2_ATOL; K3 and its backward at both aggregations of one
    frontier step of the trained model (``measure_aggregation``); K4 on
    the served 1M x 128 table (``measure_k4``).  Returns the kernels
    line's 1M rows."""
    import inspect

    import numpy as np

    from gcn_song_embeddings_tpu_torch.hybrid_1m import (
        WALK_ALPHA,
        WALK_BLOCK,
        WALK_HOPS,
        padded_block,
    )
    from gcn_song_embeddings_tpu_torch.models.pinsage import (
        conv_from_table,
        embed_all,
    )
    from gcn_song_embeddings_tpu_torch.ops import (
        agg,
        dma_agg,
        quant_kernel,
        walk_kernel,
    )
    from gcn_song_embeddings_tpu_torch.ops.ppr import (
        block_generator,
        visit_counts_topt,
    )
    from gcn_song_embeddings_tpu_torch.ops.walks import (
        draw_uniforms,
        fused_walk_tables,
        walks_from_fused_tables,
    )

    sd, hy, counts = p["scale"], p["hybrid"], p["counts"]
    trainer = sd.trainer
    dev, cfg, mcfg = trainer.device, trainer.cfg, trainer.cfg.model
    tables = fused_walk_tables(trainer.graph)
    rows = []

    # K1: the sweep's first block, and the hybrid's first query block
    b, hops, alpha = (min(cfg.walk.batch_walkers, trainer.n),
                      cfg.walk.n_hops, cfg.walk.alpha)
    nodes = torch.arange(b, dtype=torch.int32, device=dev)
    u = draw_uniforms(hops, b, block_generator(cfg.train.seed, 0, dev))
    w, nb = visit_counts_topt(walks_from_fused_tables(
        tables, nodes, hops, alpha, u), nodes, cfg.walk.t_precompute)
    if not (torch.equal(w, trainer.tables.nbhd_w[:b])
            and torch.equal(nb, trainer.tables.nbhd_n[:b])):
        raise AssertionError("the 1M sweep's first block differs from the "
                             "plain walker's top-T")
    rows.append(measure_k1(torch, walk_kernel, tables, [(
        f"1M sweep block B={b} H={hops} alpha={alpha} "
        f"({trainer.graph.n_edges} directed edges)", nodes, alpha, u)],
        {k: counts[k].get("walk", 0) for k in ("sweep", "refresh",
                                               "serve")}))
    queries = torch.as_tensor(padded_block(hy.queries, 0, WALK_BLOCK),
                              device=dev)
    u = draw_uniforms(WALK_HOPS, WALK_BLOCK, block_generator(0, 0, dev))
    k = hy.walk[0].shape[1]
    w, nb = visit_counts_topt(walks_from_fused_tables(
        tables, queries, WALK_HOPS, WALK_ALPHA, u), queries, k)
    m = min(WALK_BLOCK, len(hy.queries))
    if not (np.array_equal(w[:m].cpu().numpy(), hy.walk[0][:m])
            and np.array_equal(nb[:m].cpu().numpy(), hy.walk[1][:m])):
        raise AssertionError("the hybrid's walk lists differ from the "
                             "plain walker's top-T")
    rows.append(measure_k1(torch, walk_kernel, tables, [(
        f"1M hybrid query block B={WALK_BLOCK} H={WALK_HOPS} "
        f"alpha={WALK_ALPHA}, top-{k}", queries, WALK_ALPHA, u)],
        {"hybrid": counts["hybrid"].get("walk", 0)}))
    rows[0]["name"] += " at 1M, sweep blocks"
    rows[1]["name"] += " at 1M, hybrid walk lists"
    log(f"1M K1: sweep block top-T == the artifact's, hybrid block top-{k} "
        f"== its walk lists")

    # K2: both embed layers over all 1M rows, gathered block by block
    t_nb = trainer.tables
    nb_idx = t_nb.nbhd_n[:, :mcfg.T].to(torch.int32).contiguous()
    nb_wt = t_nb.nbhd_w[:, :mcfg.T].contiguous()
    block_rows = inspect.signature(embed_all).parameters[
        "block_rows"].default
    layers = trainer.params.layers
    with torch.inference_mode():
        h1 = conv_from_table(layers[0], t_nb.features, t_nb.features,
                             nb_idx, nb_wt, block_rows=block_rows)
    k2 = measure_k2_blocked(torch, agg, [(layers[0], t_nb.features),
                                         (layers[1], h1)],
                            nb_idx, nb_wt, block_rows)
    din2 = h1.shape[1]
    del h1
    row = kernel_row(
        "K2 3xTF32 Q-MLP of every table row, then gather + weighted mean "
        "(agg.conv_aggregate, mode stream) at 1M", agg.SOURCE,
        agg.REPLACES, {k: counts[k].get("agg", 0)
                       for k in ("embed", "hybrid")},
        0, k2, f"both embed layers, N={trainer.n} T={mcfg.T}: Din="
        f"{t_nb.features.shape[1]} and {din2}, H="
        f"{mcfg.hidden_dim}, gathered in blocks of {block_rows}; P scratch "
        f"{trainer.n * mcfg.hidden_dim * 4} bytes")
    row.pop("backward")
    row["library"] = "addmm + leaky_relu, gather, einsum (project once)"
    rows.append(row)

    # K3 and its backward at both aggregations of one frontier step
    step_shapes = step_conv_inputs(torch, trainer, trainer.sample(
        block_generator(4242, 0, dev)))
    k3 = measure_aggregation(torch, agg, "dma", step_shapes)
    rows.append(kernel_row(
        "K3 fused 3xTF32 gather + Q-MLP + weighted mean "
        "(agg.conv_aggregate, mode dma) at 1M", dma_agg.SOURCE,
        dma_agg.REPLACES, {"train": counts["train"].get("dma_agg", 0)},
        counts["train"].get("agg_backward_dma", 0), k3,
        f"both aggregations of a frontier step at B="
        f"{cfg.train.batch_size} over the 1M table: "
        f"{step_shapes[0][2].shape[0]} nodes x T={mcfg.T}, Din="
        f"{step_shapes[0][1].shape[1]} and {step_shapes[1][2].shape[0]} "
        f"nodes x T={mcfg.T}, Din={step_shapes[1][1].shape[1]}; H="
        f"{mcfg.hidden_dim}"))

    # K4 on the served 1M x 128 table
    row = measure_k4(torch, quant_kernel, p["table"], p["stochastic"],
                     {"int8": counts["int8"].get("quant", 0)})
    row["name"] += " at 1M"
    rows.append(row)
    return rows


def measure_k2_blocked(torch, agg, layers, ids, wts, block_rows) -> dict:
    """K2 (``conv_aggregate`` with ``block_rows``, as ``embed_all`` calls
    it) at each (layer, table) of ``layers`` over all rows of ``ids``,
    against its plain version block by block (a whole [N, T, Din] gather
    would not fit beside the path's tensors), with its float64 error, its
    times, a project-once library composition's and its work, in
    ``measure_aggregation``'s keys (no backward)."""
    import torch.nn.functional as F

    out = dict.fromkeys(("ms", "host_ms", "plain_ms", "library_ms", "flops",
                         "products", "bytes", "err", "err64", "plain_err64",
                         *BWD_KEYS), 0.0)
    n = ids.shape[0]
    for layer, h in layers:
        Wq, bq = layer.Wq.detach(), layer.bq.detach()
        din, hdim = h.shape[1], Wq.shape[0]

        def kernel():
            return agg.conv_aggregate(h, ids, wts, Wq, bq, mode="stream",
                                      block_rows=block_rows)

        def plain():
            return torch.cat([agg.conv_aggregate_plain(
                h, ids[s:s + block_rows], wts[s:s + block_rows], Wq, bq)
                for s in range(0, n, block_rows)])

        with torch.inference_mode():
            got, want = kernel(), plain()
            err = float((got - want).abs().max())
            log(f"K2 at 1M, Din={din} H={hdim} (N={n}, blocks of "
                f"{block_rows}): max |diff| {err:.3g}")
            if not err <= K2_ATOL:
                raise AssertionError(f"K2 at 1M differs from the plain "
                                     f"version by {err} > {K2_ATOL}")
            err64, plain_err64 = float64_error(torch, agg, h, ids, wts, Wq,
                                               bq, got, want)
            del got, want
            out["err"] = max(out["err"], err)
            out["err64"] = max(out["err64"], err64)
            out["plain_err64"] = max(out["plain_err64"], plain_err64)
            out["ms"] += cuda_ms(torch, kernel, reps=5)
            out["host_ms"] += cuda_ms(torch, kernel, reps=5, queued=False)
            out["plain_ms"] += cuda_ms(torch, plain, reps=2, warmup=1)
            out["library_ms"] += cuda_ms(torch, lambda: project_once_library(
                torch, F, h, ids, wts, Wq, bq), reps=2, warmup=1)
        flops, nbytes, distinct, _ = agg_work(torch, ids, wts, din, hdim, n)
        out["flops"] += flops
        out["products"] += 2.0 * distinct * din * hdim
        out["bytes"] += nbytes
    return out


def main() -> int:
    import torch

    if len(sys.argv) == 3 and sys.argv[1] == "--sharded-rank":
        # one rank of the sharded phase's two-rank world (run_sharded_world2)
        return sharded_rank_main(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    from gcn_song_embeddings_tpu_torch import cli
    from gcn_song_embeddings_tpu_torch.data.device import DeviceGraph
    from gcn_song_embeddings_tpu_torch.models.pinsage import (
        conv_from_table,
        pinsage_forward,
    )
    from gcn_song_embeddings_tpu_torch.ops import agg, cuda_build, dma_agg
    from gcn_song_embeddings_tpu_torch.ops import quant_kernel, walk_kernel
    from gcn_song_embeddings_tpu_torch.ops.ppr import (
        block_generator,
        precompute_neighborhoods,
    )
    from gcn_song_embeddings_tpu_torch.ops.walks import (
        draw_uniforms,
        fused_walk_tables,
    )
    from gcn_song_embeddings_tpu_torch.train.trainer import PinSageTrainer

    dev = torch.device("cuda")
    log(card_line())
    log(f"device: {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    # ---- build ---------------------------------------------------------
    t = time.perf_counter()
    reports = cuda_build.build()
    log(f"build: {len(reports)} kernels in {time.perf_counter() - t:.2f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "bytes stack frame" in line:
                log(f"  ptxas[{name}]: {line.strip()}")
    reset_counts = reset_kernel_counts

    def read_counts(need):
        counts = kernel_counts()
        missing = [name for name in need if counts[name] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the path: "
                                 f"{missing}")
        return counts

    work = os.path.join(REPO, "build", "chip_smoke")
    # the 1M phase's dataset, written on the host while the phases before
    # it run (ended at exit if the run fails first)
    root_1m = os.path.join(REPO, "build", "chip_smoke_1m")
    synth_1m = start_1m_dataset(root_1m)
    atexit.register(_stop, synth_1m, 5.0)
    reset_counts()
    st = run_main_path(dev, work)
    launches = read_counts(("walk", "agg", "agg_split", "agg_project",
                            "agg_gather_mean"))
    log(f"launches on the main path: {launches}")

    # ---- prepare, then all, on a copy of the main path's dataset --------
    reset_counts()
    pp = run_prepare_path(dev, work)
    prepare_launches = read_counts(("walk", "agg", "agg_split",
                                    "agg_project", "agg_gather_mean",
                                    "dma_agg", "agg_backward_dma"))
    log(f"launches on the prepare and all path: {prepare_launches}")
    prepare_checks = check_prepare(pp)

    # ---- audio features at the nets' published widths --------------------
    audio = run_audio_path(dev, work)
    prepare_checks["audio"] = audio["checks"]
    st.walls.update({"prepare_s": pp.walls["prepare_s"],
                     "all_s": pp.walls["all_s"],
                     "prepare": {k: v for k, v in pp.walls.items()
                                 if k not in ("prepare_s", "all_s")},
                     **audio["walls"]})
    torch.cuda.empty_cache()

    # ---- the walk-side refresh after new co-listens ----------------------
    reset_counts()
    rf = run_refresh_path(dev, st, work)
    refresh_launches = read_counts(("walk",))
    log(f"launches on the refresh path: {refresh_launches}")
    refresh_checks = check_refresh(torch, walk_kernel, st, rf)

    # ---- the training path ---------------------------------------------
    reset_counts()
    tr_st = run_train_path(dev, st, work)
    train_launches = read_counts(("agg", "dma_agg", "agg_backward_dma",
                                  "agg_split", "agg_bwd_frontier"))
    no_csr_on(train_launches, "the training path")
    log(f"launches on the training path: {train_launches}")
    check_training_run(tr_st)
    graph, cfg, mcfg = st.graph, st.cfg, st.cfg.model
    trainer = PinSageTrainer(
        DeviceGraph.from_graph(graph, dev), graph.n_items, graph.features,
        st.train_pos, cfg=tr_st.cfg,
        base_run_dir=os.path.dirname(tr_st.run_dir),
        nbhds_path=graph.nbhds_path, log=False, load_save=True,
        verbose=False)
    if (trainer.e, trainer.b, trainer.opt.count) != (
            TRAIN_EPOCHS, 0, TRAIN_EPOCHS * TRAIN_BATCHES):
        raise AssertionError(f"resume: epoch {trainer.e}, batch "
                             f"{trainer.b}, count {trainer.opt.count}")
    resume_err = float(np.abs(trainer.embed() - tr_st.emb).max())
    probe = np.arange(0, graph.n_items, 1571)
    frontier_err = float(np.abs(trainer.embed(ids=probe)
                                - tr_st.emb[probe]).max())
    log(f"resumed trainer (epoch {trainer.e}): embed_all vs the run's "
        f"emb.npy max |diff| {resume_err:.3g}; frontier embed (K3) of "
        f"{len(probe)} rows vs emb.npy (K2) max |diff| {frontier_err:.3g}")
    if not (resume_err <= 1e-6 and frontier_err <= 1e-4):
        raise AssertionError(f"resumed embeddings differ: {resume_err}, "
                             f"{frontier_err}")
    steps = three_step_checks(torch, trainer)
    st.walls.update(tr_st.walls)
    st.walls["train_step_ms"], step_profile = time_train_steps(torch,
                                                                trainer)
    frontier_backward(step_profile, "the f32 frontier step")

    # ---- 16-bit training: cli train in bf16, then in f16, each with 3 ----
    # ---- frontier steps card vs CPU and 3 full-graph steps --------------
    phases_t = time.perf_counter()
    step_ms = {"f32_frontier": st.walls["train_step_ms"]}
    step_ms["f32_fullgraph"], fg_profile = time_train_steps(
        torch, trainer, fullgraph=True)
    step_profile = {"f32_frontier": step_profile,
                    "f32_fullgraph": fg_profile}
    runs16, checks16, trainers16 = {}, {}, {}
    launches16, full_launches16 = {}, {}
    for dtype in ("bfloat16", "float16"):
        form = short16(dtype)
        reset_counts()
        run16 = run_train_path16(dev, st, work, dtype)
        launches16[form] = read_counts((f"dma_agg_{form}",
                                        f"agg_backward_dma_{form}",
                                        f"agg_{form}_tile",
                                        "agg_bwd_frontier"))
        no_csr_on(launches16[form], f"the {form} training path")
        log(f"launches on the {form} training path: {launches16[form]}")
        checks16[form] = check_run16(torch, st, run16)
        trainer16 = PinSageTrainer(
            DeviceGraph.from_graph(graph, dev), graph.n_items,
            graph.features, st.train_pos, cfg=run16.cfg,
            base_run_dir=os.path.dirname(run16.run_dir),
            nbhds_path=graph.nbhds_path, log=False, load_save=True,
            verbose=False)
        if trainer16.tables.step_features.dtype != getattr(torch, dtype):
            raise AssertionError(f"the {form} trainer's step table is not "
                                 f"{form}")
        reset_counts()
        checks16[form]["three_steps"] = three_step_checks16(torch,
                                                            trainer16)
        full_launches16[form] = read_counts((
            f"agg_{form}", f"agg_{form}_project",
            f"agg_backward_stream_{form}", f"dma_agg_{form}",
            "agg_bwd_rows", "agg_bwd_frontier"))
        log(f"launches on the {form} three-step checks (frontier card and "
            f"CPU, full graph card): {full_launches16[form]}")
        step_ms[f"{form}_frontier"], step_profile[f"{form}_frontier"] = (
            time_train_steps(torch, trainer16))
        frontier_backward(step_profile[f"{form}_frontier"],
                          f"the {form} frontier step")
        step_ms[f"{form}_fullgraph"], step_profile[f"{form}_fullgraph"] = (
            time_train_steps(torch, trainer16, fullgraph=True))
        st.walls.update(run16.walls)
        runs16[form], trainers16[form] = run16, trainer16
    bf = runs16["bf16"]
    st.walls["train_step_ms_by_form"] = step_ms
    log(json.dumps({"train_step_ms": step_ms}))

    # ---- the tail: crawl (K1), profiling, recommendation lists ----------
    reset_counts()
    tail = run_tail_path(dev, st, tr_st, bf, work)
    tail_launches = read_counts(("walk",))
    log(f"launches on the tail path: {tail_launches}")
    st.walls["tail"] = tail["walls"]
    st.walls["16bit_and_tail_phases_s"] = time.perf_counter() - phases_t

    # ---- embed_all at N=100k projects once per layer (K2) ---------------
    project_once = check_project_once(torch, agg, st)

    # ---- the int8 serving path, on the trained embeddings --------------
    reset_counts()
    it = run_int8_path(dev, st, tr_st)
    int8_launches = read_counts(("walk", "quant"))
    log(f"launches on the int8 path: {int8_launches}")
    st.walls["int8"] = it["walls"]
    int8_checks = check_int8(torch, st, tr_st, it)
    torch.cuda.empty_cache()

    # ---- the sharded path: parallel/ on NCCL (world of 1) and gloo (2) --
    t = time.perf_counter()
    sh = run_sharded_path(dev, st, work)
    sh["walls"]["phase_s"] = time.perf_counter() - t
    sharded = {"nccl_world1": sh["counts"]["nccl_world1"],
               "nccl_cli_world1": sh["counts"]["nccl_cli_world1"],
               "gloo_world2": {k: sum(sh["counts"][f"gloo_rank{r}"][k]
                                      for r in range(2))
                               for k in sh["counts"]["gloo_rank0"]}}
    log(f"launches on the sharded path: {json.dumps(sharded)}")
    log(json.dumps({"sharded_checks": {k: sh[k] for k in (
        "checks", "walls", "backends", "unverified")}}))

    # ---- the hard benchmark: hard_bench, then int8 serving quality ------
    t = time.perf_counter()
    reset_counts()
    hp = run_hard_path(dev, work)
    hard_launches = read_counts(("walk", "agg", "agg_split", "dma_agg",
                                 "agg_backward_dma"))
    log(f"launches on the hard path: {hard_launches}")
    hard_checks = check_hard(hp)
    hard_checks["kernels_at_its_shapes"] = hold_hard_kernels(torch,
                                                             hp["bench"])
    hard_checks["walls"]["phase_s"] = time.perf_counter() - t
    st.walls["hard"] = hard_checks["walls"]
    log(card_line())
    log(json.dumps({"hard_checks": hard_checks}))

    # ---- the co-listen A/B (cut), its new shapes, the roster's eval -----
    t = time.perf_counter()
    reset_counts()
    ab_state = run_colisten_path(dev, hp, work)
    ab_launches = read_counts(("walk", "agg", "agg_split", "dma_agg",
                               "agg_backward_dma"))
    log(f"launches on the co-listen A/B path: {ab_launches}")
    colisten_checks = check_colisten(ab_state)
    shapes = {}
    for arm in NEW_SHAPE_ARMS:
        reset_counts()
        shapes[arm] = run_new_shape(dev, ab_state, arm)
        shapes[arm]["launches"] = read_counts(("dma_agg", "agg_backward_dma",
                                               "agg"))
        log(f"launches on {arm}'s steps and embed: {shapes[arm]['launches']}")
        colisten_checks["walls"][f"{arm}_s"] = shapes[arm]["wall_s"]
    rows_colisten = hold_colisten_kernels(torch, ab_state, shapes)
    del shapes
    torch.cuda.empty_cache()
    # the precision policy at the wide arm's width, counters set to 0
    # before each value's steps and embed
    prec = run_precision_path(dev, ab_state)
    t_hold = time.perf_counter()
    rows_precision = hold_precision_kernels(torch, prec)
    prec["checks"]["hold_s"] = time.perf_counter() - t_hold
    log(card_line())
    log(json.dumps({"precision_checks": {
        **prec["checks"], "launches": {
            v: {k: n for k, n in r["counts"].items() if n}
            for v, r in prec["runs"].items()},
        "step_ms": {v: r["step_ms"] for v, r in prec["runs"].items()},
        "step_profile": {v: r["profile"] for v, r in prec["runs"].items()}}}))
    del prec
    torch.cuda.empty_cache()
    reset_counts()
    ev = run_eval_path(dev, hp, ab_state, work)
    eval_launches = read_counts(("walk",))
    log(f"launches on the eval path (the roster): {eval_launches}")
    eval_checks = check_eval(torch, dev, ev)
    eval_checks["rows_on_the_card"] = check_eval_rows(torch, dev, ev)
    eval_checks["project_once"] = project_once
    colisten_checks["roster"] = check_roster(ev)
    ev.built = None
    colisten_checks["walls"]["phase_s"] = time.perf_counter() - t
    st.walls["colisten"] = colisten_checks["walls"]
    log(json.dumps({"eval_walls": {
        **ev.walls, "models": {m: {c: eval_checks["accuracy"][m][c]
                                   for c in ("t (train)", "t (emb)",
                                             "t (knn)")}
                               for m in ev.models}}}))
    log(card_line())
    log(json.dumps({"colisten_checks": colisten_checks}))
    del ab_state
    torch.cuda.empty_cache()

    # ---- the repository tools: grid_refschedule, fullgraph_bench ------
    t = time.perf_counter()
    tools = run_tools_path(dev, st, hp, work)
    rows_tools = hold_tools_kernels(torch, tools)
    tools["walls"]["phase_s"] = time.perf_counter() - t
    st.walls["tools"] = tools["walls"]
    tool_counts = tools["counts"]
    log(card_line())
    log(json.dumps({"tools_checks": {
        "grid": tools["grid"], "fullgraph_bench": tools["fullgraph_bench"],
        "scaling_bench": sh["checks"]["gloo_world2"]["scaling_bench"],
        "walls": tools["walls"]}}))
    del hp, tools
    torch.cuda.empty_cache()

    # ---- the bench module: headline, FLOP-bound steps, roofline (cut) ---
    t = time.perf_counter()
    bp = run_bench_path(dev)
    bench_counts = bp["counts"]
    rows_bench = hold_bench_kernels(torch, bp, dev)
    bp["walls"]["phase_s"] = time.perf_counter() - t
    st.walls["bench"] = bp["walls"]
    log(card_line())
    log(json.dumps({"bench_checks": {k: bp[k] for k in (
        "bench", "checks", "walls")}}))
    del bp
    torch.cuda.empty_cache()

    # ---- the 1M catalog: scale_demo, refresh_1m, hybrid_1m, serve_bench --
    t = time.perf_counter()
    reset_counts()
    p1m = run_1m_path(dev, root_1m, synth=synth_1m)
    scale_1m_checks = check_1m(torch, dev, p1m)
    rows_1m = hold_1m_kernels(torch, p1m)
    scale_1m_checks["walls"]["phase_s"] = time.perf_counter() - t
    st.walls["scale_1m"] = scale_1m_checks["walls"]
    shutil.rmtree(p1m["work"], ignore_errors=True)
    del p1m
    torch.cuda.empty_cache()
    log(card_line())
    log(json.dumps({"scale_1m_checks": scale_1m_checks}))

    log(json.dumps({"phase_walls": st.walls}))
    log(json.dumps({"prepare_checks": prepare_checks}))
    log(json.dumps({"bf16_checks": checks16["bf16"]}))
    log(json.dumps({"f16_checks": checks16["f16"]}))
    log(json.dumps({"tail_checks": tail["checks"]}))
    log(json.dumps({"train_step_profile": step_profile}))
    log(json.dumps({"int8_checks": int8_checks}))
    log(json.dumps({"eval_checks": eval_checks}))
    log(json.dumps({"refresh_checks": refresh_checks}))
    emb, nb_w, nb_n, params = st.emb, st.nb_w, st.nb_n, st.params
    feats, nbw_d, nbn_d, dg = st.feats, st.nbw_d, st.nbn_d, st.dg
    rows, cached, ds = st.rows, st.cached, st.ds

    # ---- outputs are right ---------------------------------------------
    if emb.shape != (graph.n_items, mcfg.out_dim) or not np.isfinite(
            emb).all():
        raise AssertionError(f"embeddings: shape {emb.shape}, finite "
                             f"{np.isfinite(emb).all()}")
    probe = torch.arange(0, graph.n_items, 1571, dtype=torch.int32)
    with torch.inference_mode():
        ref = pinsage_forward(copy.deepcopy(params).cpu(), feats.cpu(),
                              nbw_d.cpu(), nbn_d.cpu(), probe,
                              mcfg.n_layers, mcfg.T).numpy()
    cpu_err = float(np.abs(emb[probe.numpy()] - ref).max())
    log(f"embed_all (GPU, K2) vs pinsage_forward (CPU, plain) on "
        f"{len(probe)} nodes: max |diff| {cpu_err:.3g}")
    if not cpu_err <= 1e-4:
        raise AssertionError(f"GPU embeddings disagree with the CPU path: "
                             f"{cpu_err}")
    head = cached.knn_rows(np.asarray(rows), QUERY_K)
    for row, nbrs in zip(rows, head):
        lead = [int(n) for n, w in zip(nb_n[row], nb_w[row]) if w > 0]
        got = [o["index"] for o in nbrs][:min(len(lead), QUERY_K)]
        if got != lead[:len(got)]:
            raise AssertionError(f"cached head of row {row}: {got} vs "
                                 f"{lead[:len(got)]}")
    cli_emb = os.path.join(work, "emb_cli.npy")
    cli.main(["embed", "--dataset", ds, "--out", cli_emb, "--seed", "0"])
    cli_err = float(np.abs(np.load(cli_emb) - emb).max())
    log(f"cli embed (cached sweep) vs main path: max |diff| {cli_err:.3g}")
    if not cli_err <= 1e-6:
        raise AssertionError(f"cli embed differs: {cli_err}")

    # the sweep's wall without its compressed .npz cache write
    t = time.perf_counter()
    precompute_neighborhoods(dg, cfg.walk, None, seed=0)
    torch.cuda.synchronize()
    log(f"sweep without the cache write: {time.perf_counter() - t:.3f} s")

    # ---- kernels against their plain versions, at the path's shapes ----
    # K1 at the sweep's shape (alpha 0.85 and 0) and at the live-walk
    # requests' (one query and a batch of 4, SERVE_HOPS hops)
    b, hops, alpha = cfg.walk.batch_walkers, cfg.walk.n_hops, cfg.walk.alpha
    sweep_nodes = torch.arange(b, dtype=torch.int32, device=dev)
    sweep_u = draw_uniforms(hops, b, block_generator(0, 0, dev))
    live = [torch.tensor(rows[:n], dtype=torch.int32, device=dev)
            for n in (1, len(rows))]
    k1_shapes = [(f"sweep B={b} H={hops} alpha={alpha}", sweep_nodes, alpha,
                  sweep_u),
                 (f"sweep B={b} H={hops} alpha=0.0", sweep_nodes, 0.0,
                  sweep_u)]
    for i, nodes in enumerate(live):
        k1_shapes.append((f"live-walk B={len(nodes)} H={SERVE_HOPS} "
                          f"alpha={alpha}", nodes, alpha, draw_uniforms(
                              SERVE_HOPS, len(nodes),
                              block_generator(1, i, dev))))
    # PersPageRank's query block at eval: the harness asks for 1000 rows
    # at a time, each walking SERVE_HOPS hops
    eval_nodes = torch.arange(1000, dtype=torch.int32, device=dev)
    k1_shapes.append((f"eval PageRank B=1000 H={SERVE_HOPS} alpha={alpha}",
                      eval_nodes, alpha, draw_uniforms(
                          SERVE_HOPS, 1000, block_generator(0, 0, dev))))
    sweep_launches = st.sweep_walk_launches
    # the refresh walks blocks of the sweep's shape, and the Hybrid row's
    # head blocks of the PageRank rows' shape
    results = [measure_k1(
        torch, walk_kernel, fused_walk_tables(dg), k1_shapes,
        {"sweep": sweep_launches,
         "live_walk": launches["walk"] - sweep_launches,
         "refresh": refresh_launches["walk"],
         **{f"eval_{row.split(':')[0]}": n
            for row, n in ev.row_walks.items() if n},
         "int8_live_walk": int8_launches["walk"],
         "prepare": pp.prepare_k1,
         "all_eval_PageRank": pp.all_k1["cmd_eval"],
         "tail_crawl": tail_launches["walk"],
         **{f"sharded_{w}": c["walk"] for w, c in sharded.items()},
         "hard": hard_launches["walk"],
         "colisten_ab": ab_launches["walk"],
         **{path: c["walk"] for path, c in tool_counts.items()},
         "scaling": sh["scaling_counts"]["walk"]})]
    if sum(ev.row_walks.values()) != eval_launches["walk"]:
        raise AssertionError(f"eval K1 launches by row {ev.row_walks} do "
                             f"not add up to {eval_launches['walk']}")

    # K2 at both conv layers' shapes of embed_all (its backward at the
    # same shapes: the train step's full-graph forward), K3 at both
    # aggregations of a frontier train step (K2 timed there too)
    nb_idx = nbn_d[:, :mcfg.T].to(torch.int32).contiguous()
    nb_wt = nbw_d[:, :mcfg.T].contiguous()
    with torch.inference_mode():
        h1 = conv_from_table(params.layers[0], feats, feats, nb_idx, nb_wt)
    embed_shapes = [(params.layers[0], feats, nb_idx, nb_wt, False),
                    (params.layers[1], h1, nb_idx, nb_wt, True)]
    k2 = measure_aggregation(torch, agg, "stream", embed_shapes)
    gen = block_generator(4242, 0, dev)
    step_shapes = step_conv_inputs(torch, trainer, trainer.sample(gen))
    k3 = measure_aggregation(torch, agg, "dma", step_shapes)
    k2_at_step = measure_aggregation(torch, agg, "stream", step_shapes,
                                     with_backward=False)
    row = kernel_row(
        "K2 3xTF32 Q-MLP of every table row, then gather + weighted mean "
        "(agg.conv_aggregate, mode stream)", agg.SOURCE, agg.REPLACES,
        {"serve": launches["agg"], "train": train_launches["agg"],
         "all": prepare_launches["agg"],
         **{f"sharded_{w}": c["agg"] for w, c in sharded.items()},
         "hard": hard_launches["agg"], "colisten_ab": ab_launches["agg"],
         **{path: c["agg"] for path, c in tool_counts.items()},
         "scaling": sh["scaling_counts"]["agg"],
         "bench": bench_counts["agg"]},
        train_launches["agg_backward_stream"]
        + sum(c["agg_backward_stream"] for c in sharded.values())
        + sum(c["agg_backward_stream"] for c in tool_counts.values())
        + bench_counts["agg_backward_stream"], k2,
        f"both embed_all layers, N={graph.n_items} T={mcfg.T}: Din=512 and "
        f"Din=128, H={mcfg.hidden_dim}; backward at the same shapes (the "
        f"full-graph train step), launched "
        f"{steps['k2_backward_launches']} times by the three-step check")
    row["header"] = agg.HEADER
    row["backward"]["hubs"] = hub_timing(torch, agg, graph.n_items, mcfg.T,
                                         mcfg.hidden_dim)
    row["backward"]["frontier_k2"] = frontier_k2_holds(torch, agg,
                                                       step_shapes)
    # each path's backward launches by form (K2's and K3's together)
    row["backward"]["forms_by_path"] = {
        path: {form: c.get(key, 0) for form, key in (
            ("frontier", "agg_bwd_frontier"), ("table", "agg_bwd_rows"),
            ("csr", "agg_bwd_csr"))}
        for path, c in (("train", train_launches),
                        *((f"sharded_{w}", c) for w, c in sharded.items()),
                        *tool_counts.items(), ("bench", bench_counts))}
    for name, part in row["parts"].items():
        # the split also runs for every K3 call of the training path
        part["launches_by_path"] = {
            "serve": launches[f"agg_{name}"],
            "train": train_launches[f"agg_{name}"],
            "all": prepare_launches[f"agg_{name}"],
            **{f"sharded_{w}": c[f"agg_{name}"]
               for w, c in sharded.items()},
            "hard": hard_launches[f"agg_{name}"],
            "colisten_ab": ab_launches[f"agg_{name}"],
            **{path: c[f"agg_{name}"] for path, c in tool_counts.items()},
            "scaling": sh["scaling_counts"][f"agg_{name}"],
            "bench": bench_counts[f"agg_{name}"]}
    results.append(row)
    row = kernel_row(
        "K3 fused 3xTF32 gather + Q-MLP + weighted mean "
        "(agg.conv_aggregate, mode dma)", dma_agg.SOURCE, dma_agg.REPLACES,
        {"train": train_launches["dma_agg"],
         "all": prepare_launches["dma_agg"],
         **{f"sharded_{w}": c["dma_agg"] for w, c in sharded.items()},
         "hard": hard_launches["dma_agg"],
         "colisten_ab": ab_launches["dma_agg"],
         **{path: c["dma_agg"] for path, c in tool_counts.items()},
         "scaling": sh["scaling_counts"]["dma_agg"],
         "bench": bench_counts["dma_agg"]},
        train_launches["agg_backward_dma"]
        + prepare_launches["agg_backward_dma"]
        + sum(c["agg_backward_dma"] for c in sharded.values())
        + hard_launches["agg_backward_dma"]
        + ab_launches["agg_backward_dma"]
        + sum(c["agg_backward_dma"] for c in tool_counts.values())
        + sh["scaling_counts"]["agg_backward_dma"]
        + bench_counts["agg_backward_dma"], k3,
        f"both aggregations of a frontier train step at B=128: "
        f"{step_shapes[0][2].shape[0]} nodes x T={mcfg.T}, Din=512 and "
        f"{step_shapes[1][2].shape[0]} nodes x T={mcfg.T}, Din=128; "
        f"H={mcfg.hidden_dim}")
    row["k2_ms_same_shapes"] = k2_at_step["ms"]
    row["k2_host_ms_same_shapes"] = k2_at_step["host_ms"]
    results.append(row)
    results.append(measure_k4(torch, quant_kernel, it["table"],
                              it["stochastic"],
                              {"int8": int8_launches["quant"]}))

    # the 16-bit forms: K3's at the deepest conv of a 16-bit frontier step,
    # K2's at both full-graph layers over the 100k catalog
    for form, dtype in (("bf16", torch.bfloat16), ("f16", torch.float16)):
        k3_shapes, k2_shapes = step_shapes16(torch, trainers16[form], st,
                                             dtype)
        k3_16 = measure_aggregation16(torch, agg, "dma", k3_shapes, [False])
        k2_16 = measure_aggregation16(torch, agg, "stream", k2_shapes,
                                      [False, True])
        results.append(kernel_row16(
            f"K3 {form} fused gather + Q-MLP + weighted mean "
            f"(agg.conv_aggregate on a {form} table, mode dma)",
            dma_agg.SOURCE, dma_agg.REPLACES,
            {f"train_{form}": launches16[form][f"dma_agg_{form}"],
             f"train_{form}_three_steps":
                 full_launches16[form][f"dma_agg_{form}"]},
            launches16[form][f"agg_backward_dma_{form}"]
            + full_launches16[form][f"agg_backward_dma_{form}"], k3_16,
            f"the deepest conv of a {form} frontier step at B=128: "
            f"{k3_shapes[0][1].shape[0]} nodes x T={mcfg.T}, Din=512, "
            f"H={mcfg.hidden_dim}; {form} rows and Wq, f32 weights; "
            f"backward at the same shape (no dh)"))
        results[-1]["header"] = agg.HEADER
        results.append(kernel_row16(
            f"K2 {form} Q-MLP of every table row, then gather + weighted "
            f"mean (agg.conv_aggregate on a {form} table, mode stream)",
            agg.SOURCE, agg.REPLACES,
            {f"train_{form}_fullgraph":
                 full_launches16[form][f"agg_{form}"]},
            full_launches16[form][f"agg_backward_stream_{form}"], k2_16,
            f"both full-graph layers, N={graph.n_items} T={mcfg.T}: "
            f"Din=512 and Din=128 (the first layer's output stored in "
            f"{form}), H={mcfg.hidden_dim}; {form} rows, Wq and weights "
            f"(the {form}-rounded denominator); backward at the same "
            f"shapes (dh after the first layer)"))
        results[-1]["header"] = agg.HEADER
        results[-1]["ms_over_f32_k2_ms"] = k2_16["ms"] / k2["ms"]
    results.extend(rows_colisten)
    results.extend(rows_precision)
    results.extend(rows_tools)
    results.extend(rows_bench)
    results.extend(rows_1m)
    results.extend(backward_rows(results))
    shutil.rmtree(work, ignore_errors=True)
    log(card_line())
    log(json.dumps({"kernels": results}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
