"""Import hygiene of the PyTorch port and its no-fallback device rule.

The port package, its CLI and chip_smoke.py must import with JAX, the
JAX package, pandas, torchaudio and librosa blocked (the machine with the
card has none of the last three).  This test process has JAX loaded
already (conftest), so the checks run in subprocesses with
``sys.modules[...] = None``.  The port builds its own native readers and
never loads the JAX package's.
"""

import os
import re
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "gcn_song_embeddings_tpu_torch")
BLOCK = ("import sys\n"
         "sys.modules['jax'] = None\n"
         "sys.modules['gcn_song_embeddings_tpu'] = None\n"
         "sys.modules['pandas'] = None\n"
         "sys.modules['torchaudio'] = None\n"
         "sys.modules['librosa'] = None\n")
NO_CUDA = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}


def _python(code: str, cwd: str = REPO, timeout: int = 300):
    return subprocess.run([sys.executable, "-c", BLOCK + code], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout,
                          env=NO_CUDA)


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_neither_jax_nor_the_jax_package(path):
    banned = re.compile(
        r"^\s*(from|import)\s+(jax|gcn_song_embeddings_tpu)(\.|\s|$)",
        re.MULTILINE)
    with open(path, encoding="utf-8") as f:
        hits = banned.findall(f.read())
    assert not hits, f"{path} imports {hits}"


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_names_no_native_library_of_the_jax_package(path):
    banned = re.compile(r"gcn_song_embeddings_tpu[/.]native"
                        r"|lib(jsongraph|featload|audiodec)\.so")
    with open(path, encoding="utf-8") as f:
        hits = banned.findall(f.read())
    assert not hits, f"{path} names {hits}"


def test_every_port_module_imports_with_jax_blocked():
    res = _python(
        "import importlib, pkgutil\n"
        "import gcn_song_embeddings_tpu_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, "
        "P.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert sys.modules['jax'] is None\n"
        "assert sys.modules['pandas'] is None\n"
        "assert sys.modules['torchaudio'] is None\n"
        "assert sys.modules['librosa'] is None\n"
        "print(' '.join(names))\n")
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 20
    prefix = "gcn_song_embeddings_tpu_torch."
    for module in ("ops.dma_agg", "ops.quantize", "ops.quant_kernel",
                   "train.adam", "train.loss",
                   "train.sampler", "train.trainer", "native.jsongraph",
                   "native.featload", "evals.metrics", "evals.harness",
                   "evals.tables", "evals.device_eval",
                   "models.baselines.simple", "models.baselines.similarity",
                   "models.baselines.mf", "models.baselines.node2vec",
                   "models.baselines.graphsage",
                   "models.baselines.pinsage_wrapper", "models.gnnlib",
                   "ops.graph_ops", "ops.node2vec", "train.grid_search",
                   "features", "models.audio_embedders", "data.positives",
                   "native.audiodec", "convert_audio_weights",
                   "parallel.mesh", "parallel.multihost",
                   "parallel.collectives", "parallel.gather",
                   "parallel.walks_sharded", "parallel.train_step",
                   "parallel.serve_sharded", "data.explore",
                   "data.collector", "evals.qualitative",
                   "utils.profiling", "hard_bench", "serve_int8_quality",
                   "scale_demo", "refresh_1m", "hybrid_1m", "serve_bench",
                   "colisten_ab", "hard_roster"):
        assert prefix + module in names


def test_entry_points_without_a_card_raise_and_do_not_fall_back(tmp_path):
    res = _python(
        "import numpy as np\n"
        "import scipy.sparse as sp\n"
        "from gcn_song_embeddings_tpu_torch import cli, features, serve\n"
        "from gcn_song_embeddings_tpu_torch import hard_bench\n"
        "from gcn_song_embeddings_tpu_torch import serve_int8_quality\n"
        "from gcn_song_embeddings_tpu_torch import scale_demo, refresh_1m\n"
        "from gcn_song_embeddings_tpu_torch import hybrid_1m, serve_bench\n"
        "from gcn_song_embeddings_tpu_torch import colisten_ab, hard_roster\n"
        "from gcn_song_embeddings_tpu_torch.models import "
        "audio_embedders as ae\n"
        "from gcn_song_embeddings_tpu_torch.models import gnnlib\n"
        "from gcn_song_embeddings_tpu_torch.models.baselines import mf\n"
        "from gcn_song_embeddings_tpu_torch.parallel import multihost\n"
        "from gcn_song_embeddings_tpu_torch.data import explore\n"
        "from gcn_song_embeddings_tpu_torch.ops.node2vec import "
        "build_alias_graph\n"
        "from gcn_song_embeddings_tpu_torch.train.grid_search import "
        "grid_search\n"
        "from gcn_song_embeddings_tpu_torch.utils.device import "
        "resolve_device\n"
        "ip, ix = np.array([0, 1, 2]), np.array([1, 0])\n"
        "mat = sp.csr_matrix(np.eye(3, dtype='f4'))\n"
        "calls = [lambda: resolve_device(None),\n"
        "         lambda: serve.EmbeddingIndex(np.eye(4, dtype='f4')),\n"
        "         lambda: cli.embed_dataset('nowhere'),\n"
        "         lambda: serve.main(['--emb', 'x.npy']),\n"
        "         lambda: build_alias_graph(ip, ix),\n"
        "         lambda: gnnlib.GNNCore().fit(ip, ix, None, 2),\n"
        "         lambda: gnnlib.params_from_jax({'l': {'W': [1.0]}}),\n"
        "         lambda: mf.ALS(factors=2).fit(mat),\n"
        "         lambda: mf.BPR(factors=2).fit(mat),\n"
        "         lambda: grid_search(None, None, None, {}),\n"
        "         lambda: cli.main(['prepare', '--dataset', 'nowhere']),\n"
        "         lambda: cli.main(['all', '--dataset', 'nowhere']),\n"
        "         lambda: features.MFCC(),\n"
        "         lambda: features.OpenL3(),\n"
        "         lambda: features.VGGish(),\n"
        "         lambda: features.MusicNN(),\n"
        "         lambda: features.melspectrogram(np.zeros((1, 4096))),\n"
        "         lambda: ae.MusicNNNet.build(),\n"
        "         lambda: ae.openl3_mel_windows(np.zeros((1, 16000))),\n"
        "         lambda: ae.vggish_log_mel_patches(np.zeros((1, 16000))),\n"
        "         lambda: ae.musicnn_log_mel_patches(np.zeros((1, 16000))),\n"
        "         lambda: multihost.initialize_multihost(),\n"
        "         lambda: cli.main(['train', '--dataset', 'nowhere',\n"
        "                           '--mesh-graph', '1']),\n"
        "         lambda: cli.main(['all', '--dataset', 'nowhere',\n"
        "                           '--mesh-graph', '1']),\n"
        "         lambda: serve.main(['--emb', 'x.npy', '--sharded']),\n"
        "         lambda: explore.crawl_walk_counts(None, 0),\n"
        "         lambda: hard_bench.main(['--work-dir', 'nowhere']),\n"
        "         lambda: serve_int8_quality.main(['--work-dir',\n"
        "                                          'nowhere']),\n"
        "         lambda: serve_int8_quality.int8_rank_eval(\n"
        "             np.eye(4, dtype='f4'), [[0, 1]]),\n"
        "         lambda: scale_demo.main(['--work-dir', 'nowhere']),\n"
        "         lambda: refresh_1m.main(['--work-dir', 'nowhere']),\n"
        "         lambda: hybrid_1m.main(['--work-dir', 'nowhere']),\n"
        "         lambda: serve_bench.main(['--tracks', '8']),\n"
        "         lambda: colisten_ab.main(['--work-dir', 'nowhere']),\n"
        "         lambda: hard_roster.main(['--work-dir', 'nowhere'])]\n"
        "for call in calls:\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('ran without a device')\n"
        "print(resolve_device('cpu'))\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "cpu"


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    for cwd, script in ((REPO, "chip_smoke.py"),
                        (str(tmp_path), str(tmp_path / "chip_smoke.py"))):
        if cwd != REPO:
            shutil.copy(os.path.join(REPO, "chip_smoke.py"), script)
        res = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=300,
                             env=NO_CUDA)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
