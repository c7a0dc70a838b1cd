"""``scripts/bf16x_ab.py`` (the 16-bit core's timing harness, loaded from
its path) on the CPU: the ``--no-epilogue`` copy differs from the tree
only by the switch set before the header's first line, a tree without
the switch is refused, and measuring refuses a machine without a card.
The timings themselves need the card: ``python scripts/bf16x_ab.py TREE
...`` on a machine with one H100.
"""

import importlib.util
import os
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
HEADER = Path("csrc") / "agg_tc.cuh"


def _script():
    spec = importlib.util.spec_from_file_location(
        "bf16x_ab_script", ROOT / "scripts" / "bf16x_ab.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


bf16x_ab = _script()


def _tree(tmp_path: Path) -> Path:
    shutil.copytree(ROOT / bf16x_ab.PACKAGE, tmp_path / bf16x_ab.PACKAGE,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_no_epilogue_copy_drops_only_the_epilogue_call(tmp_path):
    tree = _tree(tmp_path)
    root = Path(bf16x_ab.without_epilogue(str(tree)))
    assert root == tree / "build" / "bf16x_ab_no_epilogue"
    before = (tree / bf16x_ab.PACKAGE / HEADER).read_text()
    after = (root / bf16x_ab.PACKAGE / HEADER).read_text()
    assert after == f"#define {bf16x_ab.EPILOGUE_SWITCH} 0\n" + before
    assert f"#ifndef {bf16x_ab.EPILOGUE_SWITCH}" in before
    # the other sources are copied as they are
    for name in ("dma_agg.cu", "agg.cu"):
        assert ((root / bf16x_ab.PACKAGE / "csrc" / name).read_bytes()
                == (tree / bf16x_ab.PACKAGE / "csrc" / name).read_bytes())


def test_no_epilogue_refuses_a_core_without_the_call(tmp_path):
    tree = _tree(tmp_path)
    path = tree / bf16x_ab.PACKAGE / HEADER
    path.write_text(path.read_text().replace(
        f"#ifndef {bf16x_ab.EPILOGUE_SWITCH}", "#if 0"))
    with pytest.raises(ValueError, match="switch"):
        bf16x_ab.without_epilogue(str(tree))


def test_measure_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the harness runs there")
    with pytest.raises(RuntimeError, match="CUDA card"):
        bf16x_ab.measure(os.fspath(ROOT))



def test_k2_whole_call_runs_at_the_flopbound_steps_shapes():
    """K2's whole 16-bit call is timed over the FLOP-bound step's table
    and neighbourhoods (``bench``: 20,000 tracks, T = 3, hidden 1024)."""
    from gcn_song_embeddings_tpu_torch import bench

    assert bf16x_ab.K2_FB == (bench.N_TRACKS, bench.T)
    assert bench.FB_HIDDEN == 1024
