"""``scripts/bf16x_error_probe.py`` (loaded from its path) on the CPU, at a
small size: each form's problem has the shapes it states, its kernel and
plain errors are taken against float64 of the same rounded function, for
K3 and for K2 (on the CPU the wrapper runs the plain version, so the two
are equal and small), and the probe refuses a kernel or form it does not
know and a machine without a card.  The measurements themselves need the
card: ``python scripts/bf16x_error_probe.py`` on a machine with one H100.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _script():
    spec = importlib.util.spec_from_file_location(
        "bf16x_error_probe_script", ROOT / "scripts" / "bf16x_error_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


probe = _script()


def test_problem_shapes():
    tab, ids, w, wq, bq = probe.problem(torch, torch.device("cpu"), 7, 24,
                                        16, seed=0)
    assert tab.shape == (probe.TABLE_ROWS, 24) and tab.dtype == torch.float32
    assert ids.shape == (7, probe.T) and ids.dtype == torch.int32
    assert int(ids.min()) >= 0 and int(ids.max()) < probe.TABLE_ROWS
    assert w.shape == (7, probe.T) and wq.shape == (16, 24)
    assert bq.shape == (16,)


@pytest.mark.parametrize("form", list(probe.FORMS))
def test_errors_are_against_float64_of_the_rounded_function(form):
    from gcn_song_embeddings_tpu_torch.ops import agg
    from gcn_song_embeddings_tpu_torch.utils import precision

    args = probe.problem(torch, torch.device("cpu"), 9, 40, 12, seed=3)
    err, plain_err = probe.errors(torch, agg, precision, form, args)
    assert err.dtype == torch.float64 and err.shape == (9, 12)
    assert torch.equal(err, plain_err)
    assert 0 < float(err.abs().max()) < 1e-5


@pytest.mark.parametrize("form", list(probe.FORMS))
def test_k2_errors_are_against_float64_of_the_rounded_function(form):
    from gcn_song_embeddings_tpu_torch.ops import agg
    from gcn_song_embeddings_tpu_torch.utils import precision

    args = probe.problem(torch, torch.device("cpu"), 9, 40, 12, seed=4)
    err, plain_err = probe.errors(torch, agg, precision, form, args,
                                  probe.KERNELS["K2"])
    assert err.dtype == torch.float64 and err.shape == (9, 12)
    assert torch.equal(err, plain_err)
    assert 0 < float(err.abs().max()) < 1e-5


def test_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe runs there")
    assert probe.main(["--seeds", "1"]) == 1


@pytest.mark.parametrize("flag,known", [("--kernels", "K2"),
                                        ("--forms", "f16")])
def test_main_refuses_an_unknown_kernel_or_form(flag, known, capsys):
    # refused as it parses its arguments, before it looks for a card
    with pytest.raises(SystemExit) as exit_:
        probe.main([flag, f"{known},nope"])
    assert exit_.value.code == 2
    assert f"{flag}: unknown nope (of " in capsys.readouterr().err
