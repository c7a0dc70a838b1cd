"""The bench's difference method never returns a time that is not
positive (``fullgraph_bench.chunk_difference``, ``bench.rep_difference``):
a median difference <= 0, which a host stall inside one wall makes, is
measured again a bounded number of times, and then refused."""

import itertools

import pytest

from gcn_song_embeddings_tpu_torch import bench
from gcn_song_embeddings_tpu_torch import fullgraph_bench as fb


def _chunk_walls(walls):
    """``wall(n_chunk, i)`` for ``chunk_difference`` returning ``walls``
    in turn, the calls recorded."""
    it = iter(walls)
    calls = []

    def wall(n_chunk, i):
        calls.append((n_chunk, i))
        return next(it)
    return wall, calls


def test_a_stalled_chunk_pair_is_measured_again():
    # one rep: small 0.50 s (a stall), large 0.20 s -> -0.3 / 1; then a
    # clean pair 0.10 s / 0.20 s -> 0.1 s a batch
    wall, calls = _chunk_walls([0.5, 0.2, 0.1, 0.2])
    assert fb.chunk_difference(wall, 1, 2, reps=1) == pytest.approx(0.1)
    assert calls == [(1, 2), (2, 3)] * 2


def test_chunk_walls_that_never_give_a_positive_time_raise():
    wall, calls = _chunk_walls(itertools.cycle([0.3, 0.2]))
    with pytest.raises(RuntimeError, match=r"chunks of 1 and 2 steps.*0\.3"):
        fb.chunk_difference(wall, 1, 2, reps=3)
    assert len(calls) == 2 * 3 * fb.ATTEMPTS


def _rep_walls(walls):
    """``wall(f)`` for ``rep_difference`` returning ``walls`` in turn
    (``f`` is called, as the real walls do)."""
    it = iter(walls)

    def wall(f):
        f()
        return next(it)
    return wall


def test_a_stalled_rep_pair_is_measured_again():
    # the two warm calls, then (large, small) pairs: 0.1 - 0.4 < 0, then
    # 0.5 - 0.1 = 0.4 over 20 - 4 reps
    wall = _rep_walls([0.0, 0.0, 0.1, 0.4, 0.5, 0.1])
    got = bench.rep_difference(wall, lambda r: r, 4, 20, 1)
    assert got == pytest.approx(0.4 / 16)


def test_rep_walls_that_never_give_a_positive_time_raise():
    wall = _rep_walls(itertools.chain([0.0, 0.0],
                                      itertools.repeat(0.25)))
    with pytest.raises(RuntimeError, match="reps of 4 and 20"):
        bench.rep_difference(wall, lambda r: r, 4, 20, 3)


def test_a_median_over_one_stalled_pair_of_three_is_kept():
    """The median absorbs one stalled pair of three: no second round."""
    wall, calls = _chunk_walls([0.1, 0.2, 0.5, 0.2, 0.1, 0.3])
    assert fb.chunk_difference(wall, 1, 2, reps=3) == pytest.approx(0.1)
    assert len(calls) == 6
