"""K24's launch shape (``ops/solve.py`` ``cg_lanes``, ``cg_blocks``): pure
functions of the row count and the terms, held against numpy on the CPU.

K24 gives each row G lanes, G the power of two (1 to 32) nearest a quarter
of the mean row length, ties going to the larger; its grid is one block of 256 threads
per 8 groups of 256 / G rows, and the partials buffer holds a double a
block and at least K25's 1024.
"""

import numpy as np
import pytest

from bigstitcher_spark_tpu_torch.ops import intensity as OI
from bigstitcher_spark_tpu_torch.ops import solve as R


def _nearest_pow2(mean: float) -> int:
    cands = 2 ** np.arange(6)
    d = np.abs(cands - mean)
    return int(cands[np.flatnonzero(d == d.min())[-1]])


@pytest.mark.parametrize("n,nnz", [
    (10, 0), (10, 10), (10, 59), (10, 60), (10, 119), (10, 120), (100, 790),
    (100, 2399), (100, 2400), (10, 470), (10, 1300), (10, 5000)])
def test_cg_lanes_is_the_nearest_power_of_two(n, nnz):
    assert R.cg_lanes(n, nnz) == _nearest_pow2(nnz / n / 4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cg_lanes_of_random_rows(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, rng.integers(2, 70), rng.integers(1, 5000))
    assert (R.cg_lanes(len(lengths), int(lengths.sum()))
            == _nearest_pow2(lengths.mean() / 4))


@pytest.mark.parametrize("lanes", R.CG_LANES)
@pytest.mark.parametrize("n", [1, 7, 8, 255, 256, 257, 777, 524_288])
def test_cg_blocks_cover_every_row_once(n, lanes):
    rows = 256 // lanes * R.CG_SWEEPS
    blocks = R.cg_blocks(n, lanes)
    assert blocks == int(np.ceil(n / rows))
    assert (blocks - 1) * rows < n <= blocks * rows
    partials = R._cg_partials(blocks, "cpu")
    assert partials.numel() >= max(blocks, R.CG_UPDATE_BLOCKS)


def test_cg_lanes_of_an_intensity_system():
    """On an assembled system the choice is numpy's nearest power of two
    to a quarter of the mean of its row lengths."""
    rng = np.random.default_rng(3)
    C = 256
    ca = rng.integers(0, C, 400)
    cb = (ca + rng.integers(1, 9, 400)) % C
    stats = rng.uniform(1.0, 50.0, (400, 6))
    matches = np.column_stack([ca, cb, stats])
    smooth = np.stack([np.arange(C - 1), np.arange(1, C)], 1)
    sysm = R.assemble_cg(C, *OI.intensity_system(C, matches, 0.1, smooth),
                         "cpu")
    lengths = sysm.row_len.numpy()
    assert sysm.cols.numel() == lengths.sum()
    assert R.cg_lanes(sysm.n, sysm.cols.numel()) == _nearest_pow2(
        lengths.mean() / 4)
