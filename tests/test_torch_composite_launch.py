"""K1's launch (``ops/fusion.py`` ``composite_plan``, ``composite_records``,
``composite_block_boxes``) and K12's (model, regulariser) dispatch
(``ops/solve.py`` ``fit_pair``), held on the CPU against numpy emulations
of what the kernels and their launchers do.

K1 (``csrc/composite.cu``) gives a thread COMPOSITE_R consecutive z outputs
of one (i, j) column (a run), a block tile_j columns of tile_i consecutive
i, whole columns where they hold at most COMPOSITE_MAX_RUNS runs, else z
tiles of that many runs. The emulation walks every block,
thread, i and voxel and must land on every output voxel exactly once, for
volumes that are not multiples of the run, the column tile or the x tile.
The records list the views in the order their contributions are combined
(FIRST_WINS reversed), views with empty windows left out; a block skips a
view at an x slice when the view's window misses the slice's box, and must
keep every view that covers a voxel of it.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from bigstitcher_spark_tpu_torch.cli import solver_tools
from bigstitcher_spark_tpu_torch.ops import _cuda
from bigstitcher_spark_tpu_torch.ops import fusion as F
from bigstitcher_spark_tpu_torch.ops import models as M
from bigstitcher_spark_tpu_torch.ops import solve as R

torch.set_num_threads(1)

R_ = F.COMPOSITE_R


def _launcher_accepts(plan, shape) -> bool:
    """The checks bst_composite makes of a plan."""
    X, Y, Z = shape
    runs = -(-Z // R_)
    whole = runs <= F.COMPOSITE_MAX_RUNS
    return (plan.tile_runs == (runs if whole else F.COMPOSITE_MAX_RUNS)
            and 1 <= plan.tile_j <= Y
            and plan.tile_j * plan.tile_runs <= F.COMPOSITE_THREADS
            and plan.n_jt == -(-Y // plan.tile_j)
            and 1 <= plan.tile_i <= F.COMPOSITE_MAX_TILE_I
            and plan.grid[0] == -(-X // plan.tile_i) * plan.n_jt
            and plan.grid[1] == -(-runs // plan.tile_runs)
            and plan.grid[1] <= 65535)


def _walk(plan, shape):
    """Every (i, j, k) the kernel's blocks, threads, x slices and run
    voxels reach, with the block index of each: block x -> (x tile
    bx / n_jt, column tile bx mod n_jt), thread t -> (column t / tile_runs,
    run t mod tile_runs), kept where j < Y and k < Z."""
    X, Y, Z = shape
    nt = plan.tile_j * plan.tile_runs
    bx, by, t, ii, r = np.meshgrid(np.arange(plan.grid[0]),
                                   np.arange(plan.grid[1]), np.arange(nt),
                                   np.arange(plan.tile_i), np.arange(R_),
                                   indexing="ij")
    it, jt = bx // plan.n_jt, bx % plan.n_jt
    i = it * plan.tile_i + ii
    j = jt * plan.tile_j + t // plan.tile_runs
    k = (by * plan.tile_runs + t % plan.tile_runs) * R_ + r
    keep = (i < X) & (j < Y) & (k < Z)
    block = by * plan.grid[0] + bx
    return i[keep], j[keep], k[keep], block[keep]


SHAPES = [(5, 3, 7), (1, 1, 1), (16, 40, 132), (9, 31, 8), (3, 2, 257),
          (17, 300, 2), (2, 5, 2600), (8, 15, 136)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_every_voxel_once(shape):
    plan = F.composite_plan(shape)
    assert _launcher_accepts(plan, shape)
    i, j, k, _ = _walk(plan, shape)
    count = np.zeros(shape, np.int64)
    np.add.at(count, (i, j, k), 1)
    assert (count == 1).all()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_block_boxes_hold_their_threads(shape):
    """composite_block_boxes gives each block the box its threads' voxels
    span (the box the kernel tests the windows against)."""
    plan = F.composite_plan(shape)
    boxes = F.composite_block_boxes(plan, shape)
    assert boxes.shape == (plan.grid[0] * plan.grid[1], 2, 3)
    i, j, k, b = _walk(plan, shape)
    for d, c in enumerate((i, j, k)):
        lo = np.full(len(boxes), np.iinfo(np.int64).max)
        hi = np.full(len(boxes), -1)
        np.minimum.at(lo, b, c)
        np.maximum.at(hi, b, c)
        assert (boxes[:, 0, d] == lo).all() and (boxes[:, 1, d] == hi + 1).all()


def test_plan_at_route_a():
    """Route A's 1952 x 1952 x 132: 17 runs a column, whole columns, 7 a
    block of 119 threads, one z tile, 16 x slices a block."""
    plan = F.composite_plan((1952, 1952, 132))
    assert plan.tile_runs == 17 and plan.tile_j == 7 and plan.tile_i == 16
    assert plan.grid == (122 * 279, 1)


@pytest.mark.parametrize("shape,tile_i", [
    ((256, 256, 64), 1), ((1024, 1024, 128), 16), ((512, 512, 64), 4),
    ((3, 4, 5), 1)], ids=str)
def test_plan_x_tile_fills_the_card(shape, tile_i):
    """The longest x tile (a power of two up to 16) that still leaves
    COMPOSITE_MIN_BLOCKS blocks: phase 1's 256 x 256 x 64 block takes
    one x slice a block."""
    plan = F.composite_plan(shape)
    assert plan.tile_i == tile_i
    blocks = plan.grid[0] * plan.grid[1]
    assert blocks >= F.COMPOSITE_MIN_BLOCKS or plan.tile_i == 1


def test_plan_refuses_empty_and_huge():
    with pytest.raises(ValueError):
        F.composite_plan((0, 4, 4))
    with pytest.raises(ValueError):
        F.composite_plan((4, 4, 8 * 32 * 65536 + 1))


def _windows(rng, V, shape, n_empty):
    """V random windows inside ``shape``; ``n_empty`` of them empty."""
    wins = []
    for v in range(V):
        a = [int(rng.integers(0, s)) for s in shape]
        b = [int(rng.integers(a[d] + 1, shape[d] + 1)) for d in range(3)]
        if v < n_empty:
            d = int(rng.integers(0, 3))
            b[d] = a[d]
        wins.append((tuple(a), tuple(b)))
    order = rng.permutation(V)
    return [wins[o] for o in order]


def _records(wins, fusion_type, coeffs=False):
    V = len(wins)
    tiles = [torch.zeros((2 + v % 3, 3, 4), dtype=torch.uint16)
             for v in range(V)]
    starts, at = [], 0
    for a, b in wins:
        if any(b[d] <= a[d] for d in range(3)):
            starts.append(None)
            continue
        starts.append(at)
        at += 2 * sum(b[d] - a[d] for d in range(3))
    coffs = [None if s is None else 3 * s for s in starts]
    grids = torch.zeros((V, 2, 2, 2, 2)) if coeffs else None
    rng = np.random.default_rng(V)
    fr = rng.uniform(0, 1, (V, 3)).astype(np.float32)
    recs, order = F.composite_records(
        tiles, starts, wins, [(v, -v, 2 * v) for v in range(V)], (1, 2, 3),
        ["sep" if v % 5 == 0 else "shift" for v in range(V)], fr,
        np.ones((V, 3), np.float32), fr + 1, fusion_type, grids,
        coffs if coeffs else None)
    return tiles, starts, recs, order, grids, fr


@pytest.mark.parametrize("fusion_type", F.FUSION_TYPES)
@pytest.mark.parametrize("V", [1, 9, 64])
def test_records_order_and_fields(fusion_type, V):
    rng = np.random.default_rng(V)
    wins = _windows(rng, V, (20, 30, 40), n_empty=V // 4)
    tiles, starts, recs, order, grids, fr = _records(wins, fusion_type,
                                                     coeffs=True)
    want = [v for v in (range(V - 1, -1, -1) if fusion_type == "FIRST_WINS"
                        else range(V)) if starts[v] is not None]
    assert order == want
    size = ctypes.sizeof(_cuda.BstCompositeView)
    assert size == 144 and len(recs) == size * len(order)
    arr = (_cuda.BstCompositeView * len(order)).from_buffer_copy(recs)
    for rec, v in zip(arr, order):
        (a, b) = wins[v]
        assert tuple(rec.a) == a and tuple(rec.b) == b
        assert tuple(rec.n) == (v, -v, 2 * v) and tuple(rec.pad) == (1, 2, 3)
        assert tuple(rec.tshape) == tuple(tiles[v].shape)
        assert rec.kind == (1 if v % 5 == 0 else 0)
        assert rec.table_off == starts[v] and rec.ctab_off == 3 * starts[v]
        assert rec.tile == tiles[v].data_ptr()
        assert rec.grid == grids[v].data_ptr()
        np.testing.assert_array_equal(np.array(rec.frac, np.float32), fr[v])


def test_records_without_views():
    """Every window empty: no record, and the launch still writes every
    voxel (nviews 0)."""
    recs, order = F.composite_records(
        [torch.zeros((2, 2, 2))], [None], [((0, 0, 0), (0, 3, 3))],
        [(0, 0, 0)], (1, 1, 1), ["shift"], np.zeros((1, 3)),
        np.ones((1, 3)), np.zeros((1, 3)), "AVG")
    assert order == [] and recs == b""


@pytest.mark.parametrize("shape", [(16, 40, 132), (9, 31, 8), (3, 5, 300)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("V", [4, 64])
def test_blocks_keep_every_view_that_meets_them(shape, V):
    """The kernel's test at an x slice (i in [a0, b0), the block's j and z
    ranges meeting the window's) keeps exactly the views whose window holds
    a voxel of the slice's part of the block."""
    rng = np.random.default_rng(V + shape[2])
    wins = [w for w in _windows(rng, V, shape, n_empty=V // 4)
            if all(w[1][d] > w[0][d] for d in range(3))]
    plan = F.composite_plan(shape)
    boxes = F.composite_block_boxes(plan, shape)
    i, j, k, b = _walk(plan, shape)
    for v, (a, e) in enumerate(wins):
        inside = ((i >= a[0]) & (i < e[0]) & (j >= a[1]) & (j < e[1])
                  & (k >= a[2]) & (k < e[2]))
        met = set(zip(b[inside].tolist(), i[inside].tolist()))
        kept = set()
        for blk, box in enumerate(boxes):
            for x in range(box[0, 0], box[1, 0]):
                if not (x < a[0] or x >= e[0] or box[1, 1] <= a[1]
                        or box[0, 1] >= e[1] or box[1, 2] <= a[2]
                        or box[0, 2] >= e[2]):
                    kept.add((blk, x))
        assert kept == met, f"view {v}"


# ---------------------------------------------------------------- K12


CLI_PAIRS = [(m, r) for m in solver_tools._MODELS for r in solver_tools._REGS]


@pytest.mark.parametrize("model,reg", CLI_PAIRS)
def test_fit_pair_covers_every_cli_pair(model, reg):
    """Every (model, regulariser) the solver CLI accepts has a K12
    instantiation: its codes are csrc/solve.cu's Model enum's."""
    codes = {"NONE": -1, "IDENTITY": 0, "TRANSLATION": 1, "RIGID": 2,
             "AFFINE": 3}
    assert R.fit_pair(model, reg) == (codes[model], codes[reg])


@pytest.mark.parametrize("reg", solver_tools._REGS)
def test_fit_pair_refuses_none_as_model(reg):
    with pytest.raises(ValueError, match="NONE is a regulariser"):
        R.fit_pair(M.NONE, reg)
    with pytest.raises(ValueError):
        R.fit_pair("SIMILARITY", reg)
    with pytest.raises(ValueError):
        R.fit_pair(M.RIGID, "SIMILARITY")


def test_fit_launcher_instantiates_every_pair():
    """bst_relax_fit dispatches every model of FIT_MODELS, each with every
    regulariser of FIT_REGS, to a templated kernel (read from its source)."""
    with open(f"{_cuda.CSRC}/solve.cu") as f:
        src = f.read()
    launcher = src[src.index('extern "C" int bst_relax_fit('):]
    launcher = launcher[:launcher.index("#undef BST_FIT_REG")]
    models = set(re.findall(r"case (\w+): BST_FIT_REG\((\w+)\)", launcher))
    assert models == {(m, m) for m in R.FIT_MODELS}
    macro = src[src.index("#define BST_FIT_REG(M)"):
                src.index('extern "C" int bst_relax_fit(')]
    regs = set(re.findall(r"launch_fit<M, (\w+)>", macro))
    assert regs == set(R.FIT_REGS)
