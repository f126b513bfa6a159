"""K21's and K6's launch plans (``ops/descriptors.py`` ``ransac_plan``,
``ops/downsample.py`` ``downsample_plan``) and the exact integer tricks of
K6's fast path, held on the CPU against what the kernels do.

K21 (``csrc/ransac.cu``) gives a block RANSAC_GROUP hypotheses (lane l's
slot s holds hypothesis 128 g + 32 s + l) and one split of the candidates,
walked in tiles of RANSAC_TILE, each warp taking every eighth candidate of
a tile; the emulation must reach every hypothesis once and every candidate
once, and the plan must pass the launcher's checks. K6
(``csrc/downsample.cu``) walks rows b OX + i, j and runs of
DOWNSAMPLE_R z outputs (one on its general path) with grid strides where
the grid is cut to the card's limits; the emulation must write every
output once. Its fast path widens integers through the float's mantissa
and converts to storage by clamping and adding 2^23: both must give what
``static_cast<float>`` and ``rintf``, clamp and cast give, for every value
of the types it reads.
"""

import numpy as np
import pytest

from bigstitcher_spark_tpu_torch.ops import descriptors as DS
from bigstitcher_spark_tpu_torch.ops import downsample as D

WARPS = 8  # csrc/ransac.cu kScoreWarps


# ------------------------------------------------------------ K21


def _ransac_launcher_accepts(plan, M, I) -> bool:
    """The checks bst_ransac_score makes of a plan."""
    per, splits = plan.per_split, plan.splits
    return (plan.groups == -(-I // DS.RANSAC_GROUP)
            and 1 <= splits <= 65535 and per >= 1 and per % 4 == 0
            and splits * per >= M > (splits - 1) * per)


def _ransac_walk(plan, M, I):
    """How often the kernel's (block, warp, lane, slot) walk reaches each
    hypothesis (counted once a block group, over its first split) and
    each candidate (over every group's splits, counted for group 0)."""
    hyp = np.zeros(I, np.int64)
    cand = np.zeros(M, np.int64)
    lanes = np.arange(32)
    for g in range(plan.groups):
        for slot in range(DS.RANSAC_GROUP // 32):
            h = g * DS.RANSAC_GROUP + 32 * slot + lanes
            np.add.at(hyp, h[h < I], 1)
    for s in range(plan.splits):
        c_end = min(M, (s + 1) * plan.per_split)
        for t0 in range(s * plan.per_split, c_end, DS.RANSAC_TILE):
            n = min(DS.RANSAC_TILE, c_end - t0)
            for w in range(WARPS):
                np.add.at(cand, t0 + np.arange(w, n, WARPS), 1)
    return hyp, cand


@pytest.mark.parametrize("M,I", [(1, 1), (1, 130), (155, 10000),
                                 (200, 129), (1317, 257), (5000, 3000),
                                 (20000, 1000), (58274, 10000),
                                 (100000, 1), (257, 128)], ids=str)
def test_ransac_plan_walk_covers_each_pair_once(M, I):
    plan = DS.ransac_plan(M, I)
    assert _ransac_launcher_accepts(plan, M, I)
    hyp, cand = _ransac_walk(plan, M, I)
    assert (hyp == 1).all() and (cand == 1).all()


@pytest.mark.parametrize("M,I", [(58274, 10000), (5000, 3000),
                                 (20000, 1000), (3000, 200)], ids=str)
@pytest.mark.parametrize("sms", [132, 114, 78])
def test_ransac_plan_fills_the_card(M, I, sms):
    """Where the candidates allow it, the blocks fill the card's block
    slots (RANSAC_BLOCKS_PER_SM an SM) at least once and their last wave is
    as full as any split count up to four times the least gives; no split
    is shorter than a tile."""
    plan = DS.ransac_plan(M, I, sms)
    slots = DS.RANSAC_BLOCKS_PER_SM * sms
    blocks = plan.groups * plan.splits
    most = max(1, M // DS.RANSAC_TILE)
    if most * plan.groups >= slots:
        assert blocks >= slots
    assert plan.splits <= most
    least = min(most, -(-slots // plan.groups))
    fill = lambda s: plan.groups * s / (slots * -(-plan.groups * s // slots))
    assert fill(plan.splits) == max(fill(s) for s in
                                    range(least, min(most, 4 * least) + 1))
    if plan.splits > 1:
        assert M - (plan.splits - 1) * plan.per_split >= 1
        assert plan.per_split >= DS.RANSAC_TILE


def test_ransac_plan_at_the_main_paths_shapes():
    """9b's pair and 9a's: 79 groups; 9b cut into 10 splits of 5,828
    candidates (790 blocks: 3 waves of the 264 slots of 132 SMs but 2), 9a's
    155 candidates in one."""
    assert DS.ransac_plan(58274, 10000) == DS.RansacPlan(79, 10, 5828, True)
    assert DS.ransac_plan(155, 10000) == DS.RansacPlan(79, 1, 156, True)


@pytest.mark.parametrize("addr,vec", [(0, True), (4096 | 512, True),
                                      (4096 | 8, False), (256 | 4, False)])
def test_ransac_plan_vector_staging_by_alignment(addr, vec):
    """Float4 staging where both arrays' addresses (or'd) are 16-byte
    aligned."""
    assert DS.ransac_plan(1000, 100, addr=addr).vec is vec


def test_ransac_plan_refuses_empty_work():
    for M, I in ((0, 10), (10, 0)):
        with pytest.raises(ValueError, match="needs candidates"):
            DS.ransac_plan(M, I)


# ------------------------------------------------------------ K6


def _downsample_walk(plan) -> np.ndarray:
    """How often the kernel's strided walk over rows, j and runs writes
    each output of ``plan``: row = bx + n gx, j = (by + n gy) ty + t_y,
    run = (bz + n gz) tx + t_x, outputs run R .. run R + R - 1 below OZ
    (R = DOWNSAMPLE_R on the fast path, else 1)."""
    B, X, Y, Z = plan.shape
    OX, OY, OZ = plan.dims
    tx, ty = plan.block
    gx, gy, gz = plan.grid
    R = D.DOWNSAMPLE_R if plan.fast else 1
    runs = -(-OZ // R)
    hits = np.zeros((B * OX, OY, OZ), np.int64)
    rows = np.arange(B * OX)
    js = np.concatenate([np.arange(by * ty, by * ty + ty) + n * gy * ty
                         for by in range(gy)
                         for n in range(-(-OY // (gy * ty)) + 1)])
    rs = np.concatenate([np.arange(bz * tx, bz * tx + tx) + n * gz * tx
                         for bz in range(gz)
                         for n in range(-(-runs // (gz * tx)) + 1)])
    js, rs = js[js < OY], rs[rs < runs]
    assert len(np.unique(js)) == len(js) and len(np.unique(rs)) == len(rs)
    assert gx >= 1 and len(rows) >= 1
    for r in rs:
        k = np.arange(r * R, min(r * R + R, OZ))
        hits[np.ix_(rows, js, k)] += 1
    return hits


@pytest.mark.parametrize("shape,factors,dims", [
    ((1, 195, 195, 132), (2, 2, 2), (97, 97, 66)),     # the level, cut
    ((4, 25, 25, 128), (2, 2, 2), (12, 12, 64)),       # the batch
    ((4, 25, 25, 45), (2, 2, 1), (12, 12, 45)),        # route D's rows
    ((1, 1, 64, 4096), (1, 2, 1), (1, 32, 4096)),      # one-axis, axis 0
    ((1, 300, 128, 1), (1, 2, 1), (300, 64, 1)),       # one-axis, last axis
    ((3, 20, 17, 9), (3, 1, 2), (6, 17, 4)),
    ((1, 16, 8, 24), (2, 2, 8), (8, 4, 3)),            # the general path
    ((1, 9, 8, 7), (2, 2, 2), (5, 4, 5)),              # a padded level
], ids=str)
def test_downsample_plan_walk_covers_each_output_once(shape, factors, dims):
    plan = D.downsample_plan(shape, factors, dims, 2, 4)
    assert (_downsample_walk(plan) == 1).all()
    # the grid cut to one block a dimension: the strides cover the rest
    small = plan._replace(grid=(plan.grid[0], 1, 1))
    assert (_downsample_walk(small) == 1).all()


def test_downsample_plan_at_the_main_paths_shapes():
    """Route A's first level (uint16 rows of 264 bytes: 8-byte loads; 132-
    byte output rows: 4-byte stores), the downsample stage's batch (16-byte
    loads and stores), route D's boxes (2-byte aligned rows: element
    loads) and the one-axis form's last axis (re-viewed, so that the tile's
    128-wide axis is fastest)."""
    P = D.downsample_plan
    level = P((1, 1952, 1952, 132), (2, 2, 2), (976, 976, 66), 2, 2)
    assert (level.fast, level.vb, level.vs, level.block, level.grid) == (
        True, 8, 4, (9, 28), (976, 35, 1))
    batch = P((4, 256, 256, 128), (2, 2, 2), (128, 128, 64), 2, 4)
    assert (batch.vb, batch.vs, batch.block, batch.grid) == (
        16, 16, (8, 32), (512, 4, 1))
    route_d = P((4, 256, 256, 45), (2, 2, 1), (128, 128, 45), 2, 4)
    assert (route_d.vb, route_d.vs, route_d.block) == (0, 4, (6, 42))
    last = P((1, 1048576, 128, 1), (1, 2, 1), (1048576, 64, 1), 2, 4)
    assert (last.shape, last.factors, last.dims) == (
        (1, 1, 1048576, 128), (1, 1, 2), (1, 1048576, 64))
    assert (last.vb, last.vs, last.grid) == (16, 16, (1, 32768, 1))


@pytest.mark.parametrize("fz", [1, 2])
@pytest.mark.parametrize("Z", [1, 3, 45, 66, 128, 132])
@pytest.mark.parametrize("addr,itemsize", [
    (a, i) for i in (1, 2, 4) for a in (0, 2, 4, 8, 24, 4096 + 2)
    if a % i == 0], ids=str)
def test_downsample_plan_vector_width_by_alignment(addr, itemsize, Z, fz):
    """The load width divides the address, the row's bytes and a thread's
    run of R fz inputs, is the largest power of two (at most 16) that does,
    and is 0 (element loads) below 4 bytes."""
    plan = D.downsample_plan((2, 8, 6, Z), (2, 2, fz), (4, 3, max(1, Z // fz)),
                             itemsize, 4, addr, 256)
    if plan.shape[3] != Z:  # a trailing size-1 axis re-viewed
        assert Z == 1 and fz == 1
        return
    run = D.DOWNSAMPLE_R * fz * itemsize
    want = 16
    while want >= 4 and ((addr and addr % want) or (Z * itemsize) % want
                         or run % want):
        want //= 2
    assert plan.vb == (want if want >= 4 else 0)
    if plan.vb:
        assert (addr % plan.vb, Z * itemsize % plan.vb, run % plan.vb) == (
            0, 0, 0)


@pytest.mark.parametrize("OZ,out_itemsize,vs", [
    (66, 2, 4), (64, 4, 16), (45, 4, 4), (33, 2, 0), (8, 1, 8), (12, 1, 4),
    (64, 2, 16), (7, 1, 0)])
def test_downsample_plan_store_width(OZ, out_itemsize, vs):
    """The store width divides the output row and a run of R outputs."""
    plan = D.downsample_plan((1, 4, 4, 2 * OZ), (2, 2, 2), (2, 2, OZ), 2,
                             out_itemsize, 0, 256)
    assert plan.vs == vs


@pytest.mark.parametrize("factors,fast", [
    ((2, 2, 2), True), ((2, 2, 1), True), ((4, 4, 2), True),
    ((1, 1, 3), False), ((2, 2, 8), False), ((3, 1, 2), True),
    ((2 ** 20, 1, 1), True), ((2 ** 20 + 1, 1, 1), False)], ids=str)
def test_downsample_plan_path_by_factors(factors, fast):
    """fz of 1 or 2 with fx and fy up to 2^20 take the fast path (R z
    outputs a thread, vector access); the rest the general path (one
    output a thread, element access)."""
    plan = D.downsample_plan((1, 2 ** 20 + 1, 4, 32), factors,
                             (1, 2, max(1, 32 // factors[2])), 2, 4)
    assert plan.fast is fast
    if not fast:
        assert (plan.vb, plan.vs) == (0, 0)
        assert plan.block[0] == min(plan.dims[2], D.DOWNSAMPLE_THREADS)


def test_downsample_plan_reviews_only_a_plain_trailing_axis():
    """(B, X, Y, 1) with fz = 1 and OZ = 1 becomes (B, 1, X, Y) with
    factors (1, fx, fy): the sums along x, then y, are the same operations
    in the same order. fz = 2 over one plane, or OZ > 1 (padding), keep
    their shape."""
    P = D.downsample_plan
    p = P((2, 6, 8, 1), (3, 2, 1), (2, 4, 1), 2, 4)
    assert (p.shape, p.factors, p.dims) == ((2, 1, 6, 8), (1, 3, 2),
                                           (1, 2, 4))
    for factors, dims in (((2, 2, 2), (3, 4, 1)), ((2, 2, 1), (3, 4, 2))):
        p = P((2, 6, 8, 1), factors, dims, 2, 4)
        assert p.shape == (2, 6, 8, 1) and p.factors == factors


def test_downsample_plan_grid_limits():
    """j tiles and run tiles are cut to 65,535 (the kernel strides over the
    rest); more than 2^31 - 1 output slices are refused."""
    p = D.downsample_plan((1, 1, 2 ** 26, 2), (1, 2, 1), (1, 2 ** 25, 2), 2,
                          4)
    assert p.grid[1] == 65535 and p.block == (1, 256)
    p = D.downsample_plan((1, 1, 1, 2 ** 28), (1, 1, 1), (1, 1, 2 ** 28), 2,
                          4)
    assert p.grid[2] == 65535 and p.block == (256, 1)
    with pytest.raises(ValueError, match="exceed the launch grid"):
        D.downsample_plan((2 ** 16, 2 ** 16, 2, 2), (1, 1, 1),
                          (2 ** 16, 2, 2), 1, 4)
    with pytest.raises(ValueError, match="empty downsample"):
        D.downsample_plan((1, 0, 2, 2), (1, 1, 1), (1, 2, 2), 1, 4)


# -------------------------------------------- K6's exact integer tricks


def _byte_perm(x, y, s):
    """CUDA's __byte_perm on uint32 numpy arrays."""
    v = x.astype(np.uint64) | (np.uint64(y) << np.uint64(32))
    out = np.zeros_like(x, dtype=np.uint64)
    for i in range(4):
        sel = (s >> (4 * i)) & 7
        out |= ((v >> np.uint64(8 * sel)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _widen(words, selector, bias):
    return (_byte_perm(words, 0x4B000000, selector).view(np.float32)
            - np.float32(bias))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16], ids=str)
def test_mantissa_widening_is_exact(dtype):
    """Elem<T>::get: every value of the type, from either position of its
    32-bit word, comes out as float(v) exactly."""
    info = np.iinfo(dtype)
    v = np.arange(info.min, info.max + 1).astype(dtype)
    per = 4 // np.dtype(dtype).itemsize
    words = np.resize(v, (len(v) + per - 1) // per * per).view(np.uint32)
    vals = np.resize(v, len(words) * per).reshape(-1, per)
    for u in range(per):
        if dtype == np.uint8:
            got = _widen(words, 0x7440 + u, 2 ** 23)
        elif dtype == np.uint16:
            got = _widen(words, 0x7432 if u else 0x7410, 2 ** 23)
        else:
            got = _widen(words ^ np.uint32(0x80008000),
                         0x7432 if u else 0x7410, 2 ** 23 + 2 ** 15)
        assert np.array_equal(got, vals[:, u].astype(np.float32))


@pytest.mark.parametrize("imax", [255.0, 65535.0])
def test_storage_rounding_by_adding_two_to_the_23(imax):
    """storage_bits: clamp to [0, imax], add 2^23, keep the low 16 bits:
    the integer that rintf (half to even), clamp and cast give, for
    halves, values just inside and past both ends, signed zeros,
    infinities and NaN."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.uniform(-10, imax + 10, 200000),
        np.arange(-3, imax + 3, 0.5),
        np.nextafter(np.float32([0.5, 1.5, imax - 0.5, imax + 0.5]),
                     np.float32(np.inf)),
        np.nextafter(np.float32([0.5, 1.5, imax - 0.5, imax + 0.5]),
                     np.float32(-np.inf)),
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e30, -1e30]]).astype(np.float32)
    with np.errstate(invalid="ignore"):
        clamped = np.fmin(np.fmax(x, np.float32(0)), np.float32(imax))
        got = ((clamped + np.float32(2 ** 23)).view(np.uint32)
               & np.uint32(0xFFFF))
        want = np.fmin(np.fmax(np.rint(x), np.float32(0)),
                       np.float32(imax))
    assert np.array_equal(got, want.astype(np.uint32))
