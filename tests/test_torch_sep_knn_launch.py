"""K5's and K19's launch plans (``ops/fusion.py`` ``sep_launch_plan``,
``ops/descriptors.py`` ``knn_plan``) and the arithmetic of the two
kernels, held on the CPU against numpy emulations of what they do.

K5 (``csrc/sep.cu``) gives a thread SEP_R z outputs of one (i, j) column,
interleaved (k = z0 + lz + lanes_z r), lanes_z threads a column, a block
of SEP_THREADS threads a tile of one i, the batch row in the grid's third
index. Per view a block tabulates the x tap of its i, each column's y
weights, x-y products and 4 patch-row offsets, and each k's z tap and z
tables, with the parent's fmaf and interp_row; a voxel reads its 8 taps
at row offset + lo_z and + hi_z. The emulation walks every block, thread
and output: every voxel of every batch row is written once (ragged blocks
too), and every tap read through the tables is the patch value that
interp_row names on each axis (diag 3, 1/3, a mirrored axis, y steps
above 1, a z extent of 1). The kernel's arithmetic (1 - f once, x then y
then z, the column's x-y products once) gives ``fuse_block_sep_plain``'s
outputs bit for bit.

K19 (``csrc/descriptors.cu``) packs the candidates as float4, scans them in
a grid of (row blocks, splits, B) blocks, a thread holding Q queries (i =
row0 + t + 128 q), a split's candidates in stages of KNN_TILE, the self
test only on stages that hold a query's own index, the exact insertion only
where d <= thr; the tail merges the splits' lists in split order, fixes
the list of a query that is not valid (masked) and makes the descriptors.
The emulation runs that scan and merge in numpy float32 and gives the
twin's indices, descriptors and flags bit for bit (K not a multiple of the
stage or of Q x 128, duplicate points, pools 1-8, B > 1 masked with a
block of fewer valid points than a pool, forced splits).
"""

import math

import numpy as np
import pytest
import torch

from bigstitcher_spark_tpu_torch.ops import descriptors as DS
from bigstitcher_spark_tpu_torch.ops import fusion as F

torch.set_num_threads(1)

F32 = np.float32
R = F.SEP_R

# ------------------------------------------------------------------ K5


def _k5_outputs(plan, bs, B):
    """Every (b, i, j, k) a thread of K5's launch stores, as the kernel
    finds its place: flattened arrays of the stored voxels."""
    bx, by, bz = bs
    lz_n, (_, tile_j, tile_z) = plan.lanes_z, plan.tile
    gx, gy, gz = plan.grid
    b0 = np.arange(gx)[:, None, None, None, None]
    b1 = np.arange(gy)[None, :, None, None, None]
    b2 = np.arange(gz)[None, None, :, None, None]
    t = np.arange(F.SEP_THREADS)[None, None, None, :, None]
    r = np.arange(R)[None, None, None, None, :]
    i = b0 // plan.n_jt
    j = (b0 - i * plan.n_jt) * tile_j + t // lz_n
    k = b1 * tile_z + (t & (lz_n - 1)) + lz_n * r
    b, i, j, k = np.broadcast_arrays(b2, i, j, k)
    keep = (j < by) & (k < bz)
    return b[keep], i[keep], j[keep], k[keep]


K5_BLOCKS = [(37, 29, 13), (5, 3, 7), (256, 256, 64), (1, 1, 1), (3, 40, 9),
             (2, 3, 130), (4, 70, 66), (1, 300, 1), (9, 40, 70)]


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("bs", K5_BLOCKS, ids=lambda b: "x".join(map(str, b)))
def test_k5_plan_covers_every_voxel_once(bs, B):
    plan = F.sep_launch_plan(bs, 4, B, (8, 8, 8))
    assert plan.grid[2] == B
    count = np.zeros((B, *bs), np.int64)
    np.add.at(count, _k5_outputs(plan, bs, B), 1)
    assert (count == 1).all()
    assert plan.lanes_z == min(32, 1 << math.ceil(math.log2(-(-bs[2] // R))))
    assert plan.tile == (1, F.SEP_THREADS // plan.lanes_z, R * plan.lanes_z)
    assert plan.n_jt == -(-bs[1] // plan.tile[1])


def test_k5_plan_at_the_main_paths_block():
    """Route D's 256 x 256 x 64 block from 4 views of 288 x 288 x 128: 16
    lanes a column, 16 columns a block, one z tile; all 4 views tabulated
    at once in 6,208 bytes; 32-bit patch indices, the fusion type a
    template parameter."""
    plan = F.sep_launch_plan((256, 256, 64), 4, 16, (288, 288, 128))
    assert plan.lanes_z == 16 and plan.tile == (1, 16, 64)
    assert plan.grid == (256 * 16, 1, 16) and plan.nvs == 4
    assert plan.smem == 4 * (16 + 16 * 32 + 64 * 16) and not plan.generic


@pytest.mark.parametrize("generic", [False, True])
@pytest.mark.parametrize("bs,V", [((5, 3, 7), 1), ((37, 29, 13), 9),
                                  ((2, 300, 3), 3), ((3, 20, 150), 12),
                                  ((256, 256, 64), 33), ((4, 4, 1), 8)])
def test_k5_plan_stages_fit(bs, V, generic):
    """A stage's tables fit SEP_SMEM; at most RESAMPLE_VIEW_CHUNK views a
    stage, as many as fit."""
    ps = (6, 5, 1) if generic else (6, 5, 4)
    plan = F.sep_launch_plan(bs, V, 1, ps)
    assert plan.generic is generic
    _, tile_j, tile_z = plan.tile
    per_view = 16 + tile_j * (16 + 4 * (8 if generic else 4)) + 16 * tile_z
    assert 1 <= plan.nvs <= min(V, F.RESAMPLE_VIEW_CHUNK)
    assert plan.smem == plan.nvs * per_view <= F.SEP_SMEM
    assert plan.nvs == V or (plan.nvs + 1) * per_view > F.SEP_SMEM \
        or plan.nvs == F.RESAMPLE_VIEW_CHUNK


@pytest.mark.parametrize("ps,generic", [
    ((288, 288, 128), False), ((1290, 1290, 1290), False),
    ((1291, 1291, 1291), True), ((40, 40, 1), True), ((40, 40, 2), False)])
def test_k5_plan_generic(ps, generic):
    """The generic instantiation (64-bit patch indices, hi_z = min(lo_z +
    1, pz - 1), the fusion type read at run time) for patches of 2^31
    elements or more, or a z extent of 1."""
    assert (math.prod(ps) >= 2 ** 31 or ps[2] < 2) is generic
    assert F.sep_launch_plan((64, 64, 16), 2, 1, ps).generic is generic


@pytest.mark.parametrize("bs,V,B,ps", [((0, 3, 7), 1, 1, (4, 4, 4)),
                                       ((5, 3, 7), 0, 1, (4, 4, 4)),
                                       ((5, 3, 7), 1, 0, (4, 4, 4)),
                                       ((5, 3, 7), 1, 65536, (4, 4, 4)),
                                       ((5, 3, 7), 1, 1, (4, 0, 4))])
def test_k5_plan_refuses(bs, V, B, ps):
    with pytest.raises(ValueError):
        F.sep_launch_plan(bs, V, B, ps)


def _fma32(a, b, c):
    """fmaf of float32 operands, as ops.fusion._fma evaluates it."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(F32)


def _interp_row(pos, c):
    """interp_row with pad 0 (fusion_common.cuh) on float32 positions."""
    p = np.minimum(np.maximum(pos, F32(0)), F32(c - 1))
    lo = np.clip(np.floor(p).astype(np.int64), 0, max(c - 2, 0))
    f = (p - lo.astype(F32)).astype(F32)
    return lo, np.minimum(lo + 1, c - 1), f


def _k5_case(rng, V, bs, ps, kind, dtype=np.uint16):
    """Diagonal views over patches ``ps``: ``kind`` "main" (diag_z 3 and
    1/3, a mirrored x), "mirror_y", "steep_y" (y steps of 1.5) or "flat"
    (a z extent of 1)."""
    hi = 250 if dtype == np.uint8 else 4000
    patches = rng.uniform(0, hi, (V, *ps)).astype(dtype)
    diags = rng.uniform(0.7, 1.0, (V, 3)).astype(F32)
    ts = rng.uniform(-3, 4, (V, 3)).astype(F32)
    if kind == "main":
        diags[:, 2] = 3.0
        diags[1, 2] = F32(1 / 3)
        diags[0, 0] = -1.0
        ts[0, 0] += ps[0] - 2
    elif kind == "mirror_y":
        diags[:, 1] *= -1.0
        ts[:, 1] += ps[1]
    elif kind == "steep_y":
        diags[:, 1] = 1.5
    return patches, diags, ts


def _k5_view_tables(patches, diags, ts, plan, bs, i, j0, z0, v):
    """What a block (i, j0, z0) tabulates for view v: each column's 4 row
    offsets (x lo/hi by y lo/hi; columns past the block clamped) and each
    k's lo_z (ks past the block clamped)."""
    bx, by, bz = bs
    px, py, pz = patches.shape[1:]
    _, tile_j, tile_z = plan.tile
    xlo, xhi, _ = _interp_row(_fma32(diags[v, 0], i, ts[v, 0]), px)
    jc = np.minimum(j0 + np.arange(tile_j), by - 1)
    ylo, yhi, _ = _interp_row(_fma32(diags[v, 1], jc, ts[v, 1]), py)
    rows = np.stack([(xlo * py + ylo) * pz, (xhi * py + ylo) * pz,
                     (xlo * py + yhi) * pz, (xhi * py + yhi) * pz], 1)
    kc = np.minimum(z0 + np.arange(tile_z), bz - 1)
    zlo = _interp_row(_fma32(diags[v, 2], kc, ts[v, 2]), pz)[0]
    return rows, zlo


@pytest.mark.parametrize("kind,bs,ps,V,B,dtype", [
    ("main", (6, 9, 13), (9, 12, 42), 3, 2, np.uint16),
    ("main", (3, 20, 70), (5, 24, 210), 2, 1, np.uint8),
    ("mirror_y", (4, 11, 5), (6, 13, 9), 3, 1, np.int16),
    ("steep_y", (2, 30, 9), (4, 50, 12), 2, 1, np.float32),
    ("flat", (3, 5, 3), (5, 7, 1), 2, 1, np.uint16)],
    ids=["diag3", "diag3-ragged-u8", "mirrored-y-i16", "steep-y-f32",
         "z-extent-1"])
def test_k5_tabulated_taps_name_the_patch_values(kind, bs, ps, V, B, dtype):
    """For every block, stage, thread, output and view, the 8 values a
    voxel reads (a column's row offset + lo_z, and + lo_z + 1, or min(lo_z
    + 1, pz - 1) in the generic instantiation) are the patch values at the
    taps interp_row names on each axis."""
    rng = np.random.default_rng(91)
    bx, by, bz = bs
    plan = F.sep_launch_plan(bs, V, B, ps)
    assert plan.generic is (kind == "flat")
    _, tile_j, tile_z = plan.tile
    t = np.arange(F.SEP_THREADS)
    lz, jj = t & (plan.lanes_z - 1), t // plan.lanes_z
    seen = 0
    for b in range(B):
        patches, diags, ts = _k5_case(rng, V, bs, ps, kind, dtype)
        flat = patches.reshape(V, -1)
        for gy in range(plan.grid[1]):
            for gx in range(plan.grid[0]):
                i, jt = divmod(gx, plan.n_jt)
                j0, z0 = jt * tile_j, gy * tile_z
                for v in range(V):
                    rows, zlo = _k5_view_tables(patches, diags, ts, plan,
                                                bs, i, j0, z0, v)
                    for r in range(R):
                        u = lz + plan.lanes_z * r
                        j, k = j0 + jj, z0 + u
                        ok = (j < by) & (k < bz)
                        lo = zlo[u[ok]]
                        hi = (np.minimum(lo + 1, ps[2] - 1)
                              if plan.generic else lo + 1)
                        x = _interp_row(_fma32(diags[v, 0], i, ts[v, 0]),
                                        ps[0])
                        y = _interp_row(_fma32(diags[v, 1], j[ok], ts[v, 1]),
                                        ps[1])
                        z = _interp_row(_fma32(diags[v, 2], k[ok], ts[v, 2]),
                                        ps[2])
                        for q in range(4):
                            ro = rows[jj[ok], q]
                            for zq, dz in ((z[0], lo), (z[1], hi)):
                                assert np.array_equal(dz, zq)
                                got = flat[v, ro + dz]
                                want = patches[v, x[q & 1], y[q >> 1], zq]
                                assert np.array_equal(got, want)
                                seen += got.size
    assert seen > 0


def _k5_emulate(patches, diags, ts, tables, valid, bs, fusion_type):
    """K5's arithmetic in numpy float32, one view after another as a
    thread combines them: per axis the taps of interp_row and 1 - f once,
    x (lo g_x + hi f_x) for the 4 (y, z) rows, then y, then z, inside
    (ins_xy ins_z) and blend (w_xy w_z) from the column's products, and
    the combine of bst::CombinerT."""
    bx, by, bz = bs
    S = bx + by + bz
    P = patches.astype(F32)
    ft = fusion_type
    acc = np.full(bs, -np.inf if ft == "MAX_INTENSITY" else 0.0, F32)
    wsum = np.zeros(bs, F32)
    hit = np.zeros(bs, bool)
    one = F32(1.0)
    for v in range(P.shape[0]):
        tx = _interp_row(_fma32(diags[v, 0], np.arange(bx), ts[v, 0]),
                         P.shape[1])
        ty = _interp_row(_fma32(diags[v, 1], np.arange(by), ts[v, 1]),
                         P.shape[2])
        tz = _interp_row(_fma32(diags[v, 2], np.arange(bz), ts[v, 2]),
                         P.shape[3])
        fx, fy, fz = (t[2] for t in (tx, ty, tz))
        gx, gy = one - fx, one - fy
        gx, fx = gx[:, None, None], fx[:, None, None]
        gy, fy = gy[None, :, None], fy[None, :, None]
        vy = [[None, None], [None, None]]
        for cz in (0, 1):
            for cy in (0, 1):
                lo = P[v][np.ix_(tx[0], ty[cy], tz[cz])]
                hi = P[v][np.ix_(tx[1], ty[cy], tz[cz])]
                vy[cz][cy] = lo * gx + hi * fx
        vz = [vy[cz][0] * gy + vy[cz][1] * fy for cz in (0, 1)]
        val = vz[0] * (one - fz) + vz[1] * fz
        w_t, in_t = tables[v, 0], tables[v, 1]
        in_xy = in_t[:bx, None] * in_t[None, bx:bx + by]
        w_xy = w_t[:bx, None] * w_t[None, bx:bx + by]
        inside = in_xy[:, :, None] * in_t[None, None, bx + by:S]
        blend = w_xy[:, :, None] * w_t[None, None, bx + by:S]
        if ft in ("AVG", "AVG_BLEND"):
            w = inside * valid[v] if ft == "AVG" else inside * blend * valid[v]
            wsum = wsum + w
            acc = acc + val * w
            continue
        w = inside * valid[v]
        wsum = wsum + w
        on = w > 0
        if ft == "MAX_INTENSITY":
            acc = np.where(on, np.fmax(acc, val), acc)
        elif ft == "LAST_WINS":
            acc = np.where(on, val, acc)
        else:
            acc = np.where(on & ~hit, val, acc)
        hit |= on
    if ft in ("AVG", "AVG_BLEND"):
        fused = np.where(wsum > 0, acc / np.maximum(wsum, F32(1e-20)), F32(0))
    else:
        fused = np.where(wsum > 0, acc, F32(0))
    return fused.astype(F32), wsum


@pytest.mark.parametrize("kind", ["main", "mirror_y", "flat"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16, np.float32])
@pytest.mark.parametrize("fusion_type", F.FUSION_TYPES)
def test_k5_arithmetic_equals_twin(fusion_type, dtype, kind):
    """The kernel's order of operations gives fuse_block_sep_plain's fused
    and wsum bit for bit, with inside offsets, a switched-off view and
    voxels outside the images."""
    rng = np.random.default_rng(92)
    bs, V = (11, 9, 13), 4
    ps = (14, 12, 1) if kind == "flat" else (14, 12, 40)
    patches, diags, ts = _k5_case(rng, V, bs, ps, kind, dtype)
    offs = rng.uniform(-5, 10, (V, 3)).astype(F32)
    # every view's image starts at the block's middle column: the first
    # (or, mirrored, the last) columns lie outside every view
    offs[:, 1] = -(diags[:, 1] * (bs[1] // 2) + ts[:, 1])
    dims = np.tile(F32([30, 30, 60]), (V, 1))
    borders = rng.uniform(0, 3, (V, 3)).astype(F32)
    ranges = rng.uniform(5, 20, (V, 3)).astype(F32)
    ioffs = rng.uniform(0, 2, (V, 3)).astype(F32)
    valid = np.ones(V, F32)
    valid[1] = 0.0
    t = [torch.from_numpy(a) for a in (patches, diags, ts, offs, dims,
                                       borders, ranges, valid, ioffs)]
    want = F.fuse_block_sep_plain(*t[:8], bs, fusion_type, t[8])
    tables = F.sep_axis_tables(*t[1:7], t[8], bs).numpy()
    fused, wsum = _k5_emulate(patches, diags, ts, tables, valid, bs,
                              fusion_type)
    assert wsum.min() == 0 and wsum.max() > 0  # some voxels outside
    assert np.array_equal(fused.view(np.uint32),
                          want[0].numpy().view(np.uint32))
    assert np.array_equal(wsum.view(np.uint32),
                          want[1].numpy().view(np.uint32))


# ----------------------------------------------------------------- K19


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("B,K,P,sms", [
    (1, 100000, 4, 132), (2, 4096, 4, 132), (1, 155, 4, 132),
    (1, 300, 8, 132), (64, 4096, 4, 132), (3, 1100, 5, 132),
    (1, 1, 1, 132), (1, 513, 2, 4), (7, 2049, 8, 16)])
def test_k19_plan_covers_every_query_and_candidate_once(B, K, P, sms,
                                                        masked):
    """Every query of every entry is held by one thread of one row block
    (i = row0 + t + 128 q); the splits cut [0, K) into runs of whole
    stages, none empty, in order; splits only where B x row blocks would
    not give the card KNN_WAVE blocks an SM, and then runs of equal whole
    stages, as many as give it (the last run may be shorter), or one a
    stage."""
    plan = DS.knn_plan(B, K, P, sms, masked)
    assert plan.q == DS.knn_queries(masked) == (1 if masked else 4)
    rows = DS.KNN_THREADS * plan.q
    assert (plan.row_blocks - 1) * rows < K <= plan.row_blocks * rows
    rb = np.arange(plan.row_blocks)[:, None, None]
    t = np.arange(DS.KNN_THREADS)[None, :, None]
    q = np.arange(plan.q)[None, None, :]
    i = (rb * rows + t + DS.KNN_THREADS * q).reshape(-1)
    assert np.array_equal(np.sort(i[i < K]), np.arange(K))
    assert plan.kp == -(-K // DS.KNN_TILE) * DS.KNN_TILE
    assert plan.per_split % DS.KNN_TILE == 0
    bounds = [(s * plan.per_split, min(K, (s + 1) * plan.per_split))
              for s in range(plan.splits)]
    assert all(a < b for a, b in bounds) and bounds[-1][1] == K
    base = B * plan.row_blocks
    tiles = -(-K // DS.KNN_TILE)
    want = min(tiles, -(-DS.KNN_WAVE * sms // base))
    if base >= DS.KNN_WAVE * sms:
        assert plan.splits == 1
    else:  # runs of equal whole stages, as many as give the wave or one
        assert plan.per_split == -(-tiles // want) * DS.KNN_TILE


@pytest.mark.parametrize("B,K,P", [(0, 5, 4), (1, 0, 4), (1, 5, 0),
                                   (1, 5, 9)])
def test_k19_plan_refuses(B, K, P):
    with pytest.raises(ValueError):
        DS.knn_plan(B, K, P)


_IMAX = 2 ** 31 - 1


def _insert(ld, li, d, j, m):
    """knn_insert for the queries ``m``: (d, j) enters each list where it
    precedes the last entry in (distance, index) order."""
    j = np.broadcast_to(np.asarray(j, np.int64), d.shape)[:, None]
    enter = m & ((d < ld[:, -1]) | ((d == ld[:, -1]) & (j[:, 0] < li[:, -1])))
    if not enter.any():
        return
    prec = (ld < d[:, None]) | ((ld == d[:, None]) & (li < j))
    pos = prec.sum(1)
    k = np.arange(ld.shape[1])[None, :]
    sh_d = np.concatenate([ld[:, :1], ld[:, :-1]], 1)
    sh_i = np.concatenate([li[:, :1], li[:, :-1]], 1)
    new_d = np.where(k < pos[:, None], ld, np.where(k == pos[:, None],
                                                    d[:, None], sh_d))
    new_i = np.where(k < pos[:, None], li, np.where(k == pos[:, None], j,
                                                    sh_i))
    ld[enter], li[enter] = new_d[enter], new_i[enter]


def _k19_emulate(pts, valid, P, plan):
    """K19's scan, merge and fixed lists in numpy float32, per entry:
    each split's candidates in stage order, each candidate's distance to
    every query ((dx dx + dy dy) + dz dz, own - other), +inf for a
    candidate that is not valid (masked) and, on a stage holding a query's
    own index, for the query itself; the exact insertion only where d <=
    thr (the list's last distance, -inf for a query that is not valid);
    the splits' lists merged in split order; a query that is not valid
    gets the P lowest indices at +inf. Returns (idx (B, K, P), last
    distance (B, K))."""
    B, K, _ = pts.shape
    rows = DS.KNN_THREADS * plan.q
    i = np.arange(K)
    row0 = i // rows * rows
    out_i = np.empty((B, K, P), np.int64)
    out_d = np.empty((B, K), F32)
    inf = F32(np.inf)
    for b in range(B):
        p = pts[b]
        vq = np.ones(K, bool) if valid is None else valid[b]
        parts = []
        for s in range(plan.splits):
            ld = np.full((K, P), inf, F32)
            li = np.full((K, P), _IMAX, np.int64)
            thr = np.where(vq, inf, -inf).astype(F32)
            c_end = min(K, (s + 1) * plan.per_split)
            for c0 in range(s * plan.per_split, c_end, DS.KNN_TILE):
                self_stage = (c0 < row0 + rows) & (c0 + DS.KNN_TILE > row0)
                for j in range(c0, min(c0 + DS.KNN_TILE, c_end)):
                    dx, dy, dz = (p[:, a] - p[j, a] for a in range(3))
                    d = (dx * dx + dy * dy) + dz * dz
                    if valid is not None and not valid[b, j]:
                        d = np.full(K, inf, F32)
                    is_self = i == j
                    assert not (is_self & ~self_stage).any()
                    d = np.where(self_stage & is_self, inf, d).astype(F32)
                    m = d <= thr
                    _insert(ld, li, d, j, m)
                    # full lists: the float just below the last distance
                    below = (ld[:, -1].view(np.int32) - 1).view(F32)
                    thr = np.where(m, np.where(li[:, -1] == _IMAX,
                                               ld[:, -1], below), thr)
            parts.append((ld, li))
        ld = np.full((K, P), inf, F32)
        li = np.full((K, P), _IMAX, np.int64)
        for pd, pi in parts:
            for k in range(P):
                _insert(ld, li, pd[:, k], pi[:, k], vq)
        fixed = np.where(np.arange(P) < K, np.arange(P), _IMAX)
        li[~vq] = fixed
        ld[~vq] = inf
        out_i[b], out_d[b] = li, ld[:, -1]
    return out_i, out_d


def _sqrt(x):
    """float32 square roots as torch takes them on the CPU, where the twin
    runs here (its vectorised sqrt is not always correctly rounded; the
    card's sqrtf and torch's CUDA sqrt are, so kernel and twin agree
    there)."""
    return torch.sqrt(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def _k19_tail(pts, valid, idx, last, n, rot):
    """The tail (the first form's code) in numpy float32: dvalid, the
    offsets, the frame and the descriptors of each subset."""
    B, K, P = idx.shape
    subs = DS.subset_combinations(P, n)
    vq = np.ones((B, K), bool) if valid is None else valid
    dv = vq & (last < np.inf)
    keep = np.ones((B, K), bool) if valid is None else dv
    j = np.where(idx < K, idx, 0)
    nb = pts[np.arange(B)[:, None, None], j]
    off = np.where(keep[..., None, None], nb - pts[:, :, None, :],
                   F32(0)).astype(F32)
    out = np.zeros((B, K, len(subs), 3 * n), F32)
    eps = F32(1e-12)
    for s, sub in enumerate(subs):
        o = [off[:, :, a] for a in sub]
        if rot:
            o0, o1 = o[0], o[1 % n]
            n0 = _sqrt((o0[..., 0] * o0[..., 0] + o0[..., 1] * o0[..., 1])
                       + o0[..., 2] * o0[..., 2]) + eps
            e0 = o0 / n0[..., None]
            dot = (o1[..., 0] * e0[..., 0] + o1[..., 1] * e0[..., 1]) \
                + o1[..., 2] * e0[..., 2]
            y = o1 - dot[..., None] * e0
            n1 = _sqrt((y[..., 0] * y[..., 0] + y[..., 1] * y[..., 1])
                       + y[..., 2] * y[..., 2]) + eps
            e1 = y / n1[..., None]
            e2 = np.stack([e0[..., 1] * e1[..., 2] - e0[..., 2] * e1[..., 1],
                           e0[..., 2] * e1[..., 0] - e0[..., 0] * e1[..., 2],
                           e0[..., 0] * e1[..., 1] - e0[..., 1] * e1[..., 0]],
                          -1)
            for t, ot in enumerate(o):
                for c, e in enumerate((e0, e1, e2)):
                    out[:, :, s, 3 * t + c] = (e[..., 0] * ot[..., 0]
                                               + e[..., 1] * ot[..., 1]) \
                        + e[..., 2] * ot[..., 2]
        else:
            for t, ot in enumerate(o):
                out[:, :, s, 3 * t:3 * t + 3] = ot
    return dv, out


def _k19_check(pts, valid, n, r, rot, splits=None):
    B, K, _ = pts.shape
    P = n + r
    plan = DS.knn_plan(B, K, P, masked=valid is not None)
    if splits is not None:
        tiles = -(-K // DS.KNN_TILE)
        per = -(-tiles // splits) * DS.KNN_TILE
        plan = plan._replace(splits=-(-K // per), per_split=per)
    idx, last = _k19_emulate(pts, valid, P, plan)
    dv, desc = _k19_tail(pts, valid, idx, last, n, rot)
    want = DS.knn_descriptors_plain(
        torch.from_numpy(pts), None if valid is None else
        torch.from_numpy(valid), n, r, rot)
    assert np.array_equal(idx, want[0].numpy().astype(np.int64))
    assert np.array_equal(dv, want[2].numpy())
    assert np.array_equal(desc.view(np.uint32), want[1].numpy().view(
        np.uint32))
    return plan


@pytest.mark.parametrize("n,r", [(1, 0), (1, 1), (2, 1), (3, 1), (2, 3),
                                 (3, 3), (4, 3), (3, 5)],
                         ids=lambda v: str(v))
def test_k19_dense_emulation_equals_twin_at_every_pool(n, r):
    """Pools 1 to 8, K = 700 (not a multiple of a stage or of 128 Q), two
    duplicate points (equal distances, and a distance 0), rotation
    invariant and not."""
    rng = np.random.default_rng(93)
    pts = rng.uniform(0, 40, (1, 700, 3)).astype(F32)
    pts[0, 10] = pts[0, 11]
    pts[0, 600] = pts[0, 3]
    for rot in (True, False):
        _k19_check(pts, None, n, r, rot)


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("K", [300, 1100])
def test_k19_splits_and_merge_equal_twin(K, splits):
    """Forced splits of whole stages (the last one ragged), merged in
    split order: the twin's lists, bit for bit; points on a coarse grid, so
    that many distances tie."""
    rng = np.random.default_rng(94)
    pts = rng.integers(0, 6, (1, K, 3)).astype(F32)
    plan = _k19_check(pts, None, 3, 1, True, splits)
    assert plan.splits == min(splits, -(-K // DS.KNN_TILE))


def test_k19_masked_emulation_equals_twin():
    """B = 3 masked entries of 1,100 slots: one at 8d's pattern (valid
    slots first), one scattered, one with 3 valid points (fewer than a
    pool: their lists end in +inf entries, self included, and they have no
    descriptors); invalid queries take the fixed list. With the plan's
    splits and with 2 forced ones."""
    rng = np.random.default_rng(95)
    B, K = 3, 1100
    pts = rng.uniform(0, 30, (B, K, 3)).astype(F32)
    valid = np.zeros((B, K), bool)
    valid[0, :131] = True
    valid[1] = rng.uniform(size=K) > 0.6
    valid[2, [5, 700, 1099]] = True
    pts[1, 20] = pts[1, 21]
    for splits in (None, 2):
        plan = _k19_check(pts, valid, 3, 1, True, splits)
        assert plan.splits > 1
    want = DS.knn_descriptors_plain(torch.from_numpy(pts),
                                    torch.from_numpy(valid), 3, 1, True)
    assert not want[2][2].any() and not want[1][2].any()
    assert (want[0][0, 200] == torch.arange(4, dtype=torch.int32)).all()
