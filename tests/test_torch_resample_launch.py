"""K3's and K26's launch plan (``ops/fusion.py`` ``resample_plan``) and the
orders in which the two kernels share work across a z column, held on the
CPU against numpy and torch emulations of what the kernels do.

K3 (``csrc/gather.cu``) and K26 (``csrc/nonrigid.cu``) give a thread
RESAMPLE_R z outputs of one (i, j) column (consecutive in K3, lanes_z
apart in K26), lanes_z threads a column, a block a tile of one i; the
emulation below walks every block, thread and voxel of both layouts and
must land on every output voxel exactly once, for blocks that are not
multiples of the run or the tile.

K3 keeps the column's partial sum s_d = i A0 + j A1 and adds k A2, then
A3; for a separable view (A2, A6, A8 and A9 zeros) it computes p_x and p_y
once a column, at the run's first k, and p_z once a block for each k, from
i A8 + j A9 taken at i = j = 0. With coefficients it keeps (l_x C0 + l_y
C1), and where C2, C6, C8 and C9 are zeros too it takes the grid's x and y
taps at the run's first l_z, the z taps once for each k, and keeps the
corners' (G wx) wy of a z cell pair. Each must equal the twin's
``_apply3`` and ``_trilinear_vec`` bit for bit (the taps where a grid
coordinate is a zero whose sign follows l_x, l_y or l_z).

K26 computes C_xy(zv), the vertex models lerped along x then y, once for
each column and each z vertex its tile reaches (from the first and the last
k's taps), and lerps a voxel along z only; a tile that reaches more
vertices than the table holds lerps per voxel. The emulation follows the
plan's tiles and must give ``nonrigid_fuse_block_plain``'s outputs bit for
bit, with z ranges that start and end between vertices, grids clamped at
both ends, and spacings that overflow the table.
"""

import math

import numpy as np
import pytest
import torch

from bigstitcher_spark_tpu_torch.models.nonrigid_fusion import (
    control_grid_dims,
)
from bigstitcher_spark_tpu_torch.ops import fusion as F
from bigstitcher_spark_tpu_torch.ops import nonrigid as NR

torch.set_num_threads(1)

F32 = np.float32


# ------------------------------------------------------------ the plan


def _launcher_accepts(plan, block_shape) -> bool:
    """The checks bst_fuse_block_batch and bst_nonrigid_fuse_batch make of a
    plan."""
    bx, by, bz = block_shape
    lz, tz = plan.lanes_z, F.RESAMPLE_R * plan.lanes_z
    tile_j = F.RESAMPLE_THREADS // lz
    return (1 <= lz <= 32 and lz & (lz - 1) == 0
            and plan.n_jt == -(-by // tile_j)
            and plan.grid[0] == bx * plan.n_jt
            and plan.grid[1] * tz >= bz > (plan.grid[1] - 1) * tz
            and plan.grid[1] <= 65535 and plan.grid[0] < 2 ** 31)


def _covered(plan, block_shape, strided=False) -> np.ndarray:
    """How often the kernels' (block, thread, voxel) walk writes each output
    voxel: i = block x / n_jt, j = (block x mod n_jt) tile_j + t / lanes_z,
    k = (block y lanes_z + t mod lanes_z) R + r (K3) or block y tile_z + r
    lanes_z + t mod lanes_z (K26, ``strided``), kept where j < by and
    k < bz."""
    bx, by, bz = block_shape
    lz, R = plan.lanes_z, F.RESAMPLE_R
    tile_j = F.RESAMPLE_THREADS // lz
    b0 = np.arange(plan.grid[0])[:, None, None, None]
    b1 = np.arange(plan.grid[1])[None, :, None, None]
    t = np.arange(F.RESAMPLE_THREADS)[None, None, :, None]
    r = np.arange(R)[None, None, None, :]
    i = np.broadcast_to(b0 // plan.n_jt, (plan.grid[0], plan.grid[1],
                                           F.RESAMPLE_THREADS, R))
    j = (b0 % plan.n_jt) * tile_j + t // lz
    k = (b1 * R * lz + r * lz + t % lz if strided
         else (b1 * lz + t % lz) * R + r)
    i, j, k = np.broadcast_arrays(i, j, k)
    keep = (j < by) & (k < bz)
    count = np.zeros(block_shape, np.int64)
    np.add.at(count, (i[keep], j[keep], k[keep]), 1)
    return count


BLOCKS = [(5, 3, 7), (1, 1, 1), (256, 256, 64), (3, 40, 9), (2, 3, 130),
          (4, 70, 66), (1, 300, 1), (2, 9, 200)]


@pytest.mark.parametrize("V", [1, 4, 9])
@pytest.mark.parametrize("bs", BLOCKS, ids=lambda b: "x".join(map(str, b)))
def test_plan_covers_every_voxel_once(bs, V):
    plan = F.resample_plan(bs, V, tuple(s + 9 for s in bs))
    assert _launcher_accepts(plan, bs)
    assert (_covered(plan, bs) == 1).all()
    assert (_covered(plan, bs, strided=True) == 1).all()
    # lanes_z: the power of two at or above the block's runs, at most 32
    runs = -(-bs[2] // F.RESAMPLE_R)
    assert plan.lanes_z == min(32, 1 << math.ceil(math.log2(runs)))
    assert plan.tile == (1, F.RESAMPLE_THREADS // plan.lanes_z,
                         F.RESAMPLE_R * plan.lanes_z)


def test_plan_at_the_main_paths_block():
    """256 x 256 x 64: 16 lanes a column, 16 columns a block, one z tile;
    a warp holds two whole columns, and K26's table holds every z vertex a
    tile reaches at -cpd 10 (64 outputs: 9 vertices at most)."""
    plan = F.resample_plan((256, 256, 64), 4, (288, 288, 96))
    assert plan.lanes_z == 16 and plan.tile == (1, 16, 64)
    assert plan.grid == (256 * 16, 1) and plan.view_chunks == 1
    assert not plan.idx64
    assert plan.table_vertices >= math.ceil(63 / 10.0) + 2


@pytest.mark.parametrize("V,chunks", [(1, 1), (8, 1), (9, 2), (33, 5),
                                      (64, 8)])
def test_plan_view_chunks(V, chunks):
    """Any V: the views' parameters are staged RESAMPLE_VIEW_CHUNK at a
    time (the combiners carry over the chunks)."""
    plan = F.resample_plan((5, 3, 7), V, (14, 12, 16))
    assert plan.view_chunks == chunks
    assert F.RESAMPLE_VIEW_CHUNK == 8


@pytest.mark.parametrize("shape,idx64", [
    ((2 ** 31 - 1, 1, 1), False), ((1, 1, 2 ** 31 - 1), False),
    ((1024, 1024, 2048), True), ((2 ** 31, 1, 1), True),
    ((1300, 1300, 1300), True), ((288, 288, 96), False)])
def test_plan_index_width(shape, idx64):
    """32-bit patch indices below 2^31 elements, 64-bit from 2^31."""
    assert math.prod(shape) >= 2 ** 31 if idx64 else math.prod(shape) < 2 ** 31
    assert F.resample_plan((8, 8, 8), 1, shape).idx64 is idx64


@pytest.mark.parametrize("bs", BLOCKS, ids=lambda b: "x".join(map(str, b)))
def test_plan_table_fits(bs):
    """One view's K26 table of models (tile_j columns x (3 float4 a vertex
    + 1 of padding)) fits its NONRIGID_TABLE_F4 float4, holds as many
    vertices as fit and at least one cell pair."""
    plan = F.resample_plan(bs, 4, (9, 9, 9))
    tile_j, nv = plan.tile[1], plan.table_vertices
    assert tile_j * (3 * nv + 1) <= F.NONRIGID_TABLE_F4
    assert tile_j * (3 * (nv + 1) + 1) > F.NONRIGID_TABLE_F4
    assert nv >= 2


@pytest.mark.parametrize("bs,V", [((0, 3, 7), 1), ((5, 3, 7), 0),
                                  ((1, 1, F.RESAMPLE_R * 32 * 65536), 1)])
def test_plan_refuses(bs, V):
    with pytest.raises(ValueError):
        F.resample_plan(bs, V, (9, 9, 9))


# ------------------------------------------------- K3's shared partial sums


def _runs(bs):
    """Each voxel's run start k0 (the thread's first k) in the plan's
    layout: k - k mod R."""
    k = torch.arange(bs[2])
    return (k - k % F.RESAMPLE_R).to(torch.float32)


def _affines(rng, V):
    """Block -> patch affines: translations, rotations about z (A2, A6,
    A8, A9 = +0 or -0: separable) and about x and y (general)."""
    A = np.zeros((V, 3, 4), F32)
    for v in range(V):
        a = rng.uniform(-0.3, 0.3)
        c, s = np.cos(a), np.sin(a)
        A[v, :, :3] = [np.eye(3), [[c, -s, 0], [s, c, 0], [0, 0, 1]],
                       [[1, 0, 0], [0, c, -s], [0, s, c]],
                       [[c, 0, s], [0, 1, 0], [-s, 0, c]]][v % 4]
        A[v, :, 3] = rng.uniform(-40, 40, 3)
    A[1, 0, 2] = A[1, 1, 2] = A[1, 2, 0] = -0.0
    return torch.from_numpy(A)


def _separable(A) -> bool:
    return bool(A[0, 2] == 0 and A[1, 2] == 0 and A[2, 0] == 0
                and A[2, 1] == 0)


def _column_positions(A, bs):
    """p as K3 computes it: s_d = i A0 + j A1 once a column, then (s_d + k
    A2) + A3; for a separable view p_x and p_y at the run's first k, and
    p_z from s_z = 0 A8 + 0 A9 (a block's record of k)."""
    coords = F.block_coords(bs)
    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
    k0 = _runs(bs).repeat(bs[0] * bs[1])
    sep = _separable(A)
    s = [x * A[d, 0] + y * A[d, 1] for d in range(3)]
    if sep:
        zero = torch.zeros_like(x)
        s[2] = zero * A[2, 0] + zero * A[2, 1]
    p = [(s[d] + (k0 if sep and d < 2 else z) * A[d, 2]) + A[d, 3]
         for d in range(3)]
    return torch.stack(p, dim=-1), sep


@pytest.mark.parametrize("bs", [(5, 3, 7), (4, 6, 130), (3, 2, 9)],
                         ids=lambda b: "x".join(map(str, b)))
def test_k3_column_sums_equal_apply3(bs):
    rng = np.random.default_rng(51)
    A = _affines(rng, 8)
    coords = F.block_coords(bs)
    x, y, z = coords[:, 0:1], coords[:, 1:2], coords[:, 2:3]
    n_sep = 0
    for v in range(A.shape[0]):
        got, sep = _column_positions(A[v], bs)
        n_sep += sep
        assert torch.equal(got, F._apply3(x, y, z, A[v]))
    assert 0 < n_sep < A.shape[0]  # both forms were taken


def _taps(g, cmax):
    """Fraction and the two clipped taps (K3's sample_taps)."""
    fl = torch.floor(g)
    q = fl.to(torch.int64)
    lo, top = torch.zeros_like(q), torch.as_tensor(cmax).expand_as(q)
    return (g - fl, torch.clamp(q, lo, top), torch.clamp(q + 1, lo, top))


def test_k3_coefficient_sums_and_taps():
    """(l_x C0 + l_y C1) kept a column gives _apply3's grid coordinate bit
    for bit; with C2, C6, C8 and C9 zeros, the x and y taps taken at the
    run's first l_z and the z taps taken at l_x = l_y = 0 equal every
    voxel's, also where a coordinate is a zero whose sign follows l_z (C0
    = C1 = C3 = 0, C2 = -0) or l_x and l_y (C8 = -0, C9 = 0, C11 = 0)."""
    bs = (6, 5, 11)
    rng = np.random.default_rng(52)
    A = _affines(rng, 4)
    cdims = (4, 3, 5)
    C = np.zeros((4, 3, 4), F32)
    C[0, [0, 1, 2], [0, 1, 2]] = [0.11, 0.07, 0.3]
    C[0, :, 3] = [-0.4, 0.2, -0.6]
    C[1] = C[0]
    C[1, 0] = [0.0, 0.0, -0.0, 0.0]   # g_x = +-0 at every voxel
    C[2] = C[0]
    C[2, 1, 2] = 0.05                  # C6 != 0: the y taps per voxel
    C[3] = C[0]
    C[3, 2] = [-0.0, 0.0, 0.0, 0.0]   # g_z = +-0 at every voxel
    C = torch.from_numpy(C)
    off = torch.tensor([3.0, -2.5, -8.0])  # l_z runs from negative to positive
    coords = F.block_coords(bs)
    k0 = _runs(bs).repeat(bs[0] * bs[1])
    for v in range(A.shape[0]):
        p, sep = _column_positions(A[v], bs)
        lp = p + off
        for c in range(C.shape[0]):
            ref = F._apply3(lp[:, 0:1], lp[:, 1:2], lp[:, 2:3], C[c])
            cp = [lp[:, 0] * C[c, d, 0] + lp[:, 1] * C[c, d, 1]
                  for d in range(3)]
            got = torch.stack([(cp[d] + lp[:, 2] * C[c, d, 2]) + C[c, d, 3]
                               for d in range(3)], dim=-1)
            assert torch.equal(got, ref)
            csep = sep and _separable(C[c])
            if not csep:
                continue
            # the run's first voxel's l_z, as K3 takes it
            lz0 = ((A[v, 2, 0] * coords[:, 0] + A[v, 2, 1] * coords[:, 1])
                   + k0 * A[v, 2, 2] + A[v, 2, 3]) + off[2]
            zero = torch.zeros_like(lz0)
            g = [(cp[d] + lz0 * C[c, d, 2]) + C[c, d, 3] for d in range(2)]
            g.append(((zero * C[c, 2, 0] + zero * C[c, 2, 1])
                      + lp[:, 2] * C[c, 2, 2]) + C[c, 2, 3])
            for d in range(3):
                for a, b in zip(_taps(g[d], cdims[d] - 1),
                                _taps(ref[:, d], cdims[d] - 1)):
                    assert torch.equal(a, b)


def test_k3_corner_cache_equals_trilinear_vec():
    """The corners' (G wx) wy of a z cell pair, then times wz and summed in
    corner order, is _trilinear_vec's sum bit for bit."""
    rng = np.random.default_rng(53)
    grid = torch.from_numpy(rng.uniform(-50, 50, (4, 3, 5, 2)).astype(F32))
    pts = torch.from_numpy(rng.uniform(-1.5, 5.5, (4000, 3)).astype(F32))
    ref = F._trilinear_vec(grid, pts)
    f, lo, hi = _taps(pts, torch.tensor([3, 2, 4]))
    g = 1 - f
    flat = grid.reshape(-1, 2)

    def at(x, y, z):
        return flat[(x * 3 + y) * 5 + z]

    terms = []
    for n in range(8):
        x = hi[:, 0] if n & 1 else lo[:, 0]
        y = hi[:, 1] if n & 2 else lo[:, 1]
        z = hi[:, 2] if n & 4 else lo[:, 2]
        wx = (f if n & 1 else g)[:, 0:1]
        wy = (f if n & 2 else g)[:, 1:2]
        wz = (f if n & 4 else g)[:, 2:3]
        terms.append(at(x, y, z) * wx * wy * wz)
    got = terms[0]
    for t in terms[1:]:
        got = got + t
    assert torch.equal(got, ref)


# ------------------------------------------------- K26's factored lerps


def _nonrigid_inputs(rng, V, bs, cpd, go_shift):
    """_nonrigid_case's inputs (tests/test_torch_kernels.py): fitted vertex
    grids at spacing ``cpd``, the grid origin ``go_shift`` past the
    reference's, float32 patches."""
    bo = np.array([1500.25, 900.5, 60.75], F32)
    go = bo - F32(cpd) + F32(go_shift)
    gdims = control_grid_dims(bs, cpd)
    grids = np.zeros((V, *gdims, 12), F32)
    pshape = tuple(s + 24 for s in bs)
    patches = rng.uniform(0, 4000, (V, *pshape)).astype(F32)
    vaff = np.zeros((V, 3, 4), F32)
    offsets = rng.integers(0, 30, (V, 3)).astype(F32)
    for v in range(V):
        t = bo + rng.uniform(-10, 30, (30, 3))
        vw = t + rng.normal(0, 0.8, (30, 3)) + rng.uniform(-2, 2, 3)
        grids[v] = NR.fit_control_grid(t, vw, go.astype(np.float64), gdims,
                                       cpd)
        a = 0.05 * v
        lin = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                        [0, 0, 1]])
        vaff[v, :, :3] = lin
        vaff[v, :, 3] = -lin @ bo + 12.0 + rng.uniform(-0.5, 0.5, 3)
    dims = offsets + np.array(pshape, F32) + 8
    arrays = (patches, grids, vaff, offsets, dims,
              rng.uniform(0, 2, (V, 3)).astype(F32),
              rng.uniform(4, 12, (V, 3)).astype(F32), np.ones(V, F32), bo, go,
              np.full(3, cpd, F32))
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _lerp(a, b, g, f):
    """K26's lerp4 on each coefficient: fma(b, f, a g), one rounding."""
    return F._fma(b, f, a * g)


def _factored_models(grid, bo, go, sp, bs, plan):
    """The (N, 12) interpolated vertex models as K26 computes them, tile by
    tile: the taps of x (the tile's i), y (its columns) and z (its k), the
    tile's vertex window [vz0, vz0 + nz) from its first and last k's z taps;
    if nz fits the table, C_xy(zv) once a column and vertex (x lerp at lo1
    and hi1, then y) and per voxel the z lerp of C_xy(lo2) and C_xy(hi2);
    else both C_xy per voxel. Returns the models and whether a tile was
    tabled and whether one was not."""
    bx, by, bz = bs
    gx, gy, gz = grid.shape[:3]
    tile_j, tile_z = plan.tile[1], plan.tile[2]
    out = torch.empty((bx, by, bz, 12), dtype=torch.float32)
    used = set()

    def taps(d, idx, c):
        w = bo[d] + torch.as_tensor(idx, dtype=torch.float32)
        lo, hi, f = F._interp_taps((w - go[d]) / sp[d], c)
        return lo, hi, f[..., None], (1.0 - f)[..., None]

    for i in range(bx):
        xl, xh, xf, xg = taps(0, [i], gx)
        for j0 in range(0, by, tile_j):
            js = torch.arange(j0, min(j0 + tile_j, by))
            yl, yh, yf, yg = taps(1, js, gy)
            # the tile's y vertices, from its first and last columns (the
            # kernel's ytab runs past the block's end)
            ty = taps(1, [j0, j0 + tile_j - 1], gy)
            ny = int(max(ty[1][0], ty[1][1]) - min(ty[0][0], ty[0][1])) + 1
            for z0 in range(0, bz, tile_z):
                ks = torch.arange(z0, min(z0 + tile_z, bz))
                zl, zh, zf, zg = taps(2, ks, gz)
                vz0 = int(min(zl[0], zl[-1]))
                nz = int(max(zh[0], zh[-1])) - vz0 + 1
                tabled = (nz <= plan.table_vertices
                          and ny * nz * 3 <= F.NONRIGID_ROWS_F4)
                used.add(tabled)

                def cxy(zv):  # (columns, len(zv), 12)
                    a = _lerp(grid[xl[0]][yl][:, zv], grid[xh[0]][yl][:, zv],
                              xg, xf)
                    b = _lerp(grid[xl[0]][yh][:, zv], grid[xh[0]][yh][:, zv],
                              xg, xf)
                    return _lerp(a, b, yg[:, None], yf[:, None])

                if tabled:
                    tab = cxy(torch.arange(vz0, vz0 + nz))
                    clo, chi = tab[:, zl - vz0], tab[:, zh - vz0]
                else:
                    clo, chi = cxy(zl), cxy(zh)
                out[i, js[0]:js[-1] + 1, ks[0]:ks[-1] + 1] = _lerp(
                    clo, chi, zg, zf)
    return out.reshape(-1, 12), used


def _fuse_with_models(args, bs, models, fusion_type):
    """nonrigid_fuse_block_plain with each view's models given."""
    patches, grids, vaffs, offs, dims, borders, ranges, valid, bo = args[:9]
    L = tuple(bs)
    w = [bo[d] + torch.arange(L[d], dtype=torch.float32) for d in range(3)]
    wx = w[0][:, None, None].expand(L).reshape(-1)
    wy = w[1][None, :, None].expand(L).reshape(-1)
    wz = w[2][None, None, :].expand(L).reshape(-1)
    vals, insides, blends = [], [], []
    for v in range(patches.shape[0]):
        A = models[v]
        deformed = [NR._apply_row(A[:, 4 * r:4 * r + 4].T, wx, wy, wz)
                    for r in range(3)]
        p = torch.stack([NR._apply_row(vaffs[v][i], *deformed)
                         for i in range(3)], dim=-1)
        vals.append(F._trilinear_sample(patches[v].to(torch.float32), p))
        wb, ins = F._axis_blend_at(p + offs[v], dims[v], borders[v], ranges[v])
        insides.append(ins[:, 0] * ins[:, 1] * ins[:, 2])
        blends.append(wb[:, 0] * wb[:, 1] * wb[:, 2])
    fused, wsum = F._combine_views(torch.stack(vals), torch.stack(insides),
                                   torch.stack(blends), valid, fusion_type)
    return fused.reshape(L), wsum.reshape(L)


# z ranges starting and ending between vertices (block origin z 60.75),
# spacings that fit the table (10, 3) and overflow it (0.5, and 1 over the
# first 128 z outputs), grid origins that clamp the coordinates below 0
# (+50) and past the last vertex (-35); the last item: whether the tiles
# were tabled
NONRIGID = [((5, 3, 7), 10.0, 0.0, {True}),
            ((3, 40, 9), 10.0, -35.0, {True}),
            ((2, 5, 64), 10.0, 50.0, {True}),
            ((2, 17, 33), 0.5, 0.0, {False}),
            ((2, 9, 40), 3.0, 0.0, {True}),
            ((2, 3, 130), 1.0, 0.0, {False, True}),
            ((1, 1, 1), 10.0, 0.0, {True})]


@pytest.mark.parametrize("fusion_type", ["AVG_BLEND", "FIRST_WINS"])
@pytest.mark.parametrize("case", NONRIGID, ids=lambda c: "x".join(
    map(str, c[0])) + f"-cpd{c[1]:g}-shift{c[2]:g}")
def test_k26_factored_lerps_equal_twin(case, fusion_type):
    bs, cpd, shift, tabled = case
    rng = np.random.default_rng(54)
    V = 2
    args = _nonrigid_inputs(rng, V, bs, cpd, shift)
    grids, bo, go, sp = args[1], args[8], args[9], args[10]
    plan = F.resample_plan(bs, V, tuple(args[0].shape[1:]))
    models, used = [], set()
    for v in range(V):
        m, u = _factored_models(grids[v], bo, go, sp, bs, plan)
        models.append(m)
        used |= u
    # the twin's models: the grid lerped along x, then y, then z
    for v in range(V):
        so = grids[v]
        for d in range(3):
            i = torch.arange(bs[d], dtype=torch.float32)
            so = NR._lerp_axis(so, d, ((bo[d] + i) - go[d]) / sp[d])
        assert torch.equal(models[v], so.reshape(-1, 12))
    got = _fuse_with_models(args, bs, models, fusion_type)
    ref = NR.nonrigid_fuse_block_plain(*args, bs, fusion_type)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert used == tabled
