"""K2's and K28's launch plans (``ops/fusion.py`` ``shift_launch_plan``,
``ops/epilogue.py`` ``epilogue_plan``) and the arithmetic of the two
kernels, held on the CPU against numpy emulations of what they do.

K2 (``csrc/shift.cu``) gives a thread RESAMPLE_R consecutive z outputs of
one (i, j) column, lanes_z threads a column, a block of SHIFT_THREADS
threads a tile of one i, the batch row in the grid's third index. A block
copies each view's window, 2 planes of tile_j + 1 patch rows, in 16-byte
pieces from each row's z0 value's aligned-down address into shared memory,
and a thread reads its run's 5 values of its 4 rows from there. The
emulation walks every block, thread and run: every output voxel of every
batch row is written once, for blocks that are not multiples of the run
or the tile, and every value a thread reads from the staged window is the
patch value its tap names. The kernel's arithmetic (corner weights (wx wy)
wz once a view, a column's x-y products once a column, the taps in JAX's
order, the combine view by view) must give ``fuse_block_shift_plain``'s
outputs bit for bit.

K28 (``csrc/epilogue.cu``) gives a block a tile of the last level and its
footprint in s0 and every level between; levels whose footprint passes
shared memory go to a later segment. The emulation walks every segment,
block and thread: every s0 and level voxel is made once, and each level
computed from the staged level below (x, then y, then z means, an IEEE
division unless the factor is 1, clamp then round half to even by adding
2^23) equals ``block_epilogue_plain`` bit for bit.
"""

import math

import numpy as np
import pytest
import torch

from bigstitcher_spark_tpu_torch.ops import epilogue as E
from bigstitcher_spark_tpu_torch.ops import fusion as F

torch.set_num_threads(1)

F32 = np.float32
R = F.RESAMPLE_R

# ------------------------------------------------------------------ K2


def _k2_threads(plan, bs, B):
    """Every (block, thread, run) of K2's launch, as the kernel finds its
    place: (b, i, j, k0, nk) per thread, flattened."""
    bx, by, bz = bs
    lz, (_, tile_j, tile_z) = plan.lanes_z, plan.tile
    gx, gy, gz = plan.grid
    b0 = np.arange(gx)[:, None, None, None]
    b1 = np.arange(gy)[None, :, None, None]
    b2 = np.arange(gz)[None, None, :, None]
    t = np.arange(F.SHIFT_THREADS)[None, None, None, :]
    i = b0 // plan.n_jt
    j = (b0 - i * plan.n_jt) * tile_j + t // lz
    k0 = b1 * tile_z + (t & (lz - 1)) * R
    nk = np.where(j < by, np.clip(bz - k0, 0, R), 0)
    b, i, j, k0, nk = np.broadcast_arrays(b2, i, j, k0, nk)
    return [a.reshape(-1) for a in (b, i, j, k0, nk)]


def _k2_covered(plan, bs, B):
    count = np.zeros((B, *bs), np.int64)
    b, i, j, k0, nk = _k2_threads(plan, bs, B)
    for r in range(R):
        keep = r < nk
        np.add.at(count, (b[keep], i[keep], j[keep], k0[keep] + r), 1)
    return count


BLOCKS = [(37, 29, 13), (5, 3, 7), (256, 256, 64), (1, 1, 1), (3, 40, 9),
          (2, 3, 130), (4, 70, 66), (1, 300, 1)]


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("bs", BLOCKS, ids=lambda b: "x".join(map(str, b)))
def test_k2_plan_covers_every_voxel_once(bs, B):
    plan = F.shift_launch_plan(bs, 4, B)
    assert plan.grid[2] == B
    assert (_k2_covered(plan, bs, B) == 1).all()
    # lanes_z: the power of two at or above the block's runs, at most 32
    assert plan.lanes_z == min(32, 1 << math.ceil(math.log2(-(-bs[2] // R))))
    assert plan.tile == (1, F.SHIFT_THREADS // plan.lanes_z,
                         R * plan.lanes_z)
    assert plan.n_jt == -(-bs[1] // plan.tile[1])


def test_k2_plan_at_the_main_paths_block():
    """256 x 256 x 64 uint16: 16 lanes a column, 16 columns a block, one z
    tile; each staged row 144 bytes (a 14-byte lead and 65 values); all 4
    views staged at once in 43.5 KB; 32-bit indices."""
    plan = F.shift_launch_plan((256, 256, 64), 4, 16, 2)
    assert plan.lanes_z == 16 and plan.tile == (1, 16, 64)
    assert plan.grid == (256 * 16, 1, 16) and plan.nvs == 4
    assert plan.row_bytes == 144 and not plan.idx64
    assert plan.smem == 4 * (2 * 17 * 144 + 8 * 16 + 8 * 64) <= F.SHIFT_SMEM


@pytest.mark.parametrize("itemsize", [1, 2, 4])
@pytest.mark.parametrize("bs,V", [((5, 3, 7), 1), ((37, 29, 13), 9),
                                  ((2, 300, 3), 3), ((3, 20, 150), 12),
                                  ((256, 256, 64), 33)])
def test_k2_plan_stages_fit(bs, V, itemsize):
    """A stage's windows, column products and z tables fit SHIFT_SMEM;
    a staged row holds the worst lead (16 - itemsize bytes) and the
    tile_z + 1 values; at most RESAMPLE_VIEW_CHUNK views a stage."""
    plan = F.shift_launch_plan(bs, V, 1, itemsize)
    _, tile_j, tile_z = plan.tile
    per_view = 2 * (tile_j + 1) * plan.row_bytes + 8 * tile_j + 8 * tile_z
    assert 1 <= plan.nvs <= min(V, F.RESAMPLE_VIEW_CHUNK)
    assert plan.smem == plan.nvs * per_view <= F.SHIFT_SMEM
    assert plan.nvs == V or (plan.nvs + 1) * per_view > F.SHIFT_SMEM \
        or plan.nvs == F.RESAMPLE_VIEW_CHUNK
    assert plan.row_bytes % 16 == 0
    assert 16 - itemsize + (tile_z + 1) * itemsize <= plan.row_bytes
    assert plan.row_bytes - 16 < 16 - itemsize + (tile_z + 1) * itemsize


@pytest.mark.parametrize("bs,idx64", [
    ((256, 256, 64), False), ((1289, 1289, 1289), False),
    ((1023, 1023, 2047), True), ((1290, 1290, 1290), True)])
def test_k2_plan_index_width(bs, idx64):
    """32-bit patch indices below 2^31 patch elements ((bx + 1)(by + 1)
    (bz + 1)), 64-bit from 2^31."""
    assert (math.prod(s + 1 for s in bs) >= 2 ** 31) is idx64
    assert F.shift_launch_plan(bs, 1).idx64 is idx64


@pytest.mark.parametrize("bs,V,B", [((0, 3, 7), 1, 1), ((5, 3, 7), 0, 1),
                                    ((5, 3, 7), 1, 0), ((5, 3, 7), 1, 65536)])
def test_k2_plan_refuses(bs, V, B):
    with pytest.raises(ValueError):
        F.shift_launch_plan(bs, V, B)


def _umulhi_div(e, d):
    """e / d as the kernel takes it: umulhi(e, ceil(2^32 / d))."""
    m = (0xFFFFFFFF // d + 1) & 0xFFFFFFFF
    return (np.asarray(e, np.uint64) * np.uint64(m)) >> np.uint64(32)


def _k2_stage(flat, plan, bs, V, nv, c0, b, i, j0, z0, itemsize):
    """One stage's windows as the kernel copies them: for each staged row
    (plane i + cx, patch row min(j0 + u, by)) and 16-byte piece m, the
    bytes at (the row's z0 value's address rounded down to 16) + 16 m of
    the patches' bytes ``flat`` (zeros past their end)."""
    bx, by, bz = bs
    _, tile_j, _ = plan.tile
    rows_v, nch = 2 * (tile_j + 1), plan.row_bytes // 16
    pvol = (bx + 1) * (by + 1) * (bz + 1)
    win = rows_v * plan.row_bytes
    smem = np.zeros(nv * win, np.uint8)
    e = np.arange(nv * rows_v * nch)
    rw = _umulhi_div(e, nch).astype(np.int64)
    m = e - rw * nch
    vv = _umulhi_div(rw, rows_v).astype(np.int64)
    rr = rw - vv * rows_v
    assert (rw == e // nch).all() and (vv == rw // rows_v).all()
    cx = (rr >= tile_j + 1).astype(np.int64)
    u = rr - cx * (tile_j + 1)
    elem = ((b * V + c0 + vv) * pvol
            + ((i + cx) * (by + 1) + np.minimum(j0 + u, by)) * (bz + 1) + z0)
    src = (elem * itemsize) // 16 * 16 + 16 * m
    for k in range(16):
        ok = src + k < flat.size
        dst = vv * win + rr * plan.row_bytes + 16 * m + k
        smem[dst[ok]] = flat[src[ok] + k]
    return smem


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("bs,V,B", [((37, 29, 13), 3, 2), ((5, 3, 7), 2, 1),
                                    ((3, 9, 130), 9, 1)],
                         ids=["37x29x13", "5x3x7", "3x9x130"])
def test_k2_staged_windows_hold_every_tap(bs, V, B, dtype):
    """Every value a thread reads from a staged window (its row's byte
    offset, the row's lead at view v, its run's offset, r element sizes)
    is the patch value its tap (b, v, i + cx, j + cy, k0 + r) names, for
    every block, stage, thread and r <= nk (the patches start 16-byte
    aligned, as the wrapper makes them)."""
    rng = np.random.default_rng(81)
    bx, by, bz = bs
    patches = rng.integers(0, 250, (B, V, bx + 1, by + 1, bz + 1)).astype(
        dtype)
    flat = patches.reshape(-1).view(np.uint8)
    sz = patches.itemsize
    plan = F.shift_launch_plan(bs, V, B, sz)
    _, tile_j, tile_z = plan.tile
    pvol = (bx + 1) * (by + 1) * (bz + 1)
    t = np.arange(F.SHIFT_THREADS)
    lz, jj = t & (plan.lanes_z - 1), t // plan.lanes_z
    seen = 0
    for b in range(B):
        for gy in range(plan.grid[1]):
            for gx in range(plan.grid[0]):
                i, jt = divmod(gx, plan.n_jt)
                j0, z0 = jt * tile_j, gy * tile_z
                j, k0 = j0 + jj, z0 + lz * R
                nk = np.where(j < by, np.clip(bz - k0, 0, R), 0)
                for c0 in range(0, V, plan.nvs):
                    nv = min(plan.nvs, V - c0)
                    smem = _k2_stage(flat, plan, bs, V, nv, c0, b, i, j0, z0,
                                     sz)
                    win = 2 * (tile_j + 1) * plan.row_bytes
                    for vv in range(nv):
                        for q in range(4):
                            cx, cy = q >> 1, q & 1
                            srow = (((cx * (tile_j + 1) + jj + cy)
                                     * plan.row_bytes) + (k0 - z0) * sz)
                            row = ((b * V + c0 + vv) * pvol
                                   + ((i + cx) * (by + 1)
                                      + np.minimum(j + cy, by)) * (bz + 1)
                                   + z0)
                            lead = (row * sz) % 16
                            for r in range(R + 1):
                                ok = (nk > 0) & (r <= nk)
                                at = vv * win + srow + lead + r * sz
                                got = np.stack([smem[at + k] for k in
                                                range(sz)], -1)[ok]
                                got = got.copy().view(dtype).reshape(-1)
                                want = patches[b, c0 + vv, i + cx,
                                               (j + cy)[ok], (k0 + r)[ok]]
                                assert np.array_equal(got, want)
                                seen += int(ok.sum())
    assert seen > 0


def _k2_emulate(patches, fracs, tables, valid, bs, fusion_type):
    """K2's arithmetic in numpy float32, one view after another as a
    thread combines them: corner weights (wx wy) wz once a view, the
    column's x-y products, then for each voxel val = val + w P over the
    taps in JAX's order from val = 0, inside (ins_xy ins_z), blend
    (w_xy w_z) and the combine of bst::CombinerT."""
    bx, by, bz = bs
    S = bx + by + bz
    P = patches.astype(F32)
    ft = fusion_type
    acc = np.full(bs, -np.inf if ft == "MAX_INTENSITY" else 0.0, F32)
    wsum = np.zeros(bs, F32)
    hit = np.zeros(bs, bool)
    one = F32(1.0)
    for v in range(P.shape[0]):
        f = fracs[v]
        c = [((f[0] if n & 4 else one - f[0]) * (f[1] if n & 2 else one - f[1]))
             * (f[2] if n & 1 else one - f[2]) for n in range(8)]
        val = np.zeros(bs, F32)
        for q in range(4):
            cx, cy = q >> 1, q & 1
            for cz in (0, 1):
                val = val + c[2 * q + cz] * P[v, cx:cx + bx, cy:cy + by,
                                              cz:cz + bz]
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


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("fusion_type", F.FUSION_TYPES)
def test_k2_arithmetic_equals_twin(fusion_type, dtype):
    """The kernel's order of operations gives fuse_block_shift_plain's
    fused and wsum bit for bit (wsum > 0 is masks mode's coverage), with
    inside offsets, a switched-off view and voxels outside the images."""
    rng = np.random.default_rng(82)
    bs, V = (37, 29, 13), 4
    hi = 250 if dtype == np.uint8 else 4000
    patches = rng.uniform(0, hi, (V, *(s + 1 for s in bs))).astype(dtype)
    fr = rng.uniform(0, 1, (V, 3)).astype(F32)
    lp = (rng.uniform(-20, 60, (V, 3)) + fr).astype(F32)
    dims = np.tile(F32([70, 60, 30]), (V, 1))
    borders = rng.uniform(0, 3, (V, 3)).astype(F32)
    ranges = rng.uniform(5, 30, (V, 3)).astype(F32)
    ioffs = rng.uniform(0, 2, (V, 3)).astype(F32)
    valid = np.ones(V, F32)
    valid[1] = 0.0
    t = [torch.from_numpy(a) for a in (patches, fr, lp, dims, borders,
                                       ranges, valid, ioffs)]
    want = F.fuse_block_shift_plain(*t[:7], bs, fusion_type, t[7])
    tables = F.shift_axis_tables(t[2], t[3], t[4], t[5], t[7], bs).numpy()
    fused, wsum = _k2_emulate(patches, fr, tables, valid, bs, fusion_type)
    assert wsum.min() == 0 and wsum.max() > 0  # some voxels outside
    assert np.array_equal(fused.view(np.uint32), want[0].numpy().view(
        np.uint32))
    assert np.array_equal(wsum.view(np.uint32), want[1].numpy().view(
        np.uint32))
    assert np.array_equal(wsum > 0, want[1].numpy() > 0)


# ----------------------------------------------------------------- K28


EPI_CASES = [
    ((32, 16, 8), ()), ((32, 16, 8), ((2, 2, 2), (2, 2, 1))),
    ((32, 16, 8), ((2, 2, 1),)), ((32, 16, 8), ((2, 2, 1), (2, 1, 2))),
    ((36, 18, 8), ((3, 3, 1), (2, 1, 2))),
    ((32, 16, 8), ((4, 2, 1), (1, 2, 2), (2, 2, 2))),
    ((256, 256, 64), ((2, 2, 2),)), ((16, 200, 64), ((2, 2, 2),)),
    ((12, 40, 20), ((2, 2, 2), (2, 2, 2))), ((4, 6, 260), ((2, 2, 2),)),
    ((6, 10, 14), ((2, 2, 2),)), ((128, 128, 2), ((4, 4, 1), (4, 4, 1),
                                                  (8, 8, 1))),
    ((64, 64, 2), ((2, 2, 1),) * 5), ((2, 3, 9), ((1, 1, 3),))]
EPI_IDS = ["x".join(map(str, s)) + "-" + ".".join(
    "".join(map(str, r)) for r in rels) for s, rels in EPI_CASES]


def _split_items(steps, ext):
    """The (x, y, z item) a box's thread split walks: thread t at (t / (s2
    s1), t / s2 mod s1, t mod s2), each stepping by the split."""
    s0, s1, s2 = steps
    out = []
    for t in range(E.EPILOGUE_THREADS):
        x, y, q = t // (s2 * s1), (t // s2) % s1, t % s2
        if x >= s0:
            continue
        for xx in range(x, ext[0], s0):
            for yy in range(y, ext[1], s1):
                for qq in range(q, ext[2], s2):
                    out.append((xx, yy, qq))
    return out


@pytest.mark.parametrize("itemsize", [1, 2, 4])
@pytest.mark.parametrize("shape,rels", EPI_CASES, ids=EPI_IDS)
def test_k28_plan_makes_every_voxel_once(shape, rels, itemsize):
    """Every segment's blocks (tiles of its last level, masked at the
    block's end) make every voxel of its levels once, and of s0 in the
    first; the segments chain level to level; each kept box lies in the
    block's shared memory, 16-byte aligned, without overlap."""
    segs = E.epilogue_plan(shape, rels, itemsize)
    dims = [tuple(shape)] + E._level_dims(shape, rels)
    made = [np.zeros(d, np.int64) for d in dims]
    first = 0
    for seg in segs:
        assert seg.first == first and seg.dims == tuple(
            dims[first:first + len(seg.rels) + 1])
        assert seg.rels == tuple(tuple(r) for r in rels[first:first
                                                         + len(seg.rels)])
        n = len(seg.rels)
        scales = E._scales(seg.rels)
        last = seg.dims[-1]
        assert seg.ntiles == tuple(-(-a // t) for a, t in zip(last, seg.tile))
        assert 0 < seg.smem <= E.EPILOGUE_SMEM or (n == 0 and seg.smem == 0)
        end = 0
        for l, bx in enumerate(seg.boxes):
            assert bx.dims == tuple(t * s for t, s in zip(seg.tile,
                                                          scales[l]))
            assert math.prod(bx.steps) <= E.EPILOGUE_THREADS
            if l < n:
                assert bx.smem_off % 16 == 0 and bx.smem_off >= end
                end = bx.smem_off + math.prod(bx.dims) * itemsize
                assert end <= seg.smem
            else:
                assert bx.smem_off == -1
        for tile in np.ndindex(*seg.ntiles):
            org = [t * s for t, s in zip(tile, seg.tile)]
            cnt = [min(t, a - o) for t, a, o in zip(seg.tile, last, org)]
            for l in range(n + 1):
                lvl = first + l
                if l == 0 and first > 0:
                    continue  # the input of a later segment, made before
                lo = [o * s for o, s in zip(org, scales[l])]
                ext = [c * s for c, s in zip(cnt, scales[l])]
                made[lvl][lo[0]:lo[0] + ext[0], lo[1]:lo[1] + ext[1],
                          lo[2]:lo[2] + ext[2]] += 1
        first += n
    assert first == len(rels)
    for m in made:
        assert (m == 1).all()


@pytest.mark.parametrize("shape,rels", EPI_CASES[:10], ids=EPI_IDS[:10])
def test_k28_thread_splits_cover_each_box(shape, rels):
    """The input phase's items (vectors of 4 where ``vec``) and each
    level's voxels: every item of a whole tile's box and of a masked
    edge's box is taken by one thread once."""
    for seg in E.epilogue_plan(shape, rels, 2):
        last = seg.dims[-1]
        edge = [a - (n - 1) * t for a, n, t in zip(last, seg.ntiles,
                                                   seg.tile)]
        scales = E._scales(seg.rels)
        for l, bx in enumerate(seg.boxes):
            for cnt in (seg.tile, edge):
                ext = [c * s for c, s in zip(cnt, scales[l])]
                width = bx.width
                assert ext[2] % width == 0
                ext[2] //= width
                items = _split_items(bx.steps, ext)
                assert len(items) == len(set(items)) == math.prod(ext)


@pytest.mark.parametrize("shape,rels,aligned,vec", [
    ((16, 24, 64), ((2, 2, 2),), True, 4),
    ((16, 24, 64), ((2, 2, 2),), False, 1),
    ((6, 10, 14), ((2, 2, 2),), True, 1),     # Z not a multiple of 4
    ((8, 8, 12), ((1, 1, 3),), True, 4),
    ((2, 3, 9), ((1, 1, 3),), True, 1)])
def test_k28_plan_vectors(shape, rels, aligned, vec):
    """Phase 1 reads vectors of 4 where the block's z extent and the
    tile's footprint along z are multiples of 4 and the pointers allow."""
    seg = E.epilogue_plan(shape, rels, 2, aligned)[0]
    assert seg.vec == vec and seg.boxes[0].width == vec


def test_k28_plan_at_the_main_paths_block():
    """16 x 256x256x64 -> uint16 with level (2,2,2): one launch, a tile of
    1x16x32 level voxels over 2x32x64 of s0 (whole z rows), 8 KB of shared
    memory, vectors of 4."""
    (seg,) = E.epilogue_plan((256, 256, 64), ((2, 2, 2),), 2)
    assert seg.tile == (1, 16, 32) and seg.boxes[0].dims == (2, 32, 64)
    assert seg.ntiles == (128, 8, 1) and seg.smem == 2 * 32 * 64 * 2
    assert seg.vec == 4 and seg.boxes[0].steps == (1, 16, 16)


def test_k28_plan_splits_segments_and_refuses():
    """Levels whose one-voxel footprint passes EPILOGUE_SMEM go to a
    further segment; a level whose own window does raises."""
    segs = E.epilogue_plan((128, 128, 2), ((4, 4, 1), (4, 4, 1), (8, 8, 1)),
                           4)
    assert [(s.first, len(s.rels)) for s in segs] == [(0, 2), (2, 1)]
    with pytest.raises(ValueError, match="shared memory"):
        E.epilogue_plan((256, 256, 1), ((256, 256, 1),), 4)
    with pytest.raises(ValueError, match="do not divide"):
        E.epilogue_plan((32, 16, 8), ((5, 1, 1),), 2)
    with pytest.raises(ValueError, match="at most"):
        E.epilogue_plan((512, 2, 2), ((2, 1, 1),) * 9, 2)


def _storage(x, out_dtype):
    """to_storage: clamp to [0, imax], add 2^23, the low 16 bits."""
    if out_dtype == "float32":
        return x.astype(F32)
    imax = F32(255.0 if out_dtype == "uint8" else 65535.0)
    y = np.minimum(np.maximum(x, F32(0)), imax) + F32(2 ** 23)
    return (y.view(np.uint32) & 0xFFFF).astype(
        np.uint8 if out_dtype == "uint8" else np.uint16)


def _mean_of_window(prev, r):
    """One level voxel per window of ``prev`` (a staged box) in the
    kernel's order: x sums, / rx; y sums of those, / ry; z likewise."""
    rx, ry, rz = r
    X, Y, Z = (s // f for s, f in zip(prev.shape, r))
    acc_z = None
    for dz in range(rz):
        acc_y = None
        for dy in range(ry):
            acc_x = prev[0::rx, dy::ry, dz::rz][:X, :Y, :Z].astype(F32)
            for dx in range(1, rx):
                acc_x = acc_x + prev[dx::rx, dy::ry, dz::rz][:X, :Y, :Z]
            m_x = acc_x if rx == 1 else acc_x / F32(rx)
            acc_y = m_x if dy == 0 else acc_y + m_x
        m_y = acc_y if ry == 1 else acc_y / F32(ry)
        acc_z = m_y if dz == 0 else acc_z + m_y
    return acc_z if rz == 1 else acc_z / F32(rz)


@pytest.mark.parametrize("out_dtype", ["uint8", "uint16", "float32"])
@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("shape,rels", [
    ((32, 16, 8), ((2, 2, 2),)), ((36, 18, 8), ((3, 3, 1), (2, 1, 2))),
    ((32, 16, 8), ((4, 2, 1), (1, 2, 2), (2, 2, 2))),
    ((16, 200, 64), ((2, 2, 2),))], ids=["1", "2-mixed", "3-mixed", "edge"])
def test_k28_levels_from_staged_tiles_equal_twin(shape, rels, masks,
                                                 out_dtype):
    """s0 converted as phase 1 does it, and every level computed tile by
    tile from the level below as staged in shared memory, equal
    block_epilogue_plain bit for bit."""
    rng = np.random.default_rng(83)
    B = 2
    fused = rng.uniform(-50, 3300, (B, *shape)).astype(F32)
    fused.reshape(-1)[::7] = 0.0
    fused.reshape(-1)[3::11] = -0.0
    wsum = np.where(rng.random((B, *shape)) < 0.3, 0.0,
                    rng.uniform(0, 2, (B, *shape))).astype(F32)
    mn, mx = F32(0.0), F32(3000.0)
    want = E.block_epilogue_plain(torch.from_numpy(fused),
                                  torch.from_numpy(wsum), float(mn),
                                  float(mx), out_dtype, masks, rels)
    itemsize = want[0].element_size()
    if masks:
        on = F32(1.0 if out_dtype == "float32" else
                 (255.0 if out_dtype == "uint8" else 65535.0))
        s0 = np.where(wsum > 0, on, F32(0)).astype(want[0].numpy().dtype)
    elif out_dtype == "float32":
        s0 = fused
    else:
        imax = F32(255.0 if out_dtype == "uint8" else 65535.0)
        s0 = _storage((fused - mn) / (mx - mn) * imax, out_dtype)
    got = [s0] + [np.zeros(tuple(w.shape), s0.dtype) for w in want[1:]]
    for seg in E.epilogue_plan(shape, rels, itemsize):
        scales = E._scales(seg.rels)
        last = seg.dims[-1]
        for b in range(B):
            for tile in np.ndindex(*seg.ntiles):
                org = [t * s for t, s in zip(tile, seg.tile)]
                cnt = [min(t, a - o) for t, a, o in zip(seg.tile, last, org)]
                lo = [o * s for o, s in zip(org, scales[0])]
                ext = [c * s for c, s in zip(cnt, scales[0])]
                box = got[seg.first][b, lo[0]:lo[0] + ext[0],
                                     lo[1]:lo[1] + ext[1],
                                     lo[2]:lo[2] + ext[2]].copy()
                for l, r in enumerate(seg.rels, start=1):
                    box = _storage(_mean_of_window(box, r), out_dtype)
                    lo = [o * s for o, s in zip(org, scales[l])]
                    lvl = got[seg.first + l]
                    lvl[b, lo[0]:lo[0] + box.shape[0],
                        lo[1]:lo[1] + box.shape[1],
                        lo[2]:lo[2] + box.shape[2]] = box
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = w.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8))
