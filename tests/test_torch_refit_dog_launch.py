"""K22's and K16's launch plans (``ops/descriptors.py`` ``refit_plan``,
``ops/dog.py`` ``extrema_plan``) and numpy emulations of both kernels'
walks, held on the CPU against what the kernels do.

K22 (``csrc/ransac.cu`` refit_kernel) gives each block a contiguous run of
``per_block`` candidates; thread t takes rows r0 + t, r0 + t + 256, ... and
sums its inliers' float64 moments in that order, each warp's shuffle-down
tree and then the warps in order give the block's partial, and the last
block adds the partials in block order. The emulation repeats that order
exactly: it must reach every row once, give the same bits run to run, and
stay within 1e-12 (relative to the terms' magnitude) of the twin's torch
sums; with one block it is the first form's order. K16 (``csrc/dog.cu``
extrema_kernel) gives each block a (y, z) tile and a chunk of x planes; it
computes dog over the tile and a one-voxel halo into a ring of four planes
and tests the plane behind against its 26 neighbours from the ring. The
emulation keeps the ring as the kernel does (which voxel each slot
holds, and its dog), so it must write every dog voxel once, test every
voxel once, read exactly the in-block 3x3x3 window of each, and give the
twin's mask; a warp's queue must give each voxel past the threshold one
slot.
"""

import numpy as np
import pytest
import torch

from bigstitcher_spark_tpu_torch.ops import descriptors as DS
from bigstitcher_spark_tpu_torch.ops import dog as G
from bigstitcher_spark_tpu_torch.ops import models as MD

THREADS = 256  # csrc/ransac.cu kRefitThreads
MOMENTS = 22


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cdiv(a, b):
    return -(-a // b)


# ------------------------------------------------------------ K22


def _refit_launcher_accepts(plan, M) -> bool:
    """The checks bst_ransac_refit makes of a plan."""
    b, per = plan.blocks, plan.per_block
    return (1 <= b <= DS.REFIT_MAX_BLOCKS and per >= 1
            and b * per >= M > (b - 1) * per)


REFIT_M = [1, 2, 47, 155, 255, 256, 257, 511, 512, 1023, 1024, 1025, 4096,
           58274, 100_000, 400_000, 1_000_000]


@pytest.mark.parametrize("M", REFIT_M, ids=str)
@pytest.mark.parametrize("sms", [132, 114, 78, 264])
def test_refit_plan_covers_each_row_once(M, sms):
    plan = DS.refit_plan(M, sms)
    assert _refit_launcher_accepts(plan, M)
    assert plan.blocks <= DS.REFIT_BLOCKS_PER_SM * sms
    seen = np.zeros(M, np.int64)
    for blk in range(plan.blocks):
        r0, r1 = blk * plan.per_block, min(M, (blk + 1) * plan.per_block)
        assert r1 > r0  # no block is empty
        for t in range(min(THREADS, r1 - r0)):
            seen[r0 + t:r1:THREADS] += 1
    assert (seen == 1).all()


def test_refit_plan_at_the_main_paths_shapes():
    """9a's pairs (47-155 candidates) take the one-block form; 9b's 58,274
    fill most of the card, a block every 512 or so rows."""
    for m in (47, 155, 166):
        assert DS.refit_plan(m, 132) == DS.RefitPlan(1, m)
    plan = DS.refit_plan(58274, 132)
    assert 100 <= plan.blocks <= 132 and plan.per_block >= DS.REFIT_MIN_ROWS
    with pytest.raises(ValueError):
        DS.refit_plan(0)


def _warp_tree(v):
    """Lane 0's value after the shuffle-down tree (v += shfl_down(v, off),
    off 16 .. 1) over a warp's 32 values (axis 0)."""
    v = v.copy()
    for off in (16, 8, 4, 2, 1):
        v[:off] = v[:off] + v[off:2 * off]
    return v[0]


def _refit_emulated(pa, pb, model, eps, plan):
    """K22's mask, count and moments, in its order of summation."""
    p = pa.astype(np.float64)
    q = pb.astype(np.float64)
    m = model.reshape(-1)
    e2 = None
    for j in range(3):
        d = (((m[4 * j] * p[:, 0] + m[4 * j + 1] * p[:, 1])
              + m[4 * j + 2] * p[:, 2]) + m[4 * j + 3]) - q[:, j]
        e2 = d * d if e2 is None else e2 + d * d
    mask = e2 < eps * eps
    # each row's 22 terms (zero where it is no inlier: the kernel skips it)
    terms = np.zeros((len(p), MOMENTS))
    terms[:, 0] = 1.0
    terms[:, 1:4] = p
    terms[:, 4:7] = q
    k = 7
    for i in range(3):
        for j in range(i, 3):
            terms[:, k] = p[:, i] * p[:, j]
            k += 1
    for i in range(3):
        for j in range(3):
            terms[:, 13 + 3 * i + j] = p[:, i] * q[:, j]
    terms[~mask] = 0.0
    total = np.zeros(MOMENTS)
    count = 0
    for blk in range(plan.blocks):
        r0 = blk * plan.per_block
        r1 = min(len(p), r0 + plan.per_block)
        acc = np.zeros((THREADS, MOMENTS))
        for t in range(THREADS):
            for r in range(r0 + t, r1, THREADS):
                acc[t] = acc[t] + terms[r]
        part = np.zeros(MOMENTS)
        for w in range(THREADS // 32):
            part = part + _warp_tree(acc[32 * w:32 * w + 32])
        total = total + part
        count += int(mask[r0:r1].sum())
    return mask, count, total


def _twin_moments(pa, pb, mask):
    """The twin's moments (ransac_refit_plain's torch sums) and the sums
    of the terms' magnitudes."""
    def moments(p, q, w):
        iu = torch.triu_indices(3, 3)
        spp = torch.einsum("n,ni,nj->ij", w, p, p)
        spq = torch.einsum("n,ni,nj->ij", w, p, q)
        return torch.cat([w.sum()[None], (w[:, None] * p).sum(0),
                          (w[:, None] * q).sum(0), spp[iu[0], iu[1]],
                          spq.reshape(-1)]).numpy()

    p = torch.from_numpy(pa).double()
    q = torch.from_numpy(pb).double()
    w = torch.from_numpy(mask).double()
    return moments(p, q, w), moments(p.abs(), q.abs(), w)


def _refit_case(m, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 900, (m, 3))
    b = a + np.array([3.0, -2.0, 1.0]) + rng.normal(0, 1.0, a.shape)
    b[: m // 4] += rng.uniform(-30, 30, (m // 4, 3))
    model = np.array([[1, 0, 0, 3], [0, 1, 0, -2], [0, 0, 1, 1.0]])
    return a.astype(np.float32), b.astype(np.float32), model


@pytest.mark.parametrize("M", [1, 155, 1025, 5000, 58274], ids=str)
def test_refit_order_repeats_and_matches_the_twin(M):
    """The fixed order gives the same bits twice, the twin's mask and
    count, moments within 1e-12 of the terms' magnitude, and through the
    unchanged fit a model within the card contract (rtol 1e-9 / atol 1e-9)
    of the twin's."""
    pa, pb, model = _refit_case(M, M)
    plan = DS.refit_plan(M)
    mask, count, mo = _refit_emulated(pa, pb, model, 2.5, plan)
    mask2, count2, mo2 = _refit_emulated(pa, pb, model, 2.5, plan)
    assert np.array_equal(mask, mask2) and count == count2
    assert mo.tobytes() == mo2.tobytes()
    ref = DS.ransac_refit_plain(torch.from_numpy(pa), torch.from_numpy(pb),
                                torch.from_numpy(model), 2.5, "AFFINE",
                                "RIGID", 0.1)
    assert np.array_equal(mask, ref[0].numpy()) and count == int(ref[1])
    twin, mag = _twin_moments(pa, pb, mask)
    assert (np.abs(mo - twin) <= 1e-12 * np.maximum(mag, 1e-300)).all()
    if count < 4:
        return
    pc, qc = mo[1:4] / mo[0], mo[4:7] / mo[0]
    a = np.empty((3, 3))
    k = 7
    for i in range(3):
        for j in range(i, 3):
            a[i, j] = a[j, i] = mo[k] - mo[1 + i] * pc[j]
            k += 1
    h = mo[13:].reshape(3, 3) - mo[1:4, None] * qc[None, :]
    t = lambda v: torch.from_numpy(np.asarray(v, np.float64))
    got = MD.fit_interpolated_centred("AFFINE", "RIGID", 0.1, t(pc), t(qc),
                                     t(a), t(h))
    torch.testing.assert_close(got, ref[2], rtol=1e-9, atol=1e-9)


def test_refit_one_block_is_the_first_forms_order():
    """Below 2 x REFIT_MIN_ROWS candidates the plan is one block: the
    emulated order is then the first form's (a thread's strided rows, the
    warp trees, the warps in order), whatever the card."""
    pa, pb, model = _refit_case(900, 3)
    one = DS.refit_plan(900, 132)
    assert one.blocks == 1
    _, _, mo = _refit_emulated(pa, pb, model, 2.5, one)
    _, _, again = _refit_emulated(pa, pb, model, 2.5, DS.refit_plan(900, 8))
    assert mo.tobytes() == again.tobytes()


# ------------------------------------------------------------ K16

RING = 4  # csrc/dog.cu kExRing: planes of dog in shared memory


def _extrema_launcher_accepts(plan, B, X, Y, Z) -> bool:
    """The checks bst_dog_extrema makes of a plan (and its grid)."""
    V = 4 if plan.vec else 1
    tiles = _cdiv(Y, plan.ty) * _cdiv(Z, plan.tz)
    sp = _cdiv(plan.tz, 4) * 4 + 8
    smem = 4 * RING * (plan.ty + 2) * sp + G.EXTREMA_QUEUES
    assert G.EXTREMA_RING == RING
    return (plan.ty >= 1 and plan.tz >= 1 and plan.xc >= 1
            and plan.tz % V == 0 and (not plan.vec or Z % 4 == 0)
            and (plan.ty + 2) * (plan.tz // V)
            <= G.EXTREMA_ITEMS * G.EXTREMA_THREADS
            and 2 * (plan.ty + 2) <= G.EXTREMA_THREADS
            and (plan.ty + 2) * sp <= 65535
            and _cdiv(X, plan.xc) <= 65535 and smem <= G.EXTREMA_SMEM
            and plan.grid == (tiles, _cdiv(X, plan.xc), B))


# 8a's bucket; axes shorter than a tile, Z not a multiple of 4, X of 1 and
# 2, B = 3, several y and z tiles and x chunks
EXTREMA_SHAPES = [(2, 528, 528, 144), (3, 40, 36, 28), (1, 1, 40, 44),
                  (2, 2, 41, 43), (3, 20, 40, 42), (1, 17, 70, 300),
                  (1, 9, 45, 130), (2, 1, 3, 5), (1, 3, 1, 1)]


@pytest.mark.parametrize("shape", EXTREMA_SHAPES, ids=str)
@pytest.mark.parametrize("sms", [132, 78])
@pytest.mark.parametrize("addr", [0, 4])
def test_extrema_plan_passes_the_launchers_checks(shape, sms, addr):
    plan = G.extrema_plan(*shape, sms=sms, addr=addr)
    assert _extrema_launcher_accepts(plan, *shape)
    assert plan.vec == (shape[3] % 4 == 0 and addr == 0)


def test_extrema_plan_at_8as_bucket():
    """8a's bucket: whole z rows (no z halo) as float4s, y tiles of at most
    EXTREMA_MAX_TY rows, x cut into chunks of at most EXTREMA_PLANES
    planes; the blocks fill the card's slots several times over, and the
    ring and the queues leave L1 a third of each SM's 256 KB."""
    plan = G.extrema_plan(2, 528, 528, 144, 132)
    assert plan.vec and plan.tz == 144 and plan.ty == G.EXTREMA_MAX_TY
    assert G.EXTREMA_MIN_PLANES <= plan.xc <= G.EXTREMA_PLANES
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    assert blocks >= G.EXTREMA_BLOCKS_PER_SM * 132
    smem = 4 * RING * (plan.ty + 2) * (plan.tz + 8) + G.EXTREMA_QUEUES
    assert smem <= G.EXTREMA_SMEM
    assert G.EXTREMA_BLOCKS_PER_SM * G.EXTREMA_SMEM <= 240 * 1024
    with pytest.raises(ValueError):
        G.extrema_plan(0, 4, 4, 4)


def _extrema_emulated(plan, b1, b2, scale, thr, origins, find_max, find_min,
                      halo):
    """The kernel's walk: every block's ring (which voxel each slot holds
    and its dog), the planes it computes and stores, the voxels its
    threads test (the tile's own items each loaded) and the windows they
    read. Returns dog, mask, the stores and tests a voxel."""
    B, X, Y, Z = b1.shape
    V = 4 if plan.vec else 1
    ty, tz, xc = plan.ty, plan.tz, plan.xc
    ntz = _cdiv(Z, tz)
    SP = _cdiv(tz, 4) * 4 + 8
    SS = (ty + 2) * SP
    dog = np.full(b1.shape, np.nan, np.float32)
    mask = np.zeros(b1.shape, bool)
    stores = np.zeros(b1.shape, np.int64)
    tests = np.zeros(b1.shape, np.int64)
    flat_of = np.arange(X * Y * Z).reshape(X, Y, Z)
    for b in range(B):
        sc = np.float32(scale[b])
        th = np.float32(thr[b])
        ox, oy, oz = (int(v) for v in origins[b])
        for bx in range(plan.grid[0]):
            tyi = bx // ntz
            y0, z0 = tyi * ty, (bx - tyi * ntz) * tz
            ny, nz = min(ty, Y - y0), min(tz, Z - z0)
            nzv = nz // V
            # the loaded items: rows y0 - 1 .. y0 + ny, whole V-wide items,
            # then the two z-halo voxels of each row
            r, c = np.divmod(np.arange((ny + 2) * nzv), nzv)
            y = y0 - 1 + r
            ok = (y >= 0) & (y < Y)
            ys = np.repeat(y[ok], V)
            zs = (z0 + c[ok, None] * V + np.arange(V)).reshape(-1)
            so = (r[ok, None] * SP + 4 + c[ok, None] * V
                  + np.arange(V)).reshape(-1)
            own = np.repeat((r[ok] >= 1) & (r[ok] <= ny), V)
            hr = np.arange(2 * (ny + 2)) >> 1
            hz = np.where(np.arange(2 * (ny + 2)) & 1, z0 + nz, z0 - 1)
            hy = y0 - 1 + hr
            hok = (hy >= 0) & (hy < Y) & (hz >= 0) & (hz < Z)
            hso = hr[hok] * SP + 4 + (hz[hok] - z0)
            hy_, hz_ = hy[hok], hz[hok]
            for by in range(plan.grid[1]):
                xs, xe = by * xc, min(X, by * xc + xc)
                # which voxel each ring slot holds, and its dog
                held = np.full((RING, SS), -1, np.int64)
                val = np.zeros((RING, SS), np.float32)
                for x in range(max(0, xs - 1), xe + 1):
                    if x <= min(X - 1, xe):
                        s = x % RING
                        d = (b1[b, x, ys, zs] - b2[b, x, ys, zs]) * sc
                        held[s, so] = flat_of[x, ys, zs]
                        val[s, so] = d
                        if xs <= x < xe:
                            dog[b, x, ys[own], zs[own]] = d[own]
                            np.add.at(stores, (b, x, ys[own], zs[own]), 1)
                        held[s, hso] = flat_of[x, hy_, hz_]
                        val[s, hso] = (b1[b, x, hy_, hz_]
                                       - b2[b, x, hy_, hz_]) * sc
                    i = x - 1
                    if i < xs:
                        continue
                    # the items a thread tests: those of the tile it loaded
                    j, k = ys[own], zs[own]
                    np.add.at(tests, (b, i, j, k), 1)
                    cso = so[own]
                    assert np.array_equal(cso, (j - y0 + 1) * SP + 4
                                          + (k - z0))
                    # a queued voxel's coordinates from its ring offset (a
                    # warp's queue holds them in 16 bits)
                    assert (cso < 65536).all()
                    rr = cso // SP
                    assert np.array_equal(y0 - 1 + rr, j)
                    assert np.array_equal(z0 - 4 + cso - rr * SP, k)
                    v = val[i % RING, cso]
                    tb = lambda xi, yi, zi: (
                        (((ox + xi) * 73856093 + (oy + yi) * 19349663
                          + (oz + zi) * 83492791) & 1023).astype(np.float32)
                        * np.float32(2.0 ** -30))
                    d_max = v + tb(i, j, k)
                    d_min = v - tb(i, j, k)
                    above = np.zeros(len(j), bool)
                    below = np.zeros(len(j), bool)
                    reads = np.zeros(len(j), np.int64)
                    for dx in (-1, 0, 1):
                        xi = i + dx
                        if not 0 <= xi < X:
                            continue
                        for dy in (-1, 0, 1):
                            for dz in (-1, 0, 1):
                                yi, zi = j + dy, k + dz
                                inb = (yi >= 0) & (yi < Y) & (zi >= 0) & (
                                    zi < Z)
                                pos = cso[inb] + dy * SP + dz
                                assert np.array_equal(
                                    held[xi % RING, pos],
                                    flat_of[xi, yi[inb], zi[inb]])
                                reads[inb] += 1
                                w = val[xi % RING, pos]
                                t = tb(xi, yi[inb], zi[inb])
                                above[inb] |= w + t > d_max[inb]
                                below[inb] |= w - t < d_min[inb]
                    want = np.ones(len(j), np.int64)
                    for a_, n in ((i, X), (j, Y), (k, Z)):
                        a_ = np.asarray(a_)
                        want = want * ((a_ >= 1).astype(int) + 1
                                       + (a_ + 1 < n).astype(int))
                    assert np.array_equal(reads, want)
                    m = np.zeros(len(j), bool)
                    if find_max:
                        m |= (v > th) & ~above
                    if find_min:
                        m |= (v < -th) & ~below
                    core = ((halo <= i < X - halo) & (j >= halo)
                            & (j < Y - halo) & (k >= halo) & (k < Z - halo))
                    mask[b, i, j, k] = m & core
    return dog, mask, stores, tests


def _extrema_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    B = shape[0]
    b1 = rng.normal(0.0, 1.0, shape).astype(np.float32)
    b2 = (b1 * np.float32(0.6)
          + rng.normal(0.0, 0.3, shape).astype(np.float32))
    # ties between neighbours, so that the hash decides some of them
    b1[..., ::3] = np.round(b1[..., ::3], 1)
    b2[..., ::3] = 0.0
    scale = rng.uniform(0.5, 2.0, B).astype(np.float32)
    thr = rng.uniform(0.05, 0.3, B).astype(np.float32)
    origins = rng.integers(-600, 600, (B, 3)).astype(np.int32)
    return b1, b2, scale, thr, origins


WALK_SHAPES = [(3, 5, 40, 28), (1, 1, 40, 44), (2, 2, 41, 43),
               (1, 20, 41, 42), (1, 3, 33, 300), (1, 4, 45, 130),
               (2, 1, 3, 5)]


@pytest.mark.parametrize("shape", WALK_SHAPES, ids=str)
@pytest.mark.parametrize("find_max,find_min,halo",
                         [(True, False, 0), (False, True, 0),
                          (True, True, 1), (False, True, 2)])
def test_extrema_walk_matches_the_twin(shape, find_max, find_min, halo):
    """Every dog voxel stored once and tested once, each test reading
    exactly the in-block window from the ring (tile and block edges, x
    chunks, the z halo), and the twin's dog and mask."""
    b1, b2, scale, thr, origins = _extrema_inputs(shape, sum(shape))
    plan = G.extrema_plan(*shape, sms=4)
    dog, mask, stores, tests = _extrema_emulated(
        plan, b1, b2, scale, thr, origins, find_max, find_min, halo)
    assert (stores == 1).all() and (tests == 1).all()
    t = torch.from_numpy
    pdog, pmask = G.extrema_plain(t(b1), t(b2), t(scale), t(thr),
                                  t(origins), find_max, find_min, halo)
    assert np.array_equal(dog.view(np.int32), pdog.numpy().view(np.int32))
    assert np.array_equal(mask, pmask.numpy())


def test_extrema_walk_splits_tiles_and_chunks():
    """The walk shapes above do cross tile and chunk edges: y and z tiles,
    x chunks, a scalar path."""
    plans = [G.extrema_plan(*s, sms=4) for s in WALK_SHAPES]
    assert any(_cdiv(s[2], p.ty) > 1 for s, p in zip(WALK_SHAPES, plans))
    assert any(_cdiv(s[3], p.tz) > 1 and p.vec
               for s, p in zip(WALK_SHAPES, plans))
    assert any(_cdiv(s[3], p.tz) > 1 and not p.vec
               for s, p in zip(WALK_SHAPES, plans))
    assert any(p.grid[1] > 1 for p in plans)


def _warp_queue(bits):
    """A warp's queue (csrc/dog.cu): each lane's count of voxels past the
    threshold (bit 4 k + u: voxel u of own item k), their inclusive prefix
    sum by shuffle-ups, each lane's voxels from its exclusive prefix on;
    the queue's length is lane 31's sum."""
    n = np.array([bin(int(f)).count("1") for f in bits])
    incl = n.copy()
    for off in (1, 2, 4, 8, 16):
        up = np.concatenate([np.zeros(off, int), incl[:-off]])
        incl = incl + np.where(np.arange(32) >= off, up, 0)
    slots = []
    for lane, f in enumerate(bits):
        pos = incl[lane] - n[lane]
        for k in range(G.EXTREMA_ITEMS):
            for u in range(4):
                if (int(f) >> (4 * k + u)) & 1:
                    slots.append(((lane, k, u), pos))
                    pos += 1
    return slots, int(incl[31])


@pytest.mark.parametrize("share", [0.0, 0.01, 0.3, 1.0])
def test_warp_queue_takes_each_voxel_once(share):
    """Every voxel past the threshold gets one slot of the warp's queue, the
    slots run 0 .. length - 1, and the queue never outgrows its 512."""
    rng = np.random.default_rng(7)
    for _ in range(50):
        bits = [int(sum(1 << b for b in range(4 * G.EXTREMA_ITEMS)
                        if rng.random() < share)) for _ in range(32)]
        slots, nq = _warp_queue(bits)
        assert sorted(p for _, p in slots) == list(range(nq))
        assert len({who for who, _ in slots}) == nq
        assert nq <= 32 * G.EXTREMA_ITEMS * 4 == G.EXTREMA_QUEUES // 16
