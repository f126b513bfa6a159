"""K20's and K15's launch plans (``ops/descriptors.py`` ``ratio_plan``,
``ops/dog.py`` ``blur_plan``) and K20's filter threshold, held on the CPU
against numpy emulations of what the kernels do with them.

K20 (``csrc/descriptors.cu``) cuts A into blocks of 256 rows and B into
tiles of 128 columns, the tiles into splits; lane t of a quad scans the
columns 8m + 2t, 8m + 2t + 1 of its rows in order, skipping a pair whose
TF32 filter value is above its threshold and refining the rest exactly;
the quad shares its thresholds after each tile; the lanes' states, then
the splits', are merged by the exact rule. The emulation below does the
same with the filter values of TF32-rounded operands, and must give the
twin's answer (and the sequential scan's) on adversarial inputs. The
margin test shows, on inputs whose best pairs sit inside the TF32 error,
that no pair the threshold could skip has a distance at or below the
row's final one, and that without the margin (kappa 0, no bump) some
would.

K15 (``csrc/dog.cu``) walks runs of 16 outputs along x or y from a window
of 16 + 2r mirrored inputs, and stages chunks of z rows with a mirrored
2r halo; the emulation reads exactly those windows and must cover every
output once and equal the twin bit for bit, on axes of length 1, 2 and
below r.
"""

import numpy as np
import pytest
import torch

from bigstitcher_spark_tpu_torch.ops import descriptors as DS
from bigstitcher_spark_tpu_torch.ops import dog as G

torch.set_num_threads(1)

F32 = np.float32
EMPTY = (np.inf, np.iinfo(np.int32).max, -1, np.inf)
# K20's filter margin kappa and the bump on the threshold's running
# distance, as csrc/descriptors.cu states and uses them
RATIO_KAPPA = 2.0 ** -7
RATIO_BUMP = 1.0 + 2.0 ** -20


# ----------------------------------------------------------------- K20

def ratio_skip_threshold(T, a2):
    """K20's filter threshold in float32, rounded as the kernel rounds it:
    fl(fl(T (1 + 2^-20)) - fl(a2 (1 - kappa))). A pair whose filter value
    is above it is skipped; T is the running d2nd (d1 in nearest mode)."""
    T = np.asarray(T, F32)
    a2 = np.asarray(a2, F32)
    return (T * F32(RATIO_BUMP)) - a2 * F32(1.0 - RATIO_KAPPA)


def ratio_mma_depth(D):
    """K20's MMA depth: D + 1 in k8 steps, the last a k4 step where 4
    suffice (the kernel's NK8 and HALF)."""
    r8 = (D + 1) % 8
    return D + 1 if r8 == 0 else D + 1 - r8 + (4 if r8 <= 4 else 8)


def _tf32(x):
    """Round float32 values to TF32 as the kernel does (to nearest, ties
    away from zero: add half an ulp of 10 fraction bits, clear 13 bits)."""
    u = np.ascontiguousarray(x, F32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def _prologue(a, b):
    """Centred A and B, a2 and b2, as the twin computes them (float32,
    sums of squares in dimension order)."""
    c = DS._center_plain(torch.from_numpy(b)).numpy()
    ac, bc = (a - c).astype(F32), (b - c).astype(F32)

    def sq(x):
        s = x[:, 0] * x[:, 0]
        for k in range(1, x.shape[1]):
            s = s + x[:, k] * x[:, k]
        return s

    return ac, bc, sq(ac), sq(bc)


def _twin_d(ac, bc, a2, b2):
    """Every pair's distance as the twin rounds it."""
    dot = ac[:, None, 0] * bc[None, :, 0]
    for k in range(1, ac.shape[1]):
        dot = dot + ac[:, None, k] * bc[None, :, k]
    return np.maximum((a2[:, None] + b2[None, :]) - F32(2.0) * dot, F32(0.0))


def _filter_values(ac, bc, b2, slack, kappa=RATIO_KAPPA):
    """The filter values q ~ (1 - kappa) b2 - 2 a.b of the TF32 operands
    A' = (tf32(a), 1), B' = (tf32(-2 b), tf32((1 - kappa) b2)): their
    products summed exactly (float64), plus ``slack`` times the float32
    accumulation bound of the note (2^-17 of the terms' magnitudes)."""
    A = np.concatenate([_tf32(ac), np.ones((len(ac), 1), F32)], 1)
    B = np.concatenate([_tf32(F32(-2.0) * bc),
                        _tf32(F32(1.0 - kappa) * b2)[:, None]], 1)
    A, B = A.astype(np.float64), B.astype(np.float64)
    return A @ B.T + slack * 2.0 ** -17 * (np.abs(A) @ np.abs(B).T)


def _update(s, d, j, ow):
    """The sequential scan rule of the twin and the kernel."""
    d1, c1, o1, d2 = s
    if d < d1:
        if ow != o1:
            d2 = d1
        return (d, j, ow, d2)
    if ow != o1 and d < d2:
        d2 = d
    return (d1, c1, o1, d2)


def _merge(p, q):
    """The kernel's merge rule: the smaller d1 (then column) wins; equal
    owners keep the smaller d2nd, others min(winner's d2nd, loser's d1)."""
    pw = p[0] < q[0] or (p[0] == q[0] and p[1] <= q[1])
    w, l = (p, q) if pw else (q, p)
    d2 = min(w[3], l[3]) if w[2] == l[2] else min(w[3], l[0])
    return (w[0], w[1], w[2], d2)


def _emulate(a, b, owner, ratio, sms):
    """K20's plan, filter, refine and merges in numpy; returns (best,
    bestd, accept or None, pairs refined)."""
    Da, D = a.shape
    Db = len(b)
    plan = DS.ratio_plan(Da, Db, D, sms)
    ac, bc, a2, b2 = _prologue(a, b)
    d = _twin_d(ac, bc, a2, b2)
    q = _filter_values(ac, bc, b2, 0.0).astype(F32)
    near = owner is None
    own = np.arange(Db) if near else owner
    tile = DS.RATIO_TILE
    best, bestd, acc, refined = [], [], [], 0
    for i in range(Da):
        row = EMPTY
        for s in range(plan.splits):
            t0 = s * plan.tiles_per_split
            t1 = min(t0 + plan.tiles_per_split, plan.tiles)
            st = [EMPTY] * 4
            thr = [F32(np.inf)] * 4
            for tl in range(t0, t1):
                for j in range(tl * tile, min((tl + 1) * tile, Db)):
                    lane = (j % 8) // 2
                    if q[i, j] > thr[lane]:
                        continue
                    refined += 1
                    st[lane] = _update(st[lane], d[i, j], j, own[j])
                    T = st[lane][0] if near else st[lane][3]
                    thr[lane] = min(thr[lane],
                                    ratio_skip_threshold(T, a2[i]))
                thr = [min(thr)] * 4  # the quad shares after each tile
            part = st[0]
            for lane in range(1, 4):
                part = _merge(part, st[lane])
            row = _merge(row, part)
        best.append(row[1] if near else row[2])
        bestd.append(row[0])
        acc.append(np.sqrt(F32(row[3])) >= F32(ratio) * np.sqrt(F32(row[0])))
    return (np.array(best, np.int32), np.array(bestd, F32),
            None if near else np.array(acc), refined)


def _sequential(d, owner):
    """The one-thread-a-row scan over every column in order."""
    out = []
    for i in range(d.shape[0]):
        s = EMPTY
        for j in range(d.shape[1]):
            s = _update(s, d[i, j], j, j if owner is None else owner[j])
        out.append(s)
    return out


def _case(name, rng):
    """Adversarial inputs: (a, b, owner (or None), ratio)."""
    if name == "ties across owners":
        base = rng.integers(-4, 5, (40, 9)).astype(F32)
        b = np.concatenate([base, base, base[::-1]])
        owner = np.arange(len(b), dtype=np.int32)
        a = np.concatenate([base[:12], base[:6] + 1.0])
        return a, b, owner, 1.0
    if name == "same-owner runs":
        pts = rng.normal(0, 3, (75, 9)).astype(F32)
        b = np.repeat(pts, 4, 0) + rng.normal(0, 0.01, (300, 9)).astype(F32)
        owner = np.repeat(np.arange(75, dtype=np.int32), 4)
        a = (b[::13] + rng.normal(0, 0.02, (24, 9))).astype(F32)
        return a, b, owner, 3.0
    if name == "one owner":
        b = rng.normal(0, 1, (200, 6)).astype(F32)
        return (b[:17] + 0.1).astype(F32), b, np.zeros(200, np.int32), 3.0
    if name == "Db not a multiple of the tile":
        b = rng.normal(0, 1, (300, 9)).astype(F32)
        owner = (np.arange(300) // 3).astype(np.int32)
        return (b[5:30] + 0.05).astype(F32), b, owner, 1.5
    if name == "Da below one tile":
        b = rng.normal(0, 2, (129, 12)).astype(F32)
        owner = (np.arange(129) % 40).astype(np.int32)
        return b[:5].copy(), b, owner, 2.0
    if name == "nearest mode":
        base = rng.integers(-3, 4, (150, 3)).astype(F32)
        b = np.concatenate([base, base])  # every distance tied twice
        return base[:30].copy(), b, None, 1.0
    raise ValueError(name)


CASES = ["ties across owners", "same-owner runs", "one owner",
         "Db not a multiple of the tile", "Da below one tile", "nearest mode"]


@pytest.mark.parametrize("sms", [1, 132], ids=["one split", "splits"])
@pytest.mark.parametrize("case", CASES)
def test_ratio_emulation_equals_twin_and_scan(case, sms):
    """Partitioned states merged by the rule give the twin's answer and
    the sequential scan's, bit for bit, with the filter skipping."""
    rng = np.random.default_rng(CASES.index(case))
    a, b, owner, ratio = _case(case, rng)
    best, bestd, acc, refined = _emulate(a, b, owner, ratio, sms)
    tw = DS.ratio_match_plain(torch.from_numpy(a), torch.from_numpy(b),
                              None if owner is None
                              else torch.from_numpy(owner), ratio)
    assert np.array_equal(best, tw[0].numpy())
    assert np.array_equal(bestd, tw[1].numpy())
    if owner is not None:
        assert np.array_equal(acc, tw[2].numpy())
    ac, bc, a2, b2 = _prologue(a, b)
    seq = _sequential(_twin_d(ac, bc, a2, b2), owner)
    assert [s[0] for s in seq] == bestd.tolist()
    assert [s[1] if owner is None else s[2] for s in seq] == best.tolist()
    assert 0 < refined <= a.size // a.shape[1] * len(b)
    if sms > 1 and len(b) > DS.RATIO_TILE:
        assert DS.ratio_plan(len(a), len(b), a.shape[1], sms).splits > 1


def test_ratio_filter_skips_at_most_pairs_beyond_the_row():
    """Rows whose best pairs lie inside the TF32 error (two far clusters,
    small distances against large centred norms): no pair the threshold of
    the row's final state could skip, even with the accumulation at its
    worst, is at or below the final d2nd (ratio mode) or d1 (nearest);
    with kappa 0 and no bump some would be."""
    rng = np.random.default_rng(5)
    centre = rng.normal(0, 1, 9) * 60.0
    b = np.concatenate([centre + rng.normal(0, 0.3, (400, 9)),
                        -centre + rng.normal(0, 0.3, (400, 9))]).astype(F32)
    owner = (np.arange(800) // 2).astype(np.int32)
    a = (b[rng.choice(800, 64, replace=False)]
         + rng.normal(0, 0.05, (64, 9))).astype(F32)
    ac, bc, a2, b2 = _prologue(a, b)
    d = _twin_d(ac, bc, a2, b2)
    q_hi = _filter_values(ac, bc, b2, 1.0)
    unsafe = 0
    for own in (owner, None):
        T = np.array([s[0] if own is None else s[3]
                      for s in _sequential(d, own)], F32)
        t = ratio_skip_threshold(T, a2).astype(np.float64)
        at_risk = d <= T[:, None]
        assert at_risk.sum() >= len(a)
        assert not np.any((q_hi > t[:, None]) & at_risk)
        # the same test without the margin (q against T - a2, q's error
        # not covered) would skip some of them
        q = _filter_values(ac, bc, b2, 0.0, kappa=0.0)
        t0 = (T - a2).astype(np.float64)
        unsafe += int(np.sum((q > t0[:, None]) & at_risk))
    assert unsafe > 0


@pytest.mark.parametrize("Da,Db,sms", [
    (1, 1, 132), (5, 129, 132), (256, 128, 132), (257, 300, 132),
    (8192, 400_000, 132), (400_000, 400_000, 132), (3000, 4000, 2),
    (1334, 4000, 132)])
@pytest.mark.parametrize("D", [3, 9, 15, 18, 24])
def test_ratio_plan_covers_every_row_and_tile_once(Da, Db, sms, D):
    p = DS.ratio_plan(Da, Db, D, sms)
    rows, tile = DS.RATIO_ROWS, DS.RATIO_TILE
    assert (p.row_blocks - 1) * rows < Da <= p.row_blocks * rows
    assert (p.tiles - 1) * tile < Db <= p.tiles * tile
    assert (p.splits - 1) * p.tiles_per_split < p.tiles
    assert p.tiles <= p.splits * p.tiles_per_split
    assert p.splits == 1 or p.row_blocks * (p.splits - 1) < 2 * sms
    assert p.kp >= D + 1 and p.kp % 16 == 0
    assert p.wa >= D + 1 and p.wb >= D + 2 and p.wa % 4 == p.wb % 4 == 0
    assert 1 <= p.center_parts <= 2 * sms


@pytest.mark.parametrize("D,k", [(3, 4), (6, 8), (9, 12), (12, 16),
                                 (15, 16), (18, 20), (21, 24), (24, 28)])
def test_ratio_mma_depth(D, k):
    """D + 1 in k8 steps, the last a k4 step where 4 suffice; within the
    stored depth of B'."""
    assert ratio_mma_depth(D) == k
    assert D + 1 <= k <= DS.ratio_plan(1, 1, D).kp


def test_ratio_skip_threshold_rounds_down_safely():
    """t >= T - a2 (1 - kappa / 2) after its roundings, for T and a2 over
    many magnitudes (the note's bound on the threshold)."""
    rng = np.random.default_rng(9)
    T = (10.0 ** rng.uniform(-6, 6, 20000)).astype(F32)
    a2 = (10.0 ** rng.uniform(-6, 6, 20000)).astype(F32)
    t = ratio_skip_threshold(T, a2).astype(np.float64)
    lo = T.astype(np.float64) - a2.astype(np.float64) * (
        1.0 - RATIO_KAPPA / 2)
    assert np.all(t >= lo)
    assert np.all(ratio_skip_threshold(np.inf, a2) == np.inf)


# ----------------------------------------------------------------- K15

def _reflect(i, n):
    if n == 1:
        return 0
    while i < 0 or i >= n:
        if i < 0:
            i = -i
        if i >= n:
            i = 2 * n - 2 - i
    return i


def _slide(v, taps):
    """The run form at a radius taken at run time: the window v (...,
    RUN + 2r) slides through two blocks of RUN values (cur, nxt) while the
    taps are read in order; returns the RUN outputs."""
    L, r = G.BLUR_RUN, taps.size // 2
    W = L + 2 * r
    load = lambda u: v[..., u] if u < W else np.zeros(v.shape[:-1], F32)
    cur = [load(o) for o in range(L)]
    acc = [F32(taps[0]) * cur[o] for o in range(L)]
    for u0 in range(0, 2 * r, L):
        nxt = [load(u0 + L + o) for o in range(L)]
        for qq in range(1, L + 1):
            if u0 + qq <= 2 * r:
                w = F32(taps[u0 + qq])
                for o in range(L):
                    val = cur[o + qq] if o + qq < L else nxt[o + qq - L]
                    acc[o] = acc[o] + w * val
        cur = nxt
    return acc


def _emulate_blur(x, taps, axis):
    """K15's pass as its plan runs it: the run form's windows of RUN + 2r
    mirrored inputs or the row form's chunks with a mirrored 2r halo;
    returns the output and how often each was written."""
    B, X, Y, Z = x.shape
    r = taps.size // 2
    plan = G.blur_plan(B, X, Y, Z, axis, r)
    n = x.shape[1 + axis]
    out = np.zeros(x.shape, F32)
    hits = np.zeros(x.shape, np.int32)
    xa = np.moveaxis(x, 1 + axis, -1)  # the pass axis last
    oa = np.moveaxis(out, 1 + axis, -1)
    ha = np.moveaxis(hits, 1 + axis, -1)

    def run(c0, m, width):
        idx = [_reflect(c0 - r + q, n) for q in range(width)]
        v = xa[..., idx]
        if plan.route == "run" and r not in (6, 7):
            acc = _slide(v, taps)
            for o in range(m):
                oa[..., c0 + o] = acc[o]
                ha[..., c0 + o] += 1
            return
        for o in range(m):
            acc = F32(taps[0]) * v[..., o]
            for q in range(1, taps.size):
                acc = acc + F32(taps[q]) * v[..., o + q]
            oa[..., c0 + o] = acc
            ha[..., c0 + o] += 1

    if plan.route == "run":
        gx, gy, gz = plan.grid
        lines = (Y * Z, X * Z, X * Y)[axis]
        assert gz == B and (gx - 1) * G.BLUR_RUN_THREADS < lines
        assert lines <= gx * G.BLUR_RUN_THREADS
        for ry in range(gy):
            c0 = ry * G.BLUR_RUN
            run(c0, min(G.BLUR_RUN, n - c0), G.BLUR_RUN + 2 * r)
    else:
        assert plan.route == "row" and axis == 2
        items = B * X * Y * -(-Z // plan.chunk)
        assert (plan.grid[0] - 1) * G.BLUR_ROW_WARPS < items
        assert items <= plan.grid[0] * G.BLUR_ROW_WARPS
        assert plan.chunk <= G.BLUR_CHUNK
        for z0 in range(0, Z, plan.chunk):
            m = min(plan.chunk, Z - z0)
            run(z0, m, m + 2 * r)
    return out, hits, plan.route


@pytest.mark.parametrize("shape", [
    (2, 1, 2, 3), (1, 2, 1, 1), (1, 5, 4, 6), (2, 37, 29, 5),
    (1, 17, 19, 600), (1, 33, 3, 2)], ids=str)
@pytest.mark.parametrize("sigma", [1.8, 1.8 * G.DOG_K, 0.9, 5.5])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_blur_plan_windows_equal_the_twin(shape, sigma, axis):
    """Every output written once, from windows mirrored as the twin's pad,
    bitwise the twin's: also on axes of length 1, 2 and below r, z rows
    longer than one chunk, and radii taken at run time (sigma 0.9 and
    5.5: the run form's sliding window over one and three blocks)."""
    rng = np.random.default_rng(sum(shape) + axis)
    x = rng.normal(100.0, 20.0, shape).astype(F32)
    taps = G.gaussian_kernel_1d(sigma)
    out, hits, route = _emulate_blur(x, taps, axis)
    assert np.all(hits == 1)
    ref = G.blur_plain(torch.from_numpy(x), taps, axis).numpy()
    assert np.array_equal(out, ref)
    assert route == ("row" if axis == 2 else "run")


@pytest.mark.parametrize("shape", [(1, 3, 2, 7), (2, 2, 3, 40)], ids=str)
def test_blur_plan_long_radius_on_z(shape):
    """A radius past the row form's chunk (sigma 161: r = 483) runs z in
    the run form: every output once, bitwise the twin's, the mirror
    repeating many times over the short axis."""
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(100.0, 20.0, shape).astype(F32)
    taps = G.gaussian_kernel_1d(161.0)
    assert taps.size // 2 > G.BLUR_CHUNK
    out, hits, route = _emulate_blur(x, taps, 2)
    assert route == "run" and np.all(hits == 1)
    ref = G.blur_plain(torch.from_numpy(x), taps, 2).numpy()
    assert np.array_equal(out, ref)


def test_blur_plan_at_8a_bucket():
    """8a's bucket (2 x 528 x 528 x 144): x and y in runs of 16 over
    128-line blocks, z in one 144-output chunk a row."""
    for r in (6, 7):
        assert G.blur_plan(2, 528, 528, 144, 0, r) == G.BlurPlan(
            "run", (-(-528 * 144 // 128), 33, 2), 0)
        assert G.blur_plan(2, 528, 528, 144, 1, r) == G.BlurPlan(
            "run", (-(-528 * 144 // 128), 33, 2), 0)
        assert G.blur_plan(2, 528, 528, 144, 2, r) == G.BlurPlan(
            "row", (2 * 528 * 528 // 8, 1, 1), 144)
