"""K10's and K17's launch plans on the CPU, and numpy models of the two
kernels' walks held against the plain twins.

``ops.phasecorr.peaks_plan`` (K10: a list of N = 32 J keys a warp, units
of 4 y rows x 32 z lanes marched along chunks of x, P blocks a pair) and
``ops.dog.topk_plan`` (K17: a block for every 256 rows of the answer) are
checked against the limits ``csrc/pcm.cu`` and ``csrc/dog.cu`` refuse.
The models follow the kernels step by step: K10's units, periodic rows
and lanes and the 3x3 plane maxima of its march, each warp's list behind
its own and the pair's threshold with the inserts and bitonic merges in
the registers' layout (entry 32 j + lane), the warps' planes in any
order, the last block's pass through the final threshold; K17's radix
select (8-bit digits from the top, stopping where a bucket is taken whole),
the compaction in list order with a quota of keys equal to the k-th, and
the ranks. The CUDA code itself runs only on the card
(``tests/test_torch_kernels.py``, marker ``cuda``).
"""

import numpy as np
import pytest
import torch

from bigstitcher_spark_tpu_torch.ops import dog as G
from bigstitcher_spark_tpu_torch.ops import phasecorr as P

ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def keys(values, idx):
    """csrc topk_key: (value descending, index ascending) as uint64."""
    v = np.where(values == 0, np.float32(0), values).astype(np.float32)
    u = v.view(np.uint32).astype(np.uint64)
    ord_ = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return ((~ord_ & 0xFFFFFFFF) << np.uint64(32)) | idx.astype(np.uint64)


# ---------------------------------------------------------------- K10


def launcher_accepts(B, X, Y, Z, n, plan):
    """bst_pcm_peaks_topk's checks of a plan."""
    J, xc, (Pb, Bg) = plan
    units = -(-Y // P.PEAKS_ROWS) * -(-Z // 32) * -(-X // xc)
    return (Bg == B and J in (1, 2, 4, 8) and 1 <= n <= 32 * J
            and n <= X * Y * Z and 1 <= xc <= X
            and 1 <= Pb <= min(65535, -(-units // 8)))


SHAPES = [(2, 64, 512, 128), (2, 128, 1024, 256), (5, 32, 32, 32),
          (1, 1, 1, 1), (3, 1, 48, 1), (2, 2, 33, 2), (1, 8, 8, 1000),
          (1, 4096, 1, 1), (9, 16, 2, 300), (1, 1, 5000, 3)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("n", [1, 5, 32, 33, 100, 256])
def test_peaks_plan_within_launcher_limits(shape, n):
    if n > int(np.prod(shape[1:])):
        with pytest.raises(ValueError, match="n_peaks"):
            P.peaks_plan(*shape, n)
        return
    plan = P.peaks_plan(*shape, n)
    assert launcher_accepts(*shape, n, plan)
    assert 32 * plan.J >= n and (plan.J == 1 or 16 * plan.J < n)
    Pb, B = plan.grid
    assert Pb * B <= max(P.PEAKS_BLOCKS_PER_SM * 132, B)


def march(shape, xc, sms=132):
    """The longest march of a plan's warps, in planes."""
    B, X, Y, Z = shape
    units = -(-Y // P.PEAKS_ROWS) * -(-Z // 32) * -(-X // xc)
    warps = max(8, P.PEAKS_BLOCKS_PER_SM * sms * 8 // B)
    return -(-units // warps) * (xc + 2)


@pytest.mark.parametrize("shape", [
    (2, 64, 512, 128), (2, 64, 64, 128), (1, 512, 64, 128),
    (1, 512, 64, 256), (2, 128, 128, 128), (2, 128, 1024, 128),
    (1, 1024, 128, 128), (1, 1024, 128, 256), (2, 128, 1024, 256)], ids=str)
def test_peaks_plan_fills_the_card_at_once(shape):
    """Phase 1's and phase 6's buckets: every block resident at once (2 an
    SM on 132), no chunk of x whose units' longest march is shorter."""
    plan = P.peaks_plan(*shape, 5)
    Pb, B = plan.grid
    assert Pb * B <= P.PEAKS_BLOCKS_PER_SM * 132
    X = shape[1]
    assert march(shape, plan.xc) == min(march(shape, -(-X // c))
                                        for c in range(1, X + 1))


def test_peaks_plan_at_phase_1():
    """2 x 64 x 512 x 128, n = 5: 512 units of 4 x 32 voxels a plane, 2
    chunks of 32 planes (1,024 units, one a warp), 128 blocks a pair on
    the card's 132 x 2."""
    assert P.peaks_plan(2, 64, 512, 128, 5) == P.PeaksPlan(1, 32, (128, 2))
    assert P.peaks_plan(2, 64, 512, 128, 256).J == 8


@pytest.mark.parametrize("bad,match", [
    ((0, 4, 4, 4, 1), "non-empty"), ((1, 4, 0, 4, 1), "non-empty"),
    ((65536, 4, 4, 4, 1), "non-empty"), ((1, 4, 4, 4, 0), "n_peaks"),
    ((1, 8, 8, 8, 257), "n_peaks"), ((1, 2, 2, 2, 9), "n_peaks"),
    ((1, 2048, 1024, 1024, 5), "31-bit")])
def test_peaks_plan_refuses(bad, match):
    with pytest.raises(ValueError, match=match):
        P.peaks_plan(*bad)


def bitonic_merge(a):
    """csrc/pcm.cu bitonic_merge on a (J, 32) list: entry 32 j + lane."""
    a = a.copy()
    J = a.shape[0]
    d = J // 2
    while d:
        for j in range(J):
            if j & d == 0:
                lo, hi = np.minimum(a[j], a[j + d]), np.maximum(a[j], a[j + d])
                a[j], a[j + d] = lo, hi
        d //= 2
    lane = np.arange(32)
    for d in (16, 8, 4, 2, 1):
        o = a[:, lane ^ d]
        a = np.where(lane & d, np.maximum(a, o), np.minimum(a, o))
    return a


def warp_sort(c):
    """csrc/pcm.cu warp_sort of one key a lane."""
    lane = np.arange(32)
    k = 2
    while k <= 32:
        d = k // 2
        while d:
            o = c[lane ^ d]
            keep_min = ((lane & d) == 0) == ((lane & k) == 0)
            c = np.where(keep_min, np.minimum(c, o), np.maximum(c, o))
            d //= 2
        k *= 2
    return c


def insert_one(L, x):
    """csrc/pcm.cu insert_one: each entry keeps its key, or takes x or the
    entry before it (lane 0 the last lane's of the register before)."""
    J = L.shape[0]
    out = L.copy()
    carry = np.uint64(0)
    for j in range(J):
        prev = np.concatenate([[carry], L[j, :31]])
        first = np.arange(32) == 0 if j == 0 else np.zeros(32, bool)
        carry = L[j, 31]
        out[j] = np.where(L[j] < x, L[j], np.where(first | (prev < x), x, prev))
    return out


def merge_lists(L, other_reversed):
    """min(L[e], other[N - 1 - e]), then bitonic_merge."""
    return bitonic_merge(np.minimum(L, other_reversed))


def rev(L):
    """other[N - 1 - e] laid out as entry e = 32 j + lane."""
    return L.reshape(-1)[::-1].reshape(L.shape)


def add_candidates(L, c):
    """csrc/pcm.cu add_candidates: the warp's keys (one a lane) sorted,
    reversed into the last register and merged."""
    J = L.shape[0]
    return merge_lists(L, np.vstack([np.full((J - 1, 32), ONES),
                                     warp_sort(c)[::-1][None]]))


@pytest.mark.parametrize("J", [1, 2, 4, 8])
def test_bitonic_merges_keep_the_smallest(J):
    """The warp's candidate merge, the single insert and the list merges
    give the N smallest keys in order, whatever the lists hold."""
    rng = np.random.default_rng(J)
    N = 32 * J
    for _ in range(20):
        pool = rng.choice(2 ** 40, 3 * N + 1, replace=False).astype(np.uint64)
        A = np.sort(pool[:N]).reshape(J, 32)
        B = np.sort(pool[N:2 * N]).reshape(J, 32)
        assert np.array_equal(merge_lists(A, rev(B)).reshape(-1),
                              np.sort(pool[:2 * N])[:N])
        c = pool[2 * N:2 * N + 32].copy()
        c[rng.random(32) < 0.5] = ONES
        assert np.array_equal(add_candidates(A, c).reshape(-1),
                              np.sort(np.concatenate([A.reshape(-1), c]))[:N])
        x = pool[2 * N + 32]
        assert np.array_equal(insert_one(A, x).reshape(-1),
                              np.sort(np.append(A.reshape(-1), x))[:N])


def key_value(hi):
    """csrc/pcm.cu PeakList::refresh: the float whose keys have this upper
    word (the inverse of topk_key's value map)."""
    ord_ = ~np.uint32(hi)
    u = ord_ & np.uint32(0x7FFFFFFF) if ord_ & np.uint32(0x80000000) else ~ord_
    return np.array([u], np.uint32).view(np.float32)[0]


class WarpList:
    """csrc/pcm.cu PeakList: N keys behind min(own n-th key, gl), each key
    taken in also sent to the pair's slot of its flat index mod n; tv, the
    threshold's value, and ``all`` while it is no finite value's key."""

    def __init__(self, J, n):
        self.L = np.full((J, 32), ONES)
        self.own = self.gl = ONES
        self.n = n
        self.refresh()

    def refresh(self):
        hi = int(min(self.own, self.gl) >> np.uint64(32))
        self.all = hi >= 0xFF800000
        self.tv = key_value(hi)

    def lower(self, g):
        if g < self.gl:
            self.gl = g
            self.refresh()

    def consider(self, key, slots):
        cand = key < min(self.own, self.gl)
        if not cand.any():
            return
        if slots is not None:
            for k in key[cand]:
                at = int(k & np.uint64(0xFFFFFFFF)) % self.n
                slots[at] = min(slots[at], k)
        if cand.sum() > 2:
            self.L = add_candidates(self.L, np.where(cand, key, ONES))
        else:
            for lane in np.nonzero(cand)[0]:
                self.L = insert_one(self.L, key[lane])
        self.own = self.L.reshape(-1)[self.n - 1]
        self.refresh()


def unit_walk(V, u, xc, wl, slots, ahead=3):
    """One warp's march over unit u (4 y rows x 32 z lanes along xc
    planes), as csrc/pcm.cu PeakUnit takes it: plane p - 1 tested when
    plane p lands, the exact test only when a voxel of the unit's rows is
    at or above the threshold's value (or the threshold is no value's),
    the pair's threshold (the largest slot) read every ahead + 3 planes
    and used ``ahead`` planes later; yields after each plane the voxels it tested and
    whether it took the exact test."""
    X, Y, Z = V.shape
    R = P.PEAKS_ROWS
    nzs, nyg = -(-Z // 32), -(-Y // R)
    zs, rest = u % nzs, u // nzs
    y0, z0 = rest % nyg * R, 32 * zs
    x0 = rest // nyg * xc
    x1 = min(X, x0 + xc)
    lane = np.arange(32)
    rows = (y0 - 1 + np.arange(R + 2)) % Y
    zl = (z0 + lane) % Z
    ze = np.where(lane == 0, (z0 - 1) % Z, (z0 + 32) % Z)
    ok = (z0 + lane < Z)[None] & (y0 + np.arange(R) < Y)[:, None]
    ring = 3 + ahead
    g = ONES
    for p in range(x0 - 1, x1 + 1):
        seen, exact = [], False
        s = (p - x0 + 1) % ring
        if s == 0:
            g = max(slots)
        if s == ahead:
            wl.lower(g)
        if p > x0:
            q = p - 1
            mid = V[q % X][np.ix_(rows[1:R + 1], zl)]
            seen = [(q, y0 + i, z) for i in range(R)
                    for z in (z0 + lane)[ok[i]]]
            exact = bool((ok & (wl.all | (mid >= wl.tv))).any())
            if exact:
                m = np.full((R, 32), -np.inf, np.float32)
                for k in (q - 1, q, q + 1):
                    v = V[k % X][np.ix_(rows, zl)]
                    e = V[k % X][np.ix_(rows, ze)]
                    lo = np.concatenate([e[:, :1], v[:, :31]], 1)
                    hi = np.concatenate([v[:, 1:], e[:, 31:]], 1)
                    z3 = np.fmax(np.fmax(lo, v), hi)
                    m = np.fmax(m, np.fmax(np.fmax(z3[:R], z3[1:R + 1]),
                                           z3[2:]))
                for i in range(R):
                    flat = q * Y * Z + (y0 + i) * Z + z0 + lane
                    k = keys(np.where(mid[i] >= m[i], mid[i], -np.inf)
                             .astype(np.float32), np.where(ok[i], flat, 0))
                    wl.consider(np.where(ok[i], k, ONES), slots)
        yield seen, exact


def peaks_model(pcm, n, plan, rng=None):
    """K10's walk on a (B, X, Y, Z) float32 array: every warp of the grid
    marching its units (warp w of block q: units 8 q + w, then 8 P on)
    behind its list and the pair's threshold (n slots), the warps' planes
    interleaved in ``rng``'s order (None: warp after warp), then each
    block's merge and the last block's pass over the P n keys through the
    final threshold. Returns (B, n, 3) int32, how many times each voxel
    was tested and the share of planes that took the exact test."""
    Bn, X, Y, Z = pcm.shape
    J, xc, (Pb, _) = plan
    units = -(-Y // P.PEAKS_ROWS) * -(-Z // 32) * -(-X // xc)
    seen = np.zeros(pcm.shape, np.int64)
    out = np.zeros((Bn, n, 3), np.int32)
    planes = [0, 0]
    for b in range(Bn):
        slots = [ONES] * n
        lists = [WarpList(J, n) for _ in range(8 * Pb)]

        def warp_walk(g):
            for u in range(g, units, 8 * Pb):
                yield from unit_walk(pcm[b], u, xc, lists[g], slots)

        live = [warp_walk(g) for g in range(8 * Pb)]
        while live:
            at = 0 if rng is None else int(rng.integers(len(live)))
            try:
                tested, exact = next(live[at])
                for x, y, z in tested:
                    seen[b, x, y, z] += 1
                planes[0] += bool(tested)
                planes[1] += exact
            except StopIteration:
                live.pop(at)
        block_lists = []
        for q in range(Pb):
            warps = [lists[8 * q + w].L for w in range(8)]
            s = 1
            while s < 8:
                for w in range(0, 8, 2 * s):
                    warps[w] = merge_lists(warps[w], rev(warps[w + s]))
                s *= 2
            block_lists.append(warps[0].reshape(-1)[:n])
        flat = np.concatenate(block_lists)
        G = max(slots)
        fin = [WarpList(J, n) for _ in range(8)]
        for wl in fin:
            wl.gl = G if G == ONES else G + np.uint64(1)
        for w in range(8):
            for c in range(32 * w, len(flat), 1024):
                for i in range(4):
                    at = c + i * 256 + np.arange(32)
                    k = np.where(at < len(flat),
                                 flat[np.minimum(at, len(flat) - 1)], ONES)
                    fin[w].consider(k, None)
        warps = [wl.L for wl in fin]
        s = 1
        while s < 8:
            for w in range(0, 8, 2 * s):
                warps[w] = merge_lists(warps[w], rev(warps[w + s]))
            s *= 2
        idx = (warps[0].reshape(-1)[:n] & np.uint64(0xFFFFFFFF)).astype(
            np.int64)
        out[b] = np.stack([idx // (Y * Z), idx // Z % Y, idx % Z], -1)
    return out, seen, planes[1] / max(planes[0], 1)


@pytest.mark.parametrize("shape,n,plan", [
    ((2, 6, 20, 9), 5, None), ((1, 5, 7, 40), 40, None),
    ((2, 1, 3, 2), 4, None), ((3, 2, 1, 5), 10, None),
    ((1, 7, 9, 11), 9, P.PeaksPlan(1, 3, (1, 1))),
    ((2, 9, 10, 35), 64, P.PeaksPlan(2, 2, (2, 2)))], ids=str)
@pytest.mark.parametrize("kind", ["noise", "ties", "one_maximum"])
def test_peaks_model_matches_twin(shape, n, plan, kind):
    """The model of K10's walk tests every voxel once and gives the twin's
    peaks bitwise (lax.top_k's order, the -inf fill included) on the
    plan's units and on forced ones (partial units, several units a
    warp, z past one warp's 32 lanes), with the warps' planes in turn and
    interleaved at random (the pair's threshold read and lowered in any
    order)."""
    rng = np.random.default_rng(sum(shape) + n)
    if kind == "noise":
        pcm = rng.normal(size=shape).astype(np.float32)
    elif kind == "ties":
        pcm = rng.integers(0, 4, shape).astype(np.float32)
    else:
        g = np.meshgrid(*[np.cos(2 * np.pi * np.arange(s) / s)
                          for s in shape[1:]], indexing="ij")
        pcm = np.repeat(sum(g)[None], shape[0], 0).astype(np.float32)
    plan = plan or P.peaks_plan(*shape, n, sms=2)
    ref = P.pcm_peaks_topk_plain(torch.from_numpy(pcm), n).numpy()
    for order in (None, rng):
        got, seen, _ = peaks_model(pcm, n, plan, order)
        assert (seen == 1).all()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ["noise", "late_ties"])
def test_peaks_model_threshold_skips_planes(kind):
    """Once every one of the pair's n slots holds a finite value's key, a
    plane whose unit rows all lie below the largest one's value skips the
    exact test: on noise most planes do. A voxel at the threshold's value
    with a lower index still goes in: warp 0 (run first) fills the slots
    with spikes up to x = 24, then warp 1 meets a spike of the same value
    at x = 10."""
    rng = np.random.default_rng(7)
    shape = (1, 40, 8, 64)
    pcm = rng.random(shape).astype(np.float32)
    order = rng
    if kind == "late_ties":
        order = None
        for x in range(20, 25):
            pcm[0, x, 1, 5] = 5.0      # warp 0's unit: z 0..31
        pcm[0, 10, 2, 40] = 5.0        # warp 1's unit: z 32..63
    ref = P.pcm_peaks_topk_plain(torch.from_numpy(pcm), 5).numpy()
    got, seen, share = peaks_model(pcm, 5, P.PeaksPlan(1, 40, (1, 1)), order)
    assert (seen == 1).all() and share < 0.5
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------- K17


@pytest.mark.parametrize("B,k", [(1, 1), (2, 256), (2, 257), (2, 4096),
                                 (65535, 8192)])
def test_topk_plan(B, k):
    plan = G.topk_plan(B, k)
    assert plan.grid == (-(-k // G.TOPK_THREADS), B)
    assert plan.grid[0] * G.TOPK_THREADS >= k
    assert plan.smem == 8 * k <= 227 * 1024


@pytest.mark.parametrize("B,k", [(0, 16), (65536, 16), (1, 0),
                                 (1, G.MAX_TOPK + 1)])
def test_topk_plan_refuses(B, k):
    with pytest.raises(ValueError, match="K17"):
        G.topk_plan(B, k)


def topk_model(keys_, K):
    """K17's walk on one list of uint64 keys: the array of min(n, K) best
    keys (the list itself, or the radix select and the compaction in list
    order), then each entry's rank. Returns the keys in row order and the
    number of radix rounds taken."""
    n = len(keys_)
    rounds = 0
    if n <= K:
        s = keys_.copy()
    else:
        prefix, need, shift = np.uint64(0), K, 64
        while shift > 0:
            shift -= 8
            rounds += 1
            hi = np.uint64(0) if shift == 56 else (ONES << np.uint64(shift + 8))
            match = ((keys_ ^ prefix) & hi) == 0
            digit = (keys_[match] >> np.uint64(shift)) & np.uint64(255)
            hist = np.bincount(digit.astype(np.int64), minlength=256)
            cum = np.cumsum(hist)
            d = int(np.searchsorted(cum, need))
            below = int(cum[d] - hist[d])
            prefix |= np.uint64(d) << np.uint64(shift)
            need -= below
            if hist[d] == need:
                break
        top = ONES << np.uint64(shift)
        t = keys_ & top
        lt, eq = t < prefix, t == prefix
        take = lt | (eq & (np.cumsum(eq) <= need))
        s = keys_[take]
        assert len(s) == K
    i = np.arange(len(s))
    rank = [(int((s < x).sum()) + int(((s == x) & (i < j)).sum()))
            for j, x in enumerate(s)]
    rows = np.empty_like(s)
    rows[rank] = s
    return rows, rounds


@pytest.mark.parametrize("count,k,kind", [
    (0, 16, "distinct"), (430, 4096, "distinct"), (600, 600, "distinct"),
    (601, 600, "distinct"), (3000, 600, "ties"), (5000, 257, "few"),
    (2000, 1, "ties"), (1500, 700, "duplicates"), (900, 300, "zeros")])
def test_topk_model_matches_twin(count, k, kind):
    """The model of K17's walk gives the twin's rows bit for bit: the
    count at, below and above k, ties at the k-th score, few distinct
    scores (the radix select runs every round), a key given twice, and
    scores of +0 and -0."""
    rng = np.random.default_rng(count + k)
    shape = (40, 36, 20)
    vol = int(np.prod(shape))
    ci = rng.permutation(vol)[:count].astype(np.int32)
    if kind == "distinct":
        cs = (rng.permutation(count) + 1.0) * 0.01
    elif kind == "ties":
        cs = rng.integers(1, 9, count) * 0.1
    elif kind == "few":
        cs = np.where(rng.random(count) < 0.5, 0.25, 0.5)
    elif kind == "zeros":
        cs = rng.choice([0.0, -0.0, 2.0], count)
    else:
        cs = rng.integers(1, 50, count) * 0.1
        ci[1], cs[1] = ci[0], cs[0]
    cs = cs.astype(np.float32)
    rows, _ = topk_model(keys(cs, ci), k)
    ci_t = torch.zeros((1, vol), dtype=torch.int32)
    cs_t = torch.zeros((1, vol), dtype=torch.float32)
    ci_t[0, :count] = torch.from_numpy(ci)
    cs_t[0, :count] = torch.from_numpy(cs)
    idx, valid = G.topk_plain(ci_t, cs_t, torch.tensor([count]), k, shape)
    m = min(count, k)
    flat = (rows & np.uint64(0xFFFFFFFF)).astype(np.int64)
    assert valid[0].sum() == m and bool(valid[0, :m].all())
    want = idx[0, :m].long()
    np.testing.assert_array_equal(
        flat, ((want[:, 0] * shape[1] + want[:, 1]) * shape[2]
               + want[:, 2]).numpy())


def test_topk_model_stops_when_a_bucket_is_taken_whole():
    """Distinct scores end the radix select early (the k-th key's digit
    bucket holding exactly the keys still needed); one score for all runs
    every round."""
    rng = np.random.default_rng(5)
    ci = rng.permutation(100_000)[:5000]
    _, early = topk_model(keys((rng.random(5000) + 0.5).astype(np.float32),
                               ci), 100)
    _, full = topk_model(keys(np.full(5000, 0.5, np.float32), ci), 100)
    assert early < 8 and full == 8
