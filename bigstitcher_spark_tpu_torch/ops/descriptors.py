"""Geometric descriptor matching, RANSAC and ICP: four CUDA kernels
(K19-K22), their plain-torch twins, and the functions of the JAX module.

Port of ``bigstitcher_spark_tpu/ops/descriptors.py`` (the mvrecon matchers
the reference instantiates at SparkGeometricDescriptorMatching.java:564-621
and its RANSAC consensus fit). The JAX device programs become four
hand-written kernels for ``sm_90a``:

==========================  ==================  ===================================
wrapper                     kernel              JAX device program
==========================  ==================  ===================================
:func:`knn_descriptors`     K19 (descriptors)   ``_knn_kernel``, ``build_descriptors``,
                                                ``block_descriptors_impl``
:func:`ratio_match`         K20 (descriptors)   ``_pairwise_sqdist``,
                                                ``_match_ratio_dense``,
                                                ``_match_ratio_row_chunk``; ICP's
                                                nearest neighbour
:func:`ransac_score`        K21 (ransac)        ``_ransac_kernel``'s hypotheses,
                                                ``_ransac_score_chunk``
:func:`ransac_refit`        K22 (ransac)        ``_ransac_kernel``'s consensus refits
==========================  ==================  ===================================

A wrapper takes its plain twin only because its tensors lie on the CPU; on
CUDA tensors it launches its kernel or raises. Each wrapper counts its
calls that launch its kernel in its ``launches`` attribute. The twins of
K19-K21 repeat the kernels' float32 operations in the same order, one
rounding each, so kernel and twin agree bit for bit on the card; K22 sums
its float64 moments in another order (agreement to float64 rounding).

Deliberate differences from the JAX package (outcome parity, stated in the
tests):

- RANSAC's hypotheses come from a ``torch.Generator`` seeded with the same
  ``seed`` (Floyd's algorithm, :func:`draw_hypotheses`), not from threefry.
- One K21 launch scores every hypothesis against every candidate; JAX
  splits large sets into ``_ransac_score_chunk`` calls with host refits.
  The consensus refits (K22) run on the card in float64 for every size.
- Hypothesis fits and refits solve the centred normal equations
  (``csrc/fit3d.cuh``); inliers are ``|Mp - q|^2 < eps^2``.
- K20 centres both sides on B's mean, as JAX's dense form; JAX's tiled
  form centres each column tile on its own mean. K20 keeps the exact
  best different-owner distance (no top-k truncation).
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict, namedtuple
from contextlib import contextmanager
from itertools import combinations

import numpy as np
import torch

from . import _cuda
from . import models as M
from .fusion import _require, _stream

GEOMETRIC_HASHING = "FAST_ROTATION"        # reference method enum names
RGLDM = "PRECISE_TRANSLATION"
FRGLDM = "FAST_TRANSLATION"
ICP = "ICP"

# K19 keeps at most this many neighbours a point (its register list);
# K20 compares descriptors of at most this many values
MAX_POOL = 8
MAX_DIM = 24
# K21 fits at most this many sample pairs a hypothesis
MAX_SAMPLE = 8
# K19's launch (csrc/descriptors.cu): KNN_THREADS threads a scan block,
# each holding knn_queries(masked) queries; the candidates staged KNN_TILE
# at a time; splits of them until the scan has KNN_WAVE blocks an SM
KNN_THREADS = 128
KNN_TILE = 512
KNN_WAVE = 3
KnnPlan = namedtuple("KnnPlan", "q row_blocks splits per_split kp")
# K20's launch (csrc/descriptors.cu): a block of RATIO_ROWS rows of A, B
# streamed in stages of RATIO_TILE columns
RATIO_ROWS = 256
RATIO_TILE = 128
RatioPlan = namedtuple(
    "RatioPlan", "row_blocks splits tiles_per_split tiles kp wa wb "
                 "center_parts")
# K21's launch (csrc/ransac.cu): hypotheses a block (32 lanes x 4 slots),
# candidates staged a time, blocks an SM holds (its __launch_bounds__)
RANSAC_GROUP = 128
RANSAC_TILE = 256
RANSAC_BLOCKS_PER_SM = 2
RansacPlan = namedtuple("RansacPlan", "groups splits per_split vec")
# K22's launch (csrc/ransac.cu): threads a block, the fewest candidates a
# block takes where there are several, the most blocks an SM; its last
# block's partials (22 moments and the count, float64) a block
REFIT_THREADS = 256
REFIT_MIN_ROWS = 512
REFIT_BLOCKS_PER_SM = 1
REFIT_MAX_BLOCKS = 192
REFIT_PARTIAL = 23
RefitPlan = namedtuple("RefitPlan", "blocks per_block")
# the twins' work tiles: at most this many float32 entries a step
_TWIN_ENTRIES = 1 << 24

_F32 = (torch.float32,)
_F64 = (torch.float64,)
_I32 = (torch.int32,)
_U8 = (torch.uint8,)


def subset_combinations(n_pool: int, n_use: int) -> np.ndarray:
    """All ordered subsets (preserving distance order) of size ``n_use`` from
    the ``n_pool`` nearest neighbors — the 'redundancy' of RGLDM."""
    return np.array(list(combinations(range(n_pool), n_use)), np.int32)


class StageTimes:
    """Seconds per stage of a matching run: ``host`` (wall clock around the
    stage's calls) and ``device`` (CUDA events around them on the card,
    read by :meth:`resolve`; on the CPU the host seconds of the twins)."""

    def __init__(self):
        self.host = defaultdict(float)
        self.device = defaultdict(float)
        self._events = []

    @contextmanager
    def stage(self, name: str, device: torch.device):
        t0 = time.perf_counter()
        ev = None
        if device.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        try:
            yield
        finally:
            secs = time.perf_counter() - t0
            self.host[name] += secs
            if ev is None:
                self.device[name] += secs
            else:
                ev[1].record()
                self._events.append((name, ev))

    def resolve(self) -> None:
        for name, (a, b) in self._events:
            b.synchronize()
            self.device[name] += a.elapsed_time(b) / 1e3
        self._events.clear()


@contextmanager
def _timed(timer: StageTimes | None, name: str, device: torch.device):
    if timer is None:
        yield
    else:
        with timer.stage(name, device):
            yield


def _subsets_on(pool: int, n: int, device) -> torch.Tensor:
    return torch.from_numpy(subset_combinations(pool, n)).to(device)


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------


def _frame_coords(sel: torch.Tensor, n: int, rot: bool) -> torch.Tensor:
    """K19's descriptor of each subset: sel (..., S, n, 3) offsets ->
    (..., S, 3n), in the local frame of the first two when ``rot``."""
    if not rot:
        return sel.reshape(*sel.shape[:-2], 3 * n)
    o0, o1 = sel[..., 0, :], sel[..., 1 % n, :]

    def norm(v):
        return torch.sqrt((v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])
                          + v[..., 2] * v[..., 2])

    ex = o0 / (norm(o0) + 1e-12)[..., None]
    dot = (o1[..., 0] * ex[..., 0] + o1[..., 1] * ex[..., 1]) + o1[..., 2] * ex[..., 2]
    ey = o1 - dot[..., None] * ex
    ey = ey / (norm(ey) + 1e-12)[..., None]
    ez = torch.stack([ex[..., 1] * ey[..., 2] - ex[..., 2] * ey[..., 1],
                      ex[..., 2] * ey[..., 0] - ex[..., 0] * ey[..., 2],
                      ex[..., 0] * ey[..., 1] - ex[..., 1] * ey[..., 0]], -1)
    coords = [(e[..., None, 0] * sel[..., 0] + e[..., None, 1] * sel[..., 1])
              + e[..., None, 2] * sel[..., 2] for e in (ex, ey, ez)]
    return torch.stack(coords, -1).reshape(*sel.shape[:-2], 3 * n)


def knn_descriptors_plain(points: torch.Tensor, valid: torch.Tensor | None,
                          n: int, r: int, rot: bool, rows=None):
    """K19's twin on (B, K, 3) float32 points (``valid`` (B, K) bool or
    None): idx (B, R, P) int32, desc (B, R, S, 3n) float32 and dvalid (B,
    R) bool for the rows ``rows`` (a slice, default all)."""
    B, K, _ = points.shape
    P = n + r
    rows = rows if rows is not None else slice(0, K)
    r0, r1, _ = rows.indices(K)
    subs = _subsets_on(P, n, points.device).long()
    cols = torch.arange(K, device=points.device)
    step = max(1, _TWIN_ENTRIES // max(K, 1))
    idx_all, desc_all, dv_all = [], [], []
    for b in range(B):
        p = points[b]
        vb = None if valid is None else valid[b].bool()
        for s0 in range(r0, r1, step):
            s1 = min(r1, s0 + step)
            rp = p[s0:s1]
            d = rp[:, None, :] - p[None, :, :]  # own - other
            d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
            bad = cols[None, :] == torch.arange(s0, s1, device=p.device)[:, None]
            if vb is not None:
                bad = bad | ~vb[s0:s1, None] | ~vb[None, :]
            d2 = torch.where(bad, torch.full_like(d2, float("inf")), d2)
            srt = torch.sort(d2, dim=1, stable=True)
            idx = srt.indices[:, :P]
            dvalid = torch.isfinite(srt.values[:, P - 1]) if K > P else \
                torch.zeros(s1 - s0, dtype=torch.bool, device=p.device)
            if vb is not None:
                dvalid = dvalid & vb[s0:s1]
            if K < P:  # fewer points than a pool: the kernel's placeholders
                idx = torch.cat([idx, torch.full((s1 - s0, P - K), 2 ** 31 - 1,
                                                 device=p.device)], 1)
            offs = p[torch.where(idx < K, idx, 0)] - rp[:, None, :]
            if vb is not None:
                offs = torch.where(dvalid[:, None, None], offs,
                                   torch.zeros_like(offs))
            sel = offs[:, subs, :]
            desc_all.append(_frame_coords(sel, n, rot))
            idx_all.append(idx.to(torch.int32))
            dv_all.append(dvalid)
    R = r1 - r0
    return (torch.cat(idx_all).reshape(B, R, P),
            torch.cat(desc_all).reshape(B, R, len(subs), 3 * n),
            torch.cat(dv_all).reshape(B, R))


def _center_plain(b: torch.Tensor) -> torch.Tensor:
    return (b.to(torch.float64).sum(0) / b.shape[0]).to(torch.float32)


def ratio_match_plain(a: torch.Tensor, b: torch.Tensor,
                      owner: torch.Tensor | None, ratio: float, rows=None):
    """K20's twin: best owner (column with ``owner`` None), its squared
    distance and accept (None in nearest mode) for the rows ``rows`` of
    ``a`` (default all)."""
    Da, D = a.shape
    r0, r1, _ = (rows if rows is not None else slice(0, Da)).indices(Da)
    c = _center_plain(b)
    ac = a[r0:r1] - c
    bc = b - c

    def sq(x):
        s = x[:, 0] * x[:, 0]
        for k in range(1, D):
            s = s + x[:, k] * x[:, k]
        return s

    a2, b2 = sq(ac), sq(bc)
    own = owner.long() if owner is not None else None
    step = max(1, _TWIN_ENTRIES // max(b.shape[0], 1))
    best, bestd, accept = [], [], []
    for s0 in range(0, r1 - r0, step):
        s1 = min(r1 - r0, s0 + step)
        x = ac[s0:s1]
        dot = x[:, None, 0] * bc[None, :, 0]
        for k in range(1, D):
            dot = dot + x[:, None, k] * bc[None, :, k]
        d2 = torch.clamp((a2[s0:s1, None] + b2[None, :]) - 2.0 * dot, min=0.0)
        j = torch.argmin(d2, dim=1)
        d1 = d2.gather(1, j[:, None])[:, 0]
        if own is None:
            best.append(j.to(torch.int32))
        else:
            o1 = own[j]
            second = torch.where(own[None, :] == o1[:, None],
                                 torch.full_like(d2, float("inf")),
                                 d2).min(1).values
            best.append(o1.to(torch.int32))
            accept.append(torch.sqrt(second) >= ratio * torch.sqrt(d1))
        bestd.append(d1)
    return (torch.cat(best), torch.cat(bestd),
            torch.cat(accept) if own is not None else None)


def score_models_plain(pa: torch.Tensor, pb: torch.Tensor,
                       models: torch.Tensor, eps: float) -> torch.Tensor:
    """K21's scoring: the inliers (|Mp - q|^2 < eps^2 in float32) of each
    (3, 4) float32 model of ``models`` (I, 3, 4) over all candidates."""
    eps2 = torch.tensor(eps, dtype=torch.float32) * torch.tensor(
        eps, dtype=torch.float32)
    eps2 = eps2.to(pa.device)
    I, M = models.shape[0], pa.shape[0]
    step = max(1, _TWIN_ENTRIES // max(M, 1))
    out = []
    for h0 in range(0, I, step):
        m = models[h0:h0 + step]
        e2 = None
        for j in range(3):
            pred = ((m[:, j, 0, None] * pa[None, :, 0]
                     + m[:, j, 1, None] * pa[None, :, 1])
                    + m[:, j, 2, None] * pa[None, :, 2]) + m[:, j, 3, None]
            d = pred - pb[None, :, j]
            e2 = d * d if e2 is None else e2 + d * d
        out.append((e2 < eps2).sum(1).to(torch.int32))
    return torch.cat(out)


def ransac_score_plain(pa, pb, idx, eps: float, kind: str):
    """K21's twin: counts (I,) int32, models (I, 3, 4) float32, best (2,)
    int32 (index, count: the first maximum) and its model (3, 4) float64."""
    sp = pa[idx.long()]
    sq = pb[idx.long()]
    models = M.fit_centred(kind, *M.centred_moments(sp, sq)).contiguous()
    counts = score_models_plain(pa, pb, models, eps)
    h = torch.argmax(counts)
    best = torch.stack([h.to(torch.int32), counts[h]])
    return counts, models, best, models[h].to(torch.float64)


def ransac_refit_plain(pa, pb, model, eps: float, kind: str, reg: str,
                       lam: float, fit: bool = True):
    """K22's twin: the inlier mask (|Mp - q|^2 < eps^2 in float64) of
    ``model`` (3, 4) float64, its count, and with ``fit`` the float64
    ``fit_interpolated`` of those inliers (moments summed by torch)."""
    p = pa.to(torch.float64)
    q = pb.to(torch.float64)
    e2 = None
    for j in range(3):
        pred = ((model[j, 0] * p[:, 0] + model[j, 1] * p[:, 1])
                + model[j, 2] * p[:, 2]) + model[j, 3]
        d = pred - q[:, j]
        e2 = d * d if e2 is None else e2 + d * d
    mask = e2 < float(eps) * float(eps)
    count = mask.sum().to(torch.int32)
    if not fit:
        return mask, count, None
    w = mask.to(torch.float64)
    sw = w.sum()
    sp = (w[:, None] * p).sum(0)
    sq = (w[:, None] * q).sum(0)
    pc, qc = sp / sw, sq / sw
    spp = torch.einsum("n,ni,nj->ij", w, p, p)
    spq = torch.einsum("n,ni,nj->ij", w, p, q)
    a = spp - sp[:, None] * pc[None, :]
    a = torch.triu(a) + torch.triu(a, 1).T
    h = spq - sp[:, None] * qc[None, :]
    out = M.fit_interpolated_centred(kind, reg, lam, pc, qc, a, h)
    return mask, count, out


# ---------------------------------------------------------------------------
# Kernel wrappers (K19-K22)
# ---------------------------------------------------------------------------


def check_pool(n: int, r: int) -> int:
    """The neighbour pool n + r of a descriptor, or ValueError beyond what
    K19 keeps (ROADMAP Queue 3 item 7)."""
    P = int(n) + int(r)
    if not (1 <= n <= P <= MAX_POOL):
        raise ValueError(f"n={n}, r={r}: K19 keeps 1 to {MAX_POOL} "
                         "neighbours a point")
    return P


def knn_queries(masked: bool) -> int:
    """Queries a thread of K19's scan holds: 4, or 1 in the masked form
    (whose few valid queries then spread over more blocks)."""
    return 1 if masked else 4


def knn_plan(B: int, K: int, P: int, sms: int = 132,
             masked: bool = False) -> KnnPlan:
    """K19's launch for B entries of K points and a pool of P on a card of
    ``sms`` multiprocessors (``masked``: with validity flags):
    ``row_blocks`` scan blocks of KNN_THREADS x ``q`` queries an entry;
    the candidates, ``kp`` (K padded to whole stages of KNN_TILE), cut
    into ``splits`` runs of ``per_split`` (whole stages, none empty)
    where B x row_blocks blocks would not give the card KNN_WAVE blocks
    an SM: of equal whole stages, as many as give it (the last run may be
    shorter), or one a stage."""
    B, K, P = int(B), int(K), int(P)
    if B < 1 or K < 1 or not 1 <= P <= MAX_POOL:
        raise ValueError(f"K19 needs points and a pool of 1 to {MAX_POOL}, "
                         f"got B {B}, K {K}, P {P}")
    q = knn_queries(masked)
    row_blocks = _cdiv(K, KNN_THREADS * q)
    tiles = _cdiv(K, KNN_TILE)
    splits = min(tiles, _cdiv(KNN_WAVE * int(sms), B * row_blocks))
    per = _cdiv(tiles, splits) * KNN_TILE
    return KnnPlan(q, row_blocks, _cdiv(K, per), per, tiles * KNN_TILE)


def knn_descriptors(points: torch.Tensor, valid: torch.Tensor | None,
                    n: int, r: int, rot: bool, want_idx: bool = True):
    """K19 (``csrc/descriptors.cu``) on CUDA, :func:`knn_descriptors_plain`
    on the CPU: for (B, K, 3) float32 points (``valid`` (B, K) bool, or
    None for dense clouds) the n + r nearest neighbours of each point
    (idx (B, K, P) int32, or None without ``want_idx``), its descriptors
    (B, K, S, 3n) float32 and dvalid (B, K) bool (all True without
    ``valid`` when K > P). The launch: :func:`knn_plan`."""
    P = check_pool(n, r)
    if points.device.type == "cpu":
        idx, desc, dv = knn_descriptors_plain(points, valid, n, r, rot)
        return (idx if want_idx else None), desc, dv
    dev = points.device
    if points.dim() != 3 or points.shape[2] != 3:
        raise ValueError(f"points must be (B, K, 3), got {tuple(points.shape)}")
    B, K = int(points.shape[0]), int(points.shape[1])
    _require(points, "points", dev, _F32)
    if valid is not None:
        valid = valid.to(torch.uint8).contiguous()
        _require(valid, "valid", dev, _U8, (B, K))
    subs = _subsets_on(P, n, dev).contiguous()
    S = int(subs.shape[0])
    idx = (torch.empty((B, K, P), dtype=torch.int32, device=dev)
           if want_idx else None)
    desc = torch.empty((B, K, S, 3 * n), dtype=torch.float32, device=dev)
    dv = torch.empty((B, K), dtype=torch.uint8, device=dev)
    plan = knn_plan(B, K, P, _sms(dev), valid is not None)
    pts4 = torch.empty((B, plan.kp, 4), dtype=torch.float32, device=dev)
    part_d = torch.empty((plan.splits, B, K, P), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((plan.splits, B, K, P), dtype=torch.int32,
                         device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _cuda.load("descriptors")
    ret = lib.bst_knn_descriptors(points.data_ptr(), ptr(valid), B, K, P,
                                  int(n), S, subs.data_ptr(), int(bool(rot)),
                                  plan.q, plan.row_blocks, plan.splits,
                                  plan.per_split, plan.kp, pts4.data_ptr(),
                                  part_d.data_ptr(), part_i.data_ptr(),
                                  ptr(idx), desc.data_ptr(), dv.data_ptr(),
                                  _stream(dev))
    _cuda.check(lib, ret, "knn_descriptors")
    knn_descriptors.launches += 1
    return idx, desc, dv.bool()


knn_descriptors.launches = 0


def _cdiv(a: int, b: int) -> int:
    return -(-int(a) // int(b))


def ratio_plan(Da: int, Db: int, D: int, sms: int = 132) -> RatioPlan:
    """K20's launch for ``Da`` rows against ``Db`` columns of ``D`` values
    on a card of ``sms`` multiprocessors: a block per RATIO_ROWS rows; B's
    tiles of RATIO_TILE columns cut into ``splits`` runs of whole tiles,
    as many as bring the blocks to two an SM (none empty), each split's
    states merged in split order; the stored depth of B' ``kp`` (D + 1
    padded to 16 or 32), the row widths of the centred A and B (``wa``:
    D + 1, ``wb``: D + 2, padded to 4 floats) and the blocks of B's
    mean."""
    row_blocks = _cdiv(Da, RATIO_ROWS)
    tiles = _cdiv(Db, RATIO_TILE)
    splits = max(1, min(_cdiv(2 * sms, row_blocks), tiles))
    per = _cdiv(tiles, splits)
    return RatioPlan(row_blocks, _cdiv(tiles, per), per, tiles,
                     16 if D + 1 <= 16 else 32, _cdiv(D + 1, 4) * 4,
                     _cdiv(D + 2, 4) * 4,
                     max(1, min(2 * sms, _cdiv(Db, 256))))


def ransac_plan(M: int, I: int, sms: int = 132,
                addr: int = 0) -> RansacPlan:
    """K21's launch for ``I`` hypotheses against ``M`` candidates on a card
    of ``sms`` multiprocessors: ``groups`` blocks of RANSAC_GROUP
    hypotheses along x; the candidates cut into ``splits`` runs of
    ``per_split`` (a multiple of 4, none empty) along y, each at least a
    tile of RANSAC_TILE where M allows more than one: of the split counts
    that fill the card's RANSAC_BLOCKS_PER_SM x ``sms`` block slots once or
    more (up to four times the least), the one whose last wave of blocks
    is the fullest, the fewest on ties (each split refits its group's
    hypotheses); ``vec``: the candidate arrays 16-byte aligned (``addr``,
    their addresses or'd together), so that a tile's rows load as
    float4s."""
    M, I = int(M), int(I)
    if M < 1 or I < 1:
        raise ValueError(f"K21 needs candidates and hypotheses, got M {M}, "
                         f"I {I}")
    groups = _cdiv(I, RANSAC_GROUP)
    slots = RANSAC_BLOCKS_PER_SM * sms
    most = max(1, M // RANSAC_TILE)
    least = min(most, _cdiv(slots, groups))

    def fill(s):
        n = groups * s
        return n / (slots * _cdiv(n, slots))

    splits = max(range(least, min(most, 4 * least) + 1),
                 key=lambda s: (fill(s), -s))
    per = _cdiv(_cdiv(M, splits), 4) * 4
    return RansacPlan(groups, _cdiv(M, per), per, int(addr) % 16 == 0)


def refit_plan(M: int, sms: int = 132) -> RefitPlan:
    """K22's launch for ``M`` candidates on a card of ``sms``
    multiprocessors: ``blocks`` blocks of REFIT_THREADS threads, each a
    contiguous run of ``per_block`` candidates (the last one shorter, none
    empty). One block up to 2 x REFIT_MIN_ROWS - 1 candidates (then the
    kernel is the one-block form, bit for bit); beyond, a block every
    REFIT_MIN_ROWS candidates, up to REFIT_BLOCKS_PER_SM x ``sms`` and
    REFIT_MAX_BLOCKS (the partials the last block holds)."""
    M = int(M)
    if M < 1:
        raise ValueError(f"K22 needs candidates, got M {M}")
    blocks = max(1, min(REFIT_BLOCKS_PER_SM * int(sms), REFIT_MAX_BLOCKS,
                        M // REFIT_MIN_ROWS))
    per = _cdiv(M, blocks)
    return RefitPlan(_cdiv(M, per), per)


@functools.lru_cache(maxsize=64)
def _refit_ticket(device: torch.device, stream: int) -> torch.Tensor:
    """K22's last-block ticket for launches on ``stream`` (one int32, 0
    between launches: the last block resets it), allocated at first use."""
    return torch.zeros(1, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=8)
def _sms(device: torch.device) -> int:
    return int(torch.cuda.get_device_properties(device).multi_processor_count)


def ratio_center(b: torch.Tensor, plan: RatioPlan | None = None):
    """B's mean as K20 takes it: :func:`_center_plain` on the CPU; on CUDA
    the float64 block sums of ``csrc/descriptors.cu`` summed in block
    order and rounded once (the first step of every K20 launch)."""
    if b.device.type == "cpu":
        return _center_plain(b)
    dev = b.device
    Db, D = (int(v) for v in b.shape)
    plan = plan or ratio_plan(1, Db, D, _sms(dev))
    _require(b, "b", dev, _F32)
    partials = torch.empty(plan.center_parts * D, dtype=torch.float64,
                           device=dev)
    center = torch.empty(D, dtype=torch.float32, device=dev)
    lib = _cuda.load("descriptors")
    ret = lib.bst_ratio_center(b.data_ptr(), Db, D, partials.data_ptr(),
                               plan.center_parts, center.data_ptr(),
                               _stream(dev))
    _cuda.check(lib, ret, "ratio_center")
    return center


def ratio_match(a: torch.Tensor, b: torch.Tensor,
                owner: torch.Tensor | None, ratio: float):
    """K20 on CUDA, :func:`ratio_match_plain` on the CPU. ``a`` (Da, D),
    ``b`` (Db, D) float32, ``owner`` (Db,) int32. Ratio mode: (best owner
    (Da,) int32, its squared distance (Da,) float32, accept (Da,) bool);
    nearest mode (``owner`` None): (best column, its squared distance,
    None). After a launch ``ratio_match.refined`` holds, on the card, the
    number of pairs the filter passed to the exact refine (int64 (1,))."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError("a and b must be (Da, D) and (Db, D)")
    D = int(a.shape[1])
    if D % 3 or not 3 <= D <= MAX_DIM or a.shape[0] < 1 or b.shape[0] < 1:
        raise ValueError(f"K20 compares 1 to {MAX_DIM // 3} vectors of 3 "
                         f"(D={D}) of non-empty sets")
    if a.device.type == "cpu":
        return ratio_match_plain(a, b, owner, ratio)
    dev = a.device
    Da, Db = int(a.shape[0]), int(b.shape[0])
    _require(a, "a", dev, _F32)
    _require(b, "b", dev, _F32)
    if owner is not None:
        _require(owner, "owner", dev, _I32, (Db,))
    plan = ratio_plan(Da, Db, D, _sms(dev))
    center = ratio_center(b, plan)
    f32 = dict(dtype=torch.float32, device=dev)
    ae = torch.empty(Da * plan.wa, **f32)
    be = torch.empty(Db * plan.wb, **f32)
    bt = torch.empty(plan.tiles * RATIO_TILE * plan.kp, **f32)
    part = torch.empty(plan.splits * Da * 4, **f32)
    refined = torch.empty(1, dtype=torch.int64, device=dev)
    best = torch.empty(Da, dtype=torch.int32, device=dev)
    bestd = torch.empty(Da, **f32)
    accept = (torch.empty(Da, dtype=torch.uint8, device=dev)
              if owner is not None else None)
    lib = _cuda.load("descriptors")
    ret = lib.bst_ratio_match(
        a.data_ptr(), Da, b.data_ptr(), Db, D,
        None if owner is None else owner.data_ptr(), float(ratio),
        center.data_ptr(), plan.row_blocks, plan.splits,
        plan.tiles_per_split, plan.tiles, ae.data_ptr(), be.data_ptr(),
        bt.data_ptr(), part.data_ptr(), refined.data_ptr(), best.data_ptr(),
        bestd.data_ptr(), None if accept is None else accept.data_ptr(),
        _stream(dev))
    _cuda.check(lib, ret, "ratio_match")
    ratio_match.launches += 1
    ratio_match.refined = refined
    return best, bestd, (None if accept is None else accept.bool())


ratio_match.launches = 0
ratio_match.refined = None


def ratio_filter_dot(a: torch.Tensor, b: torch.Tensor, D: int):
    """K20's filter dot alone, the tensor cores' sum whose error the
    kernel's margin bounds: ``a`` (n, 16, kp) and ``b`` (n, 8, kp) float32
    holding TF32 values (the low 13 bits zero), kp = ``ratio_plan(1, 1,
    D).kp``; returns (n, 16, 8) a @ b^T as the filter sums it, its MMAs
    over the first D + 1 of the kp terms. On the CPU the sum of the D + 1
    terms in float64, rounded once."""
    kp = ratio_plan(1, 1, D).kp
    if a.dim() != 3 or tuple(a.shape[1:]) != (16, kp) or b.dim() != 3 \
            or tuple(b.shape) != (a.shape[0], 8, kp) or a.shape[0] < 1:
        raise ValueError(f"a and b must be (n, 16, {kp}) and (n, 8, {kp})")
    if a.device.type == "cpu":
        return (a[..., :D + 1].double()
                @ b[..., :D + 1].double().transpose(1, 2)).float()
    dev = a.device
    _require(a, "a", dev, _F32)
    _require(b, "b", dev, _F32)
    out = torch.empty((a.shape[0], 16, 8), dtype=torch.float32, device=dev)
    lib = _cuda.load("descriptors")
    ret = lib.bst_ratio_mma_probe(a.data_ptr(), b.data_ptr(), D,
                                  int(a.shape[0]), out.data_ptr(),
                                  _stream(dev))
    _cuda.check(lib, ret, "ratio_filter_dot")
    return out


def ransac_score(pa: torch.Tensor, pb: torch.Tensor, idx: torch.Tensor,
                 eps: float, kind: str):
    """K21 on CUDA, :func:`ransac_score_plain` on the CPU: the model of
    ``kind`` fitted to each hypothesis' sample pairs ``idx`` (I, sample)
    int32 of the candidates ``pa``, ``pb`` (M, 3) float32, its inlier
    count over all candidates, and the first best: counts (I,) int32,
    models (I, 3, 4) float32, best (2,) int32 (index, count), best model
    (3, 4) float64. The launch: :func:`ransac_plan`."""
    code = M.fit_code(kind)
    if code < 0:
        raise ValueError("RANSAC needs a model, not NONE")
    if idx.dim() != 2 or not 1 <= idx.shape[1] <= MAX_SAMPLE:
        raise ValueError(f"idx must be (I, 1..{MAX_SAMPLE})")
    if pa.device.type == "cpu":
        return ransac_score_plain(pa, pb, idx, eps, kind)
    dev = pa.device
    Mc = int(pa.shape[0])
    I, sample = (int(s) for s in idx.shape)
    _require(pa, "pa", dev, _F32, (Mc, 3))
    _require(pb, "pb", dev, _F32, (Mc, 3))
    _require(idx, "idx", dev, _I32)
    counts = torch.empty(I, dtype=torch.int32, device=dev)
    models = torch.empty((I, 3, 4), dtype=torch.float32, device=dev)
    best = torch.empty(2, dtype=torch.int32, device=dev)
    best_model = torch.empty((3, 4), dtype=torch.float64, device=dev)
    plan = ransac_plan(Mc, I, _sms(dev), pa.data_ptr() | pb.data_ptr())
    lib = _cuda.load("ransac")
    ret = lib.bst_ransac_score(pa.data_ptr(), pb.data_ptr(), Mc,
                               idx.data_ptr(), I, sample, code, float(eps),
                               *plan[:3], int(plan.vec), counts.data_ptr(),
                               models.data_ptr(), best.data_ptr(),
                               best_model.data_ptr(), _stream(dev))
    _cuda.check(lib, ret, "ransac_score")
    ransac_score.launches += 1
    return counts, models, best, best_model


ransac_score.launches = 0


def ransac_refit(pa: torch.Tensor, pb: torch.Tensor, model: torch.Tensor,
                 eps: float, kind: str, reg: str, lam: float,
                 fit: bool = True):
    """K22 on CUDA, :func:`ransac_refit_plain` on the CPU: the inliers
    (M,) bool of ``model`` (3, 4) float64, their count (int32 scalar
    tensor) and, with ``fit``, ``fit_interpolated(kind, reg, lam)`` of
    them as a (3, 4) float64 model (None without). One launch over
    :func:`refit_plan`'s grid."""
    code, rcode = M.fit_code(kind), M.fit_code(reg)
    if code < 0:
        raise ValueError("RANSAC needs a model, not NONE")
    if pa.device.type == "cpu":
        return ransac_refit_plain(pa, pb, model, eps, kind, reg, lam, fit)
    dev = pa.device
    Mc = int(pa.shape[0])
    _require(pa, "pa", dev, _F32, (Mc, 3))
    _require(pb, "pb", dev, _F32, (Mc, 3))
    _require(model, "model", dev, _F64, (3, 4))
    mask = torch.empty(Mc, dtype=torch.uint8, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    out = torch.empty((3, 4), dtype=torch.float64, device=dev) if fit else None
    plan = refit_plan(Mc, _sms(dev))
    partials = ticket = None
    if plan.blocks > 1:
        partials = torch.empty(plan.blocks * REFIT_PARTIAL,
                               dtype=torch.float64, device=dev)
        ticket = _refit_ticket(dev, _stream(dev))
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _cuda.load("ransac")
    ret = lib.bst_ransac_refit(pa.data_ptr(), pb.data_ptr(), Mc,
                               model.data_ptr(), float(eps), int(bool(fit)),
                               code, rcode, float(lam), *plan,
                               mask.data_ptr(), count.data_ptr(), ptr(out),
                               ptr(partials), ptr(ticket), _stream(dev))
    _cuda.check(lib, ret, "ransac_refit")
    ransac_refit.launches += 1
    return mask.bool(), count, out


ransac_refit.launches = 0


KERNEL_WRAPPERS = {
    "knn_descriptors": knn_descriptors,
    "ratio_match": ratio_match,
    "ransac_score": ransac_score,
    "ransac_refit": ransac_refit,
}


# ---------------------------------------------------------------------------
# The JAX package's functions
# ---------------------------------------------------------------------------


def _device_of(device) -> torch.device:
    from ..utils.device import resolve_device

    return resolve_device(device)


def _points_on(points, device) -> torch.Tensor:
    if isinstance(points, torch.Tensor):
        return points.to(device=device, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(device)


def knn_indices(points, k: int, device=None) -> torch.Tensor:
    """Indices (N, k) int32 of the k nearest neighbours (self excluded) of
    each point (K19), on ``device``."""
    dev = _device_of(device)
    p = _points_on(points, dev)
    idx, _, _ = knn_descriptors(p[None], None, 1, int(k) - 1, False)
    return idx[0]


def build_descriptors(points, n_neighbors: int = 3, redundancy: int = 1,
                      rotation_invariant: bool = True, device=None):
    """Per-point local geometric descriptors (K19): (descriptors (N*S,
    3n) float32, owner (N*S,) int32) on ``device``, S = C(n + r, n)."""
    dev = _device_of(device)
    p = _points_on(points, dev)
    n = int(p.shape[0])
    _, desc, _ = knn_descriptors(p[None], None, int(n_neighbors),
                                 int(redundancy), bool(rotation_invariant),
                                 want_idx=False)
    s = int(desc.shape[2])
    owner = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(s)
    return desc.reshape(n * s, -1), owner


def block_descriptors_batch(points: torch.Tensor, valid: torch.Tensor,
                            n_neighbors: int = 3, redundancy: int = 1,
                            rotation_invariant: bool = True):
    """Descriptors of each detection block's fixed-K candidate slots
    (K19's masked form): points (B, K, 3), valid (B, K) -> (desc (B, K, S,
    3n) float32, dvalid (B, K) bool); invalid slots and points without a
    full pool of valid neighbours give all-zero descriptors."""
    _, desc, dv = knn_descriptors(points.to(torch.float32).contiguous(),
                                  valid.bool(), int(n_neighbors),
                                  int(redundancy), bool(rotation_invariant),
                                  want_idx=False)
    return desc, dv


def match_ratio_test(desc_a, owner_a, desc_b, owner_b, ratio):
    """Best-vs-second-best candidate matching (K20) for the dense and the
    tiled case alike: for each descriptor of A the owner in B of its
    nearest descriptor of B, accepted if the nearest descriptor of a
    different owner is at least ``ratio`` times as far. Returns (match_b
    (Da,) int32, accept (Da,) bool)."""
    best, _, accept = ratio_match(desc_a, desc_b, owner_b.to(torch.int32),
                                  float(ratio))
    return best, accept


def candidates_launch(points_a, points_b, method: str = GEOMETRIC_HASHING,
                      n_neighbors: int = 3, redundancy: int = 1,
                      ratio_of_distance: float = 3.0, device=None,
                      timer: StageTimes | None = None):
    """Enqueue :func:`match_candidates`' device work (K19 twice, K20);
    returns a handle for :func:`candidates_finish`, or None when a cloud
    has no more points than a neighbour pool."""
    pool = n_neighbors + redundancy
    if len(points_a) <= pool or len(points_b) <= pool:
        return None
    dev = _device_of(device)
    rot = method == GEOMETRIC_HASHING
    with _timed(timer, "load", dev):
        pa, pb = _points_on(points_a, dev), _points_on(points_b, dev)
    with _timed(timer, "descriptors", dev):
        da, oa = build_descriptors(pa, n_neighbors, redundancy, rot, dev)
        db, ob = build_descriptors(pb, n_neighbors, redundancy, rot, dev)
    with _timed(timer, "ratio", dev):
        mb, acc = match_ratio_test(da, oa, db, ob, ratio_of_distance)
    return oa, mb, acc


def candidates_finish(handle, timer: StageTimes | None = None) -> np.ndarray:
    """The (M, 2) int32 candidate pairs [index_a, index_b] of a
    :func:`candidates_launch` handle, duplicates removed. The fetch (the
    wait for K19 and K20, and the copy) is the timer's ``fetch`` stage."""
    if handle is None:
        return np.zeros((0, 2), np.int32)
    with _timed(timer, "fetch", handle[0].device):
        oa, mb, acc = (t.cpu().numpy() for t in handle)
    pairs = np.stack([oa[acc], mb[acc]], axis=1)
    return np.unique(pairs, axis=0).astype(np.int32)


def match_candidates(points_a, points_b, method: str = GEOMETRIC_HASHING,
                     n_neighbors: int = 3, redundancy: int = 1,
                     ratio_of_distance: float = 3.0, device=None,
                     timer: StageTimes | None = None) -> np.ndarray:
    """Descriptor-based correspondence candidates between two clouds.

    Returns (M,2) int32 [index_a, index_b] with duplicates removed. Needs
    at least n_neighbors+redundancy+1 points per cloud.
    """
    return candidates_finish(candidates_launch(
        points_a, points_b, method, n_neighbors, redundancy,
        ratio_of_distance, device, timer), timer)


def draw_hypotheses(m: int, iterations: int, sample: int,
                    generator: torch.Generator) -> torch.Tensor:
    """(iterations, sample) int32 indices, each row ``sample`` distinct
    values of [0, m) drawn uniformly (Floyd's algorithm) from
    ``generator``, on its device."""
    if not 1 <= sample <= m:
        raise ValueError(f"cannot draw {sample} distinct of {m} candidates")
    dev = generator.device
    picks = torch.empty((int(iterations), int(sample)), dtype=torch.int64,
                        device=dev)
    for s, j in enumerate(range(m - sample, m)):
        u = torch.rand(int(iterations), generator=generator,
                       dtype=torch.float64, device=dev)
        t = torch.clamp((u * (j + 1)).floor().to(torch.int64), max=j)
        if s:
            dup = (picks[:, :s] == t[:, None]).any(1)
            t = torch.where(dup, torch.full_like(t, j), t)
        picks[:, s] = t
    return picks.to(torch.int32).contiguous()


def ransac(
    cand_a,
    cand_b,
    model_kind: str = "AFFINE",
    reg_kind: str = "RIGID",
    lam: float = 0.1,
    epsilon: float = 5.0,
    min_inlier_ratio: float = 0.1,
    min_inliers: int = 12,
    iterations: int = 10000,
    seed: int = 17,
    device=None,
    timer: StageTimes | None = None,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Hypothesis-parallel RANSAC over candidate correspondences.

    cand_a/cand_b: (M,3) matched candidate coordinates. Returns
    (model 3x4 float64, inlier_mask (M,)) or None if consensus is too small
    (RANSAC defaults: SparkGeometricDescriptorMatching.java:180-189).
    K21 scores every hypothesis, K22 refits twice on the consensus and
    marks the final inliers; the model is then refitted on the host in
    float64 on those inliers.
    """
    m = len(cand_a)
    sample = max(M.MIN_POINTS[model_kind], M.MIN_POINTS.get(reg_kind, 0), 1)
    if m < max(min_inliers, sample):
        return None
    dev = _device_of(device)
    with _timed(timer, "ransac", dev):
        pa, pb = _points_on(cand_a, dev), _points_on(cand_b, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        idx = draw_hypotheses(m, int(iterations), sample, gen)
        _, _, _, model = ransac_score(pa, pb, idx, float(epsilon), model_kind)
        for _ in range(2):  # the two consensus refits
            _, _, model = ransac_refit(pa, pb, model, float(epsilon),
                                       model_kind, reg_kind, float(lam))
        mask, _, _ = ransac_refit(pa, pb, model, float(epsilon), model_kind,
                                  reg_kind, float(lam), fit=False)
        inliers = mask.cpu().numpy()
    n_in = int(inliers.sum())
    if n_in < min_inliers or n_in < min_inlier_ratio * m:
        return None
    # final f64 refit on the inlier set (the device passes run f32 / f64)
    model = M.fit_interpolated(model_kind, reg_kind, lam,
                               np.asarray(cand_a, np.float64)[inliers],
                               np.asarray(cand_b, np.float64)[inliers])
    return np.asarray(model, np.float64), inliers


def ransac_multi(
    cand_a,
    cand_b,
    model_kind: str = "AFFINE",
    reg_kind: str = "RIGID",
    lam: float = 0.1,
    epsilon: float = 5.0,
    min_inlier_ratio: float = 0.1,
    min_inliers: int = 12,
    iterations: int = 10000,
    seed: int = 17,
    device=None,
    timer: StageTimes | None = None,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Multi-consensus RANSAC (RANSACParameters multiconsensus option,
    SparkGeometricDescriptorMatching.java:145-146,307): repeatedly find the
    largest consensus among the REMAINING candidates, remove its inliers,
    and continue until no consensus is left.

    Returns [(model 3x4, inlier_mask over the ORIGINAL candidates), ...]
    ordered by discovery. Terminates: every accepted set removes >=
    min_inliers >= 1 candidates."""
    cand_a = np.asarray(cand_a)
    cand_b = np.asarray(cand_b)
    remaining = np.arange(len(cand_a))
    out: list[tuple[np.ndarray, np.ndarray]] = []
    round_i = 0
    while len(remaining) >= max(min_inliers, 1):
        res = ransac(cand_a[remaining], cand_b[remaining], model_kind,
                     reg_kind, lam, epsilon, min_inlier_ratio, min_inliers,
                     iterations, seed=seed + round_i, device=device,
                     timer=timer)
        if res is None:
            break
        model, inl = res
        mask = np.zeros(len(cand_a), bool)
        mask[remaining[inl]] = True
        out.append((model, mask))
        remaining = remaining[~inl]
        round_i += 1
    return out


def icp(
    points_a,
    points_b,
    model_kind: str = "AFFINE",
    reg_kind: str = "RIGID",
    lam: float = 0.1,
    max_distance: float = 2.5,
    max_iterations: int = 200,
    min_converged: float = 1e-4,
    use_ransac: bool = False,
    ransac_epsilon: float = 5.0,
    ransac_iterations: int = 200,
    seed: int = 17,
    device=None,
    timer: StageTimes | None = None,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Iterative closest point: A is progressively transformed onto B.

    Returns (model 3x4 mapping a->b, correspondences (K,2) [ia, ib]) or None.
    Defaults follow the reference (200 iterations, 2.5 px max distance).
    Each round's nearest neighbours come from K20's nearest mode (JAX
    copies the whole (Na, Nb) distance matrix to the host); the refit runs
    on the host in float64. ``use_ransac`` filters each round's
    correspondences through RANSAC first (--icpUseRANSAC).
    """
    a = np.asarray(points_a, np.float64)
    b = np.asarray(points_b, np.float64)
    if len(a) < M.MIN_POINTS[model_kind] or len(b) < M.MIN_POINTS[model_kind]:
        return None
    dev = _device_of(device)
    bt = _points_on(b, dev)
    model = np.hstack([np.eye(3), np.zeros((3, 1))])
    prev_err = np.inf
    pairs = None
    for it in range(max_iterations):
        moved = a @ model[:, :3].T + model[:, 3]
        with _timed(timer, "ratio", dev):
            nn, d2, _ = ratio_match(_points_on(moved, dev), bt, None, 0.0)
            nn, d2 = nn.cpu().numpy(), d2.cpu().numpy()
        nd = np.sqrt(d2)
        keep = nd < max_distance
        if keep.sum() < max(M.MIN_POINTS[model_kind], 3):
            return None
        pairs = np.stack([np.where(keep)[0], nn[keep]], 1)
        if use_ransac:
            res = ransac(a[pairs[:, 0]], b[pairs[:, 1]], model_kind,
                         reg_kind, lam, epsilon=ransac_epsilon,
                         min_inlier_ratio=0.0,
                         min_inliers=max(M.MIN_POINTS[model_kind], 3),
                         iterations=ransac_iterations, seed=seed + it,
                         device=dev, timer=timer)
            if res is not None:
                pairs = pairs[res[1]]
        model = M.fit_interpolated(model_kind, reg_kind, lam,
                                   a[pairs[:, 0]], b[pairs[:, 1]])
        err = float(nd[keep].mean())
        if abs(prev_err - err) < min_converged:
            break
        prev_err = err
    return model, pairs.astype(np.int32)
