"""The port's CUDA kernels (K1-K29) against their plain-torch twins, on the card.

Every test here needs an NVIDIA GPU and nvcc; on a host without
``torch.cuda.is_available()`` each one skips and says so. On the card:

    BST_TEST_TPU=1 python -m pytest tests/test_torch_kernels.py -m cuda

(``BST_TEST_TPU=1`` keeps tests/conftest.py from importing JAX, which the
card machine does not have.) Tolerances: fused float32 rtol 1e-5 / atol
1e-3 and wsum atol 1e-5 (both sides round every float op; cosf and the
CPU/GPU cos differ in the last bits); converted integers |delta| <= 1.
K6 (downsample) takes the same sums in the same order on both sides, so
its outputs must be bitwise equal. K7 (window) and K9 (cross power):
rtol 1e-5 / atol 1e-6 (the same float32 operations in the same order; the
mean's float64 sum is taken in another order). K8 (FFT) against
torch.fft: max|delta| <= 2e-5 x max|X| per pair (float32 round-off grows
with log2 N). K10 (top-k): indices equal. K11-K14 (relax, float64):
each stage within rtol 1e-10 / atol 1e-12 of its twin on the same inputs
(sums in another order, another 3x3 SVD and 4x4 solve), the rtol taken
against the magnitude of the terms summed (``ops.solve.moment_scale``,
``fit_scale``) where they cancel: K11's moments about a tile's origin and
K12's world-frame translations; whole relaxations under the
JAX package's device-vs-numpy contract (iterations equal, history rtol 1e-9
/ atol 1e-9, models and link errors rtol 1e-7 / atol 1e-9). K13's fused
form (K14 in its last block) and the sharded forms of K12 and K14 (the
shards' partials added as they load them) are bitwise their unfused
pairs (K13 then K14; K29 then K12 or K14). K15 (blur) and
K16 (response, extrema) take the same float32 operations in the same order
as their twins: bitwise equal, candidate lists equal as sets with exact
counts. K17 (top-k): indices and flags equal. K18 (subpixel fit): sub
within 1e-5 px, val within rtol 1e-6. K19 (kNN descriptors), K20 (ratio
test) and K21 (RANSAC scores) take the same float32 operations in the
same order as their twins: indices, owners, flags and counts equal,
descriptors, distances and models bitwise (K20's mean of B is a float64
sum in another order, rounded once; its TF32 filter only decides which
pairs it recomputes exactly). K22 (refit, float64): masks and
counts equal, models within rtol 1e-9 / atol 1e-9 (moments summed in
another order). K26 (non-rigid fusion) at the fusion kernels' tolerances:
it rounds where its twin rounds (the twin's fused multiply-adds in
float64 may round twice where fmaf rounds once, in rare last bits). K2
(shift) and K27 (volume scan fusion) take their twin's float32 operations
in the same order on the same weight tables: bitwise (K2's batch form with
9 views against the twin at the fusion tolerance: torch sums 9 views in
another order). K29 (shard sum) adds in the
twin's order: bitwise, its dot within rtol 1e-12; K24's partial form
gives the full form's Ap bit for bit; the sharded relax on a mesh of one
card repeated is bitwise the one-device relax, the sharded CG within 1e-8
of the one-device CG.
"""

import numpy as np
import pytest
import torch

from bigstitcher_spark_tpu_torch import ops
from bigstitcher_spark_tpu_torch.ops import descriptors as DS
from bigstitcher_spark_tpu_torch.ops import dog as G
from bigstitcher_spark_tpu_torch.ops import downsample as D
from bigstitcher_spark_tpu_torch.ops import fusion as F
from bigstitcher_spark_tpu_torch.ops import phasecorr as P
from bigstitcher_spark_tpu_torch.ops import solve as R

pytestmark = pytest.mark.cuda

FTYPES = F.FUSION_TYPES


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _per_view(rng, V, lo, hi):
    return torch.from_numpy(rng.uniform(lo, hi, (V, 3)).astype(np.float32))


def _shift_inputs(rng, V, bs):
    patches = torch.from_numpy(rng.integers(
        0, 4000, (V, *(s + 1 for s in bs))).astype(np.uint16))
    fr = _per_view(rng, V, 0, 1)
    lp = torch.from_numpy(rng.uniform(-20, 60, (V, 3)).astype(np.float32)) + fr
    dims = torch.from_numpy(np.tile(np.array([70, 60, 30], np.float32), (V, 1)))
    borders = _per_view(rng, V, 0, 3)
    ranges = _per_view(rng, V, 5, 30)
    valid = torch.from_numpy((np.arange(V) < V - 1).astype(np.float32))
    ioffs = _per_view(rng, V, 0, 2)
    return patches, fr, lp, dims, borders, ranges, valid, ioffs


@pytest.mark.parametrize("fusion_type", FTYPES)
def test_fuse_block_shift_kernel(dev, fusion_type):
    rng = np.random.default_rng(11)
    bs = (40, 36, 20)
    args = _shift_inputs(rng, 4, bs)
    ref = F.fuse_block_shift_plain(*args[:7], bs, fusion_type, args[7])
    got = F.fuse_block_shift(*(a.to(dev) for a in args[:7]), bs, fusion_type,
                             args[7].to(dev))
    torch.testing.assert_close(got[0].cpu(), ref[0], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[1].cpu(), ref[1], rtol=0, atol=1e-5)


_SHIFT_DTYPES = {"uint8": torch.uint8, "uint16": torch.uint16,
                 "float32": torch.float32}


def _as_patch_dtype(patches, dtype):
    """uint16 test patches (values below 4000) as ``dtype`` (uint8: mod
    256)."""
    if dtype == "uint8":
        return (patches.to(torch.int32) % 256).to(torch.uint8)
    return patches.to(_SHIFT_DTYPES[dtype])


@pytest.mark.parametrize("dtype", sorted(_SHIFT_DTYPES))
@pytest.mark.parametrize("bs", [(40, 36, 20), (37, 29, 13), (5, 3, 130)],
                         ids=lambda b: "x".join(map(str, b)))
@pytest.mark.parametrize("fusion_type", FTYPES)
def test_fuse_block_shift_kernel_bitwise_twin(dev, fusion_type, bs, dtype):
    """K2 per block (the staged-window design) against its twin on the
    card, with inside offsets, a switched-off view and views covering the
    block in part (images at least 40 voxels wide, so that the blend
    ramps leave weight): fused and wsum equal bit for bit; one launch."""
    rng = np.random.default_rng(13)
    args = list(_shift_inputs(rng, 4, bs))
    args[2] = torch.from_numpy(rng.uniform(-8, 8, (4, 3)).astype(
        np.float32)) + args[1]
    args[3] = torch.from_numpy(np.tile(np.maximum(
        np.array(bs, np.float32) + 2, 40), (4, 1)))
    args = [a.to(dev) for a in args]
    args[0] = _as_patch_dtype(args[0], dtype)
    ops.reset_launch_counts()
    got = F.fuse_block_shift(*args[:7], bs, fusion_type, args[7])
    assert ops.launch_counts()["fuse_block_shift"] == 1
    want = F.fuse_block_shift_plain(*args[:7], bs, fusion_type, args[7])
    assert float(want[1].max()) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", sorted(_SHIFT_DTYPES))
@pytest.mark.parametrize("bs,V", [((24, 20, 16), 3), ((9, 40, 70), 3),
                                  ((37, 29, 13), 9)],
                         ids=["small", "ragged", "ragged-V9"])
@pytest.mark.parametrize("fusion_type", FTYPES)
def test_fuse_block_shift_batch_bitwise_twin(dev, fusion_type, bs, V, dtype):
    """K2's batch form with a padding row (zero patches, valid 0) and a
    switched-off view: each row bitwise the per-block kernel, the padding
    row zeros, one launch; bitwise its twin on the card (a loop of the
    per-block twin) for V = 3. V = 9 stages the views in two rounds; there
    the twin's sums over the views (torch's reduction over 9) may round
    in another order, so the twin holds it to the fusion tolerance."""
    rng = np.random.default_rng(63)
    args, ioffs, _extra = _batch_case("shift", rng, 3, V, bs, None)
    args = [a.to(dev) for a in args]
    args[0] = _as_patch_dtype(args[0], dtype)
    ioffs = ioffs.to(dev)
    ops.reset_launch_counts()
    got = F.fuse_block_shift_batch(*args, bs, fusion_type, ioffs)
    assert ops.launch_counts()["fuse_block_shift_batch"] == 1
    for b in range(3):
        want = F.fuse_block_shift(*(a[b].contiguous() for a in args), bs,
                                  fusion_type, ioffs[b].contiguous())
        for g, w in zip(got, want):
            assert torch.equal(g[b], w), f"row {b}"
    assert not got[0][-1].any() and not got[1][-1].any()
    want = F.fuse_block_shift_batch_plain(*args, bs, fusion_type, ioffs)
    if V <= 4:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("fusion_type", FTYPES)
def test_fuse_block_gather_kernel(dev, fusion_type):
    rng = np.random.default_rng(12)
    V, bs, ps = 4, (32, 28, 16), (48, 40, 24)
    patches = torch.from_numpy(rng.uniform(0, 4000, (V, *ps)).astype(np.float32))
    aff = np.zeros((V, 3, 4), np.float32)
    for v in range(V):
        a = np.deg2rad(rng.uniform(-10, 10))
        aff[v, :3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                          [0, 0, 1]]
        aff[v, :, 3] = rng.uniform(-6, 12, 3)  # some samples fall outside
    args = (patches, torch.from_numpy(aff), _per_view(rng, V, 0, 30),
            torch.from_numpy(np.tile(np.array([60, 50, 30], np.float32),
                                     (V, 1))),
            _per_view(rng, V, 0, 3), _per_view(rng, V, 5, 30),
            torch.ones(V), _per_view(rng, V, 0, 2))
    ref = F.fuse_block_plain(*args[:7], bs, fusion_type, args[7])
    got = F.fuse_block(*(a.to(dev) for a in args[:7]), bs, fusion_type,
                       args[7].to(dev))
    torch.testing.assert_close(got[0].cpu(), ref[0], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[1].cpu(), ref[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("mirrored", [False, True], ids=["pos", "mirrored"])
@pytest.mark.parametrize("fusion_type", FTYPES)
def test_fuse_block_sep_kernel(dev, fusion_type, mirrored):
    rng = np.random.default_rng(15)
    V, bs, ps = 4, (32, 28, 16), (44, 40, 24)
    patches = torch.from_numpy(rng.integers(0, 4000, (V, *ps)).astype(
        np.uint16))
    diags = rng.uniform(0.6, 1.7, (V, 3)).astype(np.float32)
    diags[1, 2] = np.float32(1 / 3)
    ts = rng.uniform(-3, 6, (V, 3)).astype(np.float32)
    if mirrored:
        diags[0, 1] *= -1.0
        ts[0, 1] += ps[1]
    args = (patches, torch.from_numpy(diags), torch.from_numpy(ts),
            _per_view(rng, V, 0, 4),
            torch.from_numpy(np.tile(np.array(ps, np.float32) * 1.3, (V, 1))),
            _per_view(rng, V, 0, 3), _per_view(rng, V, 5, 20),
            torch.from_numpy((np.arange(V) < V - 1).astype(np.float32)),
            _per_view(rng, V, 0, 2))
    # the twin runs on the card too: its blend tables then come from the
    # card's cos, as the kernel's do (where every covering view sits on the
    # far tail of its ramp, a 1-ulp cos difference between the CPU and the
    # card moves acc / wsum past the tolerance)
    args = [a.to(dev) for a in args]
    ref = F.fuse_block_sep_plain(*args[:8], bs, fusion_type, args[8])
    got = F.fuse_block_sep(*args[:8], bs, fusion_type, args[8])
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)


def _sep_inputs(rng, V, bs, ps, kind):
    """K5 inputs over ``ps`` patches (uint16 values below 4000): "main"
    (route D's: diag_z 3, one view at 1/3, one mirrored on x), "mirror_y"
    or "flat" (a z extent of 1: the generic instantiation); images at
    least 40 wide (the blend ramps leave weight), each view's image
    starting at the block's middle column (the first columns outside
    every view), inside offsets, the last view switched off."""
    patches = torch.from_numpy(rng.integers(0, 4000, (V, *ps)).astype(
        np.uint16))
    diags = rng.uniform(0.7, 1.3, (V, 3)).astype(np.float32)
    ts = rng.uniform(-3, 4, (V, 3)).astype(np.float32)
    if kind == "main":
        diags[:, 2] = 3.0
        diags[min(1, V - 1), 2] = np.float32(1 / 3)
        diags[0, 0] = -1.0
        ts[0, 0] += ps[0] - 2
    elif kind == "mirror_y":
        diags[:, 1] *= -1.0
        ts[:, 1] += ps[1]
    offs = rng.uniform(-5, 10, (V, 3)).astype(np.float32)
    offs[:, 1] = -(diags[:, 1] * (bs[1] // 2) + ts[:, 1])
    dims = np.tile(np.maximum(np.array(ps, np.float32) * 1.3, 40), (V, 1))
    valid = (np.arange(V) < V - 1).astype(np.float32) if V > 1 else \
        np.ones(V, np.float32)
    return (patches, torch.from_numpy(diags), torch.from_numpy(ts),
            torch.from_numpy(offs), torch.from_numpy(dims),
            _per_view(rng, V, 0, 3), _per_view(rng, V, 5, 20),
            torch.from_numpy(valid), _per_view(rng, V, 0, 2))


_SEP_CASES = [("main", (40, 36, 20), (44, 40, 64)),
              ("main", (37, 29, 13), (40, 34, 42)),
              ("main", (5, 41, 130), (8, 46, 392)),
              ("mirror_y", (40, 36, 20), (44, 40, 24)),
              ("flat", (40, 36, 3), (44, 40, 1))]


@pytest.mark.parametrize("dtype", sorted(_SHIFT_DTYPES) + ["int16"])
@pytest.mark.parametrize("kind,bs,ps", _SEP_CASES,
                         ids=["d3", "d3-ragged", "d3-tall", "mirror-y",
                              "z-extent-1"])
@pytest.mark.parametrize("fusion_type", FTYPES)
def test_fuse_block_sep_kernel_bitwise_twin(dev, fusion_type, kind, bs, ps,
                                            dtype):
    """K5 per block (taps tabulated once a block, the fusion type a
    template parameter; the generic instantiation at a z extent of 1)
    against its twin on the card, 4 views: fused and wsum equal bit for
    bit, some voxels outside every view; one launch."""
    rng = np.random.default_rng(17)
    args = [a.to(dev) for a in _sep_inputs(rng, 4, bs, ps, kind)]
    args[0] = (_as_patch_dtype(args[0], dtype) if dtype != "int16"
               else (args[0].to(torch.int32) - 2000).to(torch.int16))
    ops.reset_launch_counts()
    got = F.fuse_block_sep(*args[:8], bs, fusion_type, args[8])
    assert ops.launch_counts()["fuse_block_sep"] == 1
    want = F.fuse_block_sep_plain(*args[:8], bs, fusion_type, args[8])
    assert float(want[1].max()) > 0 and float(want[1].min()) == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind,bs,ps,V", [("main", (24, 20, 16),
                                            (28, 24, 50), 3),
                                           ("main", (9, 40, 70),
                                            (12, 44, 212), 3),
                                           ("mirror_y", (37, 29, 13),
                                            (40, 33, 16), 9)],
                         ids=["small", "ragged", "mirror-y-V9"])
@pytest.mark.parametrize("fusion_type", FTYPES)
def test_fuse_block_sep_batch_bitwise_twin(dev, fusion_type, kind, bs, ps,
                                           V):
    """K5's batch form with a padding row (zero patches, valid 0): each
    row bitwise the per-block kernel, the padding row zeros, one launch;
    bitwise its twin on the card for V = 3. V = 9 tabulates the views in
    two stages; there the twin's sums over the views (torch's reduction
    over 9) may round in another order, so the twin holds it to the
    fusion tolerance."""
    rng = np.random.default_rng(64)
    rows = [_sep_inputs(rng, V, bs, ps, kind) for _ in range(3)]
    args = [torch.stack([r[k] for r in rows]).to(dev) for k in range(9)]
    args[0][-1] = 0
    args[7][-1] = 0
    ops.reset_launch_counts()
    got = F.fuse_block_sep_batch(*args[:8], bs, fusion_type, args[8])
    counts = ops.launch_counts()
    assert counts["fuse_block_sep_batch"] == 1
    assert counts["fuse_block_sep"] == 0
    for b in range(3):
        want = F.fuse_block_sep(*(a[b].contiguous() for a in args[:8]), bs,
                                fusion_type, args[8][b].contiguous())
        for g, w in zip(got, want):
            assert torch.equal(g[b], w), f"row {b}"
    assert not got[0][-1].any() and not got[1][-1].any()
    want = F.fuse_block_sep_batch_plain(*args[:8], bs, fusion_type, args[8])
    if V <= 4:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape,factors,dims", [
    ((25, 19, 11), (2, 2, 2), (12, 9, 5)),   # odd extents: crop
    ((56, 32, 6), (2, 2, 8), (28, 16, 1)),   # thin axis: edge pad
    ((20, 17, 9), (3, 1, 2), (6, 17, 4)),
], ids=str)
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float32"])
def test_downsample_level_kernel(dev, dtype, shape, factors, dims):
    rng = np.random.default_rng(16)
    prev = (rng.uniform(0, 4000, shape).astype(np.float32)
            if dtype == "float32" else
            rng.integers(0, 256 if dtype == "uint8" else 65536,
                         shape).astype(dtype))
    ref = D.downsample_level_plain(torch.from_numpy(prev), factors, dims, dtype)
    got = D.downsample_level(torch.from_numpy(prev).to(dev), factors, dims,
                             dtype).cpu()
    assert got.dtype == ref.dtype
    assert torch.equal(got, ref)


@pytest.mark.parametrize("factors", [(2, 2, 2), (2, 2, 1), (3, 1, 2)], ids=str)
def test_downsample_batch_kernel(dev, factors):
    rng = np.random.default_rng(17)
    raws = torch.from_numpy(rng.integers(0, 65536, (3, 24, 20, 16)).astype(
        np.uint16))
    ref = D.downsample_block_plain(raws, factors)
    got = D.downsample_batch(raws.to(dev), factors).cpu()
    assert got.dtype == torch.float32 and torch.equal(got, ref)
    assert torch.equal(D.downsample_block(raws[1].to(dev), factors).cpu(),
                       ref[1])


def _bits_equal(a, b) -> bool:
    """Same dtype, shape and bits (NaNs compare by their bits)."""
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def _k6_data(rng, shape, dtype):
    if dtype == np.float32:
        a = rng.normal(0, 1e3, shape).astype(np.float32)
        flat = a.reshape(-1)
        for step, v in ((7, 0.0), (11, -0.0), (13, 1e-30), (17, 1e-40),
                        (19, 3e38)):
            flat[::step] = v
        return torch.from_numpy(a)
    info = np.iinfo(dtype)
    return torch.from_numpy(rng.integers(info.min, info.max + 1,
                                         shape).astype(dtype))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16,
                                   np.float32], ids=str)
@pytest.mark.parametrize("factors", [(2, 2, 1), (4, 4, 2), (1, 1, 3)],
                         ids=str)
@pytest.mark.parametrize("Z", [45, 1, 132])
def test_downsample_kernel_forms(dev, Z, factors, dtype):
    """K6 bitwise against its twin at route D's row length (45: rows only
    2-byte aligned), a trailing size-1 axis (re-viewed) and the level's
    (132: 8-byte aligned uint16 rows): the batch form from an aligned base
    and from one element past it (element loads), where the box holds a
    window; the level form padding every thin axis (ceil dims) into uint16
    and float32; float32 inputs with signed zeros, denormals and sums that
    overflow."""
    rng = np.random.default_rng(Z + 7 * factors[0] + factors[2])
    shape = (3, 18, 10, Z)
    x = _k6_data(rng, shape, dtype)
    if Z >= factors[2]:
        ref = D.downsample_block_plain(x, factors)
        got = D.downsample_batch(x.to(dev), factors).cpu()
        assert _bits_equal(got, ref)
        flat = torch.zeros(x.numel() + 1, dtype=x.dtype)
        flat[1:] = x.reshape(-1)
        off = flat.to(dev)[1:].view(shape)
        assert _bits_equal(D.downsample_batch(off, factors).cpu(), ref)
    dims = tuple(-(-s // f) for s, f in zip(shape[1:], factors))
    for out_dtype in ("uint16", "float32"):
        ref = D.downsample_level_plain(x[1], factors, dims, out_dtype)
        got = D.downsample_level(x[1].to(dev), factors, dims, out_dtype)
        assert _bits_equal(got.cpu(), ref)


@pytest.mark.parametrize("out_dtype", ["uint8", "uint16", "float32"])
def test_convert_intensity_kernel(dev, out_dtype):
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.uniform(-100, 70000, (33, 17, 9)).astype(np.float32))
    x[0, 0, :3] = torch.tensor([0.5, 1.5, 2.5])  # round half to even
    ref = F.convert_intensity_plain(x, 0.0, 65535.0, out_dtype)
    got = F.convert_intensity(x.to(dev), 0.0, 65535.0, out_dtype).cpu()
    assert got.dtype == ref.dtype
    diff = (got.to(torch.float64) - ref.to(torch.float64)).abs().max()
    assert diff <= (1e-3 if out_dtype == "float32" else 1)


def _composite_case(rng, fusion_type, out_dtype, masks):
    out_shape = (64, 56, 24)
    tiles, windows, n_offs, kinds = [], [], [], []
    V = 4
    fr = np.zeros((V, 3), np.float32)
    dg = np.ones((V, 3), np.float32)
    of = np.zeros((V, 3), np.float32)
    ioc = 1 if masks else 0
    pad = (1 + ioc,) * 3
    for v in range(V):
        S = (40, 36, 20)
        tiles.append(torch.from_numpy(
            rng.integers(0, 4000, S).astype(np.uint16)))
        if v < 2:  # "shift"
            g = rng.uniform(-30, 5, 3)
            n = np.floor(g).astype(int)
            fr[v] = g - n
            a = [max(0, -n[d] - 1 - ioc) for d in range(3)]
            b = [min(out_shape[d], S[d] - n[d] + ioc) for d in range(3)]
            kinds.append("shift")
            n_offs.append(tuple(int(x) for x in n))
        else:  # "sep", sampling steps below and above 1
            dg[v] = rng.uniform(0.7, 1.4, 3)
            g = rng.uniform(-25, 5, 3)
            of[v] = g
            a = [int(max(0, np.floor((-1.0 - ioc - g[d]) / dg[v, d])))
                 for d in range(3)]
            b = [int(min(out_shape[d], np.ceil((S[d] + ioc - g[d]) / dg[v, d]) + 1))
                 for d in range(3)]
            kinds.append("sep")
            n_offs.append((0, 0, 0))
        windows.append((tuple(int(x) for x in a), tuple(int(x) for x in b)))
    kw = dict(out_shape=out_shape, windows=tuple(windows), n_offs=tuple(n_offs),
              pad=pad, fusion_type=fusion_type, out_dtype=out_dtype,
              masks=masks, kinds=tuple(kinds))
    dims = np.tile(np.array([40, 36, 20], np.float32), (V, 1))
    params = (fr, dims, rng.uniform(0, 2, (V, 3)).astype(np.float32),
              rng.uniform(5, 20, (V, 3)).astype(np.float32),
              np.full((V, 3), 0.5 if masks else 0.0, np.float32),
              0.0, 3000.0, dg, of)
    return tiles, params, kw


@pytest.mark.parametrize("fusion_type,out_dtype,masks", [
    *[(ft, "uint16", False) for ft in FTYPES],
    ("AVG_BLEND", "uint8", False), ("AVG_BLEND", "float32", False),
    ("AVG", "uint16", True),
])
def test_composite_kernel(dev, fusion_type, out_dtype, masks):
    rng = np.random.default_rng(14)
    tiles, params, kw = _composite_case(rng, fusion_type, out_dtype, masks)
    ref = F.composite_fuse_plain(tiles, *params, **kw)
    got = F.composite_fuse([t.to(dev) for t in tiles], *params, **kw).cpu()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    d = (got.to(torch.float64) - ref.to(torch.float64)).abs()
    if out_dtype == "float32":
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-3)
    else:
        assert d.max() <= 1


def test_launch_counts_and_no_cpu_fallback(dev):
    ops.reset_launch_counts()
    x = torch.zeros(10, device=dev)
    F.convert_intensity(x, 0.0, 1.0, "uint8")
    assert ops.launch_counts()["convert_intensity"] == 1
    with pytest.raises(ValueError):
        F.convert_intensity(x.to(torch.float64), 0.0, 1.0, "uint8")


def test_composite_sep_steep_kernel(dev):
    """K1's "sep" positions round once in the kernel as in its twin: over
    voxels of 0 or 65535, float32 output at rtol 1e-5 / atol 1e-3."""
    rng = np.random.default_rng(18)
    tiles, params, kw = _composite_case(rng, "AVG", "float32", False)
    tiles = [torch.from_numpy(rng.choice(np.array([0, 65535], np.uint16),
                                         tuple(t.shape))) for t in tiles]
    ref = F.composite_fuse_plain([t.to(dev) for t in tiles], *params, **kw)
    got = F.composite_fuse([t.to(dev) for t in tiles], *params, **kw)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-3)


def _crops(rng, B, shape, dtype):
    ext = np.array([[max(1, s - int(rng.integers(0, 4))) for s in shape]
                    for _ in range(B)], np.int32)
    x = np.zeros((B, *shape), np.float32)
    for k in range(B):
        e = ext[k]
        x[k, :e[0], :e[1], :e[2]] = rng.uniform(0, 4000, tuple(e))
    if dtype == "uint16":
        x = np.round(x).astype(np.uint16)
    return torch.from_numpy(x), torch.from_numpy(ext)


@pytest.mark.parametrize("shape", [(16, 32, 8), (8, 8, 1), (64, 4, 16)],
                         ids=str)
@pytest.mark.parametrize("dtype", ["uint16", "float32"])
def test_pcm_window_kernel(dev, shape, dtype):
    x, ext = _crops(np.random.default_rng(19), 3, shape, dtype)
    x, ext = x.to(dev), ext.to(dev)
    torch.testing.assert_close(P.pcm_window(x, ext),
                               P.pcm_window_plain(x, ext), rtol=1e-5,
                               atol=1e-6)


def _fft_close(got, ref):
    for k in range(got.shape[0]):
        bound = 2e-5 * float(ref[k].abs().max())
        assert float((got[k] - ref[k]).abs().max()) <= bound


@pytest.mark.parametrize("shape", [(2, 16, 32, 8), (1, 8, 8, 1),
                                   (1, 2, 1, 8192), (1, 8192, 1, 2),
                                   (3, 4, 1024, 2)], ids=str)
def test_fft_pow2_kernel(dev, shape):
    rng = np.random.default_rng(20)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    f = P.rfftn3(x)
    _fft_close(f, torch.fft.rfftn(x, dim=(1, 2, 3)))
    # a Hermitian spectrum: cuFFT's multi-dimensional c2r, unlike numpy's
    # (matched on the CPU), is not defined for others
    y = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    h = torch.fft.rfftn(y, dim=(1, 2, 3))
    ref = torch.fft.irfftn(h, s=shape[1:], dim=(1, 2, 3))
    _fft_close(P.irfftn3(h.clone(), shape[3]), ref)


FFT_LENGTHS = [1, 2, 4, 8, 16, 32, 512, 1024, 2048, 8192]


def _fft_max_close(got, ref):
    assert float((got - ref).abs().max()) <= 2e-5 * float(ref.abs().max())


@pytest.mark.parametrize("inner", [1, 3, 65])
@pytest.mark.parametrize("N", FFT_LENGTHS)
def test_fft_pow2_c2c_lengths(dev, N, inner):
    """One c2c pass at every radix remainder (16^a x 1, 2, 4 or 8) and
    inner counts that are not a multiple of the block's 16 lines: forward
    and inverse against torch.fft, in place equal to out of place, a
    rerun bitwise equal."""
    rng = np.random.default_rng(N + inner)
    outer = max(1, 4096 // (N * inner))
    x = torch.from_numpy((rng.normal(size=(outer, N, inner))
                          + 1j * rng.normal(size=(outer, N, inner)))
                         .astype(np.complex64)).to(dev)
    f = P.fft_pow2(x, 1, "c2c")
    _fft_max_close(f, torch.fft.fft(x, dim=1))
    assert torch.equal(P.fft_pow2(x, 1, "c2c"), f)
    g = P.fft_pow2(x, 1, "c2c", inverse=True, scale=0.5)
    _fft_max_close(g, 0.5 * torch.fft.ifft(x, dim=1, norm="forward"))
    y = x.clone()
    assert P.fft_pow2(y, 1, "c2c", out=y) is y
    assert torch.equal(y, f)


@pytest.mark.parametrize("N", FFT_LENGTHS)
def test_fft_pow2_real_lengths(dev, N):
    """r2c and c2r through the half-length transform at every length (N =
    1 and 2 included) against torch.fft, reruns bitwise equal."""
    rng = np.random.default_rng(40 + N)
    x = torch.from_numpy(rng.normal(size=(5, N)).astype(np.float32)).to(dev)
    f = P.fft_pow2(x, 1, "r2c")
    _fft_max_close(f, torch.fft.rfft(x, dim=-1))
    assert torch.equal(P.fft_pow2(x, 1, "r2c"), f)
    h = torch.fft.rfft(torch.from_numpy(
        rng.normal(size=(5, N)).astype(np.float32)).to(dev), dim=-1)
    y = P.fft_pow2(h, 1, "c2r", inverse=True, scale=0.25, n=N)
    _fft_max_close(y, 0.25 * torch.fft.irfft(h, n=N, dim=-1, norm="forward"))
    assert torch.equal(P.fft_pow2(h, 1, "c2r", inverse=True, scale=0.25,
                                  n=N), y)


def test_fft_pow2_refuses_longer_lines(dev):
    with pytest.raises(ValueError, match="8192"):
        P.fft_pow2(torch.zeros(1, 16384, dtype=torch.complex64, device=dev),
                   1, "c2c")


def test_pcm_cross_power_kernel(dev):
    rng = np.random.default_rng(21)
    shape = (2, 16, 8, 5)
    c = lambda: torch.from_numpy((rng.normal(size=shape) * 1e9 + 1j
                                  * rng.normal(size=shape) * 1e9).astype(
        np.complex64)).to(dev)
    fa, fb = c(), c()
    fa[0, :3] *= 1e-7
    got, ref = P.pcm_cross_power(fa, fb), P.pcm_cross_power_plain(fa, fb)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    assert int((ref == 0).sum()) > 0


@pytest.mark.parametrize("shape,n", [((16, 32, 8), 5), ((8, 8, 1), 9),
                                     ((64, 64, 32), 256), ((4, 4, 4), 64)],
                         ids=str)
def test_pcm_peaks_topk_kernel(dev, shape, n):
    rng = np.random.default_rng(22)
    pcm = torch.from_numpy(rng.integers(0, 50, (2, *shape)).astype(
        np.float32)).to(dev)  # integer values: many ties
    assert torch.equal(P.pcm_peaks_topk(pcm, n),
                       P.pcm_peaks_topk_plain(pcm, n))


def _spikes(shape, at, base=None):
    """(B, X, Y, Z) float32: a smooth periodic floor (one maximum a pair,
    at the origin, or ``base``) with spikes of 10 + k at the points ``at``
    (pair, x, y, z) -> local maxima exactly there and at the floor's."""
    B, X, Y, Z = shape
    g = np.meshgrid(*[np.cos(2 * np.pi * np.arange(s) / s) for s in
                      (X, Y, Z)], indexing="ij")
    floor = (sum(g) if base is None else base).astype(np.float32)
    pcm = np.repeat(floor[None], B, 0)
    for k, (b, x, y, z) in enumerate(at):
        pcm[b, x, y, z] = 10.0 + k
    return torch.from_numpy(pcm)


@pytest.mark.parametrize("case", ["one_block", "fewer_spread", "axis_1",
                                  "axis_2", "b5", "n256_ties",
                                  "after_skips"])
def test_pcm_peaks_topk_plans(dev, case):
    """K10's one-launch plan at its edges, bitwise its twin: every maximum
    of a pair inside one block's units (the others' lists hold only -inf
    keys); fewer maxima than n spread over blocks (the -inf fill by
    ascending index); axes of length 1 and 2 (the wrap lands on the voxel
    itself); B = 5 pairs; n = 256 on integer values (ties); at phase 1's
    bucket, spikes that set the threshold early, then, after planes the
    threshold lets pass untested, spikes beside lower ones in the same
    plane and the plane before (their 3x3 maxima taken afresh)."""
    rng = np.random.default_rng(24)
    if case == "one_block":
        shape, n = (2, 64, 64, 32), 9
        plan = P.peaks_plan(*shape, n, DS._sms(dev))
        assert plan.grid[0] > 8
        pcm = _spikes(shape, [(b, 1, 2 + 2 * k, 5) for b in range(2)
                              for k in range(3)])
    elif case == "fewer_spread":
        shape, n = (2, 64, 64, 32), 40
        pcm = _spikes(shape, [(b, x, y, 7) for b in range(2)
                              for x, y in ((5, 60), (33, 2), (60, 31))])
    elif case == "axis_1":
        shape, n = (3, 1, 48, 1), 20
        pcm = torch.from_numpy(rng.integers(0, 9, shape).astype(np.float32))
    elif case == "axis_2":
        shape, n = (2, 2, 33, 2), 17
        pcm = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    elif case == "b5":
        shape, n = (5, 16, 40, 24), 5
        pcm = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    elif case == "n256_ties":
        shape, n = (2, 32, 64, 130), 256
        pcm = torch.from_numpy(rng.integers(0, 40, shape).astype(np.float32))
    else:
        shape, n = (2, 64, 512, 128), 5
        x = rng.random(shape).astype(np.float32)
        for k in range(12):
            x[:, 1 + k % 3, 5 * k, 7 * k] = 5.0 + 0.01 * k
        for p in (20, 33, 61):
            x[:, p, 6, 10], x[:, p, 6, 11] = 9.5 + p * 1e-3, 9.4 + p * 1e-3
            x[:, p + 1, 9, 40], x[:, p, 9, 40] = 9.0, 8.9
        pcm = torch.from_numpy(x)
    pcm = pcm.to(dev)
    got = P.pcm_peaks_topk(pcm, n)
    assert torch.equal(got, P.pcm_peaks_topk_plain(pcm, n))
    assert torch.equal(P.pcm_peaks_topk(pcm, n), got)  # tickets reset


def test_pcm_peaks_batch_kernels(dev):
    """The composition: K7, K8, K9, K10 against the plain twins on the same
    stacks. The peaks are equal index by index, except where the two
    candidates' twin PCM values are within 1e-4 relative (a near tie that
    the FFTs' round-off may order either way); the first is the shift."""
    rng = np.random.default_rng(23)
    a, ext = _crops(rng, 2, (32, 64, 16), "uint16")
    b = torch.roll(a, (2, -3, 1), dims=(1, 2, 3))
    a, b, ext = a.to(dev), b.to(dev), ext.to(dev)
    ops.reset_launch_counts()
    got = P.pcm_peaks_batch(a, b, ext, ext, 5)
    counts = ops.launch_counts()
    ref, pcm = P.pcm_peaks_plain(a, b, ext, ext, 5, return_pcm=True)
    got, ref, pcm = got.cpu().numpy(), ref.cpu().numpy(), pcm.cpu().numpy()
    for k in range(2):
        assert tuple(got[k, 0]) == (30, 3, 15)
        for i in range(5):
            vg, vr = pcm[k][tuple(got[k, i])], pcm[k][tuple(ref[k, i])]
            assert (got[k, i] == ref[k, i]).all() or abs(vg - vr) <= 1e-4 * max(
                abs(vg), abs(vr))
    assert counts["pcm_window"] == 2 and counts["fft_pow2"] == 9
    assert counts["pcm_cross_power"] == 1 and counts["pcm_peaks_topk"] == 1


# ---------------------------------------------------------------- K11-K14


def _relax_graph(tmp_path, per_pair, grid=(3, 3, 2), seed=31):
    """An interest-point graph with rigid truth: (tiles, links, rows)."""
    from bigstitcher_spark_tpu_torch.io.interestpoints import (
        InterestPointStore)
    from bigstitcher_spark_tpu_torch.io.spimdata import SpimData
    from bigstitcher_spark_tpu_torch.models import solver as S
    from bigstitcher_spark_tpu_torch.utils.solverdata import make_ip_grid

    ip = make_ip_grid(str(tmp_path / "ip"), grid=grid, tile=(400, 400, 100),
                      n_per_pair=per_pair, max_deg=1.0, seed=seed)
    sd = SpimData.load(ip.xml_path)
    tiles = S.build_tiles(sd, sd.view_ids(), S.SolverParams(source="IP"))
    links = S.matches_from_interest_points(
        sd, tiles, InterestPointStore.for_project(sd), ["beads"],
        verbose=False)
    index = {k: i for i, k in enumerate(tiles)}
    rows = [(index[lk.key_a], index[lk.key_b], lk.p, lk.q, lk.w)
            for lk in links]
    return tiles, links, rows


def _relax_state(rows, T, dev, seed):
    rng = np.random.default_rng(seed)
    pr = R.prepare_relax(rows, T, dev)
    cur = np.eye(3, 4)[None].repeat(T, 0) + rng.normal(0, 1e-3, (T, 3, 4))
    cur[:, :, 3] = rng.uniform(-5, 5, (T, 3))
    mask = np.ones(len(rows))
    mask[1] = 0.0
    return (pr, torch.from_numpy(cur).to(dev),
            torch.from_numpy(mask).to(dev))


def _close(got, ref, rtol=1e-10, atol=1e-12):
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)


def _close_scaled(got, ref, scale, rtol=1e-10, atol=1e-12):
    """|got - ref| <= atol + rtol * scale elementwise, ``scale`` the sum of
    the absolute values of the terms behind each entry."""
    bad = (got - ref).abs() > atol + rtol * scale
    assert not bool(bad.any()), (
        f"{int(bad.sum())} entries off; max |delta| / scale "
        f"{float(((got - ref).abs() / scale.clamp(min=1e-300)).max()):.3g}")


def _composite_grid(rng, gap=False, empty=True, S=(20, 18, 28), cdims=None):
    """Nine translated uint16 tiles on a 3 x 3 grid (5 px overlap, or a
    2 px gap between the tiles, so that voxels are covered by no view),
    windows clipped at the volume's faces, the middle view's window empty
    (``empty``); with ``cdims`` intensity grids of that shape."""
    nx = ny = 3
    V, step = nx * ny, (S[0] + 2, S[1] + 2) if gap else (S[0] - 5, S[1] - 5)
    out_shape = (step[0] * 2 + S[0], step[1] * 2 + S[1], S[2] + 2)
    tiles, windows, n_offs = [], [], []
    fr = np.zeros((V, 3), np.float32)
    for v in range(V):
        ix, iy = divmod(v, ny)
        tiles.append(torch.from_numpy(
            rng.integers(0, 4000, S).astype(np.uint16)))
        g = rng.uniform(-0.5, 0.5, 3) - np.array([ix * step[0],
                                                  iy * step[1], 1.0])
        n = np.floor(g).astype(int)
        fr[v] = g - n
        a = [max(0, -n[d] - 1) for d in range(3)]
        b = [min(out_shape[d], S[d] - n[d]) for d in range(3)]
        if empty and v == V // 2:
            b = list(a)
        windows.append((tuple(int(x) for x in a), tuple(int(x) for x in b)))
        n_offs.append(tuple(int(x) for x in n))
    kw = dict(out_shape=out_shape, windows=tuple(windows),
              n_offs=tuple(n_offs), pad=(1, 1, 1), kinds=("shift",) * V)
    params = (fr, np.tile(np.array(S, np.float32), (V, 1)),
              rng.uniform(0, 2, (V, 3)).astype(np.float32),
              rng.uniform(3, 9, (V, 3)).astype(np.float32),
              np.zeros((V, 3), np.float32), 0.0, 3000.0,
              np.ones((V, 3), np.float32), np.zeros((V, 3), np.float32))
    cf = {}
    if cdims is not None:
        coeffs, affs = _coeff_inputs(rng, V, S, cdims)
        cf = dict(coeffs=coeffs, coeff_affs=affs)
    return tiles, params, kw, cf


@pytest.mark.parametrize("fusion_type,out_dtype,masks,gap,cdims", [
    ("AVG_BLEND", "float32", False, False, None),
    ("AVG", "uint16", False, False, None),
    ("MAX_INTENSITY", "float32", False, True, None),
    ("FIRST_WINS", "uint16", False, False, None),
    ("LAST_WINS", "uint8", False, True, None),
    ("AVG", "uint16", True, True, None),
    ("AVG_BLEND", "float32", False, False, (3, 4, 9)),
    ("MAX_INTENSITY", "uint16", False, True, (3, 4, 9)),
], ids=str)
def test_composite_grid_kernel(dev, fusion_type, out_dtype, masks, gap,
                               cdims):
    """K1 on nine views of a 3 x 3 grid: windows at the volume's faces, an
    empty window, voxels no view covers (gap), masks, coefficient grid
    cells of ~3 planes, fewer than a thread's 8 z outputs; one launch.
    uint |delta| <= 1, float32 rtol 1e-5 / atol 1e-3."""
    rng = np.random.default_rng(41)
    tiles, params, kw, cf = _composite_grid(rng, gap, cdims=cdims)
    tiles = [t.to(dev) for t in tiles]
    cf = {k: (v.to(dev) if k == "coeffs" else v) for k, v in cf.items()}
    kw.update(fusion_type=fusion_type, out_dtype=out_dtype, masks=masks)
    ref = F.composite_fuse_plain(tiles, *params, **kw, **cf)
    ops.reset_launch_counts()
    got = F.composite_fuse(tiles, *params, **kw, **cf)
    assert ops.launch_counts()["composite_fuse"] == 1
    assert ops.coeff_launch_counts()["composite_fuse+coeff"] == (
        cdims is not None)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if out_dtype == "float32":
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-3)
    else:
        d = (got.to(torch.float64) - ref.to(torch.float64)).abs()
        assert d.max() <= 1
    if gap:
        assert bool((ref == 0).any()), "some voxels lie outside every view"


def _fit_moments(rng, T):
    """Moments (T, 36) of weighted noisy rigid maps (every third one a
    reflection) about each tile's origin; tile 5 empty, tile 7 sw < 0."""
    mom = np.zeros((T, R.N_MOMENTS))
    for t in range(T):
        p = rng.uniform(-50, 50, (30, 3)) * rng.uniform(0.05, 1.0, 3)
        refl = np.diag([1.0, 1.0, -1.0]) if t % 3 == 1 else np.eye(3)
        q = (p @ (refl @ np.linalg.qr(rng.normal(size=(3, 3)))[0]).T
             + rng.normal(0, 0.5, p.shape) + rng.uniform(-20, 20, 3))
        w = rng.uniform(0.5, 2.0, 30)
        ph = np.c_[p, np.ones(30)]
        mom[t, 0] = w.sum()
        mom[t, 1:5] = (w[:, None] * ph).sum(0)
        mom[t, 5:8] = (w[:, None] * q).sum(0)
        mom[t, 8:24] = (ph.T @ (w[:, None] * ph)).ravel()
        mom[t, 24:36] = (ph.T @ (w[:, None] * q)).ravel()
    mom[5] = 0.0
    mom[7, 0] = -1.0
    return mom


@pytest.mark.parametrize("T", [45, 70])
def test_relax_fit_pairs_kernel(dev, T):
    """K12 for every (model, regulariser) pair the solver CLI accepts, T not
    a multiple of its 32-tile blocks, tiles with sw <= 0 and a fixed tile:
    models within rtol 1e-10 (of fit_scale) / atol 1e-12 of the twin; with
    the done flag set nothing is written."""
    rng = np.random.default_rng(T)
    mom = torch.from_numpy(_fit_moments(rng, T)).to(dev)
    origin = torch.from_numpy(rng.uniform(-5, 5, (T, 3))).to(dev)
    fixed = torch.zeros(T, dtype=torch.uint8, device=dev)
    fixed[2] = 1
    cur0 = torch.from_numpy(np.eye(3, 4)[None].repeat(T, 0)
                            + rng.normal(0, 0.01, (T, 3, 4))).to(dev)
    done = torch.tensor([0, 0, 1, 0], dtype=torch.int32, device=dev)
    for model in ("TRANSLATION", "RIGID", "AFFINE"):
        for reg in ("NONE", "IDENTITY", "TRANSLATION", "RIGID", "AFFINE"):
            got = R.relax_fit(mom, fixed, origin, model, reg, 0.1, 0.7, None,
                              cur0.clone())
            ref = R.relax_fit_plain(mom, fixed, origin, model, reg, 0.1, 0.7,
                                    None, cur0.clone())
            _close_scaled(got, ref, R.fit_scale(ref, origin))
            for t in (2, 5, 7):  # fixed and empty tiles step to identity
                _close(got[t], 0.3 * cur0[t] + 0.7 * torch.eye(
                    3, 4, dtype=torch.float64, device=dev))
            kept = cur0.clone()
            R.relax_fit(mom, fixed, origin, model, reg, 0.1, 0.7, done, kept)
            assert torch.equal(kept, cur0), "a launch after done writes"


@pytest.mark.parametrize("per_pair", [20, 3000], ids=["warp", "block"])
def test_relax_moments_kernel(dev, tmp_path, per_pair):
    _, _, rows = _relax_graph(tmp_path, per_pair)
    pr, cur, lw = _relax_state(rows, 18, dev, 1)
    assert pr.wpt_tile == (1 if per_pair == 20 else 8)
    o = R.tile_origin(pr, lw)
    _close_scaled(R.relax_moments(pr, cur, lw, o),
                  R.relax_moments_plain(pr, cur, lw, o),
                  R.moment_scale(pr, cur, lw, o))
    done = torch.tensor([1, 0, 1, 0], dtype=torch.int32, device=dev)
    out = torch.full((18, R.N_MOMENTS), 7.0, dtype=torch.float64, device=dev)
    R.relax_moments(pr, cur, lw, o, done, out=out)
    assert bool((out == 7.0).all()), "a kernel launched after done returns"


@pytest.mark.parametrize("model,reg", [
    ("TRANSLATION", "NONE"), ("RIGID", "NONE"), ("AFFINE", "NONE"),
    ("AFFINE", "RIGID"), ("RIGID", "TRANSLATION"), ("TRANSLATION", "IDENTITY"),
])
def test_relax_fit_kernel(dev, tmp_path, model, reg):
    _, _, rows = _relax_graph(tmp_path, 40)
    pr, cur, lw = _relax_state(rows, 18, dev, 2)
    o = R.tile_origin(pr, lw)
    mom = R.relax_moments_plain(pr, cur, lw, o)
    mom[3] = 0.0  # a tile without matches keeps identity
    fixed = torch.zeros(18, dtype=torch.uint8, device=dev)
    fixed[0] = 1
    got = R.relax_fit(mom, fixed, o, model, reg, 0.1, 0.7, None, cur.clone())
    ref = R.relax_fit_plain(mom, fixed, o, model, reg, 0.1, 0.7, None,
                            cur.clone())
    _close_scaled(got, ref, R.fit_scale(ref, o))


def test_relax_fit_rigid_reflection_kernel(dev):
    """Point sets whose best orthogonal map is a reflection: the kernel's
    sorted SVD flips the smallest singular direction, as LAPACK's order
    makes the JAX code do."""
    rng = np.random.default_rng(33)
    T = 64
    mom = np.zeros((T, R.N_MOMENTS))
    for t in range(T):
        p = rng.uniform(0, 100, (30, 3)) * rng.uniform(0.05, 1.0, 3)
        refl = np.diag([1.0, 1.0, -1.0]) if t % 2 else np.eye(3)
        q = p @ (refl @ np.linalg.qr(rng.normal(size=(3, 3)))[0]).T
        q = q + rng.normal(0, 0.5, q.shape)
        ph = np.c_[p, np.ones(30)]
        mom[t, 0] = 30
        mom[t, 1:5] = ph.sum(0)
        mom[t, 5:8] = q.sum(0)
        mom[t, 8:24] = (ph.T @ ph).ravel()
        mom[t, 24:36] = (ph.T @ q).ravel()
    mom = torch.from_numpy(mom).to(dev)
    fixed = torch.zeros(T, dtype=torch.uint8, device=dev)
    cur = torch.zeros((T, 3, 4), dtype=torch.float64, device=dev)
    origin = torch.zeros((T, 3), dtype=torch.float64, device=dev)
    got = R.relax_fit(mom, fixed, origin, "RIGID", "NONE", 0.0, 1.0, None,
                      cur.clone())
    ref = R.relax_fit_plain(mom, fixed, origin, "RIGID", "NONE", 0.0, 1.0,
                            None, cur.clone())
    _close(got, ref, rtol=1e-9, atol=1e-9)
    det = torch.linalg.det(got[:, :, :3])
    _close(det, torch.ones_like(det), rtol=0, atol=1e-12)


@pytest.mark.parametrize("per_pair", [20, 3000], ids=["warp", "block"])
def test_relax_error_kernel(dev, tmp_path, per_pair):
    _, _, rows = _relax_graph(tmp_path, per_pair)
    pr, cur, lw = _relax_state(rows, 18, dev, 3)
    for by_link in (False, True):
        got = R.relax_error(pr, cur, lw, None, by_link)
        ref = R.relax_error_plain(pr, cur, lw, None, by_link)
        _close(got[0], ref[0])
        _close(got[1], ref[1])


@pytest.mark.parametrize("case", ["stall", "plateau", "cap"])
def test_relax_converge_kernel(dev, case):
    k = np.arange(400, dtype=np.float64)
    errs = {"stall": np.minimum(10.0 / (1 + k), 10.0 / 41),
            "plateau": 1.0 + 0.5 * np.exp(-k / 10.0),
            "cap": 3.0 + 1e-3 * np.cos(k) - 1e-4 * k}[case]
    T, pw, cap = 300, 20, 250
    rng = np.random.default_rng(34)
    share = rng.uniform(0.1, 1.0, T)
    sides = []
    for d in (dev, torch.device("cpu")):
        hist = torch.zeros(cap, dtype=torch.float64, device=d)
        state = torch.zeros(4, dtype=torch.int32, device=d)
        for e in errs:
            num = torch.from_numpy(share * e).to(d)
            den = torch.from_numpy(share.copy()).to(d)
            R.relax_converge(num, den, hist, state, pw, 5.0, cap)
        sides.append((state.cpu(), hist.cpu()))
    (s_dev, h_dev), (s_cpu, h_cpu) = sides
    assert torch.equal(s_dev, s_cpu) and int(s_dev[2]) == 1
    _close(h_dev, h_cpu)


@pytest.mark.parametrize("model,reg", [
    ("TRANSLATION", "NONE"), ("AFFINE", "RIGID"), ("RIGID", "TRANSLATION"),
])
def test_relax_on_device_matches_plain(dev, tmp_path, model, reg):
    tiles, links, rows = _relax_graph(tmp_path, 60)
    T = len(tiles)
    pr = R.prepare_relax(rows, T, dev)
    fixed = np.zeros(T, bool)
    fixed[0] = True
    warm = np.random.default_rng(35).uniform(-2, 2, (T, 3))
    warm[0] = 0.0
    mask = np.ones(len(rows))
    mask[2] = 0.0
    args = (pr, mask, fixed, warm, 0.1, 1.0, 5.0, 300, model, reg, 40)
    ops.reset_launch_counts()
    got = R.relax_on_device(*args)
    counts = ops.launch_counts()
    ref = R.relax_plain(*args)
    assert got.iterations == ref.iterations > 0
    np.testing.assert_allclose(got.history, ref.history, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.models, ref.models, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(got.link_errors, ref.link_errors, rtol=1e-7,
                               atol=1e-9)
    # chunks of 8, 16, 32, ... iterations; the last chunk may run past done.
    # K14 runs in the last block of K13's fused form; K13 alone once, for
    # the link errors
    assert counts["relax_error_converge"] >= got.iterations
    assert counts["relax_converge"] == 0
    assert counts["relax_moments"] == counts["relax_fit"] == \
        counts["relax_error_converge"]
    assert counts["relax_error"] == 1
    # a rerun repeats bit for bit (no atomics)
    again = R.relax_on_device(*args)
    assert np.array_equal(again.models, got.models)
    assert np.array_equal(again.history, got.history)


def _tile_problem(T, wpt, dev, seed, rows_per_tile=24):
    """A relax problem of T tiles on synthetic rows (tile 1 without rows
    where T > 3), K13's tile segments taken by ``wpt`` warps; models near
    identity and link weights."""
    rng = np.random.default_rng(seed)
    n = T * rows_per_tile
    own = rng.integers(0, T, n)
    if T > 3:
        own[own == 1] = 0
    L = max(T // 2, 1)
    local = rng.uniform(-500, 500, (n, 3))
    target = local + rng.normal(0, 0.5, (n, 3))
    pr = R._layout(local, target, own, rng.integers(0, T, n),
                   rng.uniform(0.1, 1.0, n), rng.integers(0, L, n),
                   rng.random(n) < 0.5, T, L, dev, (wpt, 1))
    cur = torch.from_numpy(np.eye(3, 4)[None].repeat(T, 0)
                           + rng.normal(0, 1e-4, (T, 3, 4))).to(dev)
    return pr, cur, torch.from_numpy(rng.uniform(0.5, 1.0, L)).to(dev)


# K14's state before a launch: (iteration i, stall count, hist[:i] as a
# function of the launch's error) -> done after it
_K14_CASES = {
    "fresh": (0, 0, None, 0),
    "stall fires": (50, 4, lambda e: e, 1),
    "stall resets": (50, 4, lambda e: e + 1.0, 0),
    "plateau fires": (50, 0, lambda e: e, 1),
    "plateau misses": (50, 0, lambda e: e + 1.0 + np.arange(50.0)[::-1],
                       0),
    "cap fires": (99, 0, lambda e: e + 10.0, 1),
    "done": (7, 0, None, None),
}


@pytest.mark.parametrize("T", [1, 31, 256, 257, 512, 4096])
@pytest.mark.parametrize("wpt", [1, 2, 4, 8])
def test_relax_error_converge_kernel(dev, T, wpt):
    """K13's fused form (K14 in its last block) bitwise K13 then K14 on the
    card: num, den, history and state, from states before and after the
    stall, plateau and cap rules fire, at plateau widths 1 and 40; the
    state equal to the twins' and the sums and history within rtol 1e-10;
    after done nothing is written and the ticket stays 0; two launches in a
    row leave the ticket at 0."""
    pr, cur, lw = _tile_problem(T, wpt, dev, T + wpt)
    f64 = dict(dtype=torch.float64, device=dev)
    cap = 100
    num_p, den_p = R.relax_error_plain(pr, cur, lw)
    err = float(num_p.sum() / den_p.sum())
    assert err < 5.0
    for pw in (1, 40):
        for case, (i, stall, before, want) in _K14_CASES.items():
            hist0 = torch.full((cap,), 3.0, **f64)
            if before is not None:
                hist0[:i] = torch.as_tensor(before(err) * np.ones(i), **f64)
            state0 = torch.tensor([i, stall, int(case == "done"), 0],
                                  dtype=torch.int32, device=dev)
            nd0 = torch.full((2, T), 7.0, **f64)
            sides = []
            for form in ("fused", "pair", "twins"):
                hist, state, nd = hist0.clone(), state0.clone(), nd0.clone()
                ticket = torch.zeros(1, dtype=torch.int32, device=dev)
                ops.reset_launch_counts()
                if form == "fused":
                    R.relax_error_converge(pr, cur, lw, state, (nd[0], nd[1]),
                                           hist, ticket, pw, 5.0, cap)
                    assert ops.launch_counts()["relax_error_converge"] == 1
                elif form == "pair":
                    R.relax_error(pr, cur, lw, state, out=(nd[0], nd[1]))
                    R.relax_converge(nd[0], nd[1], hist, state, pw, 5.0, cap)
                else:
                    R.relax_error_converge_plain(pr, cur, lw, state,
                                                 (nd[0], nd[1]), hist, None,
                                                 pw, 5.0, cap)
                assert int(ticket) == 0
                sides.append((nd, hist, state))
            (nd, hist, state), (nd2, hist2, state2), (nd3, hist3, state3) = \
                sides
            what = f"{case} pw {pw}"
            assert torch.equal(nd, nd2) and torch.equal(hist, hist2), what
            assert torch.equal(state, state2), what
            assert torch.equal(state, state3), what
            if want is None:
                assert torch.equal(state, state0) and torch.equal(nd, nd0)
                assert torch.equal(hist, hist0), what
                continue
            assert int(state[2]) == want and int(state[0]) == i + 1, what
            _close(nd, nd3)
            _close(hist, hist3)
    # two launches in a row: both counted, the ticket back at 0
    hist = torch.zeros(cap, **f64)
    state = torch.zeros(4, dtype=torch.int32, device=dev)
    nd = torch.empty((2, T), **f64)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    for _ in range(2):
        R.relax_error_converge(pr, cur, lw, state, (nd[0], nd[1]), hist,
                               ticket, 40, 5.0, cap)
    assert state.tolist()[:1] == [2] and int(ticket) == 0


@pytest.mark.parametrize("S", [1, 2, 4, 8, 64])
def test_relax_sharded_forms_kernel(dev, S):
    """K12's and K14's sharded forms (the shards' partials added as they
    load them) on partials of a [cuda:0] * S mesh: bitwise K29 then K12,
    and K29 then K14, each one launch and no K29; within rtol 1e-10 of
    the twins; after done nothing is written."""
    from bigstitcher_spark_tpu_torch.ops import shard as K

    T = 512
    rng = np.random.default_rng(S)
    share = rng.dirichlet(np.ones(S))
    base = _fit_moments(rng, T)
    parts = [torch.from_numpy(base * c).to(dev) for c in share]
    origin = torch.from_numpy(rng.uniform(-5, 5, (T, 3))).to(dev)
    fixed = torch.zeros(T, dtype=torch.uint8, device=dev)
    fixed[2] = 1
    cur0 = torch.from_numpy(np.eye(3, 4)[None].repeat(T, 0)
                            + rng.normal(0, 0.01, (T, 3, 4))).to(dev)
    mom = torch.empty((T, R.N_MOMENTS), dtype=torch.float64, device=dev)
    K.shard_sum(parts, mom)
    for model, reg in (("AFFINE", "RIGID"), ("TRANSLATION", "NONE"),
                       ("RIGID", "AFFINE")):
        ref = R.relax_fit(mom, fixed, origin, model, reg, 0.1, 0.7, None,
                          cur0.clone())
        ops.reset_launch_counts()
        got = R.relax_fit(parts, fixed, origin, model, reg, 0.1, 0.7, None,
                          cur0.clone())
        counts = ops.launch_counts()
        assert counts["relax_fit"] == 1 and counts["shard_sum"] == 0
        assert torch.equal(got, ref), (model, reg)
        twin = R.relax_fit_plain(parts, fixed, origin, model, reg, 0.1, 0.7,
                                 None, cur0.clone())
        _close_scaled(got, twin, R.fit_scale(twin, origin))
        kept = cur0.clone()
        R.relax_fit(parts, fixed, origin, model, reg, 0.1, 0.7,
                    torch.tensor([0, 0, 1, 0], dtype=torch.int32,
                                 device=dev), kept)
        assert torch.equal(kept, cur0), "a launch after done writes"
    # K14: 60 launches of the stall-limited error sequence
    T, cap = 300, 100
    k = np.arange(cap, dtype=np.float64)
    errs = np.maximum(10.0 / (1 + k), 10.0 / 41)
    sides = []
    for form in ("sharded", "pair", "twin"):
        hist = torch.zeros(cap, dtype=torch.float64, device=dev)
        state = torch.zeros(4, dtype=torch.int32, device=dev)
        ops.reset_launch_counts()
        for j, e in enumerate(errs[:60]):
            g = np.random.default_rng(j)
            share = torch.from_numpy(g.uniform(0.1, 1.0, (S, T))).to(dev)
            num = [share[d] * e for d in range(S)]
            den = [share[d].clone() for d in range(S)]
            if form == "sharded":
                R.relax_converge(num, den, hist, state, 40, 5.0, cap)
            elif form == "pair":
                nd = torch.empty((2, T), dtype=torch.float64, device=dev)
                K.shard_sum([torch.stack([a, b]) for a, b in zip(num, den)],
                            nd)
                R.relax_converge(nd[0], nd[1], hist, state, 40, 5.0, cap)
            else:
                R.relax_converge_plain(num, den, hist, state, 40, 5.0, cap)
        if form == "sharded":
            counts = ops.launch_counts()
            assert counts["relax_converge"] == 60 and counts["shard_sum"] == 0
        sides.append((hist, state))
    (h, st), (h2, st2), (h3, st3) = sides
    assert torch.equal(h, h2) and torch.equal(st, st2)
    assert torch.equal(st, st3) and int(st[2]) == 1
    _close(h, h3)
    kept = h.clone()
    R.relax_converge(num, den, h, st, 40, 5.0, cap)
    assert torch.equal(h, kept), "a launch after done writes"


# --------------------------------------------------------------- K15-K18


def _beads(rng, B, shape, n=12, amp=900.0, dtype=np.float32):
    """B volumes of Gaussian beads (sigma 1.8) on a noisy background."""
    grid = np.meshgrid(*(np.arange(s, dtype=np.float32) for s in shape),
                       indexing="ij")
    out = np.empty((B, *shape), np.float32)
    for b in range(B):
        v = rng.normal(100.0, 3.0, shape).astype(np.float32)
        for p in rng.uniform(0, np.array(shape) - 1, (n, 3)):
            r2 = sum((g - c) ** 2 for g, c in zip(grid, p))
            v += amp * np.exp(-r2 / (2 * 1.8 ** 2)).astype(np.float32)
        out[b] = v
    if dtype != np.float32:
        info = np.iinfo(dtype)
        out = np.clip(np.round(out), info.min, info.max).astype(dtype)
    return torch.from_numpy(out)


def _cand_sets(cand_idx, cand_score, count):
    out = []
    for b, n in enumerate(count.tolist()):
        i = cand_idx[b, :n].cpu().numpy()
        s = cand_score[b, :n].cpu().numpy()
        o = np.argsort(i)
        out.append((i[o], s[o]))
    return out


BLUR_DTYPES = [np.uint8, np.uint16, np.int16, np.float32]


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("dtype", BLUR_DTYPES, ids=str)
def test_dog_blur_kernel(dev, axis, dtype):
    """K15 and its twin take the same products and sums in the same order:
    bitwise equal, also where the mirror repeats (a 5-voxel axis under a
    15-tap kernel)."""
    x = _beads(np.random.default_rng(40), 2, (37, 29, 5), dtype=dtype).to(dev)
    for sigma in (1.8, 1.8 * G.DOG_K):
        taps = G.gaussian_kernel_1d(sigma)
        got, ref = G.dog_blur(x, taps, axis), G.blur_plain(x, taps, axis)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("shape", [(1, 2, 3), (2, 1, 17), (3, 19, 1),
                                   (17, 33, 23), (5, 21, 600),
                                   (40, 3, 129)], ids=str)
@pytest.mark.parametrize("dtype", BLUR_DTYPES, ids=str)
def test_dog_blur_kernel_shapes(dev, shape, dtype):
    """K15's forms (run: radii 6 and 7 along x, y, and radii taken at run
    time, sigma 0.9 and 5.5 (r 3 and 17: one and three register blocks of
    the sliding window); row: z, one chunk or two, the same radii) bitwise
    equal to the twin on shapes that are no multiple of the run (16) or
    the line block (128), on axes of length 1 and 2 and shorter than r,
    for every input type."""
    x = _beads(np.random.default_rng(sum(shape)), 2, shape, n=3,
               dtype=dtype).to(dev)
    for sigma in (1.8, 1.8 * G.DOG_K, 0.9, 5.5):
        taps = G.gaussian_kernel_1d(sigma)
        for axis in range(3):
            got, ref = G.dog_blur(x, taps, axis), G.blur_plain(x, taps, axis)
            assert torch.equal(got, ref), (sigma, axis)


@pytest.mark.parametrize("shape", [(3, 2, 7), (2, 3, 40)], ids=str)
@pytest.mark.parametrize("dtype", [np.uint16, np.float32], ids=str)
def test_dog_blur_kernel_long_radius(dev, shape, dtype):
    """A radius past the row form's chunk (sigma 161: r = 483) takes z in
    the run form at run time, bitwise equal to the twin, the mirror
    repeating many times over the short axis."""
    x = _beads(np.random.default_rng(sum(shape)), 2, shape, n=3,
               dtype=dtype).to(dev)
    taps = G.gaussian_kernel_1d(161.0)
    assert G.blur_plan(2, *shape, 2, taps.size // 2).route == "run"
    got, ref = G.dog_blur(x, taps, 2), G.blur_plain(x, taps, 2)
    assert torch.equal(got, ref)


# K16's tile walk: a whole-z tile as float4s (40, 36, 28), Z % 4 != 0
# (the scalar path), X of 1 and 2, y tiles that do not divide Y, z cut into
# tiles on both paths (130: scalar, 300: float4s), several x chunks
DOG_EXTREMA_SHAPES = [(40, 36, 28), (40, 36, 27), (1, 40, 44), (2, 41, 43),
                      (9, 45, 130), (3, 70, 300)]


def _dog_extrema_case(dev, shape, find_min_only, seed=41):
    rng = np.random.default_rng(seed)
    x = _beads(rng, 3, shape, n=max(12, int(np.prod(shape)) // 4000)).to(dev)
    if find_min_only:
        x = 2000.0 - x
    b1, b2 = G._blurs(G.KERNELS, x, 1.8)
    scale = G.dog_scale(torch.zeros(3, device=dev),
                        torch.tensor([1200.0, 1200.0, 5.0], device=dev))
    thr = torch.tensor([0.005, 0.002, 0.005], device=dev)
    org = torch.tensor([[-9, -9, -9], [512, -9, 120], [0, 0, 0]],
                       dtype=torch.int32, device=dev)
    return b1, b2, scale, thr, org


def _dog_extrema_agree(args):
    dog, mask = G.dog_extrema(*args)
    pdog, pmask = G.extrema_plain(*args)
    assert torch.equal(dog, pdog) and torch.equal(mask, pmask)
    got = G.dog_extrema(*args, candidates=True)
    ref = G.extrema_plain(*args, candidates=True)
    assert torch.equal(got[0], pdog)
    gs, rs = _cand_sets(*got[1:]), _cand_sets(*ref[1:])
    for (gi, gsc), (ri, rsc) in zip(gs, rs):
        assert np.array_equal(gi, ri) and np.array_equal(gsc, rsc)
    assert got[3].tolist() == ref[3].tolist() == [int(m.sum()) for m in mask]
    return mask


@pytest.mark.parametrize("shape", DOG_EXTREMA_SHAPES, ids=str)
@pytest.mark.parametrize("find_max,find_min", [(True, False), (False, True),
                                               (True, True)])
@pytest.mark.parametrize("halo", [0, 5])
def test_dog_extrema_kernel(dev, shape, find_max, find_min, halo):
    """K16 against its twin: the response bitwise, the dense mask equal,
    the candidate lists equal as sets (the kernel's order is its warps'
    atomics) with |dog| scores and exact counts; origins straddle zero
    (negative hashes); B = 3, at each of the tile walk's edge shapes."""
    args = (*_dog_extrema_case(dev, shape, find_min and not find_max),
            find_max, find_min, halo)
    mask = _dog_extrema_agree(args)
    if min(shape) > 2 * halo + 2:
        assert int(mask.sum()) > 3


def test_dog_extrema_kernel_unaligned(dev):
    """Arrays not 16-byte aligned take the scalar path, Z % 4 == 0 or not
    (the plan's ``vec`` from their addresses), with the same results."""
    shape = (6, 40, 44)
    b1, b2, scale, thr, org = _dog_extrema_case(dev, shape, False)
    n = b1.numel()
    off = [torch.empty(n + 1, device=dev) for _ in range(2)]
    u1, u2 = (o[1:].view(b.shape) for o, b in zip(off, (b1, b2)))
    u1.copy_(b1)
    u2.copy_(b2)
    assert not G.extrema_plan(3, *shape, addr=u1.data_ptr()).vec
    for fmax, fmin in ((True, False), (True, True)):
        _dog_extrema_agree((u1, u2, scale, thr, org, fmax, fmin, 1))


@pytest.mark.parametrize("n,k", [(0, 16), (7, 16), (900, 4), (50_000, 4096),
                                 (20_000, 8192)], ids=str)
def test_dog_topk_kernel(dev, n, k):
    """K17 against its twin on shuffled lists: the K best by (score
    descending, index ascending), whatever the count; block 0's scores are
    full of ties, block 1's distinct, and there the index set equals
    torch.topk's on the dense score."""
    rng = np.random.default_rng(42)
    shape = (64, 64, 32)
    vol = int(np.prod(shape))
    cand_idx = torch.zeros((2, vol), dtype=torch.int32)
    cand_score = torch.zeros((2, vol), dtype=torch.float32)
    counts = [n, n // 2]
    for b, m in enumerate(counts):
        cand_idx[b, :m] = torch.from_numpy(rng.permutation(vol)[:m].astype(
            np.int32))
        score = (rng.integers(1, 60, m) if b == 0 else rng.permutation(m) + 1)
        cand_score[b, :m] = torch.from_numpy(score.astype(np.float32) * 0.01)
    count = torch.tensor(counts, dtype=torch.int32)
    args = [t.to(dev) for t in (cand_idx, cand_score, count)]
    idx, valid = G.dog_topk(*args, k, shape)
    pidx, pvalid = G.topk_plain(*args, k, shape)
    assert torch.equal(idx, pidx) and torch.equal(valid, pvalid)
    assert valid.sum(1).tolist() == [min(k, m) for m in counts]
    dense = torch.full((vol,), -np.inf, device=dev)
    dense[args[0][1, :counts[1]].long()] = args[1][1, :counts[1]]
    top = torch.topk(dense, k)
    flat = (idx[1, :, 0] * shape[1] + idx[1, :, 1]) * shape[2] + idx[1, :, 2]
    assert set(flat[valid[1]].tolist()) == set(
        top.indices[top.values > -np.inf].tolist())


@pytest.mark.parametrize("case", ["count_0", "count_k", "count_k_plus_1",
                                  "ties_at_k"])
def test_dog_topk_counts(dev, case):
    """K17 around k (600: three blocks a list) against its twin: no
    candidate, exactly k, k + 1 (the truncation path), and more than k
    with the k-th score tied among entries far apart in the list (in
    different blocks' shares), where the lower flat indices win."""
    rng = np.random.default_rng(45)
    shape, k = (48, 40, 32), 600
    vol = int(np.prod(shape))
    counts = {"count_0": [0, 0], "count_k": [k, k - 1],
              "count_k_plus_1": [k + 1, k], "ties_at_k": [3000, 1700]}[case]
    cand_idx = torch.zeros((2, vol), dtype=torch.int32)
    cand_score = torch.zeros((2, vol), dtype=torch.float32)
    for b, m in enumerate(counts):
        cand_idx[b, :m] = torch.from_numpy(rng.permutation(vol)[:m].astype(
            np.int32))
        score = rng.permutation(m) + 1.0
        if case == "ties_at_k":  # 500 above, then 400 equal, spread out
            score = np.full(m, 7.0)
            top = rng.permutation(m)
            score[top[:500]] = 100.0 + np.arange(500)
            score[top[500:900]] = 50.0
        cand_score[b, :m] = torch.from_numpy(score.astype(np.float32))
    count = torch.tensor(counts, dtype=torch.int32)
    args = [t.to(dev) for t in (cand_idx, cand_score, count)]
    idx, valid = G.dog_topk(*args, k, shape)
    pidx, pvalid = G.topk_plain(*args, k, shape)
    assert torch.equal(idx, pidx) and torch.equal(valid, pvalid)
    assert valid.sum(1).tolist() == [min(k, m) for m in counts]
    assert int(idx[~valid].abs().sum()) == 0


def test_dog_localize_kernel(dev):
    """K18 against its twin on the K strongest extrema of bead blocks, and
    on candidates at the border (not eligible) and invalid rows: sub within
    1e-5 px, val within rtol 1e-6 (both sides round the same operations;
    the tolerance covers a division or root the compiler may order
    otherwise)."""
    rng = np.random.default_rng(43)
    x = _beads(rng, 2, (40, 36, 28), n=30).to(dev)
    b1, b2 = G._blurs(G.KERNELS, x, 1.8)
    scale = G.dog_scale(torch.zeros(2, device=dev),
                        torch.full((2,), 1200.0, device=dev))
    thr = torch.full((2,), 0.001, device=dev)
    org = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    dog, ci, cs, cnt = G.dog_extrema(b1, b2, scale, thr, org, True, True, 0,
                                     True)
    idx, valid = G.dog_topk(ci, cs, cnt, 64, dog.shape[1:])
    idx[:, 0] = torch.tensor([0, 5, 3], dtype=torch.int32, device=dev)
    valid[:, -1] = False
    sub, val = G.dog_localize(dog, idx, valid)
    psub, pval = G.localize_plain(dog, idx, valid)
    torch.testing.assert_close(sub, psub, rtol=0, atol=1e-5)
    torch.testing.assert_close(val, pval, rtol=1e-6, atol=0)
    assert int(valid.sum()) > 20 and float(sub[:, -1].abs().max()) == 0.0


@pytest.mark.parametrize("rel,k", [((1, 1, 1), 4096), ((2, 2, 1), 4096),
                                   ((1, 1, 1), 4)], ids=str)
def test_dog_block_topk_batch_kernels(dev, rel, k):
    """The whole program on the kernels (K6, K15-K18) against the twins on
    the card: valid index sets and counts equal, sub within 1e-5 px, val
    within rtol 1e-6; each kernel launched (six blur passes)."""
    rng = np.random.default_rng(44)
    blocks = _beads(rng, 2, (48 * rel[0], 40 * rel[1], 32 * rel[2]), n=25,
                    dtype=np.uint16).to(dev)
    args = (blocks, np.zeros(2, np.float32), np.full(2, 1000.0, np.float32),
            np.full(2, 0.004, np.float32),
            np.array([[-8, -8, -8], [40, -8, 24]], np.int32), 1.8, True,
            False, k, 8, rel)
    ops.reset_launch_counts()
    got = G.dog_block_topk_batch(*args)
    counts = ops.launch_counts()
    ref = G.dog_block_topk_batch(*args, stages=G.PLAIN)
    assert counts["dog_blur"] == 6 and counts["dog_extrema"] == 1, counts
    assert counts["dog_topk"] == 1 and counts["dog_localize"] == 1
    assert counts["downsample_batch"] == int(rel != (1, 1, 1))
    assert torch.equal(got[4], ref[4]) and int(got[4].min()) > 0
    assert torch.equal(got[0], ref[0]) and torch.equal(got[3], ref[3])
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[2], ref[2], rtol=1e-6, atol=0)


def test_dog_block_batch_kernels(dev):
    """The dense dog_block_batch: response bitwise, mask equal; a flat
    block with min == max detects nothing."""
    rng = np.random.default_rng(45)
    blocks = _beads(rng, 2, (40, 36, 28), dtype=np.uint16).to(dev)
    blocks[1] = 777
    args = (blocks, np.array([0.0, 777.0], np.float32),
            np.array([1000.0, 777.0], np.float32), 0.005, 1.8, True, True)
    dog, mask = G.dog_block_batch(*args)
    pdog, pmask = G.dog_block_batch(*args, stages=G.PLAIN)
    assert torch.equal(dog, pdog) and torch.equal(mask, pmask)
    assert int(mask[0].sum()) > 0 and int(mask[1].sum()) == 0
    assert float(dog[1].abs().max()) == 0.0


@pytest.mark.parametrize("rel", [(1, 1, 1), (2, 2, 1)], ids=str)
def test_dog_detect_extract_batch_kernels(dev, rel):
    """The detect-and-extract program on the kernels (K6, K15-K18, then
    K19's masked form) against the same composition of the twins on the
    card: candidates as in test_dog_block_topk_batch_kernels, descriptors
    and dvalid bitwise on the kernels' own candidates (the twins' fits
    may differ in the last bits), one K19 launch."""
    rng = np.random.default_rng(46)
    blocks = _beads(rng, 2, (48 * rel[0], 40 * rel[1], 32 * rel[2]), n=25,
                    dtype=np.uint16).to(dev)
    args = (blocks, np.zeros(2, np.float32), np.full(2, 1000.0, np.float32),
            np.full(2, 0.004, np.float32),
            np.array([[-8, -8, -8], [40, -8, 24]], np.int32), 1.8, True,
            True, 4096, 8, rel, 3, 1, True)
    ops.reset_launch_counts()
    got = G.dog_detect_extract_batch(*args)
    counts = ops.launch_counts()
    ref = G.dog_detect_extract_batch(*args, stages=G.PLAIN)
    assert counts["knn_descriptors"] == 1 and counts["dog_localize"] == 1
    assert counts["dog_blur"] == 6, counts
    assert torch.equal(got[4], ref[4]) and torch.equal(got[0], ref[0])
    assert torch.equal(got[3], ref[3])
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[2], ref[2], rtol=1e-6, atol=0)
    _, desc, dv = DS.knn_descriptors_plain(got[1], got[3], 3, 1, True)
    assert torch.equal(got[5], desc) and torch.equal(got[6], dv)
    assert int(dv.sum()) > 10


# --------------------------------------------------------------- K19-K22


@pytest.mark.parametrize("rot", [True, False], ids=["rotation", "translation"])
@pytest.mark.parametrize("n,r", [(3, 1), (2, 2), (4, 3)])
def test_knn_descriptors_dense_kernel(dev, rot, n, r):
    rng = np.random.default_rng(21)
    pts = torch.from_numpy(rng.uniform(0, 300, (1, 3000, 3)).astype(np.float32))
    pts[0, 10] = pts[0, 11]  # a duplicate point: equal distances
    got = DS.knn_descriptors(pts.to(dev), None, n, r, rot)
    ref = DS.knn_descriptors_plain(pts.to(dev), None, n, r, rot)
    for g, e in zip(got, ref):
        assert torch.equal(g, e)


def test_knn_descriptors_masked_kernel(dev):
    rng = np.random.default_rng(22)
    pts = torch.from_numpy(rng.uniform(0, 60, (3, 300, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(3, 300)) > 0.4)
    valid[2, 3:] = False  # fewer valid points than a pool
    got = DS.knn_descriptors(pts.to(dev), valid.to(dev), 3, 1, True)
    ref = DS.knn_descriptors_plain(pts.to(dev), valid.to(dev), 3, 1, True)
    for g, e in zip(got, ref):
        assert torch.equal(g, e)
    assert not bool(got[2][2].any())


def test_knn_descriptors_row_slice_twin(dev):
    rng = np.random.default_rng(23)
    pts = torch.from_numpy(rng.uniform(0, 500, (1, 5000, 3)).astype(
        np.float32)).to(dev)
    got = DS.knn_descriptors(pts, None, 3, 1, True)
    ref = DS.knn_descriptors_plain(pts, None, 3, 1, True, rows=slice(1200, 2200))
    for g, e in zip(got, ref):
        assert torch.equal(g[:, 1200:2200], e)


@pytest.mark.parametrize("n,r", [(1, 0), (1, 1), (2, 1), (3, 1), (2, 3),
                                 (3, 3), (4, 3), (3, 5)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("K", [700, 1100, 5000])
def test_knn_descriptors_launch_shapes(dev, K, n, r):
    """K19 dense at every pool (1 to 8), K not a multiple of a stage or of
    a row block (splits of the candidates, merged), duplicate points
    (equal distances and a distance 0), points on a coarse grid (ties):
    indices, descriptors and flags bitwise the twin's; one launch."""
    rng = np.random.default_rng(24)
    pts = rng.uniform(0, 30, (1, K, 3)).astype(np.float32)
    pts[0, 10] = pts[0, 11]
    pts[0, K - 1] = pts[0, 3]
    pts[0, K // 2:] = np.round(pts[0, K // 2:])
    t = torch.from_numpy(pts).to(dev)
    plan = DS.knn_plan(1, K, n + r, torch.cuda.get_device_properties(
        dev).multi_processor_count, masked=False)
    assert plan.splits > 1
    for rot in (True, False):
        ops.reset_launch_counts()
        got = DS.knn_descriptors(t, None, n, r, rot)
        assert ops.launch_counts()["knn_descriptors"] == 1
        want = DS.knn_descriptors_plain(t, None, n, r, rot)
        for g, e in zip(got, want):
            assert torch.equal(g, e)


@pytest.mark.parametrize("B,K", [(3, 1100), (2, 4096), (200, 300)])
def test_knn_descriptors_masked_launch_shapes(dev, B, K):
    """K19's masked form: entries with their valid slots first (as
    detection fills them), scattered, and with fewer valid points than a
    pool; B x row blocks below the card (splits) and above it (none):
    indices, descriptors and flags bitwise the twin's."""
    rng = np.random.default_rng(25)
    pts = rng.uniform(0, 50, (B, K, 3)).astype(np.float32)
    valid = rng.uniform(size=(B, K)) > 0.6
    valid[0] = np.arange(K) < K // 9
    valid[1] = False
    valid[1, [5, K // 2, K - 1]] = True
    t, v = torch.from_numpy(pts).to(dev), torch.from_numpy(valid).to(dev)
    got = DS.knn_descriptors(t, v, 3, 1, True)
    want = DS.knn_descriptors_plain(t, v, 3, 1, True)
    for g, e in zip(got, want):
        assert torch.equal(g, e)
    assert not bool(got[2][1].any()) and not bool(got[1][1].any())


@pytest.mark.parametrize("D", list(range(3, DS.MAX_DIM + 1, 3)))
def test_ratio_match_kernel(dev, D):
    """K20 bitwise equal to its twin at every descriptor width (the
    filter's depth 16 up to D = 15, 32 above), in ratio and nearest mode;
    its filter refines some pairs and never more than all."""
    rng = np.random.default_rng(24)
    b = torch.from_numpy(rng.normal(0, 5, (4000, D)).astype(np.float32) + 100)
    a = (b[::3] + torch.from_numpy(rng.normal(0, 0.1, (1334, D)).astype(
        np.float32)))
    owner = torch.from_numpy((np.arange(4000) // 4).astype(np.int32))
    for own in (owner, None):
        args = (a.to(dev), b.to(dev), None if own is None else own.to(dev), 3.0)
        got, ref = DS.ratio_match(*args), DS.ratio_match_plain(*args)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        if own is not None:
            assert torch.equal(got[2], ref[2])
        assert 0 < int(DS.ratio_match.refined) <= 1334 * 4000


def _ratio_case(name, rng):
    """Adversarial K20 inputs: (a, b, owner or None, ratio)."""
    f = np.float32
    if name == "ties across owners":
        base = rng.integers(-4, 5, (40, 9)).astype(f)
        b = np.concatenate([base, base, base[::-1]])
        a = np.concatenate([base[:12], base[:6] + 1.0])
        return a, b, np.arange(len(b), dtype=np.int32), 1.0
    if name == "same-owner runs":
        pts = rng.normal(0, 3, (750, 9)).astype(f)
        b = np.repeat(pts, 4, 0) + rng.normal(0, 0.01, (3000, 9)).astype(f)
        a = (b[::13] + rng.normal(0, 0.02, (231, 9))).astype(f)
        return a, b, np.repeat(np.arange(750, dtype=np.int32), 4), 3.0
    if name == "one owner":
        b = rng.normal(0, 1, (2000, 6)).astype(f)
        return (b[:300] + 0.1).astype(f), b, np.zeros(2000, np.int32), 3.0
    if name == "Db not a multiple of the tile":
        b = rng.normal(0, 1, (1001, 9)).astype(f)
        return ((b[5:700] + 0.05).astype(f), b,
                (np.arange(1001) // 3).astype(np.int32), 1.5)
    if name == "Da below one tile":
        b = rng.normal(0, 2, (129, 12)).astype(f)
        return b[:5].copy(), b, (np.arange(129) % 40).astype(np.int32), 2.0
    if name == "far clusters":
        c = rng.normal(0, 1, 9) * 60.0
        b = np.concatenate([c + rng.normal(0, 0.3, (900, 9)),
                            -c + rng.normal(0, 0.3, (900, 9))]).astype(f)
        a = (b[rng.choice(1800, 300, replace=False)]
             + rng.normal(0, 0.05, (300, 9))).astype(f)
        return a, b, (np.arange(1800) // 2).astype(np.int32), 3.0
    if name == "nearest mode":
        base = rng.integers(-3, 4, (1500, 3)).astype(f)
        return base[:300].copy(), np.concatenate([base, base]), None, 1.0
    raise ValueError(name)


@pytest.mark.parametrize("case", [
    "ties across owners", "same-owner runs", "one owner",
    "Db not a multiple of the tile", "Da below one tile", "far clusters",
    "nearest mode"])
def test_ratio_match_kernel_cases(dev, case):
    """K20 on the inputs of the CPU tests of its plan (equal distances
    across owners, same-owner runs, one owner, ragged tiles, fewer rows
    than a block, distances inside the TF32 error, nearest mode with
    every distance tied), bitwise its twin's."""
    a, b, owner, ratio = _ratio_case(case, np.random.default_rng(len(case)))
    args = (torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev),
            None if owner is None else torch.from_numpy(owner).to(dev), ratio)
    got, ref = DS.ratio_match(*args), DS.ratio_match_plain(*args)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    if owner is not None:
        assert torch.equal(got[2], ref[2])
    assert 0 < int(DS.ratio_match.refined) <= len(a) * len(b)


def _tf32(x):
    """Round float32 to TF32 as K20's prologue does (nearest, ties away)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _mma_operands(kind, D, kp, n, rng):
    """(n, 16, kp) and (n, 8, kp) TF32 operands whose sums stress the
    tensor cores' accumulation: "normal" rows over four decades; "cut
    bits", one unit term and D terms of full 11-bit significands 2^-6 to
    2^-16 below it, whose low bits fall below float32's significand once
    aligned to the unit; "cancel", terms in +/- pairs a few bits apart
    with small ones between; "filter", the filter's own operands A' =
    (a - c, 1), B' = (-2 (b - c), (1 - 2^-7) b2) of two far clusters."""
    f = np.float32
    k = D + 1
    a = np.zeros((n, 16, kp), f)
    b = np.zeros((n, 8, kp), f)
    if kind == "normal":
        a[..., :k] = rng.normal(0, 1, (n, 16, k)) * 10.0 ** rng.uniform(
            -2, 2, (n, 16, 1))
        b[..., :k] = rng.normal(0, 1, (n, 8, k)) * 10.0 ** rng.uniform(
            -2, 2, (n, 8, 1))
    elif kind == "cut bits":
        full = 2.0 - 2.0 ** -10  # every fraction bit of TF32 set
        sa = rng.choice([-1.0, 1.0], (n, 16, k))
        a[..., :k] = sa * full * 2.0 ** -rng.integers(3, 9, (n, 16, k))
        b[..., :k] = full * 2.0 ** -rng.integers(3, 9, (n, 8, k))
        a[..., 0], b[..., 0] = 1.0, 1.0
    elif kind == "cancel":
        v = rng.uniform(1, 2, (n, 16, k)) * 2.0 ** rng.integers(-4, 5,
                                                                 (n, 16, k))
        v[..., 1::2] = -v[..., 0:-1:2] * (1 - 2.0 ** -rng.integers(
            4, 12, (n, 16, v[..., 1::2].shape[-1])))
        a[..., :k] = v
        b[..., :k] = rng.uniform(1, 2, (n, 8, k))
    else:
        c = rng.normal(0, 1, D) * 60.0
        pa = c + rng.normal(0, 0.3, (n, 16, D)) * rng.choice([-1, 1],
                                                            (n, 16, 1))
        pb = rng.choice([-1, 1], (n, 8, 1)) * c + rng.normal(0, 0.3,
                                                             (n, 8, D))
        a[..., :D], a[..., D] = pa, 1.0
        b[..., :D] = -2.0 * pb
        b[..., D] = (1 - 2.0 ** -7) * np.sum(pb.astype(f) ** 2, -1)
    return _tf32(a), _tf32(b)


@pytest.mark.parametrize("kind", ["normal", "cut bits", "cancel", "filter"])
@pytest.mark.parametrize("D", list(range(3, DS.MAX_DIM + 1, 3)))
def test_ratio_filter_mma_error(dev, D, kind):
    """The accumulation term of K20's margin measured on the card: the
    filter's TF32 MMAs (its k8 and k4 steps) sum exact products of TF32
    operands within 2^-17 of the terms' magnitude sum M, the bound the
    source note's margin takes for them. The float64 reference is within
    (D + 1) 2^-53 M of the exact sum, far inside the bound."""
    kp = DS.ratio_plan(1, 1, D).kp
    a, b = _mma_operands(kind, D, kp, 256, np.random.default_rng(D))
    got = DS.ratio_filter_dot(torch.from_numpy(a).to(dev),
                              torch.from_numpy(b).to(dev), D).cpu().numpy()
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    ref = np.einsum("nik,njk->nij", a64, b64)
    mag = np.einsum("nik,njk->nij", np.abs(a64), np.abs(b64))
    worst = float(np.max(np.abs(got - ref) / mag))
    print(f"K20 filter MMAs, D {D}, {kind}: worst error "
          f"{worst / 2.0 ** -23:.3f} x 2^-23 of M")
    assert worst <= 2.0 ** -17, f"{worst / 2.0 ** -23:.2f} x 2^-23 of M"


@pytest.mark.parametrize("kind", ["TRANSLATION", "RIGID", "AFFINE"])
def test_ransac_score_kernel(dev, kind):
    rng = np.random.default_rng(25)
    m = 5000
    a = rng.uniform(0, 400, (m, 3))
    b = a @ np.array([[0.99, -0.1, 0], [0.1, 0.99, 0], [0, 0, 1.0]]).T + 7.0
    b[: m // 3] = rng.uniform(0, 400, (m // 3, 3))
    pa = torch.from_numpy(a.astype(np.float32)).to(dev)
    pb = torch.from_numpy(b.astype(np.float32)).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    idx = DS.draw_hypotheses(m, 3000, 4, g)
    got = DS.ransac_score(pa, pb, idx, 5.0, kind)
    ref = DS.ransac_score_plain(pa, pb, idx, 5.0, kind)
    for x, y in zip(got, ref):  # a degenerate sample fits NaN on both
        assert torch.equal(x.isnan(), y.isnan())
        assert torch.equal(x.nan_to_num(), y.nan_to_num())


def _ransac_case(rng, m, I, sample):
    """``m`` candidates under a small rotation (a third of them outliers,
    one NaN pair where m > 2, in hypothesis 2's sample) and ``I``
    hypotheses of ``sample`` indices drawn with repeats (samples whose pairs
    repeat or hold the NaN fit a degenerate or NaN model)."""
    a = rng.uniform(0, 400, (m, 3))
    b = a @ np.array([[0.99, -0.1, 0], [0.1, 0.99, 0], [0, 0, 1.0]]).T + 7.0
    b[: m // 3] = rng.uniform(0, 400, (m // 3, 3))
    if m > 2:
        a[m // 2] = np.nan
    idx = rng.integers(0, m, (I, sample)).astype(np.int32)
    if I > 1:
        idx[1] = idx[1, 0]
    if m > 2 and I > 2:
        idx[2, 0] = m // 2
    return (torch.from_numpy(a.astype(np.float32)),
            torch.from_numpy(b.astype(np.float32)), torch.from_numpy(idx))


@pytest.mark.parametrize("m,I,sample,kind", [
    (1, 130, 1, "TRANSLATION"),   # one candidate; I not a multiple of 128
    (200, 129, 3, "RIGID"),       # below one tile
    (20000, 1000, 4, "AFFINE"),   # splits of several tiles, ragged ends
    (5000, 3000, 1, "TRANSLATION"),
    (5000, 300, 3, "RIGID"),
    (1317, 257, 4, "AFFINE"),
], ids=str)
def test_ransac_score_kernel_shapes(dev, m, I, sample, kind):
    """K21 bitwise against its twin on the card (NaN-aware: the card's NaN
    is canonical) across its launch plan's cases, with its rows 16-byte
    aligned and one float past that (element staging); a NaN model counts
    no inlier. Samples of 3 divide by 3: the twin divides, as the kernel
    does, where the card would multiply by a Python divisor's rounded
    reciprocal."""
    pa, pb, idx = _ransac_case(np.random.default_rng(m + I), m, I, sample)
    pa, pb, idx = pa.to(dev), pb.to(dev), idx.to(dev)
    ref = DS.ransac_score_plain(pa, pb, idx, 5.0, kind)
    flat = torch.zeros((2, 3 * m + 1), device=dev)
    flat[:, 1:] = torch.stack([pa.reshape(-1), pb.reshape(-1)])
    for pa_, pb_ in ((pa, pb),
                     (flat[0, 1:].view(m, 3), flat[1, 1:].view(m, 3))):
        got = DS.ransac_score(pa_, pb_, idx, 5.0, kind)
        for x, y in zip(got, ref):
            assert torch.equal(x.isnan(), y.isnan())
            assert torch.equal(x.nan_to_num(), y.nan_to_num())
    nan = got[1].isnan().flatten(1).any(1)
    assert bool(nan.any()) == (m > 2)
    assert int(got[0][nan].abs().sum()) == 0


def test_ransac_score_kernel_ties(dev):
    """Every hypothesis the same sample: equal counts across several
    candidate splits and groups, and the first maximum (index 0) best."""
    pa, pb, _ = _ransac_case(np.random.default_rng(8), 20000, 1, 4)
    idx = torch.tensor([[5, 900, 7000, 15000]] * 1000, dtype=torch.int32)
    pa, pb, idx = pa.to(dev), pb.to(dev), idx.to(dev)
    got = DS.ransac_score(pa, pb, idx, 5.0, "AFFINE")
    ref = DS.ransac_score_plain(pa, pb, idx, 5.0, "AFFINE")
    for x, y in zip(got, ref):
        assert _bits_equal(x, y)
    assert int(got[2][0]) == 0 and bool((got[0] == got[0][0]).all())


@pytest.mark.parametrize("m", [1, 255, 256, 257, 1024, 20000, 58274],
                         ids=str)
@pytest.mark.parametrize("kind,reg,lam", [
    ("AFFINE", "RIGID", 0.1), ("RIGID", "NONE", 0.0),
    ("TRANSLATION", "IDENTITY", 0.3)])
def test_ransac_refit_kernel(dev, kind, reg, lam, m):
    """K22 against its twin: masks and counts equal, models within rtol
    1e-9 / atol 1e-9 (NaN where both fit NaN: one inlier), from one block
    (M < 1,024) to a grid of them (refit_plan); a repeat bitwise."""
    rng = np.random.default_rng(26)
    a = rng.uniform(0, 900, (m, 3))
    b = a + np.array([3.0, -2.0, 1.0]) + rng.normal(0, 1.0, a.shape)
    b[: m // 4] += rng.uniform(-30, 30, (m // 4, 3))
    pa = torch.from_numpy(a.astype(np.float32)).to(dev)
    pb = torch.from_numpy(b.astype(np.float32)).to(dev)
    model = torch.tensor([[1, 0, 0, 3], [0, 1, 0, -2], [0, 0, 1, 1.0]],
                         dtype=torch.float64, device=dev)
    for fit in (True, False):
        got = DS.ransac_refit(pa, pb, model, 2.5, kind, reg, lam, fit)
        ref = DS.ransac_refit_plain(pa, pb, model, 2.5, kind, reg, lam, fit)
        assert torch.equal(got[0], ref[0]) and int(got[1]) == int(ref[1])
        again = DS.ransac_refit(pa, pb, model, 2.5, kind, reg, lam, fit)
        assert torch.equal(again[0], got[0]) and int(again[1]) == int(got[1])
        if fit:
            torch.testing.assert_close(got[2], ref[2], rtol=1e-9, atol=1e-9,
                                       equal_nan=True)
            assert torch.equal(got[2].view(torch.int64),
                               again[2].view(torch.int64))


def test_matching_wrappers_count_and_refuse(dev):
    ops.reset_launch_counts()
    pts = torch.rand((1, 50, 3), device=dev)
    DS.knn_descriptors(pts, None, 3, 1, True)
    assert ops.launch_counts()["knn_descriptors"] == 1
    with pytest.raises(ValueError):
        DS.knn_descriptors(pts, None, 6, 3, True)  # pool 9 > MAX_POOL
    with pytest.raises(ValueError):
        DS.ratio_match(pts[0].double(), pts[0].double(), None, 3.0)


# ---------------------------------------------------------------- intensity


def _coeff_inputs(rng, V, extent, cdims=(4, 3, 2)):
    """(V, Cx, Cy, Cz, 2) grids of [scale, offset] and diagonal level
    position -> grid affines whose coordinates run past both grid edges."""
    g = np.empty((V, *cdims, 2), np.float32)
    g[..., 0] = rng.uniform(0.6, 1.6, (V, *cdims))
    g[..., 1] = rng.uniform(-200, 200, (V, *cdims))
    aff = np.zeros((V, 3, 4), np.float32)
    for v in range(V):
        for d in range(3):
            aff[v, d, d] = (cdims[d] + 1.5) / extent[d]
            aff[v, d, 3] = rng.uniform(-1.2, -0.6)
    return torch.from_numpy(g), torch.from_numpy(aff)


@pytest.mark.parametrize("fusion_type,out_dtype", [
    *[(ft, "uint16") for ft in FTYPES], ("AVG_BLEND", "float32")])
def test_composite_coeff_kernel(dev, fusion_type, out_dtype):
    """K1's coefficient branch against its twin on the card: uint16
    |delta| <= 1, float32 rtol 1e-5 / atol 1e-3."""
    rng = np.random.default_rng(30)
    tiles, params, kw = _composite_case(rng, fusion_type, out_dtype, False)
    V = len(tiles)
    kw["kinds"] = ("shift",) * V
    kw["windows"] = tuple(kw["windows"][:2]) * 2
    kw["n_offs"] = tuple(kw["n_offs"][:2]) * 2
    fr = params[0].copy()
    fr[2:] = fr[:2]
    params = (fr, *params[1:])
    coeffs, affs = _coeff_inputs(rng, V, (40, 36, 20))
    tiles = [t.to(dev) for t in tiles]
    ref = F.composite_fuse_plain(tiles, *params, coeffs=coeffs.to(dev),
                                 coeff_affs=affs, **kw)
    ops.reset_launch_counts()
    got = F.composite_fuse(tiles, *params, coeffs=coeffs.to(dev),
                           coeff_affs=affs, **kw)
    assert ops.launch_counts()["composite_fuse"] == 1
    assert ops.coeff_launch_counts()["composite_fuse+coeff"] == 1
    if out_dtype == "float32":
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-3)
    else:
        d = (got.to(torch.float64) - ref.to(torch.float64)).abs()
        assert d.max() <= 1
    with pytest.raises(ValueError, match="per-block"):
        F.composite_fuse(tiles, *params, coeffs=coeffs.to(dev),
                         coeff_affs=affs, **{**kw, "kinds": ("sep",) * V})


@pytest.mark.parametrize("fusion_type", FTYPES)
def test_fuse_block_gather_coeff_kernel(dev, fusion_type):
    """K3's coefficient branch against its twin on the card: float32 rtol
    1e-5 / atol 1e-3, wsum atol 1e-5."""
    rng = np.random.default_rng(31)
    V, bs, ps = 4, (32, 28, 16), (48, 40, 24)
    patches = torch.from_numpy(rng.integers(0, 4000, (V, *ps)).astype(
        np.uint16))
    aff = np.zeros((V, 3, 4), np.float32)
    for v in range(V):
        a = np.deg2rad(rng.uniform(-10, 10))
        aff[v, :3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                          [0, 0, 1]]
        aff[v, :, 3] = rng.uniform(-6, 12, 3)
    coeffs, caffs = _coeff_inputs(rng, V, (60, 50, 30))
    args = [patches, torch.from_numpy(aff), _per_view(rng, V, 0, 30),
            torch.from_numpy(np.tile(np.array([60, 50, 30], np.float32),
                                     (V, 1))),
            _per_view(rng, V, 0, 3), _per_view(rng, V, 5, 30),
            torch.from_numpy((np.arange(V) < V - 1).astype(np.float32)),
            _per_view(rng, V, 0, 2)]
    args = [a.to(dev) for a in args]
    cf = dict(coeffs=coeffs.to(dev), coeff_affines=caffs.to(dev))
    ref = F.fuse_block_plain(*args[:7], bs, fusion_type, args[7], **cf)
    ops.reset_launch_counts()
    got = F.fuse_block(*args[:7], bs, fusion_type, args[7], **cf)
    assert ops.coeff_launch_counts()["fuse_block+coeff"] == 1
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)
    plain = F.fuse_block(*args[:7], bs, fusion_type, args[7])
    assert (got[0] - plain[0]).abs().max() > 10  # the branch was taken


def _gather_case(rng, V, bs, dtype="uint16", coeff=False):
    """K3 inputs over a ``bs`` block: V views of the block + 9, rotated
    about z (separable: the column and per-k form) and every other view
    about x (a general affine: the per-voxel form), z steps of 0.7 (view
    1: taps repeat) and 1.6 (view 2: taps skip), translations past the
    patch (runs clamped at its ends), every fifth view invalid; with
    ``coeff`` 4 x 3 x 5 grids, every other view's grid affine tilted in z
    (its x taps per voxel)."""
    ps = tuple(s + 9 for s in bs)
    vmax = {"uint8": 255, "uint16": 4000, "int16": 3000, "float32": 4000}
    patches = rng.uniform(0, vmax[dtype], (V, *ps)).astype(dtype)
    aff = np.zeros((V, 3, 4), np.float32)
    for v in range(V):
        a = np.deg2rad(rng.uniform(-10, 10))
        c, s_ = np.cos(a), np.sin(a)
        aff[v, :3, :3] = ([[1, 0, 0], [0, c, -s_], [0, s_, c]] if v % 2 == 0
                          else [[c, -s_, 0], [s_, c, 0], [0, 0, 1]])
        aff[v, 2, 2] *= {1: 0.7, 2: 1.6}.get(v, 1.0)
        aff[v, :, 3] = rng.uniform(-6, 12, 3)
    dims = np.tile(np.array([p * 1.2 + 5 for p in ps], np.float32), (V, 1))
    args = [torch.from_numpy(patches), torch.from_numpy(aff),
            _per_view(rng, V, 0, 30), torch.from_numpy(dims),
            _per_view(rng, V, 0, 3), _per_view(rng, V, 2, 12),
            torch.from_numpy((np.arange(V) % 5 != 3).astype(np.float32)),
            _per_view(rng, V, 0, 2)]
    cf = {}
    if coeff:
        cd = (4, 3, 5)
        g = np.empty((V, *cd, 2), np.float32)
        g[..., 0] = rng.uniform(0.5, 1.5, (V, *cd))
        g[..., 1] = rng.uniform(-50, 50, (V, *cd))
        ca = np.zeros((V, 3, 4), np.float32)
        for v in range(V):
            ca[v, [0, 1, 2], [0, 1, 2]] = np.array(cd) / dims[v]
            ca[v, :, 3] = rng.uniform(-0.5, 0.5, 3)
            if v % 2:
                ca[v, 0, 2] = 0.01
        cf = dict(coeffs=torch.from_numpy(g), coeff_affines=torch.from_numpy(ca))
    return args, cf


def _gather_check(dev, args, cf, bs, fusion_type):
    """K3 against its twin, both on the card: fused rtol 1e-5 / atol 1e-3,
    wsum atol 1e-5."""
    args = [a.to(dev) for a in args]
    cf = {k: v.to(dev) for k, v in cf.items()}
    ref = F.fuse_block_plain(*args[:7], bs, fusion_type, args[7], **cf)
    ops.reset_launch_counts()
    got = F.fuse_block(*args[:7], bs, fusion_type, args[7], **cf)
    assert ops.launch_counts()["fuse_block"] == 1
    assert got[0].shape == tuple(bs)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)


# blocks that are not multiples of the run or the tile, one view to 33 (five
# view chunks of 8), 130 z outputs (two z tiles, the second ragged)
RESAMPLE_CASES = [((5, 3, 7), 1), ((1, 1, 1), 4), ((3, 40, 9), 9),
                  ((2, 5, 64), 33), ((2, 3, 130), 4), ((4, 70, 66), 4)]
_case_id = lambda c: "x".join(map(str, c[0])) + f"-V{c[1]}"


@pytest.mark.parametrize("fusion_type", FTYPES)
@pytest.mark.parametrize("case", RESAMPLE_CASES, ids=_case_id)
@pytest.mark.parametrize("coeff", [False, True], ids=["plain", "coeff"])
def test_fuse_block_gather_kernel_ragged(dev, coeff, case, fusion_type):
    bs, V = case
    args, cf = _gather_case(np.random.default_rng(33), V, bs, coeff=coeff)
    _gather_check(dev, args, cf, bs, fusion_type)


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int16", "float32"])
@pytest.mark.parametrize("case", RESAMPLE_CASES[:3], ids=_case_id)
@pytest.mark.parametrize("coeff", [False, True], ids=["plain", "coeff"])
def test_fuse_block_gather_kernel_dtypes(dev, coeff, case, dtype):
    bs, V = case
    args, cf = _gather_case(np.random.default_rng(34), V, bs, dtype, coeff)
    _gather_check(dev, args, cf, bs, "AVG_BLEND")


@pytest.mark.parametrize("coeff", [False, True], ids=["plain", "coeff"])
def test_fuse_block_gather_kernel_64bit_patch(dev, coeff):
    """One uint8 view of 1300^3 (2.197e9 elements, past 2^31) and a small
    block at its far corner: the 64-bit index instantiation, against the
    twin."""
    n = 1300
    assert F.resample_plan((16, 12, 8), 1, (n, n, n)).idx64
    g = torch.Generator(device=dev).manual_seed(35)
    patches = torch.randint(0, 256, (1, n, n, n), dtype=torch.uint8,
                            device=dev, generator=g)
    rng = np.random.default_rng(35)
    a = np.deg2rad(3.0)
    aff = np.zeros((1, 3, 4), np.float32)
    aff[0, :3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                      [0, 0, 1]]
    aff[0, :, 3] = [n - 14.3, n - 11.6, n - 9.2]  # samples past the far edge
    args = [patches, torch.from_numpy(aff),
            torch.from_numpy(np.full((1, 3), 100.0, np.float32)),
            torch.from_numpy(np.full((1, 3), n + 150.0, np.float32)),
            _per_view(rng, 1, 0, 3), _per_view(rng, 1, 20, 40), torch.ones(1),
            torch.zeros(1, 3)]
    cf = {}
    if coeff:
        grids, caffs = _coeff_inputs(rng, 1, (n + 150,) * 3)
        cf = dict(coeffs=grids, coeff_affines=caffs)
    _gather_check(dev, args, cf, (16, 12, 8), "AVG_BLEND")


@pytest.mark.parametrize("P,N,I", [(3, 256, 500), (64, 2048, 1000),
                                   (5, 16384, 300)])
def test_linefit_ransac_kernel(dev, P, N, I):
    """K23 against its twin on the same draws: every hypothesis' count and
    the argmax bitwise; the refitted a, b within 1e-5 (float32 sums in
    another order)."""
    from bigstitcher_spark_tpu_torch.ops import intensity as OI

    rng = np.random.default_rng(32)
    sa, sb = [], []
    for p in range(P):
        n = int(rng.integers(N // 2 + 1, N + 1))
        x = rng.uniform(0.05, 0.7, n).astype(np.float32)
        y = (rng.uniform(0.6, 1.5) * x + rng.uniform(-0.1, 0.1)
             + rng.normal(0, 0.004, n)).astype(np.float32)
        y[: n // 5] = rng.uniform(0, 1, n // 5)
        sa.append(x)
        sb.append(y)
    x, y, v = OI.pack_samples(sa, sb, dev)
    assert x.shape == (P, N)
    hyp = OI.draw_hypotheses(9, P, N, I, dev)
    # the card scores the hypotheses a CPU run scores
    assert torch.equal(hyp.cpu(), OI.draw_hypotheses(9, P, N, I, "cpu"))
    ops.reset_launch_counts()
    got = OI.linefit_ransac(x, y, v, hyp, 0.02)
    assert ops.launch_counts()["linefit_ransac"] == 1
    ref = OI.linefit_ransac_plain(x, y, v, hyp, 0.02)
    assert torch.equal(got.counts, ref.counts)
    assert torch.equal(got.best, ref.best) and torch.equal(got.count,
                                                           ref.count)
    torch.testing.assert_close(got.a, ref.a, rtol=0, atol=1e-5)
    torch.testing.assert_close(got.b, ref.b, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        OI.linefit_ransac(x.double(), y, v, hyp, 0.02)


def _cg_case(seed, n_views, dims, n_matches):
    from bigstitcher_spark_tpu_torch.models.intensity import smoothness_pairs
    from bigstitcher_spark_tpu_torch.ops.intensity import (
        intensity_system, match_stats)

    rng = np.random.default_rng(seed)
    C = int(np.prod(dims)) * n_views
    matches = []
    for _ in range(n_matches):
        ca, cb = rng.integers(0, C, 2)
        x = rng.uniform(100, 1000, 50)
        y = rng.uniform(0.8, 1.2) * x + rng.uniform(-20, 20) + rng.normal(0, 5, 50)
        matches.append((int(ca), int(cb), *match_stats(x / 500, y / 500)))
    return C, intensity_system(C, matches, 0.1,
                               smoothness_pairs(dims, n_views))


@pytest.mark.parametrize("n_views,dims,n_matches", [
    (3, (4, 4, 4), 300), (64, (8, 8, 8), 4000)])
def test_cg_kernels_match_plain(dev, n_views, dims, n_matches):
    """K24/K25 against cg_plain on the card: the solution within rtol 1e-9
    (dot products summed in another order), iteration counts within 1; a
    K24 and a K25 step alone against their twins within rtol 1e-12."""
    C, (rows, diag, rhs, sidx, sw) = _cg_case(5, n_views, dims, n_matches)
    sysm = R.assemble_cg(C, rows, diag, rhs, sidx, sw, dev)
    ops.reset_launch_counts()
    got = R.cg_on_device(sysm)
    counts = ops.launch_counts()
    assert counts["cg_spmv"] > got.iterations and counts["cg_update"] > 0
    assert 0 < got.card_seconds <= got.seconds
    ref = R.cg_plain(sysm)
    assert abs(got.iterations - ref.iterations) <= 1
    scale = float(ref.x.abs().max())
    torch.testing.assert_close(got.x, ref.x, rtol=1e-9, atol=1e-9 * scale)

    g = torch.Generator(device=dev)
    g.manual_seed(1)
    r = torch.randn(sysm.n, generator=g, device=dev, dtype=torch.float64)
    p_old = torch.randn(sysm.n, generator=g, device=dev, dtype=torch.float64)
    x = torch.randn(sysm.n, generator=g, device=dev, dtype=torch.float64)
    outs = []
    for spmv, update in ((R.cg_spmv, R.cg_update),
                         (R.cg_spmv_plain, R.cg_update_plain)):
        d, i = R.cg_state(sysm, dev)
        d[0], d[1] = 3.5, 0.25
        pn, ap = torch.empty_like(r), torch.empty_like(r)
        rr, xx = r.clone(), x.clone()
        spmv(sysm, rr, p_old, pn, ap, d, i)
        update(sysm, xx, rr, pn, ap, d, i)
        outs.append((pn, ap, rr, xx, d.clone(), i.clone()))
    for a, b in zip(*outs):
        if a.dtype == torch.int32:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def _csr_system(dev, lengths, seed):
    """A CGSystem with the given row lengths (random columns, values from
    N(0, 1)), for K24 alone."""
    rng = np.random.default_rng(seed)
    n, nnz = len(lengths), int(np.sum(lengths))
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(lengths, out=row_ptr[1:])
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)
    return R.CGSystem(n, t(row_ptr, np.int32), t(lengths, np.int64),
                      t(rng.integers(0, n, nnz), np.int32),
                      t(rng.normal(size=nnz), np.float64),
                      t(np.zeros(n), np.float64), t(np.zeros(n), np.float64),
                      0.0, 10)


@pytest.mark.parametrize("lanes", [None, 1, 4, 8, 32])
@pytest.mark.parametrize("case", ["ones", "mixed", "long", "many"])
def test_cg_spmv_row_lengths(dev, case, lanes):
    """K24 on rows of 1 term and of more than 32 terms, with the wrapper's
    lanes a row (None) and with each lane count, n not a multiple of a
    block's rows: p_new bitwise, Ap and p.Ap within rtol 1e-12 of the twin;
    a rerun bitwise equal."""
    rng = np.random.default_rng(7)
    lengths = {
        "ones": np.ones(777, np.int64),
        "mixed": np.where(rng.random(1001) < 0.03, rng.integers(33, 41, 1001),
                          rng.choice([1, 2, 7, 8, 9], 1001)),
        "long": rng.integers(30, 71, 517),
        "many": rng.integers(4, 12, 300_007)}[case]
    sysm = _csr_system(dev, lengths, 3)
    n = sysm.n
    assert n % 256 != 0
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    r = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
    p_old = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
    kernel = (R.cg_spmv if lanes is None else
              lambda *a: R.launch_cg_spmv(*a, lanes=lanes))
    outs = []
    for spmv in (kernel, kernel, R.cg_spmv_plain):
        d, i = R.cg_state(sysm, dev)
        d[1] = 0.375
        pn, ap = torch.empty_like(r), torch.empty_like(r)
        spmv(sysm, r, p_old, pn, ap, d, i)
        outs.append((pn, ap, d[3:].clone()))
    (pn, ap, pap), again, (pn2, ap2, pap2) = outs
    assert all(torch.equal(a, b) for a, b in zip((pn, ap, pap), again))
    assert torch.equal(pn, pn2)
    torch.testing.assert_close(ap, ap2, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(pap, pap2, rtol=1e-12, atol=1e-12)


def test_cg_spmv_offset_views(dev):
    """K24 reads lists that are views at an odd offset into larger
    tensors (no alignment beyond an element's own): within rtol 1e-12 of
    the twin."""
    lengths = np.random.default_rng(4).integers(1, 20, 3001)
    base = _csr_system(dev, lengths, 5)
    nnz = int(base.cols.numel())
    cols = torch.zeros(nnz + 1, dtype=torch.int32, device=dev)
    vals = torch.zeros(nnz + 3, dtype=torch.float64, device=dev)
    cols[1:].copy_(base.cols)
    vals[3:].copy_(base.vals)
    sysm = R.CGSystem(base.n, base.row_ptr, base.row_len, cols[1:], vals[3:],
                      base.rhs, base.x0, 0.0, 10)
    r = torch.linspace(-1.0, 1.0, sysm.n, dtype=torch.float64, device=dev)
    p_old = torch.cos(r)
    got = []
    for spmv in (R.cg_spmv, R.cg_spmv_plain):
        d, i = R.cg_state(sysm, dev)
        d[1] = 0.5
        pn, ap = torch.empty_like(r), torch.empty_like(r)
        spmv(sysm, r, p_old, pn, ap, d, i)
        got.append((pn, ap, d[3:].clone()))
    assert torch.equal(got[0][0], got[1][0])
    for a, b in zip(got[0][1:], got[1][1:]):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("lanes", [0, 3, 64])
def test_cg_spmv_refuses_bad_lanes(dev, lanes):
    sysm = _csr_system(dev, np.ones(10, np.int64), 1)
    v = torch.zeros(10, dtype=torch.float64, device=dev)
    d, i = R.cg_state(sysm, dev)
    with pytest.raises(ValueError, match="lanes a row"):
        R.launch_cg_spmv(sysm, v, v, v.clone(), v.clone(), d, i, lanes=lanes)


# ---------------------------------------------------------------- K26


def _nonrigid_case(rng, dtype, V=4, n_valid=3, bs=(24, 20, 16), cpd=10.0,
                   go_shift=0.0):
    """K26 inputs: V views (the last V - n_valid padded), fitted vertex
    grids at a spacing of ``cpd`` (the main path's 10 by default; below
    ~1.5 a tile's z range reaches more vertices than K26's table holds),
    the grid origin ``go_shift`` past the reference's (grid coordinates
    clamped at one end or the other), a block origin near (1500, 900, 60);
    one view rotated, one image ending inside the block."""
    from bigstitcher_spark_tpu_torch.models.nonrigid_fusion import (
        control_grid_dims)
    from bigstitcher_spark_tpu_torch.ops.nonrigid import fit_control_grid

    bo = np.array([1500.25, 900.5, 60.75], np.float32)
    go = bo - np.float32(cpd) + np.float32(go_shift)
    gdims = control_grid_dims(bs, cpd)
    grids = np.zeros((V, *gdims, 12), np.float32)
    grids[..., 0] = grids[..., 5] = grids[..., 10] = 1.0
    pshape = tuple(s + 24 for s in bs)
    vmax = {"uint8": 255, "uint16": 4000, "int16": 3000, "float32": 4000}[dtype]
    patches = np.zeros((V, *pshape), dtype)
    vaff = np.zeros((V, 3, 4), np.float32)
    offsets = np.zeros((V, 3), np.float32)
    for v in range(n_valid):
        t = bo + rng.uniform(-10, 30, (30, 3))
        vw = t + rng.normal(0, 0.8, (30, 3)) + rng.uniform(-2, 2, 3)
        grids[v] = fit_control_grid(t, vw, go.astype(np.float64), gdims, cpd)
        patches[v] = rng.uniform(0, vmax, pshape).astype(dtype)
        ang = 0.05 * v
        lin = np.array([[np.cos(ang), -np.sin(ang), 0],
                        [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
        vaff[v, :, :3] = lin
        vaff[v, :, 3] = -lin @ bo + 12.0 + rng.uniform(-0.5, 0.5, 3)
        offsets[v] = rng.integers(0, 30, 3)
    dims = (offsets + np.array(pshape, np.float32)
            + rng.integers(5, 20, (V, 3)).astype(np.float32))
    dims[0, 0] = offsets[0, 0] + 22.5
    borders = rng.uniform(0, 2, (V, 3)).astype(np.float32)
    ranges = rng.uniform(4, 12, (V, 3)).astype(np.float32)
    valid = (np.arange(V) < n_valid).astype(np.float32)
    arrays = (patches, grids, vaff, offsets, dims, borders, ranges, valid, bo,
              go, np.full(3, cpd, np.float32))
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays], bs


def _nonrigid_check(dev, args, bs, fusion_type):
    from bigstitcher_spark_tpu_torch.ops import nonrigid as NR

    args = [a.to(dev) for a in args]
    got = NR.nonrigid_fuse_block(*args, bs, fusion_type)
    ref = NR.nonrigid_fuse_block_plain(*args, bs, fusion_type)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("fusion_type", FTYPES)
def test_nonrigid_fuse_kernel(dev, fusion_type):
    """4 views, the last padded (valid 0, identity grid, zero affine)."""
    args, bs = _nonrigid_case(np.random.default_rng(41), "uint16")
    _nonrigid_check(dev, args, bs, fusion_type)


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int16", "float32"])
def test_nonrigid_fuse_kernel_dtypes(dev, dtype):
    args, bs = _nonrigid_case(np.random.default_rng(42), dtype)
    _nonrigid_check(dev, args, bs, "AVG_BLEND")


def test_nonrigid_fuse_kernel_four_views(dev):
    args, bs = _nonrigid_case(np.random.default_rng(43), "uint16", n_valid=4)
    _nonrigid_check(dev, args, bs, "AVG_BLEND")


def test_nonrigid_fuse_launch_counts_and_no_cpu_fallback(dev):
    from bigstitcher_spark_tpu_torch.ops import nonrigid as NR

    args, bs = _nonrigid_case(np.random.default_rng(44), "uint16")
    args = [a.to(dev) for a in args]
    ops.reset_launch_counts()
    NR.nonrigid_fuse_block(*args, bs, "AVG")
    NR.nonrigid_fuse_block_plain(*args, bs, "AVG")
    assert ops.launch_counts()["nonrigid_fuse"] == 1
    bad = list(args)
    bad[1] = bad[1].to(torch.float64)
    with pytest.raises(ValueError):
        NR.nonrigid_fuse_block(*bad, bs, "AVG")
    bad = list(args)
    bad[8] = bad[8].cpu()
    with pytest.raises(ValueError):
        NR.nonrigid_fuse_block(*bad, bs, "AVG")
    assert ops.launch_counts()["nonrigid_fuse"] == 1


# ragged blocks, one view to 33, spacings whose tiles overflow K26's table
# (0.5 at 64 z outputs a tile, 1.0 at 128) and grid origins that clamp the
# grid coordinates above the last vertex (-35) and below 0 (+50)
NONRIGID_CASES = [((5, 3, 7), 1, 1, 10.0, 0.0), ((1, 1, 1), 4, 3, 10.0, 0.0),
                  ((3, 40, 9), 9, 9, 10.0, -35.0),
                  ((2, 5, 64), 33, 20, 10.0, 0.0),
                  ((2, 17, 33), 4, 4, 0.5, 0.0),
                  ((2, 3, 130), 4, 4, 1.0, 50.0)]


@pytest.mark.parametrize("fusion_type", FTYPES)
@pytest.mark.parametrize("case", NONRIGID_CASES, ids=lambda c: "x".join(
    map(str, c[0])) + f"-V{c[1]}-cpd{c[3]:g}-shift{c[4]:g}")
def test_nonrigid_fuse_kernel_ragged(dev, case, fusion_type):
    bs, V, n_valid, cpd, shift = case
    args, bs = _nonrigid_case(np.random.default_rng(45), "uint16", V,
                              n_valid, bs, cpd, shift)
    _nonrigid_check(dev, args, bs, fusion_type)


def _nonrigid_64bit_rows(dev, rows):
    """``rows`` sets of K26 inputs of one uint8 view of 1300^3 (past 2^31
    elements; each row its own draws) and a small block at its far corner,
    on ``dev``."""
    from bigstitcher_spark_tpu_torch.models.nonrigid_fusion import (
        control_grid_dims)
    from bigstitcher_spark_tpu_torch.ops.nonrigid import fit_control_grid

    n, bs = 1300, (16, 12, 8)
    assert F.resample_plan(bs, 1, (n, n, n)).idx64
    rng = np.random.default_rng(46)
    bo = np.array([5000.5, 3000.25, 700.75], np.float32)
    go = bo - np.float32(10.0)
    gdims = control_grid_dims(bs, 10.0)
    out = []
    for r in range(rows):
        t = bo + rng.uniform(-10, 20, (30, 3))
        vw = t + rng.normal(0, 0.5, (30, 3))
        grid = fit_control_grid(t, vw, go.astype(np.float64), gdims, 10.0)
        vaff = np.zeros((1, 3, 4), np.float32)
        vaff[0, :, :3] = np.eye(3)
        vaff[0, :, 3] = -bo + np.array([n - 14.5, n - 11.5, n - 9.5])
        g = torch.Generator(device=dev).manual_seed(46 + r)
        patches = torch.randint(0, 256, (1, n, n, n), dtype=torch.uint8,
                                device=dev, generator=g)
        arrays = (grid[None], vaff, np.full((1, 3), 100.0, np.float32),
                  np.full((1, 3), n + 150.0, np.float32),
                  rng.uniform(0, 2, (1, 3)).astype(np.float32),
                  rng.uniform(4, 12, (1, 3)).astype(np.float32),
                  np.ones(1, np.float32), bo, go,
                  np.full(3, 10.0, np.float32))
        out.append([patches] + [torch.from_numpy(np.ascontiguousarray(a))
                                for a in arrays])
    return out, bs


def test_nonrigid_fuse_kernel_64bit_patch(dev):
    """One uint8 view of 1300^3 (past 2^31 elements) and a small block at
    its far corner: the 64-bit index instantiation, against the twin."""
    (args,), bs = _nonrigid_64bit_rows(dev, 1)
    _nonrigid_check(dev, args, bs, "AVG_BLEND")


def test_nonrigid_batch_form_64bit_patch(dev):
    """K26's batch form's 64-bit index instantiation: two rows of a 1300^3
    uint8 view, each bitwise the per-block kernel's, the batch within the
    per-block tolerance of its twin."""
    from bigstitcher_spark_tpu_torch.ops import nonrigid as NR

    per_row, bs = _nonrigid_64bit_rows(dev, 2)
    args = [torch.stack([r[j] for r in per_row]).to(dev) for j in range(11)]
    got = NR.nonrigid_fuse_block_batch(*args, bs, "AVG_BLEND")
    for b, row in enumerate(per_row):
        want = NR.nonrigid_fuse_block(*(a.to(dev) for a in row), bs,
                                      "AVG_BLEND")
        for g, w in zip(got, want):
            assert torch.equal(g[b], w), f"row {b}"
    del per_row
    ref = NR.nonrigid_fuse_block_batch_plain(*args, bs, "AVG_BLEND")
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)


# --------------------------------------------------------------- K27, K6


def _scan_case(rng, dtype=np.uint16, V=3, tshape=(60, 52, 28),
               bs=(24, 20, 12), grid=(2, 2, 2), K=4):
    """Resident tiles and a grid of blocks, K view slots each: floor
    offsets below 0 and past tshape - ps (clamped, wrapped windows), one
    slot in four invalid, inside offsets up to 1.5."""
    tiles = rng.integers(0, 4000, (V, *tshape)).astype(dtype)
    offs = np.array([(x * bs[0], y * bs[1], z * bs[2])
                     for x in range(grid[0]) for y in range(grid[1])
                     for z in range(grid[2])], np.int32)
    B = len(offs)
    lim = np.array(tshape) - np.array(bs) - 1
    fo = rng.integers(-6, lim + 7, (B, K, 3)).astype(np.int32)
    fr = rng.uniform(0, 1, (B, K, 3)).astype(np.float32)
    per = lambda lo, hi: rng.uniform(lo, hi, (B, K, 3)).astype(np.float32)
    args = [tiles, rng.integers(0, V, (B, K)).astype(np.int32), fo, fr,
            (fo + fr).astype(np.float32),
            np.broadcast_to(np.array(tshape, np.float32), (B, K, 3)).copy(),
            per(0, 3), per(4, 12),
            (rng.uniform(size=(B, K)) > 0.25).astype(np.float32), offs]
    out_shape = tuple(g * b for g, b in zip(grid, bs))
    return [torch.from_numpy(a) for a in args], per(0, 1.5), out_shape, bs


@pytest.mark.parametrize("fusion_type,out_dtype,masks", [
    *[(ft, "uint16", False) for ft in FTYPES],
    ("AVG_BLEND", "uint8", False), ("AVG_BLEND", "float32", False),
    ("AVG_BLEND", "uint16", True), ("FIRST_WINS", "float32", True)])
def test_fuse_volume_scan_kernel(dev, fusion_type, out_dtype, masks):
    """K27 (+ K4) against its twin on the card, bitwise: the same K2 math
    on the same weight tables, read through the wrapped windows."""
    args, io, out_shape, bs = _scan_case(np.random.default_rng(47))
    args = [a.to(dev) for a in args]
    kw = dict(fusion_type=fusion_type, out_dtype=out_dtype, masks=masks,
              inside_offs=torch.from_numpy(io).to(dev))
    ops.reset_launch_counts()
    got = F.fuse_volume_scan(*args, 100.0, 3500.0, out_shape, bs, **kw)
    counts = ops.launch_counts()
    ref = F.fuse_volume_scan_plain(*args, 100.0, 3500.0, out_shape, bs, **kw)
    assert counts["fuse_volume_scan"] == 1
    assert counts["convert_intensity"] == int(not masks)
    assert got.dtype == ref.dtype
    assert torch.equal(got.to(torch.float32), ref.to(torch.float32))
    assert float(got.to(torch.float32).std()) > 0


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32], ids=str)
def test_fuse_volume_scan_kernel_dtypes(dev, dtype):
    args, io, out_shape, bs = _scan_case(np.random.default_rng(48), dtype)
    args = [a.to(dev) for a in args]
    got = F.fuse_volume_scan(*args, 0.0, 4000.0, out_shape, bs,
                             out_dtype="float32")
    ref = F.fuse_volume_scan_plain(*args, 0.0, 4000.0, out_shape, bs,
                                   out_dtype="float32")
    assert torch.equal(got, ref)


def test_fuse_volume_scan_refuses_and_counts(dev):
    args, _io, out_shape, bs = _scan_case(np.random.default_rng(49))
    args = [a.to(dev) for a in args]
    ops.reset_launch_counts()
    bad = list(args)
    bad[1] = bad[1] + 3  # past the tiles
    with pytest.raises(ValueError, match="index the 3 tiles"):
        F.fuse_volume_scan(*bad, 0.0, 1.0, out_shape, bs)
    with pytest.raises(ValueError, match="must hold a patch"):
        F.fuse_volume_scan(*args, 0.0, 1.0, out_shape, (60, 20, 12))
    assert ops.launch_counts()["fuse_volume_scan"] == 0


@pytest.mark.parametrize("shape", [(1001,), (33, 17), (5, 64, 9),
                                   (3, 4, 65, 7)], ids=str)
@pytest.mark.parametrize("dtype", [np.uint16, np.int16, np.float32], ids=str)
def test_halfpixel_downsample2x_axis_kernel(dev, shape, dtype):
    """K6's one-axis form against its twin on the card, bitwise, along
    every axis; one K6 launch each."""
    rng = np.random.default_rng(50)
    if dtype == np.float32:
        a = rng.normal(0, 1e3, shape)
    else:
        a = rng.integers(np.iinfo(dtype).min, np.iinfo(dtype).max + 1, shape)
    x = torch.from_numpy(a.astype(dtype)).to(dev)
    for axis in range(len(shape)):
        ops.reset_launch_counts()
        got = D.halfpixel_downsample2x_axis(x, axis)
        assert ops.launch_counts()["downsample_batch"] == 1
        ref = D.halfpixel_downsample2x_axis_plain(x, axis)
        assert got.dtype == torch.float32 and torch.equal(got, ref)


# ------------------------------------------------ batch forms of K2, K3, K5


def _batch_case(kind, rng, B, V, bs, ps, coeffs=False):
    """A batch of random kernel inputs for ``kind`` ("shift", "sep",
    "gather"), the last row padding (zero patches, valid 0); returns
    (inputs in the wrapper's order but the inside offsets, inside offsets,
    coefficient keywords)."""
    def pv(lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, (B, V, 3)).astype(
            np.float32))

    if kind == "shift":
        patches = rng.integers(0, 4000, (B, V, *(s + 1 for s in bs)))
        fr = pv(0, 1)
        head = (fr, pv(-20, 60) + fr)
    else:
        patches = rng.integers(0, 4000, (B, V, *ps))
        if kind == "sep":
            head = (pv(0.5, 1.5), pv(-2, 4), pv(0, 30))
        else:
            aff = np.zeros((B, V, 3, 4), np.float32)
            a = np.deg2rad(rng.uniform(-10, 10, (B, V)))
            aff[..., 0, 0] = aff[..., 1, 1] = np.cos(a)
            aff[..., 0, 1], aff[..., 1, 0] = -np.sin(a), np.sin(a)
            aff[..., 2, 2] = 1.0
            aff[..., 3] = rng.uniform(-6, 12, (B, V, 3))
            head = (torch.from_numpy(aff), pv(0, 30))
    patches = torch.from_numpy(patches.astype(np.uint16))
    patches[-1] = 0
    valid = torch.ones((B, V))
    valid[-1] = 0
    valid[0, -1] = 0
    dims = torch.from_numpy(np.tile(np.float32([70, 60, 30]), (B, V, 1)))
    extra = {}
    if coeffs:
        g = rng.uniform(0.8, 1.2, (B, V, 3, 2, 4, 2)).astype(np.float32)
        ca = np.zeros((B, V, 3, 4), np.float32)
        ca[..., :3, :3] = np.eye(3) * 0.05
        ca[..., 3] = rng.uniform(-0.5, 0.5, (B, V, 3))
        extra = dict(coeffs=torch.from_numpy(g),
                     coeff_affines=torch.from_numpy(ca))
    return ((patches, *head, dims, pv(0, 3), pv(5, 30), valid), pv(0, 2),
            extra)


_BATCH_FORMS = {"shift": (F.fuse_block_shift_batch, F.fuse_block_shift),
                "sep": (F.fuse_block_sep_batch, F.fuse_block_sep),
                "gather": (F.fuse_block_batch, F.fuse_block)}


@pytest.mark.parametrize("bs,ps", [((24, 20, 16), (32, 28, 20)),
                                   ((9, 40, 70), (16, 48, 80))],
                         ids=["small", "ragged"])
@pytest.mark.parametrize("kind,coeff", [("shift", False), ("sep", False),
                                        ("gather", False), ("gather", True)])
@pytest.mark.parametrize("fusion_type", FTYPES)
def test_batch_form_bitwise_per_block_kernel(dev, kind, coeff, fusion_type,
                                             bs, ps):
    """Each row of a batch launch equals the per-block launch on the same
    inputs bit for bit; the padding row writes zeros; one launch."""
    batch, single = _BATCH_FORMS[kind]
    rng = np.random.default_rng(61)
    args, ioffs, extra = _batch_case(kind, rng, 3, 3, bs, ps, coeff)
    args = [a.to(dev) for a in args]
    ioffs = ioffs.to(dev)
    extra = {k: v.to(dev) for k, v in extra.items()}
    ops.reset_launch_counts()
    got = batch(*args, bs, fusion_type, ioffs, **extra)
    counts = {**ops.launch_counts(), **ops.coeff_launch_counts()}
    assert counts[batch.__name__] == 1 and counts[single.__name__] == 0
    if coeff:
        assert counts["fuse_block_batch+coeff"] == 1
    for b in range(args[0].shape[0]):
        row = {k: v[b].contiguous() for k, v in extra.items()}
        want = single(*(a[b].contiguous() for a in args), bs, fusion_type,
                      ioffs[b].contiguous(), **row)
        for g, w in zip(got, want):
            assert torch.equal(g[b], w), f"row {b}"
    assert not got[0][-1].any() and not got[1][-1].any()
    ref = batch(*(a.cpu() for a in args), bs, fusion_type, ioffs.cpu(),
                **{k: v.cpu() for k, v in extra.items()})
    torch.testing.assert_close(got[0].cpu(), ref[0], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[1].cpu(), ref[1], rtol=0, atol=1e-5)


# ------------------------------------------------------ K26's batch form


def _nonrigid_batch(rng, dtype, rows, V, n_valid, bs, cpd=10.0):
    """``rows`` distinct K26 rows of :func:`_nonrigid_case` (each its own
    draws and block origin) and a padding row (all zeros, as the sharded
    route pads)."""
    per = []
    for r in range(rows):
        args, _bs = _nonrigid_case(rng, dtype, V, n_valid, bs, cpd)
        for j in (8, 9):  # the row's block and grid origins
            args[j] = args[j] + np.float32(3.0 * r)
        per.append(args)
    per.append([torch.zeros_like(a) for a in per[0]])
    return [torch.stack([p[j] for p in per]) for j in range(11)], bs


@pytest.mark.parametrize("dtype", ["uint16", "float32"])
@pytest.mark.parametrize("case", [((24, 20, 16), 4, 3), ((5, 3, 7), 1, 1),
                                  ((2, 5, 64), 9, 9)],
                         ids=["small", "ragged-V1", "ragged-V9"])
@pytest.mark.parametrize("fusion_type", FTYPES)
def test_nonrigid_batch_form_bitwise_per_block_kernel(dev, fusion_type, case,
                                                      dtype):
    """Each row of K26's batch launch equals the per-block launch on the
    same inputs bit for bit; the padding row writes zeros; one launch; the
    batch within the per-block tolerance of its twin."""
    from bigstitcher_spark_tpu_torch.ops import nonrigid as NR

    bs, V, n_valid = case
    args, bs = _nonrigid_batch(np.random.default_rng(71), dtype, 3, V,
                               n_valid, bs)
    args = [a.to(dev) for a in args]
    ops.reset_launch_counts()
    got = NR.nonrigid_fuse_block_batch(*args, bs, fusion_type)
    counts = ops.launch_counts()
    assert counts["nonrigid_fuse_batch"] == 1
    assert counts["nonrigid_fuse"] == 0
    for b in range(3):
        want = NR.nonrigid_fuse_block(*(a[b].contiguous() for a in args), bs,
                                      fusion_type)
        for g, w in zip(got, want):
            assert torch.equal(g[b], w), f"row {b}"
    assert not got[0][-1].any() and not got[1][-1].any()
    assert len({float(f.sum()) for f in got[0][:3]}) == 3
    ref = NR.nonrigid_fuse_block_batch_plain(*args, bs, fusion_type)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)


def test_nonrigid_batch_form_refuses_bad_inputs(dev):
    from bigstitcher_spark_tpu_torch.ops import nonrigid as NR

    args, bs = _nonrigid_batch(np.random.default_rng(72), "uint16", 2, 4, 3,
                               (24, 20, 16))
    args = [a.to(dev) for a in args]
    ops.reset_launch_counts()
    bad = list(args)
    bad[8] = bad[8][0].contiguous()  # a per-block origin
    with pytest.raises(ValueError):
        NR.nonrigid_fuse_block_batch(*bad, bs, "AVG")
    bad = list(args)
    bad[1] = bad[1].cpu()
    with pytest.raises(ValueError):
        NR.nonrigid_fuse_block_batch(*bad, bs, "AVG")
    assert ops.launch_counts()["nonrigid_fuse_batch"] == 0


# ------------------------------------------------------ K28 block epilogue


@pytest.mark.parametrize("out_dtype,masks,rels,shape", [
    ("uint16", False, (), (32, 16, 8)),
    ("uint16", False, ((2, 2, 2), (2, 2, 1)), (32, 16, 8)),
    ("uint8", False, ((2, 2, 1),), (32, 16, 8)),
    ("float32", False, ((2, 2, 1), (2, 1, 2)), (32, 16, 8)),
    ("uint16", True, ((2, 2, 1),), (32, 16, 8)),
    ("float32", True, ((2, 2, 2),), (32, 16, 8)),
    ("uint16", False, ((3, 3, 1), (2, 1, 2)), (36, 18, 8)),
    ("uint16", False, ((4, 2, 1), (1, 2, 2), (2, 2, 2)), (32, 16, 8)),
])
def test_block_epilogue_kernel_bitwise_twin(dev, out_dtype, masks, rels,
                                            shape):
    """K28 against its plain twin on the card: s0 and every level equal bit
    for bit (the same float32 operations in the same order, IEEE
    division)."""
    from bigstitcher_spark_tpu_torch.ops import epilogue as E

    rng = np.random.default_rng(62)
    B = 3
    fused = torch.from_numpy(rng.uniform(-50, 3300, (B, *shape)).astype(
        np.float32)).to(dev)
    wsum = torch.from_numpy(np.where(
        rng.random((B, *shape)) < 0.3, 0.0,
        rng.uniform(0, 2, (B, *shape))).astype(np.float32)).to(dev)
    ops.reset_launch_counts()
    got = E.block_epilogue(fused, wsum, 0.0, 3000.0, out_dtype, masks, rels)
    assert ops.launch_counts()["block_epilogue"] == 1
    want = E.block_epilogue_plain(fused, wsum, 0.0, 3000.0, out_dtype, masks,
                                  rels)
    assert len(got) == len(want) == 1 + len(rels)
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w), f"level {lvl}"
    with pytest.raises(ValueError, match="do not divide"):
        E.block_epilogue(fused, wsum, 0.0, 1.0, out_dtype, masks,
                         ((5, 1, 1),))


@pytest.mark.parametrize("out_dtype", ["uint8", "uint16", "float32"])
@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("shape,rels,launches", [
    ((32, 16, 8), ((2, 2, 2),), 1),
    ((36, 18, 8), ((3, 3, 1), (2, 1, 2)), 1),
    ((32, 16, 8), ((4, 2, 1), (1, 2, 2), (2, 2, 2)), 1),
    ((16, 200, 64), ((2, 2, 2),), 1),
    ((12, 40, 20), ((2, 2, 2), (2, 2, 2)), 1),
    ((6, 10, 14), ((2, 2, 2),), 1),
    ((128, 128, 2), ((4, 4, 1), (4, 4, 1), (8, 8, 1)), None)],
    ids=["1", "2-mixed", "3-mixed", "edge", "2-edge", "odd-z", "segments"])
def test_block_epilogue_tiles_bitwise_twin(dev, out_dtype, masks, shape, rels,
                                           launches):
    """K28's tiles (masked edges, blocks whose z is no multiple of 4,
    levels split into segments where their footprint passes shared
    memory) against the twin on the card: s0 and every level bit for bit;
    one launch a segment of ops.epilogue.epilogue_plan."""
    from bigstitcher_spark_tpu_torch.ops import epilogue as E

    rng = np.random.default_rng(64)
    B = 2
    fused = torch.from_numpy(rng.uniform(-50, 3300, (B, *shape)).astype(
        np.float32))
    fused.view(-1)[3::11] = -0.0
    wsum = torch.from_numpy(np.where(
        rng.random((B, *shape)) < 0.3, 0.0,
        rng.uniform(0, 2, (B, *shape))).astype(np.float32))
    fused, wsum = fused.to(dev), wsum.to(dev)
    ops.reset_launch_counts()
    got = E.block_epilogue(fused, wsum, 0.0, 3000.0, out_dtype, masks, rels)
    itemsize = got[0].element_size()
    n_seg = len(E.epilogue_plan(shape, rels, itemsize))
    assert launches is None or n_seg == launches
    assert ops.launch_counts()["block_epilogue"] == n_seg
    want = E.block_epilogue_plain(fused, wsum, 0.0, 3000.0, out_dtype, masks,
                                  rels)
    assert len(got) == len(want) == 1 + len(rels)
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w), f"level {lvl}"


# --------------------------------------------------- K29, K24's partial form


@pytest.mark.parametrize("n,S,with_rep,with_dot", [
    (512 * 36, 4, False, False), (2 * 512, 4, False, False),
    (524_288, 4, True, True), (524_288 + 17, 3, True, True),
    (1000, 1, False, True), (300_001, 64, False, False)])
def test_shard_sum_kernel(dev, n, S, with_rep, with_dot):
    """K29 against shard_sum_plain on the card: the sum bitwise (the same
    adds in shard order), the dot within rtol 1e-12 of the twin's
    torch.dot (another order); the ticket back to 0; nothing once done."""
    from bigstitcher_spark_tpu_torch.ops import shard as K

    g = torch.Generator(device=dev)
    g.manual_seed(n + S)
    f64 = dict(dtype=torch.float64, device=dev)
    parts = [torch.randn(n, generator=g, **f64) * 10.0 ** (d % 5 - 2)
             for d in range(S)]
    rep = torch.randn(n, generator=g, **f64) if with_rep else None
    v = torch.randn(n, generator=g, **f64) if with_dot else None
    outs = []
    for fn in (K.shard_sum, K.shard_sum_plain):
        out = torch.empty(n, **f64)
        dot = torch.zeros(1, **f64) if with_dot else None
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        ops.reset_launch_counts()
        fn(parts, out, rep=rep, v=v, dot=dot, ticket=ticket)
        assert ops.launch_counts()["shard_sum"] == (fn is K.shard_sum)
        assert int(ticket) == 0
        outs.append((out, dot))
    assert torch.equal(outs[0][0], outs[1][0])
    if with_dot:
        torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-12,
                                   atol=0.0)
    done = torch.ones(1, dtype=torch.int32, device=dev)
    kept = torch.full((n,), 7.0, **f64)
    K.shard_sum(parts, kept, done=done)
    assert bool((kept == 7.0).all()), "a launch after done writes"


def test_shard_sum_kernel_refuses_other_device_args(dev):
    from bigstitcher_spark_tpu_torch.ops import shard as K

    out = torch.zeros(8, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        K.shard_sum([out.clone()], out, rep=torch.zeros(8,
                                                        dtype=torch.float64))


@pytest.mark.parametrize("store", [True, False])
@pytest.mark.parametrize("n_views,dims,n_matches", [
    (3, (4, 4, 4), 300), (64, (8, 8, 8), 4000)])
def test_cg_partial_kernel(dev, store, n_views, dims, n_matches):
    """K24's partial form on a shard's CSR (JAX's strided rows, 4 shards)
    and on the replicated one: Ap bitwise the full form's on the same
    lists (the same sums in the same order), within rtol 1e-12 of the
    twin's; p_new bitwise the twin's where stored, untouched where not;
    nothing once done."""
    C, (rows, diag, rhs, sidx, sw) = _cg_case(5, n_views, dims, n_matches)
    sysm = R.assemble_cg(C, rows, diag, rhs, sidx, sw, dev, n_shards=4)
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    f64 = dict(dtype=torch.float64, device=dev)
    r = torch.randn(sysm.n, generator=g, **f64)
    p_old = torch.randn(sysm.n, generator=g, **f64)
    for part in (sysm.shards[1], sysm.reps[0]):
        d, i = R.cg_state(part, dev)
        d[1] = 0.375
        pn_full, ap_full = torch.empty_like(r), torch.empty_like(r)
        R.cg_spmv(part, r, p_old, pn_full, ap_full, d, i)
        pn = torch.full_like(r, -3.0)
        ap = torch.empty_like(r)
        ops.reset_launch_counts()
        R.cg_spmv_partial(part, r, p_old, pn if store else None, ap, d, i)
        assert ops.launch_counts()["cg_spmv_partial"] == 1
        assert ops.launch_counts()["cg_spmv"] == 0
        assert torch.equal(ap, ap_full)
        pn_t, ap_t = torch.empty_like(r), torch.empty_like(r)
        R.cg_spmv_partial_plain(part, r, p_old, pn_t, ap_t, d, i)
        torch.testing.assert_close(ap, ap_t, rtol=1e-12, atol=1e-12)
        if store:
            assert torch.equal(pn, pn_t) and torch.equal(pn, pn_full)
        else:
            assert bool((pn == -3.0).all())
        i[1] = 1
        ap.fill_(5.0)
        R.cg_spmv_partial(part, r, p_old, None, ap, d, i)
        assert bool((ap == 5.0).all()), "a launch after done writes"


def test_sharded_relax_on_the_card(dev, tmp_path):
    """The sharded relax on [cuda] * 4 (4 shards, one distinct device):
    bitwise the one-device relax on the card; K11 and K13 a shard, K12 and
    K14 once a sweep (adding the shards' partials as they load them), K29
    for the origins and the link errors only."""
    tiles, links, rows = _relax_graph(tmp_path, 60)
    T = len(tiles)
    one = R.prepare_relax(rows, T, dev)
    sh = R.prepare_relax(rows, T, dev, 4, mesh=[dev] * 4)
    fixed = np.zeros(T, bool)
    fixed[0] = True
    warm = np.random.default_rng(35).uniform(-2, 2, (T, 3))
    warm[0] = 0.0
    mask = np.ones(len(rows))
    mask[2] = 0.0
    args = (mask, fixed, warm, 0.1, 1.0, 5.0, 300, "AFFINE", "RIGID", 40)
    a = R.relax_on_device(one, *args)
    ops.reset_launch_counts()
    b = R.relax_on_device(sh, *args)
    counts = ops.launch_counts()
    assert a.iterations == b.iterations > 0
    for x, y in ((a.history, b.history), (a.models, b.models),
                 (a.link_errors, b.link_errors)):
        assert np.array_equal(x, y)
    sweeps = counts["relax_fit"]
    assert counts["relax_moments"] == 4 * sweeps
    assert counts["relax_error"] == 4 * sweeps + 4
    assert counts["relax_converge"] == sweeps
    assert counts["relax_error_converge"] == 0
    assert counts["shard_sum"] == 2
    ref = R.relax_plain(sh, *args)
    assert ref.iterations == b.iterations
    np.testing.assert_allclose(b.history, ref.history, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(b.models, ref.models, rtol=1e-7, atol=1e-9)


def test_sharded_cg_on_the_card(dev):
    """The sharded CG on [cuda] * 4: within rtol / atol 1e-8 of the
    one-device CG (JAX's contract), within rtol 1e-9 of its twin loop;
    K24's partial form and K29, no full K24."""
    C, (rows, diag, rhs, sidx, sw) = _cg_case(5, 64, (8, 8, 8), 4000)
    one = R.cg_on_device(R.assemble_cg(C, rows, diag, rhs, sidx, sw, dev))
    sysm = R.assemble_cg(C, rows, diag, rhs, sidx, sw, dev, n_shards=4,
                         mesh=[dev] * 4)
    ops.reset_launch_counts()
    got = R.cg_on_device(sysm)
    counts = ops.launch_counts()
    assert counts["cg_spmv"] == 0
    assert counts["cg_spmv_partial"] == 5 * counts["shard_sum"] > 0
    assert counts["cg_update"] == counts["shard_sum"]
    torch.testing.assert_close(got.x, one.x, rtol=1e-8, atol=1e-8)
    ref = R.cg_plain(sysm)
    assert abs(got.iterations - ref.iterations) <= 1
    scale = float(ref.x.abs().max())
    torch.testing.assert_close(got.x, ref.x, rtol=1e-9, atol=1e-9 * scale)
