"""The port's CUDA kernels (K1-K10) against their plain-torch twins, on the card.

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
with log2 N). K10 (top-k): indices equal.
"""

import numpy as np
import pytest
import torch

from bigstitcher_spark_tpu_torch import ops
from bigstitcher_spark_tpu_torch.ops import downsample as D
from bigstitcher_spark_tpu_torch.ops import fusion as F
from bigstitcher_spark_tpu_torch.ops import phasecorr as P

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
