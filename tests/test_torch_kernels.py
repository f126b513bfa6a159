"""The port's CUDA kernels (K1-K4) against their plain-torch twins, on the card.

Every test here needs an NVIDIA GPU and nvcc; on a host without
``torch.cuda.is_available()`` each one skips and says so. On the card:

    BST_TEST_TPU=1 python -m pytest tests/test_torch_kernels.py -m cuda

(``BST_TEST_TPU=1`` keeps tests/conftest.py from importing JAX, which the
card machine does not have.) Tolerances: fused float32 rtol 1e-5 / atol
1e-3 and wsum atol 1e-5 (both sides round every float op; cosf and the
CPU/GPU cos differ in the last bits); converted integers |delta| <= 1.
"""

import numpy as np
import pytest
import torch

from bigstitcher_spark_tpu_torch.ops import fusion as F

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
    F.reset_launch_counts()
    x = torch.zeros(10, device=dev)
    F.convert_intensity(x, 0.0, 1.0, "uint8")
    assert F.launch_counts()["convert_intensity"] == 1
    with pytest.raises(ValueError):
        F.convert_intensity(x.to(torch.float64), 0.0, 1.0, "uint8")
