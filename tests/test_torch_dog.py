"""The port's DoG ops (K15-K18's plain twins) against the JAX package, on
the CPU.

The JAX package picks its blur at trace time: circular edges by FFT on the
CPU, mirrored edges by Toeplitz matrix products (``gemm``) on the TPU. The
port implements the TPU semantics, so the oracle here is the JAX package
with ``BST_DOG_BLUR=gemm`` (set for one test, with ``jax.clear_caches()``
before and after so no other test sees the traced program). Inputs are
Gaussian beads from numpy seeds. Tolerances: one blur pass within rtol
1e-6 / atol 1e-3 of JAX's on intensities up to ~1,100; the response within 5e-6
(float32 sums of 13-15 taps in another order, scaled by 1/(k-1) ~ 5.3),
masks, candidate sets and counts equal, subpixel positions within 1e-4 px
and refined values within 1e-6 (the fit's 3x3 solve amplifies the
response's last-bit differences where the Hessian is poorly conditioned).
The FFT default agrees on the halo core only, within 2e-6 (the JAX
package's own bound between its two blurs).
"""

import jax
import numpy as np
import pytest
import torch

from bigstitcher_spark_tpu.ops import dog as J
from bigstitcher_spark_tpu_torch.ops import dog as T

RESP_ATOL = 5e-6
SUB_ATOL = 1e-4
VAL_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def jax_gemm(monkeypatch):
    """The JAX package with its mirrored (TPU) blur, for one test."""
    monkeypatch.setenv("BST_DOG_BLUR", "gemm")
    jax.clear_caches()
    yield
    jax.clear_caches()


def _beads(shape, n, seed, amp=1000.0, bg=100.0, noise=2.0):
    """Gaussian beads (sigma 1.8) anywhere in the volume, on a noisy
    background (tests/test_detection.py's _bead_volume, without its margin
    rule)."""
    rng = np.random.default_rng(seed)
    grid = np.meshgrid(*(np.arange(s, dtype=np.float64) for s in shape),
                       indexing="ij")
    vol = rng.normal(bg, noise, shape)
    for p in rng.uniform(0, np.array(shape) - 1, (n, 3)):
        vol += amp * np.exp(-sum((g - c) ** 2 for g, c in zip(grid, p))
                            / (2 * 1.8 ** 2))
    return vol.astype(np.float32)


def test_host_helpers_equal_jax():
    for s in (1.3, 1.8, 2.5, 4.0):
        assert np.array_equal(T.gaussian_kernel_1d(s), J.gaussian_kernel_1d(s))
        assert T.dog_halo(s) == J.dog_halo(s)
    assert T.DOG_K == J.DOG_K
    for n in (1, 2, 5, 17):
        for r in (0, 3, 7, 20):
            want = np.pad(np.arange(n), (r, r), mode="reflect")
            assert np.array_equal(T.reflect_index(n, r), want)


def test_localize_quadratic_and_sampling_equal_jax():
    """The host float64 fit and the trilinear sampler are the JAX code."""
    vol = _beads((40, 36, 32), 10, 1)
    dog, mask = J.dog_block(vol, np.float32(0), np.float32(1200),
                            np.float32(0.005), 1.8)
    dog = np.asarray(dog)
    coords = np.argwhere(np.asarray(mask))
    assert len(coords) > 3
    a, b = J.localize_quadratic(dog, coords), T.localize_quadratic(dog, coords)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    pts = np.random.default_rng(2).uniform(0, 30, (50, 3))
    assert np.array_equal(J.sample_trilinear(vol, pts),
                          T.sample_trilinear(vol, pts))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_blur_pass_matches_jax_separable(jax_gemm, axis):
    """One K15 pass against the JAX package's mirrored blur along the same
    axis (identity taps elsewhere), including a 5-voxel axis where the
    mirror repeats under 15 taps."""
    x = _beads((24, 20, 5), 4, 3)
    taps = J.gaussian_kernel_1d(1.8 * J.DOG_K)
    one = np.ones(1, np.float32)
    kernels = [taps if d == axis else one for d in range(3)]
    want = np.asarray(J._blur_separable(x, kernels))
    got = T.blur_plain(torch.from_numpy(x)[None], taps, axis)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("find_max,find_min", [(True, False), (False, True),
                                               (True, True)],
                         ids=["MAX", "MIN", "BOTH"])
@pytest.mark.parametrize("shape", [(32, 32, 32), (48, 44, 40), (64, 40, 36)],
                         ids=str)
def test_dog_block_matches_jax(jax_gemm, find_max, find_min, shape):
    vol = _beads(shape, 14, sum(shape))
    if find_min and not find_max:
        vol = 2000.0 - vol
    origin = np.array([-9, 37, 5], np.int32)
    jd, jm = J.dog_block(vol, np.float32(0), np.float32(1200),
                         np.float32(0.005), 1.8, find_max, find_min, origin)
    td, tm = T.dog_block(torch.from_numpy(vol), 0.0, 1200.0, 0.005, 1.8,
                         find_max, find_min, origin)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=RESP_ATOL)
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert int(tm.sum()) > 0


def test_dog_block_batch_matches_jax(jax_gemm):
    """uint16 blocks, per-block bounds, thresholds and origins."""
    blocks = np.stack([_beads((40, 36, 32), 12, s) for s in (4, 5, 6)])
    blocks = np.round(blocks).astype(np.uint16)
    lo = np.array([0, 50, 90], np.float32)
    hi = np.array([1200, 900, 1400], np.float32)
    thr = np.array([0.005, 0.004, 0.008], np.float32)
    org = np.array([[-9, -9, -9], [100, -9, 40], [2000, 3000, 70]], np.int32)
    jd, jm = J.dog_block_batch(blocks, lo, hi, thr, 1.8, True, True, org)
    td, tm = T.dog_block_batch(torch.from_numpy(blocks), lo, hi, thr, 1.8,
                               True, True, org)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=RESP_ATOL)
    assert np.array_equal(tm.numpy(), np.asarray(jm))


def test_degenerate_range_detects_nothing(jax_gemm):
    """min == max: the scale gates to 0, the response is 0 and nothing is
    detected, as in the JAX package."""
    flat = torch.full((32, 32, 32), 12345, dtype=torch.uint16)
    dog, mask = T.dog_block(flat, 12345.0, 12345.0, 0.008, 1.8)
    assert int(mask.sum()) == 0 and float(dog.abs().max()) == 0.0
    beads = np.round(_beads((32, 32, 32), 8, 9)).astype(np.uint16)
    jd, jm = J.dog_block(beads, np.float32(500), np.float32(500),
                         np.float32(0.008), 1.8)
    td, tm = T.dog_block(torch.from_numpy(beads), 500.0, 500.0, 0.008, 1.8)
    assert float(np.abs(np.asarray(jd)).max()) == float(td.abs().max()) == 0
    assert int(tm.sum()) == int(np.asarray(jm).sum()) == 0


def test_fft_default_agrees_on_the_halo_core():
    """Against the JAX package's CPU default (circular edges), the response
    agrees on the halo core only."""
    x = np.random.default_rng(4).random((48, 40, 32)).astype(np.float32)
    k1 = J.gaussian_kernel_1d(1.8)
    k2 = J.gaussian_kernel_1d(1.8 * J.DOG_K)
    fft = np.asarray(J._dog_response_fft(x, k1, k2))
    b1, b2 = T._blurs(T.PLAIN, torch.from_numpy(x)[None], 1.8)
    got = (b1 - b2)[0].numpy()
    h = T.dog_halo(1.8)
    core = (slice(h, -h),) * 3
    np.testing.assert_allclose(got[core], fft[core], rtol=0, atol=2e-6)


def _topk_case(rel, n_beads=25, seed=10):
    shape = (48 * rel[0], 40 * rel[1], 32 * rel[2])
    blocks = np.stack([_beads(shape, n_beads * rel[0] * rel[1], seed + b)
                       for b in range(2)])
    blocks = np.round(blocks).astype(np.uint16)
    return (blocks, np.zeros(2, np.float32), np.full(2, 1100.0, np.float32),
            np.full(2, 0.004, np.float32),
            np.array([[-8, -8, -8], [40, -8, 24]], np.int32))


def _check_topk(got, want, k):
    idx, sub, val, valid, count = (t.numpy() for t in got)
    jidx, jsub, jval, jvalid, jcount = (np.asarray(a) for a in want)
    assert np.array_equal(count, jcount)
    for b in range(idx.shape[0]):
        assert np.array_equal(valid[b], jvalid[b])
        # the kept rows in the same (|dog| descending, index) order
        assert np.array_equal(idx[b][valid[b]], jidx[b][jvalid[b]])
        np.testing.assert_allclose(sub[b][valid[b]], jsub[b][jvalid[b]],
                                   rtol=0, atol=SUB_ATOL)
        np.testing.assert_allclose(val[b][valid[b]], jval[b][jvalid[b]],
                                   rtol=0, atol=VAL_ATOL)
        # invalid rows: flat index 0, sub 0, val 0
        assert not idx[b][~valid[b]].any() and not sub[b][~valid[b]].any()
        assert not val[b][~valid[b]].any()
    assert valid.sum(1).tolist() == [min(k, int(c)) for c in count]


@pytest.mark.parametrize("rel", [(1, 1, 1), (2, 2, 1)], ids=str)
def test_dog_block_topk_batch_matches_jax(jax_gemm, rel):
    args = _topk_case(rel)
    halo = 8 if rel == (1, 1, 1) else 4
    want = J.dog_block_topk_batch(*args, 1.8, True, False, 4096, halo, rel)
    got = T.dog_block_topk_batch(torch.from_numpy(args[0]), *args[1:], 1.8,
                                 True, False, 4096, halo, rel)
    _check_topk(got, want, 4096)
    assert int(got[3].sum()) > 5


def test_dog_block_topk_truncation_matches_jax(jax_gemm):
    """K = 4 of many more extrema: the same 4 strongest, the exact count."""
    args = _topk_case((1, 1, 1), n_beads=40, seed=20)
    want = J.dog_block_topk_batch(*args, 1.8, True, True, 4, 8, (1, 1, 1))
    got = T.dog_block_topk_batch(torch.from_numpy(args[0]), *args[1:], 1.8,
                                 True, True, 4, 8, (1, 1, 1))
    _check_topk(got, want, 4)
    assert int(got[4].min()) > 4


def test_twins_compose_the_wrappers_on_the_cpu():
    """On CPU tensors the wrappers are the twins: the program through the
    wrappers equals the program through the twins, bit for bit."""
    args = _topk_case((2, 2, 1))
    x = torch.from_numpy(args[0])
    a = T.dog_block_topk_batch(x, *args[1:], 1.8, True, False, 64, 4,
                               (2, 2, 1))
    b = T.dog_block_topk_batch(x, *args[1:], 1.8, True, False, 64, 4,
                               (2, 2, 1), stages=T.PLAIN)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
