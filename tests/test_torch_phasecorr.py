"""The port's phase correlation (K7-K10 twins and the host refinement)
against the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX functions (jitted on the
CPU, as the JAX package's own tests run them) and through the port's
wrappers on CPU tensors, which take the plain-torch twins. Tolerances:

* peaks: equal index by index, except where the two candidates' PCM
  values are within 1e-4 relative of each other (a near tie, which float32
  round-off of different FFTs may order either way);
* window: rtol 1e-5, atol 5e-7 x max|x| (the mean is a float32 sum in JAX,
  a float64 sum rounded once in the port: a few ulps of the mean apart);
* cross power: rtol 1e-5 / atol 1e-6 against the JAX formula in numpy;
* FFT passes composed in float64 against numpy: 1e-12 relative;
* refine_peaks: bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from bigstitcher_spark_tpu.ops import phasecorr as JP
from bigstitcher_spark_tpu_torch.ops import phasecorr as TP


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # torch's CPU pool is far slower than one thread on small tensors here
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smooth_noise(shape, seed=0, sigma=2.0):
    rng = np.random.default_rng(seed)
    return gaussian_filter(rng.normal(100, 20, shape).astype(np.float32),
                           sigma)


def _pair(shape, ext, shift, seed, dtype):
    """Padded crops a, b of a smooth field, b shifted by ``shift``."""
    big = _smooth_noise(tuple(e + 16 for e in ext), seed, 1.0) * 10.0
    s = np.asarray(shift)
    a = big[8:8 + ext[0], 8:8 + ext[1], 8:8 + ext[2]]
    b = big[8 - s[0]:8 - s[0] + ext[0], 8 - s[1]:8 - s[1] + ext[1],
            8 - s[2]:8 - s[2] + ext[2]]
    pa, pb = TP.pad_to(a, shape), TP.pad_to(b, shape)
    if dtype == "uint16":
        pa, pb = np.round(pa).astype(np.uint16), np.round(pb).astype(np.uint16)
    return pa, pb


CASES = [  # (padded shape, extent, shift)
    ((16, 16, 16), (16, 16, 16), (2, -1, 3)),      # cubic
    ((32, 16, 8), (27, 13, 8), (-3, 2, 1)),        # non-cubic, ext < shape
    ((32, 16, 1), (30, 11, 1), (4, -2, 0)),        # a length-1 axis
]


def _assert_peaks_agree(got, ref, pcm):
    """Index by index, or a near tie of the two candidates' PCM values."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    for k in range(got.shape[0]):
        if (got[k] == ref[k]).all():
            continue
        vg, vr = pcm[tuple(got[k])], pcm[tuple(ref[k])]
        assert abs(vg - vr) <= 1e-4 * max(abs(vg), abs(vr)), (
            f"peak {k}: {got[k]} ({vg}) vs JAX {ref[k]} ({vr})")


@pytest.mark.parametrize("dtype", ["uint16", "float32"])
@pytest.mark.parametrize("shape,ext,shift", CASES, ids=str)
def test_pcm_peaks_matches_jax(shape, ext, shift, dtype):
    a, b = _pair(shape, ext, shift, 1, dtype)
    e = np.array(ext, np.int32)
    ref = np.asarray(JP.pcm_peaks(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(e), jnp.asarray(e), 5, 0.25))
    ta, tb = torch.from_numpy(a)[None], torch.from_numpy(b)[None]
    te = torch.from_numpy(e)[None]
    got, pcm = TP.pcm_peaks_plain(ta, tb, te, te, 5, 0.25, return_pcm=True)
    _assert_peaks_agree(got[0], ref, pcm[0].numpy())
    # a peak names the shift: index -shift modulo the padded shape
    assert tuple(int(-s) % n for s, n in zip(shift, shape)) in [
        tuple(p) for p in got[0].tolist()]
    # the wrapper on CPU tensors takes the same twins
    assert torch.equal(TP.pcm_peaks(torch.from_numpy(a), torch.from_numpy(b),
                                    ext, ext), got[0])


def test_pcm_peaks_batch_matches_jax():
    """Two pairs of one bucket, uint16, each with its own extents."""
    shape = (32, 16, 8)
    pairs = [_pair(shape, (27, 13, 8), (-3, 2, 1), 2, "uint16"),
             _pair(shape, (32, 16, 6), (1, 1, -2), 3, "uint16")]
    a = np.stack([p[0] for p in pairs])
    b = np.stack([p[1] for p in pairs])
    ext = np.array([[27, 13, 8], [32, 16, 6]], np.int32)
    ref = np.asarray(JP.pcm_peaks_batch(a, b, ext, ext, 7, 0.25))
    t = lambda x: torch.from_numpy(x)
    got, pcm = TP.pcm_peaks_plain(t(a), t(b), t(ext), t(ext), 7, 0.25,
                                  return_pcm=True)
    for k in range(2):
        _assert_peaks_agree(got[k], ref[k], pcm[k].numpy())
    assert torch.equal(TP.pcm_peaks_batch(t(a), t(b), t(ext), t(ext), 7),
                       got)


@pytest.mark.parametrize("shape,ext", [((16, 16, 16), (12, 16, 9)),
                                       ((32, 16, 8), (32, 10, 8)),
                                       ((16, 8, 1), (13, 8, 1))], ids=str)
@pytest.mark.parametrize("dtype", ["uint16", "float32"])
def test_window_twin_matches_jax(shape, ext, dtype):
    rng = np.random.default_rng(5)
    x = np.zeros(shape, np.float32)
    x[:ext[0], :ext[1], :ext[2]] = gaussian_filter(
        rng.normal(1000, 200, ext), 2).astype(np.float32)
    if dtype == "uint16":
        x = np.round(x).astype(np.uint16)
    ref = np.asarray(JP._windowed(jnp.asarray(x).astype(jnp.float32),
                                  jnp.asarray(ext, jnp.int32), 0.25))
    got = TP.pcm_window(torch.from_numpy(x)[None],
                        torch.tensor([ext], dtype=torch.int32), 0.25)[0]
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=5e-7 * float(np.abs(x).max()))
    assert (got.numpy()[ext[0]:] == 0).all()  # zero past the extent


def test_cross_power_twin_matches_jax_formula():
    """The JAX lines ``cross = fa * conj(fb)``, ``mag = |cross|``,
    ``norm = where(mag > 1e-5 max, cross / max(mag, 1e-30), 0)`` in numpy
    complex64, per pair; some bins fall below the threshold."""
    rng = np.random.default_rng(6)
    shape = (2, 8, 4, 5)
    c = lambda: (rng.normal(size=shape) + 1j * rng.normal(size=shape)
                 ).astype(np.complex64)
    fa, fb = c(), c()
    fa[0, :4] *= 1e-7  # below the 1e-5 * max threshold of pair 0
    fb[1, 0, 0, 0] = 0  # a zero bin
    ref = np.empty_like(fa)
    for k in range(2):
        cross = fa[k] * np.conj(fb[k])
        mag = np.abs(cross)
        ref[k] = np.where(mag > np.float32(1e-5) * mag.max(),
                          cross / np.maximum(mag, np.float32(1e-30)), 0)
    got = TP.pcm_cross_power(torch.from_numpy(fa), torch.from_numpy(fb))
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    assert (got.numpy()[0, :4] == 0).all() and (got.numpy()[1, 4:] != 0).all()


@pytest.mark.parametrize("shape", [(2, 8, 4, 16), (1, 4, 8, 1),
                                   (1, 1, 2, 4), (3, 16, 1, 2)], ids=str)
def test_fft_passes_compose_numpy_rfftn(shape):
    """rfftn3 / irfftn3 (the K8 passes; on the CPU their torch.fft twins)
    in float64 against numpy's rfftn / irfftn; the inverse of a
    non-Hermitian spectrum drops the imaginary parts of the DC and Nyquist
    bins along z, as numpy does."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=shape)
    f = TP.rfftn3(torch.from_numpy(x))
    ref = np.fft.rfftn(x, axes=(1, 2, 3))
    assert tuple(f.shape) == ref.shape
    np.testing.assert_allclose(f.numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    h = rng.normal(size=ref.shape) + 1j * rng.normal(size=ref.shape)
    back = TP.irfftn3(torch.from_numpy(h.copy()), shape[3])
    np.testing.assert_allclose(
        back.numpy(), np.fft.irfftn(h, s=shape[1:], axes=(1, 2, 3)),
        rtol=0, atol=1e-12 * np.abs(h).max())


def test_fft_pow2_refuses_what_k8_does_not_take():
    with pytest.raises(ValueError, match="powers of two"):
        TP.fft_pow2(torch.zeros(2, 12, dtype=torch.complex64), 1, "c2c")
    with pytest.raises(ValueError, match="8192"):
        TP.fft_pow2(torch.zeros(1, 16384, dtype=torch.complex64), 1, "c2c")
    with pytest.raises(ValueError, match="last axis"):
        TP.fft_pow2(torch.zeros(4, 2), 0, "r2c")
    with pytest.raises(ValueError, match="8192"):
        TP.pcm_peaks_plain(*(torch.zeros(1, 16384, 1, 1),) * 2,
                           *(torch.ones(1, 3, dtype=torch.int32),) * 2)


def _jax_topk(pcm, n):
    masked = jnp.where(JP._local_maxima(jnp.asarray(pcm)), pcm, -jnp.inf)
    _, idx = jax.lax.top_k(masked.ravel(), n)
    return np.stack(np.unravel_index(np.asarray(idx), pcm.shape), -1)


@pytest.mark.parametrize("case", ["ties", "all_equal", "one_maximum",
                                  "thin"])
def test_topk_order_is_lax_top_k(case):
    """(value descending, flat index ascending), and the -inf entries of
    non-maxima by ascending index when fewer maxima than n exist."""
    rng = np.random.default_rng(8)
    if case == "ties":
        pcm = rng.integers(0, 4, (6, 5, 4)).astype(np.float32)
    elif case == "all_equal":
        pcm = np.ones((4, 4, 2), np.float32)
    elif case == "one_maximum":
        g = np.stack(np.meshgrid(*[np.arange(s) for s in (8, 6, 4)],
                                 indexing="ij"), -1)
        pcm = -((g - [3, 2, 1]) ** 2).sum(-1).astype(np.float32)
    else:
        pcm = rng.normal(size=(16, 1, 3)).astype(np.float32)
    n = 9
    got = TP.pcm_peaks_topk(torch.from_numpy(pcm)[None], n)[0].numpy()
    np.testing.assert_array_equal(got, _jax_topk(pcm, n))


def test_topk_refuses_more_than_256_peaks():
    with pytest.raises(ValueError, match="256"):
        TP.pcm_peaks_topk(torch.zeros(1, 16, 16, 16), 257)


def test_refine_peaks_bitwise_equals_jax():
    rng = np.random.default_rng(9)
    base = _smooth_noise((60, 50, 30), 4)
    d = (3, -2, 1)
    a = base[6:46, 6:40, 4:24]
    b = base[6 - d[0]:46 - d[0], 6 - d[1]:40 - d[1], 4 - d[2]:24 - d[2]]
    b = b + rng.normal(0, 0.5, b.shape).astype(np.float32)
    peaks = np.array([[61, 2, 31], [0, 0, 0], [5, 60, 3], [1, 1, 1]],
                     np.int32)
    for sub in (True, False):
        js, jr = JP.refine_peaks(a, b, peaks, (64, 64, 32), 32.0, sub)
        ts, tr = TP.refine_peaks(a, b, peaks, (64, 64, 32), 32.0, sub)
        assert np.array_equal(js, ts) and jr == tr
    assert JP._r_candidate(a, b, None, None, (3, -2, 1), 32.0) == \
        TP._r_candidate(a, b, None, None, (3, -2, 1), 32.0)


# the stitch_crops cases of tests/test_stitching.py:31-66, device cpu


def test_stitch_crops_integer_shift():
    base = _smooth_noise((80, 80, 40))
    d = np.array([5, -3, 2])
    a = base[10:58, 10:58, 8:32]
    b = base[10 - d[0]:58 - d[0], 10 - d[1]:58 - d[1], 8 - d[2]:32 - d[2]]
    P = (64, 64, 32)
    s, r = TP.stitch_crops(TP.pad_to(a, P), TP.pad_to(b, P), a.shape,
                           b.shape, device="cpu")
    assert np.allclose(s, d, atol=0.3)
    assert r > 0.95


def test_stitch_crops_subpixel_shift():
    from scipy.ndimage import shift as ndshift

    base = _smooth_noise((80, 80, 40))
    d = np.array([2.3, -1.7, 0.5])
    a = base[10:58, 10:58, 8:32]
    b = ndshift(base, d, order=3)[10:58, 10:58, 8:32]
    P = (64, 64, 32)
    s, r = TP.stitch_crops(TP.pad_to(a, P), TP.pad_to(b, P), a.shape,
                           b.shape, device="cpu")
    assert np.allclose(s, d, atol=0.35)


def test_stitch_crops_rejects_noise():
    a = _smooth_noise((48, 48, 24), seed=1)
    b = _smooth_noise((48, 48, 24), seed=2)
    P = (64, 64, 32)
    s, r = TP.stitch_crops(TP.pad_to(a, P), TP.pad_to(b, P), a.shape,
                           b.shape, device="cpu")
    assert r < 0.5


def test_stitch_crops_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = np.zeros((8, 8, 8), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.stitch_crops(z, z, z.shape, z.shape)
