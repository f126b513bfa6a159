"""The port's plain-torch fusion programs (K1-K5) against the JAX package.

Same inputs, drawn from ``np.random.default_rng(seed)``, go through the
JAX function (jitted on the CPU, as the JAX package's own tests run it)
and through the port's wrapper on CPU tensors, which takes the plain-torch
twin of each CUDA kernel. Tolerances: fused float32 rtol 1e-5 / atol 1e-3,
wsum atol 1e-5, converted integers |delta| <= 1 (float32 sums may round
differently between XLA and torch).
"""

import numpy as np
import pytest
import torch

from bigstitcher_spark_tpu.ops import fusion as JF
from bigstitcher_spark_tpu_torch.ops import fusion as TF

FTYPES = TF.FUSION_TYPES


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # torch's CPU pool is far slower than one thread on small tensors here
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close_f32(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-3)


def _close_int(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= 1


def _per_view(rng, V, lo, hi):
    return rng.uniform(lo, hi, (V, 3)).astype(np.float32)


@pytest.mark.parametrize("fusion_type", FTYPES)
def test_fuse_block_shift_matches_jax(fusion_type):
    rng = np.random.default_rng(1)
    V, bs = 4, (20, 18, 10)
    patches = rng.integers(0, 4000, (V, *(s + 1 for s in bs))).astype(np.uint16)
    fr = _per_view(rng, V, 0, 1)
    lp = (rng.uniform(-20, 40, (V, 3)) + fr).astype(np.float32)
    dims = np.tile(np.array([40, 30, 16], np.float32), (V, 1))
    borders, ranges = _per_view(rng, V, 0, 3), _per_view(rng, V, 4, 20)
    valid = np.array([1, 1, 1, 0], np.float32)
    ioffs = _per_view(rng, V, 0, 2)
    args = (patches, fr, lp, dims, borders, ranges, valid)
    ref = JF.fuse_block_shift(*args, block_shape=bs, fusion_type=fusion_type,
                              inside_offs=ioffs)
    got = TF.fuse_block_shift(*_t(*args), bs, fusion_type, *_t(ioffs))
    _close_f32(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("fusion_type", FTYPES)
def test_fuse_block_gather_matches_jax(fusion_type):
    rng = np.random.default_rng(2)
    V, bs, ps = 4, (16, 14, 8), (32, 32, 16)
    patches = rng.uniform(0, 4000, (V, *ps)).astype(np.float32)
    aff = np.zeros((V, 3, 4), np.float32)
    for v in range(V):
        a = np.deg2rad(rng.uniform(-12, 12))
        aff[v, :3, :3] = [[np.cos(a), -np.sin(a), 0],
                          [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        # translations reach past the patch on both sides: samples outside
        # the patch read its clamped edge
        aff[v, :, 3] = rng.uniform(-8, 24, 3)
    offsets = _per_view(rng, V, 0, 20)
    dims = np.tile(np.array([50, 40, 20], np.float32), (V, 1))
    borders, ranges = _per_view(rng, V, 0, 3), _per_view(rng, V, 4, 20)
    valid = np.ones(V, np.float32)
    ioffs = _per_view(rng, V, 0, 2)
    args = (patches, aff, offsets, dims, borders, ranges, valid)
    ref = JF.fuse_block(*args, block_shape=bs, fusion_type=fusion_type,
                        inside_offs=ioffs)
    got = TF.fuse_block(*_t(*args), bs, fusion_type, *_t(ioffs))
    _close_f32(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-5)


def _sep_case(rng, mirrored: bool):
    """4 views with diagonal block->patch affines (steps above and below
    1, e.g. a z scale of 1/3 under --preserveAnisotropy), uint16 patches;
    taps reach past the patch (clamped edge). ``mirrored`` flips y of
    view 0 and x of view 2 (tests/test_fusion.py's mirrored case)."""
    V, P = 4, (36, 32, 20)
    patches = rng.integers(0, 4000, (V, *P)).astype(np.uint16)
    diags = rng.uniform(0.6, 1.7, (V, 3)).astype(np.float32)
    diags[1, 2] = np.float32(1 / 3)
    ts = rng.uniform(-3, 6, (V, 3)).astype(np.float32)
    if mirrored:
        diags[0, 1] *= -1.0
        diags[2, 0] *= -1.0
        ts[0, 1] += P[1]
        ts[2, 0] += P[0]
    offsets = _per_view(rng, V, 0, 4)
    dims = np.tile(np.array(P, np.float32) * 1.4, (V, 1))
    borders, ranges = _per_view(rng, V, 0, 3), _per_view(rng, V, 4, 12)
    valid = np.array([1, 1, 1, 0], np.float32)
    ioffs = _per_view(rng, V, 0, 2)
    return (patches, diags, ts, offsets, dims, borders, ranges, valid), ioffs


@pytest.mark.parametrize("mirrored", [False, True], ids=["pos", "mirrored"])
@pytest.mark.parametrize("fusion_type", FTYPES)
def test_fuse_block_sep_matches_jax(fusion_type, mirrored):
    rng = np.random.default_rng(4)
    bs = (20, 18, 12)
    args, ioffs = _sep_case(rng, mirrored)
    ref = JF.fuse_block_sep(*args, block_shape=bs, fusion_type=fusion_type,
                            inside_offs=ioffs)
    got = TF.fuse_block_sep(*_t(*args), bs, fusion_type, *_t(ioffs))
    assert tuple(got[0].shape) == bs
    _close_f32(got[0], np.asarray(ref[0]).reshape(bs))
    np.testing.assert_allclose(got[1], np.asarray(ref[1]).reshape(bs),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("mirrored", [False, True], ids=["pos", "mirrored"])
def test_fuse_block_sep_matches_gather_twin(mirrored):
    """The separable twin reproduces the port's gather twin on diagonal
    affines (tests/test_fusion.py:269-342 holds the JAX pair so), inside
    the patch where both sample the same clamped taps."""
    rng = np.random.default_rng(6)
    bs = (16, 14, 10)
    (patches, diags, ts, offsets, dims, borders, ranges,
     valid), ioffs = _sep_case(rng, mirrored)
    aff = np.zeros((len(diags), 3, 4), np.float32)
    for d in range(3):
        aff[:, d, d] = diags[:, d]
    aff[:, :, 3] = ts
    for ft in ("AVG_BLEND", "MAX_INTENSITY", "FIRST_WINS"):
        s = TF.fuse_block_sep(*_t(patches, diags, ts, offsets, dims, borders,
                                  ranges, valid), bs, ft, *_t(ioffs))
        g = TF.fuse_block(*_t(patches, aff, offsets, dims, borders, ranges,
                              valid), bs, ft, *_t(ioffs))
        np.testing.assert_allclose(s[0], g[0], rtol=1e-5, atol=2e-3)
        np.testing.assert_allclose(s[1], g[1], rtol=0, atol=2e-4)


@pytest.mark.parametrize("out_dtype", ["uint8", "uint16", "float32"])
def test_convert_intensity_matches_jax(out_dtype):
    rng = np.random.default_rng(3)
    x = rng.uniform(-100, 70000, (24, 20, 12)).astype(np.float32)
    x[0, 0, :4] = [0.5, 1.5, 2.5, 65535.5]  # round half to even at the ends
    ref = JF.convert_intensity(x, np.float32(0.0), np.float32(65535.0),
                               out_dtype=out_dtype)
    got = TF.convert_intensity(torch.from_numpy(x), 0.0, 65535.0, out_dtype)
    if out_dtype == "float32":
        _close_f32(got, ref)
    else:
        _close_int(got.numpy(), ref)


def _composite_case(rng, masks, mask_offset=0.7):
    """Four tiles around a (56, 48, 20) volume: two translations with
    sub-pixel fractions, two diagonal (sep) views with steps below and
    above 1; windows as plan_composite_volume derives them."""
    out_shape = (56, 48, 20)
    ioc = int(np.ceil(mask_offset)) if masks else 0
    pad = (1 + ioc,) * 3
    V, S = 4, (36, 30, 14)
    tiles, windows, n_offs, kinds = [], [], [], []
    fr = np.zeros((V, 3), np.float32)
    dg = np.ones((V, 3), np.float32)
    of = np.zeros((V, 3), np.float32)
    corners = [(0, 0, 0), (20, 18, 6), (20, 0, 3), (0, 18, 3)]
    for v in range(V):
        tiles.append(rng.integers(0, 4000, S).astype(np.uint16))
        g = rng.uniform(-0.5, 0.5, 3) - np.array(corners[v])
        if v < 2:
            n = np.floor(g).astype(np.int64)
            fr[v] = g - n
            a = tuple(int(max(0, -n[d] - 1 - ioc)) for d in range(3))
            b = tuple(int(min(out_shape[d], S[d] - n[d] + ioc))
                      for d in range(3))
            kinds.append("shift")
            n_offs.append(tuple(int(x) for x in n))
        else:
            dg[v] = rng.uniform(0.75, 1.35, 3)
            of[v] = g
            a = tuple(int(max(0, np.floor((-1.0 - ioc - g[d]) / dg[v, d])))
                      for d in range(3))
            b = tuple(int(min(out_shape[d],
                              np.ceil((S[d] + ioc - g[d]) / dg[v, d]) + 1))
                      for d in range(3))
            kinds.append("sep")
            n_offs.append((0, 0, 0))
        windows.append((a, b))
    dims = np.tile(np.array(S, np.float32), (V, 1))
    borders, ranges = _per_view(rng, V, 0, 2), _per_view(rng, V, 4, 16)
    ioffs = np.full((V, 3), mask_offset if masks else 0.0, np.float32)
    static = dict(out_shape=out_shape, windows=tuple(windows),
                  n_offs=tuple(n_offs), pad=pad, kinds=tuple(kinds))
    return tiles, (fr, dims, borders, ranges, ioffs), (dg, of), static


@pytest.mark.parametrize("fusion_type,out_dtype,masks", [
    *[(ft, "uint16", False) for ft in FTYPES],
    ("AVG_BLEND", "uint8", False),
    ("AVG_BLEND", "float32", False),
    ("AVG_BLEND", "uint16", True),
])
def test_composite_matches_jax(fusion_type, out_dtype, masks):
    rng = np.random.default_rng(4)
    tiles, params, (dg, of), st = _composite_case(rng, masks)
    mn, mx = np.float32(0.0), np.float32(3000.0)
    fn = JF.make_translation_composite(
        st["out_shape"], st["windows"], st["n_offs"], pad=st["pad"],
        fusion_type=fusion_type, out_dtype=out_dtype, masks=masks,
        kinds=st["kinds"])
    ref = np.asarray(fn(tiles, *params, mn, mx, dg, of))
    got = TF.composite_fuse(_t(*tiles), *params, 0.0, 3000.0, dg, of,
                            fusion_type=fusion_type, out_dtype=out_dtype,
                            masks=masks, **st).numpy()
    if out_dtype == "float32":
        _close_f32(got, ref)
    else:
        _close_int(got, ref)
    if masks:
        assert set(np.unique(got)) <= {0, 65535}
    assert (got > 0).mean() > 0.5  # the windows cover most of the volume


@pytest.mark.parametrize("fusion_type",
                         ["AVG", "MAX_INTENSITY", "FIRST_WINS", "LAST_WINS"])
def test_composite_sep_positions_round_once_like_jax(fusion_type):
    """K1's "sep" sample positions ``diag * (a + i) + off`` round once, as
    XLA contracts the JAX expression into one fused multiply-add. Over
    steep data (voxels 0 or 65535) one ulp of position moves a sample by
    ~0.25, far past rtol 1e-5 / atol 1e-3 where the sample is small, so
    float32 output at that tolerance shows every position that rounds
    twice. AVG_BLEND is held by test_composite_matches_jax on gentler data:
    its acc / wsum amplifies last-bit cos differences where wsum is tiny."""
    for seed in range(3):
        rng = np.random.default_rng(40 + seed)
        tiles, params, (dg, of), st = _composite_case(rng, False)
        tiles = [rng.choice(np.array([0, 65535], np.uint16), t.shape)
                 for t in tiles]
        fn = JF.make_translation_composite(
            st["out_shape"], st["windows"], st["n_offs"], pad=st["pad"],
            fusion_type=fusion_type, out_dtype="float32", kinds=st["kinds"])
        ref = np.asarray(fn(tiles, *params, np.float32(0.0),
                            np.float32(1.0), dg, of))
        got = TF.composite_fuse(_t(*tiles), *params, 0.0, 1.0, dg, of,
                                fusion_type=fusion_type,
                                out_dtype="float32", **st).numpy()
        _close_f32(got, ref)


def test_bucketing_matches_jax():
    for s in [(1, 1, 1), (31, 32, 33), (100, 7, 64)]:
        assert TF.bucket_shape(s) == JF.bucket_shape(s)
        assert TF.bucket_shape(s, 16) == JF.bucket_shape(s, 16)
    for n in range(0, 20):
        assert TF.bucket_views(n) == JF.bucket_views(n)


def test_unknown_fusion_type_raises():
    with pytest.raises(ValueError):
        TF._combine_views(torch.zeros(1, 2), torch.zeros(1, 2),
                          torch.zeros(1, 2), torch.ones(1), "MEDIAN")
