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


# ---------------------------------------------------------------- coefficients
#
# Intensity-correction grids (V, Cx, Cy, Cz, 2) of [scale, offset] applied
# inside K1 and K3 (make_translation_composite with_coeffs, :580-591;
# fuse_block's _sample_one_view :98-103). Tolerance: fused float32 within
# rtol 1e-4 / atol 1e-3 of JAX (XLA contracts the grid coordinate and the
# scale * val + offset into fused multiply-adds and contracts the grid by
# dot products; the twins round every op), converted integers |delta| <= 1.


def _coeff_grids(rng, V, cdims=(3, 4, 2)):
    g = np.empty((V, *cdims, 2), np.float32)
    g[..., 0] = rng.uniform(0.6, 1.6, (V, *cdims))
    g[..., 1] = rng.uniform(-200, 200, (V, *cdims))
    return g


def _coeff_affs(rng, V, extent, cdims):
    """Diagonal level position -> grid affines whose grid coordinates run
    from below 0 to past C - 1 over ``extent``: both edge rules engage."""
    aff = np.zeros((V, 3, 4), np.float32)
    for v in range(V):
        for d in range(3):
            s = (cdims[d] + 1.5) / extent[d] * rng.uniform(0.9, 1.1)
            aff[v, d, d] = s
            aff[v, d, 3] = rng.uniform(-1.2, -0.6)
    return aff


def _shift_composite_case(rng):
    """Four translated tiles around a (56, 48, 20) volume (the composite
    route's coefficient case: every view a translation)."""
    out_shape, V, S = (56, 48, 20), 4, (36, 30, 14)
    corners = [(0, 0, 0), (20, 18, 6), (20, 0, 3), (0, 18, 3)]
    tiles, windows, n_offs = [], [], []
    fr = np.zeros((V, 3), np.float32)
    for v in range(V):
        tiles.append(rng.integers(0, 4000, S).astype(np.uint16))
        g = rng.uniform(-0.5, 0.5, 3) - np.array(corners[v])
        n = np.floor(g).astype(np.int64)
        fr[v] = g - n
        windows.append((tuple(int(max(0, -n[d] - 1)) for d in range(3)),
                        tuple(int(min(out_shape[d], S[d] - n[d]))
                              for d in range(3))))
        n_offs.append(tuple(int(x) for x in n))
    dims = np.tile(np.array(S, np.float32), (V, 1))
    borders, ranges = _per_view(rng, V, 0, 2), _per_view(rng, V, 4, 16)
    ioffs = np.zeros((V, 3), np.float32)
    static = dict(out_shape=out_shape, windows=tuple(windows),
                  n_offs=tuple(n_offs), pad=(1, 1, 1),
                  kinds=("shift",) * V)
    ones, zeros = np.ones((V, 3), np.float32), np.zeros((V, 3), np.float32)
    return tiles, (fr, dims, borders, ranges, ioffs), (ones, zeros), static


@pytest.mark.parametrize("fusion_type,out_dtype", [
    *[(ft, "float32") for ft in FTYPES], ("AVG_BLEND", "uint16")])
def test_composite_coeffs_matches_jax(fusion_type, out_dtype):
    rng = np.random.default_rng(14)
    tiles, params, (dg, of), st = _shift_composite_case(rng)
    V, cdims = len(tiles), (3, 4, 2)
    coeffs = _coeff_grids(rng, V, cdims)
    caffs = _coeff_affs(rng, V, (36, 30, 14), cdims)
    fn = JF.make_translation_composite(
        st["out_shape"], st["windows"], st["n_offs"], pad=st["pad"],
        fusion_type=fusion_type, out_dtype=out_dtype, with_coeffs=True,
        kinds=st["kinds"])
    mx = 1.0 if out_dtype == "float32" else 6000.0
    ref = np.asarray(fn(tiles, *params, np.float32(0.0), np.float32(mx),
                        dg, of, coeffs, caffs))
    got = TF.composite_fuse(_t(*tiles), *params, 0.0, mx, dg, of,
                            fusion_type=fusion_type, out_dtype=out_dtype,
                            coeffs=torch.from_numpy(coeffs), coeff_affs=caffs,
                            **st).numpy()
    plain = TF.composite_fuse(_t(*tiles), *params, 0.0, mx, dg, of,
                              fusion_type=fusion_type, out_dtype=out_dtype,
                              **st).numpy()
    if out_dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)
    else:
        _close_int(got, ref)
    # the correction is applied: the output moves off the uncorrected one
    assert np.abs(got.astype(np.float64) - plain).max() > 10


def test_composite_coeffs_refuse_sep_views():
    rng = np.random.default_rng(4)
    tiles, params, (dg, of), st = _composite_case(rng, False)
    V = len(tiles)
    with pytest.raises(ValueError, match="per-block"):
        TF.composite_fuse(_t(*tiles), *params, 0.0, 1.0, dg, of,
                          coeffs=torch.from_numpy(_coeff_grids(rng, V)),
                          coeff_affs=np.tile(np.eye(3, 4, dtype=np.float32),
                                             (V, 1, 1)), **st)


@pytest.mark.parametrize("fusion_type", FTYPES)
def test_fuse_block_gather_coeffs_matches_jax(fusion_type):
    rng = np.random.default_rng(12)
    V, bs, ps = 4, (16, 14, 8), (32, 32, 16)
    patches = rng.uniform(0, 4000, (V, *ps)).astype(np.float32)
    aff = np.zeros((V, 3, 4), np.float32)
    for v in range(V):
        a = np.deg2rad(rng.uniform(-12, 12))
        aff[v, :3, :3] = [[np.cos(a), -np.sin(a), 0],
                          [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        aff[v, :, 3] = rng.uniform(-8, 24, 3)
    offsets = _per_view(rng, V, 0, 20)
    dims = np.tile(np.array([50, 40, 20], np.float32), (V, 1))
    borders, ranges = _per_view(rng, V, 0, 3), _per_view(rng, V, 4, 20)
    valid = np.array([1, 1, 1, 0], np.float32)
    ioffs = _per_view(rng, V, 0, 2)
    cdims = (4, 3, 2)
    coeffs = _coeff_grids(rng, V, cdims)
    caffs = _coeff_affs(rng, V, (50, 40, 20), cdims)
    args = (patches, aff, offsets, dims, borders, ranges, valid)
    ref = JF.fuse_block(*args, block_shape=bs, fusion_type=fusion_type,
                        inside_offs=ioffs, coeffs=coeffs,
                        coeff_affines=caffs)
    got = TF.fuse_block(*_t(*args), bs, fusion_type, *_t(ioffs),
                        coeffs=torch.from_numpy(coeffs),
                        coeff_affines=torch.from_numpy(caffs))
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-5)


def test_grid_edge_rules_differ_and_each_matches_jax():
    """Past the grid's edges the composite clamps the coordinate to [0, C-1]
    with lo <= C-2 (taps C-2, C-1 at weight 1), the gather floors it and
    clips both corner indices (taps C-1, C-1 at the fraction). Each side
    equals its own JAX function there, within 1e-6."""
    from bigstitcher_spark_tpu.ops import nonrigid as JN

    C = 4
    pos = np.array([-1.7, -0.5, 0.0, 1.25, 2.999, 3.0, 3.4, 5.8], np.float32)
    lo, hi, f = TF._interp_taps(torch.from_numpy(pos), C)
    m = np.asarray(JF._separable_interp_matrix(pos, C))
    mine = np.zeros_like(m)
    np.add.at(mine, (np.arange(len(pos)), lo.numpy()), 1.0 - f.numpy())
    np.add.at(mine, (np.arange(len(pos)), hi.numpy()), f.numpy())
    np.testing.assert_allclose(mine, m, rtol=0, atol=1e-6)
    assert lo.numpy()[-1] == C - 2 and f.numpy()[-1] == 1.0
    rng = np.random.default_rng(3)
    grid = rng.uniform(0, 2, (C, 2, 3, 2)).astype(np.float32)
    pts = np.stack([pos, np.zeros_like(pos), np.full_like(pos, 1.5)], 1)
    ref = np.asarray(JN._trilinear_vec(grid, pts))
    got = TF._trilinear_vec(torch.from_numpy(grid), torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    # past the last cell the gather's fraction is nonzero on equal taps
    assert float(torch.floor(torch.tensor(pos[-1])) - (C - 1)) > 0


# --------------------------------------------------------------- K27 (scan)


def _scan_case(rng, V=3, tshape=(40, 38, 20), bs=(16, 16, 8),
               out_shape=(32, 32, 16), K=3, inside_off=True):
    """Resident uint16 tiles and a grid of blocks, K view slots each; the
    floor offsets reach below 0 and past tshape - ps on every axis, so the
    windows clamp and wrap; one slot in four is invalid."""
    tiles = rng.integers(0, 4000, (V, *tshape)).astype(np.uint16)
    grid = [(x, y, z) for x in range(0, out_shape[0], bs[0])
            for y in range(0, out_shape[1], bs[1])
            for z in range(0, out_shape[2], bs[2])]
    B = len(grid)
    view_idx = rng.integers(0, V, (B, K)).astype(np.int32)
    lim = np.array(tshape) - np.array(bs) - 1
    floor_offs = rng.integers(-6, lim + 7, (B, K, 3)).astype(np.int32)
    fracs = rng.uniform(0, 1, (B, K, 3)).astype(np.float32)
    lpos0 = (floor_offs + fracs).astype(np.float32)
    dims = np.broadcast_to(np.array(tshape, np.float32), (B, K, 3)).copy()
    borders = rng.uniform(0, 3, (B, K, 3)).astype(np.float32)
    ranges = rng.uniform(4, 12, (B, K, 3)).astype(np.float32)
    valid = (rng.uniform(size=(B, K)) > 0.25).astype(np.float32)
    ioffs = (rng.uniform(0, 1.5, (B, K, 3)) if inside_off
             else np.zeros((B, K, 3))).astype(np.float32)
    assert (floor_offs < 0).any(axis=(0, 1)).all()
    assert (floor_offs > lim).any(axis=(0, 1)).all()
    return (tiles, view_idx, floor_offs, fracs, lpos0, dims, borders, ranges,
            valid, np.array(grid, np.int32)), ioffs


@pytest.mark.parametrize("fusion_type,out_dtype,masks", [
    *[(ft, "uint16", False) for ft in FTYPES],
    ("AVG_BLEND", "uint8", False), ("AVG_BLEND", "float32", False),
    ("AVG_BLEND", "uint16", True), ("MAX_INTENSITY", "float32", True)])
def test_fuse_volume_scan_matches_jax(fusion_type, out_dtype, masks):
    """K27's twin against the JAX scan on 3 uint16 tiles of 40x38x20 and 8
    blocks of 16x16x8, windows clamped and wrapped: integers within 1,
    float32 within rtol 1e-5 / atol 1e-3 (K2's tolerances)."""
    args, ioffs = _scan_case(np.random.default_rng(11))
    kw = dict(out_shape=(32, 32, 16), block_shape=(16, 16, 8),
              fusion_type=fusion_type, out_dtype=out_dtype, masks=masks)
    ref = JF.fuse_volume_scan(*args, np.float32(100.0), np.float32(3500.0),
                              inside_offs=ioffs, **kw)
    got = TF.fuse_volume_scan(*_t(*args), 100.0, 3500.0, inside_offs=_t(
        ioffs)[0], **kw)
    plain = TF.fuse_volume_scan_plain(*args, 100.0, 3500.0,
                                      inside_offs=ioffs, device="cpu", **kw)
    assert torch.equal(got, plain)
    if out_dtype == "float32" and not masks:
        _close_f32(got, ref)
    else:
        _close_int(got.to(torch.int64) if out_dtype == "uint16" else got,
                   np.asarray(ref).astype(np.int64) if out_dtype == "uint16"
                   else ref)
    assert float(got.to(torch.float32).std()) > 0


def test_fuse_volume_scan_wrap_is_masked_like_zero_padding():
    """Where a window clamps, the scan reads wrapped tile voxels where the
    per-block route stages zeros (models/affine_fusion.py _shift_inputs).
    With tiles that are the images (img_dims = tile shape) and no
    --maskOffset the inside test weighs every wrapped tap 0, and each
    block equals K2's twin on zero-padded patches bit for bit; with an
    inside offset (AVG: no blend ramp to zero the border) they differ
    there."""
    rng = np.random.default_rng(12)
    (tiles, vidx, fo, fr, lp, dims, bo, rg, va, offs), _ = _scan_case(
        rng, inside_off=False)
    bs = (16, 16, 8)
    lim = np.array(tiles.shape[1:]) - np.array(bs) - 1
    clamped = ((fo < 0) | (fo > lim)).any(-1) & (va > 0)
    assert clamped.sum() > 8
    for ioff, same in ((0.0, True), (1.5, False)):
        io = np.full(fo.shape, ioff, np.float32)
        vol = TF.fuse_volume_scan_plain(
            tiles, vidx, fo, fr, lp, dims, bo, rg, va, offs, 0.0, 1.0,
            (32, 32, 16), bs, "AVG", out_dtype="float32", inside_offs=io,
            device="cpu")
        differ = 0
        for b, (x, y, z) in enumerate(offs):
            patches = np.zeros((vidx.shape[1], *(s + 1 for s in bs)),
                               np.uint16)
            for k, v in enumerate(vidx[b]):
                src = [slice(max(o, 0), min(o + s + 1, t)) for o, s, t in
                       zip(fo[b, k], bs, tiles.shape[1:])]
                dst = tuple(slice(s.start - o, s.stop - o)
                            for s, o in zip(src, fo[b, k]))
                patches[k][dst] = tiles[v][tuple(src)]
            fused, _ = TF.fuse_block_shift_plain(
                *_t(patches, fr[b], lp[b], dims[b], bo[b], rg[b], va[b]), bs,
                "AVG", torch.from_numpy(io[b]))
            eq = torch.equal(vol[x:x + 16, y:y + 16, z:z + 8], fused)
            assert eq or not same
            differ += not eq
        assert same or differ > 0


def test_fuse_volume_scan_refuses_overlapping_blocks_the_twin_follows_jax():
    """K27 fuses all blocks at once, so its wrapper refuses blocks that
    overlap once clipped into the volume (here the last, moved past the
    volume's edge onto the one before); the twin keeps the JAX scan's
    order: the later block wins."""
    args, ioffs = _scan_case(np.random.default_rng(13))
    offs = args[-1].copy()
    offs[-1] = (30, 40, 20)  # clipped to (16, 16, 8), where block -2 lies
    offs[-2] = (16, 16, 8)
    offs[-3] = (16, 16, 0)
    args = (*args[:-1], offs)
    kw = dict(out_shape=(32, 32, 16), block_shape=(16, 16, 8),
              out_dtype="float32", inside_offs=ioffs)
    with pytest.raises(ValueError, match="must not overlap"):
        TF.fuse_volume_scan(*args, 0.0, 1.0, device="cpu", **kw)
    ref = JF.fuse_volume_scan(*args, np.float32(0.0), np.float32(1.0), **kw)
    got = TF.fuse_volume_scan_plain(*args, 0.0, 1.0, device="cpu", **kw)
    _close_f32(got, ref)
