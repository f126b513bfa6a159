"""The sharded global solves of the port (``BST_SOLVE_SHARD``): the relax
and the intensity CG over a solve mesh, held against the port's one-device
solves and the JAX package's ``shard_map`` programs (ops/solve.py:428,
:600), on the CPU.

The port's mesh here is ``[cpu] * 4`` (the twins of K11-K14, K24's partial
form and the shard sum K29 run on each shard); the JAX package's is its 8
virtual CPU devices (tests/conftest.py). Contracts:

* the sharded relax is bitwise the port's one-device relax (rows grouped by
  owner tile, each shard with the one-device warps a segment, the shard sum
  adding exact zeros), and within ``tests/test_torch_solver.py``'s
  tolerances of JAX's sharded relax (iterations equal, history rtol / atol
  1e-9, models and link errors rtol 1e-7 / atol 1e-9);
* the sharded CG is within rtol / atol 1e-8 of the one-device CG (JAX's
  ``test_sharded_matches_single``), and within 1e-6 of JAX's sharded device
  solve and of its dense solve.

K29 and K24's partial form on the card: ``-k "shard_sum or cg_partial or
sharded"`` in ``tests/test_torch_kernels.py`` (``-m cuda``).
"""

import numpy as np
import pytest
import torch

from bigstitcher_spark_tpu import config as JC
from bigstitcher_spark_tpu.models import solver as JS
from bigstitcher_spark_tpu.ops import intensity as JI
from bigstitcher_spark_tpu.parallel import pairsched as JP
from bigstitcher_spark_tpu_torch import ops
from bigstitcher_spark_tpu_torch.models import intensity as TI
from bigstitcher_spark_tpu_torch.models import solver as TS
from bigstitcher_spark_tpu_torch.ops import intensity as OI
from bigstitcher_spark_tpu_torch.ops import shard as K
from bigstitcher_spark_tpu_torch.ops import solve as R
from bigstitcher_spark_tpu_torch.parallel import pairsched as TP
from test_torch_solver import (COMBOS, _assert_same_result, _bad_graph,
                               _graph, _params, jax_solver, x64_shim)

CPU4 = ["cpu"] * 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def shard_all(monkeypatch):
    """Every solve shards (the JAX tests' ``BST_SOLVE_SHARD`` 1)."""
    monkeypatch.setenv("BST_SOLVE_SHARD", "1")


def _sharded_params(**kw):
    return _params(TS, devices=CPU4, **kw)


# ---------------------------------------------------------------- layout


@pytest.mark.parametrize("thr,want", [("1000000000", 1), ("0", 1),
                                      ("1", 4)])
def test_shard_threshold_respected(monkeypatch, thr, want):
    """JAX's test_shard_threshold_respected on a [cpu] * 4 mesh."""
    _, _, tiles, links = _graph(n=(3, 2))
    monkeypatch.setenv("BST_SOLVE_SHARD", thr)
    st = TS._DeviceRelax(links, tiles, {tiles[0]}, _sharded_params())
    assert st.n_shards == want
    assert isinstance(st.problem, R.ShardedRelaxProblem) == (want > 1)
    if want > 1:
        assert st.problem.n_shards == 4
        assert st.problem.mesh == [torch.device("cpu")] * 4


@pytest.mark.parametrize("thr,n_rows,n_dev,want", [
    ("100", 99, 4, 1), ("100", 100, 4, 4), ("1", 10, 1, 1)])
def test_solve_layout(monkeypatch, thr, n_rows, n_dev, want):
    """JAX's rule: the links axis spans the whole mesh from BST_SOLVE_SHARD
    rows on, and a mesh of one device (the default CPU mesh) never
    shards."""
    monkeypatch.setenv("BST_SOLVE_SHARD", thr)
    mesh = R.solve_mesh("cpu", ["cpu"] * n_dev)
    assert R.solve_layout(n_rows, mesh) == want
    assert R.solve_mesh("cpu") == [torch.device("cpu")]


def test_every_shard_takes_the_one_device_warps():
    """Dense links (4,000 matches a link): the one-device layout gives a
    tile 8 warps, a shard's own rows would give it fewer; every shard
    takes the one-device warps, and the relaxation stays bitwise."""
    rng = np.random.default_rng(7)
    links = []
    for ia, ib, shift in ((0, 1, (80, 0, 0)), (2, 3, (80, 0, 0)),
                          (0, 2, (0, 80, 0)), (1, 3, (0, 80, 0))):
        p = rng.uniform(0, 100, (4000, 3))
        q = p - np.asarray(shift, float) + rng.normal(0, 0.1, p.shape)
        links.append((ia, ib, p, q, np.full(4000, 0.9)))
    one = R.prepare_relax(links, 4, "cpu")
    sh = R.prepare_relax(links, 4, "cpu", 4, mesh=[torch.device("cpu")] * 4)
    assert (one.wpt_tile, one.wpt_link) == (8, 8)
    own = [R._warps_per_segment(p.n_rows, 4) for p in sh.shards]
    assert min(own) < one.wpt_tile
    for p in sh.shards:
        assert (p.wpt_tile, p.wpt_link) == (one.wpt_tile, one.wpt_link)
    assert sum(p.n_rows for p in sh.shards) == sh.n_rows == one.n_rows
    args = (np.ones(4), np.array([True, False, False, False]),
            np.zeros((4, 3)), 0.1, 1.0, 5.0, 40, R.M.AFFINE, R.M.RIGID, 10)
    a = R.relax_on_device(one, *args)
    b = R.relax_on_device(sh, *args)
    assert a.iterations == b.iterations > 1
    for x, y in ((a.history, b.history), (a.models, b.models),
                 (a.link_errors, b.link_errors)):
        np.testing.assert_array_equal(x, y)


def test_rows_keep_their_single_device_order():
    """Each shard holds exactly its tiles' rows, in the one-device order."""
    _, _, tiles, links = _graph(n=(4, 3))
    rows = [(tiles.index(lk.key_a), tiles.index(lk.key_b), lk.p, lk.q,
             lk.w) for lk in links]
    one = R.prepare_relax(rows, len(tiles), "cpu")
    tile_shard = np.array([3, 1, 0, 2, 2, 1, 0, 3, 1, 1, 0, 2])
    sh = R.prepare_relax(rows, len(tiles), "cpu", 4, tile_shard)
    for d, p in enumerate(sh.shards):
        sel = np.isin(one.own.numpy(), np.flatnonzero(tile_shard == d))
        for name in ("local", "target", "own", "other", "w", "link_id"):
            np.testing.assert_array_equal(getattr(p, name).numpy(),
                                          getattr(one, name).numpy()[sel])
        assert p.tile_len.tolist() == [
            n if tile_shard[t] == d else 0
            for t, n in enumerate(one.tile_len.tolist())]


@pytest.mark.parametrize("seed,n_bins", [(0, 4), (1, 3), (2, 8)])
def test_assign_tasks_gives_jax_bins(seed, n_bins):
    rng = np.random.default_rng(seed)
    costs = rng.integers(0, 50, 40).astype(float)
    costs[::7] = costs[1]  # ties
    mine = TP.assign_tasks([TP.PairTask(index=i, cost=float(c))
                            for i, c in enumerate(costs)], n_bins)
    ref = JP.assign_tasks([JP.PairTask(index=i, cost=float(c))
                           for i, c in enumerate(costs)], n_bins)
    assert [[t.index for t in b] for b in mine] == \
        [[t.index for t in b] for b in ref]


# ---------------------------------------------------------------- relax


@pytest.mark.parametrize("model,reg", COMBOS)
def test_sharded_relax_bitwise_one_device(shard_all, model, reg):
    _, _, tiles, links = _graph(n=(6, 4))
    kw = dict(model=model, regularization=reg)
    single = TS.relax(links, tiles, {tiles[0]}, _params(TS, **kw))
    sharded = TS.relax(links, tiles, {tiles[0]}, _sharded_params(**kw))
    assert single.shards == 1 and sharded.shards == 4
    _assert_same_result(single, sharded, exact=True)
    for k, v in single.link_errors.items():
        assert sharded.link_errors[k] == v


@pytest.mark.parametrize("model,reg", COMBOS)
def test_sharded_relax_matches_jax_sharded(jax_solver, shard_all, model,
                                           reg):
    tiles, jl, ttiles, tl = _graph(n=(6, 4))
    port = TS.relax(tl, ttiles, {ttiles[0]},
                    _sharded_params(model=model, regularization=reg))
    assert port.shards == 4
    with JC.overrides({"BST_SOLVE_SHARD": 1}):
        params = _params(JS, model=model, regularization=reg,
                         backend="device")
        assert jax_solver._DeviceRelax(jl, tiles, {tiles[0]},
                                       params).problem.n_shards > 1
        ref = jax_solver.relax(jl, tiles, {tiles[0]}, params)
    _assert_same_result(ref, port)


def test_more_shards_than_tiles(shard_all):
    """2 tiles on 4 shards: two shards hold no row, and add zeros."""
    _, _, tiles, links = _graph(n=(2, 1))
    st = TS._DeviceRelax(links, tiles, {tiles[0]}, _sharded_params(
        model=R.M.RIGID))
    assert sorted(p.n_rows for p in st.problem.shards) == [0, 0, 8, 8]
    single = TS.relax(links, tiles, {tiles[0]}, _params(TS, model=R.M.RIGID))
    _assert_same_result(single, st.solve(), exact=True)


def test_sharded_iterative_drops_identical_links(shard_all):
    _, _, tiles, links = _bad_graph()
    kw = dict(method="ONE_ROUND_ITERATIVE")
    single = TS.solve_iterative(links, tiles, {tiles[0]}, _params(TS, **kw),
                                verbose=False)
    sharded = TS.solve_iterative(links, tiles, {tiles[0]},
                                 _sharded_params(**kw), verbose=False)
    assert len(single.removed_links) >= 1
    assert sharded.shards == 4
    _assert_same_result(single, sharded, exact=True)


def test_sharded_masked_resolve_equals_rebuilt(shard_all):
    _, _, tiles, links = _bad_graph()
    fixed = {tiles[0]}
    params = _sharded_params(model=R.M.TRANSLATION)
    state = TS._DeviceRelax(links, tiles, fixed, params)
    assert state.n_shards == 4
    mask = np.ones(len(links))
    mask[-1] = 0.0
    masked = state.solve(mask)
    rebuilt = TS.relax(links[:-1], tiles, fixed, params)
    _assert_same_result(masked, rebuilt, exact=True)


def test_sharded_relax_counts_no_launch_on_the_cpu(shard_all):
    _, _, tiles, links = _graph()
    ops.reset_launch_counts()
    TS.relax(links, tiles, {tiles[0]}, _sharded_params())
    assert not any(ops.launch_counts().values())


# ---------------------------------------------------------------- K29


def _parts(seed, S, n):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0, 10.0 ** rng.integers(-3, 4), n))
            for _ in range(S)]


@pytest.mark.parametrize("S", [1, 2, 4, 7])
@pytest.mark.parametrize("with_rep", [False, True])
def test_shard_sum_plain_adds_left_to_right(S, with_rep):
    n = 1000
    parts = _parts(S, S, n)
    rep = _parts(99, 1, n)[0] if with_rep else None
    want = parts[0].clone()
    for p in parts[1:]:
        want = want + p
    if with_rep:
        want = want + rep
    v = _parts(5, 1, n)[0]
    dot = torch.zeros(1, dtype=torch.float64)
    for fn in (K.shard_sum_plain, K.shard_sum):
        out = torch.empty(n, dtype=torch.float64)
        fn(parts, out, rep=rep, v=v, dot=dot)
        assert torch.equal(out, want)
        ref = float(torch.dot(want, v))
        assert abs(float(dot[0]) - ref) <= 1e-12 * abs(ref)


def test_shard_sum_plain_returns_once_done():
    parts = _parts(1, 3, 16)
    out = torch.full((16,), 7.0, dtype=torch.float64)
    done = torch.ones(1, dtype=torch.int32)
    K.shard_sum_plain(parts, out, done=done)
    assert torch.equal(out, torch.full((16,), 7.0, dtype=torch.float64))
    done.zero_()
    K.shard_sum_plain(parts, out, done=done)
    assert torch.equal(out, (parts[0] + parts[1]) + parts[2])


def test_shard_sum_takes_2d_buffers():
    """The relax loop adds (T, 36) moments and (2, T) error sums."""
    parts = [p.reshape(4, 9) for p in _parts(3, 4, 36)]
    out = torch.empty((4, 9), dtype=torch.float64)
    K.shard_sum(parts, out)
    assert torch.equal(out, ((parts[0] + parts[1]) + parts[2]) + parts[3])


@pytest.mark.parametrize("case", ["no shard", "65 shards", "int32 part",
                                  "short part", "strided part", "short rep",
                                  "v without dot", "float dot", "two dots",
                                  "float done", "int64 ticket", "empty out"])
def test_shard_sum_refuses_bad_arguments(case):
    n = 8
    f64 = dict(dtype=torch.float64)
    parts = [torch.zeros(n, **f64) for _ in range(3)]
    out = torch.zeros(n, **f64)
    kw = {}
    if case == "no shard":
        parts = []
    elif case == "65 shards":
        parts = [torch.zeros(n, **f64)] * 65
    elif case == "int32 part":
        parts[1] = torch.zeros(n, dtype=torch.int32)
    elif case == "short part":
        parts[2] = torch.zeros(n - 1, **f64)
    elif case == "strided part":
        parts[0] = torch.zeros(2 * n, **f64)[::2]
    elif case == "short rep":
        kw["rep"] = torch.zeros(n - 1, **f64)
    elif case == "v without dot":
        kw["v"] = torch.zeros(n, **f64)
    elif case == "float dot":
        kw.update(v=torch.zeros(n, **f64), dot=torch.zeros(1))
    elif case == "two dots":
        kw.update(v=torch.zeros(n, **f64), dot=torch.zeros(2, **f64))
    elif case == "float done":
        kw["done"] = torch.zeros(1, **f64)
    elif case == "int64 ticket":
        kw.update(v=torch.zeros(n, **f64), dot=torch.zeros(1, **f64),
                  ticket=torch.zeros(1, dtype=torch.int64))
    elif case == "empty out":
        parts = [torch.zeros(0, **f64)]
        out = torch.zeros(0, **f64)
    for fn in (K.shard_sum, K.shard_sum_plain):
        with pytest.raises(ValueError):
            fn(parts, out, **kw)


def test_shard_sum_blocks():
    assert [K.shard_sum_blocks(n) for n in (1, 256, 257, 18_432, 524_288,
                                            10 ** 9)] == [1, 1, 2, 72, 1024,
                                                          1024]


# ---------------------------------------------------------------- CG


def _system(seed=0, n_views=3, dims=(4, 4, 4), n_matches=300):
    """tests/test_solve_device.py::TestIntensityDevice._system."""
    rng = np.random.default_rng(seed)
    C = int(np.prod(dims)) * n_views
    matches = []
    for _ in range(n_matches):
        ca, cb = rng.integers(0, C, 2)
        if ca == cb:
            continue
        x = rng.uniform(100, 1000, 50)
        a, b = rng.uniform(0.8, 1.2), rng.uniform(-20, 20)
        y = a * x + b + rng.normal(0, 5, 50)
        matches.append((int(ca), int(cb), *OI.match_stats(x / 500, y / 500)))
    return C, matches, TI.smoothness_pairs(dims, n_views)


def test_sharded_cg_matches_single_and_jax(monkeypatch):
    C, matches, smooth = _system(seed=1)
    kw = dict(smooth_pairs=smooth, backend="device", device="cpu")
    single = OI.solve_intensity_coefficients(C, matches, 0.1, **kw)
    monkeypatch.setenv("BST_SOLVE_SHARD", "1")
    spy, real = [], R.solve_intensity_device

    def record(*a, **k):
        out = real(*a, **k)
        spy.append(k)
        return out

    monkeypatch.setattr(R, "solve_intensity_device", record)
    sharded = OI.solve_intensity_coefficients(C, matches, 0.1, devices=CPU4,
                                              **kw)
    assert spy[-1]["n_shards"] == 4
    np.testing.assert_allclose(sharded, single, rtol=1e-8, atol=1e-8)
    with x64_shim(), JC.overrides({"BST_SOLVE_SHARD": 1}):
        jax_sharded = JI.solve_intensity_coefficients(
            C, matches, 0.1, smooth_pairs=smooth, backend="device")
        dense = JI.solve_intensity_coefficients(
            C, matches, 0.1, smooth_pairs=smooth, backend="numpy")
    np.testing.assert_allclose(sharded, jax_sharded, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sharded, dense, rtol=1e-6, atol=1e-6)


def _dense(n, sysm):
    a = np.zeros((n, n))
    ptr, cols = sysm.row_ptr.numpy(), sysm.cols.numpy()
    for i in range(n):
        a[i, cols[ptr[i]:ptr[i + 1]]] += sysm.vals.numpy()[ptr[i]:ptr[i + 1]]
    return a


def _data_dense(n, rows):
    """The data term of match rows, term by term from its definition."""
    a = np.zeros((n, n))
    for ca, cb, m, sx, sy, sxx, syy, sxy in rows:
        u = [2 * int(ca), 2 * int(ca) + 1, 2 * int(cb), 2 * int(cb) + 1]
        block = [[sxx, sx, -sxy, -sx], [sx, m, -sy, -m],
                 [-sxy, -sy, syy, sy], [-sx, -m, sy, m]]
        for i in range(4):
            for j in range(4):
                a[u[i], u[j]] += block[i][j]
    return a


def test_strided_split_puts_jax_rows_on_each_shard():
    """Shard d holds the data term of JAX's ``rows[d::S]``; the replicated
    part the smoothness pairs and the diagonal; together the one-device
    system."""
    C, matches, smooth = _system(seed=3, n_views=2, dims=(2, 2, 2),
                                 n_matches=60)
    rows, diag, rhs, sidx, sw = OI.intensity_system(C, matches, 0.1, smooth)
    n = 2 * C
    one = R.assemble_cg(C, rows, diag, rhs, sidx, sw, "cpu")
    sh = R.assemble_cg(C, rows, diag, rhs, sidx, sw, "cpu", n_shards=3)
    assert sh.n_shards == 3 and len(sh.reps) == 1
    assert sh.max_iter == one.max_iter and sh.tol2 == one.tol2
    total = _dense(n, sh.reps[0])
    rep = np.diag(diag)
    for (i, j), w in zip(sidx, sw):
        rep[i, i] += w
        rep[j, j] += w
        rep[i, j] -= w
        rep[j, i] -= w
    np.testing.assert_allclose(total, rep, rtol=1e-15, atol=0)
    for d, part in enumerate(sh.shards):
        got = _dense(n, part)
        np.testing.assert_allclose(got, _data_dense(n, rows[d::3]),
                                   rtol=1e-14, atol=1e-14)
        total += got
    np.testing.assert_allclose(total, _dense(n, one), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(sh.reps[0].x0.numpy(), one.x0.numpy())


def test_sharded_cg_twin_loop():
    """The sharded loop through the twins: within 1e-8 of the one-device
    loop; a shard with no row adds zeros; no launch counted on the CPU."""
    ops.reset_launch_counts()
    for n_matches, S in ((300, 2), (5, 8)):
        C, matches, smooth = _system(seed=2, n_matches=n_matches)
        rows, diag, rhs, sidx, sw = OI.intensity_system(C, matches, 0.1,
                                                        smooth)
        assert len(rows) < S or S == 2
        one = R.cg_plain(R.assemble_cg(C, rows, diag, rhs, sidx, sw, "cpu"))
        sysm = R.assemble_cg(C, rows, diag, rhs, sidx, sw, "cpu", n_shards=S)
        for loop in (R.cg_plain, R.cg_on_device):
            out = loop(sysm)
            assert abs(out.iterations - one.iterations) <= 1
            np.testing.assert_allclose(out.x.numpy(), one.x.numpy(),
                                       rtol=1e-8, atol=1e-8)
    assert not any(ops.launch_counts().values())


def test_cg_partial_twin_equals_full_twin():
    C, matches, smooth = _system(seed=4)
    rows, diag, rhs, sidx, sw = OI.intensity_system(C, matches, 0.1, smooth)
    sysm = R.assemble_cg(C, rows, diag, rhs, sidx, sw, "cpu")
    g = torch.Generator().manual_seed(3)
    r, p_old = (torch.randn(sysm.n, generator=g, dtype=torch.float64)
                for _ in range(2))
    d, i = R.cg_state(sysm, "cpu")
    d[1] = 0.7
    full = [torch.empty(sysm.n, dtype=torch.float64) for _ in range(2)]
    R.cg_spmv_plain(sysm, r, p_old, *full, d, i)
    part = [torch.full((sysm.n,), -1.0, dtype=torch.float64)
            for _ in range(2)]
    R.cg_spmv_partial(sysm, r, p_old, *part, d, i)
    assert torch.equal(part[0], full[0]) and torch.equal(part[1], full[1])
    ap = torch.empty(sysm.n, dtype=torch.float64)
    R.cg_spmv_partial_plain(sysm, r, p_old, None, ap, d, i)
    assert torch.equal(ap, full[1])
    i[1] = 1  # done: nothing written
    ap.fill_(5.0)
    R.cg_spmv_partial_plain(sysm, r, p_old, None, ap, d, i)
    assert bool((ap == 5.0).all())


def test_solve_intensities_sharded(monkeypatch, shard_all):
    """``solve_intensities(devices=...)``: the per-view grids of the
    sharded solve within 1e-8 of the one-device solve's."""
    from bigstitcher_spark_tpu_torch.io.spimdata import ViewId

    dims = (2, 2, 2)
    views = [ViewId(0, s) for s in range(3)]
    rng = np.random.default_rng(6)
    matches = []
    for a in range(3):
        for b in range(a + 1, 3):
            for c in range(8):
                x = rng.uniform(100, 1000, 40)
                y = (1.0 + 0.1 * a) * x + 5 * b + rng.normal(0, 3, 40)
                matches.append(TI.CellMatch(views[a], views[b], c, c,
                                            OI.match_stats(x, y), (1.0, 0.0)))
    one = TI.solve_intensities(matches, views, dims, progress=False,
                               device="cpu")
    shd = TI.solve_intensities(matches, views, dims, progress=False,
                               device="cpu", devices=CPU4)
    for v in views:
        np.testing.assert_allclose(shd[v], one[v], rtol=1e-8, atol=1e-8)
