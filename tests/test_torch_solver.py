"""The port's solver (``bigstitcher_spark_tpu_torch``) against the JAX
package's, on the same inputs made from a seed with numpy.

The port's device backend runs here through the plain twins of the relax
kernels K11-K14 (``--device cpu``). It is held against both JAX backends
(``numpy``, the host reference, and ``device``, the jitted
``lax.while_loop``) under the JAX package's own device-vs-numpy contract
(tests/test_solve_device.py): iterations equal, error history rtol 1e-9 /
atol 1e-9, models and link errors rtol 1e-7 / atol 1e-9. The numpy backends
of the two packages are the same code: they agree exactly.

The JAX solver module imports ``jax.experimental.enable_x64``, which jax
0.9 removed. The ``jax_solver`` fixture puts ``jax.enable_x64`` in its place
for the test that asks for it, and takes it out again afterwards together
with the imported ``bigstitcher_spark_tpu.ops.solve``: the JAX package's own
solver tests then fail exactly as they do without this file, whatever order
the files run in.
"""

import contextlib
import importlib
import os
import shutil
import sys

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import bigstitcher_spark_tpu.ops as jax_ops
from bigstitcher_spark_tpu.io import spimdata as JSD
from bigstitcher_spark_tpu.models import solver as JS
from bigstitcher_spark_tpu.ops import models as JM
from bigstitcher_spark_tpu_torch.cli.main import main as torch_main
from bigstitcher_spark_tpu_torch.io import spimdata as TSD
from bigstitcher_spark_tpu_torch.io.interestpoints import InterestPointStore
from bigstitcher_spark_tpu_torch.models import solver as TS
from bigstitcher_spark_tpu_torch.ops import models as TM
from bigstitcher_spark_tpu_torch.ops import solve as TO
from bigstitcher_spark_tpu_torch.utils import solverdata

_SOLVE_MOD = "bigstitcher_spark_tpu.ops.solve"
_MISSING = object()
COMBOS = [
    (JM.TRANSLATION, JM.NONE),
    (JM.RIGID, JM.NONE),
    (JM.AFFINE, JM.NONE),
    (JM.AFFINE, JM.RIGID),
    (JM.RIGID, JM.TRANSLATION),
    (JM.TRANSLATION, JM.IDENTITY),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shim_state():
    return (getattr(jax.experimental, "enable_x64", _MISSING),
            _SOLVE_MOD in sys.modules, hasattr(jax_ops, "solve"))


@contextlib.contextmanager
def x64_shim():
    """``jax.experimental.enable_x64`` as ``jax.enable_x64`` inside, and the
    JAX ``ops.solve`` importable; on exit both are as they were before."""
    before = _shim_state()
    if before[0] is _MISSING:
        jax.experimental.enable_x64 = jax.enable_x64
    try:
        importlib.import_module(_SOLVE_MOD)
        yield
    finally:
        if before[0] is _MISSING:
            del jax.experimental.enable_x64
        if not before[1]:
            sys.modules.pop(_SOLVE_MOD, None)
        if not before[2] and hasattr(jax_ops, "solve"):
            delattr(jax_ops, "solve")


@pytest.fixture()
def jax_solver():
    """The JAX solver module, with its ``ops.solve`` importable for the
    test; afterwards the shim is gone again."""
    before = _shim_state()
    with x64_shim():
        yield JS
    assert _shim_state() == before


def test_x64_shim_leaves_nothing_behind():
    def try_import():
        try:
            importlib.import_module(_SOLVE_MOD)
            return None
        except ImportError as e:
            return str(e)

    before = _shim_state()
    failed_before = try_import()
    after_failed = _shim_state()
    with x64_shim():
        assert _SOLVE_MOD in sys.modules
        assert hasattr(jax.experimental, "enable_x64")
    assert _shim_state() == before == after_failed
    assert try_import() == failed_before
    if failed_before is not None:
        # the JAX package's own solver tests see the same failure
        assert "enable_x64" in failed_before
        with pytest.raises(ImportError, match="enable_x64"):
            JS._resolve_backend(JS.SolverParams(backend="numpy"))
        assert _shim_state() == before


# ---------------------------------------------------------------- graphs


def _graph(n=(4, 3), jitter=3.0, seed=0, tile=(100, 100, 50), step=80.0):
    """tests/test_solve_device.py's link graph: truth-consistent 8-corner
    links (the stitching-source shape) with jittered nominal positions.
    Returns :func:`_pair`'s four lists."""
    rng = np.random.default_rng(seed)
    tiles = [(JSD.ViewId(0, i),) for i in range(n[0] * n[1])]
    truth = {i: np.array([(i % n[0]) * step, (i // n[0]) * step, 0.0])
             for i in range(len(tiles))}
    nom = {i: truth[i] + (rng.uniform(-jitter, jitter, 3) if i else 0.0)
           for i in truth}
    corners = np.array([[x, y, z] for x in (0, tile[0]) for y in (0, tile[1])
                        for z in (0, tile[2])], float)
    links = []
    for i in range(len(tiles)):
        for j in (i + 1, i + n[0]):
            if j >= len(tiles):
                continue
            if j == i + 1 and (i % n[0]) == n[0] - 1:
                continue
            shift = (truth[i] - nom[i]) - (truth[j] - nom[j])
            links.append(JS.MatchLink(tiles[i], tiles[j], corners,
                                      corners + shift, np.full(8, 0.9)))
    return _pair(tiles, links)


def _pair(tiles, links):
    """(JAX tiles, JAX links, port tiles, port links) of one graph."""
    return (tiles, links, [_port_key(k) for k in tiles],
            TS.links_from_reference(links))


def _port_key(k):
    return tuple(TSD.ViewId(v.timepoint, v.setup) for v in k)


def _plain_key(k):
    """A tile key, or a link's pair of keys, as tuples of ints: the two
    packages' ViewIds are different classes."""
    if k and isinstance(k[0], tuple):
        return tuple(_plain_key(x) for x in k)
    return tuple((v.timepoint, v.setup) for v in k)


def _bad_graph():
    tiles, links, _, _ = _graph()
    corners = links[0].p
    links.append(JS.MatchLink(tiles[0], tiles[5], corners,
                              corners + np.array([80.0, -60.0, 40.0]),
                              np.full(8, 0.8)))
    return _pair(tiles, links)


def _ip_links(tmp_path, grid=(2, 2, 1), per_pair=16, seed=3):
    """An interest-point graph with rigid truth (solverdata.make_ip_grid),
    assembled by each package from the same XML and store."""
    ip = solverdata.make_ip_grid(str(tmp_path / "ip"), grid=grid,
                                 tile=(200, 200, 60), n_per_pair=per_pair,
                                 noise=0.1, max_deg=2.0, seed=seed)
    jsd = JSD.SpimData.load(ip.xml_path)
    from bigstitcher_spark_tpu.io.interestpoints import (
        InterestPointStore as JStore,
    )

    tiles = JS.build_tiles(jsd, jsd.view_ids(), JS.SolverParams(source="IP"))
    jl = JS.matches_from_interest_points(
        jsd, tiles, JStore.for_project(jsd), ["beads"], verbose=False)
    tsd = TSD.SpimData.load(ip.xml_path)
    ttiles = TS.build_tiles(tsd, tsd.view_ids(), TS.SolverParams(source="IP"))
    tl = TS.matches_from_interest_points(
        tsd, ttiles, InterestPointStore.for_project(tsd), ["beads"],
        verbose=False)
    return tiles, jl, ttiles, tl


def _assert_same_result(a, b, rtol=1e-9, atol=1e-9, exact=False):
    """The JAX package's device-vs-numpy contract; keys compared as ints."""
    assert a.iterations == b.iterations
    assert [_plain_key(k) for k in a.removed_links] == \
        [_plain_key(k) for k in b.removed_links]
    if exact:
        np.testing.assert_array_equal(a.history, b.history)
    else:
        np.testing.assert_allclose(a.history, b.history, rtol=rtol, atol=atol)
    ac = {_plain_key(k): v for k, v in a.corrections.items()}
    bc = {_plain_key(k): v for k, v in b.corrections.items()}
    assert set(ac) == set(bc)
    for k in ac:
        if exact:
            np.testing.assert_array_equal(ac[k], bc[k])
        else:
            np.testing.assert_allclose(ac[k], bc[k], rtol=1e-7, atol=atol)
    ae = {_plain_key(k): v for k, v in a.link_errors.items()}
    be = {_plain_key(k): v for k, v in b.link_errors.items()}
    assert set(ae) == set(be)
    for k in ae:
        np.testing.assert_allclose(ae[k], be[k], rtol=1e-7, atol=atol)


def _params(pkg, **kw):
    if pkg is TS:
        kw.setdefault("device", "cpu")
        kw.setdefault("backend", "device")
    return pkg.SolverParams(**kw)


# ---------------------------------------------------------------- fits


@pytest.mark.parametrize("fit", ["fit_translation", "fit_rigid", "fit_affine"])
def test_fits_equal_reference(fit):
    rng = np.random.default_rng(5)
    p = rng.uniform(0, 100, (4, 30, 3))
    a = np.eye(3, 4) + rng.normal(0, 0.02, (3, 4))
    q = p @ a[:, :3].T + a[:, 3] + rng.normal(0, 0.1, p.shape)
    w = rng.uniform(0.2, 1.0, (4, 30))
    for args in ((p, q), (p, q, w), (p[0], q[0], w[0])):
        np.testing.assert_array_equal(getattr(TM, fit)(*args),
                                      getattr(JM, fit)(*args))


def test_fit_interpolated_and_error_equal_reference():
    rng = np.random.default_rng(6)
    p = rng.uniform(0, 10, (12, 3))
    q = p + rng.uniform(-1, 1, 3)
    for kind, reg, lam in ((TM.TRANSLATION, TM.IDENTITY, 0.5),
                           (TM.AFFINE, TM.RIGID, 0.1),
                           (TM.RIGID, TM.NONE, 0.3)):
        m = TM.fit_interpolated(kind, reg, lam, p, q)
        np.testing.assert_array_equal(
            m, JM.fit_interpolated(kind, reg, lam, p, q))
        np.testing.assert_array_equal(TM.model_error(m, p, q),
                                      JM.model_error(m, p, q))
    np.testing.assert_array_equal(TM.fit_model(TM.IDENTITY, p[None], q[None]),
                                  JM.fit_model(JM.IDENTITY, p[None], q[None]))


# ---------------------------------------------------------------- relax


@pytest.mark.parametrize("model,reg", COMBOS)
def test_relax_matches_both_jax_backends(jax_solver, model, reg):
    tiles, jl, ttiles, tl = _graph()
    port = TS.relax(tl, ttiles, {ttiles[0]}, _params(TS, model=model,
                                                    regularization=reg))
    for backend in ("numpy", "device"):
        ref = jax_solver.relax(jl, tiles, {tiles[0]}, _params(
            JS, model=model, regularization=reg, backend=backend))
        _assert_same_result(ref, port)


@pytest.mark.parametrize("model,reg", COMBOS)
def test_relax_ip_graph_matches_jax(jax_solver, tmp_path, model, reg):
    """Rigidly perturbed views, many iterations (capped at 300; plateau
    width 40): the port's twins track the JAX numpy path sweep by sweep."""
    tiles, jl, ttiles, tl = _ip_links(tmp_path)
    kw = dict(model=model, regularization=reg, max_iterations=300,
              max_plateau_width=40)
    port = TS.relax(tl, ttiles, {ttiles[0]}, _params(TS, **kw))
    ref = jax_solver.relax(jl, tiles, {tiles[0]}, _params(
        JS, backend="numpy", **kw))
    # the warm start is the optimum of TRANSLATION alone (6 stall sweeps)
    assert ref.iterations > 6 or (model, reg) == (JM.TRANSLATION, JM.NONE)
    _assert_same_result(ref, port)
    # the port's own numpy backend is the JAX package's code
    mine = TS.relax(tl, ttiles, {ttiles[0]}, _params(TS, backend="numpy",
                                                     **kw))
    _assert_same_result(ref, mine, exact=True)


def test_empty_links_identity():
    _, _, tiles, _ = _graph(n=(2, 1))
    res = TS.relax([], tiles, {tiles[0]}, _params(TS))
    for k in tiles:
        np.testing.assert_array_equal(res.corrections[k], np.eye(3, 4))
    assert res.iterations == 0


def test_iterative_drops_identical_link_sequence(jax_solver):
    tiles, jl, ttiles, tl = _bad_graph()
    port = TS.solve_iterative(tl, ttiles, {ttiles[0]}, _params(
        TS, method="ONE_ROUND_ITERATIVE"), verbose=False)
    assert len(port.removed_links) >= 1
    for backend in ("numpy", "device"):
        ref = jax_solver.solve_iterative(jl, tiles, {tiles[0]}, _params(
            JS, method="ONE_ROUND_ITERATIVE", backend=backend),
            verbose=False)
        _assert_same_result(ref, port)


def test_masked_resolve_equals_rebuilt():
    """A re-solve with a zeroed link-weight mask equals a solve of the
    link list without that link, bit for bit on the twins (the masked rows
    add exact zeros in the same order)."""
    _, _, tiles, tl = _bad_graph()
    fixed = {tiles[0]}
    params = _params(TS, model=TM.TRANSLATION)
    state = TS._DeviceRelax(tl, tiles, fixed, params)
    mask = np.ones(len(tl))
    mask[-1] = 0.0
    masked = state.solve(mask)
    rebuilt = TS.relax(tl[:-1], tiles, fixed, params)
    _assert_same_result(masked, rebuilt, exact=True)


def test_backend_knob(monkeypatch):
    monkeypatch.delenv("BST_SOLVE_DEVICE", raising=False)
    assert TS._resolve_backend(TS.SolverParams()) == "device"
    monkeypatch.setenv("BST_SOLVE_DEVICE", "0")
    assert TS._resolve_backend(TS.SolverParams()) == "numpy"
    assert TS._resolve_backend(TS.SolverParams(backend="device")) == "device"


def test_device_backend_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tiles, tl = _graph(n=(2, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.relax(tl, tiles, {tiles[0]}, TS.SolverParams())


def test_problem_from_reference_equals_prepare(jax_solver):
    """The JAX package's RelaxProblem arrays (bucket-padded), carried
    across, give the same rows as the port's own layout."""
    from bigstitcher_spark_tpu.ops import solve as jax_solve

    tiles, jl, _, tl = _bad_graph()
    index = {k: i for i, k in enumerate(tiles)}
    rows = [(index[lk.key_a], index[lk.key_b], lk.p, lk.q, lk.w)
            for lk in jl]
    mine = TO.prepare_relax(rows, len(tiles), "cpu")
    ref = jax_solve.prepare_relax(rows, len(tiles), 1)
    assert ref.local.shape[0] > ref.n_rows  # padded to its bucket
    fields = {k: getattr(ref, k) for k in (
        "n_tiles", "n_links", "n_rows", "local", "target", "own", "other",
        "w", "link_id", "side_a")}
    theirs = TO.relax_problem_from_reference(fields, "cpu")
    for name in ("local", "target", "own", "other", "w", "link_id",
                 "tile_ptr", "link_rows", "link_ptr", "link_own"):
        assert torch.equal(getattr(mine, name), getattr(theirs, name)), name


# ---------------------------------------------------------------- twin stages


def _stage_inputs(seed=0):
    tiles, jl, _, tl = _bad_graph()
    rng = np.random.default_rng(seed)
    index = {k: i for i, k in enumerate(tiles)}
    T = len(tiles)
    rows = [(index[lk.key_a], index[lk.key_b], lk.p, lk.q, lk.w)
            for lk in jl]
    pr = TO.prepare_relax(rows, T, "cpu")
    cur = np.eye(3, 4)[None].repeat(T, 0) + rng.normal(0, 1e-3, (T, 3, 4))
    cur[:, :, 3] = rng.uniform(-5, 5, (T, 3))
    mask = np.ones(len(tl))
    mask[2] = 0.0
    return tiles, jl, index, pr, cur, mask


def test_k11_moments_twin_equals_segment_moments():
    """The twin's moments are the numpy path's, taken about each tile's
    origin (the mean of its points) instead of the world origin."""
    tiles, jl, index, pr, cur, mask = _stage_inputs()
    local, target, own, other, w = JS._flatten(jl, index)
    lid = np.repeat(np.arange(len(jl)), [2 * len(lk.p) for lk in jl])
    w_eff = w * mask[lid]
    tgt_world = JS._apply_batch(cur, target, other)
    origin = TO.tile_origin(pr, torch.from_numpy(mask))
    o = origin.numpy()
    active = mask[lid] != 0
    for t in range(len(tiles)):
        np.testing.assert_allclose(o[t], local[(own == t) & active].mean(0),
                                   rtol=1e-12)
    ref = JS._segment_moments(local - o[own], tgt_world - o[own], own, w_eff,
                              len(tiles))
    got = TO.relax_moments(pr, torch.from_numpy(cur), torch.from_numpy(mask),
                           origin).numpy()
    T = len(tiles)
    flat = np.concatenate([ref[0][:, None], ref[1], ref[2],
                           ref[3].reshape(T, 16), ref[4].reshape(T, 12)],
                          axis=1)
    np.testing.assert_allclose(got, flat, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("model,reg", COMBOS)
def test_k12_fit_twin_equals_reference_fits(jax_solver, model, reg):
    tiles, jl, index, pr, cur, mask = _stage_inputs(1)
    origin = TO.tile_origin(pr, torch.from_numpy(mask))
    mom = TO.relax_moments(pr, torch.from_numpy(cur), torch.from_numpy(mask),
                           origin)
    T = len(tiles)
    m = mom.numpy()
    parts = (m[:, 0], m[:, 1:5], m[:, 5:8], m[:, 8:24].reshape(T, 4, 4),
             m[:, 24:36].reshape(T, 4, 3))
    from bigstitcher_spark_tpu.ops import solve as jax_solve

    for kind in {model, reg} - {JM.NONE}:
        ref = JS._fit_from_moments(kind, *parts)
        got = TO.fit_from_moments_plain(kind, mom).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)
        with jax.experimental.enable_x64():
            jref = np.asarray(jax_solve._fit_from_moments_jnp(kind, *parts))
        np.testing.assert_allclose(got, jref, rtol=1e-9, atol=1e-9)
    fixed = np.zeros(T, np.uint8)
    fixed[0] = 1
    new = JS._fit_from_moments(model, *parts)
    if reg != JM.NONE:
        new = 0.9 * new + 0.1 * JS._fit_from_moments(reg, *parts)
    # fitted about each tile's origin o: back to world coordinates
    o = origin.numpy()
    new[:, :, 3] += o - np.einsum("tij,tj->ti", new[:, :, :3], o)
    new[0] = np.eye(3, 4)
    want = 0.5 * cur + 0.5 * new
    got = TO.relax_fit(mom, torch.from_numpy(fixed), origin, model, reg,
                       0.1, 0.5, None, torch.from_numpy(cur.copy())).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def _exact_affine_fit(p, q, w, eps=1e-9):
    """The JAX program's regularised AFFINE fit, (sum w ph ph^T + eps I) X
    = sum w ph q^T about the world origin, in exact rational arithmetic
    from the float64 inputs."""
    from fractions import Fraction as Fr

    ph = [[Fr(x) for x in row] + [Fr(1)] for row in p.tolist()]
    wf = [Fr(x) for x in w.tolist()]
    qf = [[Fr(x) for x in row] for row in q.tolist()]
    n = len(ph)
    m = [[sum(wf[i] * ph[i][a] * ph[i][b] for i in range(n))
          + (Fr(eps) if a == b else 0) for b in range(4)]
         + [sum(wf[i] * ph[i][a] * qf[i][c] for i in range(n))
            for c in range(3)] for a in range(4)]
    for c in range(4):
        piv = next(r for r in range(c, 4) if m[r][c] != 0)
        m[c], m[piv] = m[piv], m[c]
        for r in range(4):
            if r != c and m[r][c] != 0:
                f = m[r][c] / m[c][c]
                m[r] = [x - f * y for x, y in zip(m[r], m[c])]
    return np.array([[float(m[k][4 + j] / m[k][k]) for k in range(4)]
                     for j in range(3)])


def test_affine_fit_about_tile_origin_is_closer_to_exact(tmp_path):
    """The twin (moments about the tile's origin, the ridge carried there)
    lands within 1e-12 of the exact regularised fit; the JAX formulation
    (moments about the world origin) is further off on the same rows."""
    _, _, ttiles, tl = _ip_links(tmp_path)
    index = {k: i for i, k in enumerate(ttiles)}
    pr = TO.prepare_relax([(index[lk.key_a], index[lk.key_b], lk.p, lk.q,
                            lk.w) for lk in tl], len(ttiles), "cpu")
    T = len(ttiles)
    ident = torch.eye(3, 4, dtype=torch.float64).repeat(T, 1, 1)
    ones = torch.ones(len(tl), dtype=torch.float64)
    origin = TO.tile_origin(pr, ones)
    mom = TO.relax_moments_plain(pr, ident, ones, origin)
    got = TO.relax_fit_plain(mom, torch.zeros(T, dtype=torch.uint8), origin,
                             TM.AFFINE, TM.NONE, 0.0, 1.0, None,
                             ident.clone()).numpy()
    for t in range(T):
        sel = (pr.own == t).numpy()
        p, q, w = (pr.local.numpy()[sel], pr.target.numpy()[sel],
                   pr.w.numpy()[sel])
        exact = _exact_affine_fit(p, q, w)
        ref = JS._fit_from_moments(JM.AFFINE, *JS._segment_moments(
            p, q, np.zeros(len(p), int), w, 1))[0]
        err = np.abs(got[t] - exact).max()
        assert err <= 1e-12, (t, err)
        assert err <= np.abs(ref - exact).max(), t


def test_k13_error_twin_equals_mean_and_link_errors():
    tiles, jl, index, pr, cur, mask = _stage_inputs(2)
    tc, tm = torch.from_numpy(cur), torch.from_numpy(mask)
    num, den = TO.relax_error(pr, tc, tm)
    local, target, own, other, w = JS._flatten(jl, index)
    lid = np.repeat(np.arange(len(jl)), [2 * len(lk.p) for lk in jl])
    ref = JS._mean_error(cur, local, target, own, other, w * mask[lid])
    assert abs(float(num.sum() / den.sum()) - ref) <= 1e-12 * ref
    ln, ld = TO.relax_error(pr, tc, tm, by_link=True)
    link_err = (ln / torch.clamp(ld, min=1e-12)).numpy()
    per = JS._per_link_errors(cur, jl, index)
    for l, lk in enumerate(jl):
        want = per[(lk.key_a, lk.key_b)] if mask[l] else 0.0
        np.testing.assert_allclose(link_err[l], want, rtol=1e-12, atol=1e-15)


def _numpy_rules(errs, pw, max_error, max_iter):
    """The stopping iteration of models/solver.py's numpy loop for a given
    error sequence."""
    history, stall = [], 0
    for it in range(1, max_iter + 1):
        err = errs[it - 1]
        history.append(err)
        if len(history) > 1:
            stall = stall + 1 if history[-2] - err < 1e-9 * max(err, 1.0) else 0
            if stall >= 5:
                break
        if it > pw and history[-1] < max_error:
            window = history[-pw:]
            improvement = history[-pw - 1] - min(window)
            if improvement < 1e-4 * max(history[-1], 1e-12) or history[-1] < 1e-9:
                break
    return it, history


@pytest.mark.parametrize("case", ["stall", "plateau", "cap", "above_max"])
def test_k14_converge_twin_follows_the_rules(case):
    n, pw, max_error, cap = 400, 20, 5.0, 300
    k = np.arange(n, dtype=np.float64)
    errs = {"stall": 10.0 / (1 + k) + np.where(k > 30, 0.0, 0.0),
            "plateau": 1.0 + 0.5 * np.exp(-k / 10.0),
            "cap": 3.0 + 1e-3 * np.cos(k) - 1e-4 * k,
            "above_max": 8.0 + 0.5 * np.exp(-k / 10.0)}[case]
    if case == "stall":
        errs[40:] = errs[40]
    want_it, want_hist = _numpy_rules(errs, pw, max_error, cap)
    hist = torch.zeros(cap, dtype=torch.float64)
    state = torch.zeros(4, dtype=torch.int32)
    for i in range(n):
        # two tiles whose partial sums give errs[i]
        num = torch.tensor([errs[i] * 0.25, errs[i] * 0.75],
                           dtype=torch.float64)
        den = torch.tensor([0.25, 0.75], dtype=torch.float64)
        TO.relax_converge(num, den, hist, state, pw, max_error, cap)
    it, _stall, done, _ = state.tolist()
    assert done == 1 and it == want_it
    np.testing.assert_allclose(hist[:it].numpy(), want_hist, rtol=1e-15)


# ---------------------------------------------------------------- solve()


def _grid_xml(tmp_path, n=(3, 2), jitter=4.0, seed=0, islands=False):
    """tests/test_solver.py's grid project, made by the JAX package and
    saved as XML: (xml path, truth, nominal)."""
    from bigstitcher_spark_tpu.io.spimdata import (
        AttributeEntity, PairwiseStitchingResult, ViewSetup, ViewTransform,
        registration_hash)
    from bigstitcher_spark_tpu.utils.geometry import (
        Interval, translation_affine)

    rng = np.random.default_rng(seed)
    tile, overlap = (100, 100, 50), 20
    sd = JSD.SpimData()
    for a in ("illumination", "angle", "channel"):
        sd.attributes[a][0] = AttributeEntity(0, "0")
    step = (tile[0] - overlap, tile[1] - overlap)
    truth, nominal = {}, {}
    positions = [(tx * step[0], ty * step[1]) for ty in range(n[1])
                 for tx in range(n[0])]
    if islands:
        positions += [(0.0, 200.0), (80.0, 200.0)]
    for sid, (x, y) in enumerate(positions):
        truth[sid] = np.array([x, y, 0.0])
        nominal[sid] = truth[sid] + (rng.uniform(-jitter, jitter, 3)
                                     if sid else 0.0)
        sd.attributes["tile"][sid] = AttributeEntity(sid, str(sid))
        sd.setups[sid] = ViewSetup(id=sid, name=f"t{sid}", size=tile,
                                   attributes={"illumination": 0,
                                               "channel": 0, "tile": sid,
                                               "angle": 0})
        sd.registrations[JSD.ViewId(0, sid)] = [
            ViewTransform("grid", translation_affine(nominal[sid]))]

    def add_link(a, b, shift=None, r=0.9):
        va, vb = (JSD.ViewId(0, a),), (JSD.ViewId(0, b),)
        if shift is None:
            shift = (truth[a] - nominal[a]) - (truth[b] - nominal[b])
        res = PairwiseStitchingResult(
            va, vb, translation_affine(shift), r,
            hash=registration_hash([sd.model(va[0])], [sd.model(vb[0])]),
            bbox=Interval((0, 0, 0), (overlap - 1, tile[1] - 1, tile[2] - 1)))
        sd.stitching_results[res.pair_key] = res

    for ty in range(n[1]):
        for tx in range(n[0]):
            i = ty * n[0] + tx
            if tx + 1 < n[0]:
                add_link(i, i + 1)
            if ty + 1 < n[1]:
                add_link(i, i + n[0])
    if islands:
        k = n[0] * n[1]
        add_link(k, k + 1, shift=np.array([2.0, 0.0, 0.0]))
    xml = str(tmp_path / "grid.xml")
    sd.save(xml)
    return xml, truth, nominal


def _both_solve(jax_solver, xml, fixed=(), **kw):
    """JAX numpy solve and the port's; ``fixed``: (timepoint, setup)s."""
    jsd, tsd = JSD.SpimData.load(xml), TSD.SpimData.load(xml)
    ref = jax_solver.solve(jsd, jsd.view_ids(), _params(
        JS, backend="numpy", fixed_views=[JSD.ViewId(*v) for v in fixed],
        **kw), verbose=False)
    port = TS.solve(tsd, tsd.view_ids(), _params(
        TS, fixed_views=[TSD.ViewId(*v) for v in fixed], **kw),
        verbose=False)
    assert ref.iterations == port.iterations
    assert [_plain_key(k) for k in ref.removed_links] == \
        [_plain_key(k) for k in port.removed_links]
    rc = {_plain_key(k): v for k, v in ref.corrections.items()}
    pc = {_plain_key(k): v for k, v in port.corrections.items()}
    assert set(rc) == set(pc)
    for k in rc:
        np.testing.assert_allclose(pc[k], rc[k], rtol=1e-7, atol=1e-9)
    return ref, port, tsd


def test_solve_fixed_views(jax_solver, tmp_path):
    xml, truth, nominal = _grid_xml(tmp_path, n=(2, 2), seed=2)
    _, port, _ = _both_solve(jax_solver, xml, fixed=[(0, 3)])
    key3 = next(k for k in port.corrections if k[0].setup == 3)
    np.testing.assert_array_equal(port.corrections[key3], np.eye(3, 4))


def test_solve_two_round_places_disconnected_component(jax_solver, tmp_path):
    xml, _, _ = _grid_xml(tmp_path, n=(2, 1), seed=4, islands=True)
    _, port, _ = _both_solve(jax_solver, xml, method="TWO_ROUND_SIMPLE")
    c = {k[0].setup: v[:, 3] for k, v in port.corrections.items()}
    np.testing.assert_allclose(c[2] - c[3], [2.0, 0.0, 0.0], atol=0.01)
    np.testing.assert_allclose(c[2] + c[3], 0.0, atol=0.01)


def test_solve_iterative_on_project(jax_solver, tmp_path):
    xml, truth, nominal = _grid_xml(tmp_path, n=(4, 3), seed=3)
    ref, port, _ = _both_solve(jax_solver, xml, method="ONE_ROUND_ITERATIVE")
    assert port.error < 0.01


def test_stale_links_are_skipped(tmp_path):
    xml, _, _ = _grid_xml(tmp_path, n=(2, 1), seed=5)
    out = []
    for pkg, mod in ((JSD, JS), (TSD, TS)):
        sd = pkg.SpimData.load(xml)
        sd.registrations[pkg.ViewId(0, 1)][0].affine[:, 3] += 10.0
        tiles = mod.build_tiles(sd, sd.view_ids(), mod.SolverParams())
        out.append(mod.matches_from_stitching(sd, tiles, verbose=False))
    assert out == [[], []]
    sd = TSD.SpimData.load(xml)
    tiles = TS.build_tiles(sd, sd.view_ids(), TS.SolverParams())
    assert len(TS.matches_from_stitching(sd, tiles, verbose=False)) == 1


def test_store_corrections_equal_reference(jax_solver, tmp_path):
    xml, _, _ = _grid_xml(tmp_path, n=(2, 1), seed=7)
    ref, port, tsd = _both_solve(jax_solver, xml)
    jsd = JSD.SpimData.load(xml)
    jax_solver.store_corrections(jsd, ref, JS.SolverParams())
    TS.store_corrections(tsd, port, TS.SolverParams())
    for v, jv in zip(tsd.view_ids(), jsd.view_ids()):
        assert (v.timepoint, v.setup) == (jv.timepoint, jv.setup)
        assert tsd.registrations[v][0].name == jsd.registrations[jv][0].name
        np.testing.assert_allclose(tsd.model(v), jsd.model(jv), atol=1e-9)


# ---------------------------------------------------------------- CLI


def _cli_pair(tmp_path, src_xml, args):
    """The JAX solver CLI (click) and the port's (argparse) on two copies of
    one project; returns both saved XMLs loaded by the port."""
    from click.testing import CliRunner

    from bigstitcher_spark_tpu.cli.main import cli

    out = []
    for name in ("jax", "port"):
        d = tmp_path / name
        shutil.copytree(os.path.dirname(src_xml), d)
        xml = str(d / os.path.basename(src_xml))
        if name == "jax":
            res = CliRunner().invoke(cli, ["solver", "-x", xml, *args,
                                           "--solverBackend", "numpy"],
                                     catch_exceptions=False)
            assert res.exit_code == 0, res.output
        else:
            run = torch_main(["solver", "-x", xml, *args, "--device", "cpu"])
            assert set(run.timings) >= {"matches", "warm_start", "relax",
                                        "store", "total"}
        out.append(TSD.SpimData.load(xml))
    return out


def _assert_same_registrations(a, b, views):
    for v in views:
        assert [t.name for t in a.registrations[v]] == \
            [t.name for t in b.registrations[v]]
        np.testing.assert_allclose(a.model(v), b.model(v), rtol=0, atol=1e-9)


def test_cli_stitching_source_matches_jax_cli(jax_solver, tmp_path):
    g = solverdata.make_stitching_grid(str(tmp_path / "src"),
                                       grid=(8, 8, 2), tile=(200, 200, 60),
                                       n_bad=2, seed=1)
    jsd, tsd = _cli_pair(tmp_path, g.xml_path,
                         ["-s", "STITCHING", "--method",
                          "ONE_ROUND_ITERATIVE"])
    _assert_same_registrations(jsd, tsd, tsd.view_ids())
    base = tsd.model(TSD.ViewId(0, 0))[:, 3] - g.true_offsets[0]
    for v in tsd.view_ids():
        np.testing.assert_allclose(
            tsd.model(v)[:, 3] - g.true_offsets[v.setup], base, atol=0.05)


def test_cli_ip_source_matches_jax_cli(jax_solver, tmp_path):
    ip = solverdata.make_ip_grid(str(tmp_path / "src"), grid=(2, 2, 2),
                                 tile=(200, 200, 60), n_per_pair=20, seed=4)
    jsd, tsd = _cli_pair(tmp_path, ip.xml_path,
                         ["-s", "ip", "-l", "beads", "-tm", "AFFINE", "-rm",
                          "RIGID", "--lambda", "0.1", "--maxIterations",
                          "400", "--maxPlateauwidth", "50"])
    _assert_same_registrations(jsd, tsd, tsd.view_ids())


def test_cli_dry_run_saves_nothing(tmp_path):
    g = solverdata.make_stitching_grid(str(tmp_path / "src"), grid=(4, 4, 1),
                                       tile=(200, 200, 60), n_bad=0, seed=2)
    before = open(g.xml_path).read()
    run = torch_main(["solver", "-x", g.xml_path, "-s", "STITCHING",
                      "--dryRun", "--device", "cpu"])
    assert open(g.xml_path).read() == before
    assert "store" not in run.timings and run.result.iterations > 0
