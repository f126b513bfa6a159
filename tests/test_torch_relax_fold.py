"""The relax's folded launches, on the CPU through the plain twins: K14 in
the last block of K13 (one device: a sweep is K11, K12, K13 + K14) and the
shard sum K29 in the loads of K12 and K14 (the sharded relax: K12 and K14
take the shards' partials).

* ``RelaxRun`` in the new call order is bitwise the four-call order (K11,
  K12, K13, K14 as separate calls), for runs that stop on the plateau, the
  stall count and the iteration cap, at plateau widths 1 and 40;
* the twins of K12's and K14's sharded forms are bitwise
  ``shard_sum_plain`` followed by the twin, for 1, 2, 4 and 7 shards;
* the relax still meets the JAX package's device-vs-numpy contract
  (``tests/test_torch_solver.py``'s ``jax_solver`` fixture).

The kernels themselves are held bitwise against their unfused pairs on the
card: ``-k "relax or shard"`` in ``tests/test_torch_kernels.py`` (``-m
cuda``).
"""

import functools

import numpy as np
import pytest
import torch

from bigstitcher_spark_tpu.models import solver as JS
from bigstitcher_spark_tpu_torch.models import solver as TS
from bigstitcher_spark_tpu_torch.ops import shard as K
from bigstitcher_spark_tpu_torch.ops import solve as R
from test_torch_solver import _assert_same_result, _ip_links, _params, \
    jax_solver  # noqa: F401 (a fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ip_graph(tmp_path_factory):
    """A small interest-point graph with noisy rigid truth: (tiles, links,
    the JAX package's tiles and links, the relax problem's rows)."""
    jt, jl, tiles, links = _ip_links(tmp_path_factory.mktemp("fold"))
    index = {k: i for i, k in enumerate(tiles)}
    rows = [(index[lk.key_a], index[lk.key_b], lk.p, lk.q, lk.w)
            for lk in links]
    return tiles, links, jt, jl, rows


def _relax_args(rows, T, model, reg, pw, cap):
    fixed = np.zeros(T, bool)
    fixed[0] = True
    warm = np.random.default_rng(35).uniform(-2, 2, (T, 3))
    warm[0] = 0.0
    mask = np.ones(len(rows))
    return (R.prepare_relax(rows, T, "cpu"), mask, fixed, warm, 0.1, 0.5,
            5.0, cap, model, reg, pw)


def _four_call(args):
    """A RelaxRun whose sweep is the four separate twins: K11, K12, K13,
    K14."""
    run = R.RelaxRun(R.PLAIN, *args)
    rp, problem = run.first, run.shards[0]
    model, reg, lam, damping, pw, max_error, max_iter = run.args
    bind = functools.partial
    run.calls = (
        bind(R.relax_moments_plain, problem, rp.cur, rp.link_w, rp.origin,
             rp.state, out=rp.mom),
        bind(R.relax_fit_plain, rp.mom, rp.fixed, rp.origin, model, reg, lam,
             damping, rp.state, rp.cur),
        bind(R.relax_error_plain, problem, rp.cur, rp.link_w, rp.state,
             out=(rp.num, rp.den)),
        bind(R.relax_converge_plain, rp.num, rp.den, rp.hist, rp.state, pw,
             max_error, max_iter))
    return run


def _rule(state, cap):
    it, stall, done, _ = state
    assert done == 1
    return "cap" if it == cap else "stall" if stall >= 5 else "plateau"


# (model, regulariser, plateau width, cap) -> the rule that stops the run
CASES = [
    ("AFFINE", "RIGID", 1, 300, "plateau"),
    ("AFFINE", "RIGID", 40, 300, "cap"),
    ("AFFINE", "RIGID", 40, 7, "cap"),
    ("TRANSLATION", "NONE", 1, 300, "plateau"),
    ("TRANSLATION", "NONE", 40, 300, "stall"),
    ("TRANSLATION", "NONE", 1, 7, "cap"),
    ("RIGID", "AFFINE", 1, 300, "plateau"),
    ("RIGID", "AFFINE", 40, 300, "stall"),
    ("RIGID", "AFFINE", 40, 7, "cap"),
]


@pytest.mark.parametrize("model,reg,pw,cap,rule", CASES, ids=str)
def test_three_calls_bitwise_four(ip_graph, model, reg, pw, cap, rule):
    tiles, _, _, _, rows = ip_graph
    args = _relax_args(rows, len(tiles), model, reg, pw, cap)
    new = R.RelaxRun(R.PLAIN, *args)
    assert len(new.calls) == 3
    got = new.run()
    old = _four_call(args)
    ref = old.run()
    assert _rule(new.first.state.tolist(), cap) == rule
    assert torch.equal(new.first.state, old.first.state)
    assert got.iterations == ref.iterations
    for a, b in ((got.history, ref.history), (got.models, ref.models),
                 (got.link_errors, ref.link_errors)):
        assert np.array_equal(a, b)
    assert int(new.first.ticket) == 0


def _parts(seed, S, shape):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0, 10.0 ** rng.integers(-3, 4),
                                        shape)) for _ in range(S)]


@pytest.mark.parametrize("S", [1, 2, 4, 7])
@pytest.mark.parametrize("model,reg", [("AFFINE", "RIGID"),
                                       ("TRANSLATION", "NONE"),
                                       ("RIGID", "AFFINE")])
def test_fit_twin_folds_shard_sum(S, model, reg):
    """K12's sharded twin: the partials summed in K29's order, then the
    fit, bitwise."""
    T = 40
    rng = np.random.default_rng(S)
    share = rng.dirichlet(np.ones(S))
    base = torch.from_numpy(_fit_base(rng, T))
    parts = [base * float(c) for c in share]
    fixed = torch.zeros(T, dtype=torch.uint8)
    fixed[3] = 1
    origin = torch.from_numpy(rng.uniform(-5, 5, (T, 3)))
    cur0 = torch.from_numpy(np.eye(3, 4)[None].repeat(T, 0)
                            + rng.normal(0, 0.01, (T, 3, 4)))
    mom = K.shard_sum_plain(parts, torch.empty(T, R.N_MOMENTS,
                                               dtype=torch.float64))
    ref = R.relax_fit_plain(mom, fixed, origin, model, reg, 0.1, 0.7, None,
                            cur0.clone())
    got = R.relax_fit_plain(parts, fixed, origin, model, reg, 0.1, 0.7, None,
                            cur0.clone())
    assert torch.equal(got, ref)
    assert torch.equal(R.relax_fit(parts, fixed, origin, model, reg, 0.1, 0.7,
                                   None, cur0.clone()), ref)
    done = torch.tensor([0, 0, 1, 0], dtype=torch.int32)
    kept = cur0.clone()
    R.relax_fit_plain(parts, fixed, origin, model, reg, 0.1, 0.7, done, kept)
    assert torch.equal(kept, cur0)


def _fit_base(rng, T, n=30):
    """Moments (T, 36) of weighted noisy rigid maps."""
    mom = np.zeros((T, R.N_MOMENTS))
    for t in range(T):
        p = rng.uniform(-50, 50, (n, 3))
        q = (p @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T
             + rng.normal(0, 0.5, p.shape))
        w = rng.uniform(0.5, 2.0, n)
        ph = np.c_[p, np.ones(n)]
        mom[t, 0] = w.sum()
        mom[t, 1:5] = (w[:, None] * ph).sum(0)
        mom[t, 5:8] = (w[:, None] * q).sum(0)
        mom[t, 8:24] = (ph.T @ (w[:, None] * ph)).ravel()
        mom[t, 24:36] = (ph.T @ (w[:, None] * q)).ravel()
    return mom


@pytest.mark.parametrize("S", [1, 2, 4, 7])
@pytest.mark.parametrize("pw", [1, 40])
def test_converge_twin_folds_shard_sum(S, pw):
    """K14's sharded twin: each tile's num / den partials summed in K29's
    order, then the rules, bitwise over a run of 60 launches that the
    plateau (width 1) or the stall count (40) stops."""
    T, cap = 300, 100
    k = np.arange(cap, dtype=np.float64)
    errs = np.maximum(10.0 / (1 + k), 10.0 / 41)
    sides = []
    for fold in (True, False):
        hist = torch.zeros(cap, dtype=torch.float64)
        state = torch.zeros(4, dtype=torch.int32)
        for j, e in enumerate(errs[:60]):
            num = [p.abs() * e for p in _parts(j, S, T)]
            den = [p.abs() for p in _parts(j, S, T)]
            if fold:
                R.relax_converge_plain(num, den, hist, state, pw, 5.0, cap)
            else:
                out = torch.empty(T, dtype=torch.float64)
                n = K.shard_sum_plain(num, out.clone())
                d = K.shard_sum_plain(den, out.clone())
                R.relax_converge_plain(n, d, hist, state, pw, 5.0, cap)
        sides.append((hist, state))
    (h1, s1), (h2, s2) = sides
    assert torch.equal(h1, h2) and torch.equal(s1, s2)
    assert int(s1[2]) == 1


def test_sharded_run_takes_no_shard_sum_a_sweep(ip_graph, monkeypatch):
    """The sharded relax's sweeps hand the partials to K12 and K14: the
    shard sum runs for the tile origins and the link errors only."""
    tiles, _, _, _, rows = ip_graph
    T = len(tiles)
    args = list(_relax_args(rows, T, "AFFINE", "RIGID", 40, 20))
    args[0] = R.prepare_relax(rows, T, "cpu", 4, mesh=["cpu"] * 4)
    calls = []

    def counting(parts, out, *a, **k):
        calls.append(len(parts))
        return K.shard_sum_plain(parts, out, *a, **k)

    fns = R.PLAIN._replace(shard_sum=counting)
    out = R.RelaxRun(fns, *args).run()
    assert calls == [4, 4]
    one = R.relax_plain(*_relax_args(rows, T, "AFFINE", "RIGID", 40, 20))
    assert out.iterations == one.iterations == 20
    assert np.array_equal(out.models, one.models)
    assert np.array_equal(out.history, one.history)
    assert np.array_equal(out.link_errors, one.link_errors)


@pytest.mark.parametrize("pw", [1, 40])
def test_folded_relax_meets_jax_contract(jax_solver, ip_graph, pw):  # noqa: F811
    tiles, links, jt, jl, _ = ip_graph
    kw = dict(model="AFFINE", regularization="RIGID", max_iterations=300,
              max_plateau_width=pw)
    port = TS.relax(links, tiles, {tiles[0]}, _params(TS, **kw))
    ref = jax_solver.relax(jl, jt, {jt[0]}, _params(JS, backend="numpy",
                                                   **kw))
    _assert_same_result(ref, port)
