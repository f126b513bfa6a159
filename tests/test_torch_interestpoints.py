"""The port's interestpoints.n5 store against the JAX package's: each reads
what the other wrote (ids, locations and correspondences identical), the
XML lookups round-trip, and both packages assemble the same solver links
from one project."""

import numpy as np
import pytest
import torch

from bigstitcher_spark_tpu.io import interestpoints as JIP
from bigstitcher_spark_tpu.io import spimdata as JSD
from bigstitcher_spark_tpu.models import solver as JS
from bigstitcher_spark_tpu_torch.io import interestpoints as TIP
from bigstitcher_spark_tpu_torch.io import spimdata as TSD
from bigstitcher_spark_tpu_torch.models import solver as TS
from bigstitcher_spark_tpu_torch.utils import solverdata


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _content(rng):
    """Points of two labels of three views and their correspondences, in
    (timepoint, setup) form so both packages can build them."""
    views = [(0, 0), (0, 1), (1, 2)]
    pts, corrs = {}, {}
    for v in views:
        for label in ("beads", "nuclei"):
            n = int(rng.integers(5, 40))
            ids = rng.permutation(10 * n)[:n].astype(np.uint64)
            pts[v, label] = (ids, rng.uniform(-50, 500, (n, 3)))
    for (v, label), (ids, _) in pts.items():
        out = []
        for k in range(int(rng.integers(0, 12))):
            ov = views[int(rng.integers(len(views)))]
            ol = ("beads", "nuclei")[int(rng.integers(2))]
            oids = pts[ov, ol][0]
            out.append((int(ids[k % len(ids)]), ov, ol,
                        int(oids[int(rng.integers(len(oids)))])))
        corrs[v, label] = out
    pts[(1, 2), "empty"] = (np.zeros(0, np.uint64), np.zeros((0, 3)))
    corrs[(1, 2), "empty"] = []
    return pts, corrs


def _write(pkg, root, pts, corrs):
    store = pkg.InterestPointStore(str(root))
    vid = JSD.ViewId if pkg is JIP else TSD.ViewId
    for (v, label), (ids, locs) in pts.items():
        store.save_points(vid(*v), label, locs, ids)
    for (v, label), cs in corrs.items():
        store.save_correspondences(vid(*v), label, [
            pkg.CorrespondingPoint(i, vid(*ov), ol, j)
            for i, ov, ol, j in cs])


def _read(pkg, root, keys):
    store = pkg.InterestPointStore(str(root))
    vid = JSD.ViewId if pkg is JIP else TSD.ViewId
    pts, corrs = {}, {}
    for v, label in keys:
        pts[v, label] = store.load_points(vid(*v), label)
        corrs[v, label] = [
            (c.id, (c.other_view.timepoint, c.other_view.setup),
             c.other_label, c.other_id)
            for c in store.load_correspondences(vid(*v), label)]
    return pts, corrs


@pytest.mark.parametrize("writer,reader", [(JIP, TIP), (TIP, JIP), (TIP, TIP)],
                         ids=["jax-to-port", "port-to-jax", "port-to-port"])
def test_store_round_trips_between_packages(tmp_path, writer, reader):
    pts, corrs = _content(np.random.default_rng(0))
    root = tmp_path / "interestpoints.n5"
    _write(writer, root, pts, corrs)
    got_pts, got_corrs = _read(reader, root, list(pts))
    for key, (ids, locs) in pts.items():
        gids, glocs = got_pts[key]
        assert gids.dtype == np.uint64 and glocs.dtype == np.float64
        np.testing.assert_array_equal(gids, ids)
        np.testing.assert_array_equal(glocs, locs.reshape(-1, 3))
        assert got_corrs[key] == corrs[key]


def test_port_reads_jax_store_bytes_identically(tmp_path):
    """Both packages write the same datasets and attributes: the port's
    store, read back by the JAX package, equals the JAX package's own."""
    pts, corrs = _content(np.random.default_rng(1))
    _write(JIP, tmp_path / "a.n5", pts, corrs)
    _write(TIP, tmp_path / "b.n5", pts, corrs)
    a = JIP.InterestPointStore(str(tmp_path / "a.n5")).store
    b = JIP.InterestPointStore(str(tmp_path / "b.n5")).store
    for (v, label) in pts:
        grp = JIP.view_group(JSD.ViewId(*v), label)
        for sub in ("interestpoints", "correspondences"):
            assert a.get_attributes(f"{grp}/{sub}") == \
                b.get_attributes(f"{grp}/{sub}")
        for ds in ("interestpoints/id", "interestpoints/loc",
                   "correspondences/data"):
            np.testing.assert_array_equal(
                a.open_dataset(f"{grp}/{ds}").read_full(),
                b.open_dataset(f"{grp}/{ds}").read_full())


def test_clear_and_remove(tmp_path):
    pts, corrs = _content(np.random.default_rng(2))
    _write(TIP, tmp_path / "ip.n5", pts, corrs)
    store = TIP.InterestPointStore(str(tmp_path / "ip.n5"))
    v0, v1 = TSD.ViewId(0, 0), TSD.ViewId(0, 1)
    store.clear_correspondences(v0, "beads")
    assert store.load_correspondences(v0, "beads") == []
    assert len(store.load_points(v0, "beads")[0]) == len(pts[(0, 0), "beads"][0])
    store.remove_view(v0, "nuclei")
    assert len(store.load_points(v0, "nuclei")[0]) == 0
    assert len(store.load_points(v0, "beads")[0]) > 0
    store.remove_view(v1)
    for label in ("beads", "nuclei"):
        assert len(store.load_points(v1, label)[0]) == 0
        assert store.load_correspondences(v1, label) == []


def test_xml_lookups_round_trip(tmp_path):
    sd = TSD.SpimData()
    sd.setups[0] = TSD.ViewSetup(0, "a", (10, 10, 10))
    for s, label in ((0, "beads"), (0, "nuclei")):
        TIP.register_points_in_xml(sd, TSD.ViewId(0, s), label,
                                   "DoG sigma 1.8", f"tpId_0_viewSetupId_{s}/{label}")
    xml = str(tmp_path / "p.xml")
    sd.save(xml)
    for pkg in (TSD, JSD):
        got = pkg.SpimData.load(xml).interest_points[pkg.ViewId(0, 0)]
        assert sorted(got) == ["beads", "nuclei"]
        assert got["beads"].params == "DoG sigma 1.8"
        assert got["nuclei"].path == "tpId_0_viewSetupId_0/nuclei"


def test_matches_from_interest_points_equal_jax(tmp_path):
    ip = solverdata.make_ip_grid(str(tmp_path / "ip"), grid=(3, 2, 2),
                                 tile=(200, 200, 60), n_per_pair=12, seed=5)
    assert ip.n_links == 20 and ip.n_correspondences == 240
    jsd, tsd = JSD.SpimData.load(ip.xml_path), TSD.SpimData.load(ip.xml_path)
    jt = JS.build_tiles(jsd, jsd.view_ids(), JS.SolverParams(source="IP"))
    tt = TS.build_tiles(tsd, tsd.view_ids(), TS.SolverParams(source="IP"))
    jl = JS.matches_from_interest_points(
        jsd, jt, JIP.InterestPointStore.for_project(jsd), ["beads"], [2.0],
        verbose=False)
    tl = TS.matches_from_interest_points(
        tsd, tt, TIP.InterestPointStore.for_project(tsd), ["beads"], [2.0],
        verbose=False)
    assert len(jl) == len(tl) == ip.n_links
    for a, b in zip(jl, tl):
        assert [(v.timepoint, v.setup) for v in a.key_a + a.key_b] == \
            [(v.timepoint, v.setup) for v in b.key_a + b.key_b]
        for f in ("p", "q", "w"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert all((lk.w == 2.0).all() for lk in tl)
    # the beads sit where the true registrations put them: under truth,
    # each correspondence's two world points agree to the noise
    store = TIP.InterestPointStore.for_project(tsd)
    v = TSD.ViewId(0, 0)
    ids, locs = store.load_points(v, "beads")
    by_id = dict(zip(ids.tolist(), locs))
    worst = 0.0
    for c in store.load_correspondences(v, "beads"):
        ov = c.other_view.setup
        oids, olocs = store.load_points(c.other_view, "beads")
        o = dict(zip(oids.tolist(), olocs))[c.other_id]
        wa = ip.truth[0][:, :3] @ by_id[c.id] + ip.truth[0][:, 3]
        wb = ip.truth[ov][:, :3] @ o + ip.truth[ov][:, 3]
        worst = max(worst, float(np.abs(wa - wb).max()))
    assert worst < 1.0  # 0.1 px noise per axis and view
