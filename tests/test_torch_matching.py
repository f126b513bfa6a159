"""The port's ``match-interestpoints`` against the JAX package, on the CPU.

The pipeline fixture is the JAX package's own (tests/test_matching.py): a
2x2x1 project of 96x96x48 tiles, overlap 32, jitter 3, seed 9, 40 beads a
tile. Points are detected once (the port, on the CPU) and stored; then the
JAX package's ``match_interest_points`` and the port's run on the same
stored points with the same parameters. Their inlier sets are equal pair
by pair (the port's RANSAC draws other hypotheses from its own generator,
and the consensus it reaches is the same on this fixture). The
correspondences both packages store are byte for byte the same N5 blocks
and attributes. The port's ``solver -s IP`` then meets the JAX test's
gates (error < 1 px, tile spread < 1 px), and every stored link joins the
same true bead (< 5 px, median < 1 px).

Pair planning, grouping, merging, label tasks, ``-sr``, ICP and the CLI
are compared with the JAX package directly (plans and masks equal).
"""

import os
import shutil
import warnings

import numpy as np
import pytest
import torch

from bigstitcher_spark_tpu.cli.detection_tools import (
    match_interestpoints_cmd as jax_match_cmd,
)
from bigstitcher_spark_tpu.io.interestpoints import (
    InterestPointStore as JStore,
)
from bigstitcher_spark_tpu.io.spimdata import SpimData as JSpimData
from bigstitcher_spark_tpu.models import matching as JM
from bigstitcher_spark_tpu.utils.testdata import make_synthetic_project
from bigstitcher_spark_tpu_torch import NotYetPorted
from bigstitcher_spark_tpu_torch.cli.main import main as torch_main
from bigstitcher_spark_tpu_torch.io.dataset_io import ViewLoader
from bigstitcher_spark_tpu_torch.io.interestpoints import (
    InterestPointStore,
    register_points_in_xml,
)
from bigstitcher_spark_tpu_torch.io.spimdata import SpimData, ViewId
from bigstitcher_spark_tpu_torch.models import detection as TDet
from bigstitcher_spark_tpu_torch.models import matching as TM
from bigstitcher_spark_tpu_torch.models.solver import (
    SolverParams,
    solve,
    store_corrections,
)

CPU = "cpu"
FAST = dict(ransac_min_inliers=5, ransac_iterations=2000)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(v):
    return (v.timepoint, v.setup)


def _links(results):
    return {(_key(r.view_a), _key(r.view_b), r.label_a, r.label_b):
            set(zip(r.ids_a.tolist(), r.ids_b.tolist())) for r in results}


@pytest.fixture(scope="module")
def detected(tmp_path_factory):
    """The JAX fixture's project with points detected by the port."""
    proj = make_synthetic_project(
        str(tmp_path_factory.mktemp("match") / "proj"),
        n_tiles=(2, 2, 1), tile_size=(96, 96, 48), overlap=32,
        jitter=3.0, seed=9, n_beads_per_tile=40,
    )
    sd = SpimData.load(proj.xml_path)
    dets = TDet.detect_interest_points(
        sd, ViewLoader(sd), sorted(sd.registrations),
        TDet.DetectionParams(downsample_xy=1, downsample_z=1,
                             block_size=(96, 96, 48)),
        progress=False, device=CPU)
    TDet.save_detections(sd, InterestPointStore.for_project(sd), dets,
                         TDet.DetectionParams())
    sd.save(proj.xml_path)
    return proj


def _copy(proj, dst):
    shutil.copytree(os.path.dirname(proj.xml_path), dst)
    return os.path.join(dst, os.path.basename(proj.xml_path))


@pytest.fixture(scope="module")
def matched(detected, tmp_path_factory):
    """Both packages matched on copies of ``detected``; each saved its
    own results into its copy."""
    base = tmp_path_factory.mktemp("matched")
    jxml = _copy(detected, str(base / "jax"))
    txml = _copy(detected, str(base / "port"))
    jsd = JSpimData.load(jxml)
    jviews = sorted(jsd.registrations)
    jparams = JM.MatchingParams(**FAST)
    jstore = JStore.for_project(jsd)
    jres = JM.match_interest_points(jsd, jviews, jparams, jstore,
                                    progress=False)
    JM.save_matches(jsd, jstore, jres, jparams, jviews)
    tsd = SpimData.load(txml)
    tviews = sorted(tsd.registrations)
    tparams = TM.MatchingParams(**FAST)
    tstore = InterestPointStore.for_project(tsd)
    stats = TM.MatchingStats()
    tres = TM.match_interest_points(tsd, tviews, tparams, tstore,
                                    progress=False, device=CPU, stats=stats)
    TM.save_matches(tsd, tstore, tres, tparams, tviews)
    return detected, jxml, jres, txml, tres, stats


def test_inlier_sets_equal_jax(matched):
    _, _, jres, _, tres, stats = matched
    assert [(_key(r.view_a), _key(r.view_b)) for r in tres] == [
        (_key(r.view_a), _key(r.view_b)) for r in jres]
    assert _links(tres) == _links(jres)
    assert [r.n_candidates for r in tres] == [r.n_candidates for r in jres]
    for a, b in zip(jres, tres):
        assert (a.model is None) == (b.model is None)
        if a.model is not None:  # float64 refits on the same inliers
            np.testing.assert_allclose(b.model, a.model, rtol=0, atol=1e-9)
    assert stats.pairs == 6 and stats.inliers == sum(len(r.ids_a)
                                                     for r in tres)
    assert stats.timings["ransac"] > 0 and stats.kernels["descriptors"] > 0


def test_stored_correspondences_bytes_equal_jax(matched):
    _, jxml, _, txml, _, _ = matched
    jroot = os.path.join(os.path.dirname(jxml), "interestpoints.n5")
    troot = os.path.join(os.path.dirname(txml), "interestpoints.n5")
    files = []
    for d, _dirs, names in os.walk(troot):
        if "correspondences" in d:
            files += [os.path.relpath(os.path.join(d, n), troot)
                      for n in names]
    assert len(files) >= 8  # 4 views: attributes + one data block each
    for rel in files:
        with open(os.path.join(troot, rel), "rb") as f, \
                open(os.path.join(jroot, rel), "rb") as g:
            assert f.read() == g.read(), rel


def test_matches_link_same_beads(matched):
    proj, _, _, txml, tres, _ = matched
    store = InterestPointStore.for_project(SpimData.load(txml))
    checked = 0
    for r in tres:
        if len(r.ids_a) == 0:
            continue
        ids_a, locs_a = store.load_points(r.view_a, "beads")
        ids_b, locs_b = store.load_points(r.view_b, "beads")
        la = dict(zip(ids_a.tolist(), locs_a))
        lb = dict(zip(ids_b.tolist(), locs_b))
        d = np.array([np.linalg.norm(
            (la[ia] + proj.true_offsets[r.view_a.setup])
            - (lb[ib] + proj.true_offsets[r.view_b.setup]))
            for ia, ib in zip(r.ids_a.tolist(), r.ids_b.tolist())])
        checked += len(d)
        assert d.max() < 5.0 and np.median(d) < 1.0
    assert checked >= 20


def test_correspondences_symmetric_and_solver_reads_them(matched):
    proj, _, _, txml, _, _ = matched
    sd = SpimData.load(txml)
    store = InterestPointStore.for_project(sd)
    corrs = store.load_correspondences(ViewId(0, 0), "beads")
    assert len(corrs) > 0
    for c in corrs:
        back = store.load_correspondences(c.other_view, c.other_label)
        assert any(b.id == c.other_id and b.other_id == c.id
                   and b.other_view == ViewId(0, 0) for b in back)
    views = sorted(sd.registrations)
    params = SolverParams(source="IP", model="TRANSLATION", labels=["beads"],
                          device=CPU)
    res = solve(sd, views, params, verbose=False)
    assert res.error < 1.0
    store_corrections(sd, res, params)
    deltas = np.array([sd.model(v)[:, 3] - proj.true_offsets[v.setup]
                       for v in views])
    assert np.abs(deltas - deltas.mean(axis=0)).max() < 1.0


def test_cli_matches_and_dry_run(detected, tmp_path):
    xml = _copy(detected, str(tmp_path / "cli"))
    run = torch_main(["match-interestpoints", "-x", xml, "--device", "cpu",
                      "-rmni", "5", "-rit", "2000", "--dryRun"])
    assert sum(len(r.ids_a) for r in run.results) > 20
    store = InterestPointStore.for_project(SpimData.load(xml))
    assert store.load_correspondences(ViewId(0, 0), "beads") == []
    run = torch_main(["match-interestpoints", "-x", xml, "--device", "cpu",
                      "--ransacMinNumInliers", "5", "--ransacIterations",
                      "2000", "--ransacMaxEpsilon", "5",
                      "-ipfr", "OVERLAPPING_ONLY"])
    assert run.params.interest_points_for_overlap_only
    assert run.stats.timings["store"] > 0
    assert len(store.load_correspondences(ViewId(0, 0), "beads")) > 0


def test_cli_parameters_equal_jax_click(monkeypatch, detected):
    """Every option spelling, through both CLIs: the same MatchingParams."""
    seen = {}

    def grab(who):
        def fake(sd, views, params, store=None, *a, **kw):
            seen[who] = params
            return []
        return fake

    monkeypatch.setattr(JM, "match_interest_points", grab("jax"))
    monkeypatch.setattr(TM, "match_interest_points", grab("port"))
    from click.testing import CliRunner

    import bigstitcher_spark_tpu_torch.cli.detection_tools as TC

    monkeypatch.setattr(TC, "match_interest_points", grab("port"))
    args = ["-x", detected.xml_path, "--dryRun", "-l", "beads", "-l",
            "nuclei", "--matchAcrossLabels", "-m", "ICP",
            "--transformationModel", "RIGID", "--regularizationModel",
            "TRANSLATION", "--lambda", "0.3", "-rtp", "ALL_TO_ALL_WITH_RANGE",
            "--referenceTP", "2", "--rangeTP", "3", "-s", "2.5", "-n", "4",
            "-r", "2", "-rit", "77", "--ransacMaxError", "4.5", "-rmir", "0.2",
            "-rmni", "9", "-rmc", "--icpMaxDistance", "3.5",
            "--icpMaxIterations", "50", "--icpUseRANSAC", "-sr", "40",
            "-vr", "ALL_AGAINST_ALL", "--interestPointsForOverlapOnly",
            "--clearCorrespondences", "--interestPointMergeDistance", "3"]
    res = CliRunner().invoke(jax_match_cmd, args, catch_exceptions=False)
    assert res.exit_code == 0, res.output
    torch_main(["match-interestpoints", *args, "--device", "cpu"])
    j, t = vars(seen["jax"]), vars(seen["port"])
    assert t == j


@pytest.mark.parametrize("policy", ["TIMEPOINTS_INDIVIDUALLY", "ALL_TO_ALL",
                                    "ALL_TO_ALL_WITH_RANGE",
                                    "REFERENCE_TIMEPOINT"])
def test_plan_match_pairs_policies_equal_jax(tmp_path, policy):
    proj = make_synthetic_project(str(tmp_path / "tp"), n_tiles=(3, 1, 1),
                                  tile_size=(32, 32, 16), overlap=8,
                                  n_timepoints=4, n_beads_per_tile=4)
    jsd, tsd = JSpimData.load(proj.xml_path), SpimData.load(proj.xml_path)
    for kw in (dict(), dict(range_tp=1, reference_tp=2),
               dict(overlap_filter=False)):
        jp = JM.plan_match_pairs(jsd, sorted(jsd.registrations),
                                 JM.MatchingParams(registration_tp=policy,
                                                   **kw))
        tp = TM.plan_match_pairs(tsd, sorted(tsd.registrations),
                                 TM.MatchingParams(registration_tp=policy,
                                                   **kw))
        assert [(_key(a), _key(b)) for a, b in tp] == [
            (_key(a), _key(b)) for a, b in jp]
        assert tp


@pytest.fixture(scope="module")
def two_channel(tmp_path_factory):
    """The JAX test's 2 tiles x 2 channels with synthetic points: each
    channel sees a disjoint half of the beads."""
    proj = make_synthetic_project(
        str(tmp_path_factory.mktemp("grouped") / "proj"),
        n_tiles=(2, 1, 1), tile_size=(96, 96, 48), overlap=40,
        jitter=2.0, seed=21, n_beads_per_tile=120, n_channels=2,
    )
    sd = SpimData.load(proj.xml_path)
    store = InterestPointStore.for_project(sd)
    for v in sorted(sd.registrations):
        ch = sd.setups[v.setup].attributes["channel"]
        local = proj.bead_positions[ch::2] - proj.true_offsets[v.setup]
        size = np.array(sd.view_size(v), float)
        pts = local[np.all((local >= 1) & (local <= size - 2), axis=1)]
        register_points_in_xml(sd, v, "beads", "synthetic",
                               store.save_points(v, "beads", pts))
    sd.save(proj.xml_path)
    return proj


@pytest.mark.parametrize("grouping", ["group_channels", "group_tiles",
                                      "split_timepoints"])
def test_groups_equal_jax(two_channel, grouping):
    jsd = JSpimData.load(two_channel.xml_path)
    tsd = SpimData.load(two_channel.xml_path)
    kw = {grouping: True}
    if grouping == "split_timepoints":
        kw["registration_tp"] = "ALL_TO_ALL"
    jg = JM.build_match_groups(jsd, sorted(jsd.registrations),
                               JM.MatchingParams(**kw))
    tg = TM.build_match_groups(tsd, sorted(tsd.registrations),
                               TM.MatchingParams(**kw))
    assert [[_key(v) for v in g] for g in tg] == [[_key(v) for v in g]
                                                  for g in jg]
    jp = JM.plan_group_pairs(jsd, jg, JM.MatchingParams(**kw))
    tp = TM.plan_group_pairs(tsd, tg, TM.MatchingParams(**kw))
    assert ([[[_key(v) for v in g] for g in p] for p in tp]
            == [[[_key(v) for v in g] for g in p] for p in jp])


def test_split_timepoints_individual_policy_warns(two_channel):
    sd = SpimData.load(two_channel.xml_path)
    params = TM.MatchingParams(split_timepoints=True)
    groups = TM.build_match_groups(sd, sorted(sd.registrations), params)
    groups = [groups[0], tuple(ViewId(v.timepoint + 1, v.setup)
                               for v in groups[0])]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert TM.plan_group_pairs(sd, groups, params) == []
    assert any("splitTimepoints" in str(x.message) for x in w)


def test_group_channels_matches_equal_jax(two_channel):
    kw = dict(group_channels=True, method="PRECISE_TRANSLATION",
              interest_points_for_overlap_only=True, **FAST)
    jsd = JSpimData.load(two_channel.xml_path)
    jres = JM.match_interest_points(jsd, sorted(jsd.registrations),
                                    JM.MatchingParams(**kw),
                                    JStore.for_project(jsd), progress=False)
    tsd = SpimData.load(two_channel.xml_path)
    tres = TM.match_interest_points(tsd, sorted(tsd.registrations),
                                    TM.MatchingParams(**kw),
                                    InterestPointStore.for_project(tsd),
                                    progress=False, device=CPU)
    assert tres and _links(tres) == _links(jres)
    channels = {tsd.setups[r.view_a.setup].attributes["channel"]
                for r in tres}
    assert channels == {0, 1}


def test_merge_min_distance_equal_jax():
    pts = np.array([[0.0, 0.0, 0.0], [50.0, 0.0, 0.0],
                    [0.2, 0.1, 0.0], [80.0, 0.0, 0.0],
                    [50.1, 0.0, 0.1], [0.1, 0.0, 0.1]])
    view_of = np.array([0, 0, 1, 1, 2, 2])
    keep = TM.merge_min_distance(view_of, pts, 5.0)
    assert keep.tolist() == [True, True, False, True, False, False]
    assert TM.merge_min_distance(view_of, pts, 0.0).all()
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 100, (600, 3))
    view_of = rng.integers(0, 4, 600)
    for radius in (2.0, 6.0):
        assert np.array_equal(TM.merge_min_distance(view_of, pts, radius),
                              JM.merge_min_distance(view_of, pts, radius))


def test_search_radius_equal_jax():
    rng = np.random.default_rng(12)
    a = rng.uniform(0, 200, (50, 3))
    b = a + np.array([40.0, 0.0, 0.0]) + rng.normal(0, 0.1, a.shape)
    base = dict(method="PRECISE_TRANSLATION", model="TRANSLATION",
                regularization="NONE", ransac_min_inliers=5,
                ransac_iterations=1000)
    for radius in (None, 10.0, 50.0):
        jp, _, jn = JM.match_pair(a, b, JM.MatchingParams(
            search_radius=radius, **base))
        tp, _, tn = TM.match_pair(a, b, TM.MatchingParams(
            search_radius=radius, **base), device=CPU)
        assert np.array_equal(tp, jp) and tn == jn
        assert (len(tp) == 0) == (radius == 10.0)


def test_match_pair_icp_and_multi_consensus_equal_jax():
    rng = np.random.default_rng(9)
    a = np.concatenate([rng.uniform(0, 200, (40, 3)),
                        rng.uniform(400, 600, (40, 3))])
    b = np.concatenate([a[:40] + np.array([4.0, -3.0, 2.0]),
                        a[40:] + np.array([-15.0, 9.0, -5.0])])
    multi = dict(method="PRECISE_TRANSLATION", model="TRANSLATION",
                 regularization="NONE", ransac_min_inliers=10,
                 ransac_iterations=2000, ransac_multi_consensus=True)
    jp, _, _ = JM.match_pair(a, b, JM.MatchingParams(**multi))
    tp, model, _ = TM.match_pair(a, b, TM.MatchingParams(**multi), device=CPU)
    assert np.array_equal(tp, jp)
    assert (tp[:, 0] < 40).sum() > 20 and (tp[:, 0] >= 40).sum() > 20
    c = a[:40] + rng.normal(0, 0.05, (40, 3))
    icp = dict(method="ICP", model="TRANSLATION", regularization="NONE",
               icp_max_distance=3.0)
    jp, jm, jn = JM.match_pair(a[:40], c + 1.0, JM.MatchingParams(**icp))
    tp, tm, tn = TM.match_pair(a[:40], c + 1.0, TM.MatchingParams(**icp),
                               device=CPU)
    assert np.array_equal(tp, jp) and tn == jn
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-9)


def test_label_pairs_equal_jax():
    for kw in (dict(), dict(labels=("nuclei",)),
               dict(labels=("nuclei", "beads"), match_across_labels=True)):
        assert (TM.MatchingParams(**kw).label_pairs()
                == JM.MatchingParams(**kw).label_pairs())
        assert (TM.MatchingParams(**kw).all_labels
                == JM.MatchingParams(**kw).all_labels)


def test_refusals():
    with pytest.raises(ValueError, match="single label"):
        TM.match_interest_points(None, [], TM.MatchingParams(
            group_tiles=True, labels=("nuclei",)), store=object(), device=CPU)
    with pytest.raises(NotYetPorted, match="ROADMAP.md"):
        TM.match_interest_points(None, [], devices=2, device=CPU)
    with pytest.raises(NotYetPorted, match="ROADMAP.md"):
        torch_main(["match-interestpoints", "-x", "unused.xml", "--trace"])
