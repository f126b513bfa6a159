#!/usr/bin/env python3
"""K8 (FFT), K24 (CG product), K29 (shard sum) and K17 (DoG top-k) beside
their library yardsticks, and K20 (ratio test), K15 (blur pass), K16 (DoG
extrema), K3 (gather), K26 (nonrigid), K1 (composite), K12 (relax fits),
K21 (RANSAC scores), K22 (refits), K6 (downsampling), K2 (shift), K5
(separable), K28 (block epilogue), K19 (kNN descriptors), K10 (PCM peaks)
and K24's partial form beside their bounds, and phase 10's walls, on one
GPU.

    python3 scripts/kernel_yardsticks.py [--root TREE] [--scale full|tiny]
        [--buckets B,X,Y,Z;...] [--lanes G,G,...]
        [--only fft|cg|ratio|blur|gather|nonrigid|composite|fit|ransac|
                downsample|blocks|intensity|shard|loops|knn|dog|peaks|
                topk[,...]]
        [--sigmas S,S,...] [--outputs DIR] [--build-times LIB,LIB,...]

Imports the port from ``--root`` (default: the checkout this script lives
in), so that two trees, e.g. a parent commit unpacked with ``git archive``
into a gitignored directory and this checkout, can be timed on one card
in one call, in turns (parent, change, change, parent). Each tree builds
its own ``fft`` and ``cg`` libraries. The timing and the checks are
``chip_smoke.py``'s (of this checkout):

- ``pcm_times`` at phase 1's stitching bucket (2, 64, 512, 128), or at
  each of ``--buckets``: K8's rfftn / irfftn held against torch.fft (2e-5
  x max|X| per pair), its round trip, its six passes and torch.fft's
  rfftn + irfftn, each timed back to back (K7, K9 and K10 come along);
- ``cg_times`` at phase 10b's large system (7c's 16x16x2 view grid at
  8x8x8 cells: 524,288 unknowns): one K24 + K25 step held against the
  twins (rtol 1e-12), then K24 and torch.mv on the CSR matrix with
  K24's int32 indices, each one launch after a reset and back to back,
  and with ``--lanes`` K24 launched directly at each lane count; with
  ``--outputs DIR`` one K24 launch's p_new, Ap and p.Ap saved or compared
  bitwise;
- ``ratio_times`` at 9b's shape (K19's descriptors of the nucleus-scale
  pair: 400,000 x 400,000 of 9, owners in runs of 4): K20 bitwise against
  its twin on the first 4,096 rows and the last 2,048 (ratio and nearest
  mode), then its card time, its time with the host's, the pairs its
  filter refined and B's mean alone (trees that have them);
- ``blur_times`` at 8a's bucket (2 x 528 x 528 x 144 float32): K15's six
  passes each bitwise against its twin and timed alone, and together, at
  sigma 1.8 (the reference's default: radii 6 and 7) or at each of
  ``--sigmas`` (e.g. 3.0: radii 9 and 11, taken at run time);
- ``resample_yardsticks``: ``gather`` is K3 at phase 1's shape (a
  256x256x64 block of 4 uint16 views of 288x288x96, rotated about z: the
  separable form), at the same shape rotated about y (the general form)
  and K3 with coefficients at 10c's tile-corner block (its 4 translated
  views' geometry, 8x8x8 grids), ``nonrigid`` K26 at phase 11's block (4
  views, 29x29x10 vertex grids at -cpd 10); each against its twin, in
  card time, with the host's time and at each fusion type. With
  ``--outputs DIR`` the outputs are saved in DIR, or, where an earlier
  run (another tree) saved them, compared with them bitwise: run parent,
  change, change, parent with one DIR;
- ``composite_yardsticks``: ``composite`` is K1 at route A's geometry
  (synthetic tiles from a seed: 2x2x1 uint16 tiles of 1024x1024x128, 102
  px overlap, sub-pixel translations) at each fusion type, with masks,
  with uint8 and float32 output, with 10c's 8x8x8 coefficient grids and on
  "sep" (diagonal) views: card time, time with the host's (the wrapper),
  the device memory peak of one wrapper call and the output's digest; with
  ``--outputs DIR`` the digests and a corner of each output are saved or
  compared bitwise;
- ``fit_yardsticks``: ``fit`` is K12 on moments made from a seed at T =
  512 (7c's tiles) and 4,096 (7b's) for six (model, regulariser) pairs,
  tiles with sw <= 0, fixed tiles and reflections among them: card time,
  time with the host's, bound; with ``--outputs DIR`` the models are saved
  or compared bitwise; then K12's sharded form on 4 partials at T = 512
  (a tree without it: K29 then K12; the models held bitwise across trees,
  and on a tree with it K29 + K12 timed beside it);
- ``ransac_yardsticks``: ``ransac`` is K21 at 9b's shape (10,000
  hypotheses of 4 pairs against 58,274 candidates, 9b's outlier share, an
  AFFINE fit), at 9a's (155 candidates) and at 9b's with sample 1
  (TRANSLATION) and 3 (RIGID): each held bitwise against its twin, card
  time, time with the host's, bound; with ``--outputs DIR`` counts,
  models, best and best model saved or compared bitwise; then K22 at each
  yard from K21's best model there, its fit and the mask alone (fit=False)
  each against its twin and timed; with ``--outputs DIR`` masks and counts
  held bitwise across trees, models within rtol 1e-9 / atol 1e-9 across
  trees and bitwise between one tree's runs;
- ``dog_yardsticks``: ``dog`` is K16 at 8a's bucket (2 x 528 x 528 x 144:
  K15's blurs of seeded point beads on noise), its candidates form and
  its dense mask form, each bitwise against its twin (candidate lists as
  sets), card time, time with the host's, bound; with ``--outputs DIR``
  dog, the sorted candidate lists, counts and the mask held bitwise;
- ``peaks_yardsticks``: ``peaks`` is K10 at phase 1's bucket (2 x 64 x
  512 x 128) at n = 5 and 256 and with one maximum a pair (the -inf fill)
  at n = 5, and at phase 6's largest bucket at n = 5, on the twins' PCM of
  seeded crops: each bitwise its twin's, card time, time with the host's,
  bound; with ``--outputs DIR`` the peaks saved or compared bitwise. On a
  tree whose K10 is the two-pass form (a candidate kernel, then a merge
  kernel) each pass is also timed alone at phase 1's bucket: the tree's
  ``csrc/pcm.cu`` is built again with two launchers added, one a pass;
- ``topk_yardsticks``: ``topk`` is K17 at 8a's bucket (2 blocks of 528 x
  528 x 144, k 4,096) on seeded candidate lists, 430 / 431 candidates
  (8a's) and 50,000 a block (truncated): each bitwise its twin's and
  holding torch.topk's index sets, card time, time with the host's, the
  twin, torch.topk on the dense score and on the list's scores, bound;
  with ``--outputs DIR`` indices and flags saved or compared bitwise;
- ``downsample_yardsticks``: ``downsample`` is K6's level form at route
  A's first pyramid step (1952x1952x132 uint16), its batch form at the
  downsample stage's boxes (4 x 256x256x128 / (2,2,2)) and at route D's
  (4 x 256x256x45 / (2,2,1)), its one-axis form along each axis of a
  route-A tile: each bitwise against its twin, card time, time with the
  host's, avg_pool3d's time, bound; with ``--outputs DIR`` saved or
  compared bitwise (digests and the first 65,536 values);
- ``block_yardsticks``: ``blocks`` is K2 and K5 per block at phase 1's
  shapes (256x256x64 blocks of 4 uint16 views), card time, time with the
  host's, bound; on a tree that has them also their batch forms at 16
  rows (each row bitwise the per-block kernel's) and K28 on K2's batch
  output with level (2,2,2) (bitwise its twin's); with ``--outputs DIR``
  K2's and K5's outputs at each fusion type (K5's also at each patch
  dtype: uint8, uint16, int16, float32), both batches and K28's saved or
  compared bitwise;
- ``knn_yardsticks``: ``knn`` is K19 at 9b's cloud (100,000 points, -n 3
  -r 1, rotation invariant; bitwise its twin on the first 4,096 and last
  2,048 rows) and its masked form at 8d's bucket (2 blocks of 4,096
  slots, 431 and 430 valid; bitwise its twin), card time, time with the
  host's, bound and the issue floor at one operation an instruction;
  with ``--outputs DIR`` indices, descriptors and flags saved or compared
  bitwise;
- ``shard``: on a tree that has it, K29 (``ops.shard.shard_sum``) at
  phase 15a's moments (4 shards of 512 x 36 float64) and at 15b's vectors
  (4 shards of 524,288, the replicated part, p.Ap), each bitwise its twin
  (the dot within rtol 1e-12), beside ``torch.stack(...).sum(0)`` (+
  ``torch.dot``), K24's partial form on shard 0 of phase 10b's large
  system split 4 ways, against its twin, and K14's sharded form on 4
  shards of 512 tiles (a tree without it: K29 then K14; 60 launches'
  history and state held bitwise across trees, and on a tree with it K29
  + K14 timed beside it);
- ``loops``: the solve loops, which the host's launch time bounds: 7c's
  relaxation (its IP grid written and its links assembled as the solver
  does, AFFINE + RIGID, lambda 0.1) through ``solver.relax``, its wall and
  its relax seconds a run, on one device and sharded on ``[card] * 4``
  (phase 15a), one sweep of each alone in card time, and
  ``ops.solve.relax_on_device`` capped at 100 iterations (7c's
  "ms/iteration" line) and at 1 (a call's fixed cost), and the CG loop of
  phase 10b's large system through ``ops.solve.cg_on_device``: each
  repeated 5 times, with the host's seconds and ms per iteration; with
  ``--outputs DIR`` the 7c relaxation's models, history and link errors
  (the sharded ones bitwise the one-device ones) held bitwise across
  trees;
- ``intensity``: ``chip_smoke.py``'s phase 10 (10a, 10b, 10c with their
  gates) through the CLI, after every library of the tree is built, so
  that no build lands in a timed window; prints each route's wall split.

``--build-times`` builds the named libraries (``csrc/<name>.cu``) one at
a time before anything else and prints each ``nvcc``'s seconds (a
library the tree had built already is not rebuilt).

Prints the card (nvidia-smi name and power limit), then one JSON line
``{"root": ..., "kernels": {name: {...}}}``. Exits 2 without a card; with
``--device cpu`` it rehearses the checks on the twins and prints no JSON.
"""

import argparse
import importlib.util
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the tree whose bigstitcher_spark_tpu_torch is timed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", choices=("full", "tiny"), default="full")
    ap.add_argument("--buckets", default=None,
                    help="K8's buckets, B,X,Y,Z;B,X,Y,Z;... (default: phase "
                         "1's)")
    ap.add_argument("--lanes", default="",
                    help="K24 also launched with these lanes a row, e.g. "
                         "1,4,8,16")
    ap.add_argument("--only", default=None,
                    help="comma-separated: fft, cg, ratio, blur, gather, "
                         "nonrigid, composite, fit, ransac, downsample, "
                         "blocks, intensity, shard, loops, knn, dog, peaks, "
                         "topk (default fft,cg)")
    ap.add_argument("--sigmas", default="1.8",
                    help="K15's blur sigmas, S,S,... (default 1.8)")
    ap.add_argument("--outputs", default=None,
                    help="K3's, K26's, K1's, K12's, K21's, K22's, K6's, "
                         "K24's, K2's, K5's, K28's, K19's, K14's, K16's, "
                         "K10's and K17's outputs "
                         "saved here, or "
                         "compared bitwise with those an earlier run saved "
                         "here")
    ap.add_argument("--build-times", default="",
                    help="build these libraries one at a time first and "
                         "print each nvcc's seconds, e.g. gather,nonrigid")
    args = ap.parse_args(argv)
    only = tuple(args.only.split(",")) if args.only else ("fft", "cg")
    kinds = ("fft", "cg", "ratio", "blur", "gather", "nonrigid", "composite",
             "fit", "ransac", "downsample", "blocks", "intensity", "shard",
             "loops", "knn", "dog", "peaks", "topk")
    if any(k not in kinds for k in only):
        ap.error(f"--only takes {', '.join(kinds)}")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)

    import numpy as np
    import torch

    import bigstitcher_spark_tpu_torch as port
    from bigstitcher_spark_tpu_torch.ops import descriptors as DS
    from bigstitcher_spark_tpu_torch.ops import intensity as OI
    from bigstitcher_spark_tpu_torch.ops import solve as R

    if os.path.dirname(os.path.dirname(os.path.abspath(port.__file__))) != root:
        print(f"error: the port came from {port.__file__}, not {root}",
              file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    card = CS.card_line() if dev.type == "cuda" else "cpu"
    print(f"card {card}; port from {root}", flush=True)
    cfg = CS.SCALES[args.scale]
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    buckets = ([tuple(int(v) for v in b.split(","))
                for b in args.buckets.split(";")] if args.buckets
               else [cfg["pcm_bucket"]])
    lanes = tuple(int(g) for g in args.lanes.split(",") if g)
    out = {}
    if dev.type == "cuda" and args.build_times:
        from bigstitcher_spark_tpu_torch.ops import _cuda

        out["nvcc_s"] = {}
        for name in args.build_times.split(","):
            took = _cuda.build_all((name,))[name]
            out["nvcc_s"][name] = took
            print(f"  nvcc {name}.cu alone: " + (
                f"{took:.1f} s" if took else "built before this run"),
                flush=True)
    try:
        if "intensity" in only:
            out["phase 10"] = phase10(root, args.scale, dev, card, CS)
        if "composite" in only:
            out.update(CS.composite_yardsticks(dev, card, args.outputs,
                                               args.scale))
        if "fit" in only:
            out.update(CS.fit_yardsticks(dev, card, args.outputs,
                                         args.scale))
        if "ransac" in only:
            out.update(CS.ransac_yardsticks(dev, card, args.outputs,
                                            args.scale))
        if "downsample" in only:
            out.update(CS.downsample_yardsticks(dev, card, args.outputs,
                                                args.scale))
        if "blocks" in only:
            out.update(CS.block_yardsticks(dev, card, args.scale,
                                           args.outputs))
        if "knn" in only:
            out.update(CS.knn_yardsticks(dev, card, args.outputs,
                                         args.scale))
        if "dog" in only:
            out.update(CS.dog_yardsticks(dev, card, args.outputs,
                                         args.scale))
        if "peaks" in only:
            out.update(CS.peaks_yardsticks(dev, card, args.outputs,
                                           args.scale))
            if dev.type == "cuda":
                out.update(two_pass_times(root, cfg["pcm_bucket"], card, CS))
        if "topk" in only:
            out.update(CS.topk_yardsticks(dev, card, args.outputs,
                                          args.scale))
        if "gather" in only or "nonrigid" in only:
            out.update(CS.resample_yardsticks(only, dev, card, args.outputs,
                                              args.scale))
        if "blur" in only:
            shape = (2, 528, 528, 144) if args.scale == "full" else (
                2, 40, 36, 20)
            x = c(np.random.default_rng(2024).normal(
                100.0, 10.0, shape).astype(np.float32))
            for s in (float(v) for v in args.sigmas.split(",")):
                out["dog_blur" if s == 1.8 else f"dog_blur sigma {s}"] = \
                    CS.blur_times(x, s, card)
        if "ratio" in only:
            wa, wb = CS.make_clouds(args.scale)[:2]
            pa, pb = (c(w.astype(np.float32))[None] for w in (wa, wb))
            da = DS.knn_descriptors(pa, None, 3, 1, True)[1].reshape(-1, 9)
            db = DS.knn_descriptors(pb, None, 3, 1, True)[1].reshape(-1, 9)
            ob = torch.arange(len(wb), dtype=torch.int32,
                              device=dev).repeat_interleave(4)
            Da = len(da)
            rows = (slice(0, min(4096, Da)), slice(max(0, Da - 2048), Da))
            out["ratio_match"] = CS.ratio_times(da, db, ob, card, rows)
        for bucket in buckets if "fft" in only else ():
            res = CS.pcm_times(np.random.default_rng(2024), c, bucket)
            name = "fft_pow2 " + ",".join(map(str, bucket))
            CS.print_times(name, res["fft_pow2"], card)
            print(f"  {name} passes: " + ", ".join(
                f"{k} {v} ms" for k, v in res["fft_pow2"]["passes_ms"].items()),
                flush=True)
            out[name] = res["fft_pow2"]
        if "cg" in only:
            C, matches, smooth = CS.large_intensity_system(cfg["ip_grid"])
            sysm = R.assemble_cg(
                C, *OI.intensity_system(C, matches, 0.1, smooth), dev)
            res = CS.cg_times(sysm, card, lanes)
            if dev.type == "cuda":
                CS.hold_outputs(args.outputs, "cg_spmv", cg_step(sysm, dev, R),
                                res["cg_spmv"])
                print(f"  cg_spmv vs the saved run: bitwise "
                      f"{res['cg_spmv'].get('bitwise_vs_saved')}", flush=True)
            out.update({k: res[k] for k in ("cg_spmv", "cg_update")})
        if "shard" in only:
            out.update(shard_yardsticks(dev, card, cfg, CS, R, OI,
                                        args.outputs))
        if "loops" in only:
            out["loops"] = loop_times(root, args.scale, dev, card, CS, R, OI,
                                      outputs=args.outputs)
    except CS.SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    if dev.type != "cuda":
        print("rehearsal finished; no result on the CPU", file=sys.stderr)
        return 3
    print(card)
    print(json.dumps({"root": root, "kernels": out}))
    return 0


def cg_step(sysm, dev, R):
    """One launch of K24's full form on seeded inputs: (p_new, Ap, the
    state with p.Ap), for ``--outputs``."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(24)
    f64 = dict(dtype=torch.float64, device=dev)
    r, p_old = (torch.randn(sysm.n, generator=g, **f64) for _ in range(2))
    d, i = R.cg_state(sysm, dev)
    d[1] = 0.625
    p_new, ap = torch.empty(sysm.n, **f64), torch.empty(sysm.n, **f64)
    R.cg_spmv(sysm, r, p_old, p_new, ap, d, i)
    return p_new, ap, d


# launchers of each pass of the two-pass K10 alone (appended to that
# form's csrc/pcm.cu, whose kernels they launch as its launcher does)
_TWO_PASS = r'''
extern "C" int bst_k10_pass1(const float* pcm, int B, int X, int Y, int Z,
                             int n_peaks, int tiles, uint64_t* cand,
                             void* stream) {
  topk_candidates_kernel<<<dim3(tiles, B), bst::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      pcm, X, Y, Z, n_peaks, tiles, cand);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int bst_k10_pass2(const uint64_t* cand, int B, int n_peaks,
                             int tiles, int Y, int Z, int* out,
                             void* stream) {
  topk_merge_kernel<<<B, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      cand, static_cast<int64_t>(tiles) * n_peaks, n_peaks, Y, Z, out);
  return static_cast<int>(cudaGetLastError());
}
'''


def two_pass_times(root, bucket, card, CS):
    """On a tree whose K10 is the two-pass form (``topk_merge_kernel`` in
    its csrc/pcm.cu): each pass alone at ``bucket``, n = 5 and 256, in card
    time, on the twins' PCM of :func:`chip_smoke.pcm_crops`' stacks; the
    pair's outputs checked against the twin's. Built from the tree's
    source with the two launchers of ``_TWO_PASS`` added, by its own nvcc
    flags, in ``smoke_work/`` of the tree (removed after). {} on other
    trees."""
    import ctypes
    import subprocess

    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import _cuda
    from bigstitcher_spark_tpu_torch.ops import phasecorr as P

    with open(os.path.join(_cuda.CSRC, "pcm.cu")) as f:
        src = f.read()
    if "topk_merge_kernel" not in src:
        return {}
    work = os.path.join(root, "smoke_work", "k10_passes")
    os.makedirs(work, exist_ok=True)
    try:
        cu = os.path.join(work, "pcm_passes.cu")
        with open(cu, "w") as f:
            f.write(src + _TWO_PASS)
        so = os.path.join(work, "libpcm_passes.so")
        subprocess.run([_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-I", _cuda.CSRC,
                        "-o", so, cu], check=True, capture_output=True)
        lib = ctypes.CDLL(so)
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.bst_k10_pass1.argtypes = [vp] + [i] * 6 + [vp, vp]
        lib.bst_k10_pass2.argtypes = [vp] + [i] * 5 + [vp, vp]
        dev = torch.device("cuda", 0)
        c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        a, b, ext = CS.pcm_crops(np.random.default_rng(2024), c, bucket)
        pcm = P.pcm_peaks_plain(a, b, ext, ext, 5, return_pcm=True)[1]
        pcm = pcm.contiguous()
        B, X, Y, Z = bucket
        tiles = -(-(X * Y * Z) // 2048)
        stream = torch.cuda.current_stream(dev).cuda_stream
        out = {}
        for n in (5, 256):
            cand = torch.empty((B, tiles, n), dtype=torch.int64, device=dev)
            res = torch.empty((B, n, 3), dtype=torch.int32, device=dev)
            one = lambda n=n, cand=cand: lib.bst_k10_pass1(
                pcm.data_ptr(), B, X, Y, Z, n, tiles, cand.data_ptr(), stream)
            two = lambda n=n, cand=cand, res=res: lib.bst_k10_pass2(
                cand.data_ptr(), B, n, tiles, Y, Z, res.data_ptr(), stream)
            one()
            two()
            CS.check(torch.equal(res, P.pcm_peaks_topk_plain(pcm, n)),
                     f"two-pass K10 at {bucket}, n {n}, pass by pass: "
                     "indices equal to the twin's")
            r = dict(pass1_ms=CS.time_ms(one), pass2_ms=CS.time_ms(two),
                     both_ms=CS.time_ms(lambda: (one(), two())))
            print(f"  pcm_peaks_topk two-pass form at {bucket} n {n} "
                  f"[{card}]: pass 1 {r['pass1_ms']} ms  pass 2 "
                  f"{r['pass2_ms']} ms  both {r['both_ms']} ms", flush=True)
            out[f"pcm_peaks_topk passes n {n}"] = r
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def shard_yardsticks(dev, card, cfg, CS, R, OI, outputs=None):
    """K29 at phase 15's two shapes, K24's partial form at 15b's shard and
    K14's sharded form (module docstring); nothing on a tree without
    them."""
    import importlib.util

    import torch

    if importlib.util.find_spec("bigstitcher_spark_tpu_torch.ops.shard") \
            is None:
        print("  no shard sum in this tree", flush=True)
        return {}
    g = torch.Generator(device=dev)
    g.manual_seed(15)
    f64 = dict(dtype=torch.float64, device=dev)
    S = CS.SOLVE_SHARDS
    mom = [torch.randn((512, 36), generator=g, **f64) for _ in range(S)]
    out = {"shard_sum": CS.shard_sum_times(mom, None, None,
                                           f"15a's moments ({S} x 512 x 36)",
                                           card)}
    C, matches, smooth = CS.large_intensity_system(cfg["ip_grid"])
    sysm = R.assemble_cg(C, *OI.intensity_system(C, matches, 0.1, smooth),
                         dev, n_shards=S)
    n = sysm.n
    vec = [torch.randn(n, generator=g, **f64) for _ in range(S + 2)]
    out["shard_sum at 15b"] = CS.shard_sum_times(
        vec[:S], vec[S], vec[S + 1], f"15b's vectors ({S} x {n}, rep, dot)",
        card)
    out["cg_spmv_partial"] = CS.cg_partial_times(sysm, card)
    out.update(CS.sharded_converge_yard(dev, card, outputs))
    return out


def loop_times(root, scale, dev, card, CS, R, OI, reps=5, outputs=None):
    """The relax and CG loops (module docstring): host seconds of each of
    ``reps`` runs, their median and ms per iteration; with ``outputs`` the
    7c relaxation's result (models, history, link errors), on one device
    and sharded, saved or held bitwise across trees."""
    import dataclasses

    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.io.interestpoints import (
        InterestPointStore)
    from bigstitcher_spark_tpu_torch.io.spimdata import SpimData
    from bigstitcher_spark_tpu_torch.models import solver as S
    from bigstitcher_spark_tpu_torch.ops import models as M
    from bigstitcher_spark_tpu_torch.utils.solverdata import make_ip_grid

    cfg = CS.SCALES[scale]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    work = os.path.join(root, "smoke_work")
    try:
        ip = make_ip_grid(os.path.join(work, "ip"), grid=cfg["ip_grid"],
                          tile=cfg["solve_tile"],
                          n_per_pair=cfg["ip_pairs"], seed=43)
        sd = SpimData.load(ip.xml_path)
        params = S.SolverParams(source="IP", model=M.AFFINE,
                                regularization=M.RIGID, lam=0.1,
                                backend="device", device=str(dev),
                                labels=["beads"])
        tiles = S.build_tiles(sd, sd.view_ids(), params)
        links = S.matches_from_interest_points(
            sd, tiles, InterestPointStore.for_project(sd), ["beads"], [],
            verbose=False)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    fixed = S.pick_fixed(tiles, params)
    res = {}

    def runs(name, fn):
        walls, iters = [], None
        fn()
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            iters = fn()
            sync()
            walls.append(time.perf_counter() - t0)
        med = sorted(walls)[len(walls) // 2]
        res[name] = dict(walls_s=walls, median_s=med, iterations=iters,
                         ms_per_iteration=med / max(iters, 1) * 1e3)
        print(f"  [loops] {card}: {name}: {iters} iterations, median "
              f"{med:.4f} s -> {res[name]['ms_per_iteration']:.4f} "
              f"ms/iteration (host clock; runs "
              f"{', '.join(f'{w:.4f}' for w in walls)} s)", flush=True)

    relax_s, last = [], {}

    def result(r):
        """A relaxation's models, history and link errors as tensors."""
        return [torch.from_numpy(np.stack([r.corrections[k] for k in tiles])),
                torch.from_numpy(np.asarray(r.history)),
                torch.tensor([r.link_errors[k] for k in sorted(
                    r.link_errors, key=str)], dtype=torch.float64)]

    def relax():
        r = S.relax(links, tiles, fixed, params)
        relax_s.append(r.timings["relax"])
        last["one device"] = r
        return r.iterations

    runs("7c relax (solver.relax)", relax)
    relax_s = relax_s[1:]
    res["7c relax (solver.relax)"]["relax_timing_s"] = relax_s
    print(f"  [loops] 7c relax timings['relax']: "
          f"{', '.join(f'{v:.4f}' for v in relax_s)} s", flush=True)
    # 15a: the same relaxation sharded on [card] * 4
    sharded = dataclasses.replace(params, devices=[dev] * CS.SOLVE_SHARDS)
    relax4_s = []

    def relax4():
        r = S.relax(links, tiles, fixed, sharded)
        CS.check(r.shards == CS.SOLVE_SHARDS,
                 f"15a relax on {r.shards} shards")
        relax4_s.append(r.timings["relax"])
        last["sharded"] = r
        return r.iterations

    with CS.knobs({} if scale == "full" else {"BST_SOLVE_SHARD": "1"}):
        runs("15a relax sharded (solver.relax)", relax4)
        relax4_s = relax4_s[1:]
        res["15a relax sharded (solver.relax)"]["relax_timing_s"] = relax4_s
        print(f"  [loops] 15a relax timings['relax']: "
              f"{', '.join(f'{v:.4f}' for v in relax4_s)} s", flush=True)
        # one sweep alone of each (no state reads; the cap out of reach)
        sweep_ms = {}
        for name, p in (("7c one device", params), ("15a sharded", sharded)):
            calls, undo = CS.relax_spy()
            try:
                S.relax(links, tiles, fixed,
                        dataclasses.replace(p, max_iterations=1))
            finally:
                undo()
            (a, _k, _o), = calls
            a = list(a)
            a[7] = 10 ** 6
            run = R.RelaxRun(R.KERNELS, *a)
            sweep_ms[name] = CS.time_ms(run.sweep)
            if dev.type == "cuda":
                CS.check(not run.first.state.tolist()[2],
                         f"{name}: still iterating after the timed sweeps")
        res["sweep_ms"] = sweep_ms
        print(f"  [loops] {card}: card time a sweep: " + ", ".join(
            f"{k} {v} ms" for k, v in sweep_ms.items()), flush=True)
    one, four = (result(last[k]) for k in ("one device", "sharded"))
    CS.check(all(torch.equal(a, b) for a, b in zip(one, four)),
             "15a: the sharded relax's models, history and link errors "
             "bitwise the one-device relax's")
    held = {}
    CS.hold_outputs(outputs, "7c relax", one, held)
    res["bitwise_vs_saved"] = held.get("bitwise_vs_saved")
    print(f"  [loops] 7c relax ({last['one device'].iterations} iterations): "
          f"models, history and link errors vs the saved run: bitwise "
          f"{res['bitwise_vs_saved']}", flush=True)
    calls, undo = CS.relax_spy()
    try:
        S.relax(links, tiles, fixed,
                dataclasses.replace(params, max_iterations=100))
    finally:
        undo()
    (a100, _k, _o), = calls
    runs("7c relax_on_device, 100 iterations",
         lambda: R.relax_on_device(*a100).iterations)
    a1 = list(a100)
    a1[7] = 1
    runs("7c relax_on_device, 1 iteration",
         lambda: R.relax_on_device(*a1).iterations)
    C, matches, smooth = CS.large_intensity_system(cfg["ip_grid"])
    sysm = R.assemble_cg(C, *OI.intensity_system(C, matches, 0.1, smooth),
                         dev)
    card_s = []

    def cg():
        out = R.cg_on_device(sysm)
        card_s.append(out.card_seconds)
        return out.iterations

    runs("10b large cg_on_device", cg)
    card_s = card_s[1:]
    res["10b large cg_on_device"]["card_s"] = card_s
    print(f"  [loops] 10b large CG card seconds: "
          f"{', '.join(f'{v:.4f}' for v in card_s)} s", flush=True)
    res["card"] = card
    return res


def phase10(root, scale, dev, card, CS):
    """chip_smoke's phase 10 on the tree at ``root``, every library built
    first; returns its launches."""
    if dev.type == "cuda":
        from bigstitcher_spark_tpu_torch.ops import _cuda

        t0 = time.perf_counter()
        _cuda.build_all()
        print(f"  every library built in {time.perf_counter() - t0:.1f} s "
              "before phase 10", flush=True)
    work = os.path.join(root, "smoke_work")
    launches = {}
    try:
        CS.phase10_intensity(work, scale, dev, card, launches)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"launches": launches}


if __name__ == "__main__":
    sys.exit(main())
