#!/usr/bin/env python3
"""K8 (FFT) and K24 (CG product) beside their library yardsticks, and K20
(ratio test) and K15 (blur pass) beside their bounds, on one GPU.

    python3 scripts/kernel_yardsticks.py [--root TREE] [--scale full|tiny]
        [--buckets B,X,Y,Z;...] [--lanes G,G,...]
        [--only fft|cg|ratio|blur] [--sigmas S,S,...]

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
  and with ``--lanes`` K24 launched directly at each lane count;
- ``ratio_times`` at 9b's shape (K19's descriptors of the nucleus-scale
  pair: 400,000 x 400,000 of 9, owners in runs of 4): K20 bitwise against
  its twin on the first 4,096 rows and the last 2,048 (ratio and nearest
  mode), then its card time, its time with the host's, the pairs its
  filter refined and B's mean alone (trees that have them);
- ``blur_times`` at 8a's bucket (2 x 528 x 528 x 144 float32): K15's six
  passes each bitwise against its twin and timed alone, and together, at
  sigma 1.8 (the reference's default: radii 6 and 7) or at each of
  ``--sigmas`` (e.g. 3.0: radii 9 and 11, taken at run time).

Prints the card (nvidia-smi name and power limit), then one JSON line
``{"root": ..., "kernels": {name: {...}}}``. Exits 2 without a card; with
``--device cpu`` it rehearses the checks on the twins and prints no JSON.
"""

import argparse
import importlib.util
import json
import os
import sys

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
    ap.add_argument("--only", choices=("fft", "cg", "ratio", "blur"),
                    default=None)
    ap.add_argument("--sigmas", default="1.8",
                    help="K15's blur sigmas, S,S,... (default 1.8)")
    args = ap.parse_args(argv)
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
    only = (args.only,) if args.only else ("fft", "cg")
    try:
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
            out.update({k: res[k] for k in ("cg_spmv", "cg_update")})
    except CS.SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    if dev.type != "cuda":
        print("rehearsal finished; no result on the CPU", file=sys.stderr)
        return 3
    print(card)
    print(json.dumps({"root": root, "kernels": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
