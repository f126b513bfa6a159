#!/usr/bin/env python3
"""K16 (``ops.dog.dog_extrema``'s kernel) at 8a's bucket under launch plans
other than ``extrema_plan``'s, beside the elementwise calls that move the
same bytes, on one GPU.

    python3 scripts/dog_extrema_sweep.py [--root TREE] [--beads N]
        [--tiles 16,14,12,10] [--chunks 13,18,22]

Builds the bucket as ``chip_smoke.dog_yardsticks`` does (2 x 528 x 528 x
144 float32 blurs by K15 of 100 + N(0, 3) with ``--beads`` point beads of
5,000 a block; 0 beads leaves the min / max scaling of noise, which puts
~18 % of the voxels past the threshold), then for each y tile (rows) and
x chunk count launches the kernel directly with that plan (whole z rows,
float4 loads), checks dog and the candidate counts against the wrapper's
run, and prints its card time (CUDA events around 20 launches, the median
of 3 rounds after a spin). Then ``torch.sub(b1, b2)`` (the same 12 B a
voxel without the stencil), a copy and a sum of b1, and the wrapper
itself. Prints the card (nvidia-smi name and power limit) first; exits 2
without a card.
"""

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--beads", type=int, default=450)
    ap.add_argument("--tiles", default="16,14,12,10")
    ap.add_argument("--chunks", default="13,18,22")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from bigstitcher_spark_tpu_torch.ops import _cuda
    from bigstitcher_spark_tpu_torch.ops import dog as G
    from bigstitcher_spark_tpu_torch.ops.fusion import _stream

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    B, X, Y, Z = shape = (2, 528, 528, 144)
    g = torch.Generator(device=dev)
    g.manual_seed(1616)
    x = 100.0 + 3.0 * torch.randn(shape, generator=g, device=dev)
    at = torch.randint(0, x[0].numel(), (B, args.beads), generator=g,
                       device=dev)
    x.view(B, -1).scatter_add_(1, at, torch.full((B, args.beads), 5000.0,
                                                 device=dev))
    b1, b2 = G._blurs(G.KERNELS, x, 1.8)
    sc = G.dog_scale(x.amin((1, 2, 3)), x.amax((1, 2, 3)))
    del x
    thr = torch.full((B,), 0.008, device=dev)
    org = torch.tensor([[0, 0, 0], [512, -9, 120]], dtype=torch.int32,
                       device=dev)
    past = int(((b1 - b2) * sc.view(B, 1, 1, 1) > 0.008).sum())
    print(f"{args.beads} beads a block, {past} voxels past the threshold",
          flush=True)
    lib = _cuda.load("dog")
    dog = torch.empty_like(b1)
    ci = torch.empty((B, X * Y * Z), dtype=torch.int32, device=dev)
    cs = torch.empty((B, X * Y * Z), dtype=torch.float32, device=dev)
    cnt = torch.zeros(B, dtype=torch.int32, device=dev)
    ref = G.dog_extrema(b1, b2, sc, thr, org, True, False, 0, True)

    def card_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(3):
            torch.cuda._sleep(2_000_000)
            s, e = torch.cuda.Event(True), torch.cuda.Event(True)
            s.record()
            for _ in range(reps):
                fn()
            e.record()
            torch.cuda.synchronize()
            out.append(s.elapsed_time(e) / reps)
        return sorted(out)[1]

    for ty in (int(v) for v in args.tiles.split(",")):
        for chunks in (int(v) for v in args.chunks.split(",")):
            xc = -(-X // chunks)

            def run():
                cnt.zero_()
                ret = lib.bst_dog_extrema(
                    b1.data_ptr(), b2.data_ptr(), B, X, Y, Z, sc.data_ptr(),
                    thr.data_ptr(), org.data_ptr(), 1, 0, 0, 1, ty, Z, xc,
                    dog.data_ptr(), None, ci.data_ptr(), cs.data_ptr(),
                    cnt.data_ptr(), _stream(dev))
                _cuda.check(lib, ret, "dog_extrema")

            run()
            torch.cuda.synchronize()
            ok = torch.equal(dog, ref[0]) and torch.equal(cnt, ref[3])
            blocks = -(-Y // ty) * B * -(-X // xc)
            print(f"tile {ty:2d} rows, chunks of {xc:3d} planes, {blocks:5d} "
                  f"blocks: {card_ms(run):.4f} ms  dog and counts the "
                  f"wrapper's: {ok}", flush=True)
    n = b1.numel()
    out = torch.empty_like(b1)
    hbm = 3.35e12
    for name, fn, nbytes in (
            ("torch.sub(b1, b2)", lambda: torch.sub(b1, b2, out=out), 12 * n),
            ("copy of b1", lambda: out.copy_(b1), 8 * n),
            ("sum of b1", lambda: b1.sum(), 4 * n),
            ("the wrapper (extrema_plan)",
             lambda: G.dog_extrema(b1, b2, sc, thr, org, True, False, 0,
                                   True), 12 * n)):
        print(f"{name}: {card_ms(fn):.4f} ms  bound "
              f"{nbytes / hbm * 1e3:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
