#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phase 0  prints the card (nvidia-smi name, power limit) and builds the
         kernels from csrc/ (one nvcc per source, all eight at once).
Phase 1  holds each kernel against its plain-torch twin on the card and
         times both with CUDA events: K2 shift, K3 gather, K4 convert, K1
         composite and K5 separable at the per-block routes' compute block
         (256x256x64, 4 views; K5 on 288x288x128 patches with route D's
         diagonal (1,1,3), one view mirrored on x and one at (1,1,1/3));
         K6 downsample at route A's first pyramid step (1952x1952x132
         uint16 -> 976x976x66) and on a batch of the downsample stage (4 x
         256x256x128 uint16 boxes), beside torch's avg_pool3d on the same
         float32 input as the library yardstick; K6 also at route D's stage
         batch (4 x 256x256x45 uint16, factors 2,2,1: z takes the f == 1
         path), bitwise. The phase-correlation kernels at route A's x-edge
         bucket at -ds 2,2,1 (2 pairs of 64x512x128 uint16 crops): K7
         window and K9 cross power (rtol 1e-5 / atol 1e-6), K8 FFT
         (max|delta| <= 2e-5 x max|X| per pair against torch.fft, whose
         rfftn + irfftn is its library yardstick), K10 top-k (indices
         equal).
Phase 2  route A, composite + pyramid epilogue: a synthetic 2x2x1 project
         of 1024x1024x128 uint16 tiles (the 2x2-binned frame of a 2048^2
         sCMOS light-sheet camera; ~10 % overlap, sub-pixel translations,
         N5 raw in 128x128x64 blocks) goes through the port's own CLI entry
         functions, create-fusion-container --multiRes (OME-ZARR, UINT16,
         raw: 6 levels) then affine-fusion --pyramid, with the device
         budget raised so the composite route runs and K6 computes the 5
         levels on the device. Every level must equal K6's plain twin run
         on the card on the stored level below, and the container-reread
         path (downsample_pyramid_level), bitwise. The one cut is z depth:
         128 planes, not hundreds.
Phase 3  route B, per-block shift + downsample stage: the same project at
         the default budget (1 GiB + 12 B x 503 M voxels > 4e9),
         --multiRes without --pyramid. s0 must equal route A within
         |delta| <= 1; three level-1 blocks must equal the plain twin.
Phase 4  route C, gather: a 2x1x1 project (1024x1024x64) with one view
         rotated 3 degrees about z.
Phase 5  route D, per-block anisotropic: route A's project into an N5
         container with --preserveAnisotropy --anisotropyFactor 3
         --multiRes (1952x1952x45), the per-block route forced (device
         budget 1 byte): every compute block goes through K5 + K4, the
         downsample stage makes the levels (three blocks of each held
         bitwise against K6's plain twin on the card), and the standalone
         downsample tool run on s0 into separate datasets must equal them
         bitwise.
Phase 6  stitching through the port's CLI entry function: route A's
         project (a copy of its XML) at -ds 2,2,1 (the reference default;
         crops downsampled by K6) and at -ds 1,1,1 (the longest FFT lines),
         then route C's rotated project at -ds 2,2,1, whose unequal views
         render through fuse_grid_block (K2/K3/K5) before the PCM. Every
         bucket the run sent to the PCM (each shape the main path gives
         K7-K10) is held stage by stage on its own stacks, at phase 1's
         tolerances: K7 against its twin, K8's rfftn / irfftn against
         torch.fft, K9 against its twin, K10 on the twins' PCM with
         indices equal to the twin's top-k. The kernels' peaks must equal
         the twins' peaks computed on the card from the same stacks (or be
         a near tie of the twins' PCM values), and the stored shifts and r
         must equal those refined from the twins' peaks; on route A every
         pair with r > 0.5 must recover the true correction (jitter and
         the appended sub-pixel translations) within 1.5 px at 2,2,1 and
         0.75 px at 1,1,1; the saved XML must hold one StitchingResults
         entry with a nonzero hash per kept pair. Wall seconds, pairs/s,
         padded FFT voxels/s, the host split (extract / stage / launch /
         wait / refine), the card's busy seconds (CUDA events) and its
         idle share are printed beside the card.

In phases 2-5 three written compute blocks (one at the four-tile corner)
are held against the plain-torch twins run on the card, and the host-read,
H2D, kernel, D2H and write times and the fused voxels/s (and the rate
counting pyramid voxels, apart) are printed beside the card's name and
power limit. Each route runs with every launch count set to 0 just before
it and read just after it: a kernel of that route launched no time fails
the run (phase 6 counts each stitching run so). K1 then runs again, timed and held against its twin, on route A's
whole volume: the one shape the main path gives it. The second-to-last line
of output is the kernels' JSON record; the last is
{"ok": true, "device": ...}. Any failure exits non-zero and prints no
result.

``--device cpu --scale tiny`` rehearses phases 1-6 on the CPU with the
plain twins (no kernels, no timings); it then exits 3 without a result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import shutil
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
ROOT = os.path.dirname(os.path.abspath(__file__))
# kernel wrapper -> (its source under csrc/, the JAX device program it
# replaces, file:line under bigstitcher_spark_tpu/)
KERNELS = {
    "composite_fuse": ("composite.cu", "ops/fusion.py:524"),
    "fuse_block_shift": ("shift.cu", "ops/fusion.py:337"),
    "fuse_block": ("gather.cu", "ops/fusion.py:154"),
    "convert_intensity": ("convert.cu", "ops/fusion.py:648"),
    "fuse_block_sep": ("sep.cu", "ops/fusion.py:276"),
    "downsample_level": ("downsample.cu", "ops/downsample.py:50"),
    "downsample_batch": ("downsample.cu", "models/downsample_driver.py:92"),
    "pcm_window": ("pcm.cu", "ops/phasecorr.py:68"),
    "fft_pow2": ("fft.cu", "ops/phasecorr.py:68"),
    "pcm_cross_power": ("pcm.cu", "ops/phasecorr.py:68"),
    "pcm_peaks_topk": ("pcm.cu", "ops/phasecorr.py:68"),
}
# flops per (view, voxel) and per voxel, counted from the kernel sources;
# a cosf, floorf or rintf counts as one operation. K6 does one add per
# input voxel and ~10 operations per output voxel (divides, round, clamp).
# K7: a sum and 4 operations per voxel; K8: 2.5 N log2 N per real 3-D
# transform of N voxels; K9: 12 per complex bin (cross product, hypot,
# compare, 2 divides); K10: 27 comparisons per voxel (the sorts are the
# kernel's choice, not the function's work).
OPS = {"composite_view": 40, "composite_final": 6, "shift": 40,
       "gather": 92, "convert": 5, "sep": 60, "downsample_in": 1,
       "downsample_out": 10, "window": 5, "fft": 2.5, "cross": 12,
       "topk": 27}

SCALES = {
    "full": dict(tile=(1024, 1024, 128), overlap=102, block=(128, 128, 64),
                 rot_tile=(1024, 1024, 64), beads=400, per_block_budget=None,
                 level_shape=(1952, 1952, 132), batch_box=(256, 256, 128),
                 sep_patch=(288, 288, 128), levels_a=5,
                 batch_box_d=(256, 256, 45), pcm_bucket=(2, 64, 512, 128)),
    # the default budget fits tiny volumes: force the per-block routes
    "tiny": dict(tile=(96, 80, 24), overlap=24, block=(32, 32, 16),
                 rot_tile=(96, 80, 16), beads=20, per_block_budget=1,
                 level_shape=(180, 148, 26), batch_box=(64, 64, 32),
                 sep_patch=(96, 96, 24), levels_a=2,
                 batch_box_d=(64, 64, 9), pcm_bucket=(2, 16, 64, 32)),
}
BLOCK_SCALE = (2, 2, 1)       # affine-fusion's default --blockScale
COMPOSITE_BUDGET = int(40e9)  # BST_DEVICE_TILE_BUDGET that fits route A
ANISO = 3.0                   # route D's --anisotropyFactor
# the kernels each route must launch (route C's shift blocks are optional)
ROUTE_KERNELS = {
    "A": ("composite_fuse", "downsample_level"),
    "B": ("fuse_block_shift", "convert_intensity", "downsample_batch"),
    "C": ("fuse_block", "convert_intensity"),
    "D": ("fuse_block_sep", "convert_intensity", "downsample_batch"),
}
PCM_KERNELS = ("pcm_window", "fft_pow2", "pcm_cross_power", "pcm_peaks_topk")
ROUTE_KERNELS.update({
    "S 2,2,1": PCM_KERNELS + ("downsample_batch",),
    "S 1,1,1": PCM_KERNELS,
    "S rendered": PCM_KERNELS + ("fuse_block",),
})


def compute_block_of(scale):
    """The compute block of the per-block routes (storage block x scale)."""
    return tuple(b * s for b, s in zip(SCALES[scale]["block"], BLOCK_SCALE))


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)
    print(f"  ok: {what}", flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing


def time_ms(fn, reps=20, rounds=3):
    """Milliseconds per call of ``fn`` on the card: ``reps`` calls back to
    back between two CUDA events, median over ``rounds`` (after a warm-up
    call). None in a CPU rehearsal."""
    import torch

    if not torch.cuda.is_available():
        return None
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return sorted(out)[len(out) // 2]


def bound(nbytes, ops):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_abs(a, b) -> float:
    import torch

    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def max_abs_u16(a, b, dev) -> int:
    """max |a - b| of two uint16 numpy volumes, computed on ``dev`` in
    x-slabs (int32 differences)."""
    import torch

    out = 0
    for x0 in range(0, a.shape[0], 64):
        ta = torch.from_numpy(a[x0:x0 + 64]).to(dev).to(torch.int32)
        tb = torch.from_numpy(b[x0:x0 + 64]).to(dev).to(torch.int32)
        out = max(out, int((ta - tb).abs().max()))
    return out


# ---------------------------------------------------------------- phase 1


def print_times(what, r, card):
    lib = (f"  library {r['library_ms']} ms" if r.get("library_ms")
           is not None else "")
    print(f"  {what} [{card}]: max|delta| {r['err']:.3g}  kernel {r['ms']} ms"
          f"  wrapper {r['wrapper_ms']} ms  plain {r['plain_ms']} ms  bound "
          f"{r['bound'][0]:.4f} ms ({r['bound'][1]}){lib}", flush=True)


def composite_times(tiles, params, kw, dev, plain_reps=20):
    """K1 alone (on prepared weight tables), its wrapper and its plain twin
    on the same inputs with uint16 output: max |delta| of K1 against the
    twin, the three times, and the bound worked out from these inputs."""
    import numpy as np

    from bigstitcher_spark_tpu_torch.ops import fusion as F

    fracs, img_dims, borders, ranges, ioffs, mn, mx, diags, offs = params
    tables, starts = F.composite_axis_tables(
        kw["windows"], kw["n_offs"], kw["kinds"], fracs, diags, offs,
        img_dims, borders, ranges, ioffs, dev)
    bare = lambda: F.launch_composite(
        tiles, tables, starts, fracs, diags, offs, mn, mx, out_dtype="uint16",
        masks=False, **kw)
    run = lambda: F.composite_fuse(tiles, *params, out_dtype="uint16", **kw)
    plain = lambda: F.composite_fuse_plain(tiles, *params, out_dtype="uint16",
                                           **kw)
    n = int(np.prod(kw["out_shape"]))
    view_steps = sum(int(np.prod([b - a for a, b in zip(*w)]))
                     for w, st in zip(kw["windows"], starts) if st is not None)
    return dict(
        err=max_abs(run(), plain()), ms=time_ms(bare), wrapper_ms=time_ms(run),
        plain_ms=time_ms(plain, reps=plain_reps),
        bound=bound(sum(t.numel() * t.element_size() for t in tiles) + n * 2,
                    view_steps * OPS["composite_view"]
                    + n * OPS["composite_final"]))


def sep_tap_bytes(patch, diags, ts, bs, itemsize, sector=32):
    """Bytes of the patches that K5's taps touch: per view and axis, the
    indices from the smallest lo to the largest hi over the block's sample
    positions (interp_row's clamp, pad 0), the z range (contiguous in
    memory; rows start on sector boundaries) rounded out to whole
    ``sector``-byte sectors."""
    import numpy as np

    total = 0
    for d, t in zip(diags, ts):
        ext = []
        for ax in range(3):
            c = patch[ax]
            pos = np.clip(np.float64(d[ax]) * np.arange(bs[ax])
                          + np.float64(t[ax]), 0, c - 1)
            lo = np.clip(np.floor(pos), 0, max(c - 2, 0))
            hi = np.minimum(lo + 1, c - 1)
            ext.append((int(lo.min()), int(hi.max()) + 1))
        (x0, x1), (y0, y1), (z0, z1) = ext
        zb = (-(-z1 * itemsize // sector) - z0 * itemsize // sector) * sector
        total += (x1 - x0) * (y1 - y0) * zb
    return total


def sep_times(rng, c, bs, patch, V, per_view, dev):
    """K5 on 4 views at route D's compute block and patch shape, against
    its plain twin (fused float32 rtol 1e-5 / atol 1e-3, the tolerance K3
    is held to; wsum atol 1e-5)."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import fusion as F

    patches = c(rng.integers(90, 4000, (V, *patch)).astype(np.uint16))
    diags = np.tile(np.array([1.0, 1.0, ANISO], np.float32), (V, 1))
    ts = rng.uniform(0, 16, (V, 3)).astype(np.float32)
    ts[:, 2] = rng.uniform(-8, 4, V)
    diags[2, 0] = -1.0                   # mirrored on x
    ts[2, 0] += patch[0] - 8
    diags[3, 2] = np.float32(1 / ANISO)  # z upsampled instead
    dims = np.tile(np.array(patch, np.float32) + 40, (V, 1))
    args = [patches] + [c(a) for a in (
        diags, ts, per_view(0, 30), dims, per_view(0, 3), per_view(10, 40),
        np.ones(V, np.float32))]
    io_d = c(np.zeros((V, 3), np.float32))
    run = lambda: F.fuse_block_sep(*args, bs, "AVG_BLEND", io_d)
    plain = lambda: F.fuse_block_sep_plain(*args, bs, "AVG_BLEND", io_d)
    got, ref = run(), plain()
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)
    check(float((ref[1] > 0).float().mean()) > 0.5,
          "K5 case: most block voxels covered")
    for ft in F.FUSION_TYPES:
        g = F.fuse_block_sep(*args, bs, ft, io_d)
        r = F.fuse_block_sep_plain(*args, bs, ft, io_d)
        torch.testing.assert_close(g[0], r[0], rtol=1e-5, atol=1e-3)
    tables = F.sep_axis_tables(*args[1:7], io_d, bs)
    bare = lambda: F.launch_fuse_block_sep(patches, args[1], args[2], tables,
                                           args[7], bs, "AVG_BLEND")
    n = int(np.prod(bs))
    return dict(err=max_abs(got[0], ref[0]), ms=time_ms(bare),
                wrapper_ms=time_ms(run), plain_ms=time_ms(plain),
                library_ms=None,
                bound=bound(sep_tap_bytes(patch, diags, ts, bs, 2)
                            + 2 * n * 4, V * n * OPS["sep"]))


def downsample_times(x, factors, dev, level: bool):
    """K6 against its plain twin (bitwise) and torch's avg_pool3d on the
    float32 input (the library yardstick, used nowhere in the port):
    ``level`` True times downsample_level (uint16 out), else
    downsample_batch (float32 out) on the (B, X, Y, Z) batch ``x``."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import downsample as D

    dims = tuple(int(s) // f for s, f in zip(x.shape[-3:], factors))
    if level:
        run = lambda: D.downsample_level(x, factors, dims, "uint16")
        plain = lambda: D.downsample_level_plain(x, factors, dims, "uint16")
    else:
        run = lambda: D.downsample_batch(x, factors)
        plain = lambda: D.downsample_block_plain(x, factors)
    got, ref = run(), plain()
    check(got.dtype == ref.dtype and tuple(got.shape) == tuple(ref.shape)
          and torch.equal(got, ref),
          f"K6 {'level' if level else 'batch'} {tuple(x.shape)} / {factors}"
          f" -> {tuple(got.shape)} {got.dtype}: bitwise equal to the twin")
    xf = x.to(torch.float32).reshape(-1, 1, *x.shape[-3:])
    lib = lambda: torch.nn.functional.avg_pool3d(xf, factors, factors)
    pooled = lib().reshape(ref.shape)
    e = max_abs(pooled, ref.to(torch.float32))
    print(f"  avg_pool3d vs K6 twin: max|delta| {e:.3g} "
          f"(uint16 rounding for levels)", flush=True)
    ms = time_ms(run)
    n_out = int(np.prod(got.shape))
    return dict(err=max_abs(got, ref), ms=ms, wrapper_ms=ms,
                plain_ms=time_ms(plain, reps=5), library_ms=time_ms(lib),
                bound=bound(x.numel() * x.element_size()
                            + n_out * got.element_size(),
                            x.numel() * OPS["downsample_in"]
                            + n_out * OPS["downsample_out"]))


def fft_plain_roundtrip(w):
    """rfftn then irfftn of ``w`` through K8's plain twin, pass by pass."""
    from bigstitcher_spark_tpu_torch.ops import phasecorr as P

    _, X, Y, Z = (int(s) for s in w.shape)
    f = P.fft_pow2_plain(w, 3, "r2c")
    f = P.fft_pow2_plain(P.fft_pow2_plain(f, 2, "c2c"), 1, "c2c")
    g = P.fft_pow2_plain(P.fft_pow2_plain(f, 1, "c2c", True), 2, "c2c", True)
    return P.fft_pow2_plain(g, 3, "c2r", True, 1.0 / (X * Y * Z), n=Z)


def check_fft(got, ref, what):
    """K8's tolerance: max|delta| <= 2e-5 x max|ref| for every pair."""
    for k in range(int(ref.shape[0])):
        e, m = max_abs(got[k], ref[k]), float(ref[k].abs().max())
        check(e <= 2e-5 * m, f"K8 {what} pair {k}: max|delta| {e:.3g} <= "
                             f"2e-5 x {m:.4g}")


def pcm_times(rng, c, bucket):
    """K7-K10 at one stitching bucket (B pairs of X x Y x Z uint16 crops,
    each b a shifted copy of its a) against their twins, with times and
    bounds; returns {wrapper name: result}."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import phasecorr as P

    B, X, Y, Z = bucket
    ext = np.array([[X - X // 5 - k, Y - 2 - k, Z] for k in range(B)],
                   np.int32)
    a = np.zeros(bucket, np.uint16)
    for k in range(B):
        e = ext[k]
        a[k, :e[0], :e[1], :e[2]] = rng.integers(90, 4000, tuple(e))
    b = np.roll(a, (2, -3, 1), axis=(1, 2, 3))
    a, b, ext = c(a), c(b), c(ext)
    n, m = B * X * Y * Z, B * X * Y * (Z // 2 + 1)
    res = {}

    w = P.pcm_window(a, ext)
    torch.testing.assert_close(w, P.pcm_window_plain(a, ext), rtol=1e-5,
                               atol=1e-6)
    masks = P.fade_masks(ext, (X, Y, Z), 0.25)
    res["pcm_window"] = dict(
        err=max_abs(w, P.pcm_window_plain(a, ext)),
        ms=time_ms(lambda: P.launch_pcm_window(a, ext, masks)),
        wrapper_ms=time_ms(lambda: P.pcm_window(a, ext)),
        plain_ms=time_ms(lambda: P.pcm_window_plain(a, ext)),
        library_ms=None, bound=bound(n * 2 + n * 4, n * OPS["window"]))

    fa = P.rfftn3(w)
    ref = torch.fft.rfftn(w, dim=(1, 2, 3))
    check_fft(fa, ref, f"rfftn {tuple(w.shape)}")
    fb = P.rfftn3(P.pcm_window(b, ext))
    norm = P.pcm_cross_power(fa, fb)
    norm_ref = P.pcm_cross_power_plain(fa, fb)
    torch.testing.assert_close(norm, norm_ref, rtol=1e-5, atol=1e-6)
    pcm = P.irfftn3(norm.clone(), Z)
    pcm_ref = torch.fft.irfftn(norm, s=(X, Y, Z), dim=(1, 2, 3))
    check_fft(pcm, pcm_ref, f"irfftn {tuple(pcm.shape)}")
    err8 = max(max_abs(fa, ref), max_abs(pcm, pcm_ref))
    lib = lambda: torch.fft.irfftn(torch.fft.rfftn(w, dim=(1, 2, 3)),
                                   s=(X, Y, Z), dim=(1, 2, 3))
    ms8 = time_ms(lambda: P.irfftn3(P.rfftn3(w), Z))
    res["fft_pow2"] = dict(
        err=err8, ms=ms8, wrapper_ms=ms8,
        plain_ms=time_ms(lambda: fft_plain_roundtrip(w)),
        library_ms=time_ms(lib),
        bound=bound(2 * (n * 4 + m * 8),
                    2 * B * OPS["fft"] * (n // B) * np.log2(n // B)))
    ms9 = time_ms(lambda: P.pcm_cross_power(fa, fb))
    res["pcm_cross_power"] = dict(
        err=max_abs(norm, norm_ref),
        ms=ms9, wrapper_ms=ms9,
        plain_ms=time_ms(lambda: P.pcm_cross_power_plain(fa, fb)),
        library_ms=None, bound=bound(3 * m * 8, m * OPS["cross"]))

    peaks = P.pcm_peaks_topk(pcm, 5)
    peaks_ref = P.pcm_peaks_topk_plain(pcm, 5)
    check(torch.equal(peaks, peaks_ref),
          f"K10 top-5 of {tuple(pcm.shape)}: indices equal to the twin's")
    want = [(-2) % X, 3 % Y, (-1) % Z]
    check(all(peaks[k, 0].tolist() == want for k in range(B)),
          f"K7-K10: every pair's first peak names the shift {want}")
    ms10 = time_ms(lambda: P.pcm_peaks_topk(pcm, 5))
    res["pcm_peaks_topk"] = dict(
        err=0.0, ms=ms10, wrapper_ms=ms10,
        plain_ms=time_ms(lambda: P.pcm_peaks_topk_plain(pcm, 5), reps=5),
        library_ms=None, bound=bound(n * 4, n * OPS["topk"]))
    return res


def phase1_kernels(dev, scale, card):
    """Each kernel against its plain twin on the same card inputs."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import downsample as D
    from bigstitcher_spark_tpu_torch.ops import fusion as F

    rng = np.random.default_rng(2024)
    cfg = SCALES[scale]
    bs = compute_block_of(scale)
    V = 4
    res = {}
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def per_view(lo, hi):
        return rng.uniform(lo, hi, (V, 3)).astype(np.float32)

    dims = np.tile(np.array([s + 80 for s in bs], np.float32), (V, 1))
    borders, ranges = per_view(0, 3), per_view(10, 40)
    valid, ioffs = np.ones(V, np.float32), np.zeros((V, 3), np.float32)

    # K2: 4 translated views with sub-pixel fractions, some voxels outside
    patches = c(rng.integers(90, 4000, (V, *(s + 1 for s in bs)))
                .astype(np.uint16))
    fr = per_view(0, 1)
    lp = (rng.uniform(-40, 40, (V, 3)) + fr).astype(np.float32)
    io_d = c(ioffs)
    args = [patches] + [c(a) for a in (fr, lp, dims, borders, ranges, valid)]
    run = lambda: F.fuse_block_shift(*args, bs, "AVG_BLEND", io_d)
    plain = lambda: F.fuse_block_shift_plain(*args, bs, "AVG_BLEND", io_d)
    got, ref = run(), plain()
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)
    tables = F.shift_axis_tables(*args[2:6], io_d, bs)
    bare = lambda: F.launch_fuse_block_shift(patches, args[1], tables,
                                             args[6], bs, "AVG_BLEND")
    n = int(np.prod(bs))
    res["fuse_block_shift"] = dict(
        err=max_abs(got[0], ref[0]), ms=time_ms(bare), wrapper_ms=time_ms(run),
        plain_ms=time_ms(plain),
        bound=bound(patches.numel() * 2 + 2 * n * 4, V * n * OPS["shift"]))

    # K3: general affines, one rotated 7 degrees, samples outside the patch
    ps = tuple(s + 32 for s in bs)
    gpatches = c(rng.integers(90, 4000, (V, *ps)).astype(np.uint16))
    aff = np.zeros((V, 3, 4), np.float32)
    for v in range(V):
        a = np.deg2rad(7.0 if v == 1 else rng.uniform(-1, 1))
        aff[v, :3, :3] = [[np.cos(a), -np.sin(a), 0],
                          [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        aff[v, :, 3] = rng.uniform(-12, 40, 3)
    gargs = [gpatches] + [c(a) for a in (aff, per_view(0, 50), dims, borders,
                                          ranges, valid)]
    run = lambda: F.fuse_block(*gargs, bs, "AVG_BLEND", io_d)
    plain = lambda: F.fuse_block_plain(*gargs, bs, "AVG_BLEND", io_d)
    got, ref = run(), plain()
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)
    ms = time_ms(run)  # no preparation: the wrapper is the launch
    res["fuse_block"] = dict(
        err=max_abs(got[0], ref[0]), ms=ms, wrapper_ms=ms,
        plain_ms=time_ms(plain),
        bound=bound(gpatches.numel() * 2 + 2 * n * 4, V * n * OPS["gather"]))

    # K4: float32 -> uint16 with rounding half to even and clipping
    x = c(rng.uniform(-100, 70000, bs).astype(np.float32))
    run = lambda: F.convert_intensity(x, 0.0, 65535.0, "uint16")
    plain = lambda: F.convert_intensity_plain(x, 0.0, 65535.0, "uint16")
    err = max_abs(run(), plain())
    check(err <= 1, f"K4 convert |delta| {err} <= 1")
    ms = time_ms(run)
    res["convert_intensity"] = dict(
        err=err, ms=ms, wrapper_ms=ms, plain_ms=time_ms(plain),
        bound=bound(n * 6, n * OPS["convert"]))

    # K1: 2 shift + 2 sep views around the volume, zero-padded tiles
    S = tuple(int(s * 0.65) for s in bs)
    tiles, windows, n_offs, kinds = [], [], [], []
    kfr = np.zeros((V, 3), np.float32)
    dg, of = np.ones((V, 3), np.float32), np.zeros((V, 3), np.float32)
    corners = [(0, 0, 0), tuple(b - s for b, s in zip(bs, S)),
               (bs[0] - S[0], 0, 0), (0, bs[1] - S[1], 0)]
    for v in range(V):
        tiles.append(c(rng.integers(90, 4000, S).astype(np.uint16)))
        g = rng.uniform(-0.5, 0.5, 3) - np.array(corners[v]) - 2.0
        if v < 2:
            nn = np.floor(g).astype(np.int64)
            kfr[v] = g - nn
            a = tuple(int(max(0, -nn[d] - 1)) for d in range(3))
            b = tuple(int(min(bs[d], S[d] - nn[d])) for d in range(3))
            kinds.append("shift")
            n_offs.append(tuple(int(q) for q in nn))
        else:
            dg[v] = rng.uniform(0.8, 1.25, 3)
            of[v] = g
            a = tuple(int(max(0, np.floor((-1.0 - g[d]) / dg[v, d])))
                      for d in range(3))
            b = tuple(int(min(bs[d], np.ceil((S[d] - g[d]) / dg[v, d]) + 1))
                      for d in range(3))
            kinds.append("sep")
            n_offs.append((0, 0, 0))
        windows.append((a, b))
    kdims = np.tile(np.array(S, np.float32), (V, 1))
    params = (kfr, kdims, borders, ranges, ioffs, 0.0, 4000.0, dg, of)
    kw = dict(out_shape=bs, windows=tuple(windows), n_offs=tuple(n_offs),
              pad=(1, 1, 1), kinds=tuple(kinds), fusion_type="AVG_BLEND")
    for od in ("float32", "uint16"):
        got = F.composite_fuse(tiles, *params, out_dtype=od, **kw)
        ref = F.composite_fuse_plain(tiles, *params, out_dtype=od, **kw)
        if od == "float32":
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-3)
    for ft in F.FUSION_TYPES:
        e = max_abs(F.composite_fuse(tiles, *params, out_dtype="uint16",
                                     **{**kw, "fusion_type": ft}),
                    F.composite_fuse_plain(tiles, *params, out_dtype="uint16",
                                           **{**kw, "fusion_type": ft}))
        check(e <= 1, f"K1 composite {ft} |delta| {e} <= 1")
    res["composite_fuse"] = composite_times(tiles, params, kw, dev)
    del tiles

    # K5: route D's compute block and bucketed patch
    res["fuse_block_sep"] = sep_times(rng, c, bs, cfg["sep_patch"], V,
                                      per_view, dev)

    # K6: route A's first pyramid step, and one batch of the downsample
    # stage (4 level blocks of 128x128x64 x rel (2,2,2))
    vol = c(rng.integers(0, 65536, cfg["level_shape"]).astype(np.uint16))
    res["downsample_level"] = downsample_times(vol, (2, 2, 2), dev, True)
    del vol
    boxes = c(rng.integers(0, 65536, (4, *cfg["batch_box"])).astype(np.uint16))
    res["downsample_batch"] = downsample_times(boxes, (2, 2, 2), dev, False)
    del boxes
    dboxes = c(rng.integers(0, 65536, (4, *cfg["batch_box_d"]))
               .astype(np.uint16))
    got = D.downsample_batch(dboxes, (2, 2, 1))
    ref = D.downsample_block_plain(dboxes, (2, 2, 1))
    check(got.dtype == ref.dtype and torch.equal(got, ref),
          f"K6 batch at route D's boxes {tuple(dboxes.shape)} / (2, 2, 1) -> "
          f"{tuple(got.shape)}: bitwise equal to the twin")
    del dboxes

    # K7-K10: route A's x-edge bucket at -ds 2,2,1
    res.update(pcm_times(rng, c, cfg["pcm_bucket"]))
    for k, r in res.items():
        print_times(k, r, card)
    return res


# ---------------------------------------------------------------- phases 2-5


def make_project(root, scale, n_tiles, tile, rotate, seed):
    import numpy as np

    from bigstitcher_spark_tpu_torch.utils.geometry import translation_affine
    from bigstitcher_spark_tpu_torch.utils.testdata import (
        append_view_transforms, make_synthetic_project, rotation_about_z)

    cfg = SCALES[scale]
    t0 = time.time()
    proj = make_synthetic_project(
        root, n_tiles=n_tiles, tile_size=tile, overlap=cfg["overlap"],
        block_size=cfg["block"], n_beads_per_tile=cfg["beads"], seed=seed,
        compression="raw")
    rng = np.random.default_rng(seed + 100)
    ntot = int(np.prod(n_tiles))
    tr = {s: translation_affine(rng.uniform(-0.5, 0.5, 3)) for s in range(ntot)}
    if rotate:
        center = np.asarray(proj.true_offsets[1]) + np.asarray(tile) / 2
        tr[1] = rotation_about_z(3.0, center) @ np.vstack([tr[1], [0, 0, 0, 1]])
    append_view_transforms(proj.xml_path, tr)
    proj.appended = tr
    print(f"  synthesized {ntot} tiles of {tile} uint16 in "
          f"{time.time() - t0:.1f}s (host)", flush=True)
    return proj


@contextlib.contextmanager
def tile_budget(budget):
    """BST_DEVICE_TILE_BUDGET set to ``budget`` (None: the default) inside."""
    old = os.environ.pop("BST_DEVICE_TILE_BUDGET", None)
    if budget is not None:
        os.environ["BST_DEVICE_TILE_BUDGET"] = str(budget)
    try:
        yield
    finally:
        os.environ.pop("BST_DEVICE_TILE_BUDGET", None)
        if old is not None:
            os.environ["BST_DEVICE_TILE_BUDGET"] = old


def run_cli(xml, out, scale, device, budget=None, storage="ZARR",
            container_args=(), fusion_args=()):
    """create-fusion-container + affine-fusion through the CLI entry
    function; returns (FusionStats, affine-fusion wall seconds including
    its downsample stage)."""
    from bigstitcher_spark_tpu_torch.cli.main import main

    cfg = SCALES[scale]
    main(["create-fusion-container", "-x", xml, "-o", out, "-s", storage,
          "-d", "UINT16", "-c", "raw", "--blockSize",
          ",".join(str(b) for b in cfg["block"]), *container_args])
    with tile_budget(budget):
        t0 = time.perf_counter()
        (stats,) = main(["affine-fusion", "-o", out, "--device", device,
                         *fusion_args])
        wall = time.perf_counter() - t0
    return stats, wall


def container_levels(out):
    """(store, level infos of slot 0, 3-D reader of each level)."""
    from bigstitcher_spark_tpu_torch.io.chunkstore import ChunkStore
    from bigstitcher_spark_tpu_torch.io.container import read_container_meta

    store = ChunkStore.open(out)
    mr = read_container_meta(store).mr_infos[0]

    def read(lvl):
        a = store.open_dataset(mr[lvl].dataset.strip("/")).read_full()
        return a[..., 0, 0] if a.ndim == 5 else a

    return store, mr, read


def read_volume(out):
    return container_levels(out)[2](0)


def report(stats, wall, card, label, levels=()):
    """A route's phase times and rates; ``levels``: the level infos the
    downsample stage filled after fuse_volume (counted apart)."""
    import numpy as np

    t = stats.timings
    lvl_vox = (0 if stats.pyramid_levels else
               sum(int(np.prod(m.dimensions[:3])) for m in levels))
    print(f"  [{label}] {card}: path={stats.path} kernels={stats.kernel_blocks}"
          f" host-read {t['read']:.3f}s h2d {t['h2d']:.3f}s kernel "
          f"{t['kernel']:.3f}s d2h {t['d2h']:.3f}s write {t['write']:.3f}s "
          f"total {stats.seconds:.3f}s -> "
          f"{stats.voxels / max(stats.seconds, 1e-9):,.0f} fused voxels/s",
          flush=True)
    if stats.pyramid_levels:
        rate = (stats.voxels + stats.pyramid_voxels) / max(stats.seconds, 1e-9)
        print(f"  [{label}] {card}: epilogue {stats.pyramid_levels} levels, "
              f"{stats.pyramid_voxels} voxels -> {rate:,.0f} voxels/s incl. "
              f"pyramid (fuse_volume); affine-fusion wall {wall:.3f}s",
              flush=True)
    elif lvl_vox:
        print(f"  [{label}] {card}: downsample stage made {lvl_vox} level "
              f"voxels; affine-fusion wall {wall:.3f}s -> "
              f"{(stats.voxels + lvl_vox) / max(wall, 1e-9):,.0f} voxels/s "
              "incl. pyramid", flush=True)


def check_blocks(name, vol, expect_fn, blocks):
    """Hold written compute blocks against expect_fn(block) -> uint16."""
    import numpy as np

    for tag, b in blocks:
        sl = tuple(slice(o, o + s) for o, s in zip(b.offset, b.size))
        want = expect_fn(b)
        err = int(np.abs(vol[sl].astype(np.int64) - want.astype(np.int64)).max())
        check(err <= 1, f"{name} block {tag} at {b.offset}: |delta| {err} "
                        "<= 1 vs the plain twin on the device")


def pick_blocks(proj, out, compute_block):
    """Three compute blocks: the first, the last, and the one holding the
    corner where the tiles meet (mean of the tile centres)."""
    import numpy as np

    from bigstitcher_spark_tpu_torch.io.chunkstore import ChunkStore
    from bigstitcher_spark_tpu_torch.io.container import read_container_meta
    from bigstitcher_spark_tpu_torch.utils.grid import create_grid

    meta = read_container_meta(ChunkStore.open(out))
    grid = create_grid(meta.bbox.shape, compute_block, meta.block_size)
    sd = proj.spimdata
    centers = [np.asarray(proj.true_offsets[s]) + np.asarray(sd.setups[s].size) / 2
               for s in sd.setups]
    c = np.mean(centers, axis=0) - np.asarray(meta.bbox.min)
    corner = min(grid, key=lambda b: np.abs(
        (np.asarray(b.offset) + np.asarray(b.size) / 2 - c)[:2]).sum())
    return meta, [("first", grid[0]), ("tile corner", corner),
                  ("last", grid[-1])]


def plain_block(sd, loader, meta, block, compute_block, dev, aniso=None):
    """A compute block through the plain twins on ``dev`` (no kernels)."""
    import torch

    from bigstitcher_spark_tpu_torch.models import affine_fusion as A
    from bigstitcher_spark_tpu_torch.ops import fusion as F

    staged = A.stage_block(sd, loader, sd.view_ids(), block, meta.bbox,
                           compute_block, A.BlendParams(), aniso, (0.0,) * 3)
    *ins, ioffs = [torch.from_numpy(a).to(dev) for a in staged.arrays]
    fn = {"shift": F.fuse_block_shift_plain, "sep": F.fuse_block_sep_plain,
          "gather": F.fuse_block_plain}[staged.kind]
    fused, _w = fn(*ins, staged.shape, "AVG_BLEND", ioffs)
    out = F.convert_intensity_plain(fused, 0.0, 65535.0, "uint16")
    sl = tuple(slice(0, s) for s in block.size)
    return out.cpu().numpy()[sl], staged.kind


def check_level_blocks(name, mr, read, dev, lvl=1):
    """Three blocks of pyramid level ``lvl`` (first, middle, last) against
    K6's plain twin on the device, run on the stored level below: bitwise.
    ``mr``, ``read``: the level infos and level reader of the container."""
    import torch

    from bigstitcher_spark_tpu_torch.models.downsample_driver import read_padded
    from bigstitcher_spark_tpu_torch.ops.downsample import (
        convert_storage, downsample_block_plain)
    from bigstitcher_spark_tpu_torch.utils.grid import create_grid

    src, dst = read(lvl - 1), read(lvl)
    rel = [int(v) for v in mr[lvl].relativeDownsampling[:3]]
    grid = create_grid(mr[lvl].dimensions[:3], mr[lvl].blockSize[:3])
    for tag, b in (("first", grid[0]), ("middle", grid[len(grid) // 2]),
                   ("last", grid[-1])):
        box = read_padded(
            lambda off, size: src[tuple(slice(o, o + s)
                                        for o, s in zip(off, size))],
            src.shape, [o * f for o, f in zip(b.offset, rel)],
            [s * f for s, f in zip(b.size, rel)])
        want = convert_storage(downsample_block_plain(
            torch.from_numpy(box).to(dev), rel), "uint16").cpu().numpy()
        got = dst[tuple(slice(o, o + s) for o, s in zip(b.offset, b.size))]
        check((got == want).all(), f"{name} level {lvl} block {tag} at "
              f"{b.offset}: bitwise equal to K6's plain twin on the device")


def route_a_inputs(sd, loader, bbox, dev):
    """Route A's composite plan and tiles on ``dev``, as the arguments of
    composite_fuse (tiles, params, keywords without out_dtype)."""
    import torch

    from bigstitcher_spark_tpu_torch.models import affine_fusion as A

    with tile_budget(COMPOSITE_BUDGET):
        cp = A.plan_composite_volume(sd, loader, sd.view_ids(), bbox, None,
                                     A.BlendParams())
    tiles = [torch.from_numpy(loader.open(p.view).read_full()).to(dev)
             for p in cp.plans]
    params = (cp.fracs, cp.img_dims, cp.borders, cp.ranges, cp.inside_offs,
              0.0, 65535.0, cp.diags, cp.offs)
    kw = dict(out_shape=cp.out_shape, windows=cp.windows, n_offs=cp.n_offs,
              pad=cp.pad, kinds=cp.kinds, fusion_type="AVG_BLEND")
    return tiles, params, kw


def composite_at_route_a(xml_path, out_a, dev):
    """K1 timed at the one shape the main path gives it (route A's whole
    volume), after the main path's launch counts were read."""
    from bigstitcher_spark_tpu_torch.io.chunkstore import ChunkStore
    from bigstitcher_spark_tpu_torch.io.container import read_container_meta
    from bigstitcher_spark_tpu_torch.io.dataset_io import ViewLoader
    from bigstitcher_spark_tpu_torch.io.spimdata import SpimData

    sd = SpimData.load(xml_path)
    bbox = read_container_meta(ChunkStore.open(out_a)).bbox
    tiles, params, kw = route_a_inputs(sd, ViewLoader(sd), bbox, dev)
    r = composite_times(tiles, params, kw, dev, plain_reps=2)
    check(r["err"] <= 1, f"K1 at route A's shape {kw['out_shape']}: |delta| "
                         f"{r['err']} <= 1 vs the plain composite")
    return r


def counted(route, launches, dev, fn):
    """Run ``fn`` (one route's main path) with every launch count set to 0
    just before it and read just after it; on the card the route's kernels
    must each have launched. Adds the counts to ``launches``."""
    from bigstitcher_spark_tpu_torch import ops

    ops.reset_launch_counts()
    out = fn()
    got = ops.launch_counts()
    print(f"  route {route} launches: {got}", flush=True)
    for k in ROUTE_KERNELS[route] if dev.type == "cuda" else ():
        check(got[k] > 0, f"route {route}: kernel {k} launched {got[k]} "
                          "times")
    for k, n in got.items():
        launches[k] = launches.get(k, 0) + n
    return out


def route_a(work, scale, dev, card, launches):
    """Phase 2: composite route with the pyramid epilogue; the levels must
    equal K6's plain twin and the container-reread path bit for bit."""
    import torch

    from bigstitcher_spark_tpu_torch.io.container import (
        estimate_multires_pyramid)
    from bigstitcher_spark_tpu_torch.io.dataset_io import ViewLoader
    from bigstitcher_spark_tpu_torch.io.spimdata import SpimData
    from bigstitcher_spark_tpu_torch.models.downsample_driver import (
        downsample_pyramid_level)
    from bigstitcher_spark_tpu_torch.ops import downsample as D
    from bigstitcher_spark_tpu_torch.ops import fusion as F

    cfg = SCALES[scale]
    compute_block = compute_block_of(scale)
    print("phase 2 (route A, composite + pyramid epilogue)", flush=True)
    print(f"  cut: z depth {cfg['tile'][2]} planes (scale {scale})")
    proj = make_project(os.path.join(work, "p4"), scale, (2, 2, 1),
                        cfg["tile"], False, seed=7)
    out_a = os.path.join(work, "route_a.ome.zarr")
    stats_a, wall = counted("A", launches, dev, lambda: run_cli(
        proj.xml_path, out_a, scale, str(dev), budget=COMPOSITE_BUDGET,
        container_args=["--multiRes"], fusion_args=["--pyramid"]))
    report(stats_a, wall, card, "route A")
    check(stats_a.path == "composite", "route A took the composite route")
    store, mr, read = container_levels(out_a)
    steps = [list(m.absoluteDownsampling[:3]) for m in mr]
    print(f"  pyramid {steps}", flush=True)
    check(steps == estimate_multires_pyramid(mr[0].dimensions[:3])
          and len(steps) == cfg["levels_a"] + 1
          and stats_a.pyramid_levels == cfg["levels_a"],
          f"route A: --multiRes gave {len(steps)} levels and the epilogue "
          f"made {stats_a.pyramid_levels}")
    vol_a = read(0)
    meta, blocks = pick_blocks(proj, out_a, compute_block)
    sd = SpimData.load(proj.xml_path)
    loader = ViewLoader(sd)
    tiles, params, kw = route_a_inputs(sd, loader, meta.bbox, dev)
    ref_a = F.composite_fuse_plain(tiles, *params, out_dtype="uint16",
                                   **kw).cpu().numpy()
    del tiles
    check_blocks("route A", vol_a, lambda b: ref_a[tuple(
        slice(o, o + s) for o, s in zip(b.offset, b.size))], blocks)
    err = max_abs_u16(vol_a, ref_a, dev)
    check(err <= 1, f"route A whole volume {vol_a.shape}: |delta| {err} <= 1 "
                    "vs the plain composite on the device")
    del ref_a
    epi = [read(lvl) for lvl in range(1, len(mr))]
    for lvl, a in enumerate(epi, start=1):
        below = torch.from_numpy(epi[lvl - 2] if lvl > 1 else vol_a).to(dev)
        want = D.downsample_level_plain(
            below, [int(v) for v in mr[lvl].relativeDownsampling[:3]],
            [int(v) for v in mr[lvl].dimensions[:3]], "uint16").cpu().numpy()
        del below
        check(a.shape == want.shape and (a == want).all(),
              f"route A level {lvl} {a.shape}: epilogue bitwise equal to "
              "K6's plain twin on the device, run on the stored level below")
    t0 = time.perf_counter()
    for lvl in range(1, len(mr)):
        downsample_pyramid_level(store, mr[lvl - 1], mr[lvl], True, (0, 0),
                                 device=dev)
    print(f"  reread path over {len(mr) - 1} levels: "
          f"{time.perf_counter() - t0:.3f}s [{card}]", flush=True)
    for lvl, a in enumerate(epi, start=1):
        b = read(lvl)
        check(a.shape == b.shape and (a == b).all() and a.std() > 0,
              f"route A level {lvl} {a.shape}: epilogue bitwise equal to "
              "the reread path")
    return proj, out_a, vol_a, meta, blocks, sd, loader


def route_b(work, scale, dev, card, launches, a):
    """Phase 3: per-block shift route, the downsample stage makes the
    levels."""
    proj, _out_a, vol_a, meta, blocks, sd, loader = a
    cfg = SCALES[scale]
    compute_block = compute_block_of(scale)
    print("phase 3 (route B, per-block shift + downsample stage)", flush=True)
    out_b = os.path.join(work, "route_b.ome.zarr")
    stats_b, wall = counted("B", launches, dev, lambda: run_cli(
        proj.xml_path, out_b, scale, str(dev),
        budget=cfg["per_block_budget"], container_args=["--multiRes"]))
    _store, mr, read = container_levels(out_b)
    report(stats_b, wall, card, "route B", mr[1:])
    check(stats_b.path == "per-block" and stats_b.kernel_blocks["shift"] > 0
          and stats_b.pyramid_levels == 0,
          "route B took the per-block shift route, no epilogue")
    vol_b = read_volume(out_b)
    err = max_abs_u16(vol_a, vol_b, dev)
    check(err <= 1, f"route B equals route A within |delta| {err} <= 1")
    check_blocks("route B", vol_b, lambda b: plain_block(
        sd, loader, meta, b, compute_block, dev)[0], blocks)
    check_level_blocks("route B", mr, read, dev)


def route_c(work, scale, dev, card, launches):
    """Phase 4: the gather route."""
    from bigstitcher_spark_tpu_torch.io.dataset_io import ViewLoader
    from bigstitcher_spark_tpu_torch.io.spimdata import SpimData

    cfg = SCALES[scale]
    compute_block = compute_block_of(scale)
    print("phase 4 (route C, gather)", flush=True)
    proj_c = make_project(os.path.join(work, "p2"), scale, (2, 1, 1),
                          cfg["rot_tile"], True, seed=11)
    out_c = os.path.join(work, "route_c.ome.zarr")
    stats_c, wall = counted("C", launches, dev, lambda: run_cli(
        proj_c.xml_path, out_c, scale, str(dev),
        budget=cfg["per_block_budget"]))
    report(stats_c, wall, card, "route C")
    check(stats_c.path == "per-block" and stats_c.kernel_blocks["gather"] > 0,
          "route C took the per-block route with gather blocks")
    vol_c = read_volume(out_c)
    meta_c, blocks_c = pick_blocks(proj_c, out_c, compute_block)
    sd_c = SpimData.load(proj_c.xml_path)
    loader_c = ViewLoader(sd_c)
    kinds = []

    def expect(b):
        data, kind = plain_block(sd_c, loader_c, meta_c, b, compute_block, dev)
        kinds.append(kind)
        return data

    check_blocks("route C", vol_c, expect, blocks_c)
    check("gather" in kinds, f"route C checked blocks include a gather block "
                             f"({kinds})")
    return proj_c


def route_d(work, scale, dev, card, launches, a):
    """Phase 5: the per-block anisotropic route (K5), its downsample stage,
    and the standalone downsample tool on its s0."""
    from bigstitcher_spark_tpu_torch.cli.main import main
    from bigstitcher_spark_tpu_torch.models.affine_fusion import (
        anisotropy_transform)

    proj, _out_a, _vol_a, _meta, _blocks, sd, loader = a
    compute_block = compute_block_of(scale)
    print("phase 5 (route D, per-block anisotropic)", flush=True)
    out_d = os.path.join(work, "route_d.n5")

    def path():
        stats, wall = run_cli(
            proj.xml_path, out_d, scale, str(dev), budget=1, storage="N5",
            container_args=["--preserveAnisotropy", "--anisotropyFactor",
                            str(ANISO), "--multiRes"])
        _store, mr, _read = container_levels(out_d)
        rels = ";".join(",".join(str(int(v)) for v in m.relativeDownsampling)
                        for m in mr[1:])
        outs = ";".join(f"tool/s{i}" for i in range(1, len(mr)))
        t0 = time.perf_counter()
        main(["downsample", "-i", out_d, "-di", "ch0tp0/s0", "-do", outs,
              "-ds", rels, "--device", str(dev)])
        return stats, wall, mr, time.perf_counter() - t0

    stats_d, wall, mr, tool_s = counted("D", launches, dev, path)
    report(stats_d, wall, card, "route D", mr[1:])
    print(f"  [route D] {card}: downsample tool {len(mr) - 1} levels in "
          f"{tool_s:.3f}s", flush=True)
    check(stats_d.path == "per-block" and stats_d.kernel_blocks["sep"] > 0
          and stats_d.kernel_blocks["shift"] == 0
          and stats_d.kernel_blocks["gather"] == 0,
          f"route D fused every block through K5 ({stats_d.kernel_blocks})")
    store, _mr, read = container_levels(out_d)
    read = functools.lru_cache(maxsize=2)(read)
    vol_d = read(0)
    print(f"  route D volume {vol_d.shape}, pyramid "
          f"{[list(m.absoluteDownsampling) for m in mr]}", flush=True)
    meta_d, blocks_d = pick_blocks(proj, out_d, compute_block)
    aniso = anisotropy_transform(ANISO)
    kinds = []

    def expect(b):
        data, kind = plain_block(sd, loader, meta_d, b, compute_block, dev,
                                 aniso)
        kinds.append(kind)
        return data

    check_blocks("route D", vol_d, expect, blocks_d)
    check(set(kinds) == {"sep"}, f"route D checked blocks are sep ({kinds})")
    for lvl in range(1, len(mr)):
        check_level_blocks("route D", mr, read, dev, lvl)
        a_ = read(lvl)
        b_ = store.open_dataset(f"tool/s{lvl}").read_full()
        check(a_.shape == b_.shape and (a_ == b_).all() and a_.std() > 0,
              f"route D level {lvl} {a_.shape}: downsample tool bitwise "
              "equal to the fusion stage's level")


# ---------------------------------------------------------------- phase 6


def check_close(got, ref, what, rtol=1e-5, atol=1e-6):
    """K7's and K9's tolerance: |got - ref| <= atol + rtol |ref| for every
    element (real and imaginary parts apart)."""
    import torch

    if got.is_complex():
        got, ref = torch.view_as_real(got), torch.view_as_real(ref)
    bad = int(((got - ref).abs() > atol + rtol * ref.abs()).sum())
    check(got.shape == ref.shape and bad == 0,
          f"{what}: within rtol {rtol:g} / atol {atol:g} of the twin "
          f"(max|delta| {max_abs(got, ref):.3g}, {bad} outside)")


def check_bucket(what, a, b, ea, eb, n_peaks):
    """One stitching bucket's stacks through K7-K10 stage by stage, each
    held against its plain twin (K8 against torch.fft) at phase 1's
    tolerances; returns the twins' peaks and PCM."""
    import torch

    from bigstitcher_spark_tpu_torch.ops import phasecorr as P

    _, X, Y, Z = (int(s) for s in a.shape)
    spectra = []
    for side, x, e in (("a", a, ea), ("b", b, eb)):
        w = P.pcm_window(x, e)
        check_close(w, P.pcm_window_plain(x, e), f"{what} K7 window {side}")
        f = P.rfftn3(w)
        check_fft(f, torch.fft.rfftn(w, dim=(1, 2, 3)),
                  f"{what} rfftn {side}")
        spectra.append(f)
        del w
    norm = P.pcm_cross_power(*spectra)
    check_close(norm, P.pcm_cross_power_plain(*spectra),
                f"{what} K9 cross power")
    del spectra
    pcm_ref = torch.fft.irfftn(norm, s=(X, Y, Z), dim=(1, 2, 3))
    check_fft(P.irfftn3(norm, Z), pcm_ref, f"{what} irfftn")
    del norm, pcm_ref
    peaks, pcm = P.pcm_peaks_plain(a, b, ea, eb, n_peaks, 0.25,
                                   return_pcm=True)
    check(torch.equal(P.pcm_peaks_topk(pcm, n_peaks), peaks),
          f"{what} K10 top-{n_peaks} of the twins' PCM: indices equal to "
          "the twin's")
    return peaks, pcm


def stitch_run(proj, ds, route, dev, card, launches, truth_px=None):
    """One ``stitching`` run through the CLI entry function on a copy of
    ``proj``'s XML; spies on the driver's stage and PCM calls keep every
    bucket's stacks, which are then held stage by stage against the plain
    twins on the card. With ``truth_px``, every pair with r > 0.5 must
    recover the true correction within that many pixels."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.cli.main import main
    from bigstitcher_spark_tpu_torch.io.spimdata import SpimData
    from bigstitcher_spark_tpu_torch.models import stitching as TS

    xml = os.path.join(os.path.dirname(proj.xml_path),
                       f"stitch_{ds.replace(',', '')}.xml")
    shutil.copy(proj.xml_path, xml)
    staged, buckets = [], []
    stage, peaks_batch = TS._stage_bucket, TS.pcm_peaks_batch

    def stage_spy(jobs, shp, device):
        staged.append((shp, jobs))
        return stage(jobs, shp, device)

    def peaks_spy(a, b, ea, eb, n_peaks, fade_frac):
        peaks = peaks_batch(a, b, ea, eb, n_peaks, fade_frac)
        buckets.append((*staged[-1], a, b, ea, eb, peaks))
        return peaks

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    TS._stage_bucket, TS.pcm_peaks_batch = stage_spy, peaks_spy
    try:
        run = counted(route, launches, dev, lambda: main(
            ["stitching", "-x", xml, "-ds", ds, "--device", str(dev)]))
    finally:
        TS._stage_bucket, TS.pcm_peaks_batch = stage, peaks_batch
    st, t = run.stats, run.stats.timings
    print(f"  [stitching {route}] {card}: {st.pairs} pairs in {st.buckets} "
          f"buckets, wall {st.seconds:.3f}s -> {st.pairs / st.seconds:.3f} "
          f"pairs/s, {st.fft_voxels / st.seconds:,.0f} padded FFT voxels/s; "
          f"host extract {t['extract']:.3f}s stage {t['stage']:.3f}s launch "
          f"{t['launch']:.3f}s wait {t['wait']:.3f}s refine "
          f"{t['refine']:.3f}s; card busy {t['device']:.4f}s, idle share "
          f"{1 - t['device'] / st.seconds:.4f}", flush=True)
    check(st.pairs == len(run.results) > 0 and len(buckets) == st.buckets,
          f"stitching {route}: {len(run.results)} pairs computed in "
          f"{len(buckets)} buckets")
    if dev.type == "cuda":
        # the in-flight window charges a bucket 4x its float32 a+b stacks
        peak = torch.cuda.max_memory_allocated() - base
        held = sum(a.numel() * a.element_size() * 2 for _s, _j, a, *_r
                   in buckets)
        charge = max(2 * a.numel() * 4 * TS._FFT_WORKSPACE_MULT
                     for _s, _j, a, *_r in buckets)
        print(f"  [stitching {route}] {card}: device memory peak "
              f"{peak / 1e6:.1f} MB over the run's start ({held / 1e6:.1f} "
              f"MB of it the stacks kept for the checks); largest bucket "
              f"charge {charge / 1e6:.1f} MB", flush=True)

    params = TS.StitchingParams(downsampling=tuple(
        int(v) for v in ds.split(",")))
    by_key = {r.pair_key: r for r in run.results}
    for shp, jobs, a, b, ea, eb, peaks in buckets:
        what = f"stitching {route} bucket {shp} x {len(jobs)}"
        check(tuple(a.shape[1:]) == tuple(shp),
              f"{what}: the stacks are the staged bucket's")
        ref, pcm = check_bucket(what, a, b, ea, eb, params.peaks_to_check)
        got, ref = peaks.cpu().numpy(), ref.cpu().numpy()
        ties = []
        for k, i in zip(*np.nonzero((got != ref).any(axis=2))):
            vg = float(pcm[k][tuple(int(v) for v in got[k, i])])
            vr = float(pcm[k][tuple(int(v) for v in ref[k, i])])
            ties.append(abs(vg - vr) <= 1e-4 * max(abs(vg), abs(vr)))
        check(all(ties), f"{what}: kernel peaks equal the twins' on the "
              f"card ({len(ties)} near-tie swaps)")
        del pcm
        for tw in TS._refine_bucket(None, jobs, shp, ref, params):
            m = by_key[tw.pair_key]
            check(np.array_equal(m.transform, tw.transform)
                  and m.correlation == tw.correlation,
                  f"stitching {route} {tw.views_a[0]}<->{tw.views_b[0]}: "
                  f"shift {np.round(m.transform[:, 3], 3)} r "
                  f"{m.correlation:.4f} equal to the twins' refinement")
    if truth_px is not None:
        def corr(s):
            return (np.asarray(proj.true_offsets[s])
                    - np.asarray(proj.nominal_offsets[s])
                    - np.asarray(proj.appended[s])[:, 3])
        good = 0
        for r in run.results:
            if r.correlation > 0.5:
                want = corr(r.views_a[0].setup) - corr(r.views_b[0].setup)
                e = float(np.abs(r.transform[:, 3] - want).max())
                check(e <= truth_px, f"stitching {route} {r.views_a[0]}<->"
                      f"{r.views_b[0]} r {r.correlation:.3f}: |shift - "
                      f"truth| {e:.3f} <= {truth_px} px")
                good += 1
        check(good >= 4, f"stitching {route}: {good} pairs with r > 0.5")
    saved = SpimData.load(xml).stitching_results
    check(len(saved) == len(run.kept) and (truth_px is None or saved)
          and all(r.hash != 0.0 for r in saved.values()),
          f"stitching {route}: the XML reloads with {len(saved)} results "
          f"(kept {len(run.kept)}), nonzero hashes")
    return run


def phase6_stitching(proj_a, proj_c, dev, card, launches):
    print("phase 6 (stitching)", flush=True)
    stitch_run(proj_a, "2,2,1", "S 2,2,1", dev, card, launches, 1.5)
    stitch_run(proj_a, "1,1,1", "S 1,1,1", dev, card, launches, 0.75)
    stitch_run(proj_c, "2,2,1", "S rendered", dev, card, launches)


def main_path(work, scale, dev, card, launches):
    """Phases 2-6 through the CLI entry functions; returns route A's XML
    and container paths."""
    a = route_a(work, scale, dev, card, launches)
    route_b(work, scale, dev, card, launches, a)
    proj_c = route_c(work, scale, dev, card, launches)
    route_d(work, scale, dev, card, launches, a)
    phase6_stitching(a[0], proj_c, dev, card, launches)
    return a[0].xml_path, a[1]


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default); cpu rehearses without a result")
    ap.add_argument("--scale", choices=sorted(SCALES), default="full")
    args = ap.parse_args(argv)
    # projects and containers live inside the checkout, removed at the end
    work = os.path.join(ROOT, "smoke_work")

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        from bigstitcher_spark_tpu_torch.ops import _cuda
    except ImportError as e:
        print(f"error: the port is not importable next to chip_smoke.py "
              f"({e})", file=sys.stderr)
        return 2

    os.makedirs(work, exist_ok=True)
    launches: dict = {}
    try:
        if args.device == "cpu":
            torch.set_num_threads(1)
            cpu = torch.device("cpu")
            print("rehearsal on the CPU: plain twins, no kernels", flush=True)
            phase1_kernels(cpu, args.scale, "cpu")
            composite_at_route_a(*main_path(work, args.scale, cpu, "cpu",
                                            launches), cpu)
            print("rehearsal finished; no result on the CPU", file=sys.stderr)
            return 3
        dev = torch.device("cuda", 0)
        card = card_line()
        print(f"phase 0: card {card}", flush=True)
        t0 = time.time()
        took = _cuda.build_all()
        print(f"  built {sorted(took)} in {time.time() - t0:.1f}s "
              "(nvcc, in parallel)", flush=True)
        for name in _cuda.SOURCES:
            regs = [ln.strip() for ln in _cuda.ptxas_report(name).splitlines()
                    if "registers" in ln]
            print(f"  {name}: {'; '.join(regs)[:300]}")
        print(f"phase 1: kernels vs plain twins [{card}]", flush=True)
        res = phase1_kernels(dev, args.scale, card)

        route = main_path(work, args.scale, dev, card, launches)
        print(f"main path launches (routes A-D, stitching): {launches}",
              flush=True)
        # K1 runs once per run of route A, on the whole volume: its line
        # reports that shape, with the compute-block numbers beside it
        block = res["composite_fuse"]
        res["composite_fuse"] = {
            **composite_at_route_a(*route, dev),
            **{f"block_{k}": v for k, v in block.items()}}
        print_times("composite_fuse at route A's shape",
                    res["composite_fuse"], card)
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = []
    for name, (cu, jax_line) in KERNELS.items():
        r = res[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"bigstitcher_spark_tpu_torch/csrc/{cu}",
            "replaces": f"bigstitcher_spark_tpu/{jax_line}",
            "launches": launches[name], "max_abs_err": r["err"],
            "ms": r["ms"], "wrapper_ms": r["wrapper_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r.get("library_ms"),
            **({"block_ms": r["block_ms"],
                "block_wrapper_ms": r["block_wrapper_ms"],
                "block_plain_ms": r["block_plain_ms"],
                "block_bound_ms": r["block_bound"][0],
                "block_max_abs_err": r["block_err"]}
               if "block_ms" in r else {}),
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
