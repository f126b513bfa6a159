#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phase 0  prints the card (nvidia-smi name, power limit) and builds the four
         fusion kernels from csrc/ (one nvcc per source, all at once).
Phase 1  holds each kernel (K1 composite, K2 shift, K3 gather, K4 convert)
         against its plain-torch twin on the card at the per-block routes'
         compute-block size (256x256x64, 4 views, sub-pixel fractions, a
         rotated affine, samples outside the tile), and times both with
         CUDA events.
Phase 2  route A, composite: a synthetic 2x2x1 project of 1024x1024x128
         uint16 tiles (the 2x2-binned frame of a 2048^2 sCMOS light-sheet
         camera; ~10 % overlap, sub-pixel translations, N5 raw in
         128x128x64 blocks) goes through the port's own CLI entry functions,
         create-fusion-container (OME-ZARR, UINT16, raw) then affine-fusion,
         with the device budget raised so the composite route runs.
         The one cut is z depth: 128 planes instead of hundreds.
Phase 3  route B, per-block shift: the same project at the default budget,
         which the composite route does not fit (1 GiB + 12 B x 485 M
         voxels > 4e9). Its output must equal route A within |delta| <= 1.
Phase 4  route C, gather: a 2x1x1 project (1024x1024x64) with one view
         rotated 3 degrees about z.

In phases 2-4 three written compute blocks (one at the four-tile corner)
are held against the plain-torch twins run on the card, and the host-read,
H2D, kernel, D2H and write times and the fused voxels/s are printed beside
the card's name and power limit. The launch counts of every kernel are
set to 0 just before phase 2 and read just after phase 4: a kernel of the
path launched no time fails the run. K1 then runs again, timed and held
against its twin, on route A's whole volume: the one shape the main path
gives it. The second-to-last line of output
is the kernels' JSON record; the last is {"ok": true, "device": ...}.
Any failure exits non-zero and prints no result.

``--device cpu --scale tiny`` rehearses phases 1-4 on the CPU with the
plain twins (no kernels, no timings); it then exits 3 without a result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
ROOT = os.path.dirname(os.path.abspath(__file__))
JAX_FUSION = "bigstitcher_spark_tpu/ops/fusion.py"
# flops per (view, voxel) and per voxel, counted from the kernel sources;
# a cosf counts as one operation
OPS = {"composite_view": 40, "composite_final": 6, "shift": 40,
       "gather": 92, "convert": 5}

SCALES = {
    "full": dict(tile=(1024, 1024, 128), overlap=102, block=(128, 128, 64),
                 rot_tile=(1024, 1024, 64), beads=400, per_block_budget=None),
    # the default budget fits tiny volumes: force the per-block routes
    "tiny": dict(tile=(96, 80, 24), overlap=12, block=(32, 32, 16),
                 rot_tile=(96, 80, 16), beads=20, per_block_budget=1),
}
BLOCK_SCALE = (2, 2, 1)       # affine-fusion's default --blockScale
COMPOSITE_BUDGET = int(40e9)  # BST_DEVICE_TILE_BUDGET that fits route A


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


def print_times(what, r):
    print(f"  {what}: max|delta| {r['err']:.3g}  kernel {r['ms']} ms  "
          f"wrapper {r['wrapper_ms']} ms  plain {r['plain_ms']} ms  "
          f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]})", flush=True)


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


def phase1_kernels(dev, scale):
    """Each kernel against its plain twin on the same card inputs."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import fusion as F

    rng = np.random.default_rng(2024)
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
    for k, r in res.items():
        print_times(k, r)
    return res


# ---------------------------------------------------------------- phases 2-4


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


def run_cli(xml, out, scale, device, budget=None):
    from bigstitcher_spark_tpu_torch.cli.main import main

    cfg = SCALES[scale]
    main(["create-fusion-container", "-x", xml, "-o", out, "-s", "ZARR",
          "-d", "UINT16", "-c", "raw", "--blockSize",
          ",".join(str(b) for b in cfg["block"])])
    with tile_budget(budget):
        (stats,) = main(["affine-fusion", "-o", out, "--device", device])
    return stats


def read_volume(out):
    from bigstitcher_spark_tpu_torch.io.chunkstore import ChunkStore

    return ChunkStore.open(out).open_dataset("0").read_full()[..., 0, 0]


def report(stats, card, label):
    t = stats.timings
    print(f"  [{label}] {card}: path={stats.path} kernels={stats.kernel_blocks}"
          f" host-read {t['read']:.3f}s h2d {t['h2d']:.3f}s kernel "
          f"{t['kernel']:.3f}s d2h {t['d2h']:.3f}s write {t['write']:.3f}s "
          f"total {stats.seconds:.3f}s -> "
          f"{stats.voxels / max(stats.seconds, 1e-9):,.0f} fused voxels/s",
          flush=True)


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
        np.asarray(b.offset) + np.asarray(b.size) / 2 - c).sum())
    return meta, [("first", grid[0]), ("tile corner", corner),
                  ("last", grid[-1])]


def plain_block(sd, loader, meta, block, compute_block, dev):
    """A compute block through the plain twins on ``dev`` (no kernels)."""
    import torch

    from bigstitcher_spark_tpu_torch.models import affine_fusion as A
    from bigstitcher_spark_tpu_torch.ops import fusion as F

    staged = A.stage_block(sd, loader, sd.view_ids(), block, meta.bbox,
                           compute_block, A.BlendParams(), None, (0.0,) * 3)
    *ins, ioffs = [torch.from_numpy(a).to(dev) for a in staged.arrays]
    fn = (F.fuse_block_shift_plain if staged.kind == "shift"
          else F.fuse_block_plain)
    fused, _w = fn(*ins, staged.shape, "AVG_BLEND", ioffs)
    out = F.convert_intensity_plain(fused, 0.0, 65535.0, "uint16")
    sl = tuple(slice(0, s) for s in block.size)
    return out.cpu().numpy()[sl], staged.kind


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


def main_path(work, scale, dev, card):
    """Phases 2-4 through the CLI entry functions; returns route A's XML
    and container paths."""
    from bigstitcher_spark_tpu_torch.io.dataset_io import ViewLoader
    from bigstitcher_spark_tpu_torch.io.spimdata import SpimData
    from bigstitcher_spark_tpu_torch.ops import fusion as F

    cfg = SCALES[scale]
    compute_block = compute_block_of(scale)
    print("phase 2 (route A, composite)", flush=True)
    print(f"  cut: z depth {cfg['tile'][2]} planes (scale {scale})")
    proj = make_project(os.path.join(work, "p4"), scale, (2, 2, 1),
                        cfg["tile"], False, seed=7)
    out_a = os.path.join(work, "route_a.ome.zarr")
    stats_a = run_cli(proj.xml_path, out_a, scale, str(dev),
                      budget=COMPOSITE_BUDGET)
    report(stats_a, card, "route A")
    check(stats_a.path == "composite", "route A took the composite route")
    vol_a = read_volume(out_a)
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

    print("phase 3 (route B, per-block shift)", flush=True)
    out_b = os.path.join(work, "route_b.ome.zarr")
    stats_b = run_cli(proj.xml_path, out_b, scale, str(dev),
                      budget=cfg["per_block_budget"])
    report(stats_b, card, "route B")
    check(stats_b.path == "per-block" and stats_b.kernel_blocks["shift"] > 0,
          "route B took the per-block shift route")
    vol_b = read_volume(out_b)
    err = max_abs_u16(vol_a, vol_b, dev)
    check(err <= 1, f"route B equals route A within |delta| {err} <= 1")
    check_blocks("route B", vol_b, lambda b: plain_block(
        sd, loader, meta, b, compute_block, dev)[0], blocks)
    del vol_a, vol_b

    print("phase 4 (route C, gather)", flush=True)
    proj_c = make_project(os.path.join(work, "p2"), scale, (2, 1, 1),
                          cfg["rot_tile"], True, seed=11)
    out_c = os.path.join(work, "route_c.ome.zarr")
    stats_c = run_cli(proj_c.xml_path, out_c, scale, str(dev),
                      budget=cfg["per_block_budget"])
    report(stats_c, card, "route C")
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
    return proj.xml_path, out_a


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
        from bigstitcher_spark_tpu_torch.ops import fusion as F
    except ImportError as e:
        print(f"error: the port is not importable next to chip_smoke.py "
              f"({e})", file=sys.stderr)
        return 2

    os.makedirs(work, exist_ok=True)
    try:
        if args.device == "cpu":
            torch.set_num_threads(1)
            cpu = torch.device("cpu")
            print("rehearsal on the CPU: plain twins, no kernels", flush=True)
            phase1_kernels(cpu, args.scale)
            composite_at_route_a(*main_path(work, args.scale, cpu, "cpu"),
                                 cpu)
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
        res = phase1_kernels(dev, args.scale)

        F.reset_launch_counts()
        route_a = main_path(work, args.scale, dev, card)
        launches = F.launch_counts()
        print(f"main path launches: {launches}", flush=True)
        for k, n in launches.items():
            check(n > 0, f"kernel {k} launched {n} times on the main path")
        # K1 runs once per run of route A, on the whole volume: its line
        # reports that shape, with the compute-block numbers beside it
        block = res["composite_fuse"]
        res["composite_fuse"] = {
            **composite_at_route_a(*route_a, dev),
            **{f"block_{k}": v for k, v in block.items()}}
        print_times("composite_fuse at route A's shape",
                    res["composite_fuse"])
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)

    src = {"composite_fuse": ("composite.cu", 524),
           "fuse_block_shift": ("shift.cu", 337),
           "fuse_block": ("gather.cu", 154),
           "convert_intensity": ("convert.cu", 648)}
    kernels = []
    for name, (cu, line) in src.items():
        r = res[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"bigstitcher_spark_tpu_torch/csrc/{cu}",
            "replaces": f"{JAX_FUSION}:{line}",
            "launches": launches[name], "max_abs_err": r["err"],
            "ms": r["ms"], "wrapper_ms": r["wrapper_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None,
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
