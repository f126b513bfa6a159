#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phase 0  prints the card (nvidia-smi name, power limit) and builds the
         kernels from csrc/ (one nvcc per source, all seventeen at once).
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
         path; rows only 2-byte aligned), bitwise and timed the same way;
         and K6's one-axis float32 form
         (halfpixel_downsample2x_axis) along each axis of a route-A tile
         (1024x1024x128 uint16), bitwise against its twin, beside
         avg_pool3d with a window of 2 on that axis. The batch forms of
         K2, K3 and K5 at 16 rows of their per-block inputs (route A's
         batch at --devices 4, per_dev 4): every row bitwise the per-block
         kernel's, one launch timed (K2 bitwise its twin, per block at
         every fusion type and at 16 rows); K28 (block_epilogue) on K2's batch
         output with route A's first level (2,2,2), s0 and level bitwise
         its twin's in both modes (conversion, masks). K26's batch form
         at 4 distinct rows of phase 11's four-view block (synthesised
         from a seed): every row bitwise the per-block K26, |batch - twin|
         within the per-block contract, one launch timed beside 4 x the
         per-block time and its bound. The
         phase-correlation kernels at route A's x-edge
         bucket at -ds 2,2,1 (2 pairs of 64x512x128 uint16 crops): K7
         window and K9 cross power (rtol 1e-5 / atol 1e-6), K8 FFT
         (max|delta| <= 2e-5 x max|X| per pair against torch.fft, whose
         rfftn + irfftn is its library yardstick; its six passes timed
         alone too), K10 top-k (indices equal to the twin's at n = 5 and
         n = 256, and at both on a PCM of one maximum a pair, fewer than
         n: the -inf fill by ascending index; timed at n = 5 and 256).
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
         indices equal to the twin's top-k (and K10 timed at each
         bucket). The kernels' peaks must equal
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
Phase 7  the solver through the port's CLI entry function. 7a: solver -s
         STITCHING on a copy of the XML phase 6's -ds 2,2,1 run wrote
         (4 tiles, 6 links): every tile within 1.5 px of the truth, up to
         the fixed tile. 7b, grid G (utils/solverdata.py, no image data):
         32x32x4 tiles of 2048x2048x512, 11,008 stitching links (176,128
         rows), 8 of them 25 px wrong, --method ONE_ROUND_ITERATIVE:
         exactly the 8 dropped, every tile within 0.05 px; then the same
         iterative solve through the twins on the card, every solve under
         the JAX package's device-vs-numpy contract (iterations equal,
         history rtol 1e-9 / atol 1e-9, models and link errors rtol 1e-7
         / atol 1e-9) and the same drop sequence. 7c, the IP cell: 16x16x2
         views with rigid truth, 500 bead correspondences a 6-neighbour
         pair (1,216,000 rows) in interestpoints.n5, -s IP -l beads -tm
         AFFINE -rm RIGID --lambda 0.1: the final error below --maxError
         and below the pre-solve error; the kernels against the twins at
         --maxIterations 100 under the same contract; 10 sweeps of
         --solverBackend numpy on the host. K11-K14 alone against their
         twin stages at 7b's and 7c's shapes (rtol 1e-10 / atol 1e-12, the
         rtol of the terms' magnitude where sums cancel), timed with CUDA
         events, and K13's fused form (K14 in its last block, the one
         device sweep's third launch) bitwise K13 then K14, timed beside
         that pair; each cell's wall split (match assembly, warm start,
         relax, store) and row-iterations/s.
Phase 8  detect-interestpoints through the port's CLI entry function on
         copies of route A's XML (4 views of 1024x1024x128 uint16, 400
         beads a tile, level 0 only). 8a, the reference defaults -l beads
         -s 1.8 -t 0.008 -dsxy 2 -dsz 1: rel (2,2,1), so K6 pools each
         1056x1056x144 raw block (core 512x512x128, halo 8) on the card,
         batches of 2. 8b, -dsxy 1 -dsz 1: 16 uint16 blocks whose halos
         cross block boundaries, no K6. 8c, 8a with --overlappingOnly and
         --blockSize 192,192,128 (at the default block each view's overlap
         region is one block): uneven edge blocks, several buckets. A spy keeps the first batch
         of every bucket, and there K6 and each of K15's six blur passes
         must equal their twins bitwise, K16's response bitwise with equal
         candidate sets and counts, K17's indices and flags equal to its
         twin's and its index set equal to torch.topk's on the dense score,
         at the run's k and at half the largest block's count (the
         truncation path),
         K18 within 1e-5 px / rtol 1e-6, and the run's outputs equal the
         twins' program. Gates from the reference's own tests: at 8b each
         view detects at least 0.7 of the true beads 6 px inside it, and
         more than 0.8 of those have a detection within 1 px; more than
         0.7 of 8a's points lie within 1.5 px of an 8b point; every 8c
         point lies in an overlap box; interestpoints.n5 read back equals
         each run's points and the XML registers the label. Each run
         prints its wall, det-res voxels/s (core voxels over the wall, host
         IO included) and the split (min/max, read, H2D, kernels by CUDA
         events, D2H, host tail, store). K15-K18 are timed at 8a's bucket
         beside their bounds (K15 also each of its six passes alone), K17
         beside torch.topk on the dense score and on the candidate list's
         scores, and at half the largest block's count (truncated).
         8d, 8a's arguments through detect_interest_points with
         extract_descriptors (K15-K18, then K19's masked form on each
         block's 4,096 candidate slots): points and values identical to
         8a's, every batch's descriptors and flags bitwise K19's twin's on
         the same candidates, riders for every point, and K20's ratio test
         (9a's ratio 3.0) on the riders of route A's six view pairs
         joining the same true bead (< 5 px) for at least 0.7 of its
         candidates (garbage descriptors give ~0); the masked K19 timed at
         8a's bucket.
Phase 9  match-interestpoints through the port's CLI entry function. 9a:
         a copy of route A's XML with 8b's points, at the reference
         defaults (FAST_ROTATION, -n 3 -r 1, -s 3.0, AFFINE regularised
         by RIGID with lambda 0.1, -rit 10000 -rme 5 -rmir 0.1 -rmni 12),
         then solver -s IP -l beads. Gates from the JAX package's tests
         (tests/test_matching.py:141-215): every stored link joins the
         same true bead within 5 px, median below 1 px, at least 20
         checked, each stored on both views; the solve's error below 1 px
         and the tiles placed within 1 px of the truth. 9b: a nucleus-
         scale pair through models.matching.match_pair at the same
         defaults: 100,000 points uniform in a 4,000 px cube (the JAX
         package's soak size), B = R A + t (10 degrees about z) + N(0,
         0.05), 10 % of each side dropped and 10 % uniform extras added;
         the model within 0.1 px RMS of the truth on A's true points, and
         inliers at least 0.7 of the points both sides kept. 9c on route
         A: -m ICP --icpUseRANSAC on the XML 9a solved (K20's nearest
         mode, K21, K22; links within -ime 2.5 px of the same bead),
         --ransacMultiConsensus and -sr 10 (each stores links that join
         the same bead). K19-K22 are held against their twins
         on the card at 9a's first pair and at 9b (K19 and K20 on 8,192
         rows of A, K20 also on A's last 4,096 descriptor rows, its ragged
         last row block): K19 indices, descriptors and flags, K20 owners,
         flags and distances, K21 counts, models and best bitwise; K22
         masks and counts equal, models within rtol 1e-9. They are timed
         at 9b's shapes beside their bounds, K21 also at 9a's (K20's for
         the work of its
         TF32 filter and exact refine, beside the exact SIMT work's; the
         share of pairs its filter refined and B's mean alone printed); no
         single PyTorch call computes any of them (library none).
Phase 10 the intensity-correction chain through the port's CLI entry
         functions on route A's geometry (2x2x1 tiles of 1024x1024x128
         uint16, 102 px overlap, raw N5) built as the JAX intensity
         fixture is: smooth_field=600, no jitter, setup 1's s0 rescaled to
         clip(1.4 i + 30). 10a: match-intensities at the reference defaults
         (8,8,8 cells, renderScale 0.25, RANSAC 1000 iterations, epsilon
         0.02, minNumCandidates 1000); K23 held against its twin on every
         launch (every count and argmax bitwise, a and b within 1e-5); the
         fits between setup 1 and its neighbours map their cells' mean
         intensity within 1 % of 1.4 i + 30 (or its inverse). 10b: solve-intensities on 10a's matches,
         then a synthetic system on 7c's view grid (16x16x2 views of 8x8x8
         cells: 524,288 unknowns, 77,824 match rows, 688,128 smoothness
         pairs); each CG held against cg_plain on the card (rtol 1e-9,
         iterations within 1) and by its residual |Ax - b| / |b| <= 1e-9
         with A from scipy.sparse; K24/K25 timed alone, K24 beside torch's
         CSR product on the same int32 lists (torch.mv), both one launch
         at a time after a reset and back to back. 10c: affine-fusion --intensityN5 on the composite
         route (K1's coefficient branch; the whole volume within |delta|
         <= 1 of the twin on the card), the same without correction (the
         fused voxels/s of both), and forced per block (K3's branch + K4;
         three blocks against the twin, the volume within 1 of the
         composite's); then the JAX test's seam gate: a FIRST_WINS float32
         fuse_volume of a crop across the setup 0 / setup 1 seam, raw jump
         > 0.15 and corrected jump < raw / 3.
Phase 11 nonrigid-fusion through the port's CLI entry functions on route
         A's project at its uncorrected registrations (phase 9's XML
         before 9a's solve) with 9a's correspondences: create-fusion-
         container (OME-ZARR, UINT16, 128x128x64 blocks, --multiRes), then
         nonrigid-fusion at the reference defaults (-cpd 10, --alpha 1,
         AVG_BLEND, --blockScale 2,2,1) and its downsample stage. Blocks
         holding 1, 2 and 4 views are re-fused through K26's twin on the
         card (uint16 |delta| <= 1; bitwise expected); the four-view block
         with identity grids (no correspondence) through K26 and through
         K3 (|delta| <= 1); the JAX test's recovery gate on crops of the
         four pairwise overlaps with the port's DoG, over every bead 8 px
         inside exactly two tiles: no second detection within 4 px, each
         within 1.5 px of where the fitted warps place it, and within 1.5
         px of its truth plus the two views' mean registration error, at
         least 3 a crop. Beads missing the last (the fits extrapolate: an
         open fault of the method, which JAX's fusion shares) are printed
         as NOT met and counted. Prints fused voxels/s, the plan / read /
         H2D / kernel / D2H / write split, card busy seconds (CUDA events)
         and the idle share; K26 timed at the four-view block beside its
         twin and its bound (library none: grid_sample resamples one view
         by a flow field, without the 12-coefficient warp or the blend).
Phase 12 fuse_volume_scan (K27, then K4) through the API: route A's four
         tiles (1.07 GB uint16) resident on the card, route B's per-block
         plan (192 blocks of 256x256x64 with views, 4 slots each, K2's
         numbers through affine_fusion.shift_plan) as its arguments. The
         uint16 volume must lie within |delta| <= 1 of route B's s0
         (expected bitwise: the same K2 math; the scan's wrapped taps are
         weighed 0 where route B stages zeros); K27 and its masks mode
         bitwise equal to the twin on phase 2's picked blocks. Prints the
         upload, K27 + K4 seconds and fused voxels/s, and K27 timed on
         the whole plan beside the twin and its bound (library none).

Phase 13 affine-fusion --devices 4 through the CLI entry function: the
         sharded route on the one card (a one-device mesh; batches of 4 x
         per_dev blocks, one launch of K2's, K3's or K5's batch form and
         one of K28 a batch, one drain worker copying back and writing).
         13a: route A's project, --multiRes with --pyramid, into a
         container of 128x128x32 blocks fused at --blockScale 2,2,2 (route
         B's 256x256x64 compute block; at route A's 128x128x64 blocks
         level 1's (2,2,2) piece is half a chunk in z and no level is
         eligible): K28 makes level 1, the sharded downsample stage the
         rest; s0
         and every level bitwise equal to route B's. 13b: route C's
         project (gather and shift buckets), s0 bitwise route C's. 13c:
         route D's anisotropic N5 (K5's batch form), s0 bitwise route
         D's. 13d: 10c's corrected project with --intensityN5 (K3's batch
         form with its grids), s0 bitwise 10c per block's. Each prints
         the mesh, every bucket's blocks, per_dev and batches, the host
         read / H2D / kernel (CUDA events) / D2H / write seconds and the
         device memory peak; no per-block or composite kernel may launch.

Phase 14 the shard_jit routes at devices=4 on the one card (a one-device
         mesh, batches of 4 x per_dev rows, one drain worker): 14a
         detect_interest_points(devices=4) through the API on route A's
         project at 8a's parameters, then with 8d's descriptors, points,
         values (descriptors, flags) bitwise 8a's and 8d's; 14b
         nonrigid-fusion --devices 4 through the CLI entry function on
         phase 11's inputs (K26's batch form and K4 a batch, no per-block
         K26; its pyramid through the sharded downsample stage), s0 and
         every level bitwise phase 11's; 14c downsample_pyramid_level
         (devices=4) on route D's s0 into datasets of their own, each
         level bitwise route D's. Each prints the mesh, buckets, per_dev,
         batches, the wall, the read / H2D / kernel (CUDA events) / D2H /
         write seconds, the rate and the device memory peak; only the
         route's kernels may launch.

Phase 15 the sharded global solves on the solve mesh [card] * 4 (4 shards,
         one distinct device): 15a relaxes 7c's links (AFFINE + RIGID,
         lambda 0.1; 1,216,000 rows, above the default BST_SOLVE_SHARD) on
         one device and sharded, the sharded models, history, iterations
         and link errors bitwise the one-device ones; prints K11 / K13 a
         shard, K29, K12, K14 launches (K29 none a sweep, K14 none on one
         device), both walls and card seconds, and one sweep of each
         timed alone; K12's and K14's sharded forms (the shards' partials
         added as they load them) bitwise K29 then K12 / K14, timed beside
         those pairs; 15b solves 10b's large system
         (524,288 unknowns) with BST_SOLVE_SHARD=1 on the default mesh
         (one card: one device) and sharded, within rtol / atol 1e-8 of
         each other, the sharded CG against its twin loop and its
         residual. K29 (shard sum) alone at 15a's moments and at 15b's
         vectors (with the replicated part and p.Ap), bitwise its twin,
         beside torch.stack(...).sum(0) (+ torch.dot); K24's partial form
         at 15b's shard against its twin.

Kernel times are CUDA events around work queued behind a spin on the
card (its rate measured in the run), so they hold the card's time and not
the host's launch overhead. K8's and K24's wrapper times and their library
calls' are also taken without the spin (wrapper_ms, library_wrapper_ms),
the host's launch overhead included.
In phases 2-5 three written compute blocks (one at the four-tile corner)
are held against the plain-torch twins run on the card, and the host-read,
H2D, kernel, D2H and write times and the fused voxels/s (and the rate
counting pyramid voxels, apart) are printed beside the card's name and
power limit. Each route runs with every launch count set to 0 just before
it and read just after it: a kernel of that route launched no time fails
the run (phases 6, 7 and 8 count each stitching, solver and detection
run so). K1 then runs again, timed and held against its twin, on route A's
whole volume: the one shape the main path gives it; K1 is one launch a
composite (checked there), and the device memory one composite call
allocates at its peak is printed (the output and the tables: K1's first
form also held a float32 accumulator and weight sum of the whole volume,
4 GB at route A). K12 (the relax fits) runs its model and its
regulariser in two warps of a block at once. The second-to-last line
of output is the kernels' JSON record; the last is
{"ok": true, "device": ...}. Any failure exits non-zero and prints no
result.

``--device cpu --scale tiny`` rehearses phases 1-15 on the CPU with the
plain twins (no kernels, no timings; 9b at 2,000 points; 10a at 2,2,2
cells and renderScale 0.5, 10b's large system on 3x3x2 views; 8d's
ratio-test gate printed, not applied: its 32x32x16 blocks split each
view's neighbourhoods); it then exits 3 without a result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
# (counting an FMA as two operations: at one operation an instruction, as
# the kernels built with -fmad=false issue them, half of it)
F64_OPS_PER_S = 34e12         # H100 SXM float64 vector (not tensor core)
TF32_OPS_PER_S = 495e12       # H100 SXM TF32 tensor cores, dense
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
    "relax_moments": ("solve.cu", "ops/solve.py:308"),
    "relax_fit": ("solve.cu", "ops/solve.py:308"),
    "relax_error": ("solve.cu", "ops/solve.py:308"),
    "relax_converge": ("solve.cu", "ops/solve.py:308"),
    "relax_error_converge": ("solve.cu", "ops/solve.py:308"),
    "dog_blur": ("dog.cu", "ops/dog.py:61"),
    "dog_extrema": ("dog.cu", "ops/dog.py:164"),
    "dog_topk": ("dog.cu", "ops/dog.py:353"),
    "dog_localize": ("dog.cu", "ops/dog.py:259"),
    "knn_descriptors": ("descriptors.cu", "ops/descriptors.py:48"),
    "ratio_match": ("descriptors.cu", "ops/descriptors.py:208"),
    "ransac_score": ("ransac.cu", "ops/descriptors.py:380"),
    "ransac_refit": ("ransac.cu", "ops/descriptors.py:380"),
    "linefit_ransac": ("intensity.cu", "ops/intensity.py:36"),
    "cg_spmv": ("cg.cu", "ops/solve.py:527"),
    "cg_update": ("cg.cu", "ops/solve.py:527"),
    "shard_sum": ("shard.cu", "ops/solve.py:428"),
    "nonrigid_fuse": ("nonrigid.cu", "ops/nonrigid.py:133"),
    "nonrigid_fuse_batch": ("nonrigid.cu", "models/nonrigid_fusion.py:263"),
    "fuse_volume_scan": ("shift.cu", "ops/fusion.py:379"),
    "block_epilogue": ("epilogue.cu", "parallel/mesh.py:223"),
}
# the batch forms of K2, K3, K5 (one launch a bucket's batch on a device;
# the JAX sharded fuser's vmap, parallel/mesh.py:223): reported as fields
# of their per-block kernel's entry
BATCH_FORMS = {"fuse_block_shift": "fuse_block_shift_batch",
               "fuse_block": "fuse_block_batch",
               "fuse_block_sep": "fuse_block_sep_batch"}
BATCH_ROWS = 16  # route A's batch: --devices 4 x per_dev 4
# flops per (view, voxel) and per voxel, counted from the kernel sources;
# a cosf, floorf or rintf counts as one operation. K6 does one add per
# input voxel and ~10 operations per output voxel (divides, round, clamp).
# K7: a sum and 4 operations per voxel; K8: 2.5 N log2 N per real 3-D
# transform of N voxels; K9: 12 per complex bin (cross product, hypot,
# compare, 2 divides); K10: 27 comparisons per voxel (the sorts are the
# kernel's choice, not the function's work).
# K11: per row 1 multiply for w_eff, 15 for tw = M [q; 1], 35 products
# and 36 sums of the moments; K13: per row 2 x 15 for the two applies, 3
# differences, 5 for the squared norm, a sqrt, 3 for the weighted sums.
# K12 per tile (float64): the fit of each kind, plus 36 for the blend and
# 36 for the damped update; the rigid fit counts 6 Jacobi sweeps of 3
# rotations (~40 each) and the rest of the Kabsch fit, the affine one the
# 4x4 elimination with 3 right-hand sides and the back substitution (its
# time is the latency of the rigid fit's chain of float64 divides and
# square roots, which no count of operations shows). K1 per (view, voxel):
# 8 products and 8 sums of the corners, the x-y-z products of the inside
# test and blend ramp and the combine; per output voxel the finalize and
# conversion (two divides, the clamp and the rounding). K14:
# two sums per tile. K16: an add and a max per neighbour of the 27-voxel
# window of each voxel past the threshold (counted whole: the one-pass
# kernel stops at the first neighbour past the voxel, which could only
# lower an operations bound that bytes exceed); K18: per round of a candidate
# ~90 (gradient, Hessian, the pivoted 3x3 LU and solve, clip, value).
# K19: per pair of points 3 differences, 3 products, 2 sums; K20: per pair
# of descriptors of D values, D products and D - 1 sums (dot), 2 sums, a
# product and a max; K21: per hypothesis and candidate 18 for the apply,
# 3 differences, 5 for the squared norm and a compare; K22 (float64): per
# candidate the same 27 and 31 for the moments of an inlier (its grid's
# block partials, 22 adds a block, are the launch's, not counted; the mask
# alone, fit=False, the 27). K23: per
# hypothesis and sample a multiply and an add (the prediction), a
# subtract, an absolute value, a compare and the valid test. K1's
# coefficient branch: what the separable function needs per voxel, the z
# lerp of 2 channels (4 each) and the apply (2); its x and y stages are
# shared by a column (the kernel's choice to redo them per voxel is not
# counted). K3's: the grid coordinate (18), floor and clip (~15), 2
# channels x 8 corners x 3 products, their sums and the apply (~65). K26
# per (view, voxel): the z lerp of 12 coefficients (36), the deform and
# the view affine (18 each), the sample (~40: floor, fractions, 8 corner
# products, their sum), the level position, inside test, blend and combine
# (~38); the grid taps and the x and y lerps are shared by a z column and
# not counted.
OPS = {"composite_view": 40, "composite_final": 6, "shift": 40,
       "gather": 92, "convert": 5, "sep": 60, "downsample_in": 1,
       "downsample_out": 10, "window": 5, "fft": 2.5, "cross": 12,
       "topk": 27, "relax_moments": 87, "relax_error": 42,
       "relax_converge": 2,
       "fit": {"IDENTITY": 0, "TRANSLATION": 6, "AFFINE": 110,
               "RIGID": 900, "NONE": 0}, "fit_blend": 72,
       "dog_window": 54, "dog_fit": 90, "knn_pair": 8, "ransac_apply": 27,
       "refit_row": 58, "linefit": 6, "coeff_k1": 10, "coeff_k3": 100,
       "nonrigid": 150}
# bytes a relax row holds: p, q (2 x 24), other, link_id (2 x 4), w (8)
RELAX_ROW_BYTES = 64

SCALES = {
    "full": dict(tile=(1024, 1024, 128), overlap=102, block=(128, 128, 64),
                 rot_tile=(1024, 1024, 64), beads=400, per_block_budget=None,
                 level_shape=(1952, 1952, 132), batch_box=(256, 256, 128),
                 sep_patch=(288, 288, 128), levels_a=5,
                 batch_box_d=(256, 256, 45), pcm_bucket=(2, 64, 512, 128),
                 pcm_bucket_6=(2, 128, 1024, 256),
                 grid_g=(32, 32, 4), grid_bad=8, ip_grid=(16, 16, 2),
                 ip_pairs=500, solve_tile=(2048, 2048, 512), det_block=None,
                 det_block_c=(192, 192, 128), cloud=100_000,
                 cloud_extent=4000.0, twin_rows=8192, intensity_args=[]),
    # the default budget fits tiny volumes: force the per-block routes
    "tiny": dict(tile=(96, 80, 24), overlap=24, block=(32, 32, 16),
                 rot_tile=(96, 80, 16), beads=20, per_block_budget=1,
                 level_shape=(180, 148, 26), batch_box=(64, 64, 32),
                 sep_patch=(96, 96, 24), levels_a=2,
                 batch_box_d=(64, 64, 9), pcm_bucket=(2, 16, 64, 32),
                 pcm_bucket_6=(2, 32, 64, 32),
                 grid_g=(8, 8, 2), grid_bad=2, ip_grid=(3, 3, 2),
                 ip_pairs=30, solve_tile=(256, 256, 64),
                 det_block=(32, 32, 16), det_block_c=(32, 32, 16),
                 cloud=2000, cloud_extent=1100.0, twin_rows=512,
                 intensity_args=["--coefficients", "2,2,2", "--renderScale",
                                 "0.5"]),
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
# one device: K13 with K14 in its last block, K13 alone for the link
# errors; sharded: K14's sharded form, K29 for the origins and link errors
RELAX_KERNELS = ("relax_moments", "relax_fit", "relax_error",
                 "relax_error_converge")
SHARDED_RELAX_KERNELS = ("relax_moments", "relax_fit", "relax_error",
                         "relax_converge", "shard_sum")
DET_KERNELS = ("dog_blur", "dog_extrema", "dog_topk", "dog_localize")
MATCH_KERNELS = ("knn_descriptors", "ratio_match", "ransac_score",
                 "ransac_refit")
ROUTE_KERNELS.update({
    "S 2,2,1": PCM_KERNELS + ("downsample_batch",),
    "S 1,1,1": PCM_KERNELS,
    "S rendered": PCM_KERNELS + ("fuse_block",),
    "7a": RELAX_KERNELS, "7b": RELAX_KERNELS, "7c": RELAX_KERNELS,
    "8a": DET_KERNELS + ("downsample_batch",),
    "8a again": DET_KERNELS + ("downsample_batch",), "8b": DET_KERNELS,
    "8c": DET_KERNELS + ("downsample_batch",),
    "9a": MATCH_KERNELS, "9a solver": RELAX_KERNELS, "9b": MATCH_KERNELS,
    "9c ICP": ("ratio_match", "ransac_score", "ransac_refit"),
    "9c multi-consensus": MATCH_KERNELS,
    "9c search radius": MATCH_KERNELS,
    "10a": ("linefit_ransac",),
    "10b": ("cg_spmv", "cg_update"), "10b large": ("cg_spmv", "cg_update"),
    "10c composite": ("composite_fuse", "composite_fuse+coeff"),
    "10c uncorrected": ("composite_fuse",),
    "10c per-block": ("fuse_block", "fuse_block+coeff", "convert_intensity"),
    "11": ("nonrigid_fuse", "convert_intensity", "downsample_batch"),
    "8d": DET_KERNELS + ("downsample_batch", "knn_descriptors"),
    "12": ("fuse_volume_scan", "convert_intensity"),
    "13a": ("fuse_block_shift_batch", "block_epilogue", "downsample_batch"),
    "13b": ("fuse_block_batch", "fuse_block_shift_batch", "block_epilogue"),
    "13c": ("fuse_block_sep_batch", "block_epilogue"),
    "13d": ("fuse_block_batch", "fuse_block_batch+coeff", "block_epilogue"),
    "14a": DET_KERNELS + ("downsample_batch",),
    "14a desc": DET_KERNELS + ("downsample_batch", "knn_descriptors"),
    "14b": ("nonrigid_fuse_batch", "convert_intensity", "downsample_batch"),
    "14c": ("downsample_batch",),
    "15a one device": RELAX_KERNELS, "15a": SHARDED_RELAX_KERNELS,
    "15b one device": ("cg_spmv", "cg_update"),
    "15b": ("cg_spmv_partial", "shard_sum", "cg_update"),
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


_SPIN_RATE = []  # torch.cuda._sleep's cycles a second, measured once


def spin(seconds):
    """Hold the card's stream busy for about ``seconds``: torch.cuda._sleep
    at its rate on this card, measured on the first call (a 1e7-cycle spin
    between CUDA events)."""
    import torch

    if not _SPIN_RATE:
        torch.cuda._sleep(1000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(10_000_000)
        b.record()
        torch.cuda.synchronize()
        _SPIN_RATE.append(1e7 / (a.elapsed_time(b) / 1e3))
    torch.cuda._sleep(max(int(seconds * _SPIN_RATE[0]), 1))


def _timed(fn, calls, spin_s):
    """``calls`` calls of ``fn`` between two CUDA events, behind a spin of
    ``spin_s`` seconds (none if 0): (card ms, host seconds to enqueue the
    calls, whether the card was still spinning when they were queued)."""
    import torch

    if spin_s:
        spin(spin_s)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_s = time.perf_counter() - t0
    b.record()
    queued = not a.query()
    torch.cuda.synchronize()
    return a.elapsed_time(b), host_s, queued


def _queued(fn, calls, spin_s, host, reset=None):
    """:func:`_timed`, once more (after ``reset()``) behind a longer spin
    (at most 50 ms) if the host enqueued more slowly than the spin ran;
    card ms and the spin used. ``host``: no spin, so the events also hold
    whatever time the card waited for the host."""
    if host:
        return _timed(fn, calls, 0.0)[0], spin_s
    ms, host_s, queued = _timed(fn, calls, spin_s)
    if not queued and spin_s < host_s and spin_s < 0.05:
        spin_s = min(2 * host_s, 0.05)
        if reset is not None:
            reset()
        ms = _timed(fn, calls, spin_s)[0]
    return ms, spin_s


def time_ms(fn, reps=20, rounds=3, host=False):
    """Milliseconds per call of ``fn`` on the card: ``reps`` calls back to
    back between two CUDA events, median over ``rounds`` (after a warm-up
    call). A spin on the card precedes the first event, twice as long as
    the host took to enqueue the warm-up call ``reps`` times (at most 50
    ms), and longer if the host fell behind it, so the calls queue up and
    run back to back: the events time the card's work, not the host's
    launch overhead (a call that waits for the card inside, as a twin may,
    still counts the host's time). ``host``: no spin, the events also hold
    the card's waits for the host (a wrapper's time as its caller sees
    it). None in a CPU rehearsal."""
    import torch

    if not torch.cuda.is_available():
        return None
    t0 = time.perf_counter()
    fn()
    spin_s = min(2 * reps * (time.perf_counter() - t0), 0.05)
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        ms, spin_s = _queued(fn, reps, spin_s, host)
        out.append(ms / reps)
    return sorted(out)[len(out) // 2]


def bound(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def time_each(fn, reset, reps=50, host=False):
    """Milliseconds of one call of ``fn`` on the card, each call alone
    between two CUDA events with ``reset()`` run before it, outside the
    events (for kernels that change their own inputs); the median. A spin
    on the card precedes the first event, twice as long as the host took to
    enqueue the first (discarded) call (at least 0.1 ms) and longer if the
    host fell behind it, so the events time the card's work, not the host's
    launch overhead. ``host``: no spin, as :func:`time_ms`. None in a CPU
    rehearsal."""
    import torch

    if not torch.cuda.is_available():
        return None
    reset()
    t0 = time.perf_counter()
    fn()
    spin_s = min(max(2 * (time.perf_counter() - t0), 1e-4), 0.05)
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        reset()
        ms, spin_s = _queued(fn, 1, spin_s, host, reset)
        out.append(ms)
    out.sort()
    return out[len(out) // 2]


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


def gather_inputs(rng, c, bs, V, dims, borders, ranges, valid, about="z"):
    """K3's phase-1 inputs, the wrapper's first seven arguments: V uint16
    patches of the block + 32, block -> patch affines rotated about
    ``about`` (view 1 by 7 degrees, the others within 1; z: translations
    and rotations about z, K3's separable form, as every view of the main
    path; y: its general form, as views of a multi-angle acquisition) with
    translations that reach past the patch, patch offsets in [0, 50)."""
    import numpy as np

    ps = tuple(s + 32 for s in bs)
    patches = c(rng.integers(90, 4000, (V, *ps)).astype(np.uint16))
    aff = np.zeros((V, 3, 4), np.float32)
    for v in range(V):
        a = np.deg2rad(7.0 if v == 1 else rng.uniform(-1, 1))
        cs, sn = np.cos(a), np.sin(a)
        aff[v, :3, :3] = ([[cs, -sn, 0], [sn, cs, 0], [0, 0, 1]]
                          if about == "z" else
                          [[cs, 0, sn], [0, 1, 0], [-sn, 0, cs]])
        aff[v, :, 3] = rng.uniform(-12, 40, 3)
    offs = rng.uniform(0, 50, (V, 3)).astype(np.float32)
    return [patches] + [c(a) for a in (aff, offs, dims, borders, ranges,
                                       valid)]


def resample_form(F, bs, V, pshape) -> str:
    """K3's and K26's launch at a shape (``ops.fusion.resample_plan``), or
    the first form's on a tree without it."""
    if not hasattr(F, "resample_plan"):
        return "one thread a voxel (the first form)"
    p = F.resample_plan(bs, V, pshape)
    return (f"R {F.RESAMPLE_R} z outputs a thread, tile {p.tile} "
            f"({p.lanes_z} lanes a column), grid {p.grid}, {p.view_chunks} "
            f"view chunk(s) of {F.RESAMPLE_VIEW_CHUNK}, "
            f"{64 if p.idx64 else 32}-bit patch indices, K26's table "
            f"{p.table_vertices} z vertices a column")


def print_times(what, r, card):
    lib = (f"  library {r['library_ms']} ms" if r.get("library_ms")
           is not None else "")
    if r.get("library_wrapper_ms") is not None:
        lib += f" (with the host's time {r['library_wrapper_ms']} ms)"
    extra = (f"  with the host's time {r['host_ms']} ms" if "host_ms" in r
             else "")
    if "bitwise_vs_saved" in r:
        extra += f"  vs the saved run: bitwise {r['bitwise_vs_saved']}"
    if "pair_ms" in r:
        extra += f"  unfused pair {r['pair_ms']} ms"
    if r.get("issue_floor_ms") is not None:
        extra += (f"  at one operation an instruction "
                  f"{r['issue_floor_ms']:.4f} ms")
    print(f"  {what} [{card}]: max|delta| {r['err']:.3g}  kernel {r['ms']} ms"
          f"  wrapper {r['wrapper_ms']} ms  plain {r['plain_ms']} ms  bound "
          f"{r['bound'][0]:.4f} ms ({r['bound'][1]}){lib}{extra}", flush=True)


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
    import torch

    from bigstitcher_spark_tpu_torch import ops

    n = int(np.prod(kw["out_shape"]))
    view_steps = sum(int(np.prod([b - a for a, b in zip(*w)]))
                     for w, st in zip(kw["windows"], starts) if st is not None)
    # one wrapper call: K1's launches and the device memory it allocates at
    # its peak (the output, the tables, nothing of the volume's size else)
    on_card = tiles[0].device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    got = run()
    launches = ops.launch_counts()["composite_fuse"]
    peak = None
    if on_card:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        check(launches == 1, f"K1: {launches} launch a composite")
    return dict(
        err=max_abs(got, plain()), ms=time_ms(bare), wrapper_ms=time_ms(run),
        plain_ms=time_ms(plain, reps=plain_reps), launches_per_call=launches,
        peak_bytes=peak,
        bound=bound(sum(t.numel() * t.element_size() for t in tiles) + n * 2,
                    view_steps * OPS["composite_view"]
                    + n * OPS["composite_final"]))


def batch_rows(args, io, rows):
    """``rows`` distinct rows from phase 1's per-block inputs (``args``:
    patches, the per-view arrays, valid last; ``io`` the inside offsets):
    row b's patches rolled b voxels along z and its views' parameters b
    views along, one view of every odd row switched off, and the last row
    padding as the sharded route pads (all zeros). Returns (batched args,
    batched inside offsets) on the inputs' device. The rows are made on
    the host: the card's torch has no uint16 roll."""
    import torch

    dev = args[0].device
    args, io = [a.cpu() for a in args], io.cpu()

    def row(b):
        if b == rows - 1:
            return [torch.zeros_like(a) for a in args], torch.zeros_like(io)
        rb = [torch.roll(args[0], b, dims=-1)] + [
            torch.roll(a, b, dims=0) for a in args[1:]]
        if b % 2:
            rb[-1] = rb[-1].clone()
            rb[-1][b % rb[-1].shape[0]] = 0.0
        return rb, torch.roll(io, b, dims=0)

    per_row = [row(b) for b in range(rows)]
    return ([torch.stack([r[0][j] for r in per_row]).to(dev)
             for j in range(len(args))],
            torch.stack([r[1] for r in per_row]).to(dev))


def batch_times(batch_fn, plain_fn, single_fn, args, io, bs, nbytes, ops,
                bitwise=False, outputs=None):
    """A batch form of K2, K3 or K5 at BATCH_ROWS distinct rows made from
    phase 1's per-block inputs (:func:`batch_rows`): every row bitwise the
    per-block kernel (``single_fn``) on that row's inputs, the padding row
    zeros, the batch held to its plain twin (a loop of the per-block twin)
    on the same inputs with the per-block tolerance (``bitwise``: bit for
    bit, K2 and K5) and its largest |difference| from it recorded, one batch
    launch timed alone and with the host's time, the twin once, and the
    bound of the batch (``nbytes`` and ``ops`` of one row, times the
    rows); with ``outputs`` the batch's outputs held
    (:func:`hold_outputs`)."""
    import torch

    rows = BATCH_ROWS
    bargs, bio = batch_rows(args, io, rows)
    run = lambda: batch_fn(*bargs, bs, "AVG_BLEND", bio)
    got = run()
    same = all(torch.equal(g[b], w) for b in range(rows)
               for g, w in zip(got, single_fn(*(a[b] for a in bargs), bs,
                                              "AVG_BLEND", bio[b])))
    check(same, f"{batch_fn.__name__}: each of {rows} distinct rows bitwise "
                "the per-block kernel's on its inputs")
    check(not got[0][-1].any() and not got[1][-1].any(),
          f"{batch_fn.__name__}: the padding row writes zeros")
    check(len({float(g.sum()) for g in got[0][:-1]}) == rows - 1,
          f"{batch_fn.__name__}: the {rows - 1} real rows differ")
    plain = lambda: plain_fn(*bargs, bs, "AVG_BLEND", bio)
    ref = plain()
    if bitwise:
        check(all(torch.equal(g, f) for g, f in zip(got, ref)),
              f"{batch_fn.__name__}: bitwise its twin")
    # the per-block kernels' tolerance against their twins
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)
    err = max_abs(got[0], ref[0])
    r = dict(batch_rows=rows, batch_ms=time_ms(run, reps=5),
             batch_host_ms=time_ms(run, reps=5, host=True),
             batch_plain_ms=time_ms(plain, reps=1, rounds=1),
             batch_bound_ms=bound(nbytes * rows, ops * rows)[0],
             batch_max_abs_err=err)
    held = {}
    hold_outputs(outputs, batch_fn.__name__, got, held)
    if "bitwise_vs_saved" in held:
        r["batch_bitwise_vs_saved"] = held["bitwise_vs_saved"]
    del got, ref
    return r


def shift_times(rng, c, bs, V, per_view, dims, borders, ranges, valid, io_d,
                card, outputs=None):
    """K2 on V translated views with sub-pixel fractions (some voxels
    outside) bitwise against its twin at every fusion type; on a tree with
    them, its batch form at BATCH_ROWS rows and K28 on that batch's fused
    blocks with route A's first level (2,2,2). With ``outputs`` every
    output is held (:func:`hold_outputs`)."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import fusion as F

    patches = c(rng.integers(90, 4000, (V, *(s + 1 for s in bs)))
                .astype(np.uint16))
    fr = per_view(0, 1)
    lp = (rng.uniform(-40, 40, (V, 3)) + fr).astype(np.float32)
    args = [patches] + [c(a) for a in (fr, lp, dims, borders, ranges, valid)]
    run = lambda: F.fuse_block_shift(*args, bs, "AVG_BLEND", io_d)
    plain = lambda: F.fuse_block_shift_plain(*args, bs, "AVG_BLEND", io_d)
    got, ref = run(), plain()
    held = []
    for ft in F.FUSION_TYPES:
        g = F.fuse_block_shift(*args, bs, ft, io_d)
        check(all(torch.equal(a, b) for a, b in zip(
            g, F.fuse_block_shift_plain(*args, bs, ft, io_d))),
            f"K2 fuse_block_shift {bs} {ft}: bitwise its twin")
        held.append({})
        hold_outputs(outputs, f"fuse_block_shift {ft}", g, held[-1])
    tables = F.shift_axis_tables(*args[2:6], io_d, bs)
    bare = lambda: F.launch_fuse_block_shift(patches, args[1], tables,
                                             args[6], bs, "AVG_BLEND")
    n = int(np.prod(bs))
    nbytes = patches.numel() * 2 + 2 * n * 4
    res = {"fuse_block_shift": dict(
        err=max_abs(got[0], ref[0]), ms=time_ms(bare), wrapper_ms=time_ms(run),
        host_ms=time_ms(bare, host=True), plain_ms=time_ms(plain),
        bound=bound(nbytes, V * n * OPS["shift"]), **saved_all(held))}
    if not hasattr(F, "fuse_block_shift_batch"):
        return res
    res["fuse_block_shift"].update(batch_times(
        F.fuse_block_shift_batch, F.fuse_block_shift_batch_plain,
        F.fuse_block_shift, args, io_d, bs, nbytes, V * n * OPS["shift"],
        bitwise=True, outputs=outputs))
    bargs = [a.expand(BATCH_ROWS, *a.shape).contiguous() for a in args]
    fz, ws = F.fuse_block_shift_batch(
        *bargs, bs, "AVG_BLEND", io_d.expand(BATCH_ROWS, V, 3).contiguous())
    del bargs
    res["block_epilogue"] = epilogue_times(fz, ws, ((2, 2, 2),), card,
                                           outputs)
    return res


def block_yardsticks(dev, card, scale="full", outputs=None):
    """K2 and K5 per block at phase 1's shapes (K2 on phase 1's very
    inputs), and on a tree with them their batch forms at BATCH_ROWS rows
    and K28 (:func:`shift_times`, :func:`sep_times`); with ``outputs``
    K2's, K5's (every fusion type and patch dtype, and the batch) and
    K28's outputs held (:func:`hold_outputs`)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(2024)
    bs, V = compute_block_of(scale), 4
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def per_view(lo, hi):
        return rng.uniform(lo, hi, (V, 3)).astype(np.float32)

    dims = np.tile(np.array([s + 80 for s in bs], np.float32), (V, 1))
    borders, ranges = per_view(0, 3), per_view(10, 40)
    valid = np.ones(V, np.float32)
    io_d = c(np.zeros((V, 3), np.float32))
    out = shift_times(rng, c, bs, V, per_view, dims, borders, ranges, valid,
                      io_d, card, outputs)
    out["fuse_block_sep"] = sep_times(rng, c, bs, SCALES[scale]["sep_patch"],
                                      V, per_view, dev, outputs)
    for k, r in out.items():
        print_times(k, r, card)
        if "batch_ms" in r:
            print(f"  {k} batch form, {r['batch_rows']} rows [{card}]: "
                  f"{r['batch_ms']} ms (with the host's time "
                  f"{r.get('batch_host_ms')} ms), plain "
                  f"{r['batch_plain_ms']} ms, bound "
                  f"{r['batch_bound_ms']:.4f} ms; vs the saved run: bitwise "
                  f"{r.get('batch_bitwise_vs_saved')}", flush=True)
    return out


def epilogue_bytes(shape, out_itemsize: int, rels) -> int:
    """What K28 must move for a (B, X, Y, Z) batch (conversion mode): the
    float32 block read once, s0 and every level written once."""
    import numpy as np

    B, *dims = (int(v) for v in shape)
    out = int(np.prod(shape))
    for r in rels:
        dims = [d // f for d, f in zip(dims, r)]
        out += B * int(np.prod(dims))
    return int(np.prod(shape)) * 4 + out * int(out_itemsize)


def epilogue_times(fused, wsum, rels, card, outputs=None):
    """K28 on a batch of fused blocks (uint16, ``rels`` levels) against its
    twin on the card, bitwise, in both modes; its time alone and with the
    host's, its twin's and its bound (the float32 block read once, s0 and
    the levels written once); with ``outputs`` s0 and the levels held in
    both modes (:func:`hold_outputs`)."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import epilogue as E

    held = []
    for masks in (False, True):
        got = E.block_epilogue(fused, wsum, 0.0, 65535.0, "uint16", masks,
                               rels)
        ref = E.block_epilogue_plain(fused, wsum, 0.0, 65535.0, "uint16",
                                     masks, rels)
        check(all(torch.equal(g, f) for g, f in zip(got, ref)),
              f"K28 block_epilogue {tuple(fused.shape)} levels {rels} "
              f"masks {masks}: s0 and every level bitwise the twin's")
        held.append({})
        hold_outputs(outputs, f"block_epilogue masks {masks}", got,
                     held[-1])
    run = lambda: E.block_epilogue(fused, wsum, 0.0, 65535.0, "uint16",
                                   False, rels)
    plain = lambda: E.block_epilogue_plain(fused, wsum, 0.0, 65535.0,
                                           "uint16", False, rels)
    n0 = fused.numel()
    ops, prev = n0 * OPS["convert"], n0
    for lv in got[1:]:
        ops += prev * OPS["downsample_in"] + lv.numel() * OPS["downsample_out"]
        prev = lv.numel()
    ms = time_ms(run)  # no preparation: the wrapper is the launch
    r = dict(err=0.0, ms=ms, wrapper_ms=ms, host_ms=time_ms(run, host=True),
             plain_ms=time_ms(plain, reps=3),
             library_ms=None, shape=tuple(fused.shape), levels=rels,
             bound=bound(epilogue_bytes(tuple(fused.shape), 2, rels), ops),
             **saved_all(held))
    print(f"  block_epilogue (K28) at {tuple(fused.shape)}, levels {rels}: "
          f"{int(np.prod(fused.shape[1:]))} voxels a block", flush=True)
    return r


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


SEP_DTYPES = ("uint8", "uint16", "int16", "float32")


def sep_times(rng, c, bs, patch, V, per_view, dev, outputs=None):
    """K5 on 4 views at route D's compute block and patch shape, against
    its plain twin: bit for bit at every fusion type and patch dtype (and
    within fused float32 rtol 1e-5 / atol 1e-3, the tolerance K3 is held
    to, wsum atol 1e-5, for a tree whose K5 is not), its time alone, with
    the host's time and the wrapper's; on a tree with it its batch form,
    bitwise its twin (V = 4: the twin's sums over the views keep K5's
    order). With
    ``outputs`` the outputs at every fusion type and patch dtype (uint16
    patches as uint8 mod 256, int16, float32) and the batch's are held
    (:func:`hold_outputs`)."""
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
    held, same = [], True
    for dtype in SEP_DTYPES:
        pd = (patches.to(torch.int32) % 256).to(torch.uint8) \
            if dtype == "uint8" else patches.to(getattr(torch, dtype))
        for ft in F.FUSION_TYPES:
            g = F.fuse_block_sep(pd, *args[1:], bs, ft, io_d)
            r = F.fuse_block_sep_plain(pd, *args[1:], bs, ft, io_d)
            torch.testing.assert_close(g[0], r[0], rtol=1e-5, atol=1e-3)
            torch.testing.assert_close(g[1], r[1], rtol=0, atol=1e-5)
            same &= all(torch.equal(a, b) for a, b in zip(g, r))
            check(same or not hasattr(F, "sep_launch_plan"),
                  f"K5 fuse_block_sep {bs} {ft} {dtype}: bitwise its twin")
            held.append({})
            hold_outputs(outputs, f"fuse_block_sep {ft} {dtype}", g,
                         held[-1])
    tables = F.sep_axis_tables(*args[1:7], io_d, bs)
    bare = lambda: F.launch_fuse_block_sep(patches, args[1], args[2], tables,
                                           args[7], bs, "AVG_BLEND")
    n = int(np.prod(bs))
    nbytes = sep_tap_bytes(patch, diags, ts, bs, 2) + 2 * n * 4
    r = dict(err=max_abs(got[0], ref[0]), twin_bitwise=same, ms=time_ms(bare),
             host_ms=time_ms(bare, host=True), wrapper_ms=time_ms(run),
             plain_ms=time_ms(plain), library_ms=None,
             bound=bound(nbytes, V * n * OPS["sep"]), **saved_all(held))
    if hasattr(F, "fuse_block_sep_batch"):
        r.update(batch_times(F.fuse_block_sep_batch,
                             F.fuse_block_sep_batch_plain, F.fuse_block_sep,
                             args, io_d, bs, nbytes, V * n * OPS["sep"],
                             bitwise=hasattr(F, "sep_launch_plan"),
                             outputs=outputs))
    return r


def downsample_times(x, factors, dev, level: bool, outputs=None, name=""):
    """K6 against its plain twin (bitwise) and torch's avg_pool3d on the
    float32 input (the library yardstick, used nowhere in the port):
    ``level`` True times downsample_level (uint16 out), else
    downsample_batch (float32 out) on the (B, X, Y, Z) batch ``x``; the
    wrapper's time with the host's (``host_ms``); with ``outputs`` the
    output held as ``name`` (:func:`hold_outputs`)."""
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
    r = dict(err=max_abs(got, ref), ms=ms, wrapper_ms=ms,
             host_ms=time_ms(run, host=True),
             plain_ms=time_ms(plain, reps=5), library_ms=time_ms(lib),
             bound=bound(x.numel() * x.element_size()
                         + n_out * got.element_size(),
                         x.numel() * OPS["downsample_in"]
                         + n_out * OPS["downsample_out"]))
    hold_outputs(outputs, "downsample " + name, (got,), r)
    return r


def halfpixel_times(x, card, outputs=None):
    """K6's one-axis float32 form (halfpixel_downsample2x_axis) along each
    axis of ``x``: bitwise against its twin, timed beside the twin and
    avg_pool3d on the float32 input (window 2 on that axis; the library
    yardstick, used nowhere in the port), and with the host's time; with
    ``outputs`` each output held (:func:`hold_outputs`). Lists over the
    axes."""
    import torch

    from bigstitcher_spark_tpu_torch.ops import downsample as D

    xf = x.to(torch.float32)[None, None]
    r = {k: [] for k in ("halfpixel_ms", "halfpixel_host_ms",
                         "halfpixel_plain_ms", "halfpixel_library_ms",
                         "halfpixel_bound_ms", "halfpixel_bitwise_vs_saved")}
    r["halfpixel_err"] = 0.0
    for axis in range(x.dim()):
        run = lambda: D.halfpixel_downsample2x_axis(x, axis)
        plain = lambda: D.halfpixel_downsample2x_axis_plain(x, axis)
        win = tuple(2 if d == axis else 1 for d in range(3))
        lib = lambda: torch.nn.functional.avg_pool3d(xf, win, win)
        got, ref = run(), plain()
        check(torch.equal(got, ref), f"K6 halfpixel_downsample2x_axis "
              f"{tuple(x.shape)} {x.dtype} axis {axis} -> "
              f"{tuple(got.shape)}: bitwise equal to the twin")
        r["halfpixel_err"] = max(r["halfpixel_err"], max_abs(got, ref))
        r["halfpixel_ms"].append(time_ms(run))
        r["halfpixel_host_ms"].append(time_ms(run, host=True))
        r["halfpixel_plain_ms"].append(time_ms(plain, reps=5))
        held = {}
        hold_outputs(outputs, f"downsample one-axis {axis}", (got,), held)
        r["halfpixel_bitwise_vs_saved"].append(held.get("bitwise_vs_saved"))
        r["halfpixel_library_ms"].append(time_ms(lib))
        b = bound(x.numel() * x.element_size() + got.numel() * 4,
                  x.numel() * OPS["downsample_in"]
                  + got.numel() * OPS["downsample_out"])
        r["halfpixel_bound_ms"].append(b[0])
        print(f"  halfpixel_downsample2x_axis (K6) axis {axis} "
              f"{tuple(x.shape)} -> {tuple(got.shape)} [{card}]: kernel "
              f"{r['halfpixel_ms'][-1]} ms  with the host's time "
              f"{r['halfpixel_host_ms'][-1]} ms  plain "
              f"{r['halfpixel_plain_ms'][-1]} ms  bound {b[0]:.4f} ms "
              f"({b[1]})  library {r['halfpixel_library_ms'][-1]} ms "
              "(avg_pool3d)" + ("" if held.get("bitwise_vs_saved") is None
                                else "  vs the saved run: bitwise "
                                f"{held['bitwise_vs_saved']}"), flush=True)
    return r


def fft_plain_roundtrip(w):
    """rfftn then irfftn of ``w`` through K8's plain twin, pass by pass."""
    from bigstitcher_spark_tpu_torch.ops import phasecorr as P

    _, X, Y, Z = (int(s) for s in w.shape)
    f = P.fft_pow2_plain(w, 3, "r2c")
    f = P.fft_pow2_plain(P.fft_pow2_plain(f, 2, "c2c"), 1, "c2c")
    g = P.fft_pow2_plain(P.fft_pow2_plain(f, 1, "c2c", True), 2, "c2c", True)
    return P.fft_pow2_plain(g, 3, "c2r", True, 1.0 / (X * Y * Z), n=Z)


FFT_PASSES = ("r2c z", "c2c y", "c2c x", "inverse c2c x", "inverse c2c y",
              "c2r z")


def fft_pass_times(w):
    """K8's six passes of the round trip at ``w``'s (B, X, Y, Z) shape, each
    timed alone back to back (the c2c passes out of place, so every call
    transforms the same spectrum): {pass: ms}."""
    import torch

    from bigstitcher_spark_tpu_torch.ops import phasecorr as P

    _, X, Y, Z = (int(s) for s in w.shape)
    f = P.rfftn3(w)
    g = torch.empty_like(f)
    runs = (lambda: P.fft_pow2(w, 3, "r2c"),
            lambda: P.fft_pow2(f, 2, "c2c", out=g),
            lambda: P.fft_pow2(f, 1, "c2c", out=g),
            lambda: P.fft_pow2(f, 1, "c2c", inverse=True, out=g),
            lambda: P.fft_pow2(f, 2, "c2c", inverse=True, out=g),
            lambda: P.fft_pow2(f, 3, "c2r", inverse=True,
                               scale=1.0 / (X * Y * Z), n=Z))
    return {name: time_ms(fn) for name, fn in zip(FFT_PASSES, runs)}


def check_fft(got, ref, what):
    """K8's tolerance: max|delta| <= 2e-5 x max|ref| for every pair."""
    for k in range(int(ref.shape[0])):
        e, m = max_abs(got[k], ref[k]), float(ref[k].abs().max())
        check(e <= 2e-5 * m, f"K8 {what} pair {k}: max|delta| {e:.3g} <= "
                             f"2e-5 x {m:.4g}")


def pcm_crops(rng, c, bucket):
    """A stitching bucket's stacks: B pairs of X x Y x Z uint16 crops
    (random in a true extent a little below the bucket's, zero beyond),
    each b a's copy rolled by (2, -3, 1); returns (a, b, ext) through
    ``c``."""
    import numpy as np

    B, X, Y, Z = bucket
    ext = np.array([[X - X // 5 - k, Y - 2 - k, Z] for k in range(B)],
                   np.int32)
    a = np.zeros(bucket, np.uint16)
    for k in range(B):
        e = ext[k]
        a[k, :e[0], :e[1], :e[2]] = rng.integers(90, 4000, tuple(e))
    b = np.roll(a, (2, -3, 1), axis=(1, 2, 3))
    return c(a), c(b), c(ext)


def pcm_times(rng, c, bucket):
    """K7-K10 at one stitching bucket (B pairs of X x Y x Z uint16 crops,
    each b a shifted copy of its a) against their twins, with times and
    bounds; returns {wrapper name: result}."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import phasecorr as P

    B, X, Y, Z = bucket
    a, b, ext = pcm_crops(rng, c, bucket)
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
    trip = lambda: P.irfftn3(P.rfftn3(w), Z)
    res["fft_pow2"] = dict(
        err=err8, ms=time_ms(trip), wrapper_ms=time_ms(trip, host=True),
        plain_ms=time_ms(lambda: fft_plain_roundtrip(w)),
        library_ms=time_ms(lib), library_wrapper_ms=time_ms(lib, host=True),
        passes_ms=fft_pass_times(w),
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
        library_ms=None, bound=bound(n * 4, n * OPS["topk"]),
        **peaks_more(pcm))
    return res


def fill_pcm(shape, device):
    """A PCM with fewer local maxima than K10's n: one smooth periodic bump
    a pair (a single maximum, plateau-free), so the answer is the maximum,
    then the -inf of non-maxima by ascending flat index."""
    import torch

    B, X, Y, Z = shape
    g = [torch.arange(s, dtype=torch.float32, device=device) for s in
         (X, Y, Z)]
    bump = sum(torch.cos(2 * math.pi * (v - 1.0 - k) / s).view(
        [-1 if a == ax else 1 for a in range(3)])
        for ax, (v, s, k) in enumerate(zip(g, (X, Y, Z), (3, 2, 1))))
    return torch.stack([bump * (1.0 + b) for b in range(B)]).contiguous()


def peaks_more(pcm):
    """K10 beyond phase 1's n = 5: at n = 256 (its largest) against its
    twin and timed, and on :func:`fill_pcm` at n = 5 and 256 against its
    twin (the -inf fill by ascending index)."""
    import torch

    from bigstitcher_spark_tpu_torch.ops import phasecorr as P

    shape = tuple(pcm.shape)
    n = 256 if pcm[0].numel() >= 256 else int(pcm[0].numel())
    check(torch.equal(P.pcm_peaks_topk(pcm, n), P.pcm_peaks_topk_plain(pcm, n)),
          f"K10 top-{n} of {shape}: indices equal to the twin's")
    fill = fill_pcm(shape, pcm.device)
    for m in (5, n):
        check(torch.equal(P.pcm_peaks_topk(fill, m),
                          P.pcm_peaks_topk_plain(fill, m)),
              f"K10 top-{m} of {shape} with one maximum a pair (the -inf "
              "fill): indices equal to the twin's")
    return dict(n256_ms=time_ms(lambda: P.pcm_peaks_topk(pcm, n)),
                n256_wrapper_ms=time_ms(lambda: P.pcm_peaks_topk(pcm, n),
                                        host=True),
                n256_plain_ms=time_ms(lambda: P.pcm_peaks_topk_plain(pcm, n),
                                      reps=5))


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

    # K2 (and its batch form, and K28 on that batch's output)
    io_d = c(ioffs)
    res.update(shift_times(rng, c, bs, V, per_view, dims, borders, ranges,
                           valid, io_d, card))
    n = int(np.prod(bs))

    # K3: general affines, one rotated 7 degrees, samples outside the patch
    gargs = gather_inputs(rng, c, bs, V, dims, borders, ranges, valid)
    gpatches = gargs[0]
    run = lambda: F.fuse_block(*gargs, bs, "AVG_BLEND", io_d)
    plain = lambda: F.fuse_block_plain(*gargs, bs, "AVG_BLEND", io_d)
    got, ref = run(), plain()
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)
    ms = time_ms(run)  # no preparation: the wrapper is the launch
    res["fuse_block"] = dict(
        err=max_abs(got[0], ref[0]), ms=ms, wrapper_ms=ms,
        plain_ms=time_ms(plain),
        bound=bound(gpatches.numel() * 2 + 2 * n * 4, V * n * OPS["gather"]),
        form=resample_form(F, bs, V, tuple(gpatches.shape[1:])),
        ft_ms={ft: time_ms(lambda ft=ft: F.fuse_block(*gargs, bs, ft, io_d))
               for ft in F.FUSION_TYPES},
        **batch_times(F.fuse_block_batch, F.fuse_block_batch_plain,
                      F.fuse_block, gargs, io_d, bs,
                      gpatches.numel() * 2 + 2 * n * 4,
                      V * n * OPS["gather"]))
    print(f"  fuse_block (K3) form: {res['fuse_block']['form']}; by fusion "
          f"type [{card}]: " + ", ".join(
              f"{k} {v} ms" for k, v in res["fuse_block"]["ft_ms"].items()),
          flush=True)

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
    # and at route D's boxes (rows of 45 uint16: 2-byte aligned)
    dboxes = c(rng.integers(0, 65536, (4, *cfg["batch_box_d"]))
               .astype(np.uint16))
    rd = downsample_times(dboxes, (2, 2, 1), dev, False)
    print_times("downsample_batch at route D's boxes", rd, card)
    res["downsample_batch"].update(
        route_d_ms=rd["ms"], route_d_plain_ms=rd["plain_ms"],
        route_d_library_ms=rd["library_ms"], route_d_bound_ms=rd["bound"][0],
        route_d_max_abs_err=rd["err"])
    del dboxes
    # K6's one-axis form (halfpixel_downsample2x_axis) on a route-A tile
    tile = c(rng.integers(0, 65536, cfg["tile"]).astype(np.uint16))
    res["downsample_batch"].update(halfpixel_times(tile, card))
    del tile

    # K26's batch form at NONRIGID_ROWS rows of phase 11's four-view block
    res["nonrigid_fuse_batch"] = nonrigid_batch_times(rng, c, bs, dev)

    # K7-K10: route A's x-edge bucket at -ds 2,2,1
    res.update(pcm_times(rng, c, cfg["pcm_bucket"]))
    for k, r in res.items():
        print_times(k, r, card)
    print(f"  fft_pow2 passes at {cfg['pcm_bucket']} [{card}]: " + ", ".join(
        f"{k} {v} ms" for k, v in res["fft_pow2"]["passes_ms"].items()),
        flush=True)
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
            container_args=(), fusion_args=(), block=None):
    """create-fusion-container (storage blocks ``block``, default the
    scale's) + affine-fusion through the CLI entry function; returns
    (FusionStats, affine-fusion wall seconds including its downsample
    stage)."""
    from bigstitcher_spark_tpu_torch.cli.main import main

    cfg = SCALES[scale]
    main(["create-fusion-container", "-x", xml, "-o", out, "-s", storage,
          "-d", "UINT16", "-c", "raw", "--blockSize",
          ",".join(str(b) for b in block or cfg["block"]), *container_args])
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
    print(f"  composite_fuse at route A's shape {kw['out_shape']}: "
          f"{r['launches_per_call']} K1 launch a composite, device memory "
          f"peak of one call {r['peak_bytes']} B (tiles "
          f"{sum(t.numel() * t.element_size() for t in tiles)} B resident "
          "before it)", flush=True)
    return r


def reset_peak(dev):
    """Reset the card's peak-memory counter (nothing in a CPU rehearsal)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(dev):
    """The card's peak allocation since :func:`reset_peak` (None on the
    CPU)."""
    import torch

    if dev.type != "cuda":
        return None
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


# each counted route's launches, by kernel (K22's line splits its launches
# by shape: 9b's candidates against route A's small pairs in 9a and 9c)
ROUTE_LAUNCHES = {}


def counted(route, launches, dev, fn, exclusive=False):
    """Run ``fn`` (one route's main path) with every launch count set to 0
    just before it and read just after it; on the card the route's kernels
    must each have launched, and with ``exclusive`` no other kernel may
    have. Adds the counts to ``launches``."""
    from bigstitcher_spark_tpu_torch import ops

    ops.reset_launch_counts()
    out = fn()
    got = {**ops.launch_counts(), **ops.coeff_launch_counts()}
    ROUTE_LAUNCHES[route] = got
    print(f"  route {route} launches: {got}", flush=True)
    for k in ROUTE_KERNELS[route] if dev.type == "cuda" else ():
        check(got[k] > 0, f"route {route}: kernel {k} launched {got[k]} "
                          "times")
    if exclusive:
        other = {k: n for k, n in got.items()
                 if n and k not in ROUTE_KERNELS[route]}
        check(not other, f"{route}: no kernel outside "
                         f"{ROUTE_KERNELS[route]} launched ({other})")
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
    return out_b


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


# K10 at each bucket phase 6 sent it: {bucket, n, ms, bound_ms}
PHASE6_PEAKS = []


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
    if torch.cuda.is_available():
        ms = time_ms(lambda: P.pcm_peaks_topk(pcm, n_peaks))
        b = bound(pcm.numel() * 4, pcm.numel() * OPS["topk"])[0]
        PHASE6_PEAKS.append(dict(bucket=list(pcm.shape), n=n_peaks, ms=ms,
                                 bound_ms=b))
        print(f"  {what} K10 top-{n_peaks}: kernel {ms} ms  bound {b:.4f} "
              "ms (bytes)", flush=True)
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


# ---------------------------------------------------------------- phase 7


def check_relax_close(got, ref, what):
    """The JAX package's device-vs-numpy contract for two relaxations:
    iterations equal, history rtol 1e-9 / atol 1e-9, models and link
    errors rtol 1e-7 / atol 1e-9."""
    import numpy as np

    ok = got.iterations == ref.iterations
    if ok:
        ok = (np.allclose(got.history, ref.history, rtol=1e-9, atol=1e-9)
              and np.allclose(got.models, ref.models, rtol=1e-7, atol=1e-9)
              and np.allclose(got.link_errors, ref.link_errors, rtol=1e-7,
                              atol=1e-9))
    dm = (float(np.abs(got.models - ref.models).max())
          if got.models.shape == ref.models.shape else float("nan"))
    dh = (float(np.abs(got.history - ref.history).max())
          if got.history.shape == ref.history.shape and len(got.history)
          else 0.0)
    check(ok, f"{what}: kernels {got.iterations} / twin {ref.iterations} "
              f"iterations, history max|delta| {dh:.3g}, models max|delta| "
              f"{dm:.3g}, within the device-vs-numpy contract")


def relax_spy():
    """Swap ``ops.solve.relax_on_device`` for a recorder; returns (calls,
    undo). Each call is kept as (args, kwargs, output)."""
    from bigstitcher_spark_tpu_torch.ops import solve as R

    real, calls = R.relax_on_device, []

    def spy(*a, **k):
        out = real(*a, **k)
        calls.append((a, k, out))
        return out

    R.relax_on_device = spy

    def undo():
        R.relax_on_device = real

    return calls, undo


def solver_cli(xml, args, route, dev, card, launches):
    """``solver`` through the CLI entry function, its launches counted as
    ``route``; returns (SolverRun, the relaxations it ran)."""
    from bigstitcher_spark_tpu_torch.cli.main import main

    calls, undo = relax_spy()
    try:
        run = counted(route, launches, dev, lambda: main(
            ["solver", "-x", xml, *args, "--device", str(dev)]))
    finally:
        undo()
    t = run.timings
    rows = calls[0][0][0].n_rows if calls else 0
    iters = sum(out.iterations for _a, _k, out in calls)
    print(f"  [solver {route}] {card}: {len(calls)} solve(s), {rows} rows, "
          f"{iters} iterations, error {run.result.error:.6g} px; wall "
          f"{t['total']:.3f}s: match assembly {t['matches']:.3f}s, warm "
          f"start {t.get('warm_start', 0.0):.3f}s, relax "
          f"{t.get('relax', 0.0):.3f}s, store {t.get('store', 0.0):.3f}s; "
          f"{rows * iters / max(t.get('relax', 0.0), 1e-9):,.0f} "
          "row-iterations/s", flush=True)
    return run, calls


def phase7a(proj, scale, dev, card, launches):
    """7a: the registration chain on route A's project: solver on a copy of
    the XML phase 6's -ds 2,2,1 run wrote."""
    import numpy as np

    from bigstitcher_spark_tpu_torch.io.spimdata import SpimData

    base = os.path.dirname(proj.xml_path)
    xml = os.path.join(base, "solve_221.xml")
    shutil.copy(os.path.join(base, "stitch_221.xml"), xml)
    kept = len(SpimData.load(xml).stitching_results)
    run, calls = solver_cli(xml, ["-s", "STITCHING"], "7a", dev, card,
                            launches)
    pr = calls[0][0][0]
    check(pr.n_tiles == 4 and pr.n_links == kept
          and (scale == "tiny" or kept == 6),
          f"7a: {pr.n_tiles} tiles, {pr.n_links} links (phase 6 kept {kept})")
    sd = SpimData.load(xml)
    resid = {v.setup: sd.model(v)[:, 3] - np.asarray(proj.true_offsets[v.setup])
             for v in sd.view_ids()}
    for s, r in sorted(resid.items()):
        e = float(np.abs(r - resid[0]).max())
        check(e <= 1.5, f"7a tile {s}: solved position within {e:.3f} <= 1.5 "
                        "px of the truth (up to the fixed tile 0)")


def phase7b(work, scale, dev, card, launches):
    """7b: grid G, ONE_ROUND_ITERATIVE over stitching links with 8 wrong
    shifts; then the same iterative solve through the twins on the card."""
    import numpy as np

    from bigstitcher_spark_tpu_torch.io.spimdata import SpimData
    from bigstitcher_spark_tpu_torch.models import solver as S
    from bigstitcher_spark_tpu_torch.ops import solve as R
    from bigstitcher_spark_tpu_torch.utils.solverdata import (
        make_stitching_grid)

    cfg = SCALES[scale]
    t0 = time.perf_counter()
    g = make_stitching_grid(os.path.join(work, "grid_g"), grid=cfg["grid_g"],
                            tile=cfg["solve_tile"], n_bad=cfg["grid_bad"],
                            seed=41)
    print(f"  synthesized grid G {cfg['grid_g']} ({len(g.pairs)} links, "
          f"{len(g.bad_pairs)} wrong) in {time.perf_counter() - t0:.1f}s "
          "(host)", flush=True)
    xml = os.path.join(work, "grid_g", "solve.xml")
    shutil.copy(g.xml_path, xml)
    run, calls = solver_cli(xml, ["-s", "STITCHING", "--method",
                                  "ONE_ROUND_ITERATIVE"], "7b", dev, card,
                            launches)
    removed = sorted((a[0].setup, b[0].setup)
                     for a, b in run.result.removed_links)
    check(removed == sorted(g.bad_pairs),
          f"7b: dropped exactly the {len(g.bad_pairs)} wrong links {removed}")
    sd = SpimData.load(xml)
    worst = max(float(np.abs(sd.model(v)[:, 3] - g.true_offsets[v.setup]).max())
                for v in sd.view_ids())
    check(worst <= 0.05, f"7b: every tile within {worst:.2e} <= 0.05 px of "
                         "the truth (tile 0 fixed)")
    # the twins' own iterative solve on the same links
    sd = SpimData.load(g.xml_path)
    tiles = S.build_tiles(sd, sd.view_ids(), run.params)
    links = S.matches_from_stitching(sd, tiles, verbose=False)
    real = R.relax_on_device
    R.relax_on_device = R.relax_plain
    twin_calls, undo = relax_spy()
    try:
        twin = S.solve_iterative(links, tiles, S.pick_fixed(tiles, run.params),
                                 run.params, verbose=False)
    finally:
        undo()
        R.relax_on_device = real
    check(twin.removed_links == run.result.removed_links
          and len(twin_calls) == len(calls),
          f"7b: the twins drop the same link sequence in {len(twin_calls)} "
          "solves")
    for i, ((_a, _k, got), (_b, _l, ref)) in enumerate(zip(calls, twin_calls)):
        check_relax_close(got, ref, f"7b solve {i}")
    return calls


def relax_kernel_times(pr, args, what, card):
    """K11-K14 alone on one iteration of a recorded relaxation's inputs,
    each against its twin stage on the same inputs (rtol 1e-10 / atol
    1e-12), with times and bounds; returns {wrapper name: result}."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import solve as R

    _p, link_mask, fixed_mask, warm_t, lam, damping, max_error, _mi, \
        model, reg, pw = args
    dev, T, L, N = pr.device, pr.n_tiles, pr.n_links, pr.n_rows
    f64 = dict(dtype=torch.float64, device=dev)
    link_w = torch.as_tensor(np.asarray(link_mask, np.float64), **f64)
    fixed = torch.as_tensor(np.asarray(fixed_mask, bool).astype(np.uint8),
                            device=dev)
    cur = torch.zeros((T, 3, 4), **f64)
    cur[:, :, :3] = torch.eye(3, **f64)
    cur[:, :, 3] = torch.as_tensor(np.asarray(warm_t), **f64)

    def close(got, ref, name, scale=None):
        """rtol 1e-10 / atol 1e-12, the rtol against ``scale`` (the
        magnitude of the terms summed) where given, else against |ref|."""
        against = "|ref|" if scale is None else "the terms' magnitude"
        scale = ref.abs() if scale is None else scale
        bad = int(((got - ref).abs() > 1e-12 + 1e-10 * scale).sum())
        err = float((got - ref).abs().max())
        check(bad == 0, f"{what} {name}: within rtol 1e-10 (of {against}) / "
                        f"atol 1e-12 of the twin (max|delta| {err:.3g})")
        return err

    res = {}
    o = R.tile_origin(pr, link_w)
    mom = R.relax_moments_plain(pr, cur, link_w, o)
    buf = torch.empty_like(mom)
    err = close(R.relax_moments(pr, cur, link_w, o, out=buf), mom,
                "K11 moments", R.moment_scale(pr, cur, link_w, o))
    res["relax_moments"] = dict(
        err=err, ms=time_ms(lambda: R.relax_moments(pr, cur, link_w, o,
                                                    out=buf)),
        plain_ms=time_ms(lambda: R.relax_moments_plain(pr, cur, link_w, o),
                         reps=5),
        bound=bound(N * RELAX_ROW_BYTES + L * 8 + T * (96 + 24 + 288),
                    N * OPS["relax_moments"], F64_OPS_PER_S))
    new_p = R.relax_fit_plain(mom, fixed, o, model, reg, lam,
                              damping, None, cur.clone())
    scratch = cur.clone()
    err = close(R.relax_fit(mom, fixed, o, model, reg, lam, damping,
                            None, scratch), new_p, "K12 models",
                R.fit_scale(new_p, o))
    fit_ops = (OPS["fit"][model] + OPS["fit"].get(reg, 0)
               + OPS["fit_blend"])
    res["relax_fit"] = dict(
        # K12 reads only the moments: rerunning it on its own output
        # costs what the first call does
        err=err, ms=time_ms(lambda: R.relax_fit(
            mom, fixed, o, model, reg, lam, damping, None, scratch)),
        plain_ms=time_ms(lambda: R.relax_fit_plain(
            mom, fixed, o, model, reg, lam, damping, None,
            cur.clone()), reps=5),
        bound=bound(T * (288 + 24 + 2 * 96 + 1), T * fit_ops, F64_OPS_PER_S))
    nd_p = R.relax_error_plain(pr, new_p, link_w)
    nd = (torch.empty(T, **f64), torch.empty(T, **f64))
    R.relax_error(pr, new_p, link_w, out=nd)
    err = max(close(nd[0], nd_p[0], "K13 displacement sums"),
              close(nd[1], nd_p[1], "K13 weight sums"))
    res["relax_error"] = dict(
        err=err, ms=time_ms(lambda: R.relax_error(pr, new_p, link_w, out=nd)),
        plain_ms=time_ms(lambda: R.relax_error_plain(pr, new_p, link_w),
                         reps=5),
        bound=bound(N * RELAX_ROW_BYTES + L * 8 + T * (96 + 16),
                    N * OPS["relax_error"], F64_OPS_PER_S))
    sides = []
    cap = max(pw + 2, 64)  # iterations K14 may count (hist's length)
    for fn in (R.relax_converge, R.relax_converge_plain):
        hist = torch.zeros(cap, **f64)
        st = torch.zeros(4, dtype=torch.int32, device=dev)
        fn(*nd_p, hist, st, pw, max_error, cap)
        sides.append((hist, st))
    err = close(sides[0][0][:1], sides[1][0][:1], "K14 err")
    check(torch.equal(sides[0][1], sides[1][1]),
          f"{what} K14 state {sides[0][1].tolist()} equal to the twin's")
    hist, st = sides[0]
    # K14 advances its state (done after 5 stalls): time it back to back
    # behind a reset of the 16-byte state, less the reset alone
    both = time_ms(lambda: (st.zero_(), R.relax_converge(
        *nd_p, hist, st, pw, max_error, cap)))
    reset = time_ms(st.zero_)
    res["relax_converge"] = dict(
        err=err, ms=None if both is None else both - reset,
        plain_ms=time_each(lambda: R.relax_converge_plain(
            *nd_p, hist, st, pw, max_error, cap), lambda: st.zero_(),
            reps=10, host=True),
        bound=bound(T * 16 + pw * 8, T * OPS["relax_converge"],
                    F64_OPS_PER_S))
    res["relax_error_converge"] = error_converge_times(
        pr, new_p, link_w, pw, max_error, cap, what, nd_p, reset)
    for name, r in res.items():
        r["wrapper_ms"] = r["ms"]
        r["library_ms"] = None
        print_times(f"{name} at {what}", r, card)
    return res


def error_converge_times(pr, cur, link_w, pw, max_error, cap, what, nd_p,
                         reset_ms):
    """K13's fused form (K14 in its last block) on ``cur``, from K14's
    first state and from a state 50 iterations in: bitwise K13 then K14
    (num, den, history, state), the state equal to the twins' and the sums
    within rtol 1e-10 of theirs; its card time (behind a reset of the
    state, less the reset's ``reset_ms``) beside K13 + K14 launched back to
    back the same way (``pair_ms``) and the twins'."""
    import torch

    from bigstitcher_spark_tpu_torch.ops import solve as R

    dev, T = cur.device, pr.n_tiles
    f64 = dict(dtype=torch.float64, device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    err = 0.0
    for i in (0, min(50, cap - 1)):
        sides = []
        for form in ("fused", "pair", "twins"):
            hist = torch.zeros(cap, **f64)
            hist[:i] = float(nd_p[0].sum() / nd_p[1].sum()) + 1.0
            st = torch.tensor([i, 0, 0, 0], dtype=torch.int32, device=dev)
            nd = torch.empty((2, T), **f64)
            if form == "fused":
                R.relax_error_converge(pr, cur, link_w, st, (nd[0], nd[1]),
                                       hist, ticket, pw, max_error, cap)
            elif form == "pair":
                R.relax_error(pr, cur, link_w, st, out=(nd[0], nd[1]))
                R.relax_converge(nd[0], nd[1], hist, st, pw, max_error, cap)
            else:
                R.relax_error_converge_plain(pr, cur, link_w, st,
                                             (nd[0], nd[1]), hist, None, pw,
                                             max_error, cap)
            sides.append((nd, hist, st))
        (nd, hist, st), (nd2, hist2, st2), (nd3, _h3, st3) = sides
        check(torch.equal(nd, nd2) and torch.equal(hist, hist2)
              and torch.equal(st, st2),
              f"{what} K13 + K14 fused from iteration {i}: num, den, "
              f"history and state {st.tolist()} bitwise K13 then K14")
        check(torch.equal(st, st3) and int(ticket) == 0,
              f"{what} K13 + K14 fused from iteration {i}: state equal to "
              "the twins', the ticket back at 0")
        err = max(err, float((nd - nd3).abs().max()))
        bad = int(((nd - nd3).abs() > 1e-12 + 1e-10 * nd3.abs()).sum())
        check(bad == 0, f"{what} K13 + K14 fused: sums within rtol 1e-10 / "
                        f"atol 1e-12 of the twins' (max|delta| {err:.3g})")
    st = torch.zeros(4, dtype=torch.int32, device=dev)
    hist = torch.zeros(cap, **f64)
    nd = torch.empty((2, T), **f64)
    fused = time_ms(lambda: (st.zero_(), R.relax_error_converge(
        pr, cur, link_w, st, (nd[0], nd[1]), hist, ticket, pw, max_error,
        cap)))
    pair = time_ms(lambda: (st.zero_(), R.relax_error(
        pr, cur, link_w, st, out=(nd[0], nd[1])), R.relax_converge(
            nd[0], nd[1], hist, st, pw, max_error, cap)))
    L, N = pr.n_links, pr.n_rows
    sub = (lambda ms: None if ms is None or reset_ms is None
           else ms - reset_ms)
    return dict(
        err=err, ms=sub(fused), pair_ms=sub(pair),
        plain_ms=time_each(lambda: R.relax_error_converge_plain(
            pr, cur, link_w, st, (nd[0], nd[1]), hist, None, pw, max_error,
            cap), lambda: st.zero_(), reps=5, host=True),
        bound=bound(N * RELAX_ROW_BYTES + L * 8 + T * (96 + 16) + pw * 8,
                    N * OPS["relax_error"] + T * OPS["relax_converge"],
                    F64_OPS_PER_S))


def phase7c(work, scale, dev, card, launches):
    """7c: the IP cell, AFFINE regularised by RIGID; then the kernels
    against the twins at --maxIterations 100 and 10 iterations of the numpy
    backend on the host."""
    import dataclasses

    import torch

    from bigstitcher_spark_tpu_torch.models import solver as S
    from bigstitcher_spark_tpu_torch.ops import solve as R
    from bigstitcher_spark_tpu_torch.utils.solverdata import make_ip_grid

    cfg = SCALES[scale]
    t0 = time.perf_counter()
    ip = make_ip_grid(os.path.join(work, "ip"), grid=cfg["ip_grid"],
                      tile=cfg["solve_tile"], n_per_pair=cfg["ip_pairs"],
                      seed=43)
    print(f"  synthesized IP grid {cfg['ip_grid']} ({ip.n_links} links, "
          f"{ip.n_correspondences} correspondences) into interestpoints.n5 "
          f"in {time.perf_counter() - t0:.1f}s (host)", flush=True)
    assembled = []
    real_matches = S.matches_from_interest_points

    def matches_spy(sd, tiles, *a, **k):
        links = real_matches(sd, tiles, *a, **k)
        assembled.append((tiles, links))
        return links

    S.matches_from_interest_points = matches_spy
    try:
        run, calls = solver_cli(ip.xml_path, [
            "-s", "IP", "-l", "beads", "-tm", "AFFINE", "-rm", "RIGID",
            "--lambda", "0.1"], "7c", dev, card, launches)
    finally:
        S.matches_from_interest_points = real_matches
    (args, _kwargs, out), = calls
    pr = args[0]
    check(pr.n_links == ip.n_links and pr.n_rows == 2 * ip.n_correspondences,
          f"7c: {pr.n_tiles} tiles, {pr.n_links} links, {pr.n_rows} rows")
    ones = torch.ones(pr.n_links, dtype=torch.float64, device=pr.device)
    ident = torch.zeros((pr.n_tiles, 3, 4), dtype=torch.float64,
                        device=pr.device)
    ident[:, :, :3] = torch.eye(3, dtype=torch.float64, device=pr.device)
    num, den = R.relax_error(pr, ident, ones)
    pre = float(num.sum() / den.sum())
    err = run.result.error
    check(err < 5.0 and err < pre,
          f"7c: final error {err:.6f} px after {out.iterations} iterations "
          f"< --maxError 5 and < the pre-solve {pre:.6f} px (noise floor "
          "~0.23 px)")
    # kernels against twins, capped at 100 iterations
    a100 = list(args)
    a100[7] = 100
    torch.cuda.synchronize() if pr.device.type == "cuda" else None
    t0 = time.perf_counter()
    got = R.relax_on_device(*a100)
    k_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = R.relax_plain(*a100)
    p_s = time.perf_counter() - t0
    check_relax_close(got, ref, "7c at --maxIterations 100")
    print(f"  [solver 7c] {card}: 100 iterations kernels {k_s * 10:.3f} "
          f"ms/iteration (host clock, with the link errors), twin "
          f"{p_s * 10:.3f} ms/iteration", flush=True)
    tiles, links = assembled[0]
    p10 = dataclasses.replace(run.params, backend="numpy", max_iterations=10)
    t0 = time.perf_counter()
    r10 = S._relax_numpy(links, tiles, S.pick_fixed(tiles, p10), p10)
    print(f"  [solver 7c] host: --solverBackend numpy {r10.iterations} "
          f"iterations in {r10.timings['relax']:.3f}s -> "
          f"{r10.timings['relax'] / max(r10.iterations, 1) * 1e3:.1f} "
          f"ms/iteration (wall {time.perf_counter() - t0:.3f}s)", flush=True)
    return calls, (tiles, links, run.params)


def phase7_solver(work, scale, proj_a, dev, card, launches):
    """Phase 7: the solver; returns K11-K14's results at 7c's shape and
    7c's (tiles, links, params) (phase 15 relaxes them sharded)."""
    print("phase 7 (solver)", flush=True)
    phase7a(proj_a, scale, dev, card, launches)
    calls_b = phase7b(work, scale, dev, card, launches)
    calls_c, solve7c = phase7c(work, scale, dev, card, launches)
    a, _k, _o = calls_b[0]
    relax_kernel_times(a[0], a, "7b's shape", card)
    a, _k, _o = calls_c[0]
    return relax_kernel_times(a[0], a, "7c's shape", card), solve7c


# ---------------------------------------------------------------- phase 8


def check_det_bucket(what, rec, dev):
    """K6 and K15-K18 against their twins, run on the card from one batch
    the detection run sent: K6 and each of the six blur passes bitwise,
    K16's response bitwise with equal candidate sets and counts, K17 at the
    run's k and at half the largest block's count (:func:`topk_against`),
    K18 within 1e-5 px / rtol 1e-6 of its twin, and the
    whole program against the twins' program. Returns max |delta| per
    kernel."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import dog as G
    from bigstitcher_spark_tpu_torch.ops import downsample as D

    (x, lo, hi, thr, org, sigma, fmax, fmin, k, halo, rel), outs = rec
    err = {}
    if any(int(r) != 1 for r in rel):
        xp = D.downsample_batch(x, rel)
        check(torch.equal(xp, D.downsample_block_plain(x, rel)),
              f"{what}: K6 pooling bitwise equal to its twin")
    else:
        xp = x
    blurs, e = [], 0.0
    for s in (sigma, sigma * G.DOG_K):
        taps, b = G.gaussian_kernel_1d(s), xp
        for ax in range(3):
            nb = G.dog_blur(b, taps, ax)
            e = max(e, max_abs(nb, G.blur_plain(b, taps, ax)))
            b = nb
        blurs.append(b)
    err["dog_blur"] = e
    check(e == 0.0, f"{what}: K15's six passes bitwise equal to the twin")
    b1, b2 = blurs
    scale = G.dog_scale(lo, hi)
    args = (b1, b2, scale, thr, org, fmax, fmin, halo, True)
    dog, ci, cs, cnt = G.dog_extrema(*args)
    pdog, pci, pcs, pcnt = G.extrema_plain(*args)
    err["dog_extrema"] = max_abs(dog, pdog)
    same = torch.equal(cnt, pcnt)
    for b, n in enumerate(cnt.tolist()):
        if same:
            o = torch.argsort(ci[b, :n])
            same = (torch.equal(ci[b, :n][o], pci[b, :n])
                    and torch.equal(cs[b, :n][o], pcs[b, :n]))
    check(err["dog_extrema"] == 0.0 and same,
          f"{what}: K16 response bitwise, candidate sets and counts "
          f"{cnt.tolist()} equal to the twin's")
    shape = tuple(int(s) for s in dog.shape[1:])
    _d, mask = G.extrema_plain(*args[:-1], False)
    score = torch.where(mask, dog.abs(), -np.inf).reshape(dog.shape[0], -1)
    del _d, mask
    idx, valid = topk_against(what, ci, cs, cnt, k, shape, score)
    err["dog_topk"] = 0.0
    # the truncation path on the card: a k below the largest block's count
    kt = max(1, int(cnt.max()) // 2)
    if kt < int(cnt.max()):
        topk_against(what, ci, cs, cnt, kt, shape, score)
    del score
    sub, val = G.dog_localize(dog, idx, valid)
    psub, pval = G.localize_plain(dog, idx, valid)
    err["dog_localize"] = max_abs(sub, psub)
    torch.testing.assert_close(sub, psub, rtol=0, atol=1e-5)
    torch.testing.assert_close(val, pval, rtol=1e-6, atol=0)
    check(True, f"{what}: K18 sub within {err['dog_localize']:.3g} <= 1e-5 "
                "px, val within rtol 1e-6 of the twin")
    ref = G.dog_block_topk_batch(x, lo, hi, thr, org, sigma, fmax, fmin, k,
                                 halo, rel, stages=G.PLAIN)
    check(torch.equal(outs[4], ref[4]) and torch.equal(outs[0], ref[0])
          and torch.equal(outs[3], ref[3]),
          f"{what}: the run's candidates, flags and counts equal the twins' "
          "program on the same batch")
    torch.testing.assert_close(outs[1], ref[1], rtol=0, atol=1e-5)
    torch.testing.assert_close(outs[2], ref[2], rtol=1e-6, atol=0)
    return err


def topk_against(what, ci, cs, cnt, k, shape, score):
    """K17 on one batch's candidates at ``k``: indices and flags equal to
    its twin's, and each block's index set equal to torch.topk's on the
    dense score (B, voxels; -inf off the candidates) unless the k-th score
    is tied. Returns (idx, valid)."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import dog as G

    idx, valid = G.dog_topk(ci, cs, cnt, k, shape)
    pidx, pvalid = G.topk_plain(ci, cs, cnt, k, shape)
    cut = [b for b, n in enumerate(cnt.tolist()) if n > k]
    check(torch.equal(idx, pidx) and torch.equal(valid, pvalid),
          f"{what}: K17 indices and flags equal to the twin's (k={k}; "
          f"blocks truncated: {cut})")
    top = torch.topk(score, min(k + 1, score.shape[1]), dim=1)
    for b in range(score.shape[0]):
        n = int(cnt[b])
        if n > k and float(top.values[b, k - 1]) == float(top.values[b, k]):
            print(f"  {what} block {b} (k={k}): the K-th score is tied; "
                  "torch.topk may keep another of the tied", flush=True)
            continue
        f = (idx[b, :, 0].long() * shape[1] + idx[b, :, 1]) * shape[2] \
            + idx[b, :, 2]
        lib = top.indices[b, :k][top.values[b, :k] > -np.inf]
        check(set(f[valid[b]].tolist()) == set(lib.tolist()),
              f"{what} block {b}: K17's index set equals torch.topk's on the "
              f"dense score (k={k}: {min(n, k)} of {n})")
    return idx, valid


def list_scores(cs, cnt):
    """The candidate lists' scores as one (B, max count) tensor, -inf past
    each block's count: what torch.topk reads for the same selection as
    K17 (up to ties)."""
    import numpy as np
    import torch

    m = max(int(cnt.max()), 1)
    cols = torch.arange(m, device=cs.device)
    return torch.where(cols[None, :] < cnt[:, None].long(), cs[:, :m],
                       -np.inf).contiguous()


def det_kernel_times(rec, card):
    """K15-K18 alone at one recorded batch (8a's bucket), timed with CUDA
    events beside their twins, their bounds and, for K17, torch.topk on the
    dense score and on the candidate list's scores (the library
    yardsticks, used nowhere in the port), and K17 at half the largest
    block's count (truncated)."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import dog as G
    from bigstitcher_spark_tpu_torch.ops import downsample as D

    (x, lo, hi, thr, org, sigma, fmax, fmin, k, halo, rel), _outs = rec
    xp = D.downsample_batch(x, rel) if any(r != 1 for r in rel) else x
    B = int(xp.shape[0])
    n = int(xp[0].numel())
    blurs = lambda st: G._blurs(st, xp, sigma)
    b1, b2 = blurs(G.KERNELS)
    scale = G.dog_scale(lo, hi)
    args = (b1, b2, scale, thr, org, fmax, fmin, halo, True)
    dog, ci, cs, cnt = G.dog_extrema(*args)
    shape = tuple(int(s) for s in dog.shape[1:])
    idx, valid = G.dog_topk(ci, cs, cnt, k, shape)
    cand = int(cnt.sum())
    nvalid = int(valid.sum())
    t = thr.view(B, 1, 1, 1)
    past = (int((dog > t).sum()) if fmax else 0) + (
        int((dog < -t).sum()) if fmin else 0)
    _d, mask = G.extrema_plain(*args[:-1], False)
    score = torch.where(mask, dog.abs(), -np.inf).reshape(B, -1)
    del _d, mask
    res = {}
    # K15: six passes, each reads its input (float32 here) and writes float32
    res["dog_blur"] = dict(
        ms=time_ms(lambda: blurs(G.KERNELS), reps=5),
        plain_ms=time_ms(lambda: blurs(G.PLAIN), reps=2), library_ms=None,
        bound=bound(6 * B * n * (xp.element_size() + 4),
                    2 * B * n * (len(G.gaussian_kernel_1d(sigma))
                                 + len(G.gaussian_kernel_1d(sigma * G.DOG_K)))
                    * 3))
    # K16: b1, b2 read, dog written, the candidates written; 3 operations a
    # voxel, a 27-voxel window (2 a neighbour) past the threshold
    res["dog_extrema"] = dict(
        ms=time_ms(lambda: G.dog_extrema(*args), reps=5),
        plain_ms=time_ms(lambda: G.extrema_plain(*args), reps=2),
        library_ms=None,
        bound=bound(12 * B * n + 8 * cand, 3 * B * n + OPS["dog_window"]
                    * past))
    lst = list_scores(cs, cnt)
    kl = min(k, lst.shape[1])
    kt = max(1, int(cnt.max()) // 2)
    res["dog_topk"] = dict(
        ms=time_ms(lambda: G.dog_topk(ci, cs, cnt, k, shape)),
        plain_ms=time_ms(lambda: G.topk_plain(ci, cs, cnt, k, shape)),
        library_ms=time_ms(lambda: torch.topk(score, k, dim=1)),
        library_list_ms=time_ms(lambda: torch.topk(lst, kl, dim=1)),
        truncated_k=kt,
        truncated_ms=time_ms(lambda: G.dog_topk(ci, cs, cnt, kt, shape)),
        truncated_plain_ms=time_ms(lambda: G.topk_plain(ci, cs, cnt, kt,
                                                        shape)),
        truncated_library_list_ms=time_ms(lambda: torch.topk(lst, kt, dim=1)),
        bound=bound(8 * cand + 13 * B * k, cand))
    del lst
    # K18: one round a valid candidate (4 B per gather, 12 + 1 in, 16 out)
    res["dog_localize"] = dict(
        ms=time_ms(lambda: G.dog_localize(dog, idx, valid)),
        plain_ms=time_ms(lambda: G.localize_plain(dog, idx, valid)),
        library_ms=None,
        bound=bound(nvalid * (19 * 4 + 13 + 16), nvalid * OPS["dog_fit"]))
    passes, b_in = {}, xp
    for s in (sigma, sigma * G.DOG_K):
        taps, b = G.gaussian_kernel_1d(s), b_in
        for ax in range(3):
            passes[f"{len(taps)}-tap {'xyz'[ax]}"] = time_ms(
                lambda b=b, t=taps, a=ax: G.dog_blur(b, t, a), reps=10)
            b = G.dog_blur(b, taps, ax)
    res["dog_blur"]["passes_ms"] = passes
    print(f"  dog_blur's six passes at 8a's bucket [{card}]: " + ", ".join(
        f"{k} {v} ms" for k, v in passes.items()) + "; bound "
        f"{bound(B * n * (xp.element_size() + 4), 0)[0]:.4f} ms a pass "
        "(float32 in)", flush=True)
    for name, r in res.items():
        r["wrapper_ms"] = r["ms"]
        print(f"  {name} at 8a's bucket {B} x {shape} (k {k}, {cand} "
              f"candidates, {nvalid} kept) [{card}]: kernel {r['ms']} ms  "
              f"plain {r['plain_ms']} ms  bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]})" + (f"  library {r['library_ms']} ms"
                                      if r["library_ms"] is not None else "")
              + (f" (on the list's scores {r['library_list_ms']} ms); "
                 f"truncated at k {r['truncated_k']}: kernel "
                 f"{r['truncated_ms']} ms  plain {r['truncated_plain_ms']} ms"
                 f"  library on the list "
                 f"{r['truncated_library_list_ms']} ms"
                 if "library_list_ms" in r else ""), flush=True)
    return res


def detect_run(proj, args, route, dev, card, launches):
    """One detect-interestpoints run through the CLI entry function on a
    copy of ``proj``'s XML; a spy on the detection module's DoG program
    keeps the first batch of every bucket, whose kernels are then held
    against the twins on the card. The points read back from
    interestpoints.n5 must equal the run's, and the XML must register the
    label."""
    import numpy as np

    from bigstitcher_spark_tpu_torch.cli.main import main
    from bigstitcher_spark_tpu_torch.io.interestpoints import (
        InterestPointStore)
    from bigstitcher_spark_tpu_torch.io.spimdata import SpimData
    from bigstitcher_spark_tpu_torch.models import detection as TD

    xml = os.path.join(os.path.dirname(proj.xml_path),
                       f"det_{route.replace(' ', '')}.xml")
    shutil.copy(proj.xml_path, xml)
    records, program = {}, TD.dog_block_topk_batch

    def spy(*a):
        outs = program(*a)
        key = (tuple(a[0].shape[1:]), tuple(a[10]), str(a[0].dtype))
        if key not in records:
            records[key] = (a, outs)
        return outs

    TD.dog_block_topk_batch = spy
    try:
        t0 = time.perf_counter()
        run = counted(route, launches, dev, lambda: main(
            ["detect-interestpoints", "-x", xml, *args, "--device",
             str(dev)]))
        wall = time.perf_counter() - t0
    finally:
        TD.dog_block_topk_batch = program
    st, t = run.stats, run.stats.timings
    print(f"  [detection {route}] {card}: {st.views} views, {st.blocks} "
          f"blocks in {st.buckets} buckets / {st.batches} batches, "
          f"{st.points} points ({st.truncated} blocks truncated); wall "
          f"{wall:.3f}s -> {st.core_voxels / wall:,.0f} det-res voxels/s "
          f"({st.core_voxels} core voxels); min/max {t['minmax']:.3f}s read "
          f"{t['read']:.3f}s h2d {t['h2d']:.3f}s kernels {t['kernels']:.4f}s "
          f"d2h {t['d2h']:.3f}s tail {t['tail']:.3f}s store "
          f"{t['store']:.3f}s; card idle share "
          f"{1 - t['kernels'] / wall:.4f}", flush=True)
    check(len(records) == st.buckets,
          f"detection {route}: {st.buckets} buckets recorded")
    err = {}
    for (shp, rel, dt), rec in sorted(records.items()):
        e = check_det_bucket(f"detection {route} bucket {shp} rel {rel} "
                             f"{dt} x {rec[0][0].shape[0]}", rec, dev)
        for name, v in e.items():
            err[name] = max(err.get(name, 0.0), v)
    sd = SpimData.load(xml)
    store = InterestPointStore.for_project(sd)
    for det in run.detections:
        ids, locs = store.load_points(det.view, "beads")
        check(det.view in sd.interest_points
              and "beads" in sd.interest_points[det.view]
              and len(ids) == len(det.points)
              and np.array_equal(locs, det.points),
              f"detection {route} {det.view}: {len(ids)} points read back "
              "from interestpoints.n5 equal to the run's; the XML registers "
              "'beads'")
    return run, records, err


def phase8_detection(proj, scale, dev, card, launches):
    """Phase 8: detect-interestpoints on route A's project (8a reference
    defaults, 8b full resolution, 8c overlap boxes) with the reference's
    own gates; returns K15-K18's results and 8b's detections."""
    import numpy as np
    from scipy.spatial import cKDTree

    from bigstitcher_spark_tpu_torch.io.dataset_io import ViewLoader
    from bigstitcher_spark_tpu_torch.io.spimdata import SpimData
    from bigstitcher_spark_tpu_torch.models import detection as TD

    print("phase 8 (detection)", flush=True)
    cfg = SCALES[scale]
    block = ([] if cfg["det_block"] is None else
             ["--blockSize", ",".join(str(b) for b in cfg["det_block"])])
    ref = ["-l", "beads", "-s", "1.8", "-t", "0.008", *block]
    run_a, rec_a, err_a = detect_run(
        proj, [*ref, "-dsxy", "2", "-dsz", "1"], "8a", dev, card, launches)
    # 8a again in the same process, its launches not added to the main
    # path's: its kernels column without the one-time costs of the first
    # detection run (each kernel's module loaded at its first launch)
    run_a2 = detect_run(proj, [*ref, "-dsxy", "2", "-dsz", "1"], "8a again",
                        dev, card, {})[0]
    for da, d2 in zip(run_a.detections, run_a2.detections):
        check(np.array_equal(da.points, d2.points)
              and np.array_equal(da.values, d2.values),
              f"8a again {d2.view}: {len(d2.points)} points and values "
              "identical to 8a's")
    run_b, _r, err_b = detect_run(
        proj, [*ref, "-dsxy", "1", "-dsz", "1"], "8b", dev, card, launches)
    # at the default block each view's overlap region is one block: a
    # smaller one gives the overlap grid uneven edge blocks and buckets
    run_c, _r, err_c = detect_run(
        proj, [*ref, "-dsxy", "2", "-dsz", "1", "--overlappingOnly",
               "--blockSize", ",".join(str(b) for b in cfg["det_block_c"])],
        "8c", dev, card, launches)
    tile = np.asarray(cfg["tile"])
    for det in run_b.detections:
        local = (np.asarray(proj.bead_positions)
                 - np.asarray(proj.true_offsets[det.view.setup]))
        local = local[np.all((local >= 6) & (local <= tile - 7), axis=1)]
        near = cKDTree(det.points).query(local)[0] if len(det.points) else \
            np.full(len(local), np.inf)
        check(len(local) > 0 and len(det.points) >= 0.7 * len(local)
              and (near < 1.0).mean() > 0.8,
              f"8b {det.view}: {len(det.points)} points for {len(local)} "
              f"true beads 6 px inside; {(near < 1.0).mean():.3f} of them "
              "have a detection within 1 px (> 0.8)")
    for da, db in zip(run_a.detections, run_b.detections):
        near = cKDTree(db.points).query(da.points)[0]
        check(len(da.points) > 0 and (near < 1.5).mean() > 0.7,
              f"8a {da.view}: {(near < 1.5).mean():.3f} of {len(da.points)} "
              "points within 1.5 px of an 8b point (> 0.7)")
    sd = SpimData.load(proj.xml_path)
    loader = ViewLoader(sd)
    views = sorted(sd.registrations)
    ds = np.array([2.0, 2.0, 1.0])
    for det in run_c.detections:
        plan = TD._ViewPlan(loader, det.view, tuple(int(d) for d in ds))
        boxes = TD._overlap_boxes_det(sd, det.view, views, plan.det_dims,
                                      tuple(int(d) for d in ds))
        p = (det.points - (ds - 1) / 2) / ds
        inside = np.zeros(len(p), bool)
        for b in boxes:
            inside |= np.all((p >= np.array(b.min) - 1e-9)
                             & (p <= np.array(b.max) + 1e-9), axis=1)
        check(len(p) > 0 and inside.all(),
              f"8c {det.view}: all {len(p)} points inside its "
              f"{len(boxes)} overlap boxes")
    masked, gate, dets_d = phase8d_extract(proj, run_a, scale, dev, card,
                                           launches)
    one_device = {"8a": run_a.detections, "8d": dets_d}
    if dev.type != "cuda":
        return {}, run_b.detections, gate, one_device
    res = det_kernel_times(next(iter(rec_a.values())), card)
    for name, r in res.items():
        r["err"] = max(err_a.get(name, 0.0), err_b.get(name, 0.0),
                       err_c.get(name, 0.0))
    res["knn_descriptors_masked"] = masked
    return res, run_b.detections, gate, one_device


def descriptor_cloud(det, dev):
    """A view's valid riders as K20's input: (N * S, 3n) float32 and the
    owner (point index) of each row."""
    import numpy as np
    import torch

    keep = np.nonzero(det.descriptor_valid)[0]
    d = torch.from_numpy(np.ascontiguousarray(det.descriptors[keep])).to(dev)
    n, S, D = (int(v) for v in d.shape)
    owner = torch.from_numpy(keep.astype(np.int32)).to(dev)
    return d.reshape(n * S, D), owner.repeat_interleave(S)


def phase8d_extract(proj, run_a, scale, dev, card, launches):
    """Phase 8d: 8a's arguments through detect_interest_points with
    extract_descriptors (K15-K18, then K19's masked form on each block's
    candidate slots). The points and values must be 8a's; every batch's
    descriptors and flags bitwise the twin's on the same candidates; every
    view riders for all its points, some valid; and K20's ratio test on
    the riders of route A's view pairs (9a's ratio, 3.0) must join the
    same true bead (< 5 px) for at least 0.7 of its candidates. Returns
    the masked K19's numbers at 8a's bucket and (candidates, joined)."""
    import itertools

    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch import ops
    from bigstitcher_spark_tpu_torch.io.dataset_io import ViewLoader
    from bigstitcher_spark_tpu_torch.io.spimdata import SpimData
    from bigstitcher_spark_tpu_torch.models import detection as TD
    from bigstitcher_spark_tpu_torch.ops import descriptors as DS

    print("phase 8d (detection with descriptor extraction)", flush=True)
    cfg = SCALES[scale]
    block = ({} if cfg["det_block"] is None else
             dict(block_size=tuple(cfg["det_block"])))
    params = TD.DetectionParams(label="beads", sigma=1.8, threshold=0.008,
                                downsample_xy=2, downsample_z=1,
                                extract_descriptors=True, **block)
    sd = SpimData.load(proj.xml_path)
    records, program = [], TD.dog_detect_extract_batch

    def spy(*a):
        outs = program(*a)
        records.append(outs)
        return outs

    stats = TD.DetectionStats()
    TD.dog_detect_extract_batch = spy
    try:
        t0 = time.perf_counter()
        dets = counted("8d", launches, dev, lambda: TD.detect_interest_points(
            sd, ViewLoader(sd), [d.view for d in run_a.detections], params,
            progress=False, device=dev, stats=stats))
        wall = time.perf_counter() - t0
    finally:
        TD.dog_detect_extract_batch = program
    n_k19 = ops.launch_counts()["knn_descriptors"]
    t = stats.timings
    print(f"  [detection 8d] {card}: {stats.blocks} blocks in "
          f"{stats.batches} batches, {stats.points} points; wall {wall:.3f}s "
          f"(8a {run_a.stats.seconds:.3f}s in detect_interest_points): "
          f"read {t['read']:.3f}s h2d {t['h2d']:.3f}s kernels "
          f"{t['kernels']:.4f}s d2h {t['d2h']:.3f}s tail {t['tail']:.3f}s; "
          f"{n_k19} K19 launches", flush=True)
    for da, dd in zip(run_a.detections, dets):
        check(dd.view == da.view and np.array_equal(dd.points, da.points)
              and np.array_equal(dd.values, da.values),
              f"8d {dd.view}: {len(dd.points)} points and values identical "
              "to 8a's")
        check(dd.descriptors.shape[0] == len(dd.descriptor_valid)
              == len(dd.points) and bool(dd.descriptor_valid.any()),
              f"8d {dd.view}: descriptors {dd.descriptors.shape} for every "
              f"point, {int(dd.descriptor_valid.sum())} valid")
    err, same = 0.0, True
    for outs in records:
        sub, valid, desc, dv = outs[1], outs[3], outs[5], outs[6]
        _, pdesc, pdv = DS.knn_descriptors_plain(sub, valid, 3, 1, True)
        err = max(err, max_abs(desc, pdesc))
        same &= torch.equal(desc, pdesc) and torch.equal(dv, pdv)
    check(same, f"8d: in each of {len(records)} batches of "
                f"{tuple(records[0][1].shape[:2])} slots K19's masked "
                "descriptors and flags bitwise equal to the twin's on the "
                "same candidates")
    total = joined = 0
    for da, db in itertools.combinations(dets, 2):
        (a, oa), (b, ob) = descriptor_cloud(da, dev), descriptor_cloud(db, dev)
        if not len(a) or not len(b):
            continue
        mb, acc = DS.match_ratio_test(a, oa, b, ob, 3.0)
        pairs = np.unique(np.stack([oa[acc].cpu().numpy(),
                                    mb[acc].cpu().numpy()], 1), axis=0)
        wa = da.points[pairs[:, 0]] + proj.true_offsets[da.view.setup]
        wb = db.points[pairs[:, 1]] + proj.true_offsets[db.view.setup]
        ok = int((np.linalg.norm(wa - wb, axis=1) < 5.0).sum())
        print(f"  8d ratio test {da.view.setup}-{db.view.setup}: "
              f"{len(pairs)} candidates, {ok} join the same bead", flush=True)
        total, joined = total + len(pairs), joined + ok
    what = (f"8d: K20's ratio test on the riders gives {total} candidates, "
            f"{joined} ({joined / max(total, 1):.3f} >= 0.7) join the same "
            "true bead within 5 px")
    if scale == "tiny":  # 32x32x16 blocks split each view's neighbourhoods
        print(f"  (not gated at scale tiny) {what}", flush=True)
    else:
        check(total >= 20 and joined >= 0.7 * total, what)
    if dev.type != "cuda":
        return None, (total, joined), dets
    sub, valid = records[0][1], records[0][3]
    run = lambda: DS.knn_descriptors(sub, valid, 3, 1, True, want_idx=False)
    plain = lambda: DS.knn_descriptors_plain(sub, valid, 3, 1, True)
    B, K = (int(v) for v in sub.shape[:2])
    nv = valid.sum(1).to(torch.float64)
    S = int(records[0][5].shape[2])
    r = dict(err=err, launches=n_k19, ms=time_ms(run, reps=10),
             plain_ms=time_ms(plain, reps=2, rounds=1), library_ms=None,
             bound=bound(B * K * (13 + S * 36 + 1),
                         float((nv * nv).sum()) * OPS["knn_pair"]),
             issue_floor_ms=knn_issue_floor_ms(float((nv * nv).sum())))
    print(f"  knn_descriptors (K19, masked) at 8a's bucket {B} blocks x {K} "
          f"slots ({int(nv.sum())} valid) [{card}]: kernel {r['ms']} ms  "
          f"plain {r['plain_ms']} ms  bound {r['bound'][0]:.4f} ms "
          f"({r['bound'][1]}; at one operation an instruction "
          f"{r['issue_floor_ms']:.4f} ms)  launches in 8d {n_k19}",
          flush=True)
    return r, (total, joined), dets


# ---------------------------------------------------------------- phase 9


def match_kernel_checks(what, wa, wb, dev, rows=None, iterations=10000,
                        seed=17, tail_rows=0):
    """K19-K22 against their twins on the card at one pair's shapes: the
    clouds ``wa``, ``wb`` (world coordinates), their descriptors at the
    reference defaults (-n 3 -r 1, FAST_ROTATION), the candidates and
    ``iterations`` hypotheses drawn as the run draws them. ``rows`` (a
    slice) limits the twins of K19 and K20 to those rows of A; with
    ``tail_rows`` K20 is also held on A's last ``tail_rows`` descriptor
    rows (its ragged last row block). K19: indices and flags equal,
    descriptors bitwise; K20: owners and accept flags equal, best
    distances bitwise, and in nearest mode (no owners) the columns equal
    and the distances bitwise; K21: counts and models bitwise, the
    same best; K22: masks and counts equal, models within rtol 1e-9 /
    atol 1e-9 (float64 moments summed in another order). Returns (max
    |delta| per kernel, the inputs for timing)."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import descriptors as DS

    rows = rows if rows is not None else slice(0, len(wa))
    pa = torch.from_numpy(np.ascontiguousarray(wa, np.float32)).to(dev)
    pb = torch.from_numpy(np.ascontiguousarray(wb, np.float32)).to(dev)
    err = {}
    got = DS.knn_descriptors(pa[None], None, 3, 1, True)
    ref = DS.knn_descriptors_plain(pa[None], None, 3, 1, True, rows=rows)
    same = all(torch.equal(g[:, rows], r) for g, r in zip(got, ref))
    err["knn_descriptors"] = max_abs(got[1][:, rows], ref[1])
    check(same, f"{what}: K19 indices, descriptors and flags of rows "
                f"{rows.start}-{rows.stop} of {len(wa)} equal the twin's")
    da = got[1].reshape(-1, 9)
    db = DS.knn_descriptors(pb[None], None, 3, 1, True)[1].reshape(-1, 9)
    s = 4
    ob = torch.arange(len(wb), dtype=torch.int32, device=dev
                      ).repeat_interleave(s)
    drows = slice(rows.start * s, rows.stop * s)
    best, bestd, acc = DS.ratio_match(da, db, ob, 3.0)
    err["ratio_match"] = 0.0
    slices = [drows] + ([slice(len(da) - tail_rows, len(da))] if tail_rows
                        else [])
    for sl in slices:
        pbest, pbestd, pacc = DS.ratio_match_plain(da, db, ob, 3.0, rows=sl)
        e = max_abs(bestd[sl], pbestd)
        err["ratio_match"] = max(err["ratio_match"], e)
        check(torch.equal(best[sl], pbest) and torch.equal(acc[sl], pacc)
              and e == 0.0,
              f"{what}: K20 owners, accept flags and distances of "
              f"descriptors {sl.start}-{sl.stop} of {len(da)} equal the "
              f"twin's ({len(db)} columns)")
    # nearest mode (ICP's), a filter of its own (the threshold on d1)
    nbest, nbestd, _n = DS.ratio_match(da, db, None, 3.0)
    for sl in slices:
        pbest, pbestd, _p = DS.ratio_match_plain(da, db, None, 3.0, rows=sl)
        e = max_abs(nbestd[sl], pbestd)
        err["ratio_match"] = max(err["ratio_match"], e)
        check(torch.equal(nbest[sl], pbest) and e == 0.0,
              f"{what}: K20 nearest mode, columns and distances of "
              f"descriptors {sl.start}-{sl.stop} of {len(da)} equal the "
              f"twin's ({len(db)} columns)")
    oa = torch.arange(len(wa), device=dev).repeat_interleave(s)
    cand = torch.unique(torch.stack([oa[acc], best[acc].long()], 1), dim=0)
    ca = pa[cand[:, 0]].contiguous()
    cb = pb[cand[:, 1]].contiguous()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    idx = DS.draw_hypotheses(len(cand), iterations, 4, gen)
    got = DS.ransac_score(ca, cb, idx, 5.0, "AFFINE")
    ref = DS.ransac_score_plain(ca, cb, idx, 5.0, "AFFINE")
    # a degenerate sample fits NaN on both sides
    fin = torch.isfinite(ref[1])
    err["ransac_score"] = max_abs(got[1][fin], ref[1][fin])
    check(all(torch.equal(g, r) for g, r in zip(got[::2], ref[::2]))
          and torch.equal(got[3], ref[3]) and torch.equal(fin, torch.isfinite(
              got[1])) and err["ransac_score"] == 0.0,
          f"{what}: K21 counts, models and best (#{int(got[2][0])}, "
          f"{int(got[2][1])} of {len(cand)} candidates) of {iterations} "
          "hypotheses equal the twin's")
    model, e = got[3], 0.0
    for fit in (True, True, False):
        g = DS.ransac_refit(ca, cb, model, 5.0, "AFFINE", "RIGID", 0.1, fit)
        r = DS.ransac_refit_plain(ca, cb, model, 5.0, "AFFINE", "RIGID", 0.1,
                                  fit)
        check(torch.equal(g[0], r[0]) and int(g[1]) == int(r[1]),
              f"{what}: K22 inliers ({int(g[1])}) equal the twin's")
        if fit:
            torch.testing.assert_close(g[2], r[2], rtol=1e-9, atol=1e-9)
            e = max(e, max_abs(g[2], r[2]))
            model = g[2]
    err["ransac_refit"] = e
    check(True, f"{what}: K22 models within {e:.3g} of the twin's "
                "(rtol 1e-9 / atol 1e-9)")
    return err, dict(pa=pa, pb=pb, da=da, db=db, ob=ob, ca=ca, cb=cb,
                     idx=idx, model=got[3], rows=rows, drows=drows)


def match_kernel_times(t, card, at_9a=None):
    """K19-K22 alone at 9b's shapes, timed with CUDA events beside their
    bounds; the twins of K19 and K20 on the checked row slice of A (the
    whole cloud's twin would take minutes), those of K21 and K22 at the
    full shape; K21 also at 9a's shape (``at_9a``: the inputs
    :func:`match_kernel_checks` returned for 9a's pair). No single PyTorch
    call computes any of the four (K20's owner-aware second best least of
    all): library "none"."""
    import torch

    from bigstitcher_spark_tpu_torch.ops import descriptors as DS

    n, nb = len(t["pa"]), len(t["pb"])
    da, db, ob, rows, drows = t["da"], t["db"], t["ob"], t["rows"], t["drows"]
    m, iters = len(t["ca"]), len(t["idx"])
    nrows, ndrows = rows.stop - rows.start, drows.stop - drows.start
    res = {}
    res["knn_descriptors"] = dict(
        ms=time_ms(lambda: DS.knn_descriptors(t["pa"][None], None, 3, 1,
                                              True), reps=3),
        plain_ms=time_ms(lambda: DS.knn_descriptors_plain(
            t["pa"][None], None, 3, 1, True, rows=rows), reps=1, rounds=1),
        plain_shape=f"rows {rows.start}-{rows.stop} of {n}",
        library_ms=None,
        bound=bound(n * (12 + 16 + 4 * 36), n * n * OPS["knn_pair"]),
        issue_floor_ms=knn_issue_floor_ms(float(n) * n))
    DS.ratio_match(da, db, ob, 3.0)
    refined = ratio_refined(DS)
    res["ratio_match"] = dict(
        ms=time_ms(lambda: DS.ratio_match(da, db, ob, 3.0), reps=2),
        plain_ms=time_ms(lambda: DS.ratio_match_plain(da, db, ob, 3.0,
                                                      rows=drows),
                         reps=1, rounds=1),
        plain_shape=f"rows {drows.start}-{drows.stop} of {len(da)}",
        library_ms=None, refined=refined,
        refined_share=refined / (float(len(da)) * len(db)),
        center_ms=time_ms(lambda: DS.ratio_center(db), reps=10))
    res["ratio_match"]["bound"], res["ratio_match"]["simt_bound_ms"] = \
        ratio_bound(len(da), len(db), 9, refined)
    res["ransac_score"] = dict(
        ms=time_ms(lambda: DS.ransac_score(t["ca"], t["cb"], t["idx"], 5.0,
                                           "AFFINE"), reps=5),
        plain_ms=time_ms(lambda: DS.ransac_score_plain(
            t["ca"], t["cb"], t["idx"], 5.0, "AFFINE"), reps=1, rounds=1),
        plain_shape="full", library_ms=None,
        bound=bound(m * 24 + iters * (16 + 4 + 48),
                    iters * m * OPS["ransac_apply"]),
        issue_floor_ms=issue_floor_ms(iters * m * OPS["ransac_apply"]))
    res["ransac_refit"] = dict(
        ms=time_ms(lambda: DS.ransac_refit(t["ca"], t["cb"], t["model"], 5.0,
                                           "AFFINE", "RIGID", 0.1)),
        plain_ms=time_ms(lambda: DS.ransac_refit_plain(
            t["ca"], t["cb"], t["model"], 5.0, "AFFINE", "RIGID", 0.1)),
        plain_shape="full", library_ms=None,
        bound=bound(m * 25, m * OPS["refit_row"], F64_OPS_PER_S))
    # K22's third launch a RANSAC: the mask alone (no moments, no fit)
    args22 = (t["ca"], t["cb"], t["model"], 5.0, "AFFINE", "RIGID", 0.1)
    nofit = lambda: DS.ransac_refit(*args22, fit=False)
    res["ransac_refit"].update(
        nofit_ms=time_ms(nofit), nofit_wrapper_ms=time_ms(nofit, host=True),
        nofit_plain_ms=time_ms(lambda: DS.ransac_refit_plain(
            *args22, fit=False)),
        nofit_bound_ms=bound(m * 25, m * OPS["ransac_apply"],
                             F64_OPS_PER_S)[0])
    shapes = {"knn_descriptors": f"{n} points (and {nb})",
              "ratio_match": f"{len(da)} x {len(db)} descriptors of 9",
              "ransac_score": f"{iters} hypotheses x {m} candidates",
              "ransac_refit": f"{m} candidates"}
    res["ratio_match"]["wrapper_ms"] = time_ms(
        lambda: DS.ratio_match(da, db, ob, 3.0), reps=2, host=True)
    if at_9a is not None:
        m9, i9 = len(at_9a["ca"]), len(at_9a["idx"])
        args9 = (at_9a["ca"], at_9a["cb"], at_9a["idx"], 5.0, "AFFINE")
        run9 = lambda: DS.ransac_score(*args9)
        r = res["ransac_score"]
        r.update(at_9a_ms=time_ms(run9, reps=50),
                 at_9a_wrapper_ms=time_ms(run9, reps=50, host=True),
                 at_9a_plain_ms=time_ms(
                     lambda: DS.ransac_score_plain(*args9), reps=5),
                 at_9a_bound_ms=bound(m9 * 24 + i9 * (16 + 4 + 48),
                                      i9 * m9 * OPS["ransac_apply"])[0],
                 at_9a_shape=f"{i9} hypotheses x {m9} candidates")
        print(f"  ransac_score at 9a's {r['at_9a_shape']} [{card}]: kernel "
              f"{r['at_9a_ms']} ms  with the host's time "
              f"{r['at_9a_wrapper_ms']} ms  plain {r['at_9a_plain_ms']} ms  "
              f"bound {r['at_9a_bound_ms']:.5f} ms", flush=True)
        # K22 at 9a's pair from K21's best model there: both forms
        r = res["ransac_refit"]
        a22 = (at_9a["ca"], at_9a["cb"], at_9a["model"], 5.0, "AFFINE",
               "RIGID", 0.1)
        for key, fit in (("at_9a", True), ("at_9a_nofit", False)):
            run = lambda fit=fit: DS.ransac_refit(*a22, fit=fit)
            r.update({f"{key}_ms": time_ms(run, reps=50),
                      f"{key}_wrapper_ms": time_ms(run, reps=50, host=True),
                      f"{key}_plain_ms": time_ms(
                          lambda fit=fit: DS.ransac_refit_plain(*a22,
                                                                fit=fit))})
        r.update(at_9a_bound_ms=bound(m9 * 25, m9 * OPS["refit_row"],
                                      F64_OPS_PER_S)[0],
                 at_9a_shape=f"{m9} candidates")
        print(f"  ransac_refit at 9a's {m9} candidates [{card}]: kernel "
              f"{r['at_9a_ms']} ms (mask alone {r['at_9a_nofit_ms']} ms)  "
              f"with the host's time {r['at_9a_wrapper_ms']} ms  plain "
              f"{r['at_9a_plain_ms']} ms  bound {r['at_9a_bound_ms']:.5f} ms",
              flush=True)
    for name, r in res.items():
        r.setdefault("wrapper_ms", r["ms"])
        print(f"  {name} at 9b's {shapes[name]} [{card}]: kernel {r['ms']} "
              f"ms  plain {r['plain_ms']} ms ({r['plain_shape']})  bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]})  library none",
              flush=True)
    r = res["ransac_refit"]
    print(f"  ransac_refit at 9b, the mask alone (fit=False) [{card}]: "
          f"kernel {r['nofit_ms']} ms  with the host's time "
          f"{r['nofit_wrapper_ms']} ms  plain {r['nofit_plain_ms']} ms  "
          f"bound {r['nofit_bound_ms']:.4f} ms", flush=True)
    print(f"  knn_descriptors at 9b: the floor at one operation an "
          f"instruction {res['knn_descriptors']['issue_floor_ms']:.4f} ms",
          flush=True)
    r = res["ratio_match"]
    print(f"  ratio_match at 9b [{card}]: {r['refined']} pairs refined "
          f"exactly (share {r['refined_share']:.3e} of "
          f"{len(da)} x {len(db)}); B's mean alone {r['center_ms']} ms; "
          f"with the host's time {r['wrapper_ms']} ms; the exact SIMT "
          f"work's bound {r['simt_bound_ms']:.4f} ms", flush=True)
    return res


def ratio_bound(Da, Db, D, refined):
    """K20's bound for the work of the filter-and-refine design: the TF32
    dot of depth D + 1 (the D products and b2 folded in as one more term:
    2 (D + 1) operations a pair; the zeros that pad the MMA's depth to 12
    for D = 9 are the instruction shape's cost, not the function's) at
    the tensor cores' dense rate, plus one float32 compare a pair and the
    refined pairs' 2D + 3 exact operations at the float32 rate; beside it
    the bound of the exact SIMT work alone (2D + 3 a pair, float32), the
    one-thread-a-row form's. Bytes (A, B, owners, outputs) are far below
    both. Returns ((ms, "operations"), simt ms)."""
    pairs = float(Da) * float(Db)
    ms = (pairs * 2 * (D + 1) / TF32_OPS_PER_S
          + (pairs + float(refined) * (2 * D + 3)) / F32_OPS_PER_S) * 1e3
    tb = bound((Da + Db) * D * 4 + Db * 4 + Da * 9, 0)[0]
    simt = bound(0, pairs * (2 * D + 3))[0]
    return (max(ms, tb), "operations" if ms >= tb else "bytes"), simt


def ratio_refined(DS):
    """The pairs K20's last launch refined exactly (None for a tree whose
    K20 has no filter)."""
    t = getattr(DS.ratio_match, "refined", None)
    return None if t is None else int(t.item())


def issue_floor_ms(ops) -> float:
    """A float32 kernel's floor at one operation an instruction: ``ops``
    operations (counted as its bound counts them), each its own
    instruction (the kernels are built with -fmad=false), at half
    F32_OPS_PER_S (which counts an FMA as two)."""
    return ops / (F32_OPS_PER_S / 2) * 1e3


def knn_issue_floor_ms(pairs) -> float:
    """K19's floor at one operation an instruction: its OPS["knn_pair"]
    operations a pair (:func:`issue_floor_ms`)."""
    return issue_floor_ms(pairs * OPS["knn_pair"])


def knn_masked_bucket(scale, seed=2024):
    """8d's masked K19 input at 8a's bucket: 2 blocks (8a's batch at -dsxy
    2) of 4,096 candidate slots, the first 431 and 430 of them valid (8a's
    1,723 points over its 4 blocks; K17 fills the slots in score order),
    block-local subpixel coordinates uniform in a 512 x 512 x 128 block
    (every slot, valid or not); at scale tiny 2 blocks of 512 slots, 40 and
    37 valid, in 64 x 64 x 32. Returns (points (B, K, 3) float32, valid
    (B, K) bool) as numpy arrays."""
    import numpy as np

    K, counts, ext = ((4096, (431, 430), (512, 512, 128)) if scale == "full"
                      else (512, (40, 37), (64, 64, 32)))
    rng = np.random.default_rng(seed)
    pts = (rng.uniform(0, 1, (len(counts), K, 3)) * np.array(ext)).astype(
        np.float32)
    valid = np.arange(K)[None, :] < np.array(counts)[:, None]
    return pts, valid


def knn_yardsticks(dev, card, outputs=None, scale="full"):
    """K19 at 9b's cloud (A of :func:`make_clouds`: 100,000 points at full
    scale; -n 3 -r 1, rotation invariant) and its masked form at 8d's
    bucket (:func:`knn_masked_bucket`): each bitwise its twin (the dense
    form on A's first 4,096 and last 2,048 rows, the masked form whole:
    indices, descriptors and flags), card time, time with the host's,
    the twin's time, the bound and the issue floor
    (:func:`knn_issue_floor_ms`); with ``outputs`` the indices,
    descriptors and flags held (:func:`hold_outputs`)."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import descriptors as DS

    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    res = {}
    pa = c(make_clouds(scale)[0].astype(np.float32))[None]
    n = int(pa.shape[1])
    run = lambda: DS.knn_descriptors(pa, None, 3, 1, True)
    got = run()
    checked = (slice(0, min(4096, n)), slice(max(0, n - 2048), n))
    err = 0.0
    for rows in checked:
        ref = DS.knn_descriptors_plain(pa, None, 3, 1, True, rows=rows)
        check(all(torch.equal(g[:, rows], e) for g, e in zip(got, ref)),
              f"K19 dense at 9b's cloud ({n} points), rows "
              f"{rows.start}-{rows.stop}: indices, descriptors and flags "
              "bitwise the twin's")
        err = max(err, max_abs(got[1][:, rows], ref[1]))
    held = {}
    hold_outputs(outputs, "knn_descriptors dense", got, held)
    pairs = float(n) * n
    res["knn_descriptors"] = dict(
        err=err, ms=time_ms(run, reps=5), host_ms=time_ms(run, reps=5,
                                                          host=True),
        plain_ms=time_ms(lambda: DS.knn_descriptors_plain(
            pa, None, 3, 1, True, rows=checked[0]), reps=1, rounds=1),
        plain_shape=f"rows 0-{checked[0].stop} of {n}", library_ms=None,
        bound=bound(n * (12 + 16 + 4 * 36), pairs * OPS["knn_pair"]),
        issue_floor_ms=knn_issue_floor_ms(pairs), shape=f"{n} points",
        **held)
    del got
    pts, valid = knn_masked_bucket(scale)
    sub, val = c(pts), c(valid)
    run = lambda: DS.knn_descriptors(sub, val, 3, 1, True)
    plain = lambda: DS.knn_descriptors_plain(sub, val, 3, 1, True)
    got, ref = run(), plain()
    check(all(torch.equal(g, e) for g, e in zip(got, ref)),
          f"K19 masked at 8d's bucket {tuple(sub.shape[:2])}: indices, "
          "descriptors and flags bitwise the twin's")
    held = {}
    hold_outputs(outputs, "knn_descriptors masked", got, held)
    B, K = (int(v) for v in sub.shape[:2])
    nv = val.sum(1).to(torch.float64)
    S = int(got[1].shape[2])
    vpairs = float((nv * nv).sum())
    res["knn_descriptors masked"] = dict(
        err=max_abs(got[1], ref[1]), ms=time_ms(run, reps=10),
        host_ms=time_ms(run, reps=10, host=True),
        plain_ms=time_ms(plain, reps=2, rounds=1), library_ms=None,
        bound=bound(B * K * (13 + S * 36 + 1), vpairs * OPS["knn_pair"]),
        issue_floor_ms=knn_issue_floor_ms(vpairs),
        shape=f"{B} blocks x {K} slots ({int(nv.sum())} valid)", **held)
    for k, r in res.items():
        print_times(f"{k} at {r['shape']}", {**r, "wrapper_ms": r["host_ms"]},
                    card)
        print(f"  {k}: issue floor (one op an instruction) "
              f"{r['issue_floor_ms']:.4f} ms", flush=True)
    return res


def ratio_times(da, db, ob, card, check_rows=(slice(0, 4096),)):
    """K20 at one shape (9b's: 400,000 x 400,000 descriptors of 9, owners
    in runs of 4): bitwise against the twin on each row slice of
    ``check_rows`` (owners, distances, accept flags, and in nearest mode
    columns and distances), then its card time back to back, its time
    with the host's (no spin), B's mean alone on the card, the pairs
    refined and the bounds. Works on a tree whose K20 predates the filter
    (no refined count, no mean alone)."""
    import torch

    from bigstitcher_spark_tpu_torch.ops import descriptors as DS

    Da, D = (int(v) for v in da.shape)
    Db = int(db.shape[0])
    for own in (ob, None):
        got = DS.ratio_match(da, db, own, 3.0)
        for rows in check_rows:
            ref = DS.ratio_match_plain(da, db, own, 3.0, rows=rows)
            same = (torch.equal(got[0][rows], ref[0])
                    and torch.equal(got[1][rows], ref[1])
                    and (own is None or torch.equal(got[2][rows], ref[2])))
            check(same, f"K20 ({'ratio' if own is not None else 'nearest'}"
                        f" mode) rows {rows.start}-{rows.stop} of {Da} x "
                        f"{Db}: bitwise the twin's")
    DS.ratio_match(da, db, ob, 3.0)
    refined = ratio_refined(DS)
    r = dict(ms=time_ms(lambda: DS.ratio_match(da, db, ob, 3.0), reps=2),
             wrapper_ms=time_ms(lambda: DS.ratio_match(da, db, ob, 3.0),
                                reps=2, host=True),
             refined=refined,
             refined_share=(None if refined is None
                            else refined / (float(Da) * Db)),
             center_ms=(time_ms(lambda: DS.ratio_center(db), reps=10)
                        if hasattr(DS, "ratio_center") else None))
    r["bound"], r["simt_bound_ms"] = ratio_bound(Da, Db, D, refined or 0)
    print(f"  ratio_match {Da} x {Db} descriptors of {D} [{card}]: kernel "
          f"{r['ms']} ms  with the host's time {r['wrapper_ms']} ms  bound "
          f"{r['bound'][0]:.4f} ms ({r['bound'][1]}; the exact SIMT work "
          f"alone {r['simt_bound_ms']:.4f} ms)  refined pairs {refined} "
          f"(share {r['refined_share']})  B's mean alone "
          f"{r['center_ms']} ms", flush=True)
    return r


def blur_times(xp, sigma, card):
    """K15's six passes (sigma and sigma 2^(1/4), along x, y, z) on
    ``xp``, each bitwise against the twin on the card, each timed alone
    (card time, back to back), the six together, and the six with the
    host's time; the bound a pass (its input read once, its float32
    output written once)."""
    import torch

    from bigstitcher_spark_tpu_torch.ops import dog as G

    B = int(xp.shape[0])
    n = int(xp[0].numel())
    passes, b_in = {}, []
    for s in (sigma, sigma * G.DOG_K):
        taps, b = G.gaussian_kernel_1d(s), xp
        for ax in range(3):
            nb = G.dog_blur(b, taps, ax)
            check(torch.equal(nb, G.blur_plain(b, taps, ax)),
                  f"K15 {len(taps)} taps along axis {ax} of "
                  f"{tuple(xp.shape)}: bitwise the twin's")
            key = f"{len(taps)}-tap {'xyz'[ax]}"
            passes[key] = time_ms(lambda b=b, t=taps, a=ax: G.dog_blur(b, t, a),
                                  reps=10)
            b_in.append(b.element_size())
            b = nb
    six = lambda: G._blurs(G.KERNELS, xp, sigma)
    r = dict(passes_ms=passes, ms=time_ms(six, reps=5),
             wrapper_ms=time_ms(six, reps=5, host=True),
             bound=bound(sum(B * n * (e + 4) for e in b_in), 0),
             pass_bound_ms=bound(B * n * (4 + 4), 0)[0])
    print(f"  dog_blur six passes at {tuple(xp.shape)} {xp.dtype} [{card}]: "
          f"{r['ms']} ms (with the host's time {r['wrapper_ms']} ms), bound "
          f"{r['bound'][0]:.4f} ms; a float32 pass's bound "
          f"{r['pass_bound_ms']:.4f} ms; passes " + ", ".join(
              f"{k} {v} ms" for k, v in passes.items()), flush=True)
    return r


def coeff_block_inputs(rng, c, bs=(256, 256, 64)):
    """K3's coefficient branch at 10c's tile-corner block: its geometry
    (the block -> patch translations and patch offsets that route A's
    registered views give the block at (768, 512, 0): 4 views of 1024 x
    1024 x 128, parts of the block outside each, the first z taps clamped
    in three), blend ranges 40, 4 uint16 patches of 288 x 288 x 96 and 8 x
    8 x 8 grids of [scale, offset] drawn from ``rng``, with their level
    position -> grid affines (``_coeff_grid_affine`` at level 0). Returns
    (the wrapper's first seven arguments, inside offsets, coefficient
    keywords)."""
    import numpy as np

    V, ps, view = 4, tuple(b + 32 for b in bs), np.array([1024, 1024, 128])
    patches = c(rng.integers(90, 4000, (V, *ps)).astype(np.uint16))
    aff = np.zeros((V, 3, 4), np.float32)
    aff[:, :, :3] = np.eye(3)
    aff[:, :, 3] = [[1, 1, 0], [-152, 1, -1], [1, -158, -1], [-153, -158, -2]]
    offs = np.array([[767, 767, 0], [0, 767, 0], [766, 0, 0], [0, 0, 0]],
                    np.float32)
    cdims = (8, 8, 8)
    grids = np.empty((V, *cdims, 2), np.float32)
    grids[..., 0] = rng.uniform(0.7, 1.4, (V, *cdims))
    grids[..., 1] = rng.uniform(-30, 30, (V, *cdims))
    cs = view / np.array(cdims)
    caff = np.zeros((V, 3, 4), np.float32)
    caff[:, :, :3] = np.diag(1.0 / cs)
    caff[:, :, 3] = 0.5 / cs - 0.5
    dims = np.tile(view.astype(np.float32), (V, 1))
    z3 = np.zeros((V, 3), np.float32)
    args = [patches] + [c(a) for a in (aff, offs, dims, z3, z3 + 40.0,
                                       np.ones(V, np.float32))]
    return args, c(z3), dict(coeffs=c(grids), coeff_affines=c(caff))


def nonrigid_block_inputs(rng, c, bs=(256, 256, 64), cpd=10.0):
    """K26 at phase 11's tile-corner block, synthesised from ``rng``: 4
    uint16 views of 288 x 288 x 96, (29, 29, 10) vertex grids at -cpd 10
    fitted (``fit_control_grid``) to 40 points each displaced by ~1 px
    from the block's world positions, view affines rotated by up to 0.15
    rad about z, parts of the block outside each view. Returns the
    wrapper's first eleven arguments."""
    import numpy as np

    from bigstitcher_spark_tpu_torch.models.nonrigid_fusion import (
        control_grid_dims)
    from bigstitcher_spark_tpu_torch.ops.nonrigid import fit_control_grid

    V, ps = 4, tuple(b + 32 for b in bs)
    bo = np.array([900.0, 900.0, 32.0], np.float32)
    go = bo - np.float32(cpd)
    gdims = control_grid_dims(bs, cpd)
    grids = np.zeros((V, *gdims, 12), np.float32)
    vaff = np.zeros((V, 3, 4), np.float32)
    offs = np.zeros((V, 3), np.float32)
    for v in range(V):
        t = bo + rng.uniform(-10, 266, (40, 3)) * np.array([1, 1, 0.25])
        vw = t + rng.normal(0, 0.8, (40, 3)) + rng.uniform(-2, 2, 3)
        grids[v] = fit_control_grid(t, vw, go.astype(np.float64), gdims, cpd)
        ang = 0.05 * v
        lin = np.array([[np.cos(ang), -np.sin(ang), 0],
                        [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
        vaff[v, :, :3] = lin
        vaff[v, :, 3] = -lin @ bo + 16.0 + rng.uniform(-0.5, 0.5, 3)
        offs[v] = [0 if v & 1 else 800, 0 if v & 2 else 800, 0]
    patches = rng.integers(90, 4000, (V, *ps)).astype(np.uint16)
    dims = np.tile(np.array([1024, 1024, 128], np.float32), (V, 1))
    arrays = (patches, grids, vaff, offs, dims, np.zeros((V, 3), np.float32),
              np.full((V, 3), 40.0, np.float32), np.ones(V, np.float32), bo,
              go, np.full(3, cpd, np.float32))
    return [c(a) for a in arrays]


NONRIGID_ROWS = 4  # phase 14b's batch: --devices 4 x per_dev 1


def nonrigid_batch_times(rng, c, bs, dev):
    """K26's batch form at NONRIGID_ROWS distinct rows of phase 11's
    four-view block (:func:`nonrigid_block_inputs`, each row its own
    draws): every row bitwise the per-block K26 on its inputs, the batch
    within the per-block tolerance of its twin (a loop of the per-block
    twin), one launch timed beside NONRIGID_ROWS x the per-block time, and
    the bound of the batch."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import nonrigid as NR

    rows = [nonrigid_block_inputs(rng, c, bs) for _ in range(NONRIGID_ROWS)]
    args = [torch.stack([r[j] for r in rows]) for j in range(11)]
    run = lambda: NR.nonrigid_fuse_block_batch(*args, bs, "AVG_BLEND")
    plain = lambda: NR.nonrigid_fuse_block_batch_plain(*args, bs,
                                                       "AVG_BLEND")
    got, ref = run(), plain()
    same = all(torch.equal(g[b], w) for b in range(NONRIGID_ROWS)
               for g, w in zip(got, NR.nonrigid_fuse_block(
                   *rows[b], bs, "AVG_BLEND")))
    check(same, f"nonrigid_fuse_batch: each of {NONRIGID_ROWS} distinct rows "
                "bitwise the per-block K26's on its inputs")
    check(len({float(g.sum()) for g in got[0]}) == NONRIGID_ROWS,
          f"nonrigid_fuse_batch: the {NONRIGID_ROWS} rows differ")
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)
    err = max(max_abs(got[0], ref[0]), max_abs(got[1], ref[1]))
    del got, ref
    V, nb = int(rows[0][0].shape[0]), int(np.prod(bs))
    nbytes = sum(t.numel() * t.element_size() for t in args) + \
        NONRIGID_ROWS * nb * 8
    wrapper_ms = None
    if dev.type == "cuda":
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            run()
            torch.cuda.synchronize()
        wrapper_ms = (time.perf_counter() - t0) * 200.0
    single = lambda: NR.nonrigid_fuse_block(*rows[0], bs, "AVG_BLEND")
    return dict(err=err, rows=NONRIGID_ROWS, ms=time_ms(run, reps=5),
                wrapper_ms=wrapper_ms, per_block_ms=time_ms(single, reps=10),
                plain_ms=time_ms(plain, reps=1, rounds=1), library_ms=None,
                bound=bound(nbytes, NONRIGID_ROWS * V * nb * OPS["nonrigid"]))


def resample_yard(name, run, plain, nbytes, ops, form, card, outputs=None):
    """One of K3's or K26's yardstick shapes: the kernel against its twin
    on the card (fused rtol 1e-5 / atol 1e-3, wsum atol 1e-5), its card
    time and its time with the host's (AVG_BLEND), its card time at each
    fusion type, its bound; with ``outputs`` (a directory) the outputs are
    saved there as ``<name>.pt`` or, where a file of that name is there
    already (another tree's run on the same inputs), compared with it
    bitwise. ``run`` and ``plain`` take the fusion type."""
    import torch

    from bigstitcher_spark_tpu_torch.ops.fusion import FUSION_TYPES

    got, ref = run("AVG_BLEND"), plain("AVG_BLEND")
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)
    r = dict(err=max(max_abs(got[0], ref[0]), max_abs(got[1], ref[1])),
             ms=time_ms(lambda: run("AVG_BLEND"), reps=20),
             wrapper_ms=time_ms(lambda: run("AVG_BLEND"), reps=20, host=True),
             ft_ms={ft: time_ms(lambda ft=ft: run(ft), reps=20)
                    for ft in FUSION_TYPES},
             bound=bound(nbytes, ops), form=form)
    del ref
    if outputs:
        os.makedirs(outputs, exist_ok=True)
        path = os.path.join(outputs, name.replace(" ", "_") + ".pt")
        if os.path.exists(path):
            other = torch.load(path)
            r["bitwise_vs_saved"] = all(
                torch.equal(a.cpu(), b) for a, b in zip(got, other))
            r["max_delta_vs_saved"] = max(max_abs(a.cpu(), b)
                                          for a, b in zip(got, other))
        else:
            torch.save(tuple(a.cpu() for a in got), path)
            r["saved"] = path
    print(f"  {name} [{card}]: kernel {r['ms']} ms  with the host's time "
          f"{r['wrapper_ms']} ms  bound {r['bound'][0]:.4f} ms "
          f"({r['bound'][1]}; "
          f"{r['bound'][0] / r['ms'] if r['ms'] else float('nan'):.1%} of "
          f"the kernel's time)  "
          f"max|delta| vs twin {r['err']:.3g}  by fusion type: "
          + ", ".join(f"{k} {v} ms" for k, v in r["ft_ms"].items())
          + f"  form: {form}"
          + (f"  vs the saved run: bitwise {r['bitwise_vs_saved']}, "
             f"max|delta| {r['max_delta_vs_saved']:.3g}"
             if "bitwise_vs_saved" in r else ""), flush=True)
    return r


def resample_yardsticks(kinds, dev, card, outputs=None, scale="full"):
    """K3 at phase 1's shape (its views rotated about z, the separable
    form, and about y, the general form), K3 with coefficients at 10c's
    tile-corner block and K26 at phase 11's (``kinds``: "gather",
    "nonrigid"), each through :func:`resample_yard`; ``scale`` tiny
    rehearses on a 32 x 28 x 16 block."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import fusion as F
    from bigstitcher_spark_tpu_torch.ops import nonrigid as NR

    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    bs = (256, 256, 64) if scale == "full" else (32, 28, 16)
    n, V, out = int(np.prod(bs)), 4, {}
    forms = (("z", "fuse_block", ""),
             ("y", "fuse_block general", ", rotated about y"))
    for about, key, what in forms if "gather" in kinds else ():
        rng = np.random.default_rng(2024)
        dims = np.tile(np.array([s + 80 for s in bs], np.float32), (V, 1))
        pv = lambda lo, hi: rng.uniform(lo, hi, (V, 3)).astype(np.float32)
        borders, ranges = pv(0, 3), pv(10, 40)
        gargs = gather_inputs(rng, c, bs, V, dims, borders, ranges,
                              np.ones(V, np.float32), about)
        io = c(np.zeros((V, 3), np.float32))
        out[key] = resample_yard(
            f"fuse_block at phase 1's shape{what}",
            lambda ft: F.fuse_block(*gargs, bs, ft, io),
            lambda ft: F.fuse_block_plain(*gargs, bs, ft, io),
            gargs[0].numel() * 2 + 2 * n * 4, V * n * OPS["gather"],
            resample_form(F, bs, V, tuple(gargs[0].shape[1:])), card, outputs)
        del gargs
    if "gather" in kinds:
        cargs, io, cf = coeff_block_inputs(np.random.default_rng(2025), c, bs)
        out["fuse_block+coeff"] = resample_yard(
            "fuse_block with coefficients at 10c's tile-corner block",
            lambda ft: F.fuse_block(*cargs, bs, ft, io, **cf),
            lambda ft: F.fuse_block_plain(*cargs, bs, ft, io, **cf),
            cargs[0].numel() * 2 + cf["coeffs"].numel() * 4 + n * 8,
            V * n * (OPS["gather"] + OPS["coeff_k3"]),
            resample_form(F, bs, V, tuple(cargs[0].shape[1:])), card, outputs)
        del cargs
    if "nonrigid" in kinds:
        ins = nonrigid_block_inputs(np.random.default_rng(2026), c, bs)
        out["nonrigid_fuse"] = resample_yard(
            "nonrigid_fuse at phase 11's block",
            lambda ft: NR.nonrigid_fuse_block(*ins, bs, ft),
            lambda ft: NR.nonrigid_fuse_block_plain(*ins, bs, ft),
            sum(t.numel() * t.element_size() for t in ins) + n * 8,
            V * n * OPS["nonrigid"],
            resample_form(F, bs, V, tuple(ins[0].shape[1:])), card, outputs)
    return out


def output_digest(t) -> tuple:
    """Two linear hashes, modulo the prime 2^31 - 1, of a tensor's bytes read
    as 32-bit words (zero-padded), weighted by two affine functions of the
    word's index, computed on its device: two runs whose outputs have equal
    digests have equal bits but for a chance of order 1e-18."""
    import torch

    P = 2 ** 31 - 1
    b = t.contiguous().reshape(-1).view(torch.uint8)
    if b.numel() % 4:
        b = torch.cat([b, b.new_zeros(4 - b.numel() % 4)])
    words = b.view(torch.int32)
    out = [0, 0]
    step = 1 << 26
    for at in range(0, words.numel(), step):
        w = words[at:at + step].to(torch.int64) & 0xFFFFFFFF
        idx = torch.arange(at, at + w.numel(), dtype=torch.int64,
                           device=w.device)
        for h, (mul, add) in enumerate(((48271, 11), (69621, 7))):
            out[h] = (out[h] + int(((w * ((idx * mul + add) % P)) % P)
                                   .sum())) % P
    return tuple(out)


def composite_yard_inputs(rng, c, scale="full", kind="shift", coeff=False):
    """K1's yardstick inputs, planned as plan_composite_volume plans them:
    route A's geometry (a 2 x 2 x 1 grid of uint16 tiles of 1024 x 1024 x
    128, 102 px overlap, sub-pixel translations, z offsets within 4 planes,
    blend ranges 40) drawn from ``rng``; ``kind`` "sep": every view a
    diagonal affine with steps within 2 % of 1; ``coeff``: 10c's 8 x 8 x 8
    grids of [scale, offset] with their level position -> grid affines.
    ``scale`` tiny: tiles of 40 x 36 x 20, 8 px overlap. Returns (tiles,
    params, keywords without fusion_type and out_dtype, coefficient
    keywords)."""
    import numpy as np

    S = np.array((1024, 1024, 128) if scale == "full" else (40, 36, 20))
    overlap, V = (102 if scale == "full" else 8), 4
    P = np.array([[ix * (S[0] - overlap), iy * (S[1] - overlap), 0]
                  for ix in (0, 1) for iy in (0, 1)], np.float64)
    P += rng.uniform(0, [3, 3, 4], (V, 3))
    dg = (rng.uniform(0.98, 1.02, (V, 3)) if kind == "sep"
          else np.ones((V, 3)))
    out_shape = tuple(int(np.ceil((P + S / dg)[:, d].max()))
                      for d in range(3))
    tiles = [c(rng.integers(90, 4000, tuple(S), dtype=np.uint16))
             for _ in range(V)]
    fracs = np.zeros((V, 3), np.float32)
    offs = np.zeros((V, 3), np.float32)
    windows, n_offs = [], []
    for v in range(V):
        # output voxel x samples the tile at dg x + g
        g = -dg[v] * P[v]
        if kind == "sep":
            a = [int(max(0, np.floor((-1.0 - g[d]) / dg[v, d])))
                 for d in range(3)]
            b = [int(min(out_shape[d], np.ceil((S[d] - g[d]) / dg[v, d]) + 1))
                 for d in range(3)]
            n_offs.append((0, 0, 0))
            offs[v] = g
        else:
            n = np.floor(g).astype(np.int64)
            fracs[v] = g - n
            a = [int(max(0, -n[d] - 1)) for d in range(3)]
            b = [int(min(out_shape[d], S[d] - n[d])) for d in range(3)]
            n_offs.append(tuple(int(x) for x in n))
        windows.append((tuple(a), tuple(b)))
    z3 = np.zeros((V, 3), np.float32)
    params = (fracs, np.tile(S.astype(np.float32), (V, 1)), z3, z3 + 40.0,
              z3, 0.0, 65535.0, dg.astype(np.float32), offs)
    kw = dict(out_shape=out_shape, windows=tuple(windows),
              n_offs=tuple(n_offs), pad=(1, 1, 1), kinds=(kind,) * V)
    cf = {}
    if coeff:
        cdims = (8, 8, 8)
        grids = np.empty((V, *cdims, 2), np.float32)
        grids[..., 0] = rng.uniform(0.7, 1.4, (V, *cdims))
        grids[..., 1] = rng.uniform(-30, 30, (V, *cdims))
        cs = S / np.array(cdims)
        caff = np.zeros((V, 3, 4), np.float32)
        caff[:, :, :3] = np.diag(1.0 / cs)
        caff[:, :, 3] = 0.5 / cs - 0.5
        cf = dict(coeffs=c(grids), coeff_affs=caff)
    return tiles, params, kw, cf


def composite_yard(name, tiles, params, kw, cf, card, outputs=None,
                   check_twin=True):
    """K1 at one of its yardstick cases: held against its twin on the card
    (uint |delta| <= 1, float32 rtol 1e-5 / atol 1e-3), its card time
    alone on prepared tables, its time with the host's (the wrapper, tables
    included), the device memory one wrapper call allocates at its peak,
    and the output's digest (:func:`output_digest`). With ``outputs`` (a
    directory) the digest and the output's first 64 x 64 x Z corner are
    saved there or, where another tree's run saved them, compared bit for
    bit."""
    import torch

    from bigstitcher_spark_tpu_torch.ops import fusion as F

    fracs, img_dims, borders, ranges, ioffs, mn, mx, diags, offs = params
    dev = tiles[0].device
    run = lambda: F.composite_fuse(tiles, *params, **kw, **cf)
    tables, starts = F.composite_axis_tables(
        kw["windows"], kw["n_offs"], kw["kinds"], fracs, diags, offs,
        img_dims, borders, ranges, ioffs, dev)
    ct = {}
    if cf:
        ctab, coffs = F.composite_coeff_tables(
            kw["windows"], kw["n_offs"], fracs, cf["coeff_affs"],
            cf["coeffs"].shape[1:4], starts, dev)
        ct = dict(coeffs=cf["coeffs"], ctab=ctab, coffs=coffs)
    bare = lambda: F.launch_composite(tiles, tables, starts, fracs, diags,
                                      offs, mn, mx, **kw, **ct)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    got = run()
    peak = None
    if on_card:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    r = dict(ms=time_ms(bare, reps=10), wrapper_ms=time_ms(run, reps=10,
                                                           host=True),
             peak_bytes=peak, digest=output_digest(got), err=None)
    if check_twin:
        ref = F.composite_fuse_plain(tiles, *params, **kw, **cf)
        r["err"] = max_abs(got, ref)
        if kw["out_dtype"] == "float32":
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-3)
        else:
            check(r["err"] <= 1, f"{name}: |delta| {r['err']} <= 1 vs the "
                                 "twin")
        del ref
    if outputs:
        os.makedirs(outputs, exist_ok=True)
        path = os.path.join(outputs, "composite " + name + ".pt")
        corner = got[:64, :64].cpu()
        if os.path.exists(path):
            other = torch.load(path)
            r["bitwise_vs_saved"] = (tuple(other["digest"]) == r["digest"]
                                     and torch.equal(other["corner"], corner))
        else:
            torch.save(dict(digest=r["digest"], corner=corner), path)
            r["saved"] = path
    print(f"  composite {name} [{card}]: kernel {r['ms']} ms  with the "
          f"host's time {r['wrapper_ms']} ms  device memory peak "
          f"{r['peak_bytes']} B  max|delta| vs twin {r['err']}"
          f"  digest {r['digest']}" + (
              f"  vs the saved run: bitwise {r['bitwise_vs_saved']}"
              if "bitwise_vs_saved" in r else ""), flush=True)
    return r


def composite_yardsticks(dev, card, outputs=None, scale="full"):
    """K1 at route A's geometry (:func:`composite_yard_inputs`) at each
    fusion type (uint16), with masks, with uint8 and float32 output; with
    10c's coefficient grids; on "sep" views. Each through
    :func:`composite_yard`; the twin held at AVG_BLEND, masks, uint8,
    float32, coefficients and "sep"."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops.fusion import FUSION_TYPES

    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    out = {}
    tiles, params, kw, _ = composite_yard_inputs(
        np.random.default_rng(2027), c, scale)
    print(f"  composite yardstick volume {kw['out_shape']}", flush=True)
    cases = [(ft, "uint16", False) for ft in FUSION_TYPES]
    cases += [("AVG", "uint16", True), ("AVG_BLEND", "uint8", False),
              ("AVG_BLEND", "float32", False)]
    for ft, od, masks in cases:
        name = f"{ft} {od}" + (" masks" if masks else "")
        out[f"composite {name}"] = composite_yard(
            name, tiles, params,
            {**kw, "fusion_type": ft, "out_dtype": od, "masks": masks}, {},
            card, outputs, check_twin=ft == "AVG_BLEND" or masks)
    del tiles
    for name, kind, coeff in (("coeff AVG_BLEND uint16", "shift", True),
                              ("sep AVG_BLEND uint16", "sep", False)):
        tiles, params, kw, cf = composite_yard_inputs(
            np.random.default_rng(2028), c, scale, kind, coeff)
        out[f"composite {name}"] = composite_yard(
            name, tiles, params,
            {**kw, "fusion_type": "AVG_BLEND", "out_dtype": "uint16",
             "masks": False}, cf,
            card, outputs)
        del tiles
    return out


# K12's yardstick pairs (tests/test_torch_kernels.py's)
FIT_PAIRS = (("TRANSLATION", "NONE"), ("RIGID", "NONE"), ("AFFINE", "NONE"),
             ("AFFINE", "RIGID"), ("RIGID", "TRANSLATION"),
             ("TRANSLATION", "IDENTITY"))


def fit_moments(rng, T, n=30):
    """K12's inputs: moments (T, 36) of ``n`` weighted point pairs a tile
    under a noisy rotation (every third a reflection) about the tile's
    origin, origins (T, 3) up to 30,000 px out, fixed (T,) uint8 (every
    50th tile); tile 5 without matches, tile 7 with sw < 0."""
    import numpy as np

    p = rng.uniform(-50, 50, (T, n, 3)) * rng.uniform(0.05, 1.0, (T, 1, 3))
    rot = np.linalg.qr(rng.normal(size=(T, 3, 3)))[0]
    rot[1::3] = rot[1::3] @ np.diag([1.0, 1.0, -1.0])
    q = (np.einsum("tij,tnj->tni", rot, p) + rng.normal(0, 0.5, p.shape)
         + rng.uniform(-20, 20, (T, 1, 3)))
    w = rng.uniform(0.5, 2.0, (T, n))
    ph = np.concatenate([p, np.ones((T, n, 1))], 2)
    mom = np.zeros((T, 36))
    mom[:, 0] = w.sum(1)
    mom[:, 1:5] = np.einsum("tn,tni->ti", w, ph)
    mom[:, 5:8] = np.einsum("tn,tni->ti", w, q)
    mom[:, 8:24] = np.einsum("tn,tni,tnj->tij", w, ph, ph).reshape(T, 16)
    mom[:, 24:36] = np.einsum("tn,tni,tnj->tij", w, ph, q).reshape(T, 12)
    mom[5] = 0.0
    mom[7, 0] = -1.0
    fixed = (np.arange(T) % 50 == 0).astype(np.uint8)
    return mom, rng.uniform(0, 30000, (T, 3)), fixed


def fit_yardsticks(dev, card, outputs=None, scale="full"):
    """K12 at T = 512 (7c's tiles) and 4,096 (7b's) on :func:`fit_moments`,
    for each of FIT_PAIRS (lam 0.1, damping 0.7): held against its twin
    (rtol 1e-10 of fit_scale / atol 1e-12), its card time and its time with
    the host's, its bound; with ``outputs`` the models are saved there or
    compared bit for bit with another tree's. Then K12's sharded form
    (:func:`sharded_fit_yard`)."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import solve as R

    out = {}
    for T in (512, 4096) if scale == "full" else (45, 70):
        mom, o, fixed = (torch.from_numpy(a).to(dev) for a in fit_moments(
            np.random.default_rng(T), T))
        cur0 = torch.zeros((T, 3, 4), dtype=torch.float64, device=dev)
        cur0[:, :, :3] = torch.eye(3, dtype=torch.float64, device=dev)
        for model, reg in FIT_PAIRS:
            name = f"fit {model} {reg} T {T}"
            got = R.relax_fit(mom, fixed, o, model, reg, 0.1, 0.7, None,
                              cur0.clone())
            ref = R.relax_fit_plain(mom, fixed, o, model, reg, 0.1, 0.7, None,
                                    cur0.clone())
            scale_ = R.fit_scale(ref, o)
            bad = int(((got - ref).abs() > 1e-12 + 1e-10 * scale_).sum())
            check(bad == 0, f"{name}: within rtol 1e-10 (of fit_scale) / "
                            "atol 1e-12 of the twin")
            scratch = cur0.clone()
            call = lambda: R.relax_fit(mom, fixed, o, model, reg, 0.1, 0.7,
                                       None, scratch)
            ops = OPS["fit"][model] + OPS["fit"][reg] + OPS["fit_blend"]
            r = dict(err=float((got - ref).abs().max()),
                     ms=time_ms(call, reps=50), wrapper_ms=time_ms(
                         call, reps=50, host=True),
                     bound=bound(T * (288 + 24 + 2 * 96 + 1), T * ops,
                                 F64_OPS_PER_S))
            if outputs:
                os.makedirs(outputs, exist_ok=True)
                path = os.path.join(outputs, name.replace(" ", "_") + ".pt")
                if os.path.exists(path):
                    r["bitwise_vs_saved"] = torch.equal(torch.load(path),
                                                        got.cpu())
                else:
                    torch.save(got.cpu(), path)
            print(f"  {name} [{card}]: kernel {r['ms']} ms  with the host's "
                  f"time {r['wrapper_ms']} ms  bound {r['bound'][0]:.5f} ms "
                  f"({r['bound'][1]})  max|delta| vs twin {r['err']:.3g}" + (
                      f"  vs the saved run: bitwise {r['bitwise_vs_saved']}"
                      if "bitwise_vs_saved" in r else ""), flush=True)
            out[name] = r
    out.update(sharded_fit_yard(dev, card, outputs, scale))
    return out


def sharded_fit_yard(dev, card, outputs=None, scale="full"):
    """K12's sharded form at 15a's shape: 4 partials of :func:`fit_moments`
    at T = 512 (7c's tiles), AFFINE + RIGID. A tree with the form (its
    ``ops.solve`` has ``relax_error_converge``) hands the partials to K12,
    an older tree adds them with K29 first; the models saved or compared
    bitwise across trees (``outputs``), within rtol 1e-10 of the twin; card
    time, with the host's, and on a tree with the form K29 + K12 beside it
    (``pair_ms``), bitwise the form."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import shard as K
    from bigstitcher_spark_tpu_torch.ops import solve as R

    T, S, model, reg = (512 if scale == "full" else 45), 4, "AFFINE", "RIGID"
    rng = np.random.default_rng(T + S)
    mom, o, fixed = fit_moments(rng, T)
    parts = [torch.from_numpy(mom * c).to(dev)
             for c in rng.dirichlet(np.ones(S))]
    o, fixed = torch.from_numpy(o).to(dev), torch.from_numpy(fixed).to(dev)
    cur0 = torch.zeros((T, 3, 4), dtype=torch.float64, device=dev)
    cur0[:, :, :3] = torch.eye(3, dtype=torch.float64, device=dev)
    summed = torch.empty((T, R.N_MOMENTS), dtype=torch.float64, device=dev)
    fit = lambda m, c: R.relax_fit(m, fixed, o, model, reg, 0.1, 0.7, None, c)
    pair = lambda c: (K.shard_sum(parts, summed), fit(summed, c))[1]
    form = lambda c: fit(parts, c)
    has = hasattr(R, "relax_error_converge")
    run = form if has else pair
    got = run(cur0.clone())
    ref = R.relax_fit_plain(K.shard_sum_plain(parts, summed.clone()), fixed,
                            o, model, reg, 0.1, 0.7, None, cur0.clone())
    scale_ = R.fit_scale(ref, o)
    name = f"fit sharded {model} {reg} T {T} S {S}"
    check(bool(((got - ref).abs() <= 1e-12 + 1e-10 * scale_).all()),
          f"{name}: within rtol 1e-10 (of fit_scale) / atol 1e-12 of the "
          "twin")
    scratch = cur0.clone()
    ops = OPS["fit"][model] + OPS["fit"][reg] + OPS["fit_blend"]
    r = dict(err=float((got - ref).abs().max()), form=has,
             ms=time_ms(lambda: run(scratch), reps=50),
             wrapper_ms=time_ms(lambda: run(scratch), reps=50, host=True),
             bound=bound(S * T * 288 + T * (24 + 2 * 96 + 1),
                         T * ops + (S - 1) * T * R.N_MOMENTS, F64_OPS_PER_S))
    if has:
        check(torch.equal(got, pair(cur0.clone())),
              f"{name}: the sharded form bitwise K29 then K12")
        r["pair_ms"] = time_ms(lambda: pair(scratch), reps=50)
    hold_outputs(outputs, name, [got], r)
    print(f"  {name} [{card}]: {'K12 sharded form' if has else 'K29 + K12'}"
          f" {r['ms']} ms  with the host's time {r['wrapper_ms']} ms"
          + (f"  K29 + K12 {r['pair_ms']} ms" if has else "")
          + f"  bound {r['bound'][0]:.5f} ms ({r['bound'][1]})  max|delta| "
          f"vs twin {r['err']:.3g}" + (
              f"  vs the saved run: bitwise {r['bitwise_vs_saved']}"
              if "bitwise_vs_saved" in r else ""), flush=True)
    return {name: r}


def sharded_converge_yard(dev, card, outputs=None):
    """K14's sharded form at 15a's shape (4 shards of 512 tiles' num and
    den, plateau width 40): 60 launches of seeded partials along an error
    sequence that the stall count stops; a tree with the form hands the
    partials to K14, an older tree adds them with K29 first; the history
    and state saved or compared bitwise across trees (``outputs``), the
    state equal to the twin's; one launch's card time behind a reset of
    the state (less the reset), and on a tree with the form K29 + K14
    beside it (``pair_ms``), bitwise the form."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import shard as K
    from bigstitcher_spark_tpu_torch.ops import solve as R

    S, T, cap, pw = 4, 512, 100, 40
    f64 = dict(dtype=torch.float64, device=dev)
    has = hasattr(R, "relax_error_converge")
    nd = torch.empty((2, T), **f64)
    k = np.arange(cap, dtype=np.float64)
    errs = np.maximum(10.0 / (1 + k), 10.0 / 41)
    parts = []  # a launch's (2, T) partials, as the sharded relax's nd_out
    for j, e in enumerate(errs[:60]):
        share = torch.from_numpy(np.random.default_rng(j).uniform(
            0.1, 1.0, (S, T))).to(dev)
        parts.append([torch.stack([share[d] * e, share[d]])
                      for d in range(S)])

    def form(nd_parts, hist, st):
        R.relax_converge([x[0] for x in nd_parts], [x[1] for x in nd_parts],
                         hist, st, pw, 5.0, cap)

    def pair(nd_parts, hist, st):
        K.shard_sum(nd_parts, nd)
        R.relax_converge(nd[0], nd[1], hist, st, pw, 5.0, cap)

    def twin(nd_parts, hist, st):
        ndp = K.shard_sum_plain(nd_parts, torch.empty_like(nd))
        R.relax_converge_plain(ndp[0], ndp[1], hist, st, pw, 5.0, cap)

    def launches(fn):
        hist = torch.zeros(cap, **f64)
        st = torch.zeros(4, dtype=torch.int32, device=dev)
        for nd_parts in parts:
            fn(nd_parts, hist, st)
        return hist, st

    run = form if has else pair
    hist, st = launches(run)
    h3, st3 = launches(twin)
    err = float((hist - h3).abs().max())
    name = f"converge sharded T {T} S {S}"
    check(torch.equal(st, st3) and int(st[2]) == 1
          and err <= 1e-10 * float(h3.abs().max()),
          f"{name}: state {st.tolist()} equal to the twin's, history within "
          f"rtol 1e-10 ({err:.3g})")
    if has:
        h2, st2 = launches(pair)
        check(torch.equal(hist, h2) and torch.equal(st, st2),
              f"{name}: the sharded form bitwise K29 then K14")
    r = dict(err=err, form=has,
             bound=bound(S * T * 16 + pw * 8, S * T * OPS["relax_converge"],
                         F64_OPS_PER_S))
    hold_outputs(outputs, name, [hist, st], r)
    hist = torch.zeros(cap, **f64)
    st = torch.zeros(4, dtype=torch.int32, device=dev)
    reset = time_ms(st.zero_)
    sub = lambda ms: None if ms is None or reset is None else ms - reset
    timed = lambda fn: sub(time_ms(lambda: (st.zero_(), fn(parts[-1], hist,
                                                            st))))
    r["ms"] = timed(run)
    if has:
        r["pair_ms"] = timed(pair)
    print(f"  {name} [{card}]: {'K14 sharded form' if has else 'K29 + K14'}"
          f" {r['ms']} ms" + (f"  K29 + K14 {r['pair_ms']} ms" if has else "")
          + f"  bound {r['bound'][0]:.6f} ms ({r['bound'][1]})  max|delta| "
          f"vs twin {r['err']:.3g}" + (
              f"  vs the saved run: bitwise {r['bitwise_vs_saved']}"
              if "bitwise_vs_saved" in r else ""), flush=True)
    return {name: r}


def hold_outputs(outputs, name, tensors, r):
    """With ``outputs`` (a directory): each tensor's digest
    (:func:`output_digest`) and its first 65,536 elements saved there as
    ``<name>.pt`` or, where another tree's run saved them, compared bit for
    bit (``r["bitwise_vs_saved"]``; NaNs compare by their bits)."""
    import torch

    if not outputs:
        return
    os.makedirs(outputs, exist_ok=True)
    path = os.path.join(outputs, name.replace(" ", "_").replace("/", "_")
                        + ".pt")
    mine = [(output_digest(t), tuple(t.shape), str(t.dtype),
             t.contiguous().reshape(-1)[:65536].cpu().view(torch.uint8))
            for t in tensors]
    if os.path.exists(path):
        other = torch.load(path)
        r["bitwise_vs_saved"] = len(other) == len(mine) and all(
            a[:3] == b[:3] and torch.equal(a[3], b[3])
            for a, b in zip(mine, other))
    else:
        torch.save(mine, path)
        r["saved"] = path


def saved_all(held):
    """:func:`hold_outputs`' verdicts on several outputs as one: bitwise
    where every comparison was."""
    seen = [h["bitwise_vs_saved"] for h in held if "bitwise_vs_saved" in h]
    return {"bitwise_vs_saved": all(seen)} if seen else {}


def ransac_yard_inputs(rng, m, sample, dev, outliers=0.009):
    """K21's yardstick candidates: ``m`` pairs as 9b's (A uniform in 9b's
    cube, B = R A + t, 10 degrees about z, + N(0, 0.05)), ``outliers`` of
    them replaced by uniform points (9b: 523 of 58,274 outside eps), and
    10,000 hypotheses of ``sample`` pairs drawn as ``ransac`` draws them
    (seed 17)."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import descriptors as DS

    ext = SCALES["full"]["cloud_extent"]
    a = rng.uniform(0, ext, (m, 3))
    ang = np.deg2rad(10.0)
    rot = np.array([[np.cos(ang), -np.sin(ang), 0.0],
                    [np.sin(ang), np.cos(ang), 0.0], [0.0, 0.0, 1.0]])
    b = a @ rot.T + np.array([35.0, -20.0, 12.0]) + rng.normal(0, 0.05,
                                                              a.shape)
    bad = rng.permutation(m)[: int(round(outliers * m))]
    b[bad] = rng.uniform(0, ext, (len(bad), 3))
    pa, pb = (torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev)
              for v in (a, b))
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    return pa, pb, DS.draw_hypotheses(m, 10000, sample, gen)


# K21's yardstick cases: (name, candidates, sample, model); 9b's and 9a's
# (AFFINE, sample 4: -m AFFINE -rm RIGID) and the other two sample sizes
RANSAC_YARDS = (("9b AFFINE", 58274, 4, "AFFINE"), ("9a AFFINE", 155, 4,
                                                    "AFFINE"),
                ("9b TRANSLATION", 58274, 1, "TRANSLATION"),
                ("9b RIGID", 58274, 3, "RIGID"))


def ransac_yardsticks(dev, card, outputs=None, scale="full"):
    """K21 at each of RANSAC_YARDS (10,000 hypotheses; ``scale`` tiny: 600
    and 155 candidates, 300 hypotheses): counts, models, best and best
    model held against the twin on the card bit for bit (NaN-aware), card
    time, time with the host's (the wrapper as a caller sees it), bound;
    with ``outputs`` the four outputs are saved or compared bit for bit
    (:func:`hold_outputs`)."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import descriptors as DS

    out = {}
    for name, m, sample, kind in RANSAC_YARDS:
        if scale != "full":
            m = min(m, 600)
        pa, pb, idx = ransac_yard_inputs(np.random.default_rng(m + sample),
                                         m, sample, dev)
        if scale != "full":
            idx = idx[:300].contiguous()
        iters = len(idx)
        run = lambda: DS.ransac_score(pa, pb, idx, 5.0, kind)
        got = run()
        ref = DS.ransac_score_plain(pa, pb, idx, 5.0, kind)
        same = all(torch.equal(g.isnan(), f.isnan())
                   and torch.equal(g.nan_to_num(), f.nan_to_num())
                   for g, f in zip(got, ref))
        check(same, f"K21 {name} ({iters} x {m}, sample {sample}): counts, "
                    "models and best bitwise the twin's (NaN-aware)")
        fin = torch.isfinite(ref[1])
        reps = 50 if m < 1000 else 10
        r = dict(err=max_abs(got[1][fin], ref[1][fin]) if bool(fin.any())
                 else 0.0,
                 ms=time_ms(run, reps=reps),
                 wrapper_ms=time_ms(run, reps=reps, host=True),
                 bound=bound(m * 24 + iters * (16 + 4 + 48),
                             iters * m * OPS["ransac_apply"]),
                 best=[int(v) for v in got[2]], shape=(iters, m, sample),
                 twin_bitwise=same)
        if hasattr(DS, "ransac_plan") and dev.type == "cuda":
            r["plan"] = str(DS.ransac_plan(m, iters, DS._sms(dev),
                                           pa.data_ptr() | pb.data_ptr()))
        hold_outputs(outputs, "ransac " + name, got, r)
        out[f"ransac_refit {name}"] = refit_yard(pa, pb, got[3], kind, name,
                                                 card, outputs)
        print(f"  ransac_score {name} ({iters} x {m}, sample {sample}) "
              f"[{card}]: kernel {r['ms']} ms  with the host's time "
              f"{r['wrapper_ms']} ms  bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]})  best #{r['best'][0]} ({r['best'][1]})  "
              f"bitwise the twin's: {same}"
              + (f"  plan {r['plan']}" if "plan" in r else "")
              + (f"  vs the saved run: bitwise {r['bitwise_vs_saved']}"
                 if "bitwise_vs_saved" in r else ""), flush=True)
        out[f"ransac_score {name}"] = r
    return out


def hold_close(outputs, name, t, r, rtol=1e-9, atol=1e-9):
    """With ``outputs``: ``t`` (a small tensor) saved as ``<name>.pt`` by the
    first tree's run and held by later runs within ``rtol`` / ``atol``
    (``r["close_vs_saved"]``, beside ``r["bitwise_vs_saved"]``); also saved
    a tree (the port's path in the name), so that a tree's second run is
    held to its first bit for bit (``r["bitwise_vs_same_tree"]``)."""
    import hashlib

    import torch

    import bigstitcher_spark_tpu_torch as port

    if not outputs:
        return
    os.makedirs(outputs, exist_ok=True)
    base = os.path.join(outputs, name.replace(" ", "_").replace("/", "_"))
    tree = hashlib.sha1(port.__file__.encode()).hexdigest()[:8]
    mine = t.detach().cpu()
    for path, key in ((base + ".pt", "vs_saved"),
                      (f"{base}.{tree}.pt", "vs_same_tree")):
        if not os.path.exists(path):
            torch.save(mine, path)
            continue
        other = torch.load(path)
        r["bitwise_" + key] = bool(torch.equal(mine.view(torch.int64),
                                               other.view(torch.int64)))
        if key == "vs_saved":
            r["close_vs_saved"] = bool(torch.allclose(
                mine, other, rtol=rtol, atol=atol, equal_nan=True))


def refit_yard(pa, pb, model, kind, name, card, outputs=None):
    """K22 at a RANSAC yard's candidates from K21's best model there (eps
    5, the kind and a RIGID regulariser at lambda 0.1 as ``ransac`` takes
    them): its fit (fit=True) and the mask alone (fit=False), each against
    the twin (masks and counts equal, the model within rtol 1e-9 / atol
    1e-9), timed in card time and with the host's; with ``outputs`` the
    masks and counts held bit for bit across trees, the models within the
    twin's tolerance across trees and bit for bit between one tree's runs
    (:func:`hold_close`)."""
    import torch

    from bigstitcher_spark_tpu_torch.ops import descriptors as DS

    m = int(pa.shape[0])
    args = (pa, pb, model, 5.0, kind, "RIGID", 0.1)
    r = {"shape": f"{m} candidates"}
    if hasattr(DS, "refit_plan") and pa.device.type == "cuda":
        r["plan"] = str(DS.refit_plan(m, DS._sms(pa.device)))
    held = []
    for key, fit in (("fit", True), ("nofit", False)):
        run = lambda fit=fit: DS.ransac_refit(*args, fit=fit)
        got = run()
        ref = DS.ransac_refit_plain(*args, fit=fit)
        same = torch.equal(got[0], ref[0]) and int(got[1]) == int(ref[1])
        if fit:
            torch.testing.assert_close(got[2], ref[2], rtol=1e-9, atol=1e-9,
                                       equal_nan=True)
        check(same, f"K22 {name} ({m} candidates, fit={fit}): mask and count "
                    f"({int(got[1])}) the twin's"
                    + (", the model within rtol 1e-9 / atol 1e-9" if fit
                       else ""))
        reps = 50 if m < 1000 else 20
        r[f"{key}_ms"] = time_ms(run, reps=reps)
        r[f"{key}_wrapper_ms"] = time_ms(run, reps=reps, host=True)
        h = {}
        hold_outputs(outputs, f"ransac_refit {name} {key}", got[:2], h)
        held.append(h)
        if fit:
            h = {}
            hold_close(outputs, f"ransac_refit {name} model", got[2], h)
            r.update({f"model_{k}": v for k, v in h.items()})
    r.update(saved_all(held))
    r["count"] = int(got[1])
    r["bound"] = bound(m * 25, m * OPS["refit_row"], F64_OPS_PER_S)
    r["ms"], r["wrapper_ms"] = r["fit_ms"], r["fit_wrapper_ms"]
    print(f"  ransac_refit {name} ({m} candidates, {r['count']} inliers) "
          f"[{card}]: fit {r['fit_ms']} ms (with the host's time "
          f"{r['fit_wrapper_ms']} ms), mask alone {r['nofit_ms']} ms ("
          f"{r['nofit_wrapper_ms']} ms)  bound {r['bound'][0]:.5f} ms"
          + (f"  plan {r['plan']}" if "plan" in r else "")
          + (f"  masks and counts vs the saved run: bitwise "
             f"{r['bitwise_vs_saved']}" if "bitwise_vs_saved" in r else "")
          + (f"; model vs the saved run: bitwise "
             f"{r['model_bitwise_vs_saved']}, within 1e-9 "
             f"{r['model_close_vs_saved']}"
             if "model_bitwise_vs_saved" in r else "")
          + (f"; vs this tree's first run: bitwise "
             f"{r['model_bitwise_vs_same_tree']}"
             if "model_bitwise_vs_same_tree" in r else ""), flush=True)
    return r


def dog_yardsticks(dev, card, outputs=None, scale="full"):
    """K16 at 8a's bucket (2 x 528 x 528 x 144 float32; ``scale`` tiny: 2 x
    40 x 36 x 20): blurs by K15 of 100 + N(0, 3) with point beads of 5,000
    (from a seed on the card), min / max scaled, threshold 0.008 (the
    detection default), maxima (8a's), origins straddling zero. "beads":
    450 beads a block (8a: 1,723 points in 4 blocks), the candidates form
    (8a's route) and the dense mask form (dog_block); "noise": no bead, so
    that the min / max scaling puts ~18 % of the voxels past the threshold,
    the candidates form. Each against the twin (dog bitwise, candidate
    sets, scores and counts, the mask equal), timed in card time and with
    the host's; with ``outputs`` dog, the sorted candidate lists, the
    counts and the mask held bit for bit across trees."""
    import torch

    from bigstitcher_spark_tpu_torch.ops import dog as G

    shape = (2, 528, 528, 144) if scale == "full" else (2, 40, 36, 20)
    B = shape[0]
    out = {}
    for case, n_beads, forms in (("beads", 450, (True, False)),
                                 ("noise", 0, (True,))):
        g = torch.Generator(device=dev)
        g.manual_seed(1616)
        x = 100.0 + 3.0 * torch.randn(shape, generator=g, device=dev)
        n_beads = n_beads if scale == "full" else n_beads // 20
        at = torch.randint(0, x[0].numel(), (B, n_beads), generator=g,
                           device=dev)
        x.view(B, -1).scatter_add_(1, at, torch.full((B, n_beads), 5000.0,
                                                     device=dev))
        b1, b2 = G._blurs(G.KERNELS, x, 1.8)
        sc = G.dog_scale(x.amin((1, 2, 3)), x.amax((1, 2, 3)))
        del x
        thr = torch.full((B,), 0.008, device=dev)
        org = torch.tensor([[0, 0, 0], [512, -9, 120]], dtype=torch.int32,
                           device=dev)
        n = int(b1[0].numel())
        past = int(((b1 - b2) * sc.view(B, 1, 1, 1) > thr.view(B, 1, 1, 1))
                   .sum())
        for cand in forms:
            form = f"{case} {'candidates' if cand else 'dense'}"
            args = (b1, b2, sc, thr, org, True, False, 0, cand)
            got = G.dog_extrema(*args)
            ref = G.extrema_plain(*args)
            if cand:
                sets = []
                for b, k in enumerate(got[3].tolist()):
                    o = torch.argsort(got[1][b, :k])
                    sets += [got[1][b, :k][o], got[2][b, :k][o]]
                same = (torch.equal(got[0], ref[0])
                        and torch.equal(got[3], ref[3])
                        and all(torch.equal(sets[2 * b], ref[1][b, :k])
                                and torch.equal(sets[2 * b + 1],
                                                ref[2][b, :k])
                                for b, k in enumerate(got[3].tolist())))
                kept = [got[0], got[3], *sets]
                nb = 12 * B * n + 8 * int(got[3].sum())
            else:
                same = (torch.equal(got[0], ref[0])
                        and torch.equal(got[1], ref[1]))
                kept = list(got)
                nb = 13 * B * n
            check(same, f"K16 {form} at {shape}: dog bitwise, "
                        + ("candidate sets, scores and counts "
                           f"{got[3].tolist()}" if cand else "the mask")
                        + " the twin's")
            del ref
            run = lambda args=args: G.dog_extrema(*args)
            r = dict(ms=time_ms(run, reps=10),
                     wrapper_ms=time_ms(run, reps=10, host=True),
                     bound=bound(nb, 3 * B * n + OPS["dog_window"] * past),
                     shape=shape, past=past, twin_bitwise=same)
            if hasattr(G, "extrema_plan") and dev.type == "cuda":
                r["plan"] = str(G.extrema_plan(*shape, G._sms(dev)))
            if cand:
                r["counts"] = got[3].tolist()
            hold_outputs(outputs, f"dog_extrema {form}", kept, r)
            del got, kept
            print(f"  dog_extrema {form} at {shape} [{card}]: kernel "
                  f"{r['ms']} ms  with the host's time {r['wrapper_ms']} ms  "
                  f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]})  past the "
                  f"threshold {past}"
                  + (f"  counts {r['counts']}" if cand else "")
                  + (f"  plan {r['plan']}" if "plan" in r else "")
                  + (f"  vs the saved run: bitwise {r['bitwise_vs_saved']}"
                     if "bitwise_vs_saved" in r else ""), flush=True)
            out[f"dog_extrema {form}"] = r
        del b1, b2
    return out


def peaks_yardsticks(dev, card, outputs=None, scale="full"):
    """K10 at phase 1's stitching bucket (2 x 64 x 512 x 128) at n = 5 and
    256 and on :func:`fill_pcm` (one maximum a pair) at n = 5, and at
    phase 6's largest bucket at n = 5 (the stitching default), on the PCM
    the twins make of :func:`pcm_crops`' stacks (torch.fft for K8: the
    same input for every tree). Each bitwise its twin's, card time, time
    with the host's, bound; with ``outputs`` the peaks held bit for bit
    across trees."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import phasecorr as P

    cfg = SCALES[scale]
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    out = {}
    for bucket, ns in ((cfg["pcm_bucket"], (5, 256)),
                       (cfg["pcm_bucket_6"], (5,))):
        a, b, ext = pcm_crops(np.random.default_rng(2024), c, bucket)
        pcm = P.pcm_peaks_plain(a, b, ext, ext, 5, return_pcm=True)[1]
        pcm = pcm.contiguous()
        del a, b
        cases = [(str(n), pcm, n) for n in ns]
        if bucket == cfg["pcm_bucket"]:
            cases.append(("5 fill", fill_pcm(bucket, dev), 5))
        for label, x, n in cases:
            name = f"pcm_peaks_topk {','.join(map(str, bucket))} n {label}"
            got = P.pcm_peaks_topk(x, n)
            check(torch.equal(got, P.pcm_peaks_topk_plain(x, n)),
                  f"{name}: indices equal to the twin's")
            run = lambda x=x, n=n: P.pcm_peaks_topk(x, n)
            r = dict(ms=time_ms(run), wrapper_ms=time_ms(run, host=True),
                     bound=bound(x.numel() * 4, x.numel() * OPS["topk"]))
            if hasattr(P, "peaks_plan") and dev.type == "cuda":
                r["plan"] = str(P.peaks_plan(*x.shape, n, P._sms(dev)))
            hold_outputs(outputs, name, [got], r)
            print(f"  {name} [{card}]: kernel {r['ms']} ms  with the host's "
                  f"time {r['wrapper_ms']} ms  bound {r['bound'][0]:.4f} ms "
                  f"({r['bound'][1]})"
                  + (f"  plan {r['plan']}" if "plan" in r else "")
                  + (f"  vs the saved run: bitwise {r['bitwise_vs_saved']}"
                     if "bitwise_vs_saved" in r else ""), flush=True)
            out[name] = r
        del pcm, cases
    return out


def topk_yardsticks(dev, card, outputs=None, scale="full"):
    """K17 at 8a's bucket (2 blocks of 528 x 528 x 144, k 4,096; ``scale``
    tiny: 40 x 36 x 20, k 256) on candidate lists from a seed (distinct
    flat indices in random order, scores as |dog| past 8a's threshold):
    "8a", 430 and 431 candidates (8a's ~430 a block); "truncated", 50,000
    a block (tiny: 1,000). Each against its twin (indices and flags
    bitwise) and torch.topk's index sets on the dense score; card time,
    time with the host's, the twin, torch.topk on the dense score and on
    the list's scores (:func:`list_scores`), bound; with ``outputs``
    indices and flags held bit for bit across trees."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import dog as G

    full = scale == "full"
    shape = (528, 528, 144) if full else (40, 36, 20)
    vol, k, B = int(np.prod(shape)), 4096 if full else 256, 2
    out = {}
    for label, counts in (("8a", (430, 431) if full else (20, 21)),
                          ("truncated", (50_000,) * 2 if full else (1000,) * 2)):
        g = torch.Generator(device=dev)
        g.manual_seed(1717)
        ci = torch.zeros((B, vol), dtype=torch.int32, device=dev)
        cs = torch.zeros((B, vol), dtype=torch.float32, device=dev)
        dense = torch.full((B, vol), -np.inf, device=dev)
        for b, m in enumerate(counts):
            ci[b, :m] = torch.randperm(vol, generator=g, device=dev)[:m].int()
            cs[b, :m] = 0.008 + torch.rand(m, generator=g, device=dev)
            dense[b, ci[b, :m].long()] = cs[b, :m]
        cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
        name = f"dog_topk {label}"
        idx, valid = topk_against(f"{name} at {B} x {shape}", ci, cs, cnt, k,
                                  shape, dense)
        lst = list_scores(cs, cnt)
        run = lambda: G.dog_topk(ci, cs, cnt, k, shape)
        cand = sum(counts)
        r = dict(ms=time_ms(run), wrapper_ms=time_ms(run, host=True),
                 plain_ms=time_ms(lambda: G.topk_plain(ci, cs, cnt, k, shape),
                                  reps=5),
                 library_ms=time_ms(lambda: torch.topk(dense, k, dim=1)),
                 library_list_ms=time_ms(lambda: torch.topk(
                     lst, min(k, lst.shape[1]), dim=1)),
                 bound=bound(8 * cand + 13 * B * k, cand), counts=counts, k=k)
        hold_outputs(outputs, name, [idx, valid], r)
        print(f"  {name} at {B} x {shape} (k {k}, counts {counts}) [{card}]: "
              f"kernel {r['ms']} ms  with the host's time {r['wrapper_ms']} "
              f"ms  plain {r['plain_ms']} ms  library {r['library_ms']} ms "
              f"(on the list's scores {r['library_list_ms']} ms)  bound "
              f"{r['bound'][0]:.5f} ms ({r['bound'][1]})"
              + (f"  vs the saved run: bitwise {r['bitwise_vs_saved']}"
                 if "bitwise_vs_saved" in r else ""), flush=True)
        out[name] = r
        del ci, cs, dense, lst
    return out


def downsample_yardsticks(dev, card, outputs=None, scale="full"):
    """K6's three forms at phase 1's shapes (uint16 from a seed): the level
    form at route A's first pyramid step (1952 x 1952 x 132 -> 976 x 976 x
    66 uint16), the batch form at the downsample stage's boxes (4 of 256 x
    256 x 128: level blocks of 128 x 128 x 64 x rel (2, 2, 2)) and at route
    D's (4 x 256 x 256 x 45 / (2, 2, 1)), the one-axis form along each axis
    of a route-A tile (1024 x 1024 x 128), through
    :func:`downsample_times` and :func:`halfpixel_times` with their
    outputs held. ``scale`` tiny rehearses at SCALES' tiny shapes."""
    import numpy as np
    import torch

    cfg = SCALES[scale]
    rng = np.random.default_rng(2029)
    c = lambda *shape: torch.from_numpy(
        rng.integers(0, 65536, shape).astype(np.uint16)).to(dev)
    out = {}
    for key, x, f, level in (
            ("level route A", c(*cfg["level_shape"]), (2, 2, 2), True),
            ("batch", c(4, *cfg["batch_box"]), (2, 2, 2), False),
            ("batch route D", c(4, *cfg["batch_box_d"]), (2, 2, 1), False)):
        out[f"downsample {key}"] = downsample_times(x, f, dev, level,
                                                    outputs, key)
        print_times(f"downsample {key}", out[f"downsample {key}"], card)
        del x
    out["downsample one-axis"] = halfpixel_times(c(*cfg["tile"]), card,
                                                 outputs)
    return out


def match_cli(xml, args, route, dev, card, launches):
    """``match-interestpoints`` through the CLI entry function, launches
    counted as ``route``; prints the wall and its split."""
    from bigstitcher_spark_tpu_torch.cli.main import main

    t0 = time.perf_counter()
    run = counted(route, launches, dev, lambda: main(
        ["match-interestpoints", "-x", xml, *args, "--device", str(dev)]))
    wall = time.perf_counter() - t0
    st, t, k = run.stats, run.stats.timings, run.stats.kernels
    print(f"  [matching {route}] {card}: {st.pairs} pairs, {st.candidates} "
          f"candidates, {st.inliers} inliers; wall {wall:.3f}s: load "
          f"{t['load']:.3f}s descriptors {t['descriptors']:.3f}s ratio "
          f"{t['ratio']:.3f}s fetch {t['fetch']:.3f}s ransac "
          f"{t['ransac']:.3f}s host {t['host']:.3f}s store {t['store']:.3f}s; "
          "card busy descriptors "
          f"{k['descriptors']:.4f}s ratio {k['ratio']:.4f}s ransac "
          f"{k['ransac']:.4f}s; idle share "
          f"{1 - sum(k.values()) / wall:.4f}", flush=True)
    return run


def check_links(what, proj, xml, max_px, min_checked, median_px=1.0):
    """Every stored correspondence joins the same true bead: within
    ``max_px``, their median below ``median_px``, at least ``min_checked``
    checked, and stored symmetrically on the other view."""
    import numpy as np

    from bigstitcher_spark_tpu_torch.io.interestpoints import (
        InterestPointStore)
    from bigstitcher_spark_tpu_torch.io.spimdata import SpimData

    sd = SpimData.load(xml)
    store = InterestPointStore.for_project(sd)
    pts = {v: store.load_points(v, "beads") for v in sd.view_ids()}
    corrs = {v: store.load_correspondences(v, "beads") for v in sd.view_ids()}
    links = {(v, c.id, c.other_view, c.other_id)
             for v, cs in corrs.items() for c in cs}
    d, sym = [], True
    for v, cs in corrs.items():
        loc = dict(zip(pts[v][0].tolist(), pts[v][1]))
        for c in cs:
            oid, olocs = pts[c.other_view]
            other = dict(zip(oid.tolist(), olocs))[c.other_id]
            d.append(np.linalg.norm(
                (loc[c.id] + proj.true_offsets[v.setup])
                - (other + proj.true_offsets[c.other_view.setup])))
            sym &= (c.other_view, c.other_id, v, c.id) in links
    d = np.asarray(d)
    check(len(d) >= min_checked and d.max() < max_px
          and np.median(d) < median_px and sym,
          f"{what}: {len(d)} stored links (>= {min_checked}) join the same "
          f"true bead, max {d.max() if len(d) else float('nan'):.3f} < "
          f"{max_px} px, median "
          f"{np.median(d) if len(d) else float('nan'):.3f} < {median_px} "
          "px; every one stored on both views")


def make_clouds(scale, seed=61):
    """9b's nucleus-scale pair: A uniform in a cube at the JAX package's
    soak density, B = R A + t (10 degrees about z) + N(0, 0.05); 10 % of
    each side dropped and 10 % uniform extras added to each. Returns (A,
    B, the true model (3, 4), the number of true points at the head of A,
    the number of points both sides kept)."""
    import numpy as np

    cfg = SCALES[scale]
    n, ext = cfg["cloud"], cfg["cloud_extent"]
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, ext, (n, 3))
    ang = np.deg2rad(10.0)
    rot = np.array([[np.cos(ang), -np.sin(ang), 0.0],
                    [np.sin(ang), np.cos(ang), 0.0], [0.0, 0.0, 1.0]])
    t = np.array([35.0, -20.0, 12.0])
    b = a @ rot.T + t + rng.normal(0, 0.05, a.shape)
    keep_a = rng.permutation(n)[: n - n // 10]
    keep_b = rng.permutation(n)[: n - n // 10]
    extra = lambda: rng.uniform(0, ext, (n // 10, 3))
    wa = np.concatenate([a[keep_a], extra()])
    wb = np.concatenate([b[keep_b], extra() @ rot.T + t])
    common = len(np.intersect1d(keep_a, keep_b))
    return wa, wb, np.hstack([rot, t[:, None]]), len(keep_a), common


def phase9_matching(work, proj, det_b, scale, dev, card, launches, gate8d):
    """Phase 9: match-interestpoints. 9a on route A with 8b's points at the
    reference defaults, then solver -s IP; 9b a nucleus-scale pair through
    match_pair; 9c ICP, multi-consensus and search radius on route A.
    ``gate8d``: 8d's ratio-test (candidates, joined), printed beside 9a's.
    Returns K19-K22's results."""
    import numpy as np

    from bigstitcher_spark_tpu_torch.io.interestpoints import (
        InterestPointStore)
    from bigstitcher_spark_tpu_torch.io.spimdata import SpimData
    from bigstitcher_spark_tpu_torch.models import detection as TD
    from bigstitcher_spark_tpu_torch.models import matching as TM
    from bigstitcher_spark_tpu_torch.ops import descriptors as DS
    from bigstitcher_spark_tpu_torch.utils.geometry import apply_affine

    print("phase 9 (matching)", flush=True)
    tiny = scale == "tiny"
    # the XML (its registrations) beside a store holding 8b's points
    base = os.path.join(work, "match_8b")
    os.makedirs(base, exist_ok=True)
    xml0 = os.path.join(base, "dataset.xml")
    shutil.copy(proj.xml_path, xml0)
    sd = SpimData.load(xml0)
    TD.save_detections(sd, InterestPointStore.for_project(sd), det_b,
                       TD.DetectionParams())
    sd.save(xml0)

    def copy_of(name, src=base):
        d = os.path.join(work, name)
        shutil.copytree(src, d)
        return os.path.join(d, "dataset.xml")

    # tiny tiles share a few beads an overlap: fewer inliers suffice there
    small = ["-rmni", "4", "-rmir", "0.0"] if tiny else []
    xml_a = copy_of("match_9a")
    run_a = match_cli(xml_a, ["-l", "beads", *small], "9a", dev, card,
                      launches)
    check_links("9a", proj, xml_a, 5.0, 4 if tiny else 20)
    print(f"  9a: {run_a.stats.candidates} candidates, "
          f"{run_a.stats.inliers} inliers (8b's points); 8d's riders at "
          f"-dsxy 2: {gate8d[0]} candidates, {gate8d[1]} join the same bead",
          flush=True)
    srun, _calls = solver_cli(xml_a, ["-s", "IP", "-l", "beads"], "9a solver",
                              dev, card, launches)
    sd = SpimData.load(xml_a)
    delta = np.array([sd.model(v)[:, 3] - proj.true_offsets[v.setup]
                      for v in sd.view_ids()])
    spread = float(np.abs(delta - delta.mean(0)).max())
    # tiny tiles share too few beads to link every view: no spread gate
    check(srun.result.error < 1.0 and (spread < 1.0 or tiny),
          f"9a solver -s IP: error {srun.result.error:.4f} < 1 px, tile "
          f"placement spread {spread:.4f} < 1 px against the truth")
    # the kernels against the twins at the shapes of the pair with the most
    # candidates
    first = max(run_a.results, key=lambda r: r.n_candidates)
    sd0 = SpimData.load(xml0)
    st0 = InterestPointStore.for_project(sd0)
    wa, wb = (apply_affine(sd0.model(v), st0.load_points(v, "beads")[1])
              for v in (first.view_a, first.view_b))
    err, at_9a = match_kernel_checks(
        f"9a pair {first.view_a.setup}-{first.view_b.setup}", wa, wb, dev)

    # 9b: the nucleus-scale pair
    wa, wb, truth, n_true, n_common = make_clouds(scale)
    timer = DS.StageTimes()
    t0 = time.perf_counter()
    pairs, model, n_cand = counted("9b", launches, dev, lambda: TM.match_pair(
        wa, wb, TM.MatchingParams(), seed=17, device=dev, timer=timer))
    wall = time.perf_counter() - t0
    timer.resolve()
    h = timer.host
    busy = sum(timer.device[k] for k in ("descriptors", "ratio", "ransac"))
    print(f"  [matching 9b] {card}: {len(wa)} x {len(wb)} points, {n_cand} "
          f"candidates, {len(pairs)} inliers; wall {wall:.3f}s: "
          f"descriptors {h['descriptors']:.3f}s ratio {h['ratio']:.3f}s "
          f"fetch {h['fetch']:.3f}s ransac {h['ransac']:.3f}s host "
          f"{wall - sum(h.values()):.3f}s; card busy descriptors "
          f"{timer.device['descriptors']:.4f}s ratio "
          f"{timer.device['ratio']:.4f}s ransac "
          f"{timer.device['ransac']:.4f}s; idle share "
          f"{1 - busy / wall:.4f}", flush=True)
    src = wa[:n_true]  # the true points of A (the extras follow)
    rms = float(np.sqrt(((src @ model[:, :3].T + model[:, 3]
                          - (src @ truth[:, :3].T + truth[:, 3])) ** 2)
                        .sum(1).mean())) if model is not None else np.inf
    check(model is not None and rms < 0.1 and len(pairs) >= 0.7 * n_common,
          f"9b: model maps A within {rms:.4f} < 0.1 px RMS of the truth; "
          f"{len(pairs)} inliers >= 0.7 x {n_common} common points")
    e9b, inputs = match_kernel_checks(
        "9b", wa, wb, dev, rows=slice(0, SCALES[scale]["twin_rows"]),
        tail_rows=SCALES[scale]["twin_rows"] // 2)
    for k, v in e9b.items():
        err[k] = max(err.get(k, 0.0), v)

    # 9c: the other options on route A
    xml_icp = copy_of("match_9c_icp", os.path.dirname(xml_a))
    match_cli(xml_icp, ["-l", "beads", "-m", "ICP", "--icpUseRANSAC",
                        "--clearCorrespondences", *small], "9c ICP", dev,
              card, launches)
    check_links("9c ICP", proj, xml_icp, 2.5, 4 if tiny else 20, 2.5)
    for route, extra in (("9c multi-consensus", ["-rmc"]),
                         ("9c search radius", ["-sr", "10"])):
        xml_c = copy_of("match_" + route.split()[1].replace("-", "_"))
        run = match_cli(xml_c, ["-l", "beads", *extra, *small], route, dev,
                        card, launches)
        check(sum(len(r.ids_a) for r in run.results) > 0,
              f"{route}: {sum(len(r.ids_a) for r in run.results)} "
              "correspondences stored")
        check_links(route, proj, xml_c, 5.0, 4 if tiny else 20)
    if dev.type != "cuda":
        return {}
    res = match_kernel_times(inputs, card, at_9a)
    for name, r in res.items():
        r["err"] = err.get(name, 0.0)
    return res


# ---------------------------------------------------------------- phase 10


def make_intensity_project(root, scale, seed=71):
    """Route A's geometry built with smooth_field=600 and no jitter (the
    JAX intensity fixture's choices: line fits need dynamic range), setup
    1's s0 rescaled to clip(1.4 i + 30): the miscalibration to recover;
    the views registered to their true offsets."""
    import numpy as np

    from bigstitcher_spark_tpu_torch.io.chunkstore import ChunkStore
    from bigstitcher_spark_tpu_torch.utils.geometry import translation_affine
    from bigstitcher_spark_tpu_torch.utils.testdata import (
        append_view_transforms, make_synthetic_project)

    cfg = SCALES[scale]
    t0 = time.time()
    proj = make_synthetic_project(
        root, n_tiles=(2, 2, 1), tile_size=cfg["tile"],
        overlap=cfg["overlap"], block_size=cfg["block"], jitter=0.0,
        n_beads_per_tile=cfg["beads"], seed=seed, smooth_field=600.0,
        compression="raw")
    ds = ChunkStore.open(os.path.join(root, "dataset.n5")).open_dataset(
        "setup1/timepoint0/s0")
    img = ds.read_full().astype(np.float32)
    ds.write(np.clip(np.float32(1.4) * img + np.float32(30), 0,
                     65535).astype(np.uint16), (0, 0, 0))
    # registered, as after a solve: the intensity chain runs on registered
    # views (the generator's nominal grid is up to 4 px off the truth)
    append_view_transforms(proj.xml_path, {
        s: translation_affine(proj.true_offsets[s] - proj.nominal_offsets[s])
        for s in proj.true_offsets}, name="registration")
    print(f"  synthesized 4 tiles of {cfg['tile']} uint16 with a smooth "
          f"field, setup 1 rescaled to 1.4 i + 30, registered to the truth, "
          f"in {time.time() - t0:.1f}s (host)", flush=True)
    return proj


def linefit_spy():
    """Swap ``ops.intensity.linefit_ransac`` for a recorder of its inputs
    and outputs; returns (calls, undo)."""
    from bigstitcher_spark_tpu_torch.ops import intensity as OI

    real, calls = OI.linefit_ransac, []

    def spy(*a, **k):
        out = real(*a, **k)
        # the wrapper counts under its module name, which is now the spy's
        real.launches += spy.launches
        spy.launches = 0
        calls.append((a, out))
        return out

    spy.launches = 0
    OI.linefit_ransac = spy

    def undo():
        OI.linefit_ransac = real

    return calls, undo


def cg_spy():
    """Swap ``ops.solve.solve_intensity_device`` for a recorder of the
    systems it solves; returns (calls, undo)."""
    from bigstitcher_spark_tpu_torch.ops import solve as R

    real, calls = R.solve_intensity_device, []

    def spy(*a, **k):
        t0 = time.perf_counter()
        out = real(*a, **k)
        calls.append((a, out, time.perf_counter() - t0))
        return out

    R.solve_intensity_device = spy

    def undo():
        R.solve_intensity_device = real

    return calls, undo


def linefit_times(a, card):
    """K23 alone on one recorded launch's inputs: kernel and twin times,
    the bound (about 6 float32 operations a hypothesis and sample)."""
    from bigstitcher_spark_tpu_torch.ops import intensity as OI

    x, y, v, hyp, eps = a
    P, N = x.shape
    I = hyp.shape[1]
    r = dict(ms=time_ms(lambda: OI.linefit_ransac(x, y, v, hyp, eps)),
             plain_ms=time_ms(lambda: OI.linefit_ransac_plain(x, y, v, hyp,
                                                              eps), reps=2),
             library_ms=None,
             bound=bound(P * N * 12 + P * I * 12 + P * 16,
                         P * I * N * OPS["linefit"]),
             issue_floor_ms=issue_floor_ms(P * I * N * OPS["linefit"]))
    r["wrapper_ms"] = r["ms"]
    print(f"  linefit_ransac (K23) at {P} cell pairs x {N} samples x {I} "
          f"hypotheses [{card}]: kernel {r['ms']} ms  plain {r['plain_ms']} "
          f"ms  bound {r['bound'][0]:.4f} ms ({r['bound'][1]})  at one "
          f"operation an instruction {r['issue_floor_ms']:.4f} ms  library "
          "none", flush=True)
    return r


def phase10a(proj, scale, dev, card, launches):
    """10a: match-intensities at the reference defaults (8,8,8 cells,
    renderScale 0.25, RANSAC 1000 iterations, epsilon 0.02,
    minNumCandidates 1000); K23 held against its twin on every launch."""
    import torch

    from bigstitcher_spark_tpu_torch.cli.main import main
    from bigstitcher_spark_tpu_torch.ops import intensity as OI

    calls, undo = linefit_spy()
    try:
        matches, st = counted("10a", launches, dev, lambda: main(
            ["match-intensities", "-x", proj.xml_path, "--device", str(dev),
             *SCALES[scale]["intensity_args"]]))
    finally:
        undo()
    t = st.timings
    print(f"  [intensity 10a] {card}: {st.pairs} view pairs, "
          f"{st.cell_pairs} cell pairs fitted in {len(calls)} K23 launches, "
          f"{st.matches} cell matches kept; wall {st.seconds:.3f}s: sample "
          f"{t['sample']:.3f}s K23 {t['ransac']:.3f}s (card "
          f"{st.kernel:.4f}s) trim {t['trim']:.3f}s store {t['store']:.3f}s; "
          f"idle share {1 - st.kernel / max(st.seconds, 1e-9):.4f}",
          flush=True)
    check(len(calls) > 0 and st.matches > 0,
          f"10a: {st.matches} cell matches from {len(calls)} K23 launches")
    err = 0.0
    for a, got in calls:
        ref = OI.linefit_ransac_plain(*a)
        same = (torch.equal(got.counts, ref.counts)
                and torch.equal(got.best, ref.best)
                and torch.equal(got.count, ref.count))
        e = max(max_abs(got.a, ref.a), max_abs(got.b, ref.b))
        err = max(err, e)
        check(same and e <= 1e-5,
              f"10a K23 launch of {tuple(a[0].shape)} x {a[3].shape[1]}: "
              f"every count and argmax bitwise equal to the twin, a and b "
              f"within {e:.3g} <= 1e-5")
    check_fit_recovery(matches)
    biggest = max(calls, key=lambda c: c[0][0].numel() * c[0][3].shape[1])
    res = {}
    if dev.type == "cuda":
        res["linefit_ransac"] = {**linefit_times(biggest[0], card), "err": err}
    return res


def check_fit_recovery(matches):
    """Setup 1 was rescaled to 1.4 i + 30: (1) every kept fit is the least-
    squares line of its inliers (from their sums); (2) the inliers pooled
    over each view pair with setup 1 give a slope within 0.05 of 1.4 (of
    1/1.4 where setup 1 is the first view); (3) a cell's own slope is
    attenuated by the noise in x (errors in variables: a (1 - s^2 / var x),
    s the generator's sensor noise, times 1.4 where x is setup 1's), and the
    median cell lies within 0.03 of that prediction."""
    import numpy as np

    from bigstitcher_spark_tpu_torch.utils.testdata import NOISE_SIGMA

    lsq, pooled, dev_true, dev_pred = 0.0, {}, [], []
    for m in matches:
        n, sx, sy, sxx, _syy, sxy = m.stats
        var, cov = sxx / n - (sx / n) ** 2, sxy / n - sx * sy / n ** 2
        a = cov / var
        lsq = max(lsq, abs(m.fit[0] - a) / abs(a),
                  abs(m.fit[1] - (sy - a * sx) / n) / max(abs(sy / n), 1.0))
        if 1 not in (m.view_a.setup, m.view_b.setup):
            continue
        fwd = m.view_b.setup == 1
        want = 1.4 if fwd else 1 / 1.4
        noise = NOISE_SIGMA * (1.0 if fwd else 1.4)
        dev_true.append(abs(m.fit[0] - want))
        dev_pred.append(abs(m.fit[0] - want * (1 - noise ** 2 / var)))
        pooled.setdefault((m.view_a, m.view_b), []).append(m.stats)
    check(len(matches) > 0 and lsq <= 1e-9,
          f"10a: each of {len(matches)} fits is the least-squares line of its "
          f"inliers' sums within {lsq:.3g} <= 1e-9 (relative)")
    check(len(pooled) > 0, f"10a: {len(pooled)} view pairs with setup 1")
    for (va, vb), st in sorted(pooled.items()):
        n, sx, sy, sxx, _syy, sxy = np.sum(st, axis=0)
        a = (sxy - sx * sy / n) / (sxx - sx * sx / n)
        want = 1.4 if vb.setup == 1 else 1 / 1.4
        check(abs(a - want) < 0.05,
              f"10a: setup {va.setup} -> {vb.setup}, inliers of {len(st)} "
              f"cells pooled: slope {a:.5f} within {abs(a - want):.5f} < "
              f"0.05 of {want:.5f}")
    med_t, med_p = float(np.median(dev_true)), float(np.median(dev_pred))
    print(f"  10a cells' own slopes: median |a - 1.4 (1/1.4)| {med_t:.4f}, "
          f"{sum(e < 0.05 for e in dev_true)} of {len(dev_true)} within 0.05",
          flush=True)
    check(med_p < 0.03,
          f"10a: the cells' slopes lie a median {med_p:.4f} < 0.03 from "
          f"the errors-in-variables prediction (noise sigma {NOISE_SIGMA} "
          "in x)")


def intensity_sparse(n_cells, rows, diag, sidx, sw):
    """The intensity normal matrix as scipy.sparse, built term by term from
    its definition (apart from the CG's own assembly)."""
    import numpy as np
    import scipy.sparse as sp

    rows = np.asarray(rows, np.float64).reshape(-1, 8)
    ia, ib = 2 * rows[:, 0].astype(np.int64), 2 * rows[:, 1].astype(np.int64)
    n, sx, sy, sxx, syy, sxy = (rows[:, k] for k in range(2, 8))
    blocks = {(0, 0): sxx, (0, 1): sx, (0, 2): -sxy, (0, 3): -sx,
              (1, 0): sx, (1, 1): n, (1, 2): -sy, (1, 3): -n,
              (2, 0): -sxy, (2, 1): -sy, (2, 2): syy, (2, 3): sy,
              (3, 0): -sx, (3, 1): -n, (3, 2): sy, (3, 3): n}
    u = [ia, ia + 1, ib, ib + 1]
    si = np.asarray(sidx, np.int64).reshape(-1, 2)
    w = np.asarray(sw, np.float64)
    i = np.concatenate([u[a] for a, _ in blocks] + [si[:, 0], si[:, 1],
                                                    si[:, 0], si[:, 1]])
    j = np.concatenate([u[b] for _, b in blocks] + [si[:, 0], si[:, 1],
                                                    si[:, 1], si[:, 0]])
    v = np.concatenate(list(blocks.values()) + [w, w, -w, -w])
    N = 2 * n_cells
    return sp.coo_matrix((v, (i, j)), shape=(N, N)).tocsr() + sp.diags(diag)


def check_cg(what, args, x_dev, iters, dev, **shards):
    """A recorded intensity CG against cg_plain on the card (solution within
    rtol 1e-9 of the largest entry), and the residual |A x - b| / |b| <=
    1e-9 with A built by scipy.sparse on the host. ``shards``
    (``n_shards``, ``mesh``): the twin loop of the sharded system."""
    import numpy as np

    from bigstitcher_spark_tpu_torch.ops import solve as R

    n_cells, rows, diag, rhs, sidx, sw, _dev = args
    sysm = R.assemble_cg(n_cells, rows, diag, rhs, sidx, sw, dev, **shards)
    t0 = time.perf_counter()
    ref = R.cg_plain(sysm)
    plain_s = time.perf_counter() - t0
    x = x_dev.cpu().numpy()
    xr = ref.x.cpu().numpy()
    err = float(np.abs(x - xr).max())
    scale = float(np.abs(xr).max())
    A = intensity_sparse(n_cells, rows, diag, sidx, sw)
    res = float(np.linalg.norm(A @ x - rhs) / np.linalg.norm(rhs))
    terms = sum(int(m.vals.numel()) for m in getattr(
        sysm, "shards", []) + getattr(sysm, "reps", [sysm]))
    print(f"  [intensity {what}] {2 * n_cells} unknowns, {len(rows)} match "
          f"rows, {len(sidx)} smoothness pairs, {terms} CSR "
          f"terms: kernels {iters} / twin {ref.iterations} iterations "
          f"(cap {sysm.max_iter}); twin loop {plain_s:.3f}s", flush=True)
    check(err <= 1e-9 * scale and abs(iters - ref.iterations) <= 1,
          f"{what}: K24/K25 solution within {err:.3g} <= 1e-9 x {scale:.3g} "
          "of cg_plain on the card")
    check(res <= 1e-9, f"{what}: residual |Ax - b| / |b| = {res:.3g} <= 1e-9 "
                       "(A from scipy.sparse)")
    return sysm, err


def large_intensity_system(grid, seed=73):
    """7c's view grid, 8x8x8 cells a view: one match for each face-adjacent
    cell pair across every view edge, stats drawn as
    tests/test_solve_device.py::TestIntensityDevice._system draws them,
    and every view's smoothness pairs. Returns (cells, rows, smooth)."""
    import numpy as np

    from bigstitcher_spark_tpu_torch.models.intensity import smoothness_pairs

    rng = np.random.default_rng(seed)
    dims, G = (8, 8, 8), tuple(grid)
    ncell = 512
    vid = np.arange(int(np.prod(G))).reshape(G)
    cell = np.arange(ncell).reshape(dims)
    pairs = []
    for d in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[d], hi[d] = slice(0, G[d] - 1), slice(1, G[d])
        va, vb = vid[tuple(lo)].ravel(), vid[tuple(hi)].ravel()
        face_a = np.take(cell, [dims[d] - 1], axis=d).ravel()
        face_b = np.take(cell, [0], axis=d).ravel()
        pairs.append(np.stack([
            (va[:, None] * ncell + face_a[None, :]).ravel(),
            (vb[:, None] * ncell + face_b[None, :]).ravel()], 1))
    pairs = np.concatenate(pairs)
    M = len(pairs)
    x = rng.uniform(100, 1000, (M, 50))
    a = rng.uniform(0.8, 1.2, (M, 1))
    b = rng.uniform(-20, 20, (M, 1))
    y = a * x + b + rng.normal(0, 5, (M, 50))
    x, y = x / 500, y / 500
    rows = np.concatenate([pairs.astype(np.float64), np.stack(
        [np.full(M, 50.0), x.sum(1), y.sum(1), (x * x).sum(1),
         (y * y).sum(1), (x * y).sum(1)], 1)], 1)
    n_views = int(np.prod(G))
    return ncell * n_views, rows, smoothness_pairs(dims, n_views)


def cg_times(sysm, card, lanes=()):
    """K24 and K25 alone at ``sysm``'s shapes (the state held open so every
    launch works), against their twin steps, beside their bounds; K24
    beside torch's CSR product (``torch.mv`` on a sparse CSR tensor).
    ``lanes``: K24 also launched with each of these lanes a row, bitwise
    the wrapper's p_new and within rtol 1e-12 of its Ap, and timed both
    ways (``lanes_ms``: {G: [one at a time, back to back]})."""
    import torch

    from bigstitcher_spark_tpu_torch.ops import solve as R

    dev, n, nnz = sysm.device, sysm.n, sysm.vals.numel()
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    f64 = dict(dtype=torch.float64, device=dev)
    r0 = torch.randn(n, generator=g, **f64)
    x0 = torch.randn(n, generator=g, **f64)
    p_old = torch.randn(n, generator=g, **f64)
    p_new, ap = torch.empty(n, **f64), torch.empty(n, **f64)
    d0, i0 = R.cg_state(sysm, dev)
    d0[0], d0[1], d0[2] = 2.0, 0.5, 0.0
    i0[2] = 1 << 30
    d, i, r, x = d0.clone(), i0.clone(), r0.clone(), x0.clone()

    def reset():
        d.copy_(d0)
        i.copy_(i0)
        r.copy_(r0)
        x.copy_(x0)

    spmv = lambda: R.cg_spmv(sysm, r, p_old, p_new, ap, d, i)
    upd = lambda: R.cg_update(sysm, x, r, p_new, ap, d, i)
    reset()
    spmv()
    upd()
    got = (p_new.clone(), ap.clone(), r.clone(), x.clone(), d.clone())
    reset()
    pn2, ap2 = torch.empty_like(p_new), torch.empty_like(ap)
    R.cg_spmv_plain(sysm, r, p_old, pn2, ap2, d, i)
    R.cg_update_plain(sysm, x, r, pn2, ap2, d, i)
    ref = (pn2, ap2, r.clone(), x.clone(), d.clone())
    errs = [max_abs(a, b) for a, b in zip(got, ref)]
    scale = max(float(t.abs().max()) for t in ref)
    check(max(errs) <= 1e-12 * scale,
          f"K24/K25 one step at {n} unknowns: within {max(errs):.3g} of "
          "their twins (rtol 1e-12 of the largest entry)")
    res = {
        "cg_spmv": dict(
            err=max(errs[:2]),
            plain_ms=time_each(lambda: R.cg_spmv_plain(
                sysm, r, p_old, pn2, ap2, d, i), reset, reps=10, host=True),
            bound=bound(nnz * 12 + (n + 1) * 4 + n * 32, nnz * 4 + n * 4,
                        F64_OPS_PER_S),
            **spmv_yardsticks(sysm, spmv, reset, p_old)),
        "cg_update": dict(
            err=max(errs[2:]), ms=time_each(upd, reset),
            plain_ms=time_each(lambda: R.cg_update_plain(
                sysm, x, r, p_new, ap, d, i), reset, reps=10, host=True),
            library_ms=None,
            bound=bound(n * 48, n * 7, F64_OPS_PER_S)),
    }
    if lanes:
        res["cg_spmv"]["lanes_ms"] = lane_times(sysm, spmv, reset, p_new, ap,
                                                (r, p_old, d, i), lanes, card)
    for name, r_ in res.items():
        r_.setdefault("wrapper_ms", r_["ms"])
        lib = (f"  library {r_['library_ms']} ms (torch.mv, int32 CSR)"
               if r_["library_ms"] is not None else "  library none")
        print(f"  {name} at {n} unknowns, {nnz} CSR terms [{card}]: kernel "
              f"{r_['ms']} ms  plain {r_['plain_ms']} ms  bound "
              f"{r_['bound'][0]:.4f} ms ({r_['bound'][1]}){lib}", flush=True)
    y = res["cg_spmv"]
    print(f"  cg_spmv against torch.mv (int32 CSR) [{card}]: one launch "
          f"after a reset {y['ms']} / {y['library_ms']} ms; back to back "
          f"{y['b2b_ms']} / {y['library_b2b_ms']} ms (int64 indices "
          f"{y['library_int64_b2b_ms']} ms); with the host's time, back to "
          f"back {y['wrapper_ms']} / {y['library_wrapper_ms']} ms",
          flush=True)
    return res


def lane_times(sysm, spmv, reset, p_new, ap, state, lanes, card):
    """K24 launched directly with each of ``lanes`` lanes a row on the
    wrapper's inputs: checked against the wrapper's p_new (bitwise) and Ap
    (rtol 1e-12), then timed one at a time and back to back."""
    import torch

    from bigstitcher_spark_tpu_torch.ops import solve as R

    r, p_old, d, i = state
    reset()
    spmv()
    want = (p_new.clone(), ap.clone())
    out = {}
    for g in lanes:
        run = lambda: R.launch_cg_spmv(sysm, r, p_old, p_new, ap, d, i,
                                       lanes=g)
        reset()
        run()
        check(torch.equal(p_new, want[0]) and max_abs(ap, want[1])
              <= 1e-12 * float(want[1].abs().max()),
              f"K24 at {g} lanes a row: p_new bitwise, Ap within rtol 1e-12 "
              "of the wrapper's")
        out[g] = [time_each(run, reset), time_ms(run)]
        print(f"  cg_spmv at {g} lanes a row [{card}]: one launch after a "
              f"reset {out[g][0]} ms, back to back {out[g][1]} ms",
              flush=True)
    return out


def spmv_yardsticks(sysm, spmv, reset, p):
    """K24 (``spmv``, idempotent on fixed r and p_old) and torch.mv of the
    CSR matrix with K24's int32 indices on ``p``, each timed one launch at
    a time after ``reset`` (time_each: ``ms``, ``library_ms``) and back to
    back (time_ms: ``b2b_ms``, ``library_b2b_ms``; with the host's time:
    ``wrapper_ms``, ``library_wrapper_ms``); torch.mv with int64 indices
    back to back beside them."""
    import warnings

    import torch

    n = sysm.n
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # sparse CSR is "beta"
        csr = torch.sparse_csr_tensor(sysm.row_ptr, sysm.cols, sysm.vals,
                                      (n, n))
        csr64 = torch.sparse_csr_tensor(sysm.row_ptr.long(),
                                        sysm.cols.long(), sysm.vals, (n, n))
    mv = lambda: torch.mv(csr, p)
    return dict(ms=time_each(spmv, reset), library_ms=time_each(mv, reset),
                b2b_ms=time_ms(spmv), library_b2b_ms=time_ms(mv),
                wrapper_ms=time_ms(spmv, host=True),
                library_wrapper_ms=time_ms(mv, host=True),
                library_int64_b2b_ms=time_ms(lambda: torch.mv(csr64, p)))


def cg_report(what, card, work, wall, out, cg_s):
    """One solve's wall split: the CG's host assembly and upload, its loop
    (launches and state reads), the card's busy seconds inside the loop
    (CUDA events around each chunk's launches) and the idle share."""
    print(f"  [intensity {what}] {card}: {work}, wall {wall:.3f}s: assembly "
          f"{cg_s - out.seconds:.3f}s, CG loop {out.seconds:.3f}s "
          f"({out.iterations} iterations), card busy {out.card_seconds:.4f}s,"
          f" idle share {1 - out.card_seconds / max(wall, 1e-9):.4f}",
          flush=True)


def phase10b(proj, scale, dev, card, launches):
    """10b: solve-intensities on 10a's matches, then the large synthetic
    system; K24/K25 held against cg_plain and by their residual."""
    from bigstitcher_spark_tpu_torch.cli.main import main
    from bigstitcher_spark_tpu_torch.ops import intensity as OI

    calls, undo = cg_spy()
    try:
        t0 = time.perf_counter()
        counted("10b", launches, dev, lambda: main(
            ["solve-intensities", "-x", proj.xml_path, "--device", str(dev)]))
        wall = time.perf_counter() - t0
        args, out, cg_s = calls[-1]
        cg_report("10b", card, "solve-intensities", wall, out, cg_s)
        _sysm, err = check_cg("10b", args, out.x, out.iterations, dev)
        C, rows, smooth = large_intensity_system(SCALES[scale]["ip_grid"])
        t0 = time.perf_counter()
        counted("10b large", launches, dev, lambda:
                OI.solve_intensity_coefficients(
                    C, rows, 0.1, smooth_pairs=smooth, backend="device",
                    device=dev))
        wall = time.perf_counter() - t0
        args, out, cg_s = calls[-1]
        cg_report("10b large", card, f"{C} cells", wall, out, cg_s)
        sysm, err2 = check_cg("10b large", args, out.x, out.iterations, dev)
    finally:
        undo()
    if dev.type != "cuda":
        return {}
    res = cg_times(sysm, card)
    for r in res.values():
        r["err"] = max(r["err"], err, err2)
    return res


def coeff_times(kind, run, plain, nbytes, ops, card):
    """A K1 or K3 coefficient launch and its twin timed, with the bound."""
    r = dict(coeff_ms=time_ms(run, reps=5),
             coeff_plain_ms=time_ms(plain, reps=2, rounds=1),
             coeff_bound=bound(nbytes, ops),
             coeff_issue_floor_ms=issue_floor_ms(ops))
    print(f"  {kind} with coefficients [{card}]: kernel {r['coeff_ms']} ms  "
          f"plain {r['coeff_plain_ms']} ms  bound {r['coeff_bound'][0]:.4f} "
          f"ms ({r['coeff_bound'][1]})  at one operation an instruction "
          f"{r['coeff_issue_floor_ms']:.4f} ms", flush=True)
    return r


def phase10c(work, proj, scale, dev, card, launches):
    """10c: affine-fusion --intensityN5 on the composite route (K1 and its
    coefficient branch) and forced per block (K3's branch, K4), held
    against the twins; the JAX test's seam gate through fuse_volume."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.io.chunkstore import (
        ChunkStore, StorageFormat)
    from bigstitcher_spark_tpu_torch.io.dataset_io import ViewLoader
    from bigstitcher_spark_tpu_torch.io.spimdata import SpimData
    from bigstitcher_spark_tpu_torch.models import affine_fusion as A
    from bigstitcher_spark_tpu_torch.models.intensity import IntensityStore
    from bigstitcher_spark_tpu_torch.ops import fusion as F
    from bigstitcher_spark_tpu_torch.utils.geometry import Interval

    compute_block = compute_block_of(scale)
    sd = SpimData.load(proj.xml_path)
    loader = ViewLoader(sd)
    views = sd.view_ids()
    store = IntensityStore.for_project(sd)
    coeffs = {v: store.load_coefficients(v).astype(np.float32) for v in views}
    vols, rates = {}, {}
    for route, budget, extra in (
            ("10c composite", COMPOSITE_BUDGET, ["--intensityN5"]),
            ("10c uncorrected", COMPOSITE_BUDGET, []),
            ("10c per-block", 1, ["--intensityN5"])):
        out = os.path.join(work, route.replace(" ", "_") + ".ome.zarr")
        # a separate affine-fusion process uploads its grids itself: drop
        # the tables this process holds (solve-intensities registers one)
        A._COEFF_TABLES.clear()
        stats, wall = counted(route, launches, dev, lambda: run_cli(
            proj.xml_path, out, scale, str(dev), budget=budget,
            fusion_args=extra))
        report(stats, wall, card, route)
        check(stats.path == route.split()[1].replace("uncorrected",
                                                     "composite"),
              f"{route}: took the {stats.path} route")
        if route.endswith("per-block"):
            check(stats.kernel_blocks["gather"] > 0
                  and stats.kernel_blocks["shift"] == 0,
                  f"{route}: every block through K3 "
                  f"({stats.kernel_blocks})")
        rates[route] = stats.voxels / max(stats.seconds, 1e-9)
        vols[route] = read_volume(out)
        if route.endswith("per-block"):
            meta, blocks = pick_blocks(proj, out, compute_block)
    print(f"  [intensity 10c] {card}: fused voxels/s composite corrected "
          f"{rates['10c composite']:,.0f}, uncorrected "
          f"{rates['10c uncorrected']:,.0f}, per-block corrected "
          f"{rates['10c per-block']:,.0f}", flush=True)

    # the composite volume against K1's twin on the card
    with tile_budget(COMPOSITE_BUDGET):
        cp = A.plan_composite_volume(sd, loader, views, meta.bbox, None,
                                     A.BlendParams(), coefficients=coeffs,
                                     device=dev)
    tiles = [torch.from_numpy(loader.open(p.view).read_full()).to(dev)
             for p in cp.plans]
    params = (cp.fracs, cp.img_dims, cp.borders, cp.ranges, cp.inside_offs,
              0.0, 65535.0, cp.diags, cp.offs)
    kw = dict(out_shape=cp.out_shape, windows=cp.windows, n_offs=cp.n_offs,
              pad=cp.pad, kinds=cp.kinds, fusion_type="AVG_BLEND",
              out_dtype="uint16", coeffs=cp.coeffs.to(dev),
              coeff_affs=cp.coeff_affs)
    ref = F.composite_fuse_plain(tiles, *params, **kw).cpu().numpy()
    e1 = max_abs_u16(vols["10c composite"], ref, dev)
    check(e1 <= 1, f"10c composite volume {ref.shape}: |delta| {e1} <= 1 vs "
                   "the plain composite with coefficients on the device")
    del ref
    e2 = max_abs_u16(vols["10c per-block"], vols["10c composite"], dev)
    check(e2 <= 1, f"10c per-block (K3) volume: |delta| {e2} <= 1 vs the "
                   "composite (K1) one")
    moved = max_abs_u16(vols["10c composite"], vols["10c uncorrected"], dev)
    check(moved > 50, f"10c: the correction moves the volume by up to "
                      f"{moved} > 50")
    res = {}
    if dev.type == "cuda":
        n = int(np.prod(cp.out_shape))
        steps = sum(int(np.prod([b - a for a, b in zip(*w)]))
                    for w in cp.windows)
        res["composite_fuse"] = coeff_times(
            "composite_fuse (K1) at 10c's volume",
            lambda: F.composite_fuse(tiles, *params, **kw),
            lambda: F.composite_fuse_plain(tiles, *params, **kw),
            sum(t.numel() * t.element_size() for t in tiles) + n * 2,
            steps * (OPS["composite_view"] + OPS["coeff_k1"])
            + n * OPS["composite_final"], card)
        res["composite_fuse"]["coeff_err"] = float(e1)
    del tiles

    # per-block samples against K3's twin (coefficients), |delta| <= 1
    grid_err = 0
    for tag, b in blocks:
        staged = A.stage_block(sd, loader, views, b, meta.bbox,
                               compute_block, A.BlendParams(), None,
                               (0.0,) * 3, coeffs, dev)
        *ins, ioffs = [torch.from_numpy(a).to(dev) for a in staged.arrays]
        cf = dict(coeffs=staged.coeffs[0].to(dev),
                  coeff_affines=torch.from_numpy(staged.coeffs[1]).to(dev))
        fused, _w = F.fuse_block_plain(*ins, staged.shape, "AVG_BLEND", ioffs,
                                       **cf)
        want = F.convert_intensity_plain(fused, 0.0, 65535.0,
                                         "uint16").cpu().numpy()
        sl = tuple(slice(o, o + s) for o, s in zip(b.offset, b.size))
        got = vols["10c per-block"][sl]
        e = int(np.abs(got.astype(np.int64) - want[tuple(
            slice(0, s) for s in b.size)].astype(np.int64)).max())
        grid_err = max(grid_err, e)
        check(staged.kind == "gather" and e <= 1,
              f"10c per-block block {tag} at {b.offset}: |delta| {e} <= 1 vs "
              "K3's twin with coefficients on the device")
        if dev.type == "cuda" and tag == "tile corner":
            V = int(ins[0].shape[0])
            nb = int(np.prod(staged.shape))
            print(f"  fuse_block (K3) with coefficients form: "
                  f"{resample_form(F, staged.shape, V, ins[0].shape[1:])}; "
                  f"grids {tuple(cf['coeffs'].shape[1:4])}", flush=True)
            res["fuse_block"] = coeff_times(
                f"fuse_block (K3) at a {staged.shape} block of {V} views",
                lambda: F.fuse_block(*ins, staged.shape, "AVG_BLEND", ioffs,
                                     **cf),
                lambda: F.fuse_block_plain(*ins, staged.shape, "AVG_BLEND",
                                           ioffs, **cf),
                ins[0].numel() * ins[0].element_size()
                + cf["coeffs"].numel() * 4 + nb * 8,
                V * nb * (OPS["gather"] + OPS["coeff_k3"]), card)
    if "fuse_block" in res:
        res["fuse_block"]["coeff_err"] = float(grid_err)
    del vols

    # the seam gate of tests/test_intensity.py::test_cli_and_corrected_fusion
    # on a crop across the setup 0 / setup 1 seam, FIRST_WINS float32
    # in world coordinates: view 0 (setup 0) ends at x_end; below setup
    # 2's first row only setups 0 and 1 cover the crop
    bbox = meta.bbox
    x_end = int(round(sd.model(views[0])[0, 3])) + sd.view_size(views[0])[0]
    half = min(64, sd.view_size(views[0])[0] // 4)
    ylen = int(round(sd.model(views[2])[1, 3])) - int(bbox.min[1]) - 8
    crop = Interval.from_shape((2 * half, ylen, bbox.shape[2]),
                               (x_end - half, bbox.min[1], bbox.min[2]))
    cs = ChunkStore.create(os.path.join(work, "seam.n5"), StorageFormat.N5)
    jumps = {}
    for name, cf in (("raw", None), ("corrected", coeffs)):
        ds = cs.create_dataset(name, crop.shape, compute_block, "float32")
        A.fuse_volume(sd, loader, views, ds, crop, block_size=compute_block,
                      block_scale=(1, 1, 1), fusion_type="FIRST_WINS",
                      out_dtype="float32", min_intensity=0.0,
                      max_intensity=1.0, device=dev, coefficients=cf)
        v = ds.read_full()
        zs = slice(8, max(9, v.shape[2] - 8))
        left = v[half - 3:half, 8:ylen - 8, zs].mean()
        right = v[half + 1:half + 4, 8:ylen - 8, zs].mean()
        jumps[name] = abs(left - right) / right
    check(jumps["raw"] > 0.15 and jumps["corrected"] < jumps["raw"] / 3,
          f"10c seam: raw jump {jumps['raw']:.4f} > 0.15, corrected "
          f"{jumps['corrected']:.4f} < raw / 3")
    return res


def phase10_intensity(work, scale, dev, card, launches):
    """Phase 10: the intensity-correction chain on route A's geometry."""
    print("phase 10 (intensity correction)", flush=True)
    t0 = time.perf_counter()
    proj = make_intensity_project(os.path.join(work, "p10"), scale)
    res = phase10a(proj, scale, dev, card, launches)
    res.update(phase10b(proj, scale, dev, card, launches))
    res["coeff"] = phase10c(work, proj, scale, dev, card, launches)
    print(f"  phase 10 wall {time.perf_counter() - t0:.1f}s", flush=True)
    return res, proj


# ---------------------------------------------------------------- phase 11


def nonrigid_project(work, proj):
    """Route A's XML at its uncorrected registrations (phase 9's copy,
    before 9a's solve) beside 9a's interestpoints.n5 (8b's beads and 9a's
    correspondences) and a link to route A's images."""
    d = os.path.join(work, "p11")
    shutil.copytree(os.path.join(work, "match_9a"), d)
    shutil.copy(os.path.join(work, "match_8b", "dataset.xml"),
                os.path.join(d, "dataset.xml"))
    os.symlink(os.path.join(os.path.dirname(proj.xml_path), "dataset.n5"),
               os.path.join(d, "dataset.n5"))
    return os.path.join(d, "dataset.xml")


def views_near(sd, block_global):
    """How many views cover a block (their boxes overlap it grown by 2 px):
    the views the nonrigid planner keeps, up to its deformation."""
    from bigstitcher_spark_tpu_torch.utils.geometry import (
        Interval, transformed_interval)

    grown = block_global.expand(2)
    return sum(transformed_interval(sd.model(v), Interval.from_shape(
        sd.view_size(v))).overlaps(grown) for v in sd.view_ids())


def nonrigid_inputs(sd, loader, unique, block, bbox, compute_block, dev):
    """One block's K26 inputs on ``dev``, staged as fuse_nonrigid_volume
    stages them at the reference defaults, and the count of views, or None
    when no view is selected."""
    import torch

    from bigstitcher_spark_tpu_torch.models import nonrigid_fusion as NF

    arrays, nv, _p, _r = NF.stage_nonrigid_block(
        sd, loader, sd.view_ids(), unique, block, bbox, compute_block)
    if arrays is None:
        return None
    return [torch.from_numpy(a).to(dev) for a in arrays], nv


def k3_block(sd, loader, block, bbox, compute_block, dev):
    """The same block through K3 (affine fusion's gather kernel) and K4."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.models import affine_fusion as A
    from bigstitcher_spark_tpu_torch.ops import fusion as F
    from bigstitcher_spark_tpu_torch.utils.geometry import Interval

    bg = Interval.from_shape(compute_block, block.offset).translate(bbox.min)
    plans = A.plan_block(sd, loader, sd.view_ids(), bg, None)
    pshape = F.bucket_shape(np.max([p.patch_interval.shape for p in plans],
                                   axis=0))
    *ins, ioffs = [torch.from_numpy(a).to(dev) for a in A._gather_inputs(
        loader, plans, pshape, F.bucket_views(len(plans)), A.BlendParams(),
        (0.0, 0.0, 0.0))]
    fused, _w = F.fuse_block(*ins, compute_block, "AVG_BLEND", ioffs)
    return F.convert_intensity(fused, 0.0, 65535.0, "uint16")


def warp_placement(sd, unique, bbox, compute_block, view, x, cpd=10.0,
                   alpha=1.0):
    """Where nonrigid fusion shows what lies at world position ``x`` under
    ``view``'s registration: the w with A(w) w = x, A(w) the view's vertex
    models of the compute block holding w (as fuse_nonrigid_volume fits
    them) interpolated at w by K26's clamp rule, in float64. Fixed-point
    steps from w = x, each solving with A frozen."""
    import numpy as np

    from bigstitcher_spark_tpu_torch.models import nonrigid_fusion as NF
    from bigstitcher_spark_tpu_torch.utils.grid import GridBlock

    gdims = NF.control_grid_dims(compute_block, cpd)
    org, cb = np.asarray(bbox.min), np.asarray(compute_block)
    x = np.asarray(x, np.float64)
    w, grids = x, {}
    for _ in range(50):
        off = tuple(int(o) for o in np.floor((w - org) / cb) * cb)
        if off not in grids:
            res = NF._plan_nonrigid_block(
                sd, [view], unique, GridBlock(off, tuple(compute_block),
                                              (0, 0, 0)),
                bbox, compute_block, gdims, cpd, alpha, None)
            if res is None:
                raise SmokeFailure(f"11: {view} does not cover {w}")
            grids[off] = res[2][0][1].astype(np.float64)
        a = grids[off]
        pos = (w - (org + np.asarray(off)) + cpd) / cpd
        for d in range(3):  # x, then y, then z
            c = a.shape[0]
            p = np.clip(pos[d], 0, c - 1)
            lo = int(np.clip(np.floor(p), 0, max(c - 2, 0)))
            a = a[lo] * (1 - (p - lo)) + a[min(lo + 1, c - 1)] * (p - lo)
        a = a.reshape(3, 4)
        nxt = np.linalg.solve(a[:, :3], x - a[:, 3])
        done = np.abs(nxt - w).max() < 1e-6
        w = nxt
        if done:
            break
    return w


def segment_distance(p, a, b) -> float:
    """Distance from point p to the segment from a to b."""
    import numpy as np

    ab = b - a
    t = np.clip(np.dot(p - a, ab) / max(float(np.dot(ab, ab)), 1e-12), 0, 1)
    return float(np.linalg.norm(p - (a + t * ab)))


def recovery_gate(proj, sd, unique, vol, bbox, compute_block, dev, tiny):
    """JAX's test_recovers_misregistration gate on crops of the pairwise
    overlaps, detected with the port's DoG. Every bead 8 px inside exactly
    two tiles (and clear of the others) is checked; its expected position
    is the truth plus the mean registration error of the two views. JAX's
    gate: the nearest detection lies within 1.5 px of it and no second one
    within 4 px (no double image). On full-size tiles a view's fits may
    extrapolate from few correspondences, and the reference's warp then
    places a bead away from that expectation: such misses are counted and
    returned, an open fault of the algorithm (ROADMAP Queue 3), which JAX's
    fusion shares (tests/test_torch_nonrigid.py). Each bead is also held to
    where the fitted warps place it: its nearest detection lies within 1.5
    px of the segment between the two views' placements
    (:func:`warp_placement`): some detection does. Fails on a double image, on a bead off its
    placements, or on a crop where fewer than 3 beads meet JAX's gate.
    Returns (beads checked, beads that meet JAX's gate, worst of those,
    misses as (bead, px from the expectation), worst px from the
    placements)."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import dog as DG
    from bigstitcher_spark_tpu_torch.utils.geometry import apply_affine

    tile = np.asarray(sd.view_size(sd.view_ids()[0]))
    org = np.asarray(bbox.min)
    true = {s: np.asarray(o, np.float64) for s, o in proj.true_offsets.items()}
    view = {v.setup: v for v in sd.view_ids()}
    reg = {s: sd.model(v)[:, 3] for s, v in view.items()}
    beads = np.asarray(proj.bead_positions)
    local = {s: beads - o for s, o in true.items()}
    inside = {s: np.all((x >= 8) & (x <= tile - 8), axis=1)
              for s, x in local.items()}
    near_tile = {s: np.all((x >= -4) & (x <= tile + 3), axis=1)
                 for s, x in local.items()}

    total, met, worst, misses, off_warp = 0, 0, 0.0, [], 0.0
    for a, b in ((0, 1), (2, 3), (0, 2), (1, 3)):
        lo = np.maximum(np.maximum(true[a], true[b]).astype(int) - org, 0)
        hi = np.minimum(np.minimum(true[a], true[b]).astype(int) + tile - org,
                        vol.shape)
        crop = vol[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]].astype(np.float32)
        dogv, mask = DG.dog_block(torch.from_numpy(crop).to(dev),
                                  float(crop.min()), float(crop.max()), 0.01,
                                  1.8)
        pts, _v = DG.localize_quadratic(dogv.cpu().numpy(),
                                        np.argwhere(mask.cpu().numpy()))
        pts = pts + lo + org
        sel = inside[a] & inside[b]
        for s_ in true:
            if s_ not in (a, b):
                sel &= ~near_tile[s_]
        drift = 0.5 * ((reg[a] - true[a]) + (reg[b] - true[b]))
        checked = crop_met = 0
        for bead in beads[sel]:
            exp = bead + drift
            if np.any(exp - 4 < lo + org) or np.any(exp + 4 > hi + org):
                continue
            dist = np.linalg.norm(pts - exp, axis=1)
            near = np.sort(dist)[:2]
            if near[1] <= 4.0:
                raise SmokeFailure(f"11 overlap {a}-{b}: bead "
                                   f"{np.round(bead, 2)} double-imaged "
                                   f"({np.round(near, 3)} px)")
            placed = [warp_placement(
                sd, unique, bbox, compute_block, view[s],
                apply_affine(sd.model(view[s]), bead - true[s]))
                for s in (a, b)]
            e = min(segment_distance(p, *placed) for p in pts)
            if e >= 1.5:
                raise SmokeFailure(
                    f"11 overlap {a}-{b}: bead {np.round(bead, 2)} detected "
                    f"{e:.3f} px from where the fitted warps place it "
                    f"({np.round(placed[0], 2)}, {np.round(placed[1], 2)}; "
                    "need < 1.5)")
            off_warp = max(off_warp, e)
            checked += 1
            if near[0] < 1.5:
                crop_met += 1
                worst = max(worst, float(near[0]))
            else:
                misses.append((bead, float(near[0])))
                print(f"  NOT met: 11 overlap {a}-{b} bead "
                      f"{np.round(bead, 2)} {near[0]:.3f} px from truth + "
                      f"drift; the fitted warps place it "
                      f"{np.linalg.norm(placed[0] - exp):.3f} and "
                      f"{np.linalg.norm(placed[1] - exp):.3f} px from it "
                      f"(setups {a}, {b}), the detection {e:.3f} px from "
                      "them", flush=True)
        check(crop_met >= (0 if tiny else 3),
              f"11 overlap {a}-{b} crop {tuple(int(x) for x in hi - lo)}: "
              f"{crop_met} of {checked} beads within 1.5 px of truth + drift "
              "(JAX's gate), none double-imaged within 4 px, each within "
              "1.5 px of the fitted warps' placement")
        total += checked
        met += crop_met
    return total, met, worst, misses, off_warp


def nonrigid_times(ins, nv, card):
    """K26 at the main path's compute block (the tile corner's staged
    inputs) against its twin on the card, timed, with its bound."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import fusion as F
    from bigstitcher_spark_tpu_torch.ops import nonrigid as NR

    bs = compute_block_of("full")
    run = lambda: NR.nonrigid_fuse_block(*ins, bs, "AVG_BLEND")
    plain = lambda: NR.nonrigid_fuse_block_plain(*ins, bs, "AVG_BLEND")
    got, ref = run(), plain()
    err = max(max_abs(got[0], ref[0]), max_abs(got[1], ref[1]))
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)
    del got, ref
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        run()
        torch.cuda.synchronize()
    wrapper_ms = (time.perf_counter() - t0) * 100.0
    V, nb = int(ins[0].shape[0]), int(np.prod(bs))
    nbytes = sum(t.numel() * t.element_size() for t in ins) + nb * 8
    r = dict(err=err, ms=time_ms(run, reps=10), wrapper_ms=wrapper_ms,
             plain_ms=time_ms(plain, reps=2, rounds=1), library_ms=None,
             bound=bound(nbytes, nv * nb * OPS["nonrigid"]),
             issue_floor_ms=issue_floor_ms(nv * nb * OPS["nonrigid"]),
             form=resample_form(F, bs, V, tuple(ins[0].shape[1:])))
    print(f"  nonrigid_fuse (K26) form: {r['form']}", flush=True)
    print(f"  nonrigid_fuse (K26) at a {bs} block of {nv} views ({V} "
          f"staged, {tuple(ins[0].shape[1:])} {ins[0].dtype} patches, grids "
          f"{tuple(ins[1].shape[1:4])}) [{card}]: max|delta| {err:.3g}  "
          f"kernel {r['ms']} ms  wrapper {wrapper_ms:.4f} ms  plain "
          f"{r['plain_ms']} ms  bound {r['bound'][0]:.4f} ms "
          f"({r['bound'][1]}; at one operation an instruction "
          f"{r['issue_floor_ms']:.4f} ms)  library none", flush=True)
    return r


def phase11_nonrigid(work, proj, scale, dev, card, launches):
    """Phase 11: nonrigid-fusion through the CLI entry functions on route
    A's project, with 9a's correspondences at the views' uncorrected
    registrations; K26 held against its twin and, on identity grids,
    against K3; JAX's recovery gate on the overlaps; K26 timed."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.cli.main import main
    from bigstitcher_spark_tpu_torch.io.container import read_container_meta
    from bigstitcher_spark_tpu_torch.io.dataset_io import ViewLoader
    from bigstitcher_spark_tpu_torch.io.interestpoints import (
        InterestPointStore)
    from bigstitcher_spark_tpu_torch.io.spimdata import SpimData
    from bigstitcher_spark_tpu_torch.models import nonrigid_fusion as NF
    from bigstitcher_spark_tpu_torch.ops import fusion as F
    from bigstitcher_spark_tpu_torch.ops import nonrigid as NR
    from bigstitcher_spark_tpu_torch.utils.geometry import Interval
    from bigstitcher_spark_tpu_torch.utils.grid import create_grid

    print("phase 11 (nonrigid fusion)", flush=True)
    t_phase = time.perf_counter()
    cfg = SCALES[scale]
    compute_block = compute_block_of(scale)
    xml = nonrigid_project(work, proj)
    out = os.path.join(work, "nonrigid.ome.zarr")
    main(["create-fusion-container", "-x", xml, "-o", out, "-s", "ZARR",
          "-d", "UINT16", "-c", "raw", "--blockSize",
          ",".join(str(b) for b in cfg["block"]), "--multiRes"])
    t0 = time.perf_counter()
    (stats,) = counted("11", launches, dev, lambda: main(
        ["nonrigid-fusion", "-o", out, "-l", "beads", "--device", str(dev)]))
    wall = time.perf_counter() - t0
    t = stats.timings
    card_s = t.get("card")
    print(f"  [nonrigid 11] {card}: {stats.blocks} blocks "
          f"({stats.skipped_empty} empty), {stats.voxels} voxels in "
          f"{stats.seconds:.3f}s -> {stats.voxels / stats.seconds:,.0f} fused "
          f"voxels/s (tool wall {wall:.3f}s with the pyramid); plan "
          f"{t['plan']:.3f}s read {t['read']:.3f}s h2d {t['h2d']:.3f}s kernel "
          f"{t['kernel']:.3f}s d2h {t['d2h']:.3f}s write {t['write']:.3f}s; "
          + (f"card busy {card_s:.4f}s, idle share "
             f"{1 - card_s / stats.seconds:.4f}" if card_s is not None
             else "card not measured (CPU)"), flush=True)
    store, mr, read = container_levels(out)
    vol = read(0)
    check(stats.voxels == vol.size and stats.kernel_blocks["nonrigid"]
          == stats.blocks - stats.skipped_empty and len(mr) > 1,
          f"11: {stats.voxels} voxels fused through K26 in "
          f"{stats.kernel_blocks['nonrigid']} blocks, {len(mr) - 1} pyramid "
          "levels")
    check_level_blocks("11", mr, read, dev)

    sd = SpimData.load(xml)
    loader = ViewLoader(sd)
    views = sd.view_ids()
    unique = NF.build_unique_points(sd, InterestPointStore.for_project(sd),
                                    views, ["beads"])
    counts = {v.setup: len(unique.targets[v]) for v in views}
    tiny = scale == "tiny"
    # tiny tiles share a few beads: not every view has a correspondence
    check(all(n > 0 for n in counts.values()) or tiny,
          f"11: unique points per setup {counts}")
    bbox = read_container_meta(store).bbox
    grid = create_grid(bbox.shape, compute_block, cfg["block"])
    picks = {}
    for blk in grid:
        n = views_near(sd, Interval.from_shape(compute_block, blk.offset
                                               ).translate(bbox.min))
        picks.setdefault(n, blk)
    worst, res, seen = 0, {}, []
    for n in (n for n in (1, 2, 4) if n in picks):
        blk = picks[n]
        ins, nv = nonrigid_inputs(sd, loader, unique, blk, bbox,
                                  compute_block, dev)
        fused, _w = NR.nonrigid_fuse_block_plain(*ins, compute_block,
                                                 "AVG_BLEND")
        want = F.convert_intensity_plain(fused, 0.0, 65535.0,
                                         "uint16").cpu().numpy()
        del fused, _w
        sl = tuple(slice(o, o + s) for o, s in zip(blk.offset, blk.size))
        e = int(np.abs(vol[sl].astype(np.int64) - want[tuple(
            slice(0, s) for s in blk.size)].astype(np.int64)).max())
        worst = max(worst, e)
        seen.append(nv)
        check(e <= 1,
              f"11 block of {nv} views at {blk.offset}: |delta| {e} <= 1 vs "
              "K26's twin on the device")
        if nv == 4 and dev.type == "cuda":
            res["nonrigid_fuse"] = nonrigid_times(ins, nv, card)
        del ins
    # tiny tiles leave no block to a single view
    check(seen == [1, 2, 4] or (tiny and 4 in seen),
          f"11: the checked blocks hold {seen} views")

    # identity grids (no correspondence: M = 0) against K3's fusion
    empty = NF.UniquePoints({v: np.zeros((0, 3)) for v in views},
                            {v: np.zeros((0, 3)) for v in views})
    blk = picks[4]
    ins, _nv = nonrigid_inputs(sd, loader, empty, blk, bbox, compute_block,
                               dev)
    fused, _w = NR.nonrigid_fuse_block(*ins, compute_block, "AVG_BLEND")
    a = F.convert_intensity(fused, 0.0, 65535.0, "uint16").to(torch.int32)
    b = k3_block(sd, loader, blk, bbox, compute_block, dev).to(torch.int32)
    e_id = int((a - b).abs().max())
    check(e_id <= 1 and int(b.max()) > 0,
          f"11 identity grids at {blk.offset}: K26 within |delta| {e_id} <= 1 "
          "of K3's fusion of the block")
    del ins, fused, _w, a, b

    n_checked, met, gate, misses, off_warp = recovery_gate(
        proj, sd, unique, vol, bbox, compute_block, dev, tiny)
    print(f"  [nonrigid 11] recovery gate (JAX's): {met} of {n_checked} "
          f"beads in 4 overlap crops within 1.5 px of truth + drift, worst "
          f"{gate:.3f} px; "
          + (f"NOT met for {len(misses)} (worst "
             f"{max(m[1] for m in misses):.3f} px), where the fits "
             "extrapolate: open fault, ROADMAP Queue 3; " if misses else "")
          + f"every bead within {off_warp:.3f} px of the fitted warps' "
          f"placement; twin blocks worst |delta| {worst}, identity vs K3 "
          f"{e_id}; phase 11 wall {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    if "nonrigid_fuse" in res:
        res["nonrigid_fuse"]["err"] = max(res["nonrigid_fuse"]["err"], worst)
    return res


# ---------------------------------------------------------------- phase 12


def scan_plan(sd, loader, views, bbox, compute_block, block_size):
    """Route B's per-block plan (the blocks with views; K2's numbers of
    each, ``affine_fusion.shift_plan``) as the arguments of
    fuse_volume_scan: (view_idx, floor_offs, fracs, lpos0, img_dims,
    borders, blend_ranges, valid, block_offsets, inside_offs), the padded
    out_shape and the grid blocks planned."""
    import numpy as np

    from bigstitcher_spark_tpu_torch.models import affine_fusion as A
    from bigstitcher_spark_tpu_torch.ops import fusion as F
    from bigstitcher_spark_tpu_torch.utils.geometry import Interval
    from bigstitcher_spark_tpu_torch.utils.grid import create_grid

    bs = tuple(int(b) for b in compute_block)
    planned = []
    for blk in create_grid(bbox.shape, bs, block_size):
        bg = Interval.from_shape(bs, blk.offset).translate(bbox.min)
        plans = A.plan_block(sd, loader, views, bg, None)
        if plans:
            planned.append((blk, bg, plans))
    check(all(p.is_translation and p.level == 0
              for _b, _g, plans in planned for p in plans),
          f"{len(planned)} blocks with views, all translations at level 0")
    K = max(F.bucket_views(len(p)) for _b, _g, p in planned)
    rows = [A.shift_plan(loader, plans, bg, K, A.BlendParams(),
                         (0.0, 0.0, 0.0)) for _b, bg, plans in planned]
    view_idx = np.array([[views.index(p.view) for p in plans]
                         + [0] * (K - len(plans))
                         for _b, _g, plans in planned], np.int32)
    cols = [np.stack([r[i] for r in rows]) for i in range(8)]
    offsets = np.array([b.offset for b, _g, _p in planned], np.int64)
    out_shape = tuple(-(-int(n) // b) * b for n, b in zip(bbox.shape, bs))
    return ((view_idx, *cols[:7], offsets, cols[7]), out_shape,
            [b for b, _g, _p in planned])


def scan_bound(sc, itemsize, sector=32):
    """K27's least bytes: the 32-byte tile sectors the valid slots'
    windows cover (each once; z rows start on sector boundaries when tz x
    itemsize is a multiple of 32) plus 4 B written a voxel of the volume;
    its operations: K2's per valid view-voxel."""
    import numpy as np
    import torch

    V, tx, ty, tz = (int(v) for v in sc.tiles.shape)
    per_row = -(-tz * itemsize // sector)
    hit = torch.zeros((V, tx, ty, per_row), dtype=torch.bool,
                      device=sc.tiles.device)
    ps = [b + 1 for b in sc.block_shape]
    for (v, c), ok in zip(zip(sc.view_idx.reshape(-1).tolist(),
                              sc.clamp.reshape(-1, 3).tolist()),
                          sc.valid.reshape(-1).tolist()):
        if ok:
            z0, z1 = c[2] * itemsize // sector, -(-(c[2] + ps[2]) * itemsize
                                                  // sector)
            hit[v, c[0]:c[0] + ps[0], c[1]:c[1] + ps[1], z0:z1] = True
    nbytes = int(hit.sum()) * sector + int(np.prod(sc.out_shape)) * 4
    nvalid = int((sc.valid > 0).sum())
    return bound(nbytes, nvalid * int(np.prod(sc.block_shape)) * OPS["shift"])


def phase12_scan(scale, dev, card, launches, a, out_b):
    """Phase 12: route A's project fused by fuse_volume_scan (K27 + K4)
    from its tiles resident on the card, on route B's per-block plan; the
    uint16 volume within |delta| <= 1 of route B's s0 (expected bitwise:
    the same K2 math); K27 and its masks mode bitwise equal to the twin on
    phase 2's picked blocks; K27 timed on the whole plan."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import fusion as F

    proj, _out_a, _vol_a, meta, blocks, sd, loader = a
    print("phase 12 (volume scan fusion from resident tiles)", flush=True)
    bs = compute_block_of(scale)
    views = sd.view_ids()
    t0 = time.perf_counter()
    args, out_shape, planned = scan_plan(sd, loader, views, meta.bbox, bs,
                                         meta.block_size)
    t_plan = time.perf_counter() - t0
    *cols, ioffs = args
    t0 = time.perf_counter()
    host = np.stack([loader.open(v).read_full() for v in views])
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    tiles = torch.from_numpy(host).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    del host

    def fuse(c, **kw):
        return F.fuse_volume_scan(tiles, *c, 0.0, 65535.0, out_shape, bs,
                                  "AVG_BLEND", "uint16", inside_offs=ioffs,
                                  **kw)

    def fused_volume():
        t0 = time.perf_counter()
        out = fuse(cols)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    out, t_fuse = counted("12", launches, dev, fused_volume)
    shape = tuple(int(n) for n in meta.bbox.shape)
    vol = out[:shape[0], :shape[1], :shape[2]].cpu().numpy()
    del out
    voxels = int(np.prod(shape))
    print(f"  [scan 12] {card}: {len(planned)} blocks of {bs} into "
          f"{out_shape}, {cols[0].shape[1]} slots a block; plan "
          f"{t_plan:.3f}s, tile read {t_read:.3f}s, upload of "
          f"{tiles.numel() * tiles.element_size() / 1e9:.3f} GB "
          f"{t_up:.3f}s, K27 + K4 {t_fuse:.4f}s -> "
          f"{voxels / t_fuse:,.0f} fused voxels/s", flush=True)
    from_b = read_volume(out_b)
    err = max_abs_u16(vol, from_b, dev)
    ndiff = int((vol != from_b).sum())
    check(err <= 1, f"phase 12 volume {vol.shape}: |delta| {err} <= 1 of "
                    f"route B's per-block s0 ({ndiff} voxels differ)")
    del vol, from_b
    # K27 and its masks mode against the twin on phase 2's picked blocks
    pick = [i for i, b in enumerate(planned)
            if any(b.offset == p.offset for _t, p in blocks)]
    sub = [c[pick] for c in cols]
    io = ioffs[pick]
    sc = F.VolumeScanInputs(tiles, *sub, out_shape, bs, io)
    ref = F._volume_scan_plain(sc, "AVG_BLEND", False)
    got = F.launch_fuse_volume_scan(sc) if dev.type == "cuda" else ref
    e27 = max_abs(got, ref)
    check(torch.equal(got, ref), f"K27 on {len(pick)} picked blocks: "
          "bitwise equal to its twin on the card")
    del got, ref
    m = F.fuse_volume_scan(tiles, *sub, 0.0, 65535.0, out_shape, bs,
                           "AVG_BLEND", "uint16", True, io)
    mp = F.fuse_volume_scan_plain(tiles, *sub, 0.0, 65535.0, out_shape, bs,
                                  "AVG_BLEND", "uint16", True, io)
    m, mp = m.to(torch.int32), mp.to(torch.int32)
    check(torch.equal(m, mp) and int(m.max()) == 65535,
          f"K27 masks on {len(pick)} picked blocks: equal to the twin's")
    del m, mp
    if dev.type != "cuda":
        return {}
    sc = F.VolumeScanInputs(tiles, *cols, out_shape, bs, ioffs)
    r = dict(err=e27, ms=time_ms(lambda: F.launch_fuse_volume_scan(sc),
                                 reps=3),
             wrapper_ms=time_ms(lambda: fuse(cols), reps=3),
             plain_ms=time_ms(lambda: F._volume_scan_plain(
                 sc, "AVG_BLEND", False), reps=1, rounds=1),
             library_ms=None, bound=scan_bound(sc, tiles.element_size()))
    print(f"  fuse_volume_scan (K27) over {len(planned)} blocks [{card}]: "
          f"kernel {r['ms']} ms (the volume's zero fill included)  wrapper "
          f"(tables, K27, K4) {r['wrapper_ms']} ms  plain {r['plain_ms']} "
          f"ms  bound {r['bound'][0]:.4f} ms ({r['bound'][1]})  library "
          "none", flush=True)
    return {"fuse_volume_scan": r}


# ---------------------------------------------------------------- phase 13


def sharded_run(route, xml, out, ref_out, scale, dev, card, launches,
                **cli):
    """affine-fusion --devices 4 through the CLI entry function: the
    sharded route, no per-block or composite kernel, its mesh, batches and
    split printed, s0 bitwise equal to ``ref_out``'s (the per-block route's
    container of the same project: the batch forms and K28 take its
    kernels' and K4's arithmetic on the same staged inputs). Returns the
    FusionStats."""
    import numpy as np

    from bigstitcher_spark_tpu_torch import ops

    reset_peak(dev)
    cli["fusion_args"] = ["--devices", "4", *cli.get("fusion_args", ())]
    stats, wall = counted(route, launches, dev, lambda: run_cli(
        xml, out, scale, str(dev), **cli))
    peak = peak_bytes(dev)
    got = {**ops.launch_counts(), **ops.coeff_launch_counts()}
    report(stats, wall, card, route)
    per_block = ("fuse_block_shift", "fuse_block", "fuse_block_sep",
                 "convert_intensity", "composite_fuse")
    check(stats.path == "sharded" and not any(got[k] for k in per_block),
          f"{route} took the sharded route, no per-block or composite "
          f"kernel ({stats.path}, {[got[k] for k in per_block]})")
    print(f"  [{route}] {card}: mesh {len(stats.mesh)} device(s) "
          f"{stats.mesh} for --devices 4; " + "; ".join(
              f"{b['key'][0]} x{b['key'][-1]} views: {b['blocks']} blocks, "
              f"per_dev {b['per_dev']}, {b['batches']} batches"
              for b in stats.buckets)
          + f"; launches {[(k, got[k]) for k in ROUTE_KERNELS[route]]}"
          + (f"; device memory peak {peak} B" if peak is not None else ""),
          flush=True)
    vol, ref = read_volume(out), read_volume(ref_out)
    check(vol.shape == ref.shape and np.array_equal(vol, ref)
          and vol.std() > 0,
          f"{route}: s0 {vol.shape} bitwise equal to "
          f"{os.path.basename(ref_out)}")
    return stats


def phase13_sharded(work, scale, dev, card, launches, proj_a, out_b, proj_c,
                    proj10):
    """Phase 13: affine-fusion --devices 4 on the one card (a one-device
    mesh, batches of 4 x per_dev blocks, as JAX on a one-device host): 13a
    route A's project with --pyramid, 13b route C's, 13c route D's, 13d
    10c's corrected per-block case; each s0 bitwise equal to its per-block
    route's container, 13a's levels to route B's."""
    import numpy as np

    from bigstitcher_spark_tpu_torch.models import affine_fusion as A

    cfg = SCALES[scale]
    print("phase 13 (sharded route, --devices 4)", flush=True)
    t0 = time.perf_counter()
    # 13a: storage blocks halved in z with --blockScale 2,2,2 keep route
    # B's compute block and make level 1's per-block piece one chunk
    block = (cfg["block"][0], cfg["block"][1], cfg["block"][2] // 2)
    print(f"  13a container: --blockSize {block} with --blockScale 2,2,2 "
          f"(compute block {compute_block_of(scale)}; at route A's blocks "
          "level 1's piece is half a chunk in z, so no level is eligible)",
          flush=True)
    out = os.path.join(work, "13a.ome.zarr")
    st = sharded_run("13a", proj_a.xml_path, out, out_b, scale, dev, card,
                     launches, container_args=["--multiRes"], block=block,
                     fusion_args=["--pyramid", "--blockScale", "2,2,2"])
    check(st.pyramid_levels >= 1 and st.kernel_blocks["shift"] > 0,
          f"13a: {st.pyramid_levels} epilogue level(s), "
          f"{st.kernel_blocks['shift']} blocks through K2's batch form")
    _s, mr, read = container_levels(out)
    _sb, mr_b, read_b = container_levels(out_b)
    check(len(mr) == len(mr_b), f"13a and route B: {len(mr)} levels")
    for lvl in range(1, len(mr)):
        a, b = read(lvl), read_b(lvl)
        how = "epilogue" if lvl <= st.pyramid_levels else "downsample stage"
        check(a.shape == b.shape and np.array_equal(a, b) and a.std() > 0,
              f"13a level {lvl} {a.shape} ({how}) bitwise equal to route "
              "B's downsample-stage level")
    st = sharded_run("13b", proj_c.xml_path,
                     os.path.join(work, "13b.ome.zarr"),
                     os.path.join(work, "route_c.ome.zarr"), scale, dev, card,
                     launches)
    check(st.kernel_blocks["gather"] > 0 and st.kernel_blocks["shift"] > 0,
          f"13b: gather and shift buckets ({st.kernel_blocks})")
    st = sharded_run("13c", proj_a.xml_path, os.path.join(work, "13c.n5"),
                     os.path.join(work, "route_d.n5"), scale, dev, card,
                     launches, storage="N5", container_args=[
                         "--preserveAnisotropy", "--anisotropyFactor",
                         str(ANISO)])
    check(st.kernel_blocks["sep"] > 0 and st.kernel_blocks["shift"] == 0
          and st.kernel_blocks["gather"] == 0,
          f"13c: every block through K5's batch form ({st.kernel_blocks})")
    A._COEFF_TABLES.clear()  # an affine-fusion process uploads its grids
    st = sharded_run("13d", proj10.xml_path,
                     os.path.join(work, "13d.ome.zarr"),
                     os.path.join(work, "10c_per-block.ome.zarr"), scale, dev,
                     card, launches, fusion_args=["--intensityN5"])
    check(st.kernel_blocks["gather"] > 0 and st.kernel_blocks["shift"] == 0,
          f"13d: every block through K3's batch form with its grids "
          f"({st.kernel_blocks})")
    print(f"  phase 13 wall {time.perf_counter() - t0:.1f}s", flush=True)


# ---------------------------------------------------------------- phase 14


def peak_text(dev):
    p = peak_bytes(dev)
    return "not measured (CPU)" if p is None else f"{p} B"


def phase14a(proj, scale, dev, card, launches, det_one):
    """14a: detect_interest_points(devices=4) through the API on route A's
    project at 8a's parameters, then with 8d's descriptors: points, values
    (and descriptors, flags) bitwise 8a's and 8d's one-device results."""
    import numpy as np

    from bigstitcher_spark_tpu_torch.io.dataset_io import ViewLoader
    from bigstitcher_spark_tpu_torch.io.spimdata import SpimData
    from bigstitcher_spark_tpu_torch.models import detection as TD

    cfg = SCALES[scale]
    block = ({} if cfg["det_block"] is None else
             dict(block_size=tuple(cfg["det_block"])))
    sd = SpimData.load(proj.xml_path)
    for route, desc, ref in (("14a", False, det_one["8a"]),
                             ("14a desc", True, det_one["8d"])):
        params = TD.DetectionParams(label="beads", sigma=1.8, threshold=0.008,
                                    downsample_xy=2, downsample_z=1,
                                    extract_descriptors=desc, **block)
        stats = TD.DetectionStats()
        reset_peak(dev)
        t0 = time.perf_counter()
        dets = counted(route, launches, dev, lambda: (
            TD.detect_interest_points(
                sd, ViewLoader(sd), [d.view for d in ref], params,
                progress=False, device=dev, devices=4, stats=stats)),
            exclusive=True)
        wall = time.perf_counter() - t0
        t = stats.timings
        print(f"  [{route}] {card}: mesh {len(stats.mesh)} device(s) "
              f"{stats.mesh} for devices=4; {stats.blocks} blocks in "
              f"{stats.buckets} buckets / {stats.batches} batches, per_dev "
              f"{stats.per_dev}; {stats.points} points; wall {wall:.3f}s -> "
              f"{stats.core_voxels / wall:,.0f} det-res voxels/s; min/max "
              f"{t['minmax']:.3f}s read {t['read']:.3f}s h2d {t['h2d']:.3f}s "
              f"kernels {t['kernels']:.4f}s d2h {t['d2h']:.3f}s write (tail) "
              f"{t['tail']:.3f}s; device memory peak {peak_text(dev)}",
              flush=True)
        check(stats.mesh and stats.batches > 0,
              f"{route}: the sharded route ran ({stats.batches} batches)")
        for a, b in zip(ref, dets):
            same = (a.view == b.view and np.array_equal(a.points, b.points)
                    and np.array_equal(a.values, b.values))
            if desc:
                same &= (np.array_equal(a.descriptors, b.descriptors)
                         and np.array_equal(a.descriptor_valid,
                                            b.descriptor_valid))
            check(same and len(b.points) > 0,
                  f"{route} {b.view}: {len(b.points)} points, values"
                  + (", descriptors and flags" if desc else "")
                  + f" bitwise the one-device run's ({route[:3]}"
                  + (" = 8d" if desc else " = 8a") + ")")


def phase14b(work, proj, scale, dev, card, launches):
    """14b: nonrigid-fusion --devices 4 through the CLI entry function on
    phase 11's inputs: K26's batch form and K4 a batch, no per-block K26;
    s0 and every level bitwise phase 11's."""
    import numpy as np

    from bigstitcher_spark_tpu_torch.cli.main import main

    cfg = SCALES[scale]
    xml = os.path.join(work, "p11", "dataset.xml")
    out = os.path.join(work, "nonrigid14.ome.zarr")
    main(["create-fusion-container", "-x", xml, "-o", out, "-s", "ZARR",
          "-d", "UINT16", "-c", "raw", "--blockSize",
          ",".join(str(b) for b in cfg["block"]), "--multiRes"])
    reset_peak(dev)
    t0 = time.perf_counter()
    (stats,) = counted("14b", launches, dev, lambda: main(
        ["nonrigid-fusion", "-o", out, "-l", "beads", "--device", str(dev),
         "--devices", "4"]), exclusive=True)
    wall = time.perf_counter() - t0
    from bigstitcher_spark_tpu_torch import ops

    got = ops.launch_counts()
    t = stats.timings
    print(f"  [14b] {card}: mesh {len(stats.mesh)} device(s) {stats.mesh} "
          f"for --devices 4; " + "; ".join(
              f"bucket {b['key'][1:]}: {b['blocks']} blocks, per_dev "
              f"{b['per_dev']}, {b['batches']} batches"
              for b in stats.buckets)
          + f"; {stats.batches} batches, {stats.voxels} voxels in "
          f"{stats.seconds:.3f}s -> {stats.voxels / stats.seconds:,.0f} fused "
          f"voxels/s (tool wall {wall:.3f}s with the sharded pyramid); plan "
          f"{t['plan']:.3f}s read {t['read']:.3f}s h2d {t['h2d']:.3f}s "
          f"kernel {t['kernel']:.4f}s d2h {t['d2h']:.3f}s write "
          f"{t['write']:.3f}s; launches nonrigid_fuse {got['nonrigid_fuse']}"
          f", nonrigid_fuse_batch {got['nonrigid_fuse_batch']}; device "
          f"memory peak {peak_text(dev)}", flush=True)
    check(stats.path == "sharded" and got["nonrigid_fuse"] == 0
          and (got["nonrigid_fuse_batch"] == stats.batches
               or dev.type != "cuda"),
          f"14b: the sharded route, {got['nonrigid_fuse_batch']} launches of "
          f"K26's batch form for {stats.batches} batches, no per-block K26")
    _s, mr, read = container_levels(out)
    _s11, mr11, read11 = container_levels(os.path.join(work,
                                                       "nonrigid.ome.zarr"))
    check(len(mr) == len(mr11) > 1, f"14b and phase 11: {len(mr)} levels")
    for lvl in range(len(mr)):
        a, b = read(lvl), read11(lvl)
        check(a.shape == b.shape and np.array_equal(a, b) and a.std() > 0,
              f"14b level {lvl} {a.shape} bitwise phase 11's")


def phase14c(work, scale, dev, card, launches):
    """14c: downsample_pyramid_level(devices=4) on route D's s0 into
    datasets of their own: every level bitwise route D's."""
    import dataclasses

    import numpy as np

    from bigstitcher_spark_tpu_torch.models.downsample_driver import (
        downsample_pyramid_level)

    store, mr, read = container_levels(os.path.join(work, "route_d.n5"))
    prev = mr[0]
    for lvl in range(1, len(mr)):
        m = mr[lvl]
        dst = dataclasses.replace(m, dataset=f"sharded14/s{lvl}")
        store.create_dataset(dst.dataset, m.dimensions[:3], m.blockSize[:3],
                             m.dataType.lower(), compression="raw")
        st = {}
        reset_peak(dev)
        t0 = time.perf_counter()
        counted("14c", launches, dev, lambda: downsample_pyramid_level(
            store, prev, dst, False, device=dev, devices=4, stats=st),
            exclusive=True)
        wall = time.perf_counter() - t0
        t = st["timings"]
        vox = int(np.prod(m.dimensions[:3]))
        print(f"  [14c level {lvl}] {card}: mesh {len(st['mesh'])} device(s) "
              f"{st['mesh']} for devices=4; " + "; ".join(
                  f"source {b['shape']}: {b['blocks']} blocks, per_dev "
                  f"{b['per_dev']}, {b['batches']} batches"
                  for b in st["buckets"])
              + f"; {st['batches']} batches; wall {wall:.3f}s -> "
              f"{vox / wall:,.0f} level voxels/s; read {t['read']:.3f}s h2d "
              f"{t['h2d']:.3f}s kernel {t['kernel']:.4f}s d2h "
              f"{t['d2h']:.3f}s write {t['write']:.3f}s; device memory peak "
              f"{peak_text(dev)}", flush=True)
        a = store.open_dataset(dst.dataset).read_full()
        b = read(lvl)
        check(a.shape == b.shape and np.array_equal(a, b) and a.std() > 0,
              f"14c level {lvl} {a.shape} bitwise route D's")
        prev = dst


def phase14_shard_routes(work, scale, dev, card, launches, proj_a, det_one):
    """Phase 14: the shard_jit routes at devices=4 on the one card (a
    one-device mesh): 14a detection, 14b nonrigid fusion, 14c the
    downsample stage, each bitwise its one-device route."""
    print("phase 14 (shard_jit routes: detection, nonrigid fusion, "
          "downsample stage at devices=4)", flush=True)
    t0 = time.perf_counter()
    phase14a(proj_a, scale, dev, card, launches, det_one)
    phase14b(work, proj_a, scale, dev, card, launches)
    phase14c(work, scale, dev, card, launches)
    print(f"  phase 14 wall {time.perf_counter() - t0:.1f}s", flush=True)


# ---------------------------------------------------------------- phase 15


SOLVE_SHARDS = 4  # phase 15's solve mesh: the one card, four times


@contextlib.contextmanager
def knobs(env):
    """``BST_*`` knobs set for the block, as they were afterwards."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def shard_sum_times(parts, rep, v, what, card):
    """K29 alone on ``parts`` (+ ``rep``; the dot with ``v``) against
    shard_sum_plain: the sum bitwise, the dot within rtol 1e-12; card
    time, the twin's, the bound (each input read once, the output written
    once) and torch.stack(...).sum(0) (+ torch.dot) as the library call."""
    import torch

    from bigstitcher_spark_tpu_torch.ops import shard as K

    dev, n = parts[0].device, parts[0].numel()
    f64 = dict(dtype=torch.float64, device=dev)
    out, ref = torch.empty(parts[0].shape, **f64), torch.empty(
        parts[0].shape, **f64)
    dot, dref = ((torch.zeros(1, **f64), torch.zeros(1, **f64))
                 if v is not None else (None, None))
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    run = lambda: K.shard_sum(parts, out, rep=rep, v=v, dot=dot,
                              ticket=ticket)
    plain = lambda: K.shard_sum_plain(parts, ref, rep=rep, v=v, dot=dref)
    run()
    plain()
    check(torch.equal(out, ref), f"K29 at {what}: the sum bitwise its twin's")
    err = max_abs(out, ref)
    if v is not None:
        derr = abs(float(dot[0]) - float(dref[0]))
        check(derr <= 1e-12 * abs(float(dref[0])),
              f"K29 at {what}: p.Ap within rtol 1e-12 of the twin's "
              f"torch.dot (|delta| {derr:.3g})")
        err = max(err, derr)
    terms = list(parts) + ([rep] if rep is not None else [])
    if v is not None:
        lib = lambda: torch.dot(torch.stack(terms).sum(0), v)
    else:
        lib = lambda: torch.stack(terms).sum(0)
    n_in = len(terms) + (v is not None)
    r = dict(err=err, ms=time_ms(run), wrapper_ms=time_ms(run, host=True),
             plain_ms=time_ms(plain, reps=5), library_ms=time_ms(lib),
             bound=bound(n_in * n * 8 + n * 8,
                         (len(terms) - 1) * n + (2 * n if v is not None
                                                 else 0), F64_OPS_PER_S))
    print_times(f"shard_sum at {what}", r, card)
    return r


def phase15a(scale, dev, card, launches, solve7c):
    """15a: 7c's links relaxed again, AFFINE + RIGID, on one device and on
    the mesh [dev] * 4 (above the default BST_SOLVE_SHARD at full width):
    the sharded relax bitwise the one-device one; then one sweep of each
    timed alone and K29 at the moments' shape. Returns K29's result."""
    import dataclasses

    import numpy as np

    from bigstitcher_spark_tpu_torch import config
    from bigstitcher_spark_tpu_torch.models import solver as S
    from bigstitcher_spark_tpu_torch.ops import solve as R

    tiles, links, params = solve7c
    n_rows = 2 * sum(len(lk.p) for lk in links)
    thr = config.KNOBS["BST_SOLVE_SHARD"][1]
    check(scale == "tiny" or n_rows >= thr,
          f"15a: {n_rows} rows " + (
              f">= the default BST_SOLVE_SHARD {thr}" if n_rows >= thr
              else "(tiny: BST_SOLVE_SHARD=1 for 15a)"))
    fixed = S.pick_fixed(tiles, params)
    runs = {}
    with knobs({} if n_rows >= thr else {"BST_SOLVE_SHARD": "1"}):
        for route, devices in (("15a one device", None),
                               ("15a", [dev] * SOLVE_SHARDS)):
            p = dataclasses.replace(params, devices=devices)
            calls, undo = relax_spy()
            try:
                before = dict(launches)
                t0 = time.perf_counter()
                res = counted(route, launches, dev,
                              lambda: S.relax(links, tiles, fixed, p),
                              exclusive=True)
                wall = time.perf_counter() - t0
            finally:
                undo()
            (args, _k, out), = calls
            got = {k: launches.get(k, 0) - before.get(k, 0)
                   for k in launches}
            runs[route] = (args, out, res, wall, got)
    (a1, o1, r1, w1, _), (a4, o4, r4, w4, got) = runs.values()
    pr = a4[0]
    check(isinstance(pr, R.ShardedRelaxProblem) and pr.n_shards ==
          SOLVE_SHARDS and r4.shards == SOLVE_SHARDS,
          f"15a: the relax sharded over {SOLVE_SHARDS} shards "
          f"({[sh.n_rows for sh in getattr(pr, 'shards', [])]} rows)")
    check(o4.iterations == o1.iterations
          and np.array_equal(o4.history, o1.history)
          and np.array_equal(o4.models, o1.models)
          and np.array_equal(o4.link_errors, o1.link_errors),
          f"15a: {o4.iterations} sweeps, history, models and link errors "
          "bitwise the one-device relax's")
    sweeps = got.get("relax_fit", 0)
    one = runs["15a one device"][4]
    k29 = got.get("shard_sum", 0)
    print(f"  [solver 15a] {card}: {pr.n_tiles} tiles, {pr.n_rows} rows, "
          f"{o4.iterations} iterations ({sweeps} sweeps launched); launches "
          f"K11 {got.get('relax_moments', 0)} ({got.get('relax_moments', 0) / SOLVE_SHARDS:g} a shard), "
          f"K13 {got.get('relax_error', 0)} ({got.get('relax_error', 0) / SOLVE_SHARDS:g} a shard), "
          f"K29 {k29} ({(k29 - 2) / max(sweeps, 1):g} a sweep past the "
          f"origins and link errors), K12 {sweeps}, K14 "
          f"{got.get('relax_converge', 0)}; one device: K11 "
          f"{one.get('relax_moments', 0)}, K12 {one.get('relax_fit', 0)}, "
          f"K13 + K14 {one.get('relax_error_converge', 0)}, K13 "
          f"{one.get('relax_error', 0)}, K14 {one.get('relax_converge', 0)}, "
          f"K29 {one.get('shard_sum', 0)}; wall sharded {w4:.3f}s (relax "
          f"loop {o4.seconds:.3f}s, card {o4.card_seconds:.4f}s) / one "
          f"device {w1:.3f}s (loop {o1.seconds:.3f}s, card "
          f"{o1.card_seconds:.4f}s)", flush=True)
    if dev.type == "cuda":
        check(k29 == 2 and got.get("relax_converge", 0) == sweeps
              and one.get("relax_converge", 0) == 0
              and one.get("shard_sum", 0) == 0,
              f"15a: K29 {k29} launches (the origins and the link errors, "
              f"none a sweep), K14 {got.get('relax_converge', 0)} sharded "
              f"(one a sweep) and {one.get('relax_converge', 0)} on one "
              "device")
    # one sweep alone, each problem (no state reads; the cap out of reach)
    sweep_ms = {}
    for name, a in (("one device", a1), ("sharded", a4)):
        a = list(a)
        a[7] = 10 ** 6
        run = R.RelaxRun(R.KERNELS, *a)
        sweep_ms[name] = time_ms(run.sweep)
        if dev.type == "cuda":
            check(not run.first.state.tolist()[2],
                  f"15a {name}: still iterating after the timed sweeps")
    print(f"  [solver 15a] {card}: card time a sweep sharded "
          f"{sweep_ms['sharded']} ms, one device {sweep_ms['one device']} "
          "ms (launches queued behind a spin)", flush=True)
    res = shard_sum_times(run.mom_out, None, None,
                          f"15a's moments ({SOLVE_SHARDS} x {pr.n_tiles} x "
                          f"{R.N_MOMENTS})", card)
    res["sweep_ms"] = sweep_ms
    forms = sharded_form_times(run, card)
    for name, launched in (("relax_fit", sweeps),
                           ("relax_converge", got.get("relax_converge", 0))):
        forms[name]["launches"] = launched
    return res, forms


def sharded_form_times(run, card):
    """K12's and K14's sharded forms on a sharded RelaxRun's partials (its
    last sweep's moments and error sums): bitwise K29 then K12 and K29 then
    K14, the state equal to the twins'; card time of each form beside the
    pair (``pair_ms``, K29 and the kernel back to back) and the twin.
    Returns {wrapper name: result}."""
    import torch

    from bigstitcher_spark_tpu_torch.ops import shard as K
    from bigstitcher_spark_tpu_torch.ops import solve as R

    run.sweep()  # the partials of one more sweep
    rp, T, S = run.first, run.T, len(run.shards)
    model, reg, lam, damping, pw, max_error, _mi = run.args
    dev = rp.cur.device
    f64 = dict(dtype=torch.float64, device=dev)
    parts, nd_parts = run.mom_out, run.nd_out
    num, den = run.num_out, run.den_out
    mom, nd = torch.empty((T, R.N_MOMENTS), **f64), torch.empty((2, T), **f64)
    fit = lambda m, c: R.relax_fit(m, rp.fixed, rp.origin, model, reg, lam,
                                   damping, None, c)
    got = fit(parts, rp.cur.clone())
    K.shard_sum(parts, mom)
    ref = fit(mom, rp.cur.clone())
    check(torch.equal(got, ref), f"15a K12 sharded form ({S} partials): "
                                 "models bitwise K29 then K12")
    twin = R.relax_fit_plain(parts, rp.fixed, rp.origin, model, reg, lam,
                             damping, None, rp.cur.clone())
    scale = R.fit_scale(twin, rp.origin)
    err_fit = float((got - twin).abs().max())
    check(bool(((got - twin).abs() <= 1e-12 + 1e-10 * scale).all()),
          f"15a K12 sharded form: within rtol 1e-10 (of fit_scale) / atol "
          f"1e-12 of its twin (max|delta| {err_fit:.3g})")
    scratch = rp.cur.clone()
    fit_ops = (OPS["fit"][model] + OPS["fit"].get(reg, 0) + OPS["fit_blend"])
    res = {"relax_fit": dict(
        err=err_fit, ms=time_ms(lambda: fit(parts, scratch)),
        pair_ms=time_ms(lambda: (K.shard_sum(parts, mom), fit(mom, scratch))),
        plain_ms=time_ms(lambda: R.relax_fit_plain(
            parts, rp.fixed, rp.origin, model, reg, lam, damping, None,
            scratch.clone()), reps=5),
        bound=bound(S * T * 288 + T * (24 + 2 * 96 + 1),
                    T * fit_ops + (S - 1) * T * R.N_MOMENTS, F64_OPS_PER_S))}
    cap = max(pw + 2, 64)
    sides = []
    start = float(rp.hist[0]) if int(rp.state[0]) else 1.0
    for form in ("sharded", "pair", "twin"):
        hist = torch.zeros(cap, **f64)
        hist[:50] = start + 1.0
        st = torch.tensor([50, 0, 0, 0], dtype=torch.int32, device=dev)
        if form == "sharded":
            R.relax_converge(num, den, hist, st, pw, max_error, cap)
        elif form == "pair":
            K.shard_sum(nd_parts, nd)
            R.relax_converge(nd[0], nd[1], hist, st, pw, max_error, cap)
        else:
            R.relax_converge_plain(num, den, hist, st, pw, max_error, cap)
        sides.append((hist, st))
    (h, st), (h2, st2), (h3, st3) = sides
    check(torch.equal(h, h2) and torch.equal(st, st2),
          f"15a K14 sharded form ({S} partials): history and state "
          f"{st.tolist()} bitwise K29 then K14")
    err_c = float((h - h3).abs().max())
    check(torch.equal(st, st3) and err_c <= 1e-10 * float(h3.abs().max()),
          f"15a K14 sharded form: state equal to its twin's, the error "
          f"within rtol 1e-10 ({err_c:.3g})")
    st = torch.zeros(4, dtype=torch.int32, device=dev)
    reset = time_ms(st.zero_)
    sub = lambda ms: None if ms is None or reset is None else ms - reset
    res["relax_converge"] = dict(
        err=err_c, ms=sub(time_ms(lambda: (st.zero_(), R.relax_converge(
            num, den, h, st, pw, max_error, cap)))),
        pair_ms=sub(time_ms(lambda: (st.zero_(), K.shard_sum(nd_parts, nd),
                                     R.relax_converge(nd[0], nd[1], h, st, pw,
                                                      max_error, cap)))),
        plain_ms=time_each(lambda: R.relax_converge_plain(
            num, den, h, st, pw, max_error, cap), lambda: st.zero_(),
            reps=10, host=True),
        bound=bound(S * T * 16 + pw * 8, S * T * OPS["relax_converge"],
                    F64_OPS_PER_S))
    for name, r in res.items():
        r["wrapper_ms"] = r["ms"]
        print_times(f"{name} sharded form at 15a ({S} partials)", r, card)
    return res


def cg_partial_times(sysm, card):
    """K24's partial form alone on shard 0 of ``sysm`` (no p_new store, as
    the loop launches it on a shard) against its twin: Ap within rtol
    1e-12; card time, twin, bound (the lists, r and p_old read, Ap
    written)."""
    import torch

    from bigstitcher_spark_tpu_torch.ops import solve as R

    sh = sysm.shards[0]
    dev, n, nnz = sh.device, sh.n, int(sh.vals.numel())
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    f64 = dict(dtype=torch.float64, device=dev)
    r, p_old = (torch.randn(n, generator=g, **f64) for _ in range(2))
    d, i = R.cg_state(sh, dev)
    d[1] = 0.5
    ap, ref = torch.empty(n, **f64), torch.empty(n, **f64)
    run = lambda: R.cg_spmv_partial(sh, r, p_old, None, ap, d, i)
    run()
    R.cg_spmv_partial_plain(sh, r, p_old, None, ref, d, i)
    err = max_abs(ap, ref)
    check(err <= 1e-12 * float(ref.abs().max()),
          f"K24's partial form at 15b's shard ({n} rows, {nnz} terms): Ap "
          f"within rtol 1e-12 of its twin's ({err:.3g})")
    r_ = dict(err=err, ms=time_ms(run), wrapper_ms=time_ms(run, host=True),
              plain_ms=time_ms(lambda: R.cg_spmv_partial_plain(
                  sh, r, p_old, None, ref, d, i), reps=5), library_ms=None,
              bound=bound(nnz * 12 + (n + 1) * 4 + n * 24, nnz * 4 + n * 2,
                          F64_OPS_PER_S))
    print_times(f"cg_spmv_partial at 15b's shard ({nnz} terms)", r_, card)
    return r_


def phase15b(scale, dev, card, launches):
    """15b: 10b's large system with BST_SOLVE_SHARD=1: on the default mesh
    (one card: one device) and on [dev] * 4 (sharded): within rtol / atol
    1e-8 of each other, the sharded run against its twin loop and its
    residual; K24's partial form and K29 at its shapes. Returns their
    results."""
    import numpy as np
    import torch

    from bigstitcher_spark_tpu_torch.ops import intensity as OI
    from bigstitcher_spark_tpu_torch.ops import solve as R

    C, rows, smooth = large_intensity_system(SCALES[scale]["ip_grid"])
    mesh = [dev] * SOLVE_SHARDS
    sols, outs = {}, {}
    calls, undo = cg_spy()
    try:
        with knobs({"BST_SOLVE_SHARD": "1"}):
            for route, devices in (("15b one device", None), ("15b", mesh)):
                t0 = time.perf_counter()
                sols[route] = counted(
                    route, launches, dev, lambda: OI.solve_intensity_coefficients(
                        C, rows, 0.1, smooth_pairs=smooth, backend="device",
                        device=dev, devices=devices), exclusive=True)
                outs[route] = (calls[-1], time.perf_counter() - t0)
    finally:
        undo()
    (args, out, cg_s), wall = outs["15b"]
    cg_report("15b", card, f"{C} cells, {SOLVE_SHARDS} shards", wall, out,
              cg_s)
    (_a1, out1, cg1), wall1 = outs["15b one device"]
    cg_report("15b one device", card, f"{C} cells", wall1, out1, cg1)
    err = float(np.abs(sols["15b"] - sols["15b one device"]).max())
    check(np.allclose(sols["15b"], sols["15b one device"], rtol=1e-8,
                      atol=1e-8),
          f"15b: the sharded CG within rtol / atol 1e-8 of the one-device "
          f"CG (max|delta| {err:.3g})")
    sysm, _err = check_cg("15b", args, out.x, out.iterations, dev,
                          n_shards=SOLVE_SHARDS, mesh=mesh)
    if dev.type != "cuda":
        return {}
    part = cg_partial_times(sysm, card)
    # K29 at the CG's shape: the shards' Ap of a direction, the replicated
    # part's, p.Ap
    g = torch.Generator(device=dev)
    g.manual_seed(8)
    f64 = dict(dtype=torch.float64, device=dev)
    r, p_old = (torch.randn(sysm.n, generator=g, **f64) for _ in range(2))
    d, i = R.cg_state(sysm.reps[0], dev)
    d[1] = 0.5
    p_new, ap_rep = torch.empty(sysm.n, **f64), torch.empty(sysm.n, **f64)
    R.cg_spmv_partial(sysm.reps[0], r, p_old, p_new, ap_rep, d, i)
    parts = [torch.empty(sysm.n, **f64) for _ in sysm.shards]
    for sh, ap in zip(sysm.shards, parts):
        R.cg_spmv_partial(sh, r, p_old, None, ap, d, i)
    k29 = shard_sum_times(parts, ap_rep, p_new,
                          f"15b's vectors ({SOLVE_SHARDS} x {sysm.n}, the "
                          "replicated part, p.Ap)", card)
    return {"cg_spmv_partial": part, "shard_sum_15b": k29}


def prefixed(prefix, r):
    """A kernel result's numbers as fields of another kernel's entry:
    err -> max_abs_err, bound -> bound_ms and bound_by."""
    out = {f"{prefix}{k}": v for k, v in r.items()
           if k not in ("err", "bound")}
    out[f"{prefix}max_abs_err"] = r["err"]
    out[f"{prefix}bound_ms"], out[f"{prefix}bound_by"] = r["bound"]
    return out


def phase15_sharded_solves(scale, dev, card, launches, solve7c):
    """Phase 15: the sharded global solves on the mesh [dev] * 4."""
    t0 = time.perf_counter()
    print("phase 15 (sharded solves, devices=[card] * 4)", flush=True)
    k29, forms = phase15a(scale, dev, card, launches, solve7c)
    res = phase15b(scale, dev, card, launches)
    if res:
        k29.update(prefixed("at_15b_", res["shard_sum_15b"]))
        res = prefixed("partial_", res["cg_spmv_partial"])
    print(f"  phase 15 wall {time.perf_counter() - t0:.1f}s", flush=True)
    return {"shard_sum": k29}, res, forms


def main_path(work, scale, dev, card, launches):
    """Phases 2-15 through the CLI entry functions (8d, 12, 14a, 14c and
    15 through the API); returns route A's XML and container paths and
    phases 7-12's and 15's kernel results. Prints each phase's wall."""
    walls, t = {}, [time.perf_counter()]

    def lap(phase, out=None):
        now = time.perf_counter()
        walls[phase] = round(now - t[0], 1)
        t[0] = now
        return out

    a = lap("2", route_a(work, scale, dev, card, launches))
    out_b = lap("3", route_b(work, scale, dev, card, launches, a))
    proj_c = lap("4", route_c(work, scale, dev, card, launches))
    lap("5", route_d(work, scale, dev, card, launches, a))
    lap("6", phase6_stitching(a[0], proj_c, dev, card, launches))
    relax, solve7c = lap("7", phase7_solver(work, scale, a[0], dev, card,
                                            launches))
    det, det_b, gate8d, det_one = lap("8", phase8_detection(
        a[0], scale, dev, card, launches))
    match = lap("9", phase9_matching(work, a[0], det_b, scale, dev, card,
                                     launches, gate8d))
    inten, proj10 = lap("10", phase10_intensity(work, scale, dev, card,
                                                launches))
    nonrigid = lap("11", phase11_nonrigid(work, a[0], scale, dev, card,
                                          launches))
    scan = lap("12", phase12_scan(scale, dev, card, launches, a, out_b))
    lap("13", phase13_sharded(work, scale, dev, card, launches, a[0], out_b,
                              proj_c, proj10))
    lap("14", phase14_shard_routes(work, scale, dev, card, launches, a[0],
                                   det_one))
    k29, partial, forms = lap("15", phase15_sharded_solves(
        scale, dev, card, launches, solve7c))
    if "cg_spmv" in inten:
        inten["cg_spmv"].update(partial)
    # K12's and K14's sharded forms (15a) as fields of their kernels' entries
    for name, r in forms.items():
        if name in relax:
            relax[name].update(prefixed("sharded_", r))
    print(f"phase walls (s): {walls}", flush=True)
    return a[0].xml_path, a[1], {**relax, **det, **match, **inten,
                                 **nonrigid, **scan, **k29}


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
    t_start = time.time()
    try:
        if args.device == "cpu":
            torch.set_num_threads(1)
            cpu = torch.device("cpu")
            print("rehearsal on the CPU: plain twins, no kernels", flush=True)
            phase1_kernels(cpu, args.scale, "cpu")
            composite_at_route_a(*main_path(work, args.scale, cpu, "cpu",
                                            launches)[:2], cpu)
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
        t0 = time.time()
        res = phase1_kernels(dev, args.scale, card)
        print(f"  phase 1 wall {time.time() - t0:.1f}s", flush=True)

        *route, later = main_path(work, args.scale, dev, card, launches)
        coeff = later.pop("coeff")
        masked = later.pop("knn_descriptors_masked")
        res.update(later)
        print(f"main path launches (routes A-D, stitching, solver, "
              f"detection, matching, intensity, nonrigid, scan, sharded, "
              f"shard_jit routes, sharded solves): "
              f"{launches}", flush=True)
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
            **({"plain_shape": r["plain_shape"]} if "plain_shape" in r
               else {}),
            # K1: its launches a composite and one call's device memory peak
            **{k: r[k] for k in ("launches_per_call", "peak_bytes")
               if k in r},
            # K8's six passes (phase 1); K24's and torch.mv's back-to-back
            # times beside the one-launch ones (10b); the library call's
            # time with the host's (K8, K24)
            **{k: r[k] for k in ("passes_ms", "b2b_ms", "library_b2b_ms",
                                 "library_int64_b2b_ms",
                                 "library_wrapper_ms") if k in r},
            # K20 (9b): the pairs its filter refined, B's mean alone, the
            # bound of the exact SIMT work alone; K19 (9b): its floor at
            # one operation an instruction beside its operations bound
            **{k: r[k] for k in ("refined", "refined_share", "center_ms",
                                 "simt_bound_ms", "issue_floor_ms")
               if k in r},
            **({"block_ms": r["block_ms"],
                "block_wrapper_ms": r["block_wrapper_ms"],
                "block_plain_ms": r["block_plain_ms"],
                "block_bound_ms": r["block_bound"][0],
                "block_max_abs_err": r["block_err"]}
               if "block_ms" in r else {}),
            # K3's and K26's launch form, K3's time by fusion type; K26's
            # batch form's rows and the per-block time beside it (phase 1)
            **{k: r[k] for k in ("form", "ft_ms", "rows", "per_block_ms")
               if k in r},
            # K6's one-axis form and its batch form at route D's boxes
            # (phase 1), K21 at 9a's shape beside 9b's, K19's masked form
            # (8d)
            **{k: v for k, v in r.items()
               if k.startswith(("halfpixel_", "route_d_", "at_9a_",
                                "at_15b_", "partial_", "sharded_",
                                "pair_", "n256_", "truncated_",
                                "library_list_"))},
            # K10 at each bucket phase 6 sent it
            **({"at_6": PHASE6_PEAKS} if name == "pcm_peaks_topk" else {}),
            # K24's partial form (phase 15b): its launches; K29: one
            # sweep of 15a alone, sharded and on one device
            **({"partial_launches": launches["cg_spmv_partial"]}
               if name == "cg_spmv" else {}),
            **({"sweep_ms": r["sweep_ms"]} if "sweep_ms" in r else {}),
            # K22: the mask alone (fit=False) at 9b; launches by shape
            **({**{k: v for k, v in r.items() if k.startswith("nofit_")},
                "launches_9b": ROUTE_LAUNCHES.get("9b", {}).get(name, 0),
                "launches_small_pairs": launches[name] - ROUTE_LAUNCHES.get(
                    "9b", {}).get(name, 0)}
               if name == "ransac_refit" else {}),
            **({"masked_launches": masked["launches"],
                "masked_ms": masked["ms"],
                "masked_plain_ms": masked["plain_ms"],
                "masked_bound_ms": masked["bound"][0],
                "masked_issue_floor_ms": masked["issue_floor_ms"],
                "masked_max_abs_err": masked["err"]}
               if name == "knn_descriptors" else {}),
            # K2's, K3's and K5's batch forms (phase 1 at BATCH_ROWS rows;
            # launches from phase 13)
            **({"batch_launches": launches[BATCH_FORMS[name]],
                **{k: v for k, v in r.items() if k.startswith("batch_")}}
               if name in BATCH_FORMS else {}),
            **({"batch_coeff_launches": launches["fuse_block_batch+coeff"]}
               if name == "fuse_block" else {}),
            **({"shape": r["shape"], "levels": r["levels"]}
               if name == "block_epilogue" else {}),
            **({"coeff_launches": launches[f"{name}+coeff"],
                "coeff_ms": coeff[name]["coeff_ms"],
                "coeff_plain_ms": coeff[name]["coeff_plain_ms"],
                "coeff_bound_ms": coeff[name]["coeff_bound"][0],
                "coeff_issue_floor_ms": coeff[name]["coeff_issue_floor_ms"],
                "coeff_max_abs_err": coeff[name]["coeff_err"]}
               if name in coeff else {}),
        })
    print(f"total {time.time() - t_start:.1f}s (builds included)")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
