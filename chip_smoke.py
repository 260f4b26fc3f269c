#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gaus_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Everything is driven from configs/synthetic/config.py at the bench shape
340x600 (836 tiles of 16x16, frontend capacity 393216, pair factor 1.35,
r_max 530944). Phases (any failure exits non-zero and prints no result
line):

1. Build the CUDA kernels from gaus_slam_tpu_torch/csrc (one nvcc per
   source, all at once) and read the card's name and power limit.
2. Each kernel against its plain PyTorch version on the card, at the
   frontend's shapes (a random map from a numpy seed): K1/K3 on out,
   stash and kexit, K2 and K5 on d_attrs against torch.autograd through
   the plain versions (and SA's depth rows against float64), K2 launched
   twice and bit-equal to itself, K3's out bit-equal to K1's, K5's
   re-forward stash bit-equal to K1's stash and its gradient to K2's, K4
   (the row-layout gather the reduction calls) bit for bit against its
   plain version and torch.index_select, also on a binning whose pair
   budget is cut below demand (it overflows: called eagerly, as here, the
   reduction runs its run path too, K4 included, and torch.where drops
   it; inside a captured step an IF node runs the slab path alone, 13d),
   where the selected reduction must be the slab one bit for bit (the run
   one without overflow). Prints errors, tolerances, ms per call (CUDA events
   after warm-up; K4, a short kernel, inside a CUDA graph) and K2's and
   K4's registers, spills and shared memory.
3. The port's Frontend (backend "pallas": K1-K4) over 24 frames, submaps
   of 10 frames, so at least two submap cuts, then process_final; the
   backend queue is drained after every frame. Per frame: iterations,
   loss, keyframe or cut, n_active, wall ms and t_err, the camera
   centre's error relative to the submap's first frame against the same
   relative ground truth. Each tracked frame must end below half the
   error of its constant-velocity init, or within T_ERR_ABS (2x the JAX
   system's ATE where that init is already near it); a tracker that never
   moves its pose must fail that check. Every LocalMap must hold finite
   frozen poses, a descriptor and its kept frames. K1-K4 must launch. The
   iterations and losses per frame must equal PARENT_PHASE3 (the code
   before the step path's host waits were taken out, on this card).
3b. The same Frontend under backend "reference" (the plain compositor,
   K5 as its backward, the plain gather) with tpu.coarse_map_stride 1,
   6 frames; K5 must launch and K1-K4 must not. This backend tracks at
   full resolution only, so a control run drives the stash kernels
   through that same schedule: a reference frame passes the tracking
   check, or fails it only where the control fails it too, ending within
   ATE_JAX of the control's error.
   Launches are counted per phase: zeroed just before, read just after.
4. torch.profiler over a tracking and a mapping iteration on phase 3's
   final map: wall, device busy, idle share, and the host's ms in the
   CUDA calls that wait for the card (stream synchronizes, synchronous
   copies: a step's host waits).
4b. No host wait inside a step (tools/sync_audit.py): tracking_loop
   with the config's converged_th, a frontend mapping_step, a
   Backend.process() running a fused x4 mapping batch and a captured
   sharded_ba_step over four slots of the card, at 340x600, each under
   torch.cuda.set_sync_debug_mode("error"); any flagged call fails. The
   tracking loop is one loop program: its host waits must be 0.
5. The port's driver (scripts/gaus.py::rgbd_slam, backend "pallas") at
   the test scale, 48x64 over 12 frames: it must write the result,
   timing and scene artifacts and clear the bounds
   tests/test_full_slam.py:37-40 holds the JAX system to, or fail them
   only through a keyframe test within KF_MARGIN of its threshold whose
   reversal (a control run) clears them.
6. The driver at the bench shape, 340x600 over the config's 30 frames:
   cuts at frames 10 and 20 and process_final, so three merges, two of
   them through the covisibility / prune / tracking branch, then
   eval_final. Launches are also counted inside every process_localmap
   and inside eval_final (zeroed just before each, read just after):
   K1, K2 and K4 must launch in the backend, K3 in eval_final. ATE-RMSE
   must end below T_ERR_ABS, and PSNR over the first submap's frames
   above PSNR_MIN (the later merges' donors are culled by the prune task,
   in the JAX package as in the port: PERF.md, section 6). Prints frames per
   second of the frame loop (backend drains included), ms per backend
   task by kind (a device sync after each), merges, capacity-bucket
   flips, ms per eval_final frame and the peak device memory. ATE and
   first-submap PSNR must print as PARENT_DRIVER's (the earlier code's).
   Launches are counted inside each Frontend.tracking too (the loop
   programs' device tallies folded in just before and just after): K1
   and K2 must launch there exactly once per iteration that ran, the
   frames' summed device iteration counts (no iteration queued past a
   stop).
7. K6, the bf16 probe: its entry point (python -m
   gaus_slam_tpu_torch.tools.bf16_probe) once, then each of its six
   (chain, dtype) cases against the plain version at the probe's
   [4096, 512] shape, and its time (50 launches in a CUDA graph), rate,
   bound and bf16/f32 ratio per chain.
8. From disk: the synthetic scene's first 12 frames (seed 0, the driver's
   trajectory) written at 340x600 as a ReplicaV2 tree (rgb/depth PNG
   through utils/png.py, depth in millimetres, traj_w_c.txt) with a
   camera profile that utils/yaml_lite.py must read back; every frame
   must read back bit-equal through the loader and through the PNG
   reader. The driver runs from that tree with backend.save_ckpt,
   eval.eval_mesh and $LPIPS_WEIGHTS on a random-weights .npz (numpy
   seed), then again, resumed from the checkpoint at the first cut
   (frame 10). Each run must clear phase 6's ATE and first-submap PSNR
   bounds, score the mesh with an F-score in (0, 1] (eval_final prints
   and leaves the keys out when the mesh evaluation fails), give a
   finite LPIPS, launch K1-K4, and launch K3 inside fuse_render_mesh.
   Then scripts/eval.py on the saved scene must reproduce result.json's
   PSNR to 1e-4, and scripts/vis_final.py must write 4 views and a mesh.
   Prints ms per loaded frame, checkpoint write and restore ms, fusion ms
   per view, TSDF extract ms, LPIPS ms per frame and the F-score,
   precision and recall beside the card's name and power limit.
9. The 3DGS render method, the SplaTAM baseline and gs_densify.
   9a. K1, K3, K2 and K4 on 3DGS pair attributes (phase 2's random map
   through preprocess_3dgs, anisotropic and isotropic, all tiles and the
   coarse tracking subset) in their SA-off instantiation: K1's out, stash
   and kexit within 1e-4 of each channel's scale, K3 bit-equal to K1, K2
   within 1e-5 worst-row relative L2 of torch.autograd through the plain
   version, K4 in the 3DGS mapping reduction bit-equal to the plain
   landing; no (pair, pixel) that pair_culled rejects may pass the alpha
   test. K1 / K2 / K3 ms per call beside phase 2's SA times, with bounds
   recounted without SA's per-pair work.
   9b. The 3DGS ablation (render.method 3dgs, isotropic gaussians, what
   EXP=1 sets) through the driver: at 48x64 x 12 against the JAX
   package's CPU numbers in that configuration (SMALL_BOUNDS_3DGS, with
   phase 5's borderline-keyframe control), then at 340x600 x 30 as phase
   6 (three merges, eval_final) against phase 6's bounds.
   K1-K4 must launch and K5 must not.
   9c. scripts/splatam.py with configs/replica/splatam.py on phase 8's
   ReplicaV2 tree (340x600 x 12): time.json, result.json and
   scene/gaussians.ply written, the map capacity grown at least once,
   finite ATE < T_ERR_ABS and PSNR > 15 dB (tests/test_splatam.py), K1-K4
   launched; prints tracking and mapping ms from time.json.
   9d. The driver on phase 8's tree with backend.gs_densify: clone /
   split / prune counts per densify_and_prune call, which must run at
   least once and never outgrow the capacity; phase 8's ATE and
   first-submap PSNR bounds.
10. The backend on a CUDA stream of its own, the sharded BA and the
   pipelined driver.
   10a. Phase 3's LocalMaps (deep copies) through a fresh Backend in one
   fixed call sequence (a merge, then 4 process() calls a turn until the
   queue is empty, random_process off) while a Frontend tracks the
   synthetic frames on the default stream between the turns: twice with
   tpu.backend_device "off", once with "auto" (a stream of its own on
   this one card). The "auto" run's final map, Adam moments and submap
   transforms must equal the first "off" run's to the bit wherever the
   two "off" runs agree to the bit, and elsewhere lie within twice their
   difference; every K1/K2/K4 launch inside the backend must run on its
   stream and every frontend launch on the default stream. The same
   holds under allocator pressure (each merge's backend work starts with
   a spin, and the default stream at once fills fresh tensors of the
   donor snapshot's sizes); the control without Backend._adopt's
   record_stream must differ there, as the control without the wait
   must; and gaus_mp's feeder handoff (_receive) under the same pressure
   reads its frame, its control without record_stream the next one. The
   "off" map's digest must equal PARENT_10A_DIGEST when set. The
   milliseconds in which the two streams' kernels overlapped are read
   from profiler traces (the backend's stream carries mark kernels) of
   two turns as scheduled and of two turns with a BACKLOG_CYCLES spin
   queued on the caller's stream (which the backend's waits for) before
   their backend tasks, with the host's kernel launches that blocked on
   a full launch queue; printed, not required (PERF.md, section 6). The
   replays of the captured steps (phase 13) inside the backend must run
   on its stream too.
   (python3 chip_smoke.py --streams-of <root> prints both windows for
   the port of another tree, unchecked.)
   10b. parallel.sharded_ba_step over four slots of cuda:0 at 340x600 on
   phase 2's random map with the synthetic scene's frames 0-3 against the
   sequential mean-gradient step (loss within 1e-5 relative, parameters
   bit-equal or within 1e-6 of each field's scale), also with weights
   [1, 1, 1, 0] against the 3-keyframe step; ms per captured sharded
   step (a shard program per slot and the reduction's, with owners of
   their own, the map stepped in place) beside 4 sequential captured
   mapping steps, and one step under torch.profiler: at most 5 graph
   launches and SHARDED_OUTSIDE_LIMIT kernels, copies and fills outside
   a graph; then a Backend whose BA group is those four slots through
   two merges: sharded steps ran, the map is finite, K1, K2 and K4
   launched.
   10c. scripts/gaus_mp.py at 340x600 over the config's 30 frames with
   the backend on the frontend's stream and on its own: three merges,
   phase 6's ATE and first-submap PSNR bounds, K1-K4 launched (K3 inside
   eval_final) and K5 not; frames per second of the loop beside phase 6's,
   backend tasks drained beside the frames and after the last one, peak
   device memory. Then on phase 8's tree with backend.save_ckpt, and
   resumed from the checkpoint of the first cut (frame 11): the same
   bounds and launches.
11. The bf16 compute dtype (tpu.compute_dtype "bf16") and the last
   scripts.
   11a. K1, K3 and K2 in bf16 on phase 2's random map, SA on with 2DGS
   attributes and SA off with 3DGS ones, all tiles and the coarse
   subset: out, stash and kexit against the plain bf16 chain on the card
   within TOL_BF16_*, the gradient against the plain chain's float32 vjp
   within TOL_BF16_GRAD_* and against its torch.autograd within
   tests/test_raster_grad.py:281-316's bounds, the share of bit-equal
   values, K3's out bit-equal to K1's, the bf16 cull checked conservative
   on the bf16 chain; the gap to the f32 kernels printed under
   test_raster_grad's bounds (on the tiles with x, y < 256 and on all);
   ms per call (the packed bf16x2 kernels) beside the F32
   instantiation's on the same case and their ratio, plain ms, bounds at
   the bf16 rates, and the share of floats bit-equal to the plain chain.
   11b. The driver with tpu.compute_dtype "bf16": at 48x64 x 12 against
   phase 5's bounds moved by the JAX package's bf16-f32 gap
   (SMALL_BOUNDS_BF16); at 340x600 x 30 against phase 6's ATE bound and
   its first-submap PSNR bound moved by the JAX package's 340x600 render
   gap (PSNR_MIN_BF16), the pixels with x, y < 256 and the rest printed;
   only the bf16 K1-K3 launch; frames/s beside phase 6's; ATE and
   first-submap PSNR as PARENT_DRIVER's.
   11c. scripts/eval_nvs.py on phase 6's scene (every 6th frame), without
   and with pose refinement (finite metrics, the refined PSNR at most
   0.1 dB under the unrefined); scripts/gen_video.py on it, flythrough
   and mesh orbit (8 frames), each written by the port's GIF encoder and
   decoded back equal to the quantized frames; keyframe_overlap's
   points_overlap on the card and on the CPU with the same points.
   11d. tools/microbench.py at its defaults: ms per stage.
12. The last tools, each through its own entry point.
   12a. tools/backend_probe.py at its defaults (680x1200, 4 reps): the
   backend-shaped map (capacity 2883584) and each stage's ms under the
   factor budget and the demand-keyed pair cap; every time finite and
   > 0, the pair cap's bin without overflow and with num_pairs ==
   demand; the peak device memory; K1, K2 and K4 launched; demand,
   num_pairs and n_active equal PARENT_PROBE.
   12b. tools/quality_ab.py --variants default --seeds 0 --frames 100 at
   340x600 through its ab_runner child process: the row has no error and
   clears phase 6's ATE and PSNR bounds (whole run, 100 frames); K1-K4
   launched in the child (summed from the GAUS_LAUNCH_LOG file).
   12c. tools/test_spread.py with seeds 0 and 1 at 48x64 x 12 (mesh on),
   one child process each: every row clears tests/test_full_slam.py's
   bounds, or fails them only as phase 5 allows (a borderline keyframe
   whose reversal, rerun here, clears them), or, at a seed where the JAX
   package misses those bounds too (JAX_SPREAD), clears the bounds the
   JAX tool suggests from its own five seeds; F-score in (0, 1]; K1-K4
   launched in the children.
13. The captured steps (slam/programs.py: each step of the loops one
   CUDA graph, captured at its key's first call and replayed).
   13a. The bias-correction tables against the host floats they replace
   (a division by a table entry equals the division by the host float,
   steps 1-300); a Frontend over frames 0-11 and process_final, then a
   Backend over its LocalMaps with their task queues and two each of the
   per-step mapping, ba and tracking tasks, once with the steps captured
   and once under programs.eager(): every pose, iteration count, loss and
   map array bit-equal (so every program equals its eager run on the
   card: the tracking iterations at both levels and the tail, the
   frontend's and the backend's mapping_loop dense and coarse,
   mapping_step, ba_step, backend_tracking_step, the submap init, the
   keyframe's add_and_prune, both prunes); the programs each ran,
   the graph pools' MiB and the peak device memory above the start. The
   eval frame (render, PSNR, MS-SSIM, depth metrics) captured against
   its eager run on the Frontend's last frames, bit for bit, with ms
   per frame each way; the sharded BA step over four slots, captured,
   against its eager run over two chained steps, weights 1 and
   [1, 1, 1, 0], bit for bit.
   13b. Per step on the captured programs, under torch.profiler: graph
   launches, kernels and copies outside a graph and kernels the card
   ran, wall and device busy ms and the idle share, for a frontend
   tracking loop, the frontend's fused mapping, a backend fused x4 batch
   (at most X4_LAUNCH_LIMIT graph launches + kernels outside a graph), a
   backend mapping step, a backend tracking step, the sharded BA step on
   four slots with the Backend's owners (at most 5 graph launches and
   SHARDED_OUTSIDE_LIMIT operations outside a graph), an eval frame, a
   keyframe's view and add_and_prune, and a submap init; the tracking
   loop by CUDA events in turns: the loop program and the lagged graphs,
   each of the Frontend's owner (captured before those rows) and of an
   owner of its own (captured after them), and a loop program of a third
   owner profiled once, as the Frontend's was in its row; no capture
   meanwhile; the device ms before each loop program's launch; then
   the port's spans over 12 frames by kind of frame, host and card ms
   (tools/frame_split.py), the graph launches and captures by program
   and the graph pools' MiB. Phases 3, 4b, 6, 10a, 11b and 12a ran with
   the steps captured before it (4b audits the replays, the sharded
   step's included). The tracking loop, one loop program, must be 1
   graph launch, no kernel outside a graph and no host wait.
   13c. The tracking loop as one loop program (programs.while_loop:
   CUDA graph conditional WHILE nodes, csrc/graph_loop.cu): a Frontend's
   frame at 340x600 tracked in tests/test_torch_while_loop.py's four
   schedules (a stop inside the coarse level, inside the full-resolution
   level, no early exit, the view and the prediction after a stop inside
   the full-resolution level), the launched
   program bit-equal to its first call (one eager iteration, the warm-up,
   then the graph), to the lagged loop and to programs.eager(), with 0
   host waits; the node types of the captured iteration and tail graphs
   (all of the kinds a WHILE body takes); while_cond against
   while_cond_plain (the host loop under programs.eager(), on the card)
   in counter loops over COUNTER_GRID (kmax 0, a stop before the entry,
   two levels), early exit on and off, each launched
   program's while_cond launches (folded from the device tally) equal
   to its levels plus its iterations; the device us per WHILE iteration
   of a counter (the kernels line's while_cond ms) and the plain
   version's.
   13d. The gradient reduction's lax.cond as a CUDA graph IF node
   (graph_loop.cond, csrc/graph_loop.cu): a frontend mapping_step, a
   backend fused x4 batch (mapping_loop over 4 frames), a ba_step and the
   sharded BA step over four slots, each twice chained, on the 340x600
   map of a Frontend's first frames, under the config's pair budget and
   under one cut to half the demand (every step overflows): captured
   against programs.eager(), bit for bit; each program that reduces pair
   gradients holds one conditional node per reduction; on replays the
   device tallies show one branch per node run, the slab branch on every
   overflowing replay and the run branch on every other, if_cond's
   launches equal the nodes run, and K4 launches once per run branch
   (never on an overflowing replay). if_cond against if_cond_plain in
   small programs on both flag values and with the flag flipped between
   replays. By CUDA events at the mapping step's shapes: the slab and run
   reductions alone, torch.where over both (the eager path, every step's
   before), the reduction's IF node program on each binning; the
   captured mapping step with the IF node and with the reduction forced
   to torch.where over both (the parent's program), in turns, with and
   without overflow; if_cond's ms per node (a program of IF_NODES nodes
   less the same branches launched plain) and the plain version's.
14. K7 and K8, the tracking render's per-pair preprocess and its
   backward to the pose gradient (ops/track_preprocess.py), at the tum
   cell's pair-cache rows R = 2^20 and at R/2 (its stride-2 level), on a
   random cache (numpy seed 0; one row in eight behind the camera, one
   in sixteen zero-opacity padding) seen through TUM fr1's camera at
   480x640: K7 bit for bit against the chain with the means moved by
   elementwise sums in K7's order, and within TRACK_PRE_TOL of each
   row's scale against the chain's cuBLAS product; K8's d_w2c within
   TRACK_PRE_TOL (normwise) of autograd of the chain, twice the same
   bits. ms per launch of K7 alone and K8 alone (50 launches in a CUDA
   graph) against their plain counterparts (the chain's forward; its
   backward from d_attrs to d_w2c), the bounds by bytes; and forward +
   backward to the pose through pose_matrix, the chain against the
   Function of K7 and K8 (each one captured graph).
Then one JSON line with every kernel's numbers (launches per phase; K1-K3
also without SA on 3DGS attributes; the bf16 instantiations as entries
of their own, with their launches in 11b at 340x600; while_cond, the
tracking loop's condition, from 13c; if_cond, the reduction's, from
13d), the card line, and {"ok": true, "device": {...}} as the last
line.
"""
from __future__ import annotations

import contextlib
import json
import os
import queue
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "synthetic", "config.py")

H, W = 340, 600              # bench shape (bench.py)
N_FRAMES = 24                # phase 3: two cuts at the default 10-frame submaps
# What the code printed on this card with the tracking render's per-pair
# preprocess in K7 / K8 (ops/track_preprocess.py: the means moved by
# elementwise sums, not a cuBLAS product): the device-side branches, the
# lagged early exit and the captured steps must give the same numbers, to
# every digit.
# phase 3: frame -> (tracking iterations, loss to 4 decimals)
PARENT_PHASE3 = {
    1: (30, "1677.3408"), 2: (30, "1887.2175"), 3: (17, "157.2274"),
    4: (12, "183.0615"), 5: (15, "170.8146"), 6: (13, "281.1314"),
    7: (13, "207.2997"), 8: (16, "154.1984"), 9: (14, "133.2078"),
    10: (12, "142.0230"), 11: (16, "146.0222"), 12: (17, "146.3900"),
    13: (10, "126.9726"), 14: (15, "122.0923"), 15: (26, "1187.9246"),
    16: (13, "133.9661"), 17: (27, "1162.0981"), 18: (14, "160.2215"),
    19: (15, "158.6969"), 20: (12, "145.4548"), 21: (15, "128.7208"),
    22: (16, "135.2138"), 23: (30, "1202.5151")}
# phases 6 and 11b: ATE RMSE and first-submap PSNR as printed (.6g)
PARENT_DRIVER = {"driver_340x600": ("0.00202335", "41.3221"),
                 "bf16_340x600": ("0.00926382", "33.1192")}
# phase 12a: demand, num_pairs and n_active of the probe's map
PARENT_PROBE = {"demand": 3772565, "num_pairs": 3772565, "n_active": 2448000}
N_FRAMES_REF = 6             # phase 3b
# A tracked frame ends below TRACK_GAIN x its constant-velocity init's
# translation error, or within T_ERR_ABS: twice the JAX system's
# ATE-RMSE at 340x600 (5.5 mm, 3 seeds x 100 frames on a TPU v5e,
# tools/quality_ab.py), for inits that already sit near that accuracy.
TRACK_GAIN = 0.5
ATE_JAX = 0.0055
T_ERR_ABS = 2 * ATE_JAX
# phase 6: 4 dB under the JAX system's 39.09 dB PSNR at 340x600 (3 seeds
# x 100 frames of the pipelined schedule on a TPU v5e, tools/quality_ab.py;
# a quality figure), held over the frames of the first submap
PSNR_MIN = 35.0
# phase 5: the bounds tests/test_full_slam.py:37-40 hold the JAX system to
# at 48x64 over 12 frames
SMALL = dict(SYN_H="48", SYN_W="64", SYN_FRAMES="12")
SMALL_BOUNDS = {"ATE RMSE": ("<", 0.025), "PSNR": (">", 25.1),
                "MS-SSIM": (">", 0.99), "Depth L1": ("<", 0.017)}
# phase 9b, the 3DGS ablation (render.method 3dgs, isotropic gaussians)
# through the driver. The JAX package's driver at 48x64 x 12, seed 0, on
# the CPU (tests/test_torch_splatam.py::test_3dgs_ablation_driver_matches_
# jax and the same run in 2DGS; backend "interpret"):
JAX_48x64_2DGS = {"ATE RMSE": 0.01642247568269582, "PSNR": 26.379912853240967,
                  "MS-SSIM": 0.9979527046283087,
                  "Depth L1": 0.010275302610049645}
JAX_48x64_3DGS = {"ATE RMSE": 0.028712366615661403,
                  "PSNR": 22.325717449188232, "MS-SSIM": 0.9947469979524612,
                  "Depth L1": 0.01961565805443873}
# At 48x64: each of SMALL_BOUNDS moved by what the JAX package reaches in
# 3DGS against 2DGS (the same headroom over the JAX numbers as
# tests/test_full_slam.py gives the 2DGS ones).
SMALL_BOUNDS_3DGS = {k: (op, b + JAX_48x64_3DGS[k] - JAX_48x64_2DGS[k])
                     for k, (op, b) in SMALL_BOUNDS.items()}
# At 340x600 the 3DGS ablation is held to phase 6's bounds unrelaxed
# (the JAX package loses 12.3 mm ATE and 4.05 dB PSNR between 2DGS and
# 3DGS at 48x64, a margin these bounds do not take).
# phase 11b, the driver with tpu.compute_dtype "bf16". The JAX package's
# driver at 48x64 x 12, seed 0, on the CPU with "bf16" (backend
# "interpret"; tests/test_torch_bf16.py::test_bf16_driver_matches_jax,
# slow, which also reruns JAX_48x64_2DGS in f32 to the same digits):
JAX_48x64_BF16 = {"ATE RMSE": 0.017630747822350263,
                  "PSNR": 25.632961908976238, "MS-SSIM": 0.9978483070929846,
                  "Depth L1": 0.015740143368020654}
# At 48x64: each of SMALL_BOUNDS moved by what the JAX package loses in
# bf16 against f32 there.
SMALL_BOUNDS_BF16 = {k: (op, b + JAX_48x64_BF16[k] - JAX_48x64_2DGS[k])
                     for k, (op, b) in SMALL_BOUNDS.items()}
# At 340x600 bf16 also rounds the pixel coordinates, past 256 to even
# numbers and past 512 to multiples of 4, a loss that 48x64 cannot show.
# The JAX package's render of the synthetic scene's frame-0 map at
# 340x600, 5 mm from frame 0's pose, in f32 and in bf16: PSNR over the
# whole image (tests/test_torch_bf16.py::test_full_width_render_matches_
# jax, slow, on the CPU; 0.73 dB of the loss on the pixels with x, y <
# 256, 4.8 dB on the rest; the port's within 0.02 dB of each).
JAX_340x600_RENDER_PSNR = {"f32": 35.3896484375, "bf16": 31.226842880249023}
# At 340x600 phase 6's ATE bound holds unmoved, and its first-submap PSNR
# bound moves by that render's bf16-f32 gap.
PSNR_MIN_BF16 = (PSNR_MIN + JAX_340x600_RENDER_PSNR["bf16"]
                 - JAX_340x600_RENDER_PSNR["f32"])
# phase 9c: tests/test_splatam.py's PSNR bound
SPLATAM_PSNR_MIN = 15.0
# a keyframe test within this share of its threshold is decided by float32
# rounding (the port's CPU and card runs count 156 and 153 at 48x64 frame
# 9 against 153.6)
KF_MARGIN = 0.02
# phase 12c: the JAX package's own spread on this tree, tools/test_spread.py
# over seeds 0-4 on the CPU (interpret). It clears tests/test_full_slam.py's
# bounds at seed 0 only: seeds 1-4 end near 23.1-23.3 dB with a depth L1 of
# 38-42 mm (artifacts/test_bounds_spread.json, recorded on older code, has
# all five near 26.3 dB). Where the JAX package misses those bounds at a
# seed, a port seed is held to the bounds the JAX tool suggests from these
# five rows.
JAX_SPREAD = os.path.join(REPO, "artifacts", "test_bounds_spread_jax_cpu.json")

# Peak rates of one H100 SXM (NVIDIA data sheet, at a 700 W limit). The
# special-function units give 16 results (reciprocal, exp2, log2) per SM
# per clock against 128 f32 lanes doing an FMA (2 FLOP) each, so their
# rate is the f32 rate / 16.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
SFU_PER_S = F32_FLOP_PER_S / 16
# packed bf16 outside the tensor cores: 133.8 TFLOP/s against 66.9 f32
# (NVIDIA H100 Tensor Core GPU Architecture white paper, SXM5)
BF16_FLOP_PER_S = 2 * F32_FLOP_PER_S
# ex2.approx.bf16x2 (PTX ISA 7.8, sm_90) gives two bf16 exps per
# special-function instruction. NVIDIA publishes no rate for it; the
# bounds take it at twice the f32 rate, the least time it could take.
# rcp and lg2 have no packed bf16 form and keep SFU_PER_S.
BF16_EXP_PER_S = 2 * SFU_PER_S
# (FLOP, SFU) per (pair, pixel) that the function needs, counted once from
# compositing.composite_chunk (SA on, normals off) without the kernels'
# own recompute. FLOP: add, sub, mul, min, max and compare 1 each, a
# fused multiply-add 2; SFU: reciprocals, exp and log.
# Per evaluation (a pixel walks its tile's pairs until it terminates):
#   ray-splat geometry and alpha 38 + (rcp, exp); accept test and
#   transmittance 7 + (log1p, exp).
FWD_EVAL = (45, 4)
# Of those, the exps that the bf16 chain computes in bf16: exp(-rho / 2)
# and exp(cum). Its rcp and log1p, and SA's float32 exp, are not packed.
FWD_EVAL_BF16_EXPS = 2
# Per evaluation that the cull test rejects (raster_common.cuh::
# pair_culled: both squared distances past the pair's cull radius), which
# needs that test alone: the 2D distance 7, the ray's three coordinates
# 12, the 3D comparison 6; no special function.
CULL_EVAL = (25, 0)
# Per accepted (pair, pixel): weight, median test, color, SA prefixes and
# log-sum 13; SA's fusion weight and fused depth 25 + (rcp, rcp, exp).
FWD_ACCEPTED = (38, 3)
# K2 per accepted (pair, pixel): the forward's per-pair values without
# its color and depth sums (38 - 11), the hand-derived vjp 64 + (rcp),
# and the sum over pixels of the 18 gradient rows it touches 18. K5
# computes the same function (its re-forward is the kernel's own
# recompute, as K2's is), so it has the same bound.
BWD_ACCEPTED = (27 + 64 + 18, 4)

KERNELS = {
    "raster_forward_stash": ("K1", "gaus_slam_tpu_torch/csrc/raster_forward.cu",
                             "gaus_slam_tpu/ops/pallas_forward.py:173"),
    "raster_backward_stash": ("K2", "gaus_slam_tpu_torch/csrc/raster_backward.cu",
                              "gaus_slam_tpu/ops/pallas_backward.py:201"),
    "raster_forward": ("K3", "gaus_slam_tpu_torch/csrc/raster_forward.cu",
                       "gaus_slam_tpu/ops/pallas_forward.py:32"),
    "monotone_row_gather": ("K4", "gaus_slam_tpu_torch/csrc/gather.cu",
                            "gaus_slam_tpu/ops/gather.py:35"),
    "raster_backward": ("K5", "gaus_slam_tpu_torch/csrc/raster_backward.cu",
                        "gaus_slam_tpu/ops/pallas_backward.py:109"),
    "bf16_probe": ("K6", "gaus_slam_tpu_torch/csrc/bf16_probe.cu",
                   "tools/bf16_probe.py:74"),
    # the bf16 compute dtype of K1, K2 and K3: the same TPU kernels with
    # compute_dtype "bf16" (where the dtype enters each)
    "raster_forward_stash_bf16": (
        "K1-bf16", "gaus_slam_tpu_torch/csrc/raster_forward.cu",
        "gaus_slam_tpu/ops/pallas_forward.py:297"),
    "raster_backward_stash_bf16": (
        "K2-bf16", "gaus_slam_tpu_torch/csrc/raster_backward.cu",
        "gaus_slam_tpu/ops/pallas_backward.py:344"),
    "raster_forward_bf16": (
        "K3-bf16", "gaus_slam_tpu_torch/csrc/raster_forward.cu",
        "gaus_slam_tpu/ops/pallas_forward.py:110"),
}
# the tracking loop's condition: no Pallas kernel; it replaces the JAX
# tracking_loop's while_loop cond (cond_until), which XLA runs on the
# device between iterations
KERNELS["while_cond"] = ("L1", "gaus_slam_tpu_torch/csrc/graph_loop.cu",
                         "gaus_slam_tpu/slam/steps.py:129")
# the gradient reduction's branch: no Pallas kernel; it replaces the JAX
# slab_scatter_grads' lax.cond on the overflow flag, which XLA runs on the
# device (only the taken branch)
KERNELS["if_cond"] = ("L2", "gaus_slam_tpu_torch/csrc/graph_loop.cu",
                      "gaus_slam_tpu/ops/binning.py:120")
# the tracking render's preprocess: no Pallas kernel; it replaces the
# JAX render_tracking's plain preprocess chain, which XLA fuses
KERNELS["track_preprocess"] = ("K7",
                               "gaus_slam_tpu_torch/csrc/track_preprocess.cu",
                               "gaus_slam_tpu/render/__init__.py:537")
KERNELS["track_preprocess_backward"] = (
    "K8", "gaus_slam_tpu_torch/csrc/track_preprocess.cu",
    "gaus_slam_tpu/render/__init__.py:537")
TRACK_PATH = ("track_preprocess", "track_preprocess_backward")
STASH_PATH = ("raster_forward_stash", "raster_backward_stash",
              "raster_forward", "monotone_row_gather")
BF16_PATH = ("raster_forward_stash_bf16", "raster_backward_stash_bf16",
             "raster_forward_bf16")


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def time_ms(fn, reps, warm=2):
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def time_graph_ms(fn, reps):
    """Device ms per call of a short kernel: ``reps`` calls captured in one
    CUDA graph and replayed between CUDA events, so the wrapper's host
    time between launches does not count."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


# ---------------------------------------------------------------------------
# phase 1


def phase_build():
    """Builds every library; prints each kernel's registers, spills and
    static shared memory from the -Xptxas -v report, and the dynamic
    shared memory K2's sweep asks for."""
    import ctypes

    from gaus_slam_tpu_torch.ops import _cuda

    t0 = time.time()
    built = _cuda.build_all()
    print(f"[build] {len(built)} libraries in {time.time() - t0:.1f} s "
          f"into {_cuda.BUILD_DIR}")
    for name, (path, report) in built.items():
        lines = report.splitlines()
        for i, line in enumerate(lines):
            if "registers" in line or "spill" in line:
                # the kernel's name is on the "Compiling entry" line above
                entry = next((ln.split("'")[1] for ln in reversed(lines[:i])
                              if "Compiling entry function" in ln), "")
                print(f"[build] {name}: {entry[:60]} {line.strip()}")
    smem = ctypes.CDLL(str(built["raster_backward"][0])).sweep_smem_bytes
    print(f"[build] raster_backward: the sweep (K2, K5) takes {smem()} bytes "
          f"of dynamic shared memory per CTA")


# ---------------------------------------------------------------------------
# scene


def config_from_env(env):
    """configs/synthetic/config.py loaded with the SYN_* variables of
    ``env`` set (and the process environment restored after)."""
    from gaus_slam_tpu_torch.utils.config import load_config as load

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return load(CONFIG)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def load_config():
    """configs/synthetic/config.py at H x W, cameras probed from the
    synthetic dataset (as scripts/gaus.py does); returns (config, dataset)."""
    from gaus_slam_tpu_torch.data.synthetic import SyntheticDataset
    from gaus_slam_tpu_torch.utils.config import probe_cameras

    cfg = config_from_env(dict(SYN_H=str(H), SYN_W=str(W)))
    ds = SyntheticDataset(height=H, width=W, num_frames=60)
    probe_cameras(cfg, ds[0][0], ds.intrinsics)
    return cfg, ds


def load_frame(ds, i, dev):
    import torch

    color, depth, _, c2w = ds[i]
    return (torch.as_tensor(color / 255.0, dtype=torch.float32, device=dev),
            torch.as_tensor(depth, dtype=torch.float32, device=dev),
            np.asarray(c2w, np.float64))


def make_setup(dev):
    """(config, dataset, the frontend's SystemConfig, capacity)."""
    from gaus_slam_tpu_torch.utils.config import SystemConfig

    cfg, ds = load_config()
    sys_cfg = SystemConfig.from_config(cfg, component="frontend", device=dev)
    return cfg, ds, sys_cfg, int(cfg["tpu"]["frontend_capacity"])


# ---------------------------------------------------------------------------
# phase 2


def random_map(ds, cam, capacity, dev, seed=0):
    """Map of frame 0 with numpy-seeded random opacity, color, scale and
    position jitter on its active rows."""
    import torch

    from gaus_slam_tpu_torch.models.gaussians import Params
    from gaus_slam_tpu_torch.slam.init_map import initialize_map

    color, depth, _ = load_frame(ds, 0, dev)
    gm = initialize_map(capacity, color, depth,
                        torch.eye(4, device=dev), cam)
    rng = np.random.default_rng(seed)
    n = gm.capacity

    def noise(shape, scale):
        return torch.as_tensor(rng.normal(0.0, scale, shape).astype(np.float32),
                               device=dev)

    act = gm.active[:, None]
    p = gm.params
    new = Params(
        xyz=p.xyz + act * noise((n, 3), 0.003),
        log_scales=p.log_scales + act * noise((n, 2), 0.3),
        quats=p.quats + act * noise((n, 4), 0.1),
        opacity_logit=torch.where(act, noise((n, 1), 2.0), p.opacity_logit),
        rgb=torch.where(act, torch.as_tensor(
            rng.uniform(0, 1, (n, 3)).astype(np.float32), device=dev), p.rgb),
    )
    return gm._replace(params=new)


def kernel_inputs(gm, cam, opts, stride):
    """Pair attributes + tile ranges of the mapping path (all tiles) and
    of the coarse tracking path (stride-3 tile subset of a phase-major
    cache sliced to its head block), for opts' render method."""
    import torch

    from gaus_slam_tpu_torch.render import (_prep_attrs, _preprocess_3dgs,
                                            bin_for_tracking, bin_full,
                                            expand_pairs,
                                            track_coarse_budget)
    from gaus_slam_tpu_torch.ops.preprocess import (pack_pair_attrs,
                                                    preprocess_t)
    from gaus_slam_tpu_torch.slam.steps import _coarse_tile_ids

    with torch.no_grad():
        bins = bin_full(gm.params, gm.active, cam, opts)
        attrs, _ = _prep_attrs(gm.params, gm.active, cam, opts)
        pattrs = expand_pairs(attrs.T, bins, opts.max_tiles_per_gaussian)
        full = (pattrs.contiguous(), bins.tile_start, bins.tile_stop, None)
        cache = bin_for_tracking(gm, cam, opts, coarse_strides=(stride,))
        hi = track_coarse_budget(cache.raw_t.shape[1], stride)
        raw = cache.raw_t[:, :hi]
        eye = cam.replace_w2c(torch.eye(4, device=raw.device))
        if opts.method == "3dgs":
            # render_tracking's 3DGS branch at the identity pose
            pre = _preprocess_3dgs(raw[0:3].T, raw[3:5].T, raw[5:9].T,
                                   raw[9], eye, opts)
            cattrs = pack_pair_attrs(pre, raw[10:13].T)
        else:
            cattrs, _ = preprocess_t(raw[0:3], raw[3:5], raw[5:9], raw[9],
                                     raw[10:13], eye)
        ids = _coarse_tile_ids(opts.grid, stride, raw.device)
        ts = torch.clamp(cache.tile_start, max=hi)
        te = torch.where(cache.tile_stop <= hi, cache.tile_stop, ts)
        coarse = (cattrs.contiguous(), ts[ids.long()], te[ids.long()], ids)
    return bins, {"full": full, "coarse": coarse}


def cull_rejects(op, dx, dy, p_x, p_y, p_z):
    """raster_common.cuh::pair_culled on tensors: both squared distances
    of a (pair, pixel) past the pair's cull radius rho_cull(op) (-1 where
    no pixel can pass the alpha test), the 3D one without the division."""
    import torch

    from gaus_slam_tpu_torch.ops.camera import ALPHA_MIN, FILTER_INV_SQUARE

    m = 1.0 / 1024.0
    lim = torch.where(op < ALPHA_MIN, torch.full_like(op, -1.0),
                      2.0 * torch.log(op / ALPHA_MIN) * (1.0 + m) + m)
    return ((FILTER_INV_SQUARE * (dx * dx + dy * dy) > lim)
            & (p_x * p_x + p_y * p_y > lim * (p_z * p_z)))


def cull_rejects_bf16(op, rho2d, rho3d):
    """raster_common.cuh::pair_culled under BF16 on tensors: the bf16
    chain's own rounded rho2d and rho3d both past the bf16 radius of the
    bf16 opacity (rho_cull<BF16>)."""
    import torch

    from gaus_slam_tpu_torch.ops.camera import ALPHA_MIN

    ob = op.to(torch.bfloat16).float()
    lim = torch.where(ob < ALPHA_MIN, torch.full_like(ob, -1.0),
                      2.0 * torch.log(ob / ALPHA_MIN) * (1.0 + 1.0 / 1024.0)
                      + 1.0 / 32.0)
    return (rho2d.float() > lim) & (rho3d.float() > lim)


def pair_pixel_work(pattrs, ts, te, out, grid, chunk=16384, bf16=False):
    """(pair, pixel) work this run's data needs, for the operation bound:
    (evaluations, culled, accepted, wrongly culled). A pixel evaluates its
    tile's pairs until it terminates, just past its last contributor
    n_contrib; of those evaluations, the cull test rejects some without
    their geometry (cull_rejects); it accepts a pair at or before
    n_contrib whose depth and alpha tests pass (composite_chunk's okf).
    Wrongly culled: (pair, pixel) of the tile's whole range that the cull
    rejects although the alpha test passes (must be 0: the cull is
    conservative). ts / te are the ranges of tiles 0..T-1. ``bf16``: the
    bf16 chain's geometry and alpha test (compositing.bf16_geometry) and
    the bf16 cull (cull_rejects_bf16)."""
    import torch

    from gaus_slam_tpu_torch.ops.camera import (ALPHA_MIN, FILTER_INV_SQUARE,
                                                NEAR_N)
    from gaus_slam_tpu_torch.ops.composite_ref import tile_pixel_coords
    from gaus_slam_tpu_torch.ops.compositing import bf16_geometry

    dev = pattrs.device
    lens = (te - ts).clamp(min=0).long()
    nc = out[:, 13]
    upto = torch.minimum(nc.double() + 1.0, lens.double()[:, None])
    upto = torch.where(out[:, 15] > 0.5, upto,
                       lens.double()[:, None].expand_as(upto))
    evals = float(upto.sum())
    tile = torch.repeat_interleave(torch.arange(lens.numel(), device=dev), lens)
    k = torch.arange(tile.numel(), device=dev) - (torch.cumsum(lens, 0)
                                                  - lens)[tile]
    px, py = tile_pixel_coords(grid, torch.arange(lens.numel(), device=dev))
    accepted = culled = wrong = 0
    for c0 in range(0, tile.numel(), chunk):
        t, kk = tile[c0:c0 + chunk], k[c0:c0 + chunk]
        a = pattrs[:, ts.long()[t] + kk].T[..., None]     # [m, 24, 1]
        x, y = px[t, 0], py[t, 0]                          # [m, P]
        p_x = x * a[:, 0] + y * a[:, 3] + a[:, 6]
        p_y = x * a[:, 1] + y * a[:, 4] + a[:, 7]
        p_z = x * a[:, 2] + y * a[:, 5] + a[:, 8]
        sx = p_x / torch.where(p_z != 0, p_z, torch.ones_like(p_z))
        sy = p_y / torch.where(p_z != 0, p_z, torch.ones_like(p_z))
        rho3d = sx * sx + sy * sy
        rho2d = FILTER_INV_SQUARE * ((a[:, 12] - x) ** 2 + (a[:, 13] - y) ** 2)
        d_raw = torch.where(rho3d <= rho2d, sx * a[:, 9] + sy * a[:, 10]
                            + a[:, 11], a[:, 11].expand_as(sx))
        alpha = a[:, 17] * torch.exp(-0.5 * torch.minimum(rho3d, rho2d))
        pz_ok = p_z != 0
        if bf16:
            g = bf16_geometry(a.transpose(1, 2), x[:, None], y[:, None])
            pz_ok, d_raw, alpha = (g.pz_ok[:, 0], g.d_raw[:, 0].float(),
                                   g.alpha_raw[:, 0].float())
            rej = cull_rejects_bf16(a[:, 17], g.rho2d[:, 0], g.rho3d[:, 0])
        else:
            rej = cull_rejects(a[:, 17], a[:, 12] - x, a[:, 13] - y, p_x,
                               p_y, p_z)
        ok = (pz_ok & (d_raw >= NEAR_N) & (alpha >= ALPHA_MIN)
              & ((kk + 1)[:, None].float() <= nc[t]))
        accepted += int(ok.sum())
        ev = kk[:, None].double() < upto[t]
        culled += int((rej & ev).sum())
        wrong += int((rej & pz_ok & (alpha >= ALPHA_MIN)).sum())
    return evals, float(culled), float(accepted), wrong


def op_bound(evals, accepted, per_accepted, nbytes, culled=0.0, bf16=False):
    """(bound ms, 'operations' or 'bytes'): the f32 and special-function
    pipes run side by side, so the operation time is the larger of the
    two; the bound is the larger of that and the bytes' time. Of the
    evaluations, the ``culled`` ones cost the cull test alone. ``bf16``:
    the bf16 chain's bound, every FLOP at the packed bf16 rate (its sums
    and SA's fusion weight are float32, so this is below what the
    function needs) and its bf16 exps at BF16_EXP_PER_S."""
    kept = evals - culled
    flop = (kept * FWD_EVAL[0] + culled * CULL_EVAL[0]
            + accepted * per_accepted[0])
    sfu = (kept * FWD_EVAL[1] + culled * CULL_EVAL[1]
           + accepted * per_accepted[1])
    t_sfu, rate = sfu / SFU_PER_S, F32_FLOP_PER_S
    if bf16:
        exps = kept * FWD_EVAL_BF16_EXPS
        t_sfu = (sfu - exps) / SFU_PER_S + exps / BF16_EXP_PER_S
        rate = BF16_FLOP_PER_S
    t_ops = max(flop / rate, t_sfu) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


# Tolerances of the kernels against their plain versions, relative to
# each channel's scale. The two sum in different orders (sequential per
# pixel vs cumsum / matmul over the block); channels built on SA's fusion
# weight see that rounding amplified, because the weight depends on the
# cancelling variance estimate D2 - 2*D*mm (depth, middepth and the D /
# D2 stash rows). The SA distortion channel is itself that cancellation,
# D2 - 2*mm*D + mm^2*(1-T): its error is measured against the scale of
# its terms (mm*D + mm^2), not of its small result.
TOL_OUT = {c: 1e-4 for c in range(13)}
TOL_OUT.update({3: 2e-3, 8: 2e-3, 9: 2e-3})
TOL_STASH = {0: 1e-4, 1: 0.0, 2: 2e-3, 3: 2e-3, 4: 1e-4, 5: 1e-4, 6: 2e-3,
             7: 0.0}
TOL_GRAD = 2e-3


def compare_out(k_out, p_out, tol=TOL_OUT):
    """Integer channels (n_contrib, med_contrib, done) may differ only on
    threshold-borderline pixels (< 0.5%); float channels agree within
    TOL_OUT of the channel's scale on the other pixels. Returns (mismatch
    fraction, max abs err, per-channel report, ok)."""
    import torch

    agree = torch.ones_like(k_out[:, 0], dtype=torch.bool)
    for c in (13, 14, 15):
        agree &= k_out[:, c] == p_out[:, c]
    frac = int((~agree).sum()) / agree.numel()
    err, ok, report = 0.0, frac < 5e-3, []
    mm, dd = p_out[:, 8].abs(), p_out[:, 3].abs()
    for c in range(13):
        ref = mm * dd + mm * mm if c == 9 else p_out[:, c].abs()
        scale = max(float(ref.max()), 1e-6)
        d = (k_out[:, c] - p_out[:, c]).abs()[agree]
        m = float(d.max()) if d.numel() else 0.0
        err = max(err, m)
        ok = ok and m <= tol[c] * scale
        report.append(f"{c}:{m / scale:.1e}")
    return frac, err, " ".join(report), ok


def compare_stash(k_stash, p_stash, k_kexit, p_kexit, ts, te, dev, tol):
    """Stash rows of the tiles whose block count agrees, each within tol
    of its scale. Returns (ok, report)."""
    import torch

    from gaus_slam_tpu_torch.ops.raster_forward import stash_offsets

    soff = stash_offsets(ts, te).long()
    rows = [torch.arange(int(soff[i]), int(soff[i]) + int(k_kexit[i]),
                         device=dev)
            for i in torch.nonzero(k_kexit == p_kexit)[:, 0].tolist()]
    rows = torch.cat(rows) if rows else torch.zeros(0, dtype=torch.long,
                                                    device=dev)
    ok, report = True, []
    for c in range(8):
        ref = p_stash[rows, c]
        m = float((k_stash[rows, c] - ref).abs().max()) if rows.numel() else 0.0
        scale = max(float(ref.abs().max()), 1e-6) if rows.numel() else 1.0
        ok = ok and m <= tol[c] * scale
        report.append(f"{c}:{m / scale:.1e}")
    return ok, " ".join(report)


def compare_grad(k_grad, p_grad, p64):
    """Per attribute row: relative L2 error against the plain float32
    version <= TOL_GRAD, or, where SA's fusion weight makes two float32
    summation orders differ by more, against the plain float64 evaluation
    no further than the plain float32 version is. Returns (ok, report)."""
    ok, report = True, []
    for c in range(21):
        ref = float(p_grad[c].norm())
        if ref == 0.0:
            ok = ok and float(k_grad[c].abs().max()) == 0.0
            continue
        r32 = float((k_grad[c] - p_grad[c]).norm()) / ref
        r64 = float((k_grad[c].double() - p64[c]).norm() / p64[c].norm())
        p_64 = float((p_grad[c].double() - p64[c]).norm() / p64[c].norm())
        ok = ok and (r32 <= TOL_GRAD or r64 <= 1.5 * p_64 + 1e-5)
        report.append(f"{c}:{r32:.1e}/{r64:.1e}/{p_64:.1e}")
    return ok, report


def phase_kernels(ds, sys_cfg, capacity, dev):
    import torch

    from gaus_slam_tpu_torch.ops.gather import (
        monotone_row_gather, monotone_row_gather_rows,
        monotone_row_gather_rows_plain)
    from gaus_slam_tpu_torch.ops.raster_backward import (
        raster_backward, raster_backward_plain, raster_backward_stash,
        raster_backward_stash_plain)
    from gaus_slam_tpu_torch.ops.raster_forward import (raster_forward,
                                                        raster_forward_plain,
                                                        raster_forward_stash)

    cam, opts = sys_cfg.cam, sys_cfg.opts
    d_max = opts.max_tiles_per_gaussian
    gm = random_map(ds, cam, capacity, dev)
    bins, cases = kernel_inputs(gm, cam, opts,
                                sys_cfg.track_front.coarse_stride)
    rng = np.random.default_rng(1)
    results = {}
    kw = dict(grid=opts.grid, use_sa=True, need_normal=False)
    for case, (pattrs, ts, te, ids) in cases.items():
        n_sub = int(ts.shape[0])
        print(f"[kernels] case {case}: {n_sub} tiles, R={pattrs.shape[1]}, "
              f"pairs={int((te - ts).clamp(min=0).sum())}")
        k_out, k_stash, k_kexit = raster_forward_stash(pattrs, ts, te,
                                                       tile_ids=ids, **kw)
        k3_out = raster_forward(pattrs, ts, te, tile_ids=ids, **kw)
        p_out, p_stash, p_kexit = raster_forward_plain(pattrs, ts, te,
                                                       tile_ids=ids, **kw)
        torch.cuda.synchronize()
        frac, err1, report, ok1 = compare_out(k_out, p_out)
        kex_agree = float((k_kexit == p_kexit).float().mean())
        st_ok, st_report = compare_stash(k_stash, p_stash, k_kexit, p_kexit,
                                         ts, te, dev, TOL_STASH)
        k3_same = bool(torch.equal(k3_out, k_out))
        print(f"[kernels] K1 {case}: int-channel mismatch {frac:.2e} "
              f"(< 5e-3), float max abs err {err1:.3e}, relative by channel "
              f"[{report}] (tol {TOL_OUT}), kexit agree {kex_agree:.4f}, "
              f"stash relative by row [{st_report}]; K3 == K1 "
              f"out: {k3_same}")
        check(ok1, f"K1 {case} disagrees with its plain version")
        check(kex_agree >= 0.99, f"K1 {case} kexit disagrees")
        check(st_ok, f"K1 {case} stash disagrees")
        check(k3_same, f"K3 {case} differs from K1's output")

        d_out = torch.zeros_like(k_out)
        d_out[:, :10] = torch.as_tensor(
            rng.normal(size=(n_sub, 10, k_out.shape[-1])).astype(np.float32),
            device=dev)
        bargs = (pattrs, ts, te, k_stash, k_kexit, k_out, d_out)
        k_grad = raster_backward_stash(*bargs, tile_ids=ids, **kw)
        k_again = raster_backward_stash(*bargs, tile_ids=ids, **kw)
        p_grad = raster_backward_stash_plain(*bargs, tile_ids=ids, **kw)
        # the same function evaluated in float64: SA's gradient through the
        # depth rows reads the fusion weight's cancelling variance
        # estimate, so two float32 evaluations in different summation
        # orders differ by more than TOL_GRAD there; the kernel must then
        # be no further from float64 than the plain float32 version is
        p64 = raster_backward_stash_plain(
            *(a.double() if a.is_floating_point() else a for a in bargs),
            tile_ids=ids, **kw)
        torch.cuda.synchronize()
        err2 = float((k_grad - p_grad).abs().max())
        ok2, report = compare_grad(k_grad, p_grad, p64)
        del p64
        untouched = float(k_grad[21:].abs().max())
        same = bool(torch.equal(k_again, k_grad))
        print(f"[kernels] K2 {case}: max abs err {err2:.3e}; per attribute "
              f"row relative L2 err vs plain f32 / vs f64 / plain f32 vs "
              f"f64 [{' '.join(report)}] (tol: vs f32 <= {TOL_GRAD}, or vs "
              f"f64 <= 1.5 x plain's); pad rows {untouched}; two launches "
              f"bit-equal: {same}")
        check(ok2 and untouched == 0.0,
              f"K2 {case} disagrees with torch.autograd through the plain "
              f"version")
        check(same, f"K2 {case}: two launches on the same inputs differ")
        if case == "full":
            # without SA the weight is well conditioned: K2 must match the
            # plain version's autograd tightly
            kn = dict(kw, use_sa=False)
            n_out, n_stash, n_kexit = raster_forward_stash(pattrs, ts, te, **kn)
            nargs = (pattrs, ts, te, n_stash, n_kexit, n_out, d_out)
            nk = raster_backward_stash(*nargs, **kn)
            npl = raster_backward_stash_plain(*nargs, **kn)
            rel_n = max(float((nk[c] - npl[c]).norm() / npl[c].norm())
                        for c in range(21) if float(npl[c].norm()) > 0)
            print(f"[kernels] K2 full without SA: worst row relative L2 err "
                  f"{rel_n:.2e} (tol 1e-5)")
            check(rel_n <= 1e-5, "K2 without SA disagrees with its plain "
                  "version")

        if case == "full":
            # K5 on the same inputs: its own re-forward instead of K1's
            # stash, so the same carries and the same gradient as K2
            k5_args = (pattrs, ts, te, k_out, d_out)
            scratch = torch.zeros_like(k_stash)
            k5 = raster_backward(*k5_args, scratch=scratch, **kw)
            p5 = raster_backward_plain(*k5_args, **kw)
            p5_64 = raster_backward_plain(pattrs.double(), ts, te,
                                          k_out.double(), d_out.double(), **kw)
            torch.cuda.synchronize()
            err5 = float((k5 - p5).abs().max())
            ok5, report5 = compare_grad(k5, p5, p5_64)
            del p5_64
            d52 = float((k5 - k_grad).abs().max())
            print(f"[kernels] K5: max abs err {err5:.3e}; per attribute row "
                  f"relative L2 err vs plain f32 / vs f64 / plain f32 vs f64 "
                  f"[{' '.join(report5)}] (tol as K2); largest difference "
                  f"from K2 on K1's stash {d52:.3e} (bit-equal: "
                  f"{bool(torch.equal(k5, k_grad))})")
            check(ok5 and float(k5[21:].abs().max()) == 0.0,
                  "K5 disagrees with torch.autograd through the plain version")
            check(bool(torch.equal(k5, k_grad)),
                  "K5 is not bit-equal to K2 on K1's stash")
            same5 = bool(torch.equal(scratch, k_stash))
            print(f"[kernels] K5's re-forward stash == K1's stash: {same5}")
            check(same5, "K5's re-forward stash differs from K1's")
            del scratch

            evals, culled, accepted, wrong = pair_pixel_work(
                pattrs, ts, te, k_out, opts.grid)
            check(wrong == 0, f"phase 2: the cull rejected {wrong} (pair, "
                  f"pixel) that pass the alpha test")
            out_bytes = k_out.numel() * 4
            in_bytes = pattrs.numel() * 4 + 3 * n_sub * 4
            stash_bytes = int(k_kexit.sum()) * 8 * 256 * 4
            t_k1 = time_ms(lambda: raster_forward_stash(pattrs, ts, te, **kw), 10)
            t_k3 = time_ms(lambda: raster_forward(pattrs, ts, te, **kw), 10)
            t_k2 = time_ms(lambda: raster_backward_stash(*bargs, **kw), 5)
            t_p1 = time_ms(lambda: raster_forward_plain(pattrs, ts, te, **kw),
                           2, warm=1)
            t_p2 = time_ms(lambda: raster_backward_stash_plain(*bargs, **kw),
                           1, warm=1)
            t_k5 = time_ms(lambda: raster_backward(*k5_args, **kw), 5)
            t_p5 = time_ms(lambda: raster_backward_plain(*k5_args, **kw), 1,
                           warm=1)

            work = {
                "raster_forward_stash": (FWD_ACCEPTED,
                                         in_bytes + out_bytes + stash_bytes),
                "raster_forward": (FWD_ACCEPTED, in_bytes + out_bytes),
                "raster_backward_stash": (
                    BWD_ACCEPTED, 2 * in_bytes + 2 * out_bytes + stash_bytes),
                "raster_backward": (BWD_ACCEPTED,
                                    2 * in_bytes + 2 * out_bytes)}
            # the bound with culled evaluations at the cull test's cost,
            # and as counted before (every evaluation at full cost)
            bounds = {k: op_bound(evals, accepted, per, nb, culled=culled)
                      for k, (per, nb) in work.items()}
            print("[kernels] bound ms with culled evaluations at the cull "
                  "test's cost (every evaluation at full cost): " + ", ".join(
                      f"{KERNELS[k][0]} {bounds[k][0]:.4f} "
                      f"({op_bound(evals, accepted, per, nb)[0]:.4f})"
                      for k, (per, nb) in work.items()))
            b1, b3 = bounds["raster_forward_stash"], bounds["raster_forward"]
            b2, b5 = bounds["raster_backward_stash"], bounds["raster_backward"]
            results["raster_forward_stash"] = dict(
                max_abs_err=err1, ms=t_k1, plain_ms=t_p1, bound_ms=b1[0],
                bound_by=b1[1], library_ms=None)
            results["raster_forward"] = dict(
                max_abs_err=err1, ms=t_k3, plain_ms=t_p1, bound_ms=b3[0],
                bound_by=b3[1], library_ms=None)
            results["raster_backward_stash"] = dict(
                max_abs_err=err2, ms=t_k2, plain_ms=t_p2, bound_ms=b2[0],
                bound_by=b2[1], library_ms=None)
            results["raster_backward"] = dict(
                max_abs_err=err5, ms=t_k5, plain_ms=t_p5, bound_ms=b5[0],
                bound_by=b5[1], library_ms=None)
            print(f"[kernels] K5 ms {t_k5:.3f} (plain {t_p5:.1f}, bound "
                  f"{b5[0]:.4f} {b5[1]})")
            print(f"[card] {card_line()}")
            print(f"[kernels] ms: K1 {t_k1:.3f} (plain {t_p1:.1f}, bound "
                  f"{b1[0]:.4f} {b1[1]}), K3 {t_k3:.3f} (bound {b3[0]:.4f}), "
                  f"K2 {t_k2:.3f} (plain {t_p2:.1f}, bound {b2[0]:.4f} "
                  f"{b2[1]}); (pair, pixel) evaluations {evals:.6g}, culled "
                  f"{culled:.6g} (wrongly: {wrong}), accepted {accepted:.6g}")

    # K4 at the reduction's shapes: [R, 24] run totals, pos = run ends of
    # the binning's per-gaussian pair counts, as binning._land calls it
    r = bins.pair_gauss.shape[0]
    acc = torch.as_tensor(rng.normal(size=(r, 24)).astype(np.float32),
                          device=dev)
    pos = torch.clamp(torch.cumsum(bins.counts, 0) - 1, 0, r - 1).to(torch.int32)
    pos_l = pos.long()
    k4 = monotone_row_gather_rows(acc, pos)
    p4 = monotone_row_gather_rows_plain(acc, pos)
    l4 = torch.index_select(acc, 0, pos_l)
    # the JAX contract ([C, R] -> [C, N]) reaches the same kernel
    j4 = monotone_row_gather(acc.T.contiguous(), pos, max_step=d_max)
    torch.cuda.synchronize()
    exact = bool(torch.equal(k4, p4)) and bool(torch.equal(k4, l4)) \
        and bool(torch.equal(j4, k4.T))
    err4 = float((k4 - p4).abs().max())
    # a short kernel: timed in a CUDA graph, without the wrapper's host
    # time between launches
    t_k4 = time_graph_ms(lambda: monotone_row_gather_rows(acc, pos), 50)
    t_p4 = time_graph_ms(lambda: monotone_row_gather_rows_plain(acc, pos), 50)
    t_l4 = time_graph_ms(lambda: torch.index_select(acc, 0, pos_l), 50)
    # bytes the gather must move: each distinct source row read once (a
    # repeated position is served by the cache), every output row written,
    # and the positions
    distinct = int(torch.unique(pos).numel())
    nbytes = (distinct * acc.shape[1] + k4.numel() + pos.numel()) * 4
    b4 = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[kernels] K4 rows: bit-exact against its plain version, "
          f"index_select and the [C, R] contract {exact} (max abs err "
          f"{err4}), ms {t_k4:.5f}, plain {t_p4:.5f}, index_select "
          f"{t_l4:.5f}, bound {b4:.5f} bytes ({distinct} distinct of "
          f"N={pos.numel()} rows, R={r}, C={acc.shape[1]})")
    check(exact, "K4 is not bit-exact")
    results["monotone_row_gather"] = dict(
        max_abs_err=err4, ms=t_k4, plain_ms=t_p4, bound_ms=b4,
        bound_by="bytes", library_ms=t_l4)
    overflow_reduction(gm, cam, opts, bins, rng, dev)
    return results


def overflow_reduction(gm, cam, opts, bins, rng, dev):
    """Phase 2: the reduction decides its branch on the device, so the
    run path (K4's landing) also runs on an overflowing binning, whose
    result torch.where then drops. K4 must hold its plain version there
    too, and the selected result must be the slab reduction's bits; on
    the usual binning, the run path's."""
    import torch

    from gaus_slam_tpu_torch.ops.gather import (
        monotone_row_gather_rows, monotone_row_gather_rows_plain)
    from gaus_slam_tpu_torch.render import bin_full

    n, d_max = gm.params.xyz.shape[0], opts.max_tiles_per_gaussian
    demand = int(bins.demand)
    # a pair budget cut below demand, as tests/test_torch_reduce.py's
    # r_max = 384 case, at this map's width
    tight = opts._replace(pair_cap=max(128, demand // 2))
    with torch.no_grad():
        obins = bin_full(gm.params, gm.active, cam, tight)
    r = obins.pair_gauss.shape[0]
    check(bool(obins.overflow) and int(obins.demand) == demand,
          f"phase 2: a {r}-pair budget under demand {demand} did not "
          f"overflow")
    pos = torch.clamp(torch.cumsum(obins.counts, 0) - 1, 0,
                      r - 1).to(torch.int32)
    acc = torch.as_tensor(rng.normal(size=(r, 24)).astype(np.float32),
                          device=dev)
    k4 = monotone_row_gather_rows(acc, pos)
    p4 = monotone_row_gather_rows_plain(acc, pos)
    g = torch.as_tensor(rng.normal(size=(r, 24)).astype(np.float32),
                        device=dev)
    sel = obins.slab_scatter_grads(g, n, backend=opts.backend)
    zero = torch.zeros((), device=dev)
    slab = obins._slab_reduce(torch.where(obins.pair_ok[:, None], g, zero),
                              n, d_max)
    g_full = torch.as_tensor(rng.normal(
        size=(bins.pair_gauss.shape[0], 24)).astype(np.float32), device=dev)
    sel_full = bins.slab_scatter_grads(g_full, n, backend=opts.backend)
    run_full = bins._run_reduce(
        torch.where(bins.pair_ok[:, None], g_full, zero), n, d_max,
        opts.backend)
    torch.cuda.synchronize()
    k4_same = bool(torch.equal(k4, p4))
    picked = bool(torch.equal(sel, slab)) and bool(torch.equal(sel_full,
                                                              run_full))
    print(f"[kernels] K4 on an overflowing binning (R={r} under demand "
          f"{demand}, N={n}): bit-exact against its plain version {k4_same}; "
          f"the selected reduction is the slab one (overflow) and the run "
          f"one (no overflow), bit for bit: {picked}")
    check(k4_same, "phase 2: K4 is not bit-exact on an overflowing binning")
    check(picked, "phase 2: slab_scatter_grads did not select the slab "
          "reduction under overflow, or the run one without")


# ---------------------------------------------------------------------------
# phases 3 and 3b: the port's Frontend


def center_err(w2c, gt_rel):
    """Camera centre error of an estimated w2c against a relative c2w."""
    est = np.linalg.inv(np.asarray(w2c, np.float64))
    return float(np.linalg.norm(est[:3, 3] - gt_rel[:3, 3]))


def track_ok(err, init_err):
    return err < max(TRACK_GAIN * init_err, T_ERR_ABS)


def drive_frontend(label, cfg, ds, backend, n_frames, dev, strict=True):
    """Stream frames 0 .. n_frames-1 through Frontend.process_frame, then
    process_final, draining the backend queue after every frame. Checks
    every LocalMap and, with ``strict``, every tracked frame (otherwise
    each record carries the check's verdict in "ok"); returns (launches
    of this run, per-frame records, state for the profile, LocalMaps)."""
    import torch

    from gaus_slam_tpu_torch.ops import _cuda
    from gaus_slam_tpu_torch.slam.frontend import Frontend

    to_backend = queue.Queue()
    lms, recs, noop_pass = [], [], []
    sync(dev)
    _cuda.clear_launches()
    fe = Frontend(cfg, to_backend, backend=backend, device=dev)
    for t in range(n_frames):
        color, depth, _, c2w = ds[t]
        # what the frame starts from: the submap's first frame, and the
        # constant-velocity init (the speculative path gives the same value)
        first = fe.local_frames[0].time_idx if fe.local_frames else t
        if fe.local_frames:
            last = fe.local_frames[-1]
            init_w2c = fe.vel @ last._w2c_host
        n_lms = len(lms)
        t0 = time.perf_counter()
        fe.process_frame(t, np.asarray(color, np.float32) / np.float32(255),
                         np.asarray(depth), c2w)
        sync(dev)
        ms = 1e3 * (time.perf_counter() - t0)
        while not to_backend.empty():
            lms.append(to_backend.get())
        cut = len(lms) > n_lms
        kind = "map init" if t == 0 else ("cut" if cut else (
            "keyframe" if fe.local_frames[-1].frame_type == 1 else "tracked"))
        rec = dict(t=t, kind=kind, ms=ms, n_active=fe.n_active_host,
                   submap=fe.cur_lmid - (1 if cut else 0))
        if t > 0:
            gt_rel = np.linalg.inv(np.asarray(ds[first][3], np.float64)) \
                @ np.asarray(c2w, np.float64)
            w2c = lms[-1].frames[-1].est_w2c if cut else \
                fe.local_frames[-1]._w2c_host
            err, init_err = center_err(w2c, gt_rel), center_err(init_w2c, gt_rel)
            # a tracker that never moves its pose keeps the submap's first
            # pose (the constant-velocity prediction from two equal poses)
            noop = center_err(np.eye(4), gt_rel)
            noop_pass.append(track_ok(noop, noop))
            rec.update(err=err, init_err=init_err, ok=track_ok(err, init_err),
                       **fe.last_track)
            check(np.isfinite(rec["loss"]), f"{label} frame {t}: non-finite "
                  f"tracking loss")
            check(rec["ok"] or not strict,
                  f"{label} frame {t}: translation error {err} neither below "
                  f"{TRACK_GAIN} x its constant-velocity init's {init_err} "
                  f"nor within {T_ERR_ABS}")
            print(f"[{label}] frame {t}: {kind}, iters {rec['iters']}, loss "
                  f"{rec['loss']:.4f}, t_err {err:.5f} m (constant-velocity "
                  f"init {init_err:.5f} m, no-op tracker {noop:.5f} m), "
                  f"n_active {rec['n_active']}, {ms:.0f} ms")
        else:
            print(f"[{label}] frame 0: map init, n_active {rec['n_active']}, "
                  f"{ms:.0f} ms")
        recs.append(rec)
    state = dict(fe=fe, frame=fe.local_frames[-1],
                 pose=fe.local_frames[-1].pose,
                 gt=fe._tile_gt(fe.local_frames[-1]))
    fe.process_final()
    while not to_backend.empty():
        lms.append(to_backend.get())
    sync(dev)
    launches = dict(_cuda.fold_launches())
    check(not all(noop_pass), f"{label}: the tracking check passes a "
          f"tracker that never moves its pose")
    for lm in lms:
        keep = min(fe.num_frame_saved, len(lm.frames) - 1)
        kept = [i for i, f in enumerate(lm.frames) if f.gt_color is not None]
        check(all(f.pose is None and np.isfinite(f.est_w2c).all()
                  for f in lm.frames), f"{label}: LocalMap {lm.lmid} holds a "
              f"live or non-finite pose")
        check(lm.map_desc is not None and lm.map_desc.shape == (2, 256)
              and np.isfinite(lm.map_desc).all(),
              f"{label}: LocalMap {lm.lmid} has no descriptor")
        check(len(lm.saved_idxs) == keep and sorted(lm.saved_idxs) == kept,
              f"{label}: LocalMap {lm.lmid} keeps {kept}, not "
              f"{keep} frames {lm.saved_idxs}")
    for lm in lms:
        errs = [r["err"] for r in recs if r.get("submap") == lm.lmid
                and "err" in r]
        rmse = float(np.sqrt(np.mean(np.square(errs)))) if errs else 0.0
        print(f"[{label}] submap {lm.lmid}: frames "
              f"{lm.frames[0].time_idx}-{lm.frames[-1].time_idx}, kept "
              f"{sorted(lm.saved_idxs)}, n_active "
              f"{int(lm.map_params[2])}, t_err RMSE {rmse:.5f} m")
    print(f"[{label}] kernels {json.dumps(launches)}")
    return launches, recs, state, lms


def phase_frontend(cfg, ds, dev):
    """Phase 3: the Frontend on the stash kernels, through >= two cuts."""
    launches, recs, state, lms = drive_frontend(
        "frontend", cfg, ds, "pallas", N_FRAMES, dev)
    cuts = sum(r["kind"] == "cut" for r in recs)
    check(cuts >= 2, f"phase 3 cut {cuts} submaps, not at least 2")
    for name in STASH_PATH:
        check(launches.get(name, 0) > 0, f"{name} never launched in phase 3")
    now = {r["t"]: (r["iters"], f"{r['loss']:.4f}") for r in recs if r["t"]}
    differ = {t: (now.get(t), v) for t, v in PARENT_PHASE3.items()
              if now.get(t) != v}
    print(f"[frontend] iterations and losses per frame equal the earlier "
          f"code's: {not differ}; differing (now, then): {differ}")
    check(not differ, f"phase 3: iterations or losses moved from the "
          f"earlier code's: {differ}")
    return launches, recs, state, lms


def phase_reference(ds, dev):
    """Phase 3b: the Frontend under the reference render backend, which
    tracks at full resolution only (no coarse phase, as in the JAX
    package). A control run drives the stash kernels through the same
    schedule (coarse_iters 0, coarse mapping stride 1) over the same
    frames. A reference frame passes the tracking check, or fails it only
    where the control fails it too and then ends within ATE_JAX of the
    control's error."""
    cfg, _ = load_config()
    cfg["tpu"]["coarse_map_stride"] = 1
    launches, recs, _, _ = drive_frontend(
        "reference", cfg, ds, "reference", N_FRAMES_REF, dev, strict=False)
    check(launches.get("raster_backward", 0) > 0,
          "K5 never launched in phase 3b")
    for name in STASH_PATH + ("while_cond",):
        check(launches.get(name, 0) == 0,
              f"{name} launched under the reference backend")
    ctl_cfg, _ = load_config()
    ctl_cfg["tpu"]["coarse_map_stride"] = 1
    ctl_cfg["frontend"].update(coarse_iters=0, coarse_levels=[])
    _, ctl, _, _ = drive_frontend("control", ctl_cfg, ds, "pallas",
                                  N_FRAMES_REF, dev, strict=False)
    for r, c in zip(recs[1:], ctl[1:]):
        ok = r["ok"] or (not c["ok"] and r["err"] <= c["err"] + ATE_JAX)
        print(f"[reference] frame {r['t']}: t_err {r['err']:.5f} m, control "
              f"(stash kernels, same schedule) {c['err']:.5f} m; tracking "
              f"check {r['ok']} / control {c['ok']} -> "
              f"{'pass' if ok else 'FAIL'}")
        check(ok, f"reference frame {r['t']}: t_err {r['err']} fails the "
              f"tracking check, and the control's {c['err']} "
              f"(check {c['ok']}) does not account for it")
    return launches, recs


def frame_times(label, recs):
    """Median wall ms per kind of frame (first-use costs of frame 0 and
    of the first frame of each kind included in the list)."""
    out = {}
    for kind in ("map init", "tracked", "keyframe", "cut"):
        ms = [r["ms"] for r in recs if r["kind"] == kind]
        if ms:
            out[kind] = (float(np.median(ms)), len(ms))
    print(f"[{label}] wall ms per frame (median, count): "
          + ", ".join(f"{k} {v[0]:.0f} ({v[1]})" for k, v in out.items()))
    return out


# ---------------------------------------------------------------------------
# phase 4 (after the counts were read): where a tracking and a mapping
# iteration spend their time


def phase_profile(st):
    """torch.profiler over 3 full-resolution tracking iterations and one
    2-iteration mapping group on phase 3's final map and frame
    (tools/sync_audit.py::profile_window): device busy time (sum of
    kernel times), the host wall time around it, the busiest device ops,
    and the host's time in CUDA calls that wait for the card. Prints 'not
    measured' where the profiler sees no device time."""
    import torch

    from gaus_slam_tpu_torch.render import bin_for_tracking
    from gaus_slam_tpu_torch.slam.steps import mapping_loop, tracking_loop
    from gaus_slam_tpu_torch.tools.sync_audit import profile_window

    fe, pose, gt = st["fe"], st["pose"], st["gt"]
    s = fe.sys
    cam, opts, gm = s.cam, s.opts, fe.map
    cache = bin_for_tracking(gm, cam.replace_w2c(pose.w2c), opts)
    tc = s.track_front._replace(num_iters=3, coarse_iters=0, converged_th=-1.0)

    def track():
        tracking_loop(cache, pose, gt, cam, opts, tc, s.lcfg)

    w2cs = torch.stack([pose.w2c])
    gts = gt[None]

    def mapping():
        mapping_loop(gm, w2cs, gts, cam, opts, s.mcfg, s.lcfg,
                     rebin_every=2, coarse_stride=fe.coarse_map_stride)

    for label, fn in (("tracking, 3 full-res iterations", track),
                      ("mapping, 1 group of 2 iterations", mapping)):
        fn()
        torch.cuda.synchronize()
        w = profile_window(fn)
        print(f"[profile] {label}: host waits {w['wait_ms']:.3f} ms (stream "
              f"synchronizes and synchronous copies); by call (ms, count) "
              f"{json.dumps(w['waits'])}")
        if w["busy"] <= 0:
            print(f"[profile] {label}: wall {w['wall']:.1f} ms, device time "
                  f"not measured (the profiler saw none)")
            continue
        print(f"[profile] {label}: wall {w['wall']:.1f} ms, device busy "
              f"{w['busy']:.1f} ms, idle share "
              f"{1 - w['busy'] / w['wall']:.2f}; top: "
              + "; ".join(f"{k[:60]} x{n} {ms:.2f} ms"
                          for ms, n, k in w["top"]))


def phase_no_sync(dev, card):
    """Phase 4b: no host wait inside a step. tools/sync_audit.py's four
    steps at 340x600 (a Frontend over frames 0-10, a Backend that merged
    the first submap): tracking_loop with the config's converged_th, the
    frontend's mapping_step, a Backend.process() that runs a fused x4
    mapping batch and a sharded_ba_step over four slots of this card,
    each run once, then once under torch.cuda.set_sync_debug_mode
    ("error"): a stream synchronize, a blocking copy or a read of a
    device value inside fails the phase. The tracking loop is one loop
    program (its early exit decided on the card): its host waits must
    be 0."""
    from gaus_slam_tpu_torch.tools import sync_audit

    st = sync_audit.build_state(H, W, dev)
    res, aux = sync_audit.audit(st, "error")
    sync_audit.report(res)
    iters = int(aux["iters"])
    print(f"[no_sync] {card}: tracking_loop (converged_th "
          f"{st['fe'].sys.track_front.converged_th}), one loop program: "
          f"{iters} iterations, {aux['host_waits']} host waits; flagged "
          f"calls per step { {k: len(v) for k, v in res.items()} }")
    check(aux["host_waits"] == 0, f"phase 4b: the tracking loop waited "
          f"{aux['host_waits']} times on the host")
    for name, found in res.items():
        if found:
            check(False, f"phase 4b: {name} made the host wait: {found[0]}")


# ---------------------------------------------------------------------------
# phases 5 and 6: the port's driver


def out_dir(name):
    return os.path.join(REPO, "output", "chip_smoke", name)


class DriverProbe:
    """Wraps the driver's Backend.process_localmap, Backend.process,
    Frontend.process_frame and eval_final for one run: launches inside
    every merge and inside eval_final (the counts zeroed just before each
    and read just after, then added back to the run's total), wall ms per
    backend task by kind (a device sync after each task), the merges and
    the frame loop's and eval_final's wall time."""

    def __init__(self, sync_tasks=True):
        """``sync_tasks``: a device sync after each backend task, to time
        it; off for the pipelined driver, whose backend work must stay
        queued beside the frontend's. Then the tasks are counted by
        whether the frontend had taken its last frame
        (Frontend.process_final) when they drained."""
        import collections

        self.sync_tasks = sync_tasks
        self.drained = collections.Counter()
        self.last_frame_in = False
        self.inside = {"backend": collections.Counter(),
                       "eval": collections.Counter(),
                       "mesh": collections.Counter(),
                       "tracking": collections.Counter()}
        # the frames' summed device iteration counts (Frontend.last_track)
        self.track_iters = 0
        # wall ms of the checkpoint writes / restores, LPIPS calls, TSDF
        # integrations (one per fused view) and extractions, and whole
        # fuse_render_mesh calls
        self.ms = collections.defaultdict(list)
        self.tasks = collections.defaultdict(list)
        self.merges = []
        self.t_loop = self.t_eval = None
        self.eval_s = 0.0
        self.backend = None
        # keyframe tests: (frame, low-alpha pixels, threshold hw * tau_k)
        self.kf_tests = []

    def _counted(self, where, fn, *a, fold=False, **kw):
        """``fn`` with the launches inside it counted apart; ``fold``: the
        loop programs' device tallies folded in before and after (a device
        sync each; never in a window whose work stays queued)."""
        from gaus_slam_tpu_torch.ops import _cuda

        if fold:
            _cuda.fold_launches()
        saved = dict(_cuda.LAUNCHES)
        _cuda.LAUNCHES.clear()
        try:
            return fn(*a, **kw)
        finally:
            if fold:
                _cuda.fold_launches()
            inside = dict(_cuda.LAUNCHES)
            self.inside[where].update(inside)
            _cuda.LAUNCHES.clear()
            _cuda.LAUNCHES.update(saved)
            _cuda.LAUNCHES.update(inside)

    def _timed(self, key, fn):
        import torch

        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                self.ms[key].append(1e3 * (time.perf_counter() - t0))
        return wrapped

    def __enter__(self):
        import torch

        from gaus_slam_tpu_torch.slam import backend as B
        from gaus_slam_tpu_torch.slam import frontend as F
        from gaus_slam_tpu_torch.utils import checkpoint as C
        from gaus_slam_tpu_torch.utils import eval as E
        from gaus_slam_tpu_torch.utils import eval_mesh as M
        from gaus_slam_tpu_torch.utils import tsdf as T

        self._orig = (B.Backend.process_localmap, B.Backend.process,
                      F.Frontend.process_frame, E.eval_final,
                      F.Frontend.tracking, F.Frontend.process_final)
        self._timed_orig = [(o, n, getattr(o, n)) for o, n in (
            (C, "save_run_state"), (C, "restore_run_state"), (E, "lpips"),
            (M, "fuse_render_mesh"), (T.TSDFVolume, "integrate"),
            (T.TSDFVolume, "extract_mesh"))]
        merge, process, frame, ev, track, final = self._orig
        probe = self
        for owner, name, fn in self._timed_orig:
            timed = self._timed(name, fn)
            if name == "fuse_render_mesh":
                timed = (lambda t: lambda *a, **kw: probe._counted(
                    "mesh", t, *a, **kw))(timed)
            setattr(owner, name, timed)

        def tracking(fe, frame_, **kw):
            # counted apart in the synchronous driver only: the folds'
            # device syncs would hold the pipelined driver's frontend
            # behind the backend's queued work
            r = (probe._counted("tracking", track, fe, frame_, fold=True,
                                **kw) if probe.sync_tasks
                 else track(fe, frame_, **kw))
            probe.track_iters += fe.last_track["iters"]
            if r[2] is not None:
                s = fe.sys
                hw = s.cam.height * s.cam.width
                pad = s.opts.grid.num_tiles * s.opts.grid.pixels_per_tile - hw
                probe.kf_tests.append((frame_.time_idx, float(r[2]) - pad,
                                       hw * fe.tau_k))
            return r

        def process_localmap(be, lm, multi_process=False):
            probe.backend = be
            first = be.cur_lmid < 0
            frames = [f.time_idx for f in lm.frames]
            n0, donors = be.n_active_host, lm.n_active_host
            # the synchronous driver folds the device tallies around a
            # merge (its IF nodes' branches, K4 among them)
            probe._counted("backend", merge, be, lm, multi_process,
                           fold=probe.sync_tasks)
            # the host mirror: exact after the drain's prune
            probe.merges.append(dict(lmid=lm.lmid, first=first,
                                     frames=[frames[0], frames[-1]],
                                     covis=list(be.covis_idxs), before=n0,
                                     donors=donors, after=be.n_active_host))

        def process_(be):
            q = be.task_queue
            kind = q[0][0] if q else "idle"
            n0 = len(q)
            t0 = time.perf_counter()
            if probe.sync_tasks:
                process(be)
            else:
                probe._counted("backend", process, be)
            n = n0 - len(q)
            if not probe.sync_tasks:
                probe.drained["after the last frame" if probe.last_frame_in
                              else "beside the frames"] += n
                return
            torch.cuda.synchronize()
            if kind == "mapping" and n == be.MAP_BATCH:
                kind = "mapping (fused x4)"
            probe.tasks[kind].append(1e3 * (time.perf_counter() - t0))

        def process_frame(fe, *a, **kw):
            if probe.t_loop is None:
                probe.t_loop = time.perf_counter()
            return frame(fe, *a, **kw)

        def process_final(fe):
            probe.last_frame_in = True
            return final(fe)

        def eval_final(*a, **kw):
            torch.cuda.synchronize()
            probe.t_eval = time.perf_counter()
            res = probe._counted("eval", ev, *a, **kw)
            torch.cuda.synchronize()
            probe.eval_s = time.perf_counter() - probe.t_eval
            return res

        B.Backend.process_localmap = process_localmap
        B.Backend.process = process_
        F.Frontend.process_frame = process_frame
        F.Frontend.tracking = tracking
        F.Frontend.process_final = process_final
        E.eval_final = eval_final
        return self

    def __exit__(self, *exc):
        from gaus_slam_tpu_torch.slam import backend as B
        from gaus_slam_tpu_torch.slam import frontend as F
        from gaus_slam_tpu_torch.utils import eval as E

        (B.Backend.process_localmap, B.Backend.process,
         F.Frontend.process_frame, E.eval_final,
         F.Frontend.tracking, F.Frontend.process_final) = self._orig
        for owner, name, fn in self._timed_orig:
            setattr(owner, name, fn)
        return False


def run_driver(label, env, dev, edit=None, resume_from=None,
               pipelined=False):
    """rgbd_slam on configs/synthetic/config.py with ``env`` (SYN_*) and
    ``edit(config)`` applied, the stash kernels, output under
    output/chip_smoke/<label>; ``pipelined``: scripts/gaus_mp.py's
    rgbd_slam in place of scripts/gaus.py's. Returns (result, launches of
    the whole run, DriverProbe, seconds, out dir)."""
    import shutil

    import torch

    from gaus_slam_tpu_torch.ops import _cuda
    from gaus_slam_tpu_torch.scripts import gaus, gaus_mp

    rgbd_slam = (gaus_mp if pipelined else gaus).rgbd_slam

    out = out_dir(label)
    shutil.rmtree(out, ignore_errors=True)
    cfg = config_from_env(dict(env, SYN_OUT=out))
    if edit is not None:
        edit(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.clear_launches()
    t0 = time.perf_counter()
    with DriverProbe(sync_tasks=not pipelined) as probe:
        result = rgbd_slam(cfg, backend="pallas", device=dev,
                           resume_from=resume_from)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_cuda.fold_launches())
    print(f"[{label}] result {json.dumps(result)}")
    print(f"[{label}] kernels {json.dumps(launches)}; inside the backend "
          f"{json.dumps(dict(probe.inside['backend']))}; inside eval_final "
          f"{json.dumps(dict(probe.inside['eval']))}")
    for name in ("result.json", "time.json", "scene/gaussians.ply",
                 "scene/w2cs.npz.npy"):
        check(os.path.exists(os.path.join(out, name)),
              f"{label}: the driver wrote no {name}")
    return result, launches, probe, secs, out


def small_bounds_failed(label, result, bounds=None):
    """Prints each bound of ``bounds`` (SMALL_BOUNDS); returns the keys it
    fails."""
    failed = []
    for key, (op, bound) in (bounds or SMALL_BOUNDS).items():
        v = result[key]
        ok = np.isfinite(v) and (v < bound if op == "<" else v > bound)
        print(f"[{label}] {key} {v:.6g} (bound {op} {bound}): "
              f"{'pass' if ok else 'FAIL'}")
        if not ok:
            failed.append(key)
    return failed


def phase_driver_small(dev, label="driver_48x64", bounds=None, edit=None,
                       seed=0):
    """Phase 5: the driver at 48x64 over 12 frames against the bounds of
    tests/test_full_slam.py (phase 9b: ``edit`` sets the 3DGS ablation
    and ``bounds`` are the JAX package's in that configuration). The seed-0 schedule's keyframe test at frame
    9 sits within 3 pixels of its threshold (the port counts 156
    low-alpha pixels on the CPU and 153 on the card, the JAX package 155,
    against 153.6), so float32 rounding decides it, and without that keyframe
    the last frames render from a map that never saw them, in the JAX
    package as in the port (PERF.md, section 6). So a run that fails the
    bounds passes only if a keyframe test sat within KF_MARGIN of its
    threshold and a control run, with tau_k moved just across that one
    count so the frame takes the other decision, clears every bound.
    ``seed``: the config's SEED (phase 12c reruns a spread seed here)."""
    env = dict(SMALL, SEED=str(seed))
    result, launches, probe, secs, _ = run_driver(label, env, dev, edit=edit)
    print(f"[{label}] {secs:.1f} s; keyframe tests (frame, low-alpha "
          f"pixels, threshold): {probe.kf_tests}")
    if not small_bounds_failed(label, result, bounds):
        return launches
    near = [k for k in probe.kf_tests if abs(k[1] - k[2]) <= KF_MARGIN * k[2]]
    check(near, f"{label} fails the bounds, and no keyframe test sat within "
          f"{KF_MARGIN:.0%} of its threshold")
    t, n_low, thr = min(near, key=lambda k: abs(k[1] - k[2]))
    hw = int(SMALL["SYN_H"]) * int(SMALL["SYN_W"])
    tau = (n_low + (0.5 if n_low > thr else -0.5)) / hw
    print(f"[{label}] frame {t}'s keyframe test counted {n_low:.0f} "
          f"against {thr:.1f}; control: tau_k {tau:.6f}, so that frame "
          f"takes the other decision")
    ctl, _, ctl_probe, _, _ = run_driver(
        f"{label}_control", dict(env, SYN_TAU_K=repr(tau)), dev, edit=edit)
    print(f"[{label}_control] keyframe tests: {ctl_probe.kf_tests}")
    check(not small_bounds_failed(f"{label}_control", ctl, bounds),
          f"{label}: the control run with frame {t}'s borderline keyframe "
          f"decision reversed fails the bounds too")
    return launches


def phase_driver_full(dev, label="driver_340x600", edit=None, suffix="",
                      psnr_min=PSNR_MIN):
    """Phase 6: the driver at 340x600 over the config's 30 frames (phase
    9b: ``edit`` sets the 3DGS ablation; phase 11b: the bf16 compute
    dtype, whose K1-K3 launch under the names with ``suffix``, with its
    own first-submap PSNR bound ``psnr_min``)."""
    import torch

    result, launches, probe, secs, out = run_driver(
        label, dict(SYN_H=str(H), SYN_W=str(W)), dev, edit=edit)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(out, "time.json")) as f:
        times = json.load(f)
    n_frames = int(config_from_env({})["data"]["num_frames"])
    loop_s = probe.t_eval - probe.t_loop
    probe.fps = n_frames / loop_s
    be = probe.backend
    print(f"[{label}] {n_frames} frames, frame loop (backend drains, "
          f"final merge and refine included) {loop_s:.2f} s: "
          f"{n_frames / loop_s:.3f} frames/s; time.json {json.dumps(times)}")
    print(f"[{label}] merges {len(probe.merges)} "
          f"{json.dumps(probe.merges)}, capacity-bucket flips "
          f"{be.bucket_flips}, backend capacity {be.map.capacity}, pair "
          f"factor {be.sys.opts.pair_budget_factor}")
    print(f"[{label}] backend ms per task (median, mean, count): "
          + "; ".join(f"{k} {np.median(v):.1f} {np.mean(v):.1f} {len(v)}"
                      for k, v in sorted(probe.tasks.items())))
    print(f"[{label}] eval_final {probe.eval_s:.2f} s, "
          f"{1e3 * probe.eval_s / n_frames:.1f} ms per frame; peak device "
          f"memory {peak:.2f} GiB; whole run {secs:.1f} s")
    # every tracking iteration that ran launched K1 and K2 once, and no
    # other did (no iteration queued past the stop)
    k1, k2 = (probe.inside["tracking"].get(n + suffix, 0)
              for n in ("raster_forward_stash", "raster_backward_stash"))
    print(f"[{label}] the frontend's tracking loops launched K1 {k1} and "
          f"K2 {k2} times; the frames' summed device iteration counts "
          f"{probe.track_iters}; K1 / K2 over the whole run "
          f"{launches.get('raster_forward_stash' + suffix, 0)} / "
          f"{launches.get('raster_backward_stash' + suffix, 0)}")
    check(k1 == k2 == probe.track_iters > 0,
          f"{label}: the tracking loops launched K1 {k1} and K2 {k2} times "
          f"for {probe.track_iters} iterations")
    print(f"[{label}] K4 launches over the whole run "
          f"{launches.get('monotone_row_gather', 0)} (PR 15: 240, K4 in "
          f"every captured reduction; now once per run branch taken), "
          f"inside the backend {probe.inside['backend'].get('monotone_row_gather', 0)}; "
          f"if_cond {launches.get('if_cond', 0)}")
    check(probe.inside["tracking"].get("while_cond", 0) > 0,
          f"{label}: while_cond never launched in the tracking loops")
    check(len(probe.merges) == 3, f"{label} merged {len(probe.merges)} "
          f"submaps, not 3")
    later = [m for m in probe.merges if not m["first"]]
    check(len(later) == 2 and all(m["covis"] for m in later),
          f"{label}: the later merges retrieved no covisible submaps")
    for kind in ("mapping (fused x4)", "prune", "tracking"):
        check(probe.tasks.get(kind), f"{label} ran no {kind} task")
    for name in ("raster_forward_stash" + suffix,
                 "raster_backward_stash" + suffix, "monotone_row_gather"):
        check(probe.inside["backend"].get(name, 0) > 0,
              f"{label}: {name} never launched inside the backend")
    check(probe.inside["eval"].get("raster_forward" + suffix, 0) > 0,
          f"{label}: raster_forward{suffix} never launched inside "
          f"eval_final")
    ate = result["ATE RMSE"]
    print(f"[{label}] ATE RMSE {ate:.6g} (bound < {T_ERR_ABS}): "
          f"{'pass' if ate < T_ERR_ABS else 'FAIL'}")
    check(np.isfinite(ate) and ate < T_ERR_ABS,
          f"{label}: ATE RMSE {ate} not < {T_ERR_ABS}")
    # PSNR over the first submap's frames. On this 30-frame schedule the
    # synchronous driver's later merges lose their donors to the prune
    # task, in the JAX package as in the port: they enter at opacity 0.01
    # and the pre-prune mapping tasks leave them under the 0.05 cull
    # (PERF.md, section 6), so the later frames render from the first
    # submap's map alone
    psnrs = np.loadtxt(os.path.join(out, "psnr.txt"))
    # a submap owns its frames but the last, which opens the next submap;
    # the last submap owns its last frame too
    owned = [(m["lmid"], psnrs[m["frames"][0]:m["frames"][1]
                               + (m is probe.merges[-1])])
             for m in probe.merges]
    own = owned[0][1]
    print(f"[{label}] PSNR {result['PSNR']:.6g} over all frames; mean "
          f"by submap {[(i, round(float(p.mean()), 3)) for i, p in owned]}; "
          f"over the first submap's {len(own)} frames {own.mean():.6g} "
          f"(bound > {psnr_min}): "
          f"{'pass' if own.mean() > psnr_min else 'FAIL'}")
    check(np.isfinite(own).all() and own.mean() > psnr_min,
          f"{label}: PSNR {own.mean()} over the first submap's frames "
          f"not > {psnr_min}")
    if label in PARENT_DRIVER:
        got = (f"{ate:.6g}", f"{own.mean():.6g}")
        print(f"[{label}] ATE RMSE and first-submap PSNR {got}, the earlier "
              f"code's {PARENT_DRIVER[label]}")
        check(got == PARENT_DRIVER[label], f"{label}: ATE / PSNR {got} "
              f"moved from the earlier code's {PARENT_DRIVER[label]}")
    return launches, probe


# ---------------------------------------------------------------------------
# phase 8: from disk, checkpoint and resume, mesh and LPIPS


N_FRAMES_DISK = 12     # one cut, at frame 10 (submaps of 10 frames)
SEQ = "synthetic_seed0"


def disk_data(root):
    """The config's data section for the ReplicaV2 tree under root."""
    return dict(dataset_name="replicav2", basedir=root, sequence=SEQ,
                gradslam_data_cfg=os.path.join(root,
                                               "replica_v2_synthetic.yaml"),
                desired_image_height=H, desired_image_width=W, start=0,
                end=-1, stride=1, num_frames=N_FRAMES_DISK)


def write_disk_scene(root, n):
    """The synthetic scene's first n frames (seed 0) as a ReplicaV2 tree
    under root (rgb/rgb_%04d.png, depth/depth_%04d.png in millimetres,
    traj_w_c.txt) through utils/png.py, and a camera profile beside it.
    Returns (profile path, [(color u8, depth u16)])."""
    import shutil

    from gaus_slam_tpu_torch.data.synthetic import SyntheticDataset
    from gaus_slam_tpu_torch.utils import yaml_lite
    from gaus_slam_tpu_torch.utils.png import write_png

    shutil.rmtree(root, ignore_errors=True)
    d = os.path.join(root, SEQ, "imap", "00")
    os.makedirs(os.path.join(d, "rgb"))
    os.makedirs(os.path.join(d, "depth"))
    # the trajectory the driver streams: its speed depends on the
    # sequence length, which the config sets to num_frames_total
    cfg = config_from_env(dict(SYN_H=str(H), SYN_W=str(W),
                               SYN_FRAMES=str(n)))
    ds = SyntheticDataset(height=H, width=W, seed=0,
                          num_frames=cfg["data"]["num_frames_total"])
    frames, poses = [], []
    for i in range(n):
        color, depth, _, c2w = ds[i]
        c8 = np.clip(np.round(color), 0, 255).astype(np.uint8)
        depth = np.asarray(depth)
        depth = depth[..., 0] if depth.ndim == 3 else depth
        d16 = np.round(depth * 1000.0).astype(np.uint16)
        write_png(os.path.join(d, "rgb", f"rgb_{i:04d}.png"), c8)
        write_png(os.path.join(d, "depth", f"depth_{i:04d}.png"), d16)
        frames.append((c8, d16))
        poses.append(np.asarray(c2w, np.float64).ravel())
    np.savetxt(os.path.join(d, "traj_w_c.txt"), poses, fmt="%.17g")
    k = ds.intrinsics
    cam = dict(image_height=H, image_width=W, fx=float(k[0, 0]),
               fy=float(k[1, 1]), cx=float(k[0, 2]), cy=float(k[1, 2]),
               png_depth_scale=1000.0, crop_edge=0)
    prof = disk_data(root)["gradslam_data_cfg"]
    with open(prof, "w") as f:
        f.write("# the synthetic scene's camera, ReplicaV2 layout\n"
                "dataset_name: replicav2\ncamera_params:\n"
                + "".join(f"  {key}: {v!r}\n" for key, v in cam.items()))
    parsed = yaml_lite.load(prof)
    check(parsed == {"dataset_name": "replicav2", "camera_params": cam},
          f"phase 8: yaml_lite read the profile as {parsed}")
    return prof, frames


def lpips_weights(path, seed=0):
    """Random AlexNet-LPIPS weights in the export schema (numpy seed):
    the LPIPS value only proves the path."""
    from gaus_slam_tpu_torch.utils.lpips import ALEX_CFG

    rng = np.random.default_rng(seed)
    w, in_ch = {}, 3
    for i, (oc, k, _, _) in enumerate(ALEX_CFG):
        w[f"conv{i}_w"] = rng.normal(0, 0.1, (oc, in_ch, k, k)).astype(
            np.float32)
        w[f"conv{i}_b"] = rng.normal(0, 0.1, (oc,)).astype(np.float32)
        w[f"lin{i}_w"] = rng.uniform(0, 1, (oc,)).astype(np.float32)
        in_ch = oc
    np.savez(path, **w)


def disk_run_checks(label, result, launches, probe, out, first):
    """The bounds of phase 6 and the mesh, LPIPS and launch checks of one
    phase-8 driver run; ``first``: the first submap's [first, last] frame
    (its last opens the next submap). Returns the first submap's PSNR."""
    ate = result["ATE RMSE"]
    psnrs = np.loadtxt(os.path.join(out, "psnr.txt"))
    own = psnrs[first[0]:first[1]]
    f, prec, rec = (result.get(k) for k in
                    ("Mesh F-score", "Mesh precision", "Mesh recall"))
    print(f"[{label}] ATE RMSE {ate:.6g} (bound < {T_ERR_ABS}); PSNR "
          f"{result['PSNR']:.6g} over all frames, {own.mean():.6g} over the "
          f"first submap's {len(own)} (bound > {PSNR_MIN}); mesh F-score "
          f"{f} precision {prec} recall {rec}; LPIPS {result['LPIPS']}")
    print(f"[{label}] launches inside fuse_render_mesh "
          f"{json.dumps(dict(probe.inside['mesh']))}")
    check(np.isfinite(ate) and ate < T_ERR_ABS,
          f"phase 8 ({label}): ATE RMSE {ate} not < {T_ERR_ABS}")
    check(len(own) > 0 and np.isfinite(own).all() and own.mean() > PSNR_MIN,
          f"phase 8 ({label}): PSNR {own.mean()} over the first submap's "
          f"frames not > {PSNR_MIN}")
    # eval_final keeps the JAX package's try around the mesh evaluation:
    # a failure there prints and leaves these keys out
    check(isinstance(f, float) and 0.0 < f <= 1.0,
          f"phase 8 ({label}): mesh F-score {f!r} not in (0, 1]: the mesh "
          f"evaluation failed")
    check(np.isfinite(result["LPIPS"]),
          f"phase 8 ({label}): LPIPS {result['LPIPS']} is not finite")
    for name in STASH_PATH:
        check(launches.get(name, 0) > 0,
              f"phase 8 ({label}): {name} never launched in the driver")
    check(probe.inside["mesh"].get("raster_forward", 0) > 0,
          f"phase 8 ({label}): K3 never launched inside fuse_render_mesh")
    return own


def phase_disk(dev, card):
    """Phase 8: the driver from a ReplicaV2 tree on disk, with checkpoints,
    mesh evaluation and LPIPS, resumed from its checkpoint; then the
    port's eval and vis_final scripts on the saved scene."""
    import collections

    import torch

    from gaus_slam_tpu_torch.data import basedataset as B
    from gaus_slam_tpu_torch.data import get_dataset
    from gaus_slam_tpu_torch.scripts import eval as eval_script
    from gaus_slam_tpu_torch.scripts import vis_final
    from gaus_slam_tpu_torch.utils.png import read_png

    root = out_dir("disk_data")
    _, frames = write_disk_scene(root, N_FRAMES_DISK)
    data = disk_data(root)
    ds = get_dataset(data)
    check(len(ds) == N_FRAMES_DISK, f"phase 8: {len(ds)} frames on disk")
    t0 = time.perf_counter()
    loaded = [ds[i] for i in range(len(ds))]
    load_ms = 1e3 * (time.perf_counter() - t0) / len(ds)
    t0 = time.perf_counter()
    raw = [(read_png(c), read_png(d))
           for c, d in zip(ds.color_paths, ds.depth_paths)]
    png_ms = 1e3 * (time.perf_counter() - t0) / len(ds)
    for i, ((c8, d16), (color, depth, _, _), (c_png, d_png)) in enumerate(
            zip(frames, loaded, raw)):
        check(np.array_equal(color, c8.astype(np.float32))
              and np.array_equal(depth[..., 0],
                                 d16.astype(np.float32) / 1000.0)
              and np.array_equal(c_png, c8) and np.array_equal(d_png, d16),
              f"phase 8: frame {i} does not read back as written")
    reader = ("cv2" if B.cv2 is not None else
              "imageio" if B.imageio is not None else "utils/png.py")

    weights = os.path.join(root, "lpips_random.npz")
    lpips_weights(weights)
    old_env = os.environ.get("LPIPS_WEIGHTS")
    os.environ["LPIPS_WEIGHTS"] = weights

    def edit(cfg):
        cfg["data"] = dict(data)
        cfg["backend"]["save_ckpt"] = True
        cfg["eval"]["eval_mesh"] = True

    env = dict(SYN_H=str(H), SYN_W=str(W), SYN_FRAMES=str(N_FRAMES_DISK))
    try:
        result, launches, probe, secs, out = run_driver(
            "disk", env, dev, edit=edit)
        first = probe.merges[0]["frames"]
        own = disk_run_checks("disk", result, launches, probe, out, first)
        ckpt = os.path.join(out, "ckpt")
        with open(os.path.join(ckpt, "meta.json")) as f:
            meta = json.load(f)
        check(meta["next_frame_idx"] == 11 and len(meta["localmaps"]) == 1,
              f"phase 8: the checkpoint is at frame "
              f"{meta['next_frame_idx']} with {len(meta['localmaps'])} "
              f"submaps, not the first cut's (frame 11, 1 submap)")
        resumed, r_launches, r_probe, r_secs, r_out = run_driver(
            "disk_resumed", env, dev, edit=edit, resume_from=ckpt)
        check(len(r_probe.ms["restore_run_state"]) == 1,
              "phase 8: the resumed run restored no checkpoint")
        check(r_probe.merges and r_probe.merges[0]["lmid"] == 1,
              "phase 8: the resumed run did not continue from the second "
              "submap")
        disk_run_checks("disk_resumed", resumed, r_launches, r_probe, r_out,
                        first)

        # the port's scripts on the first run's saved scene
        scene = os.path.join(out, "scene")
        with open(os.path.join(out, "result.json")) as f:
            want = json.load(f)["PSNR"]
        t0 = time.perf_counter()
        kind = torch.device(dev).type
        again = eval_script.main([scene, "--device", kind])
        eval_s = time.perf_counter() - t0
        print(f"[disk] scripts/eval.py on the saved scene: PSNR "
              f"{again['PSNR']:.8g} against result.json's {want:.8g} "
              f"({eval_s:.1f} s)")
        check(abs(again["PSNR"] - want) <= 1e-4,
              f"phase 8: scripts/eval.py gives PSNR {again['PSNR']}, "
              f"result.json {want}")
        vis_mesh = collections.Counter()
        from gaus_slam_tpu_torch.ops import _cuda
        _cuda.clear_launches()
        written = vis_final.main([scene, "--device", kind, "--num_views",
                                  "4", "--mesh"])
        torch.cuda.synchronize()
        vis_mesh.update(_cuda.fold_launches())
        check(len(written) == 5 and all(os.path.exists(p) for p in written),
              f"phase 8: scripts/vis_final.py wrote {written}")
        check(vis_mesh.get("raster_forward", 0) > 0,
              "phase 8: K3 never launched in scripts/vis_final.py")
    finally:
        if old_env is None:
            os.environ.pop("LPIPS_WEIGHTS", None)
        else:
            os.environ["LPIPS_WEIGHTS"] = old_env

    ms = probe.ms
    views = len(ms["integrate"])
    fuse = sum(ms["fuse_render_mesh"])
    extract = sum(ms["extract_mesh"])
    print(f"[disk] {card}: {load_ms:.3f} ms per loaded frame ({W}x{H} PNG "
          f"color + depth read by {reader}; utils/png.py alone "
          f"{png_ms:.3f} ms); "
          f"checkpoint write {ms['save_run_state']} ms, restore "
          f"{r_probe.ms['restore_run_state']} ms; fusion "
          f"{(fuse - extract) / max(views, 1):.2f} ms per view over {views} "
          f"views (render, readback and TSDF integrate; the integrate "
          f"{np.mean(ms['integrate']):.2f} ms of it), TSDF extract "
          f"{extract:.1f} ms; LPIPS "
          f"{np.mean(ms['lpips']):.3f} ms per frame; F-score "
          f"{result['Mesh F-score']:.6f} precision "
          f"{result['Mesh precision']:.6f} recall {result['Mesh recall']:.6f}"
          f"; first run {secs:.1f} s, resumed run {r_secs:.1f} s; vis_final "
          f"launches {json.dumps(dict(vis_mesh))}")
    print(f"[disk] first submap PSNR {own.mean():.6g}")
    total = collections.Counter(launches)
    total.update(r_launches)
    return dict(total)


# ---------------------------------------------------------------------------
# phase 9: the 3DGS render method, the SplaTAM baseline and gs_densify


# Without SA nothing amplifies the two summation orders' rounding: every
# output channel and stash row within 1e-4 of its scale (the integer ones
# exactly), and K2's gradient, through a well-conditioned weight, within
# 1e-5 worst-row relative L2 of torch.autograd through the plain version
# (phase 2's check of K2 without SA).
TOL_OUT_NO_SA = {c: 1e-4 for c in range(13)}
TOL_STASH_NO_SA = {c: 0.0 if t == 0.0 else 1e-4 for c, t in TOL_STASH.items()}
TOL_GRAD_NO_SA = 1e-5
# The per-accepted work without SA's fusion weight and fused depth (25
# FLOP + rcp, rcp, exp of FWD_ACCEPTED; the backward's per-pair forward
# values drop the same).
FWD_ACCEPTED_NO_SA = (FWD_ACCEPTED[0] - 25, FWD_ACCEPTED[1] - 3)
BWD_ACCEPTED_NO_SA = (BWD_ACCEPTED[0] - 25, BWD_ACCEPTED[1] - 3)


def edit_3dgs(cfg):
    """What EXP=1 sets in the dataset profiles (configs/replica/
    config.py:15,39,112): the 3DGS render method, isotropic gaussians."""
    cfg["render"]["method"] = "3dgs"
    cfg["gaussians"]["gaussian_distribution"] = "isotropic"


def phase_3dgs_kernels(ds, sys_cfg, capacity, dev, card, sa_numbers):
    """Phase 9a: K1, K3, K2 and K4 on 3DGS pair attributes (phase 2's
    random map through preprocess_3dgs, anisotropic and isotropic, all
    tiles and the coarse tracking subset), SA off as the 3DGS method runs
    them: each against its plain version, the cull checked conservative,
    and K1 / K2 / K3 timed beside phase 2's SA times."""
    import torch

    from gaus_slam_tpu_torch.ops import _cuda
    from gaus_slam_tpu_torch.ops.raster_backward import (
        raster_backward_stash, raster_backward_stash_plain)
    from gaus_slam_tpu_torch.ops.raster_forward import (raster_forward,
                                                        raster_forward_plain,
                                                        raster_forward_stash)

    cam = sys_cfg.cam
    gm = random_map(ds, cam, capacity, dev)
    rng = np.random.default_rng(3)
    kw = dict(grid=sys_cfg.opts.grid, use_sa=False, need_normal=False)
    numbers = {}
    for iso in (False, True):
        kind = "isotropic" if iso else "anisotropic"
        opts = sys_cfg.opts._replace(method="3dgs", iso3d=iso)
        check(opts.use_sa and not opts.settings().use_sa,
              "phase 9a: the 3DGS method must turn SA off")
        bins, cases = kernel_inputs(gm, cam, opts,
                                    sys_cfg.track_front.coarse_stride)
        print(f"[3dgs kernels] {kind}: pair demand {int(bins.demand)}, "
              f"r_max {bins.pair_gauss.shape[0]}, overflow "
              f"{bool(bins.overflow)}, rects shrunk {int(bins.n_shrunk)}")
        check(not bool(bins.overflow), "phase 9a: the binning overflows")
        for case, (pattrs, ts, te, ids) in cases.items():
            label = f"{kind} {case}"
            n_sub = int(ts.shape[0])
            live = pattrs[17] > 0
            check(bool((pattrs[2] == 0).all() and (pattrs[5] == 0).all()
                       and (pattrs[8][live] == 1).all()),
                  f"phase 9a {label}: the pair attributes are not "
                  f"pixel-linear (p_z == 1)")
            k_out, k_stash, k_kexit = raster_forward_stash(
                pattrs, ts, te, tile_ids=ids, **kw)
            k3_out = raster_forward(pattrs, ts, te, tile_ids=ids, **kw)
            p_out, p_stash, p_kexit = raster_forward_plain(
                pattrs, ts, te, tile_ids=ids, **kw)
            torch.cuda.synchronize()
            frac, err1, report, ok1 = compare_out(k_out, p_out,
                                                  TOL_OUT_NO_SA)
            kex_agree = float((k_kexit == p_kexit).float().mean())
            st_ok, st_report = compare_stash(k_stash, p_stash, k_kexit,
                                             p_kexit, ts, te, dev,
                                             TOL_STASH_NO_SA)
            k3_same = bool(torch.equal(k3_out, k_out))
            print(f"[3dgs kernels] K1 {label}: {n_sub} tiles, pairs "
                  f"{int((te - ts).clamp(min=0).sum())}; int-channel "
                  f"mismatch {frac:.2e} (< 5e-3), float max abs err "
                  f"{err1:.3e}, relative by channel [{report}] (tol 1e-4), "
                  f"kexit agree {kex_agree:.4f}, stash relative by row "
                  f"[{st_report}] (tol 1e-4, rows 1 and 7 exact); K3 == K1 "
                  f"out: {k3_same}; alpha max {float(k_out[:, 4].max()):.3f}")
            check(ok1, f"K1 on 3DGS attributes ({label}) disagrees with its "
                  f"plain version")
            check(kex_agree >= 0.99, f"K1 on 3DGS attributes ({label}): "
                  f"kexit disagrees")
            check(st_ok, f"K1 on 3DGS attributes ({label}): stash disagrees")
            check(k3_same, f"K3 on 3DGS attributes ({label}) differs from "
                  f"K1's output")
            check(float(k_out[:, 4].max()) > 0.5,
                  f"phase 9a {label}: the render is empty")

            d_out = torch.zeros_like(k_out)
            d_out[:, :10] = torch.as_tensor(
                rng.normal(size=(n_sub, 10, k_out.shape[-1])).astype(
                    np.float32), device=dev)
            bargs = (pattrs, ts, te, k_stash, k_kexit, k_out, d_out)
            k_grad = raster_backward_stash(*bargs, tile_ids=ids, **kw)
            p_grad = raster_backward_stash_plain(*bargs, tile_ids=ids, **kw)
            torch.cuda.synchronize()
            rel = max(float((k_grad[c] - p_grad[c]).norm()
                            / p_grad[c].norm())
                      for c in range(21) if float(p_grad[c].norm()) > 0)
            err2 = float((k_grad - p_grad).abs().max())
            pad = float(k_grad[21:].abs().max())
            print(f"[3dgs kernels] K2 {label}: worst row relative L2 err "
                  f"{rel:.2e} (tol {TOL_GRAD_NO_SA}), max abs err "
                  f"{err2:.3e}, pad rows {pad}")
            check(rel <= TOL_GRAD_NO_SA and pad == 0.0,
                  f"K2 on 3DGS attributes ({label}) disagrees with "
                  f"torch.autograd through the plain version")

            if case != "full":
                continue
            evals, culled, accepted, wrong = pair_pixel_work(
                pattrs, ts, te, k_out, opts.grid)
            print(f"[3dgs kernels] {label}: (pair, pixel) evaluations "
                  f"{evals:.6g}, culled {culled:.6g}, accepted "
                  f"{accepted:.6g}; culled although the alpha test passes: "
                  f"{wrong}")
            check(wrong == 0, f"phase 9a {label}: pair_culled rejected "
                  f"{wrong} (pair, pixel) that pass the alpha test: the cull "
                  f"is not conservative on 3DGS attributes")
            if iso:
                continue
            # K4 inside the 3DGS mapping reduction: the K4 landing against
            # the plain gather's, bit for bit
            d_pairs = torch.as_tensor(rng.normal(
                size=(bins.pair_gauss.shape[0], 24)).astype(np.float32),
                device=dev)
            n = gm.capacity
            _cuda.clear_launches()
            g4 = bins.slab_scatter_grads(d_pairs, n, backend="pallas")
            torch.cuda.synchronize()
            k4_launched = _cuda.fold_launches().get("monotone_row_gather", 0)
            gp = bins.slab_scatter_grads(d_pairs, n, backend="reference")
            same4 = bool(torch.equal(g4, gp))
            print(f"[3dgs kernels] K4 in the 3DGS mapping reduction "
                  f"([R={d_pairs.shape[0]}, 24] -> [N={n}, 24]): launched "
                  f"{k4_launched}, bit-equal to the plain gather's landing: "
                  f"{same4}")
            check(k4_launched > 0 and same4, "K4 in the 3DGS mapping "
                  "reduction is not bit-equal to the plain landing")

            out_bytes = k_out.numel() * 4
            in_bytes = pattrs.numel() * 4 + 3 * n_sub * 4
            stash_bytes = int(k_kexit.sum()) * 8 * 256 * 4
            t_k1 = time_ms(lambda: raster_forward_stash(pattrs, ts, te, **kw),
                           10)
            t_k3 = time_ms(lambda: raster_forward(pattrs, ts, te, **kw), 10)
            t_k2 = time_ms(lambda: raster_backward_stash(*bargs, **kw), 5)
            t_p1 = time_ms(lambda: raster_forward_plain(pattrs, ts, te, **kw),
                           2, warm=1)
            t_p2 = time_ms(lambda: raster_backward_stash_plain(*bargs, **kw),
                           1, warm=1)
            work = {
                "raster_forward_stash": (t_k1, t_p1, FWD_ACCEPTED_NO_SA,
                                         in_bytes + out_bytes + stash_bytes,
                                         err1),
                "raster_forward": (t_k3, t_p1, FWD_ACCEPTED_NO_SA,
                                   in_bytes + out_bytes, err1),
                "raster_backward_stash": (
                    t_k2, t_p2, BWD_ACCEPTED_NO_SA,
                    2 * in_bytes + 2 * out_bytes + stash_bytes, err2)}
            for name, (t, tp, per, nb, err) in work.items():
                b = op_bound(evals, accepted, per, nb, culled=culled)
                numbers[name] = dict(ms=t, plain_ms=tp, bound_ms=b[0],
                                     bound_by=b[1], max_abs_err=err)
            print(f"[3dgs kernels] {card}: ms per call without SA on 3DGS "
                  f"attributes ({label}) beside phase 2's with SA on 2DGS "
                  f"attributes: " + ", ".join(
                      f"{KERNELS[k][0]} {v['ms']:.4f} (SA "
                      f"{sa_numbers[k]['ms']:.4f}; plain {v['plain_ms']:.1f}; "
                      f"bound {v['bound_ms']:.4f} {v['bound_by']})"
                      for k, v in numbers.items()))
    # the same kernels on phase 2's 2DGS attributes, SA on and off in one
    # call: what SA costs apart from the change of attributes
    _, cases = kernel_inputs(gm, cam, sys_cfg.opts,
                             sys_cfg.track_front.coarse_stride)
    pattrs, ts, te, _ = cases["full"]
    t2 = {True: [], False: []}
    for sa in (True, False, False, True):
        k = dict(kw, use_sa=sa)
        o, st, kx = raster_forward_stash(pattrs, ts, te, **k)
        d_o = torch.zeros_like(o)
        d_o[:, :10] = 1.0
        ba = (pattrs, ts, te, st, kx, o, d_o)
        t2[sa].append((
            time_ms(lambda: raster_forward_stash(pattrs, ts, te, **k), 10),
            time_ms(lambda: raster_forward(pattrs, ts, te, **k), 10),
            time_ms(lambda: raster_backward_stash(*ba, **k), 5)))
    mean = {sa: np.mean(v, axis=0) for sa, v in t2.items()}
    print(f"[3dgs kernels] {card}: on phase 2's 2DGS attributes (full), ms "
          f"per call with SA / without (mean of two turns each): K1 "
          f"{mean[True][0]:.4f} / {mean[False][0]:.4f}, K3 "
          f"{mean[True][1]:.4f} / {mean[False][1]:.4f}, K2 "
          f"{mean[True][2]:.4f} / {mean[False][2]:.4f}")
    return numbers


def check_launches(label, launches, want=STASH_PATH, absent=("raster_backward",)):
    for name in want:
        check(launches.get(name, 0) > 0, f"{label}: {name} never launched")
    for name in absent:
        check(launches.get(name, 0) == 0, f"{label}: {name} launched")


def phase_3dgs_driver(dev):
    """Phase 9b: the 3DGS ablation through the port's driver, at 48x64 x
    12 against the JAX package's numbers in that configuration, then at
    340x600 x 30 against phase 6's bounds."""
    small = phase_driver_small(dev, "3dgs_48x64", SMALL_BOUNDS_3DGS,
                               edit_3dgs)
    check_launches("phase 9b (48x64)", small)
    full, probe = phase_driver_full(dev, "3dgs_340x600", edit_3dgs)
    check_launches("phase 9b (340x600)", full)
    return small, full, probe


def phase_splatam(dev, card):
    """Phase 9c: the port's SplaTAM baseline (scripts/splatam.py) with
    configs/replica/splatam.py, its data the ReplicaV2 tree of phase 8
    (340x600 x 12)."""
    import shutil

    import torch

    from gaus_slam_tpu_torch.models import gaussians as G
    from gaus_slam_tpu_torch.ops import _cuda
    from gaus_slam_tpu_torch.scripts import splatam
    from gaus_slam_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", "replica", "splatam.py"))
    cfg["data"] = disk_data(out_dir("disk_data"))
    base = out_dir("splatam")
    out = base + "_splatam"
    shutil.rmtree(out, ignore_errors=True)
    cfg["vis_base_dir"] = base
    grown = []
    resize = G.resize_map

    def counted_resize(gm, cap):
        grown.append((gm.capacity, cap))
        return resize(gm, cap)

    G.resize_map = counted_resize
    torch.cuda.synchronize()
    _cuda.clear_launches()
    t0 = time.perf_counter()
    try:
        result = splatam.rgbd_slam(cfg, backend="pallas", device=dev)
    finally:
        G.resize_map = resize
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_cuda.fold_launches())
    with open(os.path.join(out, "time.json")) as f:
        times = json.load(f)
    n_track = int(cfg["frontend"]["num_tracking_iters"])
    n_frames = N_FRAMES_DISK
    print(f"[splatam] result {json.dumps(result)}")
    print(f"[splatam] {card}: {n_frames} frames in {secs:.1f} s "
          f"({1.0 / times['frame_time']:.3f} frames/s over the frame loop "
          f"and the final refinement); tracking "
          f"{times['tracking_iter_time(ms)']:.1f} ms per tracked frame "
          f"({times['tracking_iter_time(ms)'] / n_track:.2f} ms per "
          f"iteration of {n_track}), mapping "
          f"{times['mapping_iter_time(ms)']:.2f} ms per iteration; "
          f"time.json {json.dumps(times)}")
    print(f"[splatam] capacity growth {grown}; launches "
          f"{json.dumps(launches)}")
    for name in ("time.json", "result.json", "scene/gaussians.ply"):
        check(os.path.exists(os.path.join(out, name)),
              f"phase 9c: the SplaTAM driver wrote no {name}")
    check(any(new > old for old, new in grown),
          "phase 9c: the map capacity never grew")
    check_launches("phase 9c", launches)
    ate, psnr = result["ATE RMSE"], result["PSNR"]
    print(f"[splatam] ATE RMSE {ate:.6g} (bound < {T_ERR_ABS}), PSNR "
          f"{psnr:.6g} (bound > {SPLATAM_PSNR_MIN})")
    check(np.isfinite(psnr) and psnr > SPLATAM_PSNR_MIN,
          f"phase 9c: PSNR {psnr} not > {SPLATAM_PSNR_MIN}")
    check(np.isfinite(ate) and ate < T_ERR_ABS,
          f"phase 9c: ATE RMSE {ate} not < {T_ERR_ABS}")
    return launches


def phase_gs_densify(dev, card):
    """Phase 9d: the port's driver on phase 8's tree with
    backend.gs_densify: densify_and_prune must run, never drop a row for
    want of capacity, and the run must clear phase 8's bounds."""
    import torch

    from gaus_slam_tpu_torch.models import gaussians as G

    calls = []
    real = G.densify_and_prune

    def counted(gm, grad_stat, generator=None, **kw):
        clone, split = G.densify_masks(
            gm, grad_stat, grad_threshold=kw["grad_threshold"],
            percent_dense=kw["percent_dense"], extent=kw["extent"])
        n0, nc, ns = int(gm.n_active), int(clone.sum()), int(split.sum())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(gm, grad_stat, generator, **kw)
        n1 = int(out.n_active)
        calls.append(dict(before=n0, clones=nc, splits=ns,
                          pruned=n0 + nc + 2 * ns - n1, after=n1,
                          capacity=gm.capacity,
                          ms=round(1e3 * (time.perf_counter() - t0), 2)))
        return out

    def edit(cfg):
        cfg["data"] = disk_data(out_dir("disk_data"))
        cfg["backend"]["gs_densify"] = True

    G.densify_and_prune = counted
    try:
        result, launches, probe, secs, out = run_driver(
            "gs_densify", dict(SYN_H=str(H), SYN_W=str(W),
                               SYN_FRAMES=str(N_FRAMES_DISK)), dev, edit=edit)
    finally:
        G.densify_and_prune = real
    be = probe.backend
    print(f"[gs_densify] {card}: densify_and_prune calls (clones, splits, "
          f"prunes per call) {json.dumps(calls)}; backend capacity "
          f"{be.map.capacity}, n_active {int(be.map.n_active)}; mapping steps "
          f"{be.mapping_iter}; backend ms per task (median, count): "
          + "; ".join(f"{k} {np.median(v):.1f} {len(v)}"
                      for k, v in sorted(probe.tasks.items()))
          + f"; whole run {secs:.1f} s")
    check(calls, "phase 9d: densify_and_prune never ran")
    check("mapping (fused x4)" not in probe.tasks,
          "phase 9d: gs_densify ran the fused mapping batches")
    for c in calls:
        check(c["before"] + c["clones"] + 2 * c["splits"] <= c["capacity"],
              f"phase 9d: a densify outgrew the capacity and dropped rows "
              f"({c})")
    check(be.map.capacity >= int(be.map.n_active),
          "phase 9d: the capacity fell under the map")
    check_launches("phase 9d", launches)
    psnrs = np.loadtxt(os.path.join(out, "psnr.txt"))
    first = probe.merges[0]["frames"]
    own = psnrs[first[0]:first[1]]
    ate = result["ATE RMSE"]
    print(f"[gs_densify] ATE RMSE {ate:.6g} (bound < {T_ERR_ABS}); PSNR "
          f"{result['PSNR']:.6g} over all frames, {own.mean():.6g} over the "
          f"first submap's {len(own)} (bound > {PSNR_MIN})")
    check(np.isfinite(ate) and ate < T_ERR_ABS,
          f"phase 9d: ATE RMSE {ate} not < {T_ERR_ABS}")
    check(len(own) > 0 and np.isfinite(own).all() and own.mean() > PSNR_MIN,
          f"phase 9d: PSNR {own.mean()} over the first submap's frames not > "
          f"{PSNR_MIN}")
    return launches


# ---------------------------------------------------------------------------
# phase 10: the backend on its own stream, the sharded BA, the pipelined
# driver


N_LOAD = 12            # 10a: frontend frames tracked beside each backend run
LATE_HANDOFF_CYCLES = 400_000_000   # 10a: ~0.2 s of spin at the H100's clock
MARK_KERNELS = ("spin_kernel", "kernelHistogram1D")  # 10a: the stream marks
# 10a: map_digest of the "off" run's backend state with K7 / K8 (this card)
PARENT_10A_DIGEST = "a321d43a29d66b5b"
TASKS_PER_TURN = 4     # 10a: backend tasks per turn, as in gaus_mp's loop
PROFILE_TURNS = range(2, 4)   # 10a: the turns the profiler watches
BACKLOG_TURNS = range(4, 6)   # 10a: the same with a backlog on the backend
BACKLOG_CYCLES = 400_000_000  # 10a: ~0.2 s, more than 4 tasks' host time
# MARK_KERNELS: spins and the histogram kernel are left out of the busy
# time; the histogram kernel marks the backend's stream
BA_GROUP = 4           # 10b: keyframes of one sharded step, all on cuda:0
SHARDED_OUTSIDE_LIMIT = 16   # 10b: kernels, copies, fills outside a graph


def union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap_us(xs, ys):
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    tot = 0.0
    while i < len(xs) and j < len(ys):
        tot += max(0.0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return tot


def stream_overlap(trace_path):
    """(kernel busy ms by stream, the backend's stream or None, ms in which
    the backend's kernels (or, unmarked, the second stream's) ran beside
    the others', window ms) from a chrome trace whose backend stream
    carries spin kernels; None (and what the trace holds) when it has no
    kernel or no stream to tell apart."""
    import collections

    with open(trace_path) as f:
        trace = json.load(f)["traceEvents"]
    events = [e for e in trace if e.get("cat") == "kernel"]

    def is_mark(e):
        return any(m in e.get("name", "") for m in MARK_KERNELS)

    # spins (marks, backlogs) may run on either stream; the histogram
    # kernel marks the backend's alone
    marks = {e["args"].get("stream") for e in events
             if MARK_KERNELS[1] in e.get("name", "")}
    by_stream = collections.defaultdict(list)
    for e in events:
        if not is_mark(e):
            by_stream[e["args"].get("stream")].append(
                (e["ts"], e["ts"] + e["dur"]))
    print(f"[streams] trace marks: "
          f"{sorted({(e['args'].get('stream'), e['name'][:60]) for e in events if is_mark(e)})}"
          f"; kernels per stream "
          f"{ {k: len(v) for k, v in sorted(by_stream.items())} }")
    backend = next(iter(marks)) if len(marks) == 1 else None
    other = backend if backend is not None else (
        max(by_stream) if len(by_stream) == 2 else None)
    if other is None or other not in by_stream:
        print(f"[streams] the trace holds "
              f"{dict(collections.Counter(e.get('cat') for e in trace))}, "
              f"marks on streams {sorted(marks)}, kernels on streams "
              f"{sorted(by_stream)}")
        return None
    busy = {k: union(v) for k, v in by_stream.items()}
    rest = union([iv for k, v in busy.items() if k != other for iv in v])
    span = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events))
    # where the host traced its CUDA calls: the launches that blocked it
    # (a full launch queue) for more than a millisecond
    blocked = [e["dur"] / 1e3 for e in trace if e.get("cat") == "cuda_runtime"
               and e.get("name") == "cudaLaunchKernel"
               and e.get("dur", 0) > 1000]
    print(f"[streams] kernel launches that held the host over 1 ms: "
          f"{len(blocked)}, {sum(blocked):.1f} ms in all, longest "
          f"{max(blocked, default=0.0):.1f} ms")
    return ({k: sum(b - a for a, b in v) / 1e3 for k, v in busy.items()},
            backend, overlap_us(busy[other], rest) / 1e3, span / 1e3)


@contextlib.contextmanager
def stream_context_without_wait(be):
    """10a's control: Backend.stream_context with the wait on the caller's
    stream left out, the fault 10a's check must catch."""
    import torch

    with torch.cuda.stream(be.stream):
        yield


def late_handoff(lm):
    """10a: the donor snapshot's colours arrive late on the caller's
    stream. They are halved at once, and the default stream writes the
    true ones back only after a spin of LATE_HANDOFF_CYCLES, so a backend
    that reads them without waiting for that stream reads the halved
    ones."""
    import torch

    rgb = lm.map_params[0].rgb
    saved = rgb.clone()
    rgb.mul_(0.5)
    torch.cuda.synchronize()
    torch.cuda._sleep(LATE_HANDOFF_CYCLES)
    rgb.copy_(saved)


def adopt_without_record(be, t):
    """10a's record_stream control: Backend._adopt with the tensor not
    marked as in use on the backend's stream, the fault the pressure runs
    must catch."""
    if t is None or be.stream is None or t.device != be.device:
        return type(be)._adopt(be, t)
    return t


def stream_run(label, cfg, lms, ds, dev, bd, profile=False, late=False,
               wait=True, pressure=False, record=True):
    """10a: a fresh Backend with tpu.backend_device ``bd`` through one fixed
    call sequence (each of ``lms`` merged, then TASKS_PER_TURN process()
    calls a turn until its queue is empty) while a Frontend tracks the
    synthetic frames on the default stream between the turns. ``late``
    hands each donor snapshot over late (late_handoff); ``wait=False``
    leaves out the backend's wait on the caller's stream (the control).
    ``pressure``: each merge's work on the backend's stream starts with a
    spin of LATE_HANDOFF_CYCLES, and as soon as the merge call returns
    the default stream fills fresh tensors of the donor snapshot's sizes,
    which the caching allocator may place in the donor's freed memory;
    ``record=False`` leaves out Backend._adopt's record_stream (the
    control). Returns (final state, launches of the run, launches by
    (kernel, inside the backend, stream handle), the profiled window's
    overlap or None, seconds)."""
    import collections
    import copy
    import types

    import torch
    from torch.profiler import ProfilerActivity, profile as profiler

    from gaus_slam_tpu_torch.ops import _cuda
    from gaus_slam_tpu_torch.slam import programs
    from gaus_slam_tpu_torch.slam.backend import Backend
    from gaus_slam_tpu_torch.slam.frontend import Frontend
    from gaus_slam_tpu_torch.utils.checkpoint import backend_state_arrays

    cfg = copy.deepcopy(cfg)
    cfg["backend"]["random_process"] = False
    cfg["tpu"]["backend_device"] = bd
    be = Backend(cfg, device=dev)
    if not wait:
        be.stream_context = types.MethodType(stream_context_without_wait,
                                             be)
    if not record:
        be._adopt = types.MethodType(adopt_without_record, be)
    delay = [False]
    if pressure:
        entry = be.stream_context

        @contextlib.contextmanager
        def delayed():
            with entry():
                if delay[0]:
                    torch.cuda._sleep(LATE_HANDOFF_CYCLES)
                yield
        be.stream_context = delayed
    fe = Frontend(cfg, queue.Queue(), device=dev)
    inside = [False]
    streams = collections.Counter()
    real_check = _cuda.check

    warming = []    # (owner, the stream that called it) per warm-up

    def counted_check(rc, what):
        # a wrapper calls check right after its launch, on its stream; in
        # a capture it launched nothing (the graph's replays run it). A
        # program's warm-up runs on its owner's capture stream, between
        # the calling stream's work (Owner._warm): counted on the caller's
        if not torch.cuda.is_current_stream_capturing():
            h = torch.cuda.current_stream().cuda_stream
            if warming and warming[-1][0].stream.cuda_stream == h:
                h = warming[-1][1]
            streams[(what, inside[0], h)] += 1
        return real_check(rc, what)

    real_warm = programs.Owner._warm

    def counted_warm(own, fn, name):
        warming.append((own, torch.cuda.current_stream().cuda_stream))
        try:
            return real_warm(own, fn, name)
        finally:
            warming.pop()

    real_replay = programs.Owner._replay

    def counted_replay(own, prog):
        # a program replays on the caller's stream (slam/programs.py)
        streams[("graph:" + prog.name, inside[0],
                 torch.cuda.current_stream().cuda_stream)] += 1
        return real_replay(own, prog)

    def in_backend(fn):
        def run(*a, **kw):
            inside[0] = True
            try:
                return fn(*a, **kw)
            finally:
                inside[0] = False
        return run

    merge, process = in_backend(be.process_localmap), in_backend(be.process)
    frames = iter(range(N_LOAD))

    def fetch():
        # the next frame from the dataset (host work, before the turn's
        # backend tasks)
        t = next(frames, None)
        return None if t is None else (t, ds[t])

    def load(item):
        if item is not None:
            t, (color, depth, _, c2w) = item
            fe.process_frame(t, np.asarray(color, np.float32)
                             / np.float32(255), np.asarray(depth), c2w)
            while not fe.to_backend.empty():
                fe.to_backend.get()

    def mark(stream):
        # a spin kernel and a histogram kernel (which the port never
        # launches) tell the backend's stream apart in the trace
        with torch.cuda.stream(stream):
            torch.cuda._sleep(1000)
            torch.histc(torch.ones(64, device=stream.device), bins=4,
                        min=0.0, max=2.0)

    # profiled windows: the schedule as it is, then the same turns with
    # a backlog (a spin queued on the backend's stream before its tasks)
    windows = ({PROFILE_TURNS.start: ("plain", PROFILE_TURNS),
                BACKLOG_TURNS.start: ("backlog", BACKLOG_TURNS)}
               if profile else {})
    prof, win, overlap, turn = None, None, {}, 0
    torch.cuda.synchronize()
    _cuda.clear_launches()
    _cuda.check = counted_check
    programs.Owner._replay = counted_replay
    programs.Owner._warm = counted_warm
    t0 = time.perf_counter()
    filled = []
    try:
        for lm in copy.deepcopy(lms):
            if late:
                late_handoff(lm)
            shapes = [(p.shape, p.dtype) for p in lm.map_params[0]]
            delay[0] = True
            merge(lm, multi_process=True)
            delay[0] = False
            if pressure:
                # the merge dropped the donor snapshot: reuse its sizes now
                filled.append([torch.full(sh, 1e3, dtype=dt, device=dev)
                               for sh, dt in shapes])
            while be.task_queue:
                if turn in windows:
                    win = windows[turn]
                    # the backlog window also traces the host's CUDA calls
                    prof = profiler(activities=[ProfilerActivity.CUDA] + (
                        [ProfilerActivity.CPU] if win[0] == "backlog"
                        else []))
                    prof.start()
                item = fetch()
                if prof is not None:
                    # every turn: a trace may lose a few kernel records
                    mark(be.stream)
                if prof is not None and win[0] == "backlog":
                    # on the caller's stream, which the backend's waits
                    # for: the turn's backend work and the frontend's
                    # queue up behind it and are released together
                    torch.cuda._sleep(BACKLOG_CYCLES)
                for _ in range(TASKS_PER_TURN):
                    if be.task_queue:
                        process()
                load(item)
                if prof is not None and turn == win[1].stop - 1:
                    mark(be.stream)
                    torch.cuda.synchronize()
                    prof.stop()
                    path = os.path.join(out_dir("streams"),
                                        f"trace_{win[0]}.json")
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    prof.export_chrome_trace(path)
                    overlap[win[0]] = stream_overlap(path)
                    prof = None
                turn += 1
        be.wait()
        torch.cuda.synchronize()
    finally:
        _cuda.check = real_check
        programs.Owner._replay = real_replay
        programs.Owner._warm = real_warm
    del filled
    secs = time.perf_counter() - t0
    launches = dict(_cuda.fold_launches())
    return backend_state_arrays(be), be, launches, streams, overlap, secs


def phase_streams(cfg, ds, lms, dev, card):
    """Phase 10a: the backend on a CUDA stream of its own must leave the
    same map as on the frontend's stream, also when each donor snapshot
    arrives late on the frontend's stream; and the control, the same run
    with the backend's wait on the caller's stream left out, must not."""
    import torch

    check(len(lms) >= 2, f"phase 10a: {len(lms)} LocalMaps from phase 3")
    runs = {}
    for label, bd, late, wait, pressure, record in (
            ("off", "off", False, True, False, True),
            ("off again", "off", False, True, False, True),
            ("auto", "auto", False, True, False, True),
            ("auto, late handoff", "auto", True, True, False, True),
            ("auto, late handoff, pressure", "auto", True, True, True, True),
            ("control: auto, late handoff, no wait", "auto", True, False,
             False, True),
            ("control: auto, late handoff, pressure, no record_stream",
             "auto", True, True, True, False)):
        runs[label] = stream_run(label, cfg, lms, ds, dev, bd,
                                 profile=(label == "auto"), late=late,
                                 wait=wait, pressure=pressure, record=record)
        print(f"[streams] {card}: {label}: {len(lms)} merges, "
              f"{runs[label][5]:.2f} s with {N_LOAD} frontend frames beside "
              f"them; map digest {map_digest(runs[label][0])}; launches "
              f"{json.dumps(runs[label][2])}")
    a, b = runs["off"][0], runs["off again"][0]
    digest = map_digest(a)
    if PARENT_10A_DIGEST is not None:
        check(digest == PARENT_10A_DIGEST, f"phase 10a: the off run's map "
              f"digest {digest} is not the earlier code's "
              f"{PARENT_10A_DIGEST}")
        print(f"[streams] {card}: the off run's map equals the earlier "
              f"code's bit for bit (digest {digest})")
    _, be, launches, streams, overlap, _ = runs["auto"]
    check(be.stream is not None, "phase 10a: backend_device auto has no "
          "stream of its own on one card")

    def against_off(label):
        """(values equal to the off run where the two off runs agree,
        values where the two off runs agree, [(key, max |label - off|,
        max |off - off again|)] where they do not, keys whose values
        differ where they agree)."""
        c = runs[label][0]
        n_equal = n_all = 0
        worst, broken = [], []
        for k in a:
            x, y, z = (torch.as_tensor(np.asarray(v), dtype=torch.float64)
                       for v in (a[k], b[k], c[k]))
            check(x.shape == z.shape, f"phase 10a: {label}: {k} has shape "
                  f"{tuple(z.shape)}, {tuple(x.shape)} off it")
            same = (x == y) | (torch.isnan(x) & torch.isnan(y))
            n_all += int(same.sum())
            ok = (z == x) | (torch.isnan(z) & torch.isnan(x))
            n_equal += int((ok & same).sum())
            if not bool(ok[same].all()):
                broken.append(k)
            if not bool(same.all()):
                spread = float((x - y)[~same].abs().max())
                dz = float((z - x)[~same].abs().max())
                worst.append((k, dz, spread))
        return n_equal, n_all, worst, broken

    for label in ("auto", "auto, late handoff",
                  "auto, late handoff, pressure"):
        n_equal, n_all, worst, broken = against_off(label)
        check(not broken, f"phase 10a: {label}: {broken} differ on the "
              f"backend's stream where the two runs on the frontend's agree "
              f"to the bit")
        for k, dz, spread in worst:
            check(dz <= 2 * spread, f"phase 10a: {label}: {k} on the "
                  f"backend's stream is {dz} from the first run off it, "
                  f"twice the runs' own spread {spread} exceeded")
        print(f"[streams] {card}: {label}: the map on the backend's own "
              f"stream is bit-equal to the frontend-stream run wherever the "
              f"two frontend-stream runs agree ({n_equal} of {n_all} "
              f"values); elsewhere (field, max |auto - off|, max |off - off "
              f"again|): {worst}")
    label = "control: auto, late handoff, no wait"
    n_equal, n_all, _, broken = against_off(label)
    check(bool(broken), f"phase 10a: {label}: the map came out bit-equal "
          f"to the frontend-stream run, so 10a's check cannot see a missing "
          f"wait")
    print(f"[streams] {card}: {label}: differs from the frontend-stream run "
          f"where the two frontend-stream runs agree, as it must "
          f"({n_all - n_equal} of {n_all} values, in {len(broken)} arrays)")
    label = "control: auto, late handoff, pressure, no record_stream"
    n_equal, n_all, _, broken = against_off(label)
    check(bool(broken), f"phase 10a: {label}: the map came out bit-equal "
          f"to the frontend-stream run, so 10a's check cannot see a missing "
          f"record_stream")
    print(f"[streams] {card}: {label}: differs from the frontend-stream run "
          f"where the two frontend-stream runs agree, as it must "
          f"({n_all - n_equal} of {n_all} values, in {len(broken)} arrays)")
    feeder_handoff(dev, card)
    default = torch.cuda.default_stream().cuda_stream
    own = be.stream.cuda_stream
    graphs = {w for (w, ins, h) in streams if w.startswith("graph:")}
    check(graphs, "phase 10a: no captured step replayed")
    for name in ("raster_forward_stash", "raster_backward_stash",
                 "monotone_row_gather") + tuple(
                     g for g in sorted(graphs) if any(
                         w == g and ins for (w, ins, h) in streams)):
        on = {h: n for (w, ins, h), n in streams.items() if w == name and ins}
        check(on and set(on) == {own} and own != default,
              f"phase 10a: {name} ran inside the backend on streams {on}, "
              f"not on the backend's own {own}")
    front = {h for (w, ins, h) in streams if not ins}
    check(front == {default}, f"phase 10a: the frontend launched on {front}")
    print(f"[streams] {card}: backend K1/K2/K4 launches on its stream: "
          + ", ".join(f"{w} {n}" for (w, ins, h), n in sorted(streams.items())
                      if ins and h == own))
    # no host wait is left in the backend's steps (4b), and each step is
    # one graph launch (phase 13): the overlap of the streams' kernels is
    # printed, not required (PERF.md, section 6)
    print_overlap(card, overlap)
    return launches


def print_overlap(card, overlap):
    """Prints 10a's profiled windows; returns {window: ms in which both
    streams' kernels ran}. Fails when a trace tells no streams apart."""
    both, unmarked = {}, []
    for name, turns in (("plain", PROFILE_TURNS), ("backlog", BACKLOG_TURNS)):
        check(overlap.get(name) is not None, f"phase 10a: the {name} "
              f"window's trace told no two streams apart")
        busy, bstream, both[name], span = overlap[name]
        print(f"[streams] {card}: turns {turns.start}-{turns.stop - 1} of the "
              f"auto run under the profiler ({name}"
              + (f", a {BACKLOG_CYCLES}-cycle spin queued on the caller's "
                 f"stream before each turn's backend tasks" if name ==
                 "backlog" else "") + f"): window {span:.1f} ms, kernel busy ms by "
              f"trace stream "
              f"{json.dumps({str(k): round(v, 3) for k, v in busy.items()})} "
              f"(the backend's: "
              f"{bstream if bstream is not None else 'unmarked'}), both "
              f"streams at once {both[name]:.3f} ms")
        if bstream is None:
            unmarked.append(name)
    check(not unmarked, f"phase 10a: the traces of {unmarked} did not mark "
          f"the backend's stream")
    return both


def streams_of(root):
    """10a's profiled "auto" run with the port found under ``root`` (an
    unpacked older tree, say): phase 3's LocalMaps, then stream_run's two
    windows, printed. A measurement to set beside this tree's in one
    call; nothing is checked. ``python3 chip_smoke.py --streams-of
    <root>``."""
    import torch

    sys.path.insert(0, os.path.abspath(root))
    import gaus_slam_tpu_torch

    print(f"[streams_of] the port from {gaus_slam_tpu_torch.__file__}")
    dev = torch.device("cuda")
    cfg, ds, _, _ = make_setup(dev)
    _, _, _, lms = drive_frontend("frontend", cfg, ds, "pallas", N_FRAMES,
                                  dev)
    run = stream_run("auto", cfg, lms, ds, dev, "auto", profile=True)
    print(f"[streams_of] map digest {map_digest(run[0])}")
    print_overlap(card_line(), run[4])


def map_digest(state):
    """sha1 of a flat {name: array} state (backend_state_arrays), names
    in order: equal digests, equal bits."""
    import hashlib

    h = hashlib.sha1()
    for k in sorted(state):
        h.update(k.encode())
        h.update(np.ascontiguousarray(np.asarray(state[k])).tobytes())
    return h.hexdigest()[:16]


def feeder_handoff(dev, card):
    """10a: gaus_mp's feeder hands each frame from its copy stream to the
    frontend's (scripts/gaus_mp.py::_receive: a wait on the copy's event,
    then record_stream). Provoked as the backend's handoff: the frontend's
    stream spins before it reads the frame, the frame's tensors are
    dropped, and the feeder copies the next frame at once. Through
    _receive the read sees the first frame; without its record_stream
    (the control) the next frame's copy lands in the freed memory
    first."""
    import torch

    from gaus_slam_tpu_torch.scripts.gaus_mp import _receive

    def receive_without_record(color, depth, event):
        torch.cuda.current_stream().wait_event(event)
        return color, depth

    copy_stream = torch.cuda.Stream(device=dev)
    n = H * W

    def staged(value):
        with torch.cuda.stream(copy_stream):
            c = torch.full((n, 3), value, dtype=torch.uint8).pin_memory().to(
                dev, non_blocking=True)
            d = torch.full((n,), value, dtype=torch.int16).pin_memory().to(
                dev, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(copy_stream)
        return c, d, ev

    seen = {}
    for label, receive in (("_receive", _receive),
                           ("control", receive_without_record)):
        torch.cuda.synchronize()
        c, d, ev = staged(1)
        c, d = receive(c, d, ev)
        torch.cuda._sleep(LATE_HANDOFF_CYCLES)
        got = (c.float().sum(), d.float().sum())
        del c, d
        nxt = staged(2)
        torch.cuda.synchronize()
        seen[label] = (float(got[0]) / (3 * n), float(got[1]) / n)
        del nxt
    print(f"[streams] {card}: gaus_mp's feeder handoff under the same "
          f"pressure: the frontend read the frame as {seen['_receive']} "
          f"(colour, depth mean) through _receive, {seen['control']} "
          f"without its record_stream (the frame 1, the next copy 2)")
    check(seen["_receive"] == (1.0, 1.0), "phase 10a: _receive's frame was "
          "overwritten by the feeder's next copy")
    check(seen["control"] != (1.0, 1.0), "phase 10a: without record_stream "
          "the feeder's next copy did not land in the frame's memory, so "
          "the pressure cannot show the fault")


def sequential_ba_step(gm, w2cs, gts, keyframes, s):
    """The mean-gradient step a sharded one stands for: each keyframe's
    loss through render_full and mapping_loss, the gradients accumulated
    in .grad, then one Adam step. Returns (map, mean loss)."""
    from gaus_slam_tpu_torch.models import gaussians as G
    from gaus_slam_tpu_torch.render import render_full
    from gaus_slam_tpu_torch.slam.loss import mapping_loss

    params = [t.detach().clone().requires_grad_() for t in gm.params]
    total = 0.0
    for k in keyframes:
        out, _ = render_full(G.Params(*params), gm.active,
                             s.cam.replace_w2c(w2cs[k]), s.opts,
                             need_normal=s.opts.normals_in_tracking)
        loss = mapping_loss(out, gts[k], s.lcfg)[0]
        loss.backward()
        total += float(loss.detach())
    grads = G.Params(*(t.grad / len(keyframes) for t in params))
    return (G.adam_step(gm, grads, dict(s.mcfg.lrs), s.mcfg.betas, s.mcfg.eps,
                        isotropic=s.mcfg.isotropic), total / len(keyframes))


def phase_sharded_ba(cfg, ds, lms, capacity, dev, card):
    """Phase 10b: sharded_ba_step over [cuda:0] * 4 against the sequential
    mean-gradient step, then a Backend whose BA group is those four."""
    import copy

    import torch

    from gaus_slam_tpu_torch.models.frame import LrSchedule, init_exposure
    from gaus_slam_tpu_torch.ops import _cuda
    from gaus_slam_tpu_torch.ops.composite_ref import frame_to_tiles
    from gaus_slam_tpu_torch.parallel import sharded_ba_step
    from gaus_slam_tpu_torch.slam import programs
    from gaus_slam_tpu_torch.slam.backend import Backend
    from gaus_slam_tpu_torch.slam.steps import mapping_step
    from gaus_slam_tpu_torch.utils.config import SystemConfig

    s = SystemConfig.from_config(cfg, device=dev)   # the backend's
    gm = random_map(ds, s.cam, capacity, dev)
    c2w0 = np.asarray(ds[0][3], np.float64)
    w2cs, gts = [], []
    for t in range(BA_GROUP):
        color, depth, c2w = load_frame(ds, t, dev)
        w2cs.append(torch.as_tensor(
            (np.linalg.inv(c2w) @ c2w0).astype(np.float32), device=dev))
        gts.append(frame_to_tiles(color, depth, s.opts.grid))
    w2cs, gts = torch.stack(w2cs), torch.stack(gts)
    devs = [torch.device(dev)] * BA_GROUP

    def sharded(weights=None):
        return sharded_ba_step(devs, gm, w2cs, gts, s.cam, s.opts, s.mcfg,
                               s.lcfg, weights=weights)

    for weights in (None, [1, 1, 1, 0]):
        live = [k for k in range(BA_GROUP) if weights is None or weights[k]]
        got, loss, diag = sharded(weights)
        want, want_loss = sequential_ba_step(gm, w2cs, gts, live, s)
        rel = abs(float(loss) - want_loss) / abs(want_loss)
        errs = {}
        for f, x, y in zip(got.params._fields, got.params, want.params):
            scale = float(y.abs().max())
            errs[f] = (0.0 if torch.equal(x, y)
                       else float((x - y).abs().max()) / scale)
        print(f"[sharded_ba] {card}: weights {weights or [1] * BA_GROUP}: loss "
              f"{float(loss):.7g} against the sequential {want_loss:.7g} "
              f"(rel {rel:.2e}, tol 1e-5); params' max error / field scale "
              f"{errs} (tol 1e-6; 0.0 bit-equal); shard losses "
              f"{diag['losses'].tolist()}, overflow {bool(diag['overflow'])}")
        check(rel <= 1e-5, f"phase 10b: sharded loss {float(loss)} against "
              f"{want_loss}")
        check(all(e <= 1e-6 for e in errs.values()),
              f"phase 10b: sharded step against the sequential one {errs}")

    exp = init_exposure(dev)
    sched = LrSchedule(0.0, 0.0, 1)

    def four_steps():
        m = gm
        for k in range(BA_GROUP):
            m, _, _ = mapping_step(m, w2cs[k], gts[k], exp, False, sched,
                                   s.cam, s.opts, s.mcfg, s.lcfg)
        return m

    # the captured step as the Backend runs it: its owners, the map
    # stepped in place in the map owner's buffers
    owners = [programs.Owner(f"10b-shard{k}", device=d)
              for k, d in enumerate(devs)] + [programs.Owner("10b-map")]
    chain = {"gm": gm}

    def sharded_chain():
        chain["gm"], _, _ = sharded_ba_step(devs, chain["gm"], w2cs, gts,
                                            s.cam, s.opts, s.mcfg, s.lcfg,
                                            owners=owners)

    step_ms = time_ms(sharded_chain, 5, warm=2)
    seq_ms = time_ms(four_steps, 5, warm=1)
    w = step_window(sharded_chain)
    n = w["launches"]
    print(f"[sharded_ba] {card}: {step_ms:.2f} ms per captured sharded step "
          f"over {BA_GROUP} keyframes on one card, {seq_ms:.2f} ms for "
          f"{BA_GROUP} sequential captured mapping steps (ratio "
          f"{step_ms / seq_ms:.3f}; {H}x{W}, capacity {gm.capacity}); one "
          f"step profiled: graph launches {n['graphs']}, kernels outside a "
          f"graph {n['kernels']}, copies and fills outside a graph "
          f"{n['copies']}, kernels on the card {n['device_kernels']}, wall "
          f"{w['wall']:.3f} ms, device busy {w['busy']:.3f} ms, idle share "
          + ("not measured" if w["idle"] is None else f"{w['idle']:.3f}"))
    check(n["graphs"] <= BA_GROUP + 1
          and n["kernels"] + n["copies"] <= SHARDED_OUTSIDE_LIMIT,
          f"phase 10b: the captured sharded step made {n['graphs']} graph "
          f"launches and {n['kernels'] + n['copies']} operations outside a "
          f"graph (limits {BA_GROUP + 1}, {SHARDED_OUTSIDE_LIMIT})")

    c = copy.deepcopy(cfg)
    c["backend"]["random_process"] = False
    torch.cuda.synchronize()
    _cuda.clear_launches()
    be = Backend(c, device=dev, devices=devs)
    t0 = time.perf_counter()
    for lm in copy.deepcopy(lms[:2]):
        be.process_localmap(lm, multi_process=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_cuda.fold_launches())
    finite = all(bool(torch.isfinite(t).all()) for t in be.map.params)
    print(f"[sharded_ba] {card}: Backend with a BA group of {be.ba_group}: "
          f"two merges "
          f"in {secs:.2f} s, {be.ba_group_calls} sharded steps, mapping "
          f"counts {[lm.mapping_times for lm in be.local_maps]}, n_active "
          f"{int(be.map.n_active)}, finite {finite}; launches "
          f"{json.dumps(launches)}")
    check(be.ba_group_calls > 0, "phase 10b: the Backend ran no sharded step")
    check(finite and int(be.map.n_active) > 0,
          "phase 10b: the Backend's map is empty or not finite")
    check_launches("phase 10b", launches,
                   want=("raster_forward_stash", "raster_backward_stash",
                         "monotone_row_gather"))
    return launches


def refine_iters(be):
    """The mapping iterations of Backend.final_refine."""
    n = be.final_refinement
    return be.local_maps[-1].frames[-1].time_idx if n == -1 else n


def pipelined_checks(label, result, launches, probe, out, first, card):
    """Phase 6's ATE and first-submap PSNR bounds, K1-K4 launched (K3
    inside eval_final) and K5 not, for one pipelined run."""
    ate = result["ATE RMSE"]
    psnrs = np.loadtxt(os.path.join(out, "psnr.txt"))
    own = psnrs[first[0]:first[1]]
    print(f"[{label}] {card}: ATE RMSE {ate:.6g} (bound < {T_ERR_ABS}); PSNR "
          f"{result['PSNR']:.6g} over all frames, {own.mean():.6g} over the "
          f"first submap's {len(own)} (bound > {PSNR_MIN}); launches "
          f"{json.dumps(launches)}, inside eval_final "
          f"{json.dumps(dict(probe.inside['eval']))}")
    check(np.isfinite(ate) and ate < T_ERR_ABS,
          f"phase 10c ({label}): ATE RMSE {ate} not < {T_ERR_ABS}")
    check(len(own) > 0 and np.isfinite(own).all() and own.mean() > PSNR_MIN,
          f"phase 10c ({label}): PSNR {own.mean()} over the first submap's "
          f"frames not > {PSNR_MIN}")
    check_launches(f"phase 10c ({label})", launches)
    check(probe.inside["eval"].get("raster_forward", 0) > 0,
          f"phase 10c ({label}): K3 never launched inside eval_final")


def phase_pipelined(dev, card, fps_sync):
    """Phase 10c: scripts/gaus_mp.py at the bench shape with the backend on
    the frontend's stream and on its own, then from phase 8's tree with
    checkpoints, resumed from the first."""
    import shutil

    import torch

    from gaus_slam_tpu_torch.utils import checkpoint as C

    n_frames = int(config_from_env({})["data"]["num_frames"])
    out = {}
    for bd in ("off", "auto"):
        label = f"mp_{bd}"

        def edit(cfg, bd=bd):
            cfg["tpu"]["backend_device"] = bd

        result, launches, probe, secs, path = run_driver(
            label, dict(SYN_H=str(H), SYN_W=str(W)), dev, edit=edit,
            pipelined=True)
        peak = torch.cuda.max_memory_allocated() / 2**30
        be = probe.backend
        loop_s = probe.t_eval - probe.t_loop
        print(f"[{label}] {card}: {n_frames} frames, frame loop (final merge "
              f"and refine included) {loop_s:.2f} s: "
              f"{n_frames / loop_s:.3f} frames/s against the synchronous "
              f"driver's {fps_sync:.3f} (phase 6, this call); backend tasks "
              f"drained {json.dumps(dict(probe.drained))}, then "
              f"final_refine's {refine_iters(be)} mapping iterations; "
              f"merges {len(probe.merges)}; stream "
              f"{'own' if be.stream is not None else 'the frontend'}'s; "
              f"peak device memory {peak:.2f} GiB; whole run {secs:.1f} s")
        check(len(probe.merges) == 3, f"{label} merged {len(probe.merges)} "
              f"submaps, not 3")
        check((be.stream is not None) == (bd == "auto"),
              f"{label}: the backend's stream does not follow the knob")
        pipelined_checks(label, result, launches, probe, path,
                         probe.merges[0]["frames"], card)
        out[f"10c {bd}"] = launches

    first_ckpt = out_dir("mp_disk_first_ckpt")
    shutil.rmtree(first_ckpt, ignore_errors=True)
    save = C.save_run_state

    def keep_first(path, *a, **kw):
        save(path, *a, **kw)
        if not os.path.exists(first_ckpt):
            shutil.copytree(path, first_ckpt)

    def edit(cfg):
        cfg["data"] = disk_data(out_dir("disk_data"))
        cfg["backend"]["save_ckpt"] = True

    env = dict(SYN_H=str(H), SYN_W=str(W), SYN_FRAMES=str(N_FRAMES_DISK))
    C.save_run_state = keep_first
    try:
        result, launches, probe, secs, path = run_driver(
            "mp_disk", env, dev, edit=edit, pipelined=True)
    finally:
        C.save_run_state = save
    first = probe.merges[0]["frames"]
    pipelined_checks("mp_disk", result, launches, probe, path, first, card)
    with open(os.path.join(first_ckpt, "meta.json")) as f:
        meta = json.load(f)
    check(meta["next_frame_idx"] == 11 and len(meta["localmaps"]) == 1,
          f"phase 10c: the first checkpoint is at frame "
          f"{meta['next_frame_idx']} with {len(meta['localmaps'])} submaps, "
          f"not the first cut's (frame 11, 1 submap)")
    resumed, r_launches, r_probe, r_secs, r_path = run_driver(
        "mp_disk_resumed", env, dev, edit=edit, resume_from=first_ckpt,
        pipelined=True)
    check(len(r_probe.ms["restore_run_state"]) == 1,
          "phase 10c: the resumed run restored no checkpoint")
    check(r_probe.merges and r_probe.merges[0]["lmid"] == 1,
          "phase 10c: the resumed run did not continue from the second "
          "submap")
    pipelined_checks("mp_disk_resumed", resumed, r_launches, r_probe, r_path,
                     first, card)
    print(f"[mp_disk] {card}: first run {secs:.1f} s, resumed from frame 11 "
          f"{r_secs:.1f} s; checkpoint writes {probe.ms['save_run_state']} "
          f"ms, restore {r_probe.ms['restore_run_state']} ms")
    out["10c disk"] = launches
    out["10c resumed"] = r_launches
    return out


# ---------------------------------------------------------------------------
# phase 7: K6


def probe_bound_ms(chain, n, dtype, numel):
    """(bound ms, by) of one K6 launch: each element read and written once;
    per element the chain's FLOP (an FMA 2; mul, add and compare 1) at the
    dtype's rate and its exp at the dtype's special-function rate."""
    import torch

    if chain == "fma":
        flop, sfu = 2 * n, 0
    elif chain == "exp":
        flop, sfu = 2 * n, n
    else:
        flop, sfu = 2 * n + 3 * (n // 8), n // 8
    bf16 = dtype == torch.bfloat16
    rate = BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S
    sfu_rate = BF16_EXP_PER_S if bf16 else SFU_PER_S
    t_ops = max(numel * flop / rate, numel * sfu / sfu_rate) * 1e3
    elsize = 2 if dtype == torch.bfloat16 else 4
    t_bytes = 2 * numel * elsize / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_bf16_probe(dev):
    """Phase 7: K6 through its entry point (launches counted), then each
    case against the plain version and timed."""
    import torch

    from gaus_slam_tpu_torch.ops import _cuda
    from gaus_slam_tpu_torch.ops.bf16_probe import (CHAIN_LEN, SHAPE, probe,
                                                    probe_plain)
    from gaus_slam_tpu_torch.tools import bf16_probe as tool

    torch.cuda.synchronize()
    _cuda.clear_launches()
    check(tool.main([]) == 0, "the bf16 probe's entry point failed")
    torch.cuda.synchronize()
    launches = dict(_cuda.fold_launches())
    check(launches.get("bf16_probe", 0) > 0, "K6 never launched by its "
          "entry point")
    base = torch.as_tensor(np.random.default_rng(7).uniform(
        0.5, 1.5, SHAPE).astype(np.float32), device=dev)
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, t_ops=0.0)
    err, rates = 0.0, {}
    for chain, n in CHAIN_LEN.items():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x = base.to(dtype)
            k, p = probe(x, chain, n), probe_plain(x, chain, n)
            torch.cuda.synchronize()
            rel = float(((k.float() - p.float()).abs()
                         / p.float().abs().clamp(min=1e-30)).max())
            differ = float((k != p).float().mean())
            # f32: the kernel's FMA rounds once per step where the plain
            # version rounds twice; bf16: at most one bf16 ulp (2^-7)
            tol = 2e-5 if dtype == torch.float32 else 2.0 ** -7
            ms = time_graph_ms(lambda: probe(x, chain, n), 50)
            plain = time_ms(lambda: probe_plain(x, chain, n), 5, warm=1)
            bound, by = probe_bound_ms(chain, n, dtype, x.numel())
            gops = x.numel() * n / (ms * 1e-3) / 1e9
            rates[(chain, name)] = gops
            print(f"[bf16_probe] {chain:5s} {name:8s} max rel err {rel:.2e} "
                  f"(tol {tol:.1e}), elements differing {differ:.4f}; "
                  f"{ms * 1e3:.1f} us ({gops:.1f} Gop/s), plain "
                  f"{plain * 1e3:.1f} us, bound {bound * 1e3:.2f} us ({by})")
            check(rel <= tol and bool(torch.isfinite(k.float()).all()),
                  f"K6 {chain} {name} disagrees with its plain version")
            err = max(err, float((k.float() - p.float()).abs().max()))
            tot["ms"] += ms
            tot["plain_ms"] += plain
            tot["bound_ms"] += bound
            tot["t_ops"] += bound if by == "operations" else 0.0
    for chain in CHAIN_LEN:
        print(f"[bf16_probe] bf16/f32 ratio [{chain}]: "
              f"{rates[(chain, 'bfloat16')] / rates[(chain, 'float32')]:.2f}x")
    # the kernels line's entry: one launch of each of the six cases
    number = dict(max_abs_err=err, ms=tot["ms"], plain_ms=tot["plain_ms"],
                  bound_ms=tot["bound_ms"],
                  bound_by=("operations" if tot["t_ops"] >= tot["bound_ms"] / 2
                            else "bytes"),
                  library_ms=None)
    return launches, number


# ---------------------------------------------------------------------------
# phase 11: the bf16 compute dtype, and the last scripts

# Tolerances of the bf16 kernels against the plain bf16 chain on the card,
# relative to each channel's (stash row's) scale: both round the same ops
# to bf16, but the kernels sum the prefixes sequentially per pixel and the
# plain chain with cumsum; a prefix that lands across a bf16 rounding
# boundary moves that pair's T_pref by one bf16 step (2^-8 relative) and
# what follows from it. That is rare (tests/test_torch_bf16.py: 92-98% of
# the float values bit-equal on the CPU), so the bounds are quantiles:
# float channels q99 1e-3 and mean 1e-4 (the cancelling distortion
# channel 9 q99 1e-2, mean 1e-3), stash rows the same; under 0.5% of the
# pixels (stash entries) with another contributor count (done flag), 99%
# of the tiles with the same kexit.
# K2-bf16's gradient against the plain chain's vjp in float32 on the same
# rounded forward values (raster_backward_stash_plain(f32_vjp=True)), the
# arithmetic the kernel does: relative to the largest gradient, q99 1e-4
# and mean 1e-5; each attribute row within relative L2 3e-2 of the
# reference's row. Both sum the prefixes in their own order, so a pair's
# T_pref may round one bf16 step apart, and the geometry rows' sums over
# pixels cancel: phase 2's map reads q99 3.1e-5, mean 1.9e-6 and rows up
# to 1.3e-2 (cx, 3DGS coarse; 8.9e-3 with SA), the colour rows 1e-7,
# where a row scaled by 0.9 would read 0.1. Beside it, the gradient against torch.autograd through
# the plain bf16 chain (which rounds each cotangent to bf16, as the JAX
# package's gradient does) under tests/test_raster_grad.py:281-316's
# gradient bounds (q99 0.15, mean 3e-2; under 1% of the zero structure
# flipped); its worst row reads 10% relative L2 on phase 2's map.
TOL_BF16_Q99, TOL_BF16_MEAN = 1e-3, 1e-4
TOL_BF16_Q99_DIST, TOL_BF16_MEAN_DIST = 1e-2, 1e-3
TOL_BF16_GRAD_Q99, TOL_BF16_GRAD_MEAN, TOL_BF16_GRAD_ROW = 1e-4, 1e-5, 3e-2
# The gap of bf16 to the f32 kernels is printed under those bounds, not
# held to them: they were set at 32x32, and the bf16 chain's error grows
# with the pixel coordinates. bf16 holds them and the attributes to 8
# bits, so p = x a0 + y a1 + a2 cancels terms of a few hundred to a
# surfel's local coordinate, and past 256 the coordinates themselves
# round, to even numbers, past 512 to multiples of 4 (in the JAX package
# too: its compositing.py:122-127 casts px and py). The gap is printed for
# the tiles whose pixels all have x, y < 256 and for the whole image.
EXACT_BF16 = 256


def bf16_errors(got, ref, rows, scale_of=None):
    """Per row c of [n, C, P] (C = len(rows)): (q99, mean) of |got - ref|
    relative to the row's scale, on the pixels whose integer channels
    agree (``rows``: {c: "float" | "int"}). Returns (mismatch share,
    {c: (q99, mean)}, share of bit-equal float values)."""
    import torch

    agree = torch.ones_like(got[:, 0], dtype=torch.bool)
    for c, kind in rows.items():
        if kind == "int":
            agree &= got[:, c] == ref[:, c]
    frac = int((~agree).sum()) / agree.numel()
    errs, same, total = {}, 0, 0
    for c, kind in rows.items():
        if kind == "int":
            continue
        scale = (scale_of(c) if scale_of else None)
        if scale is None:
            scale = max(float(ref[:, c].abs().max()), 1e-6)
        d = ((got[:, c] - ref[:, c]).abs() / scale)[agree].double()
        errs[c] = ((float(torch.quantile(d[:2**24], 0.99)),
                    float(d.mean())) if d.numel() else (0.0, 0.0))
        same += int((got[:, c].view(torch.int32)
                     == ref[:, c].view(torch.int32)).sum())
        total += got[:, c].numel()
    return frac, errs, same / max(total, 1)


def bf16_ok(errs, dist_rows=()):
    return all(q <= (TOL_BF16_Q99_DIST if c in dist_rows else TOL_BF16_Q99)
               and m <= (TOL_BF16_MEAN_DIST if c in dist_rows
                         else TOL_BF16_MEAN)
               for c, (q, m) in errs.items())


def grad_rows_f32_vjp(g, ref):
    """K2-bf16's gradient ``g`` against the float32 vjp ``ref`` of the
    plain bf16 chain: (ok, report)."""
    import torch

    sc = max(float(ref.abs().max()), 1e-3)
    gerr = ((g - ref).abs() / sc).flatten().double()
    gq, gm = float(torch.quantile(gerr[:2**24], 0.99)), float(gerr.mean())
    ok = gq <= TOL_BF16_GRAD_Q99 and gm <= TOL_BF16_GRAD_MEAN
    rows = []
    for c in range(21):
        norm = float(ref[c].norm())
        if norm == 0.0:
            ok = ok and float(g[c].abs().max()) == 0.0
            continue
        rel = float((g[c] - ref[c]).norm()) / norm
        ok = ok and rel <= TOL_BF16_GRAD_ROW
        rows.append(f"{c}:{rel:.1e}")
    return ok, f"q99 {gq:.2e} mean {gm:.2e}, rows [{' '.join(rows)}]"


def grad_bounds(g, ref):
    """tests/test_raster_grad.py:281-316's gradient bounds of ``g``
    against ``ref``: (ok, report)."""
    import torch

    sc = max(float(ref.abs().max()), 1e-3)
    gerr = ((g - ref).abs() / sc).flatten().double()
    gq = float(torch.quantile(gerr[:2**24], 0.99))
    flip = float(((ref == 0) != (g == 0)).double().mean())
    ok = gq < 0.15 and float(gerr.mean()) < 3e-2 and flip < 0.01
    return ok, (f"grad q99 {gq:.2e} mean {float(gerr.mean()):.2e}, zero "
                f"flips {flip:.2e}")


def exact_region(ids, n_sub, ts, te, r, grid, dev):
    """(tiles, pair columns) of the tiles whose pixels all have x, y <
    EXACT_BF16 (exact in bf16), as masks."""
    import torch

    tid = torch.arange(n_sub, device=dev) if ids is None else ids.long()
    t_ok = (((tid % grid.tiles_x + 1) * grid.block_w <= EXACT_BF16)
            & ((tid // grid.tiles_x + 1) * grid.block_h <= EXACT_BF16))
    cols = torch.zeros(r, dtype=torch.bool, device=dev)
    for a, b in zip(ts[t_ok].tolist(), te[t_ok].tolist()):
        if b > a:
            cols[a:b] = True
    return t_ok, cols


def gap_to_f32(o16, o32, g16, g32):
    """tests/test_raster_grad.py:281-316's bounds of a bf16 render and
    gradient against the f32 ones: (ok, report)."""
    import torch

    ok, rep = True, []
    for c in range(9):
        sc = max(float(o32[:, c].abs().max()), 1e-3)
        err = ((o16[:, c] - o32[:, c]).abs() / sc).flatten().double()
        q99 = float(torch.quantile(err[:2**24], 0.99))
        ok = ok and q99 < (12e-2 if c == 8 else 6e-2) \
            and float(err.mean()) < 1.5e-2
        rep.append(f"{c}:{q99:.1e}/{float(err.mean()):.1e}")
    sc9 = max(float(o32[:, 9].abs().max()), 1e-3)
    e9 = float(((o16[:, 9] - o32[:, 9]).abs() / sc9).mean())
    ok = ok and e9 < 0.6
    gok, grep = grad_bounds(g16, g32)
    rep.append(f"9 mean {e9:.2e}; {grep}")
    return ok and gok, " ".join(rep)


def phase_bf16_kernels(ds, sys_cfg, capacity, dev, card):
    """Phase 11a: K1, K3 and K2 in bf16 on phase 2's random map, SA on with
    2DGS attributes and SA off with 3DGS ones (anisotropic), all tiles and
    the coarse subset, against the plain bf16 chain on the card, the f32
    kernels and the bf16 cull; ms, plain ms and bounds on each variant's
    full case. Returns ({name: numbers} for SA on 2DGS, the same for SA
    off on 3DGS)."""
    import torch

    from gaus_slam_tpu_torch.ops.raster_backward import (
        raster_backward_stash, raster_backward_stash_plain)
    from gaus_slam_tpu_torch.ops.raster_forward import (raster_forward,
                                                        raster_forward_plain,
                                                        raster_forward_stash,
                                                        stash_offsets)

    cam = sys_cfg.cam
    gm = random_map(ds, cam, capacity, dev)
    rng = np.random.default_rng(11)
    out_rows = {c: "float" for c in range(13)}
    out_rows.update({13: "int", 14: "int", 15: "int"})
    stash_rows = {0: "float", 1: "int", 2: "float", 3: "float", 4: "float",
                  5: "float", 6: "float"}
    results = ({}, {})
    for vi, (variant, opts, use_sa) in enumerate((
            ("2dgs SA", sys_cfg.opts, True),
            ("3dgs no-SA", sys_cfg.opts._replace(method="3dgs"), False))):
        kw = dict(grid=opts.grid, use_sa=use_sa, need_normal=False)
        k16 = dict(kw, compute_dtype="bf16")
        _, cases = kernel_inputs(gm, cam, opts,
                                 sys_cfg.track_front.coarse_stride)
        for case, (pattrs, ts, te, ids) in cases.items():
            label = f"{variant} {case}"
            n_sub = int(ts.shape[0])
            k_out, k_stash, k_kexit = raster_forward_stash(
                pattrs, ts, te, tile_ids=ids, **k16)
            k3 = raster_forward(pattrs, ts, te, tile_ids=ids, **k16)
            p_out, p_stash, p_kexit = raster_forward_plain(
                pattrs, ts, te, tile_ids=ids, **k16)
            f_out, f_stash, f_kexit = raster_forward_stash(
                pattrs, ts, te, tile_ids=ids, **kw)
            torch.cuda.synchronize()
            mm, dd = p_out[:, 8].abs(), p_out[:, 3].abs()
            dist_scale = (max(float((mm * dd + mm * mm).max()), 1e-6)
                          if use_sa else None)
            frac, errs, bits = bf16_errors(
                k_out, p_out, out_rows,
                lambda c: dist_scale if c == 9 else None)
            kex_agree = float((k_kexit == p_kexit).float().mean())
            same_k = torch.nonzero(k_kexit == p_kexit)[:, 0].tolist()
            soff = stash_offsets(ts, te).long()
            srows = torch.cat([torch.arange(int(soff[i]), int(soff[i])
                                            + int(k_kexit[i]), device=dev)
                               for i in same_k] or
                              [torch.zeros(0, dtype=torch.long, device=dev)])
            sfrac, serrs, sbits = bf16_errors(k_stash[srows], p_stash[srows],
                                              stash_rows)
            k3_same = bool(torch.equal(k3, k_out))
            d_out = torch.zeros_like(k_out)
            d_out[:, :10] = torch.as_tensor(
                rng.normal(size=(n_sub, 10, k_out.shape[-1])).astype(
                    np.float32), device=dev)
            bargs = (pattrs, ts, te, k_stash, k_kexit, k_out, d_out)
            k_grad = raster_backward_stash(*bargs, tile_ids=ids, **k16)
            p_grad = raster_backward_stash_plain(*bargs, tile_ids=ids, **k16)
            v_grad = raster_backward_stash_plain(*bargs, tile_ids=ids,
                                                 f32_vjp=True, **k16)
            f_grad = raster_backward_stash(pattrs, ts, te, f_stash, f_kexit,
                                           f_out, d_out, tile_ids=ids, **kw)
            torch.cuda.synchronize()
            rel = {c: float((k_grad[c] - p_grad[c]).norm()
                            / p_grad[c].norm())
                   for c in range(21) if float(p_grad[c].norm()) > 0}
            gbits = float((k_grad.view(torch.int32)
                           == v_grad.view(torch.int32)).double().mean())
            g_ok, g_rep = grad_bounds(k_grad, p_grad)
            v_ok, v_rep = grad_rows_f32_vjp(k_grad, v_grad)
            t_ok, cols = exact_region(ids, n_sub, ts, te, pattrs.shape[1],
                                      opts.grid, dev)
            gap_ok, gap_rep = gap_to_f32(k_out[t_ok], f_out[t_ok],
                                         k_grad[:, cols], f_grad[:, cols])
            _, gap_all = gap_to_f32(k_out, f_out, k_grad, f_grad)
            err1 = float((k_out[:, :13] - p_out[:, :13]).abs().max())
            err2 = float((k_grad - v_grad).abs().max())
            print(f"[bf16 kernels] K1 {label}: {n_sub} tiles; int-channel "
                  f"mismatch {frac:.2e} (< 5e-3), q99/mean relative by "
                  f"channel [" + " ".join(
                      f"{c}:{q:.1e}/{m:.1e}" for c, (q, m) in errs.items())
                  + f"], bit-equal share {bits:.4f}; kexit agree "
                  f"{kex_agree:.4f}; stash: done mismatch {sfrac:.2e}, "
                  f"by row [" + " ".join(
                      f"{c}:{q:.1e}/{m:.1e}" for c, (q, m) in serrs.items())
                  + f"], bit-equal share {sbits:.4f}; K3 == K1 out: "
                  f"{k3_same}")
            print(f"[bf16 kernels] K2 {label}: against the float32 vjp of "
                  f"the plain chain {v_rep} (tol q99 {TOL_BF16_GRAD_Q99}, "
                  f"mean {TOL_BF16_GRAD_MEAN}, rows {TOL_BF16_GRAD_ROW}), "
                  f"bit-equal share {gbits:.4f}; against torch.autograd of the plain "
                  f"chain {g_rep} (test_raster_grad's bounds: q99 0.15, "
                  f"mean 3e-2, flips 1e-2), worst row relative L2 "
                  f"{max(rel.values()):.2e} (row {max(rel, key=rel.get)}); "
                  f"pad rows {float(k_grad[21:].abs().max())}")
            print(f"[bf16 kernels] {label}: gap to the f32 kernels (q99/mean "
                  f"by channel) on the {int(t_ok.sum())} tiles with x, y < "
                  f"{EXACT_BF16} [{gap_rep}]: "
                  f"{'within' if gap_ok else 'OUTSIDE'} test_raster_grad's "
                  f"bounds; on all {n_sub} tiles [{gap_all}]")
            check(frac < 5e-3 and bf16_ok(errs, (9,)),
                  f"K1-bf16 {label} disagrees with its plain version")
            check(kex_agree >= 0.99, f"K1-bf16 {label}: kexit disagrees")
            check(sfrac < 5e-3 and bf16_ok(serrs),
                  f"K1-bf16 {label}: stash disagrees")
            check(k3_same, f"K3-bf16 {label} differs from K1-bf16's out")
            check(v_ok and float(k_grad[21:].abs().max()) == 0.0,
                  f"K2-bf16 {label} disagrees with the float32 vjp of the "
                  f"plain bf16 chain")
            check(g_ok, f"K2-bf16 {label} disagrees with torch.autograd "
                  f"through the plain bf16 chain")
            check(not torch.equal(k_out, f_out),
                  f"phase 11a {label}: bf16 rounded nothing")
            if case != "full":
                continue
            evals, culled, accepted, wrong = pair_pixel_work(
                pattrs, ts, te, k_out, opts.grid, bf16=True)
            print(f"[bf16 kernels] {label}: (pair, pixel) evaluations "
                  f"{evals:.6g}, culled {culled:.6g}, accepted "
                  f"{accepted:.6g}; culled although the bf16 alpha test "
                  f"passes: {wrong}")
            check(wrong == 0, f"phase 11a {label}: the bf16 cull rejected "
                  f"{wrong} (pair, pixel) that pass the bf16 alpha test")
            out_bytes = k_out.numel() * 4
            in_bytes = pattrs.numel() * 4 + 3 * n_sub * 4
            stash_bytes = int(k_kexit.sum()) * 8 * 256 * 4
            t_k1 = time_ms(lambda: raster_forward_stash(pattrs, ts, te, **k16),
                           10)
            t_k3 = time_ms(lambda: raster_forward(pattrs, ts, te, **k16), 10)
            t_k2 = time_ms(lambda: raster_backward_stash(*bargs, **k16), 5)
            # the F32 instantiations on the same case
            fargs = (pattrs, ts, te, f_stash, f_kexit, f_out, d_out)
            t_f1 = time_ms(lambda: raster_forward_stash(pattrs, ts, te, **kw),
                           10)
            t_f3 = time_ms(lambda: raster_forward(pattrs, ts, te, **kw), 10)
            t_f2 = time_ms(lambda: raster_backward_stash(*fargs, **kw), 5)
            t_p1 = time_ms(lambda: raster_forward_plain(pattrs, ts, te,
                                                        **k16), 2, warm=1)
            t_p2 = time_ms(lambda: raster_backward_stash_plain(*bargs, **k16),
                           1, warm=1)
            fwd_acc = FWD_ACCEPTED if use_sa else FWD_ACCEPTED_NO_SA
            bwd_acc = BWD_ACCEPTED if use_sa else BWD_ACCEPTED_NO_SA
            work = {
                "raster_forward_stash_bf16": (
                    t_k1, t_f1, t_p1, fwd_acc,
                    in_bytes + out_bytes + stash_bytes, err1),
                "raster_forward_bf16": (t_k3, t_f3, t_p1, fwd_acc,
                                        in_bytes + out_bytes, err1),
                "raster_backward_stash_bf16": (
                    t_k2, t_f2, t_p2, bwd_acc,
                    2 * in_bytes + 2 * out_bytes + stash_bytes, err2)}
            for name, (ms, fms, pms, per, nb, err) in work.items():
                # the function's bound at the bf16 rates (the chain's adds,
                # subs and muls run packed in bf16x2); the f32 rate's beside
                # it
                b = op_bound(evals, accepted, per, nb, culled=culled,
                             bf16=True)
                share = gbits if "backward" in name else bits
                results[vi][name] = dict(
                    max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0],
                    bound_by=b[1], library_ms=None,
                    bound_ms_f32_rate=op_bound(evals, accepted, per, nb,
                                               culled=culled)[0],
                    bit_equal_share=share, f32_ms=fms)
                print(f"[bf16 kernels] {variant} {KERNELS[name][0]}: "
                      f"{ms:.4f} ms, its F32 instantiation {fms:.4f} ms on "
                      f"the same case, ratio {ms / fms:.3f}; bound "
                      f"{b[0]:.4f} ms ({b[1]}); floats bit-equal to the "
                      f"plain bf16 chain{' (its float32 vjp)' if 'backward' in name else ''}: "
                      f"{share:.4f}")
            print(f"[card] {card_line()}")
            print(f"[bf16 kernels] {variant} ms: K1-bf16 {t_k1:.4f} (plain "
                  f"{t_p1:.1f}), K3-bf16 {t_k3:.4f}, K2-bf16 {t_k2:.4f} "
                  f"(plain {t_p2:.1f}); bounds at the bf16 rates (at the "
                  f"f32 rate) " + ", ".join(
                      f"{KERNELS[k][0]} {v['bound_ms']:.4f} "
                      f"({v['bound_ms_f32_rate']:.4f})"
                      for k, v in results[vi].items()))
    return results


def set_bf16(cfg):
    cfg.setdefault("tpu", {})["compute_dtype"] = "bf16"


def region_psnr(label, frames, dev):
    """Mean PSNR (valid-depth pixels, as eval_final) of the saved scene of
    run ``label`` at its own poses over ``frames``, on the pixels with x,
    y < EXACT_BF16 and on the rest."""
    import torch

    from gaus_slam_tpu_torch.data import get_dataset
    from gaus_slam_tpu_torch.ops.composite_ref import tiles_to_image
    from gaus_slam_tpu_torch.render import render_view
    from gaus_slam_tpu_torch.utils.config import SystemConfig
    from gaus_slam_tpu_torch.utils.image_metrics import psnr
    from gaus_slam_tpu_torch.utils.scene_io import load_scene

    config, gm, w2cs, _ = load_scene(os.path.join(out_dir(label), "scene"),
                                     device=dev)
    s = SystemConfig.from_config(config, device=dev)
    ds = get_dataset(config["data"])
    e, inside, outside = EXACT_BF16, [], []
    yy, xx = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    region = (xx < e) & (yy < e)
    with torch.no_grad():
        for i in frames:
            color, depth, _, _ = ds[i]
            gt = torch.as_tensor(np.asarray(color, np.float32) / 255.0,
                                 device=dev)
            valid = torch.as_tensor(np.asarray(depth, np.float32).squeeze(),
                                    device=dev) > 0
            out = render_view(gm, s.cam.replace_w2c(torch.as_tensor(
                w2cs[i], dtype=torch.float32, device=dev)), s.opts)
            rgb = torch.clamp(tiles_to_image(out[:, 0:3], s.opts.grid, H, W)
                              .permute(1, 2, 0), 0.0, 1.0)
            inside.append(float(psnr(rgb, gt, mask=valid & region)))
            outside.append(float(psnr(rgb, gt, mask=valid & ~region)))
    return float(np.mean(inside)), float(np.mean(outside))


def phase_bf16_driver(dev, fps_f32):
    """Phase 11b: the driver with tpu.compute_dtype "bf16" at 48x64 x 12
    (SMALL_BOUNDS_BF16) and at 340x600 x 30 (phase 6's ATE bound, and its
    first-submap PSNR bound moved by the JAX package's 340x600 bf16-f32
    render gap: PSNR_MIN_BF16), the PSNR on the pixels with x, y < 256
    and on the rest printed beside phase 6's; only the bf16
    instantiations of K1-K3 launch."""
    small = phase_driver_small(dev, label="bf16_48x64",
                               bounds=SMALL_BOUNDS_BF16, edit=set_bf16)
    full, probe = phase_driver_full(dev, label="bf16_340x600", edit=set_bf16,
                                    suffix="_bf16", psnr_min=PSNR_MIN_BF16)
    first = range(probe.merges[0]["frames"][0], probe.merges[0]["frames"][1])
    r16 = region_psnr("bf16_340x600", first, dev)
    r32 = region_psnr("driver_340x600", first, dev)
    print(f"[bf16_340x600] first-submap PSNR on the pixels with x, y < "
          f"{EXACT_BF16} / on the rest: bf16 {r16[0]:.4f} / {r16[1]:.4f}, "
          f"phase 6's f32 {r32[0]:.4f} / {r32[1]:.4f}")
    for launches, label in ((small, "48x64"), (full, "340x600")):
        for name in BF16_PATH:
            check(launches.get(name, 0) > 0,
                  f"phase 11b {label}: {name} never launched")
        for name in ("raster_forward_stash", "raster_backward_stash",
                     "raster_forward", "raster_backward"):
            check(launches.get(name, 0) == 0,
                  f"phase 11b {label}: the f32 {name} launched")
    print(f"[bf16_340x600] {probe.fps:.3f} frames/s against phase 6's f32 "
          f"{fps_f32:.3f} in this call")
    return small, full


def phase_scripts(dev):
    """Phase 11c: eval_nvs, gen_video and keyframe_overlap on phase 6's
    saved scene."""
    import torch

    from gaus_slam_tpu_torch.ops.camera import camera_from_intrinsics
    from gaus_slam_tpu_torch.ops.geometry import points_from_depth
    from gaus_slam_tpu_torch.ops.se3 import invert_se3, transform_points
    from gaus_slam_tpu_torch.scripts import eval_nvs, gen_video
    from gaus_slam_tpu_torch.utils import gif, viz
    from gaus_slam_tpu_torch.utils.keyframe_selection import (
        keyframe_overlap, points_overlap)

    scene = os.path.join(out_dir("driver_340x600"), "scene")
    t0 = time.perf_counter()
    r0 = eval_nvs.evaluate(scene, pose_refine=False, frames=range(0, 30, 6))
    t1 = time.perf_counter()
    r1 = eval_nvs.evaluate(scene, frames=range(0, 30, 6))
    t2 = time.perf_counter()
    print(f"[eval_nvs] without refinement {json.dumps(r0)} ({t1 - t0:.1f} "
          f"s); with {json.dumps(r1)} ({t2 - t1:.1f} s)")
    for r in (r0, r1):
        for k in ("NVS PSNR", "NVS MS-SSIM", "NVS Depth L1"):
            check(np.isfinite(r[k]), f"phase 11c: eval_nvs {k} {r[k]}")
    check(r1["NVS PSNR"] >= r0["NVS PSNR"] - 0.1,
          f"phase 11c: pose refinement lowered NVS PSNR from "
          f"{r0['NVS PSNR']} to {r1['NVS PSNR']}")

    captured = []
    write = viz.frames_to_video

    def spy(frames, path, fps=30):
        captured.append([np.asarray(f) for f in frames])
        return write(frames, path, fps)

    viz.frames_to_video = spy
    try:
        for argv in ([scene, "--stride", "2"],
                     [scene, "--mesh", "--n_frames", "8"]):
            t0 = time.perf_counter()
            path = gen_video.main(argv)
            secs = time.perf_counter() - t0
            frames = captured[-1]
            check(path.endswith(".gif"), f"phase 11c: gen_video wrote "
                  f"{path}, not the port's GIF")
            _, idx = gif.read_gif(path)
            want = np.stack([gif.quantize(np.clip(f * 255, 0, 255).astype(
                np.uint8)) for f in frames])
            same = idx.shape == want.shape and bool((idx == want).all())
            print(f"[gen_video] {' '.join(argv[1:])}: {len(frames)} frames "
                  f"of {frames[0].shape}, {os.path.getsize(path)} bytes in "
                  f"{path}, {secs:.1f} s; decoded == quantized frames: "
                  f"{same}")
            check(same, f"phase 11c: {path} does not decode to its frames")
            check(float(np.stack(frames).max()) > 0.1,
                  f"phase 11c: gen_video {argv[1:]} rendered black frames")
    finally:
        viz.frames_to_video = write

    from gaus_slam_tpu_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(height=H, width=W, num_frames=30)
    _, depth, k, c2w = ds[6]
    kfs = np.stack([np.linalg.inv(ds[i][3]) for i in (0, 3, 9, 12, 20, 29)])
    # frame 6's valid pixels back-projected once (on the CPU), scored
    # against six keyframe poses on the card and on the CPU
    cpu = torch.device("cpu")
    cam = camera_from_intrinsics(H, W, k, np.eye(4), device=cpu)
    dep = torch.as_tensor(np.asarray(depth, np.float32).squeeze())
    w2c = torch.as_tensor(np.linalg.inv(c2w), dtype=torch.float32)
    pts_w = transform_points(invert_se3(w2c), points_from_depth(
        dep, cam).reshape(-1, 3)[(dep > 0).reshape(-1)])
    n_pts = int(pts_w.shape[0])
    kf_t = torch.as_tensor(kfs, dtype=torch.float32)
    sums = [points_overlap(pts_w.to(d), kf_t.to(d), cam, H, W).cpu()
            for d in (dev, cpu)]
    sampled = keyframe_overlap(dep.to(dev), w2c.to(dev), cam,
                               kf_t.to(dev)).cpu()
    gap = float((sums[0] - sums[1]).abs().max())
    print(f"[keyframe_overlap] exact overlaps over {n_pts} points, card "
          f"{sums[0].tolist()}, CPU {sums[1].tolist()} (equal: "
          f"{bool(torch.equal(sums[0], sums[1]))}); sampled on the card "
          f"{sampled.tolist()}")
    check(gap <= 1.0 / n_pts, f"phase 11c: points_overlap on the card and "
          f"on the CPU differ by {gap}, more than one point of {n_pts}")
    check(float((sampled - sums[0]).abs().max()) < 0.05,
          "phase 11c: keyframe_overlap's 1600 draws stray from the exact "
          "overlap")


def phase_microbench(dev):
    """Phase 11d: tools/microbench.py at its defaults."""
    from gaus_slam_tpu_torch.tools import microbench

    t0 = time.perf_counter()
    ms = microbench.main([])
    print(f"[microbench] ms per stage {json.dumps(ms)} ({time.perf_counter() - t0:.1f} s)")
    check(all(np.isfinite(v) and v > 0 for v in ms.values()) and
          len(ms) == len(microbench.STAGES), "phase 11d: a stage failed")


# ---------------------------------------------------------------------------
# phase 12: the last tools


def child_launches(path):
    """The launch counts the child processes appended to ``path``
    (ops/_cuda.py's GAUS_LAUNCH_LOG), summed."""
    import collections

    total = collections.Counter()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                total.update(json.loads(line)["launches"])
    return dict(total)


@contextlib.contextmanager
def launch_log(name):
    """GAUS_LAUNCH_LOG set to a fresh file for the child processes started
    inside; yields its path."""
    from gaus_slam_tpu_torch.ops import _cuda

    path = os.path.join(out_dir(name), "launches.jsonl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    old = os.environ.get(_cuda.LAUNCH_LOG_ENV)
    os.environ[_cuda.LAUNCH_LOG_ENV] = path
    try:
        yield path
    finally:
        if old is None:
            os.environ.pop(_cuda.LAUNCH_LOG_ENV)
        else:
            os.environ[_cuda.LAUNCH_LOG_ENV] = old


def phase_backend_probe(card):
    """Phase 12a: tools/backend_probe.py at its defaults."""
    from gaus_slam_tpu_torch.ops import _cuda
    from gaus_slam_tpu_torch.tools import backend_probe

    for k in ("PROBE_H", "PROBE_W", "PROBE_REPS"):
        check(k not in os.environ, f"phase 12a: {k} is set; the probe runs "
              f"at its defaults")
    _cuda.clear_launches()
    t0 = time.perf_counter()
    res = backend_probe.main([])
    secs = time.perf_counter() - t0
    launches = dict(_cuda.fold_launches())
    stages = ("bin", "map1", "map4", "map4c", "trk", "trkc")
    print(f"[backend_probe] {card}: 680x1200, capacity {res['capacity']}, "
          f"active {res['n_active']}; ms per call (wall between fences):")
    for tag in ("factor1.75", "paircap"):
        b = res["bins"][tag]
        print(f"[backend_probe] {tag} (r_max {b['r_max']}: demand "
              f"{b['demand']}, num_pairs {b['num_pairs']}, overflow "
              f"{b['overflow']}): " + ", ".join(
                  f"{k} {res[tag][k]:.3f}" for k in stages))
    print(f"[backend_probe] peak device memory {res['peak_mib']:.1f} MiB; "
          f"launches {json.dumps(launches)}; {secs:.1f} s")
    check(res["capacity"] == 2883584, f"phase 12a: capacity "
          f"{res['capacity']}, not bucket_capacity(2.36e6) = 2883584")
    for tag in ("factor1.75", "paircap"):
        for k in stages:
            v = res[tag][k]
            check(v is not None and np.isfinite(v) and v > 0,
                  f"phase 12a: {tag} {k} = {v}")
    b = res["bins"]["paircap"]
    check(not b["overflow"] and b["num_pairs"] == b["demand"] > 0,
          f"phase 12a: the pair cap's bin {b}")
    for tag in ("factor1.75", "paircap"):
        got = dict(demand=res["bins"][tag]["demand"],
                   num_pairs=res["bins"][tag]["num_pairs"],
                   n_active=res["n_active"])
        check(got == PARENT_PROBE, f"phase 12a: {tag}: {got} moved from the "
              f"earlier code's {PARENT_PROBE}")
    check_launches("phase 12a", launches,
                   want=("raster_forward_stash", "raster_backward_stash",
                         "monotone_row_gather"))
    return launches


def phase_quality_ab(card):
    """Phase 12b: tools/quality_ab.py, the default variant, seed 0, 100
    frames at 340x600, through its child process."""
    from gaus_slam_tpu_torch.tools import quality_ab

    out = out_dir("quality_ab")
    rows_path = os.path.join(out, "rows.jsonl")
    if os.path.exists(rows_path):
        os.remove(rows_path)
    t0 = time.perf_counter()
    with launch_log("quality_ab") as log:
        rows = quality_ab.main(["--variants", "default", "--seeds", "0",
                                "--frames", "100", "--height", str(H),
                                "--width", str(W), "--out", rows_path,
                                "--out-root", out])
    secs = time.perf_counter() - t0
    launches = child_launches(log)
    print(f"[quality_ab] {card}: rows {json.dumps(rows)}; launches in the "
          f"child {json.dumps(launches)}; {secs:.1f} s")
    check(len(rows) == 1 and "error" not in rows[0],
          f"phase 12b: quality_ab gave {rows}")
    r = rows[0]
    ok_ate = np.isfinite(r["ate_rmse"]) and r["ate_rmse"] < T_ERR_ABS
    ok_psnr = np.isfinite(r["psnr"]) and r["psnr"] > PSNR_MIN
    print(f"[quality_ab] ATE RMSE {r['ate_rmse']:.6g} (bound < {T_ERR_ABS}): "
          f"{'pass' if ok_ate else 'FAIL'}; PSNR {r['psnr']:.6g} over the "
          f"100 frames (bound > {PSNR_MIN}): {'pass' if ok_psnr else 'FAIL'}")
    check(ok_ate and ok_psnr, f"phase 12b: the row {r} misses phase 6's "
          f"bounds")
    check_launches("phase 12b", launches)
    return launches


def phase_test_spread(dev, card):
    """Phase 12c: tools/test_spread.py, seeds 0 and 1 at 48x64 x 12."""
    from gaus_slam_tpu_torch.tools import test_spread

    out = out_dir("test_spread")
    path = os.path.join(out, "spread.json")
    if os.path.exists(path):
        os.remove(path)
    t0 = time.perf_counter()
    with launch_log("test_spread") as log:
        summary = test_spread.main(["--seeds", "0", "1", "--device", "cuda",
                                    "--out", path, "--out-root", out])
    secs = time.perf_counter() - t0
    launches = child_launches(log)
    rows = summary["rows"]
    print(f"[test_spread] {card}: {summary['workload']}; rows "
          f"{json.dumps(rows)}; launches in the children "
          f"{json.dumps(launches)}; {secs:.1f} s")
    check(sorted(r["seed"] for r in rows) == [0, 1],
          f"phase 12c: rows for seeds {[r['seed'] for r in rows]}")
    check_launches("phase 12c", launches)
    keys = {"ATE RMSE": "ate_rmse", "PSNR": "psnr", "MS-SSIM": "ms_ssim",
            "Depth L1": "depth_l1"}
    with open(JAX_SPREAD) as f:
        jax = json.load(f)
    jax_rows = {r["seed"]: r for r in jax["rows"]}
    b = jax["suggested_bounds"]
    spread_bounds = {"ATE RMSE": ("<", b["ate_lt"]),
                     "PSNR": (">", b["psnr_gt"]),
                     "Depth L1": ("<", b["depth_l1_lt"])}
    for r in rows:
        label = f"spread_seed{r['seed']}"
        check(0 < r["fscore"] <= 1, f"phase 12c: {label} F-score "
              f"{r['fscore']}")
        if not small_bounds_failed(label, {k: r[v] for k, v in keys.items()}):
            continue
        j = jax_rows[r["seed"]]
        jax_missed = small_bounds_failed(
            f"{label} (JAX package)", {k: j[v] for k, v in keys.items()})
        if jax_missed:
            print(f"[{label}] the JAX package misses those bounds at this "
                  f"seed too; held to its five seeds' suggested bounds "
                  f"{json.dumps(b)}")
            check(not small_bounds_failed(
                label, {k: r[keys[k]] for k in spread_bounds}, spread_bounds)
                and r["fscore"] > b["fscore_gt"],
                f"phase 12c: {label} misses the JAX spread's bounds")
        else:
            # phase 5's allowance: rerun the seed here to read its keyframe
            # tests, and the control with the borderline one reversed
            phase_driver_small(dev, label, seed=r["seed"])
    return launches


# ---------------------------------------------------------------------------
# phase 13: the captured steps


N_FRAMES_PROGRAMS = 12   # 13a: one cut, at frame 10
X4_LAUNCH_LIMIT = 10     # 13b: graph launches + kernels outside a graph
def programs_frontend(cfg, ds, dev, eager):
    """13a: a Frontend over frames 0 .. N_FRAMES_PROGRAMS-1, then
    process_final, with its steps captured (or all under
    programs.eager()); returns (per-frame (w2c, tracking record), the
    LocalMaps cut, the final map's arrays, the Frontend)."""
    from gaus_slam_tpu_torch.slam import programs
    from gaus_slam_tpu_torch.slam.frontend import Frontend
    from gaus_slam_tpu_torch.utils.checkpoint import _flatten, _map_state

    fe = Frontend(cfg, queue.Queue(), device=dev)
    recs, lms = [], []
    with (programs.eager() if eager else contextlib.nullcontext()):
        for t in range(N_FRAMES_PROGRAMS):
            color, depth, _, c2w = ds[t]
            fe.process_frame(t, np.asarray(color, np.float32)
                             / np.float32(255), np.asarray(depth), c2w)
            while not fe.to_backend.empty():
                lms.append(fe.to_backend.get())
            last = fe.local_frames[-1]
            recs.append((np.asarray(getattr(last, "_w2c_host", np.eye(4))),
                         fe.last_track))
        fe.process_final()
        while not fe.to_backend.empty():
            lms.append(fe.to_backend.get())
    sync(dev)
    return recs, lms, _flatten(_map_state(fe.map)), fe


def programs_backend(cfg, lms, dev, eager):
    """13a: a Backend (random_process off) merging copies of ``lms``,
    each merge's task queue drained (fused x4 batches dense and coarse,
    prune, backend tracking), then two each of the per-step mapping, ba
    and tracking tasks on the first submap; captured or all under
    programs.eager().
    Returns the backend's state arrays and the Backend."""
    import copy

    from gaus_slam_tpu_torch.slam import programs
    from gaus_slam_tpu_torch.slam.backend import Backend
    from gaus_slam_tpu_torch.utils.checkpoint import backend_state_arrays

    cfg = copy.deepcopy(cfg)
    cfg["backend"]["random_process"] = False
    be = Backend(cfg, device=dev)
    with (programs.eager() if eager else contextlib.nullcontext()):
        for lm in copy.deepcopy(lms):
            be.process_localmap(lm)
        for _ in range(2):
            be.mapping(0)
            be.ba(0)
            be.tracking(0)
        be._check_escalation()
    sync(dev)
    return backend_state_arrays(be), be


def eval_inputs(frame, ds, dev):
    """A Frontend frame's eval_final inputs at its pose."""
    import torch

    color, depth, _, _ = ds[frame.time_idx]
    w2c = torch.as_tensor(np.asarray(frame.get_w2c.detach().cpu()),
                          device=dev)
    return (w2c, torch.as_tensor(np.asarray(color, np.float32) / 255.0,
                                 device=dev),
            torch.as_tensor(np.asarray(depth, np.float32), device=dev))


def programs_eval(fe, ds, dev, card):
    """13a: utils/eval.py's eval frame (render, image, PSNR, MS-SSIM, depth
    metrics) captured against programs.eager() on the Frontend's map and
    frames, bit for bit; ms per eval frame each way."""
    import torch

    from gaus_slam_tpu_torch.slam import programs
    from gaus_slam_tpu_torch.utils.eval import _eval_frame

    s = fe.sys
    own = programs.Owner("13-eval")
    frames = [f.time_idx for f in fe.local_frames]
    ins = [eval_inputs(f, ds, dev) for f in fe.local_frames]
    for t, (w2c, color, depth) in zip(frames, ins):
        vals, rgb = _eval_frame(fe.map, w2c, color, depth, s.cam, s.opts,
                                s.lcfg, owner=own)
        rgb = rgb.clone()
        with programs.eager():
            v_e, rgb_e = _eval_frame(fe.map, w2c, color, depth, s.cam,
                                     s.opts, s.lcfg)
        check(torch.equal(vals, v_e) and torch.equal(rgb, rgb_e),
              f"phase 13: the eval frame {t} differs from its eager run "
              f"({vals.tolist()} against {v_e.tolist()})")
    ms = {}
    for label, ctx in (("captured", contextlib.nullcontext),
                       ("eager", programs.eager)):
        def run():
            with ctx():
                for w2c, color, depth in ins:
                    _eval_frame(fe.map, w2c, color, depth, s.cam, s.opts,
                                s.lcfg, owner=own)
        ms[label] = time_ms(run, 3, warm=1) / len(ins)
    print(f"[programs] {card}: the eval frame captured equals its eager run "
          f"bit for bit on {len(ins)} frames; ms per eval frame (render, "
          f"PSNR, MS-SSIM, depth; LPIPS apart) captured {ms['captured']:.3f}, "
          f"eager {ms['eager']:.3f}")
    return ms


def programs_sharded(be, dev, card):
    """13a: the sharded BA step over BA_GROUP slots of the card, two
    chained steps with weights 1 and with [1, 1, 1, 0], captured (shard
    owners and a map owner) against programs.eager(), bit for bit."""
    import torch

    from gaus_slam_tpu_torch.parallel import sharded_ba_step
    from gaus_slam_tpu_torch.slam import programs

    s = be.sys
    lm = be.local_maps[0]
    fids = [lm.saved_idxs[k % len(lm.saved_idxs)] for k in range(BA_GROUP)]
    w2cs = torch.stack([lm.get_frame_w2c(f).detach() for f in fids])
    gts = torch.stack([be._tile_gt(lm.frames[f]) for f in fids])
    devs = [torch.device(dev)] * BA_GROUP
    gm0 = programs._clone(be.map)
    for weights in (None, [1, 1, 1, 0]):
        owners = [programs.Owner(f"13-shard{k}", device=d)
                  for k, d in enumerate(devs)] + [programs.Owner("13-map")]
        runs = []
        for ctx, own in ((contextlib.nullcontext, owners),
                         (programs.eager, None)):
            gm, out = gm0, []
            with ctx():
                for _ in range(2):
                    gm, loss, diag = sharded_ba_step(
                        devs, gm, w2cs, gts, s.cam, s.opts, s.mcfg, s.lcfg,
                        weights=weights, owners=own)
                    out.append(programs._clone((loss, diag)))
            runs.append(programs._clone((gm, out)))
        a, b = ([t for _, t in _leaves(r)] for r in runs)
        check(len(a) == len(b) and all(torch.equal(x, y)
                                       for x, y in zip(a, b)),
              f"phase 13: the captured sharded step (weights {weights}) "
              f"differs from its eager run")
    print(f"[programs] {card}: the sharded BA step over {BA_GROUP} slots, "
          f"captured ({BA_GROUP} shard programs and the reduction), equals "
          f"its eager run bit for bit over two chained steps, weights 1 and "
          f"[1, 1, 1, 0]")


def _leaves(tree):
    from gaus_slam_tpu_torch.slam import programs

    out = []
    programs._flatten(tree, "", out)
    return out


def step_window(fn) -> dict:
    """One call of ``fn`` (its programs captured before) under
    torch.profiler (tools/sync_audit.py::profile_window): wall ms, device
    busy ms, idle share and launches."""
    from gaus_slam_tpu_torch.tools.sync_audit import profile_window

    w = profile_window(fn)
    w["idle"] = (1 - w["busy"] / w["wall"]) if w["busy"] > 0 else None
    return w


def pool_bytes() -> int:
    """Bytes the caching allocator holds in graph pools (segments of a
    private pool)."""
    import torch

    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def phase_programs(cfg, ds, dev, card):
    """Phase 13: the captured steps (slam/programs.py)."""
    import torch

    from gaus_slam_tpu_torch.models import gaussians as G
    from gaus_slam_tpu_torch.models.frame import _f32_pow, bias_table
    from gaus_slam_tpu_torch.ops.consts import at, div_by_entry
    from gaus_slam_tpu_torch.slam import programs

    # the step tables on the card: an entry's multiplication equals the
    # division by the host float it replaces (CUDA multiplies by the
    # float32 reciprocal), at steps 1 .. 300
    x = torch.randn(1 << 16, device=dev)
    for b in (0.9, 0.999, 0.7, 0.99):
        for kind, tab, host in (
                ("map", G.bias_table(b, dev), lambda t: G._bias_correction(
                    b, t)),
                ("pose", bias_table(b, dev), lambda t: 1 - _f32_pow(b, t))):
            for t in range(1, 301):
                d = at(tab, torch.tensor(t, dtype=torch.int32, device=dev))
                check(torch.equal(div_by_entry(x, d), x / host(t)),
                      f"phase 13: the {kind} bias table of {b} at step {t} "
                      f"does not divide as the host float")
    print(f"[programs] {card}: bias-correction tables divide bit-equal to "
          f"the host floats at steps 1-300 (betas 0.9, 0.999, 0.7, 0.99)")

    # 13a: every program bit-equal to its eager run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    f_prog = programs_frontend(cfg, ds, dev, eager=False)
    secs_prog = time.perf_counter() - t0
    peak_front = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    f_eager = programs_frontend(cfg, ds, dev, eager=True)
    secs_eager = time.perf_counter() - t0
    check(len(f_prog[1]) >= 1, "phase 13: no submap cut in 13a's frames")
    for t, ((w_p, tr_p), (w_e, tr_e)) in enumerate(zip(f_prog[0],
                                                       f_eager[0])):
        check(np.array_equal(w_p, w_e) and tr_p == tr_e,
              f"phase 13: frame {t}'s pose or tracking ({tr_p}) differs from "
              f"the eager run's ({tr_e})")
    for k in f_eager[2]:
        check(np.array_equal(np.asarray(f_prog[2][k]),
                             np.asarray(f_eager[2][k])),
              f"phase 13: the frontend's map {k} differs from the eager run's")
    fe = f_prog[3]
    names = {p.name for p in fe.programs.programs.values()}
    for want in ("initialize_map", "add_and_prune", "prune_gaussians"):
        check(want in names, f"phase 13: the frontend ran no {want} program "
              f"({sorted(names)})")
    print(f"[programs] {card}: the Frontend over {N_FRAMES_PROGRAMS} frames "
          f"with its steps captured equals the eager run bit for bit (every "
          f"pose, iteration count, loss and the final map): {secs_prog:.1f} "
          f"s captured (captures included), {secs_eager:.1f} s eager; "
          f"{len(fe.programs.programs)} programs "
          f"{sorted({p.name for p in fe.programs.programs.values()})}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    b_prog, be = programs_backend(cfg, f_prog[1], dev, eager=False)
    peak_back = torch.cuda.max_memory_allocated() - base
    b_eager, _ = programs_backend(cfg, f_eager[1], dev, eager=True)
    check(map_digest(b_prog) == map_digest(b_eager),
          f"phase 13: the backend's state differs from the eager run's "
          f"({map_digest(b_prog)} against {map_digest(b_eager)})")
    names = sorted({p.name for p in be.programs.programs.values()})
    for want in ("mapping_loop", "mapping_step", "ba_step",
                 "backend_tracking_step", "prune_gaussians"):
        check(want in names, f"phase 13: the backend ran no {want} program "
              f"({names})")
    print(f"[programs] {card}: the Backend over {len(f_prog[1])} merges, "
          f"their task queues, 2 mapping and 2 ba tasks with its steps "
          f"captured equals the eager run bit for bit (digest "
          f"{map_digest(b_prog)}); programs {names}; graph pools "
          f"{pool_bytes() / 2**20:.1f} MiB; peak device memory above the "
          f"start: frontend {peak_front / 2**20:.1f} MiB, backend "
          f"{peak_back / 2**20:.1f} MiB; captures "
          f"{json.dumps(dict(programs.CAPTURES))}")

    eval_rows = programs_eval(fe, ds, dev, card)
    programs_sharded(be, dev, card)

    # 13b: launches and idle share per step, on the captured programs
    from gaus_slam_tpu_torch.ops.graph_loop import LoopGraph
    from gaus_slam_tpu_torch.parallel import sharded_ba_step
    from gaus_slam_tpu_torch.render import bin_for_tracking, render_view
    from gaus_slam_tpu_torch.slam.densify import add_and_prune
    from gaus_slam_tpu_torch.slam.frontend import Frontend
    from gaus_slam_tpu_torch.slam.init_map import initialize_map
    from gaus_slam_tpu_torch.slam.steps import (ComposedW2C, mapping_loop,
                                                tracking_loop)
    from gaus_slam_tpu_torch.utils.eval import _eval_frame

    # a Frontend over frames 0-4 (no cut: its frames keep their images)
    fe = Frontend(cfg, queue.Queue(), device=dev)
    for t in range(5):
        color, depth, _, c2w = ds[t]
        fe.process_frame(t, np.asarray(color, np.float32) / np.float32(255),
                         np.asarray(depth), c2w)
    s = fe.sys
    frame = fe.local_frames[-1]
    gt = fe._tile_gt(frame)
    pose = frame.pose
    strides = fe._track_strides()
    cache = bin_for_tracking(fe.map, s.cam.replace_w2c(pose.w2c), s.opts,
                             coarse_strides=strides)
    tc = s.track_front._replace(converged_th=-1.0)
    sel = [fe.local_frames[i % len(fe.local_frames)] for i in range(
        fe.num_mapping_iters // fe.rebin_every)]

    def track(lag=None, owner=fe.programs):
        tracking_loop(cache, pose, gt, s.cam, s.opts, tc, s.lcfg,
                      compact_coarse=bool(strides), owner=owner, lag=lag)

    def fmap():
        mapping_loop(fe.map, [ComposedW2C(None, f.pose.quat, f.pose.trans)
                              for f in sel],
                     [fe._tile_gt(f) for f in sel], s.cam, s.opts, s.mcfg,
                     s.lcfg, rebin_every=fe.rebin_every,
                     coarse_stride=fe.coarse_map_stride, owner=fe.programs)

    def x4():
        with be.stream_context():
            be.task_queue.clear()
            be.task_queue.extend([("mapping", 0, True)] * be.MAP_BATCH)
            be.process()
        be.wait()

    def bmap():
        with be.stream_context():
            be.mapping(0)
        be.wait()

    def btrack():
        with be.stream_context():
            be.tracking(0)
        be.wait()

    def eval_frame():
        _eval_frame(fe.map, *ins, s.cam, s.opts, s.lcfg, owner=eval_owner)

    def keyframe():
        # render_view, then add_and_prune on its view, as _densify runs
        # them (the map grows in place; rows past capacity are dropped)
        view = render_view(fe.map, s.cam.replace_w2c(ins[0]), s.opts,
                           owner=fe.programs)
        fe.map = add_and_prune(fe.map, ins[0], ins[1], ins[2], view, s.cam,
                               s.opts, s.dcfg, s.lcfg, owner=fe.programs)

    def init():
        initialize_map(fe.map.capacity, ins[1], ins[2], ins[0], s.cam,
                       owner=init_owner)

    ba_devs = [torch.device(dev)] * BA_GROUP
    lm = be.local_maps[0]
    fids = [lm.saved_idxs[k % len(lm.saved_idxs)] for k in range(BA_GROUP)]
    ba_w2cs = torch.stack([lm.get_frame_w2c(f).detach() for f in fids])
    ba_gts = torch.stack([be._tile_gt(lm.frames[f]) for f in fids])

    def sharded():
        with be.stream_context():
            bs = be.sys
            be.map, _, _ = sharded_ba_step(
                ba_devs, be.map, ba_w2cs, ba_gts, bs.cam, bs.opts, bs.mcfg,
                bs.lcfg, owners=be.ba_owners(ba_devs))
        be.wait()

    eval_owner = programs.Owner("13b-eval")
    init_owner = programs.Owner("13b-init")
    ins = eval_inputs(frame, ds, dev)
    # the Frontend's tracking programs, the loop program and the lagged
    # graphs, captured before the rows below capture theirs
    track()
    track(lag=1)
    rows = {}
    for label, fn, per in (
            (f"tracking loop, {tc.num_iters} iterations", track,
             tc.num_iters),
            (f"frontend mapping, {fe.num_mapping_iters} iterations", fmap, 1),
            ("backend fused x4 mapping batch", x4, 1),
            ("backend mapping step", bmap, 1),
            ("backend tracking step", btrack, 1),
            (f"sharded BA step, {BA_GROUP} slots", sharded, 1),
            ("eval frame", eval_frame, 1),
            ("keyframe view + densify and prune", keyframe, 1),
            ("submap init (initialize_map)", init, 1)):
        fn()
        torch.cuda.synchronize()
        w = step_window(fn)
        rows[label] = w
        n = w["launches"]
        idle = ("not measured" if w["idle"] is None else f"{w['idle']:.3f}")
        print(f"[programs] {card}: {label}: graph launches {n['graphs']}, "
              f"kernels launched outside a graph {n['kernels']}, copies and "
              f"fills outside a graph {n['copies']}, kernels on "
              f"the card {n['device_kernels']}"
              + (f" ({(n['graphs'] + n['kernels']) / per:.2f} launches per "
                 f"iteration)" if per > 1 else "")
              + f"; wall {w['wall']:.3f} ms, device busy {w['busy']:.3f} ms, "
              f"idle share {idle}; host waits {w['wait_ms']:.3f} ms")
    # the loop program against the lagged per-iteration graphs, in turns:
    # device ms from CUDA events around a call (torch.profiler does not
    # trace every run of a WHILE body), host wall ms around a call and its
    # synchronize; each of the Frontend's owner, captured before the rows
    # above, and of an owner of its own, captured after them
    late = {k: programs.Owner(f"13b-{k}")
            for k in ("loop", "loop profiled", "lagged")}
    variants = {
        "loop program, captured before": track,
        "lagged graphs, captured before": lambda: track(lag=1),
        "loop program, captured after": lambda: track(owner=late["loop"]),
        "loop program, captured after, profiled once": lambda: track(
            owner=late["loop profiled"]),
        "lagged graphs, captured after": lambda: track(
            lag=1, owner=late["lagged"])}
    for fn in variants.values():
        fn()
    # under torch.profiler once, as the Frontend's loop program was in
    # its row
    step_window(variants["loop program, captured after, profiled once"])
    captures = sum(programs.CAPTURES.values())
    per = {k: [] for k in variants}
    # an event just before a loop program's launch: the device ms before
    # it (the arguments bound, the device waiting on the host) apart
    marks = []
    launch = LoopGraph.launch

    def marked(self):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        launch(self)

    LoopGraph.launch = marked
    try:
        for label in list(variants) + list(variants)[::-1]:
            for _ in range(3):
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                marks.clear()
                t0 = time.perf_counter()
                e0.record()
                variants[label]()
                e1.record()
                torch.cuda.synchronize()
                per[label].append((e0.elapsed_time(e1),
                                   1e3 * (time.perf_counter() - t0),
                                   e0.elapsed_time(marks[0]) if marks
                                   else None))
    finally:
        LoopGraph.launch = launch
    captures = sum(programs.CAPTURES.values()) - captures
    print(f"[programs] {card}: tracking loop, {tc.num_iters} iterations, "
          f"in turns (6 calls each; {captures} captures meanwhile): "
          + "; ".join(f"{k} device mean {np.mean([a for a, _, _ in v]):.3f} "
                      f"(min {np.min([a for a, _, _ in v]):.3f}, max "
                      f"{np.max([a for a, _, _ in v]):.3f}) ms, host wall "
                      f"{np.mean([b for _, b, _ in v]):.3f} ms"
                      + (f", before the launch "
                         f"{np.mean([c for *_, c in v]):.3f} ms"
                         if v[0][2] is not None else "")
                      for k, v in per.items()))
    check(captures == 0, f"phase 13: {captures} captures while the "
          f"tracking loops were timed")
    w = rows[f"tracking loop, {tc.num_iters} iterations"]
    n = w["launches"]
    check(n["graphs"] == 1 and n["kernels"] == 0 and w["wait_ms"] == 0
          and "cudaEventSynchronize" not in w["waits"],
          f"phase 13: the tracking loop issued {n['graphs']} graph launches "
          f"and {n['kernels']} kernels outside a graph, host waits "
          f"{w['wait_ms']} ms {w['waits']}")
    n = rows["backend fused x4 mapping batch"]["launches"]
    check(n["graphs"] >= 1 and n["graphs"] + n["kernels"] <= X4_LAUNCH_LIMIT,
          f"phase 13: the fused x4 batch issued {n['graphs']} graph launches "
          f"and {n['kernels']} kernels outside a graph (limit "
          f"{X4_LAUNCH_LIMIT})")
    n = rows[f"sharded BA step, {BA_GROUP} slots"]["launches"]
    check(1 <= n["graphs"] <= BA_GROUP + 1
          and n["kernels"] + n["copies"] <= SHARDED_OUTSIDE_LIMIT,
          f"phase 13: the sharded BA step issued {n['graphs']} graph "
          f"launches and {n['kernels'] + n['copies']} operations outside a "
          f"graph (limits {BA_GROUP + 1}, {SHARDED_OUTSIDE_LIMIT})")
    keyframe_split(cfg, dev, card)
    print(f"[programs] {card}: graph launches by program since the start "
          f"{json.dumps(dict(programs.GRAPH_LAUNCHES))}; captures "
          f"{json.dumps(dict(programs.CAPTURES))}; graph pools "
          f"{pool_bytes() / 2**20:.1f} MiB")
    return rows


# 13c: the counter loops that hold while_cond against while_cond_plain:
# (kmax of each level, stop), live false from the start where stop is 0
COUNTER_GRID = [((0,), 3), ((5,), 0), ((5,), 3), ((5,), 9), ((1,), 1),
                ((30,), 12), ((4, 10), 6), ((4, 10), 2), ((4, 10), 15),
                ((0, 0), 4), ((3, 3), 9)]
COUNTER_TIMED = (1000, 2000)   # iterations of the timed counter loops


def loop_cases(tc):
    """13c: tests/test_torch_while_loop.py's four schedules on the config's
    tracking config ``tc``: (TrackConfig, view and prediction on). The
    thresholds place the stop: any step under 1 cm converges at once
    (inside a coarse level of n - 1), 2 mm after a coarse level of 2 (the
    stop in the full-resolution level, with and without the view and the
    prediction)."""
    n, stride = tc.num_iters, tc.levels()[0][1]
    fine = tc._replace(coarse_levels=((2, stride),), converged_th=2e-3)
    return {"stop in coarse": (tc._replace(coarse_levels=((n - 1, stride),),
                                           converged_th=1e-2), False),
            "stop in fine": (fine, False),
            "no early exit": (tc._replace(converged_th=-1.0), False),
            "view and predict": (fine, True)}


def counter_loop(kmaxs, stop, early, own, dev, read=True):
    """programs.while_loop over a counter on the card: a level per kmax,
    the body one more and live while under ``stop``, the tail doubling
    the count. Returns (count, live, tail), read on the host (``read``)."""
    import torch

    from gaus_slam_tpu_torch.slam import programs

    def body(n, live, stop):
        n = n + 1
        return n, live & (n < stop)

    args = {"n": torch.zeros((), dtype=torch.int32, device=dev),
            "live": torch.full((), stop > 0, dtype=torch.bool, device=dev),
            "stop": torch.full((), stop, dtype=torch.int32, device=dev)}
    done, tail = programs.while_loop(
        own, "counter", body, [({}, k, early) for k in kmaxs], args,
        carry=("n", "live"), cond=lambda a: (a["n"], a["live"]),
        body_args=("n", "live", "stop"), tail=lambda n: {"twice": 2 * n},
        tail_args=("n",))
    if read:
        return int(done["n"]), bool(done["live"]), int(tail["twice"])


def phase_loop_program(cfg, ds, dev, card):
    """Phase 13c: the tracking loop as one loop program (WHILE nodes).
    Returns the kernels line's numbers of while_cond."""
    import torch

    from gaus_slam_tpu_torch.ops import _cuda
    from gaus_slam_tpu_torch.ops.graph_loop import (BODY_TYPES, node_types,
                                                    while_cond_plain)
    from gaus_slam_tpu_torch.render import bin_for_tracking
    from gaus_slam_tpu_torch.slam import programs
    from gaus_slam_tpu_torch.slam.frontend import Frontend
    from gaus_slam_tpu_torch.slam.steps import tracking_loop

    # what the loop program is built on, on this machine
    drv = subprocess.run(["nvidia-smi", "--query-gpu=driver_version",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    api = {k: hasattr(torch._C._CUDAGraph, k) for k in (
        "raw_cuda_graph", "instantiate", "begin_capture_to_if_node")}
    print(f"[loop] {card}: PyTorch {torch.__version__} (CUDA "
          f"{torch.version.cuda}), driver {drv}; torch._C._CUDAGraph "
          f"{api}; CUDAGraph(keep_graph=True) captures each level's "
          f"iteration and the tail, csrc/graph_loop.cu (nvcc's static "
          f"cudart, no -rdc: cudaGraphSetConditional links without it) "
          f"assembles them; graph pools {pool_bytes() / 2**20:.1f} MiB")
    # a Frontend's frame: the one program against the lagged loop and
    # eager(), its first call (the warm-up iteration, then the graph) and
    # its launch
    fe = Frontend(cfg, queue.Queue(), device=dev)
    for t in range(5):
        color, depth, _, c2w = ds[t]
        fe.process_frame(t, np.asarray(color, np.float32) / np.float32(255),
                         np.asarray(depth), c2w)
    s = fe.sys
    frame = fe.local_frames[-1]
    gt, pose = fe._tile_gt(frame), frame.pose
    strides = fe._track_strides()
    cache = bin_for_tracking(fe.map, s.cam.replace_w2c(pose.w2c), s.opts,
                             coarse_strides=strides)
    own = programs.Owner("13c")
    for case, (tc, view) in loop_cases(s.track_front).items():
        def run(lag=None, owner=None):
            p, aux = tracking_loop(cache, pose, gt, s.cam, s.opts, tc, s.lcfg,
                                   want_view=view,
                                   prev_pose=pose if view else None,
                                   predict=view, compact_coarse=bool(strides),
                                   lag=lag, owner=owner)
            waits = aux.pop("host_waits"), aux.pop("queued")
            return _leaves(programs._clone((p, aux))), waits
        first, w1 = run(owner=own)
        launched, w2 = run(owner=own)
        lagged, _ = run(lag=1, owner=programs.Owner("13c-lag"))
        with programs.eager():
            eager, _ = run()
        for label, ref in (("its first call (one eager iteration, then "
                            "the graph)", first),
                           ("the lagged loop", lagged), ("eager()", eager)):
            check([p for p, _ in ref] == [p for p, _ in launched]
                  and all(torch.equal(a, b) for (_, a), (_, b)
                          in zip(ref, launched)),
                  f"phase 13c: {case}: the loop program differs from "
                  f"{label}")
        check(w1 == w2 == (0, 0), f"phase 13c: {case}: host waits {w1} {w2}")
        aux = dict(launched)
        iters = int(aux[".1.iters"])
        coarse, n = tc.levels()[0][0], tc.num_iters
        ok = {"stop in coarse": iters < coarse,
              "no early exit": iters == n}.get(case, coarse < iters < n)
        print(f"[loop] {card}: {case} ({tc.levels()}, converged_th "
              f"{tc.converged_th}): {iters} iterations; the launched program "
              f"equals its first call, the lagged loop and eager() bit for "
              f"bit")
        check(ok, f"phase 13c: {case} stopped after {iters} iterations")
    loops = [p for p in own.programs.values() if p.name == "tracking_loop"]
    check(loops and all(p.loop is not None for p in loops),
          "phase 13c: no loop graph was assembled")
    for p in loops[:1] + [q for q in fe.programs.programs.values()
                          if q.name == "tracking_loop"][:1]:
        for i, g in enumerate(p.graphs):
            types = node_types(g.raw_cuda_graph())
            counts = {k: types.count(k) for k in sorted(set(types))}
            print(f"[loop] {card}: {p.key[0]} graph {i} "
                  f"({'level ' + str(i) if i < len(p.bodies) else 'tail'}): "
                  f"{len(types)} nodes {counts}")
            check(set(types) <= BODY_TYPES, f"phase 13c: a captured graph "
                  f"holds nodes a WHILE body refuses: {counts}")

    # while_cond against while_cond_plain: counter loops, each launch
    # against the host loop over while_cond_plain on the card (eager()) and
    # a python loop; a launch's while_cond launches: its levels' entries
    # and its iterations
    cases = 0
    for kmaxs, stop in COUNTER_GRID:
        for early in (True, False):
            n, live = 0, stop > 0
            for k in kmaxs:
                while n < k and (live or not early):
                    n += 1
                    live = live and n < stop
            want = (n, live, 2 * n)
            with programs.eager():
                plain = counter_loop(kmaxs, stop, early, None, dev)
            c_own = programs.Owner("13c-counter")
            first = counter_loop(kmaxs, stop, early, c_own, dev)
            _cuda.clear_launches()
            got = counter_loop(kmaxs, stop, early, c_own, dev)
            conds = _cuda.fold_launches().get("while_cond", 0)
            check(got == first == plain == want
                  and conds == len(kmaxs) + n,
                  f"phase 13c: the counter loop {kmaxs}, stop {stop}, early "
                  f"{early}: launched {got} (first call {first}), host loop "
                  f"over while_cond_plain {plain}, python {want}; "
                  f"while_cond launched {conds} times")
            cases += 1
    # its time: the slope of a counter loop's device ms over iterations
    # (while_cond with the WHILE node's relaunch of a 2-kernel body), and
    # the plain version's
    ms = {}
    for k in COUNTER_TIMED:
        t_own = programs.Owner("13c-timed")
        counter_loop((k,), k + 1, True, t_own, dev)
        ms[k] = time_ms(lambda: counter_loop((k,), k + 1, True, t_own, dev,
                                             read=False), 5)
    per_iter = (ms[COUNTER_TIMED[1]] - ms[COUNTER_TIMED[0]]) / (
        COUNTER_TIMED[1] - COUNTER_TIMED[0])
    it = torch.zeros((), dtype=torch.int32, device=dev)
    lv = torch.ones((), dtype=torch.bool, device=dev)
    plain_ms = time_ms(lambda: while_cond_plain(it, lv, 30, True), 100)
    bound = 5 / HBM_BYTES_PER_S * 1e3     # reads 4 + 1 bytes
    print(f"[loop] {card}: while_cond equals while_cond_plain in "
          f"{cases} counter loops (kmax 0, a stop before the entry, two "
          f"levels); a WHILE iteration of a counter {per_iter * 1e3:.3f} us "
          f"({COUNTER_TIMED} iterations: {ms[COUNTER_TIMED[0]]:.3f} / "
          f"{ms[COUNTER_TIMED[1]]:.3f} ms a launch), while_cond_plain "
          f"{plain_ms * 1e3:.3f} us, bound {bound * 1e6:.3f} ns (bytes)")
    return dict(max_abs_err=0.0, ms=per_iter, plain_ms=plain_ms,
                bound_ms=bound, bound_by="bytes", library_ms=None)


# ---------------------------------------------------------------------------
# phase 13d: the gradient reduction's lax.cond as an IF node


IF_NODES = 256   # 13d: IF nodes in the program that times if_cond


def cond_cases(fe, dev):
    """13d: the programs that reduce pair gradients, on ``fe``'s map and
    last frames: {name: run(owners, opts) -> the cloned results of two
    chained calls}; ``owners`` a list (the sharded step's shard owners
    and its map owner; one owner for the others, None under eager())."""
    import torch

    from gaus_slam_tpu_torch.models.frame import init_exposure, init_pose
    from gaus_slam_tpu_torch.parallel import sharded_ba_step
    from gaus_slam_tpu_torch.slam import programs
    from gaus_slam_tpu_torch.slam.steps import (ComposedW2C, ba_step,
                                                mapping_loop, mapping_step)

    s = fe.sys
    frames = [fe.local_frames[i % len(fe.local_frames)] for i in range(4)]
    gts = [fe._tile_gt(f) for f in frames]
    w2cs = [f.pose.w2c.detach().clone() for f in frames]
    gm0 = programs._clone(fe.map)
    devs = [torch.device(dev)] * BA_GROUP

    def one(owners):
        return None if owners is None else owners[0]

    def fmap(owners, opts):
        gm, exp, out = gm0, init_exposure(dev), []
        for k in range(2):
            f = frames[k]
            gm, exp, aux = mapping_step(
                gm, ComposedW2C(None, f.pose.quat, f.pose.trans), gts[k],
                exp, False, s.exp_sched_front, s.cam, opts, s.mcfg, s.lcfg,
                owner=one(owners))
            out.append(programs._clone((gm, exp, aux)))
        return out

    def x4(owners, opts):
        gm, out = gm0, []
        for _ in range(2):
            gm, aux = mapping_loop(gm, w2cs, gts, s.cam, opts, s.mcfg,
                                   s.lcfg, rebin_every=1, coarse_stride=1,
                                   owner=one(owners))
            out.append(programs._clone((gm, aux)))
        return out

    def ba(owners, opts):
        gm, pose, exp = gm0, init_pose(np.eye(4, dtype=np.float32),
                                       device=dev), init_exposure(dev)
        out = []
        for k in range(2):
            gm, pose, exp, aux = ba_step(
                gm, pose, w2cs[k], gts[k], exp, s.cam, opts, s.mcfg, s.lcfg,
                s.exp_sched_back, owner=one(owners))
            out.append(programs._clone((gm, pose, exp, aux)))
        return out

    def sharded(owners, opts):
        gm, out = gm0, []
        for _ in range(2):
            gm, loss, diag = sharded_ba_step(
                devs, gm, torch.stack(w2cs), torch.stack(gts), s.cam, opts,
                s.mcfg, s.lcfg, owners=owners)
            out.append(programs._clone((gm, loss, diag)))
        return out

    return {"frontend mapping_step": (fmap, 1),
            "backend fused x4 batch": (x4, 1),
            "ba_step": (ba, 1),
            f"sharded BA step, {BA_GROUP} slots": (sharded, BA_GROUP + 1)}


def cond_tallies(owners):
    """Every program of ``owners`` that holds IF nodes: [(program, its
    nodes' (then, else) counts now)]."""
    return [(p, [t.tolist() for t, _ in p.tally.parts])
            for own in owners for p in own.programs.values()
            if p.tally is not None]


def flag_program(own, flag, dev):
    """13d: a program whose one IF node writes 1.0 (the then branch) or
    2.0 (the else branch) into a [4] result; returns it, copied."""
    import torch

    from gaus_slam_tpu_torch.ops.graph_loop import cond
    from gaus_slam_tpu_torch.slam import programs

    def fn(flag, x):
        return cond(flag, lambda o: torch.add(x, 1.0, out=o),
                    lambda o: torch.add(x, 2.0, out=o), torch.empty_like(x))

    return programs.call(own, "if_cond", fn, dict(
        flag=flag, x=torch.zeros(4, device=dev)), {}, "y").clone()


def phase_cond_program(cfg, ds, dev, card):
    """Phase 13d: the gradient reduction's lax.cond as an IF node. Returns
    the kernels line's numbers of if_cond."""
    import torch

    from gaus_slam_tpu_torch.ops import _cuda
    from gaus_slam_tpu_torch.ops import binning as B
    from gaus_slam_tpu_torch.ops.graph_loop import cond, if_cond_plain
    from gaus_slam_tpu_torch.render import bin_full
    from gaus_slam_tpu_torch.slam import programs
    from gaus_slam_tpu_torch.slam.frontend import Frontend

    fe = Frontend(cfg, queue.Queue(), device=dev)
    for t in range(5):
        color, depth, _, c2w = ds[t]
        fe.process_frame(t, np.asarray(color, np.float32) / np.float32(255),
                         np.asarray(depth), c2w)
    s = fe.sys
    frame = fe.local_frames[-1]
    cam = s.cam.replace_w2c(frame.pose.w2c.detach())
    with torch.no_grad():
        bins = bin_full(fe.map.params, fe.map.active, cam, s.opts)
    demand = int(bins.demand)
    tight = s.opts._replace(pair_cap=max(128, demand // 2))
    budgets = {"the config's budget": s.opts,
               f"a budget of {tight.r_max(0)} pairs under demand {demand}":
               tight}
    print(f"[cond] {card}: an IF node with an else body (size 2) on the "
          f"overflow flag; map capacity {fe.map.capacity}, demand {demand}, "
          f"r_max {s.opts.r_max(fe.map.capacity)} (overflow "
          f"{bool(bins.overflow)}) and {tight.r_max(0)}")

    # every program bit-equal to eager(); its IF nodes, branches and K4
    for i, (name, (run, n_own)) in enumerate(cond_cases(fe, dev).items()):
        for (budget, opts), ovf in zip(budgets.items(), (False, True)):
            with programs.eager():
                want = run(None, opts)
            flags = [bool((t != 0).all()) if ovf else bool((t != 0).any())
                     for path, t in _leaves(want)
                     if path.endswith("overflow")]
            check(flags and all(f == ovf for f in flags),
                  f"phase 13d: {name} under {budget}: overflow flags "
                  f"{flags}, not all {ovf}")
            tag = f"13d-{i}-{int(ovf)}"
            owners = ([programs.Owner(f"{tag}-shard{k}", device=dev)
                       for k in range(n_own - 1)] if n_own > 1 else []) + [
                programs.Owner(tag)]
            first = run(owners, opts)
            a, b = ([t for _, t in _leaves(r)] for r in (first, want))
            check(len(a) == len(b) and all(torch.equal(x, y)
                                           for x, y in zip(a, b)),
                  f"phase 13d: {name} under {budget}: the captured calls "
                  f"differ from eager()")
            held = cond_tallies(owners)
            check(held, f"phase 13d: {name}: no program holds an IF node")
            for p, _ in held:
                n_if = p.types.count("conditional")
                check(n_if == len(p.tally.parts),
                      f"phase 13d: {name}: {p.name}'s graph holds {n_if} "
                      f"conditional nodes for {len(p.tally.parts)} "
                      f"reductions ({p.types.count('kernel')} kernels)")
            captures = sum(programs.CAPTURES.values())
            _cuda.clear_launches()
            again = run(owners, opts)
            counts = dict(_cuda.fold_launches())
            check(sum(programs.CAPTURES.values()) == captures,
                  f"phase 13d: {name}: the second calls captured")
            a = [t for _, t in _leaves(again)]
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  f"phase 13d: {name} under {budget}: the replays differ "
                  f"from eager()")
            then = other = 0
            for (p, before), (_, now) in zip(held, cond_tallies(owners)):
                for (t0, e0), (t1, e1) in zip(before, now):
                    then, other = then + t1 - t0, other + e1 - e0
            k4 = counts.get("monotone_row_gather", 0)
            ifs = counts.get("if_cond", 0)
            nodes = sum(p.types.count("conditional") for p, _ in held)
            print(f"[cond] {card}: {name} under {budget}: 2 captured calls "
                  f"equal eager() bit for bit; {len(held)} programs, "
                  f"{nodes} conditional nodes; replays: slab branch {then}, "
                  f"run branch {other}, if_cond {ifs}, K4 {k4}, K1 "
                  f"{counts.get('raster_forward_stash', 0)}, K2 "
                  f"{counts.get('raster_backward_stash', 0)}")
            check(then + other == ifs > 0 and (other == 0 if ovf else
                                               then == 0),
                  f"phase 13d: {name} under {budget}: the replays ran the "
                  f"slab branch {then} and the run branch {other} times "
                  f"for {ifs} IF nodes")
            check(k4 == other, f"phase 13d: {name} under {budget}: K4 "
                  f"launched {k4} times for {other} run branches")

    # if_cond against if_cond_plain: the branch each flag picks, in a
    # program of its own, and with the flag flipped between replays
    own = programs.Owner("13d-flag")
    vals = (True, False, True, False, False, True, True)
    taken = [0, 0]
    for i, val in enumerate(vals):
        flag = torch.tensor(val, device=dev)
        y = flag_program(own, flag, dev)
        branch = int(if_cond_plain(flag))
        check(torch.equal(y, torch.full_like(y, 1.0 + branch)),
              f"phase 13d: if_cond on {val} wrote {y.tolist()}, "
              f"if_cond_plain's branch writes {1.0 + branch}")
        if i:                      # the first call is the warm-up
            taken[branch] += 1
    cases = len(vals)
    [(p, (counts,))] = cond_tallies([own])
    check(counts == taken and p.types.count("conditional") == 1,
          f"phase 13d: the flag program's tally {counts} over replays "
          f"that took {taken}; types {p.types}")

    # the reductions' ms by CUDA events at the mapping step's shapes
    n, d_max = fe.map.capacity, s.opts.max_tiles_per_gaussian
    rng = np.random.default_rng(13)
    red = {}
    for (budget, opts), ovf in zip(budgets.items(), (False, True)):
        with torch.no_grad():
            bb = bin_full(fe.map.params, fe.map.active, cam, opts)
        r = bb.pair_gauss.shape[0]
        g = torch.as_tensor(rng.normal(size=(r, 24)).astype(np.float32),
                            device=dev)
        g0 = torch.where(bb.pair_ok[:, None], g, torch.zeros((), device=dev))
        r_own = programs.Owner(f"13d-reduce-{int(ovf)}")

        def node(bb=bb, g=g, r_own=r_own):
            return programs.call(r_own, "reduce", lambda bins, g: (
                bins.slab_scatter_grads(g, n, d_max, backend="pallas")),
                dict(bins=bb, g=g), {}, "grads")

        node()
        got = node().clone()
        check(torch.equal(got, bb.slab_scatter_grads(g, n, d_max, "pallas")),
              f"phase 13d: the reduction's IF node program under {budget} "
              f"differs from torch.where over both reductions")
        red[ovf] = {
            "slab": time_ms(lambda: bb._slab_reduce(g0, n, d_max), 10),
            "run": time_ms(lambda: bb._run_reduce(g0, n, d_max, "pallas"),
                           10),
            "where": time_ms(lambda: bb.slab_scatter_grads(g, n, d_max,
                                                           "pallas"), 10),
            "node": time_ms(node, 10)}
        print(f"[cond] {card}: the reduction under {budget} (R={r}, "
              f"N={n}, overflow {ovf}), ms by CUDA events: slab "
              f"{red[ovf]['slab']:.3f}, run {red[ovf]['run']:.3f}, "
              f"torch.where over both (eager) {red[ovf]['where']:.3f}, the "
              f"IF node program {red[ovf]['node']:.3f}")

    # the captured mapping step with the IF node and with the reduction
    # forced to torch.where over both (the parent's program), in turns
    fmap = cond_cases(fe, dev)["frontend mapping_step"][0]

    def where_cond(pred, then_fn, else_fn, out):
        return torch.where(pred, then_fn(torch.empty_like(out)),
                           else_fn(torch.empty_like(out)), out=out)

    steps = {}
    for (budget, opts), ovf in zip(budgets.items(), (False, True)):
        owners = {"IF node": [programs.Owner(f"13d-step-if-{int(ovf)}")],
                  "torch.where": [programs.Owner(f"13d-step-w-{int(ovf)}")]}
        real = B.cond
        B.cond = where_cond
        try:
            fmap(owners["torch.where"], opts)
        finally:
            B.cond = real
        fmap(owners["IF node"], opts)
        ms = {k: [] for k in owners}
        for k in list(owners) + list(owners)[::-1]:
            ms[k].append(time_ms(lambda: fmap(owners[k], opts), 5) / 2)
        steps[ovf] = {k: float(np.mean(v)) for k, v in ms.items()}
        print(f"[cond] {card}: the captured frontend mapping_step under "
              f"{budget} (overflow {ovf}), device ms a step by CUDA events "
              f"(two turns each, results cloned): IF node "
              f"{steps[ovf]['IF node']:.3f} ({ms['IF node']}), torch.where "
              f"over both {steps[ovf]['torch.where']:.3f} "
              f"({ms['torch.where']})")

    # if_cond's ms: a program of IF_NODES IF nodes, each branch one
    # 1-element add, less a program of the same adds launched plain
    def many(flag, x):
        ys = []
        for _ in range(IF_NODES):
            ys.append(cond(flag, lambda o: torch.add(x, 1.0, out=o),
                           lambda o: torch.add(x, 2.0, out=o),
                           torch.empty_like(x)))
        return torch.stack(ys)

    def plain(flag, x):
        return torch.stack([torch.add(x, 1.0) for _ in range(IF_NODES)])

    flag = torch.tensor(True, device=dev)
    x1 = torch.zeros(1, device=dev)
    own_if, own_plain = programs.Owner("13d-ifs"), programs.Owner(
        "13d-plain")
    run_if = lambda: programs.call(own_if, "ifs", many, dict(  # noqa: E731
        flag=flag, x=x1), {}, "y")
    run_plain = lambda: programs.call(own_plain, "plain", plain, dict(  # noqa: E731
        flag=flag, x=x1), {}, "y")
    run_if()
    run_plain()
    t_if = [time_ms(run_if, 20), time_ms(run_plain, 20)]
    t_if += [time_ms(run_plain, 20), time_ms(run_if, 20)]
    per_node = ((t_if[0] + t_if[3]) - (t_if[1] + t_if[2])) / 2 / IF_NODES
    plain_ms = time_ms(lambda: if_cond_plain(flag), 100)
    bound = 17 / HBM_BYTES_PER_S * 1e3   # the flag, a tally slot in and out
    print(f"[cond] {card}: if_cond equals if_cond_plain on {cases} calls "
          f"(both flags, flipped between replays); {IF_NODES} IF nodes "
          f"{(t_if[0] + t_if[3]) / 2:.3f} ms, the same adds plain "
          f"{(t_if[1] + t_if[2]) / 2:.3f} ms: {per_node * 1e3:.3f} us per "
          f"IF node; if_cond_plain {plain_ms * 1e3:.3f} us; bound "
          f"{bound * 1e6:.3f} ns (bytes)")
    return dict(max_abs_err=0.0, ms=per_node, plain_ms=plain_ms,
                bound_ms=bound, bound_by="bytes", library_ms=None,
                reduction_ms={str(k): v for k, v in red.items()},
                step_ms={str(k): v for k, v in steps.items()})


def keyframe_split(cfg, dev, card):
    """13b: the port's spans (utils/trace.py) over N_FRAMES_PROGRAMS frames
    at 340x600 (tools/frame_split.py's frontend run, under torch.profiler):
    median host ms and card ms of each span by kind of frame."""
    import copy

    from gaus_slam_tpu_torch.tools import frame_split as FS

    _, recs = FS.traced(FS.run_frontend, copy.deepcopy(cfg), H, W,
                        N_FRAMES_PROGRAMS, dev)
    kinds = FS.summarize(recs)["kinds"]
    check(kinds.get("keyframe", {}).get("n") and kinds.get("cut", {}).get("n"),
          f"phase 13: no keyframe or no cut among the traced frames "
          f"({kinds})")
    for kind, row in kinds.items():
        print(f"[programs] {card}: {kind} frames ({row['n']}), median host "
              f"/ card ms: " + ", ".join(
                  f"{k[k.index('.') + 1:]} {v:.0f} / "
                  f"{row['device_ms'][k]:.0f}"
                  for k, v in row["host_ms"].items()))


# phase 14: the tum cell's pair-cache rows (2 x its first capacity bucket)
TRACK_PRE_R = 1 << 20
# against the chain's cuBLAS product (its own sum order: xyz_cam an ulp or
# two apart): a0..a2, tw and K8's d_w2c within 1e-5 of their scale
TRACK_PRE_TOL = 1e-5


def track_pre_inputs(r, dev, seed=0):
    """A [13, r] pair cache in front of the camera (numpy draws), one row
    in eight behind it and one in sixteen a zero-opacity padding row, and
    a pose 20 deg and 10 cm from the identity."""
    import torch

    rng = np.random.default_rng(seed)
    raw = np.empty((13, r), np.float32)
    raw[0:2] = rng.uniform(-1.5, 1.5, (2, r))
    raw[2] = rng.uniform(0.5, 4.0, r)
    raw[2, ::8] = -rng.uniform(0.1, 1.0, raw[2, ::8].shape)
    raw[3:5] = np.exp(rng.uniform(np.log(1e-3), np.log(3e-2), (2, r)))
    q = rng.normal(size=(4, r))
    raw[5:9] = q / np.linalg.norm(q, axis=0)
    raw[9] = rng.uniform(0.0, 1.0, r)
    raw[9, ::16] = 0.0
    raw[10:13] = rng.uniform(0.0, 1.0, (3, r))
    quat = torch.tensor((0.97, 0.12, -0.17, 0.09), device=dev)
    trans = torch.tensor((0.06, -0.05, 0.08), device=dev)
    return torch.tensor(raw, device=dev), quat, trans


def phase_track_preprocess(dev, card):
    """14: K7 and K8 against the chain and timed, at R and R/2."""
    import torch

    from gaus_slam_tpu_torch.ops import _cuda
    from gaus_slam_tpu_torch.ops import track_preprocess as TP
    from gaus_slam_tpu_torch.ops.camera import (camera_from_intrinsics,
                                                world_to_pix3)
    from gaus_slam_tpu_torch.ops.se3 import pose_matrix, quat_normalize

    k = np.array([[517.3, 0.0, 318.6], [0.0, 516.5, 255.3], [0.0, 0.0, 1.0]])
    eye = camera_from_intrinsics(480, 640, k, np.eye(4), device=dev)
    M = world_to_pix3(eye)
    raw_full, quat0, trans0 = track_pre_inputs(TRACK_PRE_R, dev)
    numbers = {}
    _cuda.clear_launches()
    for r in (TRACK_PRE_R, TRACK_PRE_R // 2):
        raw = raw_full[:, :r]       # a head slice, as the coarse level's
        quat = quat0.clone().requires_grad_()
        trans = trans0.clone().requires_grad_()
        w2c, q = pose_matrix(quat, trans), quat_normalize(quat).detach()
        d = torch.randn((24, r), generator=torch.Generator().manual_seed(1)
                        ).to(dev)
        with torch.no_grad():
            got = TP.k7(raw, w2c, q, M)
            xyz_cam = torch.stack([w2c[i, 0] * raw[0] + w2c[i, 1] * raw[1]
                                   + w2c[i, 2] * raw[2] + w2c[i, 3]
                                   for i in range(3)])
            exact = TP.track_preprocess_plain(
                torch.cat([xyz_cam, raw[3:]]),
                torch.eye(4, device=dev), q, eye)
        check(torch.equal(got, exact),
              f"phase 14: K7 at R {r} differs from the chain with the means "
              f"moved in its order")
        plain = TP.track_preprocess_plain(raw, w2c, q, eye)
        err = 0.0
        for c in range(12):
            scale = float(plain[c].abs().max())
            err = max(err, float((got[c] - plain[c]).abs().max()) / scale)
        check(err <= TRACK_PRE_TOL and torch.equal(got[14:17], plain[14:17])
              and torch.equal(got[18:], plain[18:]),
              f"phase 14: K7 at R {r} against the chain: {err:.3g} of scale")
        (want,) = torch.autograd.grad(plain, (w2c,), d)
        g1, g2 = TP.k8(raw, q, M, d), TP.k8(raw, q, M, d)
        gerr = float(torch.linalg.norm((g1 - want).double())
                     / torch.linalg.norm(want.double()))
        check(torch.equal(g1, g2), f"phase 14: K8 at R {r} twice differs")
        check(gerr <= TRACK_PRE_TOL,
              f"phase 14: K8 at R {r} against autograd: {gerr:.3g}")
        t7 = time_graph_ms(lambda: TP.k7(raw, w2c, q, M), 50)
        t8 = time_graph_ms(lambda: TP.k8(raw, q, M, d), 50)

        def chain(fn, pose_leaves, grad=True):
            """``fn``'s pair attributes at the pose, and with ``grad`` their
            backward: to w2c, or with ``pose_leaves`` through pose_matrix
            to the quaternion and translation."""
            def run():
                qq = quat0.detach().requires_grad_(pose_leaves)
                tt = trans0.detach().requires_grad_(pose_leaves)
                w = pose_matrix(qq, tt)
                if not pose_leaves:
                    w = w.detach().requires_grad_()
                attrs = fn(raw, w, quat_normalize(qq).detach(), eye)
                if grad:
                    torch.autograd.grad(
                        attrs, (qq, tt) if pose_leaves else (w,), d)
            return run
        # the plain counterparts: the chain's forward (K7's), its
        # backward from d_attrs to d_w2c (K8's: forward and backward less
        # the forward), each one captured graph of 5 calls
        plain = TP.track_preprocess_plain
        t_fwd = time_graph_ms(chain(plain, False, grad=False), 5)
        t_bwd = time_graph_ms(chain(plain, False), 5) - t_fwd
        # forward and backward to the pose, pose_matrix included: the
        # chain against the Function of K7 and K8
        t_chain = time_graph_ms(chain(plain, True), 5)
        t_fn = time_graph_ms(chain(TP.track_preprocess, True), 5)
        b7 = 37 * 4 * r / HBM_BYTES_PER_S * 1e3
        b8 = 16 * 4 * r / HBM_BYTES_PER_S * 1e3
        for name, t, b, e, tp in (
                ("track_preprocess", t7, b7, err, t_fwd),
                ("track_preprocess_backward", t8, b8, gerr, t_bwd)):
            numbers.setdefault(name, {})[f"r{r}"] = dict(
                max_rel_err=e, ms=t, bound_ms=b, bound_by="bytes",
                roofline=b / t, plain_ms=tp, chain_ms=t_chain,
                function_ms=t_fn)
        print(f"[track_pre] {card}: R {r}: K7 {t7:.4f} ms (bound "
              f"{b7:.4f}, {100 * b7 / t7:.1f}%; the chain's forward "
              f"{t_fwd:.4f}), K8 {t8:.4f} ms (bound {b8:.4f}, "
              f"{100 * b8 / t8:.1f}%; the chain's backward to w2c "
              f"{t_bwd:.4f}), K7 + K8 {t7 + t8:.4f} ms "
              f"({100 * (b7 + b8) / (t7 + t8):.1f}% of {b7 + b8:.4f}); "
              f"forward + backward to the pose: the Function {t_fn:.4f} ms, "
              f"the chain {t_chain:.4f} ms; K7 err {err:.3g} of "
              f"scale, K8 {gerr:.3g}")
    launches = dict(_cuda.fold_launches())
    print(f"[track_pre] launches {json.dumps({k: launches.get(k, 0) for k in TRACK_PATH})}")
    return numbers, launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import gaus_slam_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    try:
        phase_build()
        card = card_line()
        print(f"[device] {card}")
        cfg, ds, sys_cfg, capacity = make_setup(dev)
        numbers = phase_kernels(ds, sys_cfg, capacity, dev)
        launches, recs, state, lms = phase_frontend(cfg, ds, dev)
        ref_launches, ref_recs = phase_reference(ds, dev)
        frame_times("frontend", recs)
        frame_times("reference", ref_recs)
        phase_profile(state)
        del state
        phase_no_sync(dev, card)
        small_launches = phase_driver_small(dev)
        full_launches, probe = phase_driver_full(dev)
        k6_launches, numbers["bf16_probe"] = phase_bf16_probe(dev)
        disk_launches = phase_disk(dev, card)
        numbers_3dgs = phase_3dgs_kernels(ds, sys_cfg, capacity, dev, card,
                                          numbers)
        small_3dgs, full_3dgs, _ = phase_3dgs_driver(dev)
        splatam_launches = phase_splatam(dev, card)
        densify_launches = phase_gs_densify(dev, card)
        stream_launches = phase_streams(cfg, ds, lms, dev, card)
        ba_launches = phase_sharded_ba(cfg, ds, lms, capacity, dev, card)
        mp_launches = phase_pipelined(dev, card, probe.fps)
        numbers_bf16, numbers_bf16_3dgs = phase_bf16_kernels(
            ds, sys_cfg, capacity, dev, card)
        numbers.update(numbers_bf16)
        numbers_3dgs.update(numbers_bf16_3dgs)
        bf16_small, bf16_full = phase_bf16_driver(dev, probe.fps)
        phase_scripts(dev)
        phase_microbench(dev)
        probe_launches = phase_backend_probe(card)
        ab_launches = phase_quality_ab(card)
        spread_launches = phase_test_spread(dev, card)
        phase_programs(cfg, ds, dev, card)
        numbers["while_cond"] = phase_loop_program(cfg, ds, dev, card)
        numbers["if_cond"] = phase_cond_program(cfg, ds, dev, card)
        track_numbers, track_launches = phase_track_preprocess(dev, card)
        numbers.update(track_numbers)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    phases = {"3": launches, "3b": ref_launches, "5": small_launches,
              "6": full_launches, "6 backend": dict(probe.inside["backend"]),
              "6 eval_final": dict(probe.inside["eval"]), "7": k6_launches,
              "8": disk_launches, "9b 48x64": small_3dgs,
              "9b 340x600": full_3dgs, "9c": splatam_launches,
              "9d": densify_launches, "10a": stream_launches,
              "10b": ba_launches, **mp_launches, "11b 48x64": bf16_small,
              "11b 340x600": bf16_full, "12a": probe_launches,
              "12b": ab_launches, "12c": spread_launches,
              "14": track_launches}
    kernels = []
    for name, (kid, src, replaces) in KERNELS.items():
        # launches on this slice's path: the driver at full width (phase
        # 6) for K1-K4, K7, K8, while_cond and if_cond, the reference
        # backend (3b)
        # for K5,
        # K6's entry (7)
        # the bf16 instantiations: the driver with the bf16 compute dtype
        # at full width (11b)
        main_path = ("6" if name in STASH_PATH + TRACK_PATH
                     + ("while_cond", "if_cond") else
                     "11b 340x600" if name in BF16_PATH else
                     "3b" if name == "raster_backward" else "7")
        kernels.append({"name": name, "id": kid, "route": "cuda",
                        "source": src, "replaces": replaces,
                        "launches": int(phases[main_path].get(name, 0)),
                        "launches_by_phase": {
                            p: int(c.get(name, 0)) for p, c in phases.items()},
                        **numbers[name],
                        # K1 / K2 / K3 without SA on 3DGS attributes (9a)
                        **({"no_sa_3dgs": numbers_3dgs[name]}
                           if name in numbers_3dgs else {})})
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--streams-of"] and len(sys.argv) == 3:
        sys.exit(streams_of(sys.argv[2]))
    sys.exit(main())
