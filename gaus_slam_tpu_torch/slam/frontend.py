"""Frontend: per-frame tracking + local mapping + submap management
(port of gaus_slam_tpu/slam/frontend.py; reference slam/Frontend.py).

  process_frame: velocity-model pose init -> tracking loop -> tracking-
  lost test (EMA of depth-L1) -> keyframe test via rendered alpha
  coverage -> densify + local mapping + prune -> submap cut on {lost, too
  many frames, map too big} and handoff to the backend queue.

The state machine, its knobs (``frontend`` / ``tpu.*``) and the order of
its draws from ``self.rng`` are the JAX package's, so the same config and
the same frames take the same decisions. Timing statistics keep the
reference's time.json contract (Frontend.py:285-308).
"""
from __future__ import annotations

import json
import os
import random
import time

import numpy as np
import torch

from ..models import gaussians as G
from ..models.frame import Frame, init_exposure
from ..models.submap import LocalMap
from ..ops.composite_ref import frame_to_tiles
from ..render import render_view
from ..utils import trace
from ..utils.config import SystemConfig
from ..utils.stage import DEPTH_U16_SCALE
from .densify import add_and_prune, prune_gaussians
from .init_map import initialize_map
from . import programs
from .steps import (ComposedW2C, DiagFold, bin_mapping, bin_tracking,
                    mapping_loop, mapping_step, tracking_loop)


def _dequant(x):
    """uint8 colour * f32(1/255), uint16 depth * f32(1/DEPTH_U16_SCALE) (a
    float32 tensor times a python scalar computes in float32): the JAX
    frontend's ``_dequant_u8`` / ``_dequant_u16``."""
    scale = 1 / 255 if x.dtype == torch.uint8 else 1 / DEPTH_U16_SCALE
    return x.to(torch.float32) * scale


def _to_device(x, device, owner=None) -> torch.Tensor:
    """A frame array (numpy or torch) on ``device``, dequantized as the
    JAX frontend does (``_dequant``); anything else as float32. A
    camera-dtype frame moves first and widens on the device, so the copy
    carries 1 or 2 bytes a value; the widen-and-multiply is a program of
    ``owner`` (slam/programs.py; the host-to-card copy stays outside it)
    whose result is the caller's own."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        if a.dtype not in (np.uint8, np.uint16):
            return torch.as_tensor(a, dtype=torch.float32, device=device)
        x = torch.from_numpy(a)
    x = x.detach().to(device)
    if x.dtype not in (torch.uint8, torch.uint16):
        return x.to(torch.float32)
    return programs.call(owner, "dequant", _dequant, dict(x=x), {},
                         outs="frame", copies=("frame",))


def _readback(fetch: dict) -> dict:
    """Host copies of the values the host needs after a loop: numpy for
    arrays, python scalars for 0-d tensors. Copies also on the CPU, where
    ``cpu()`` would share a program's buffer (slam/programs.py)."""
    def host(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            return x.numpy().copy() if x.dim() else x.item()
        return x

    with trace.span("frontend.wait"):
        return {k: host(v) for k, v in fetch.items()}


def _host_w2c(frame) -> np.ndarray:
    """Host mirror of a frame's current pose. Tracked frames carry
    ``_w2c_host`` from the tracking readback; anything else falls back to
    one device readback."""
    w = getattr(frame, "_w2c_host", None)
    if w is not None:
        return w
    with trace.span("frontend.wait"):
        return frame.get_w2c.detach().cpu().numpy()


def _w2c_arg(frame):
    """A frame's w2c for a captured step (Frame.get_w2c, made inside it
    when the frame has a live pose)."""
    if frame.pose is None:
        return frame.get_w2c
    return ComposedW2C(None, frame.pose.quat, frame.pose.trans)


def _host_inv_se3(m: np.ndarray) -> np.ndarray:
    inv = np.eye(4, dtype=np.float32)
    R, t = m[:3, :3], m[:3, 3]
    inv[:3, :3] = R.T
    inv[:3, 3] = -R.T @ t
    return inv


class Frontend:
    def __init__(self, config: dict, to_backend, wandb_run=None,
                 backend: str = "pallas", device="cuda"):
        self.config = config
        self.wandb_run = wandb_run
        self.device = torch.device(device)
        self.sys = SystemConfig.from_config(config, backend=backend,
                                            component="frontend",
                                            device=self.device)
        self.to_backend = to_backend
        self.rng = random.Random(config.get("seed", 0))

        fr = config["frontend"]
        tpu = config.get("tpu", {})
        self.num_mapping_iters = int(fr["num_mapping_iters"])
        self.tau_k = float(fr["tau_k"])
        self.tau_l = float(fr["tau_l"])
        self.max_frames = int(fr["max_frames"])
        self.vel_pose_init = bool(fr.get("vel_pose_init", True))
        self.enable_retracking = bool(fr.get("enable_retracking", False))
        # re-bin the tracking pair cache once mid-loop (after the coarse
        # phase) at the updated pose; off = one cache per frame
        self.tracking_refresh = bool(fr.get("tracking_refresh", False))
        self.additional_densify = bool(fr.get("additional_densify", False))
        self.densify_interval = int(config["densify"].get("densify_interval", 20))
        # consecutive mapping iterations sharing one binning (1 = re-bin
        # every iteration, exact reference parity)
        self.rebin_every = int(tpu.get("mapping_rebin_every", 1))
        # coarse mapping: each mapping iteration renders a rotating
        # checkerboard of 1/stride^2 of the image tiles; 1 = every tile
        self.coarse_map_stride = int(tpu.get("coarse_map_stride", 1))
        self.num_frame_saved = int(config["backend"]["num_frame_saved"])
        self.capacity_quantum = int(tpu.get("capacity_quantum", 1 << 16))
        self.capacity_margin = float(tpu.get("capacity_margin", 1.3))
        # floor capacity: pre-size the map arrays to the bucket of
        # tau_l * margin
        self.capacity_floor = int(tpu.get("frontend_capacity", 0))
        # keyframe-coverage view rendered from the tracking pair cache at
        # the final pose; off = a fresh full binning via render_view
        self.fused_kf_view = bool(tpu.get("fused_kf_view", True))
        # speculative next-frame binning at the constant-velocity pose
        # (the same value the host init computes), launched before this
        # frame's readback; dropped whenever the map or self.sys changes
        self.speculative_bin = bool(tpu.get("speculative_bin", True))
        self._spec = None
        self._spec_slot = 0
        # compact coarse tracking: a phase-major tracking cache whose head
        # block holds the coarse checkerboard's pairs
        self.compact_coarse_track = bool(tpu.get("compact_coarse_track", True))

        # the captured steps (tracking iterations, mapping) and the map's
        # buffers they step in place (slam/programs.py)
        self.programs = programs.Owner("frontend")
        self.map: G.GaussianMap | None = None
        self.local_frames: list[Frame] = []
        self.cur_lmid = 0
        self.vel = np.eye(4, dtype=np.float32)
        self.tracking_flag = True
        self.avg_depth_l1 = 0.05
        self.depth_l1_rec = []
        self.numpts_rec = []

        # timing (time.json contract)
        self.t_track_iter = [0.0, 0]
        self.t_track_frame = [0.0, 0]
        # host mirror of map.n_active, refreshed at every densify / prune /
        # create, so the per-frame path tests map size without a sync
        self.n_active_host = 0
        self.t_map_iter = [0.0, 0]
        self.t_map_frame = [0.0, 0]
        self.total_time = 0.0
        # iterations and final loss of the last tracked frame (reports)
        self.last_track = None

    # ------------------------------------------------------------------
    def _track_strides(self) -> tuple:
        """Phase-major strides for the tracking pair cache (coarse ->
        fine; () = plain tile-major): non-empty only when the tracking
        loop runs coarse levels (never under the reference backend) and
        the compact slice is on."""
        if (not self.compact_coarse_track
                or self.sys.opts.backend == "reference"):
            return ()
        return tuple(s for _, s in self.sys.track_front.levels() if s > 1)

    def _capacity_for(self, n: int) -> int:
        return G.bucket_capacity(n, self.capacity_quantum,
                                 self.capacity_margin, self.capacity_floor)

    def _fit_capacity(self):
        """Grow (or shrink with hysteresis) the map arrays to a small set
        of capacity buckets."""
        gm = self.map
        with trace.span("frontend.wait"):
            n = int(gm.n_active)
        self.n_active_host = n
        cap = self._capacity_for(n)
        if cap < gm.capacity and n > 0.35 * gm.capacity:
            return
        self.map = G.resize_map(gm, cap)

    def _tile_gt(self, frame: Frame):
        if getattr(frame, "gt_tiled", None) is None:
            frame.gt_tiled = frame_to_tiles(
                frame.gt_color, frame.gt_depth, self.sys.opts.grid)
        return frame.gt_tiled

    # ------------------------------------------------------------------
    @trace.spanned("frontend.create_map")
    def create_map(self):
        """Init the local map from the first frame's unprojection + local
        mapping (Frontend.create_map, :63-73)."""
        frame = self.local_frames[0]
        cap = self._capacity_for(frame.gt_color.shape[0]
                                 * frame.gt_color.shape[1])
        self.map = initialize_map(cap, frame.gt_color, frame.gt_depth,
                                  frame.get_w2c, self.sys.cam,
                                  owner=self.programs)
        with trace.span("frontend.wait"):
            self.n_active_host = int(self.map.n_active)
        self.mapping()

    def _check_escalation(self, diag: dict):
        """Bump pair budgets when the binning diagnostics say the static
        capacities clipped (see SystemConfig.maybe_escalate)."""
        new = self.sys.maybe_escalate(
            overflow=bool(diag.get("overflow", False)),
            n_shrunk=int(diag.get("n_shrunk", 0)),
            n_active=self.map.capacity if self.map is not None else 0,
            demand=int(diag.get("demand", 0)),
        )
        if new is not None:
            print(f"[gaus] pair budget escalation: "
                  f"factor {self.sys.opts.pair_budget_factor}->"
                  f"{new.opts.pair_budget_factor}, pair_cap "
                  f"{self.sys.opts.pair_cap}->{new.opts.pair_cap}, d_max "
                  f"{self.sys.opts.max_tiles_per_gaussian}->"
                  f"{new.opts.max_tiles_per_gaussian}")
            self.sys = new

    @trace.spanned(trace.TRACKING)
    def tracking(self, frame: Frame, want_view: bool = False,
                 prev_pose=None, spec_cache=None):
        """Returns (depth_l1, view_render|None, n_low|None). With
        ``want_view`` the final-pose render and its low-alpha pixel count
        come from the tracking loop's own pair cache.

        ``spec_cache``: a PairCache binned during the PREVIOUS frame's
        tracking at this frame's (identical) init pose. ``prev_pose``
        enables the next frame's speculation (see tracking_loop)."""
        s = self.sys
        t0 = time.perf_counter()
        strides = self._track_strides()
        if spec_cache is not None:
            cache = spec_cache
        else:
            cache = bin_tracking(self.map, _w2c_arg(frame), s.cam, s.opts,
                                 coarse_strides=strides, owner=self.programs)
        tcfg = s.track_front
        iters_pre = 0
        diag_pre = None
        n_coarse = min(sum(i for i, _ in tcfg.levels()), tcfg.num_iters)
        if self.tracking_refresh and 0 < n_coarse < tcfg.num_iters:
            # phase 1 (coarse) on the init-pose cache, then re-bin at the
            # updated pose and run the full-res phase on a fresh cache
            pose, aux1 = tracking_loop(
                cache, frame.pose, self._tile_gt(frame), s.cam, s.opts,
                tcfg._replace(num_iters=n_coarse), s.lcfg,
                compact_coarse=bool(strides), owner=self.programs)
            # the init-pose cache's diagnostics reach the escalation too
            # (copied: the next binning rewrites the cache's buffers)
            diag_pre = (cache.overflow.clone(), cache.n_shrunk.clone())
            cache = bin_tracking(
                self.map, ComposedW2C(None, pose.quat, pose.trans), s.cam,
                s.opts, owner=self.programs)
            frame.pose = pose
            iters_pre = aux1["iters"]
            tcfg = tcfg._replace(num_iters=tcfg.num_iters - n_coarse,
                                 coarse_iters=0, coarse_levels=())
            strides = ()  # fresh cache is tile-major; no coarse left
        predict = self.speculative_bin and prev_pose is not None
        pose, aux = tracking_loop(
            cache, frame.pose, self._tile_gt(frame), s.cam, s.opts,
            tcfg, s.lcfg, want_view=want_view,
            prev_pose=prev_pose if predict else None,
            predict=predict, use_vel=self.vel_pose_init,
            compact_coarse=bool(strides), owner=self.programs)
        frame.pose = pose
        # the iteration count is a device scalar (as in JAX): it rides the
        # one readback below
        fetch = {"overflow": cache.overflow, "n_shrunk": cache.n_shrunk,
                 "demand": cache.demand, "depth_l1": aux["depth_l1"],
                 "loss": aux["loss"], "w2c": aux["w2c"],
                 "iters": aux["iters"] + iters_pre}
        if diag_pre is not None:
            fetch["overflow"] = torch.logical_or(fetch["overflow"], diag_pre[0])
            fetch["n_shrunk"] = torch.maximum(fetch["n_shrunk"], diag_pre[1])
        if want_view:
            fetch["n_low"] = aux["n_low"]
        if predict:
            # launch the NEXT frame's binning at the predicted pose before
            # the readback below; dropped (by map identity) if anything
            # changes the map first
            fetch["pred_w2c"] = aux["pred_w2c"]
            # into one of two slots: this frame's cache may be the other
            self._spec_slot ^= 1
            spec_next = bin_tracking(
                self.map, aux["pred_w2c"], s.cam, s.opts,
                coarse_strides=self._track_strides(), owner=self.programs,
                into=f"spec_cache{self._spec_slot}")
        host = _readback(fetch)
        sys_before = self.sys
        self._check_escalation(host)
        frame._w2c_host = np.asarray(host["w2c"])
        # a cache binned with the budget before an escalation would
        # overflow again: drop it and re-bin next frame
        self._spec = ((self.map, spec_next, aux["pred_pose"],
                       np.asarray(host["pred_w2c"]))
                      if predict and self.sys is sys_before else None)
        iters = int(host["iters"])
        trace.annotate(iters=iters)
        dt = time.perf_counter() - t0
        self.t_track_iter[0] += dt
        self.t_track_iter[1] += max(iters, 1)
        self.last_track = {"iters": iters, "loss": host["loss"]}
        return (float(host["depth_l1"]), aux.get("view"), host.get("n_low"))

    @trace.spanned("frontend.mapping")
    def mapping(self, frames=None):
        s = self.sys
        frames = frames or self.local_frames
        # fused path: K rebin-groups x rebin_every Adam steps through
        # mapping_loop; the per-step path below covers exposure and
        # mid-loop densification
        fused_ok = (not s.lcfg.enable_exposure
                    and not self.additional_densify
                    and self.num_mapping_iters % self.rebin_every == 0)
        if fused_ok:
            t0 = time.perf_counter()
            k = self.num_mapping_iters // self.rebin_every
            sel = [self.rng.choice(frames) for _ in range(k)]
            # the program binds each frame's pose and tiles on their own,
            # and makes a tracked frame's w2c (Frame.get_w2c) itself
            w2cs = [_w2c_arg(f) for f in sel]
            gts = [self._tile_gt(f) for f in sel]
            gm, aux = mapping_loop(self.map, w2cs, gts, s.cam, s.opts,
                                   s.mcfg, s.lcfg,
                                   rebin_every=self.rebin_every,
                                   coarse_stride=self.coarse_map_stride,
                                   owner=self.programs)
            self.map = gm
            for f in sel:
                f.mapping_times += self.rebin_every
            self._check_escalation(_readback(
                {"overflow": aux["overflow"], "n_shrunk": aux["n_shrunk"],
                 "demand": aux["demand"]}))
            dt = time.perf_counter() - t0
            self.t_map_iter[0] += dt
            self.t_map_iter[1] += self.num_mapping_iters
            return

        exp_dummy = init_exposure(self.device)
        t0 = time.perf_counter()
        n_steps = 0
        diags = DiagFold()  # the steps' binning diagnostics, on the device
        it = 0
        while it < self.num_mapping_iters:
            frame: Frame = self.rng.choice(frames)
            # `rebin_every` consecutive iterations on this frame share one
            # binning (1 = re-bin inside every step like the reference)
            group = min(self.rebin_every, self.num_mapping_iters - it)
            f_w2c = frame.get_w2c
            bins = None
            if group > 1:
                bins = bin_mapping(self.map, f_w2c, s.cam, s.opts,
                                   owner=self.programs)
            for _ in range(group):
                exp = (frame.exposure if frame.exposure is not None
                       else exp_dummy)
                gm, exp, aux = mapping_step(
                    self.map, f_w2c, self._tile_gt(frame), exp,
                    s.lcfg.enable_exposure and frame.mapping_times > 10,
                    s.exp_sched_front, s.cam, s.opts, s.mcfg, s.lcfg,
                    bins=bins, owner=self.programs)
                self.map = gm
                diags.add(aux)
                if frame.exposure is not None:
                    frame.exposure = exp
                frame.mapping_times += 1
                n_steps += 1
                it += 1
                if (self.additional_densify
                        and (frame.mapping_times + 1)
                        % self.densify_interval == 0):
                    self._densify(frame)
                    break  # map rows changed: stale bins, resample
        # one readback for the whole loop; the fold keeps a transient
        # mid-loop overflow
        if diags.n:
            self._check_escalation(_readback(diags.folded()))
        dt = time.perf_counter() - t0
        self.t_map_iter[0] += dt
        self.t_map_iter[1] += n_steps

    @trace.spanned("frontend.densify")
    def _densify(self, frame: Frame, render_out=None):
        s = self.sys
        w2c = frame.get_w2c.detach()
        if render_out is None:
            render_out = render_view(self.map, s.cam.replace_w2c(w2c), s.opts,
                                     owner=self.programs)
        # the reference prunes inside add_new_gaussians too
        # (Densify.py:41), besides the post-mapping prune in process_frame:
        # one program for both
        self.map = add_and_prune(
            self.map, w2c, frame.gt_color, frame.gt_depth, render_out,
            s.cam, s.opts, s.dcfg, s.lcfg, owner=self.programs)
        self._fit_capacity()

    # ------------------------------------------------------------------
    @trace.spanned(trace.FRAME)
    def process_frame(self, time_idx, gt_color, gt_depth, gt_pose):
        """Main frontend pipeline (Frontend.process_frame, :142-222).

        gt_color: [H, W, 3] float 0..1 OR uint8 0..255; gt_depth: [H, W]
        float meters OR uint16 at stage.DEPTH_U16_SCALE counts/m (numpy or
        torch); gt_pose: c2w [4, 4]. Its span's ``kind`` is the frame's:
        "init" (the run's first frame), "tracked", "keyframe" or "cut".
        """
        trace.annotate(frame=time_idx, kind="tracked")
        with trace.span("frontend.h2d"):
            gt_color = _to_device(gt_color, self.device, self.programs)
            gt_depth = _to_device(gt_depth, self.device, self.programs)
            gt_w2c = np.linalg.inv(np.asarray(gt_pose))
            cur = Frame(time_idx=time_idx, gt_color=gt_color,
                        gt_depth=gt_depth, gt_w2c=gt_w2c, kfid=self.cur_lmid,
                        device=self.device)
        s = self.sys
        self.local_frames.append(cur)

        if len(self.local_frames) == 1:
            trace.annotate(kind="init")
            cur.frame_type = 0  # RKF
            cur.start_optimizer(np.eye(4, dtype=np.float32),
                                s.lcfg.enable_exposure)
            self.create_map()
            return

        frame_t0 = time.perf_counter()
        last = self.local_frames[-2]
        with trace.span("frontend.pose_init"):
            if not self.vel_pose_init:
                self.vel = np.eye(4, dtype=np.float32)
            spec = self._spec
            self._spec = None
            spec_ok = spec is not None and spec[0] is self.map
            if spec_ok:
                # the previous frame's tracking already produced this
                # frame's pose init and its binning
                cur.pose = spec[2]
                cur._w2c_host = spec[3]
                if s.lcfg.enable_exposure:
                    cur.exposure = init_exposure(self.device)
            else:
                initial_w2c = self.vel @ _host_w2c(last)
                cur.start_optimizer(initial_w2c, s.lcfg.enable_exposure)
        # the keyframe-coverage view rides along with tracking unless the
        # submap will be cut anyway (the map-size / max-frames cuts are
        # known now, which covers all cuts when retracking is off)
        may_need_view = not (
            len(self.local_frames) > self.max_frames
            or self.n_active_host > self.tau_l
        )
        depth_l1, view_out, n_low = self.tracking(
            cur, want_view=may_need_view and self.fused_kf_view,
            prev_pose=last.pose,
            spec_cache=spec[1] if spec_ok else None)
        self.depth_l1_rec.append(depth_l1)

        tracking_flag = (depth_l1 < self.avg_depth_l1 * 5
                         if self.enable_retracking else True)
        if tracking_flag:
            self.avg_depth_l1 = 0.9 * self.avg_depth_l1 + 0.1 * depth_l1
        self.t_track_frame[0] += time.perf_counter() - frame_t0
        self.t_track_frame[1] += 1

        is_refkf = (
            (not tracking_flag)
            or len(self.local_frames) > self.max_frames
            or self.n_active_host > self.tau_l
        )

        if not tracking_flag:
            cur.start_optimizer(_host_w2c(last), s.lcfg.enable_exposure)
            cur._w2c_host = _host_w2c(last)
            self.vel = np.eye(4, dtype=np.float32)
            self._spec = None  # speculated from the now-discarded pose
            print("Tracking failed, reset localmap!!!")
        else:
            # velocity update on the host from the two host pose mirrors
            self.vel = cur._w2c_host @ _host_inv_se3(_host_w2c(last))

        if not is_refkf:
            hw = s.cam.height * s.cam.width
            with trace.span("frontend.kf_test"):
                if n_low is not None:
                    out = view_out
                    pad = (s.opts.grid.num_tiles * s.opts.grid.pixels_per_tile
                           - hw)
                    n_low_val = float(n_low) - pad
                else:
                    w2c = cur.get_w2c.detach()
                    out = render_view(self.map, s.cam.replace_w2c(w2c),
                                      s.opts, owner=self.programs)
                    alpha = out[:, 4]
                    # padded pixels never accumulate alpha; subtract them
                    with trace.span("frontend.wait"):
                        n_low_val = (float(torch.sum(alpha < 0.5))
                                     - (alpha.numel() - hw))
            if n_low_val > hw * self.tau_k:
                trace.annotate(kind="keyframe")
                map_t0 = time.perf_counter()
                cur.frame_type = 1  # KF
                self._densify(cur, render_out=out)
                self.mapping()
                with trace.span("frontend.prune"):
                    self.map = prune_gaussians(self.map, s.dcfg,
                                               owner=self.programs)
                    self._fit_capacity()
                self.t_map_frame[0] += time.perf_counter() - map_t0
                self.t_map_frame[1] += 1

        if is_refkf:
            trace.annotate(kind="cut")
            self._cut_submap(time_idx, gt_color, gt_depth, gt_w2c,
                             tracking_flag)

        self.numpts_rec.append(self.n_active_host)

    @trace.spanned("frontend.cut")
    def _cut_submap(self, time_idx, gt_color, gt_depth, gt_w2c,
                    tracking_flag):
        s = self.sys
        lm = LocalMap.cut(
            self.cur_lmid, self.local_frames, G.extract_params(self.map),
            self.num_frame_saved, tracking_ok=self.tracking_flag,
            rng=self.rng, n_active_host=self.n_active_host,
        )
        self.to_backend.put(lm)
        self.cur_lmid += 1
        cur = Frame(time_idx=time_idx, gt_color=gt_color, gt_depth=gt_depth,
                    gt_w2c=gt_w2c, kfid=self.cur_lmid, frame_type=0,
                    device=self.device)
        cur.start_optimizer(np.eye(4, dtype=np.float32),
                            s.lcfg.enable_exposure)
        self.local_frames = [cur]
        self.create_map()
        self.tracking_flag = tracking_flag
        while hasattr(self.to_backend, "qsize") and self.to_backend.qsize() > 1:
            print("backend too busy !!!")
            time.sleep(1)

    def process_final(self):
        if len(self.local_frames) > 1:
            lm = LocalMap.cut(
                self.cur_lmid, self.local_frames,
                G.extract_params(self.map), self.num_frame_saved,
                rng=self.rng, n_active_host=self.n_active_host,
            )
            self.cur_lmid += 1
            self.to_backend.put(lm)

    # ------------------------------------------------------------------
    def update_common_visualization(self):
        """Frontend dashboards (Frontend.py:231-242): local map point
        count and per-frame depth-L1, plus wandb series when enabled."""
        from ..utils import viz

        out_dir = self.config.get("vis_base_dir", "output")
        os.makedirs(out_dir, exist_ok=True)
        viz.save_series(self.numpts_rec,
                        os.path.join(out_dir, "frontend_numpts.png"))
        viz.save_series(self.depth_l1_rec,
                        os.path.join(out_dir, "depth_l1.png"))
        if self.wandb_run is not None:
            self.wandb_run.log({
                "frontend_numpts": self.numpts_rec[-1] if self.numpts_rec
                else 0,
                "depth_l1": self.depth_l1_rec[-1] if self.depth_l1_rec
                else 0.0,
            })

    # ------------------------------------------------------------------
    def time_stats(self) -> dict:
        def rate(acc):
            return acc[0] / max(acc[1], 1)

        return {
            "tracking_iter_time(ms)": rate(self.t_track_iter) * 1000,
            "tracking_frame_time(s)": rate(self.t_track_frame),
            "mapping_iter_time(ms)": rate(self.t_map_iter) * 1000,
            "mapping_frame_time(s)": rate(self.t_map_frame),
            "frame_time": (self.total_time
                           / max(self.t_track_frame[1], 1)),
        }

    def write_time_json(self):
        out_dir = self.config.get("vis_base_dir", "output")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "time.json"), "w") as f:
            json.dump(self.time_stats(), f)
