"""Backend: submap merging, global-map refinement and the submap pose
graph (port of gaus_slam_tpu/slam/backend.py; reference slam/Backend.py).

  process_localmap: rigid-transfer a submap's gaussians into the global
  frame (new gaussians start almost transparent, the opacity cap),
  retrieve covisible submaps by descriptor, and schedule a queue of
  mapping / prune / tracking tasks over them. A lost submap is first
  re-tracked against the global map.

  process(): drains one task; consecutive mapping tasks of one class run
  as one fused 4-task mapping_loop; when idle, a random submap gets a
  refinement task.

  gs_densify (``backend.gs_densify``): every mapping step accumulates
  the per-gaussian view-space gradient statistic, and every
  ``densify.densify_interval`` mapping steps the global map is cloned,
  split and pruned (3DGS style, Backend.py:117-128). Mapping then runs
  step by step: the fused batches emit no per-step statistics.

Placement (``tpu.*``, resolved as in the JAX package by
``resolve_placement``): with ``devices``, a BA group of more than one
device, consecutive mapping tasks of either coarse class run as one
keyframe-parallel step (parallel.sharded_ba_step), one keyframe per
device. ``tpu.backend_device`` puts the map on a card of its own, or on
the frontend's card behind a CUDA stream of the backend's own. Then
every public entry (process_localmap, process, final_refine,
re_tracking) runs on that stream after the caller's pending work, the
tensors the frontend hands over are kept from the caching allocator
until the backend's stream is done with them, and a reader of backend
state outside the backend calls ``wait()`` first.

The schedule, its knobs and the order of the draws from ``self.rng`` are
the JAX package's, so the same submaps give the same task queue.
``backend.save_ckpt`` is the driver's (utils/checkpoint.py at every
submap boundary).
"""
from __future__ import annotations

import collections
import contextlib
import functools
import os
import random

import numpy as np
import torch

from ..models import gaussians as G
from ..models.frame import init_exposure
from ..models.submap import LocalMap, Localmaps
from ..ops.composite_ref import frame_to_tiles
from ..ops.consts import host_to_device
from ..ops.se3 import invert_se3, quat_multiply, rotmat_to_quat
from ..utils.config import SystemConfig
from .densify import prune_gaussians
from . import programs
from .steps import (ComposedW2C, DiagFold, ba_step, backend_tracking_step,
                    mapping_loop, mapping_step)


def transform_params(params: G.Params, transfer: torch.Tensor) -> G.Params:
    """Rigid transform of a raw param snapshot
    (Backend.transfer_map_params, Backend.py:157-161)."""
    R, t = transfer[:3, :3], transfer[:3, 3]
    return params._replace(
        xyz=params.xyz @ R.T + t,
        quats=quat_multiply(rotmat_to_quat(R)[None, :], params.quats))


def resolve_placement(backend_device, ba_group: int, device: torch.device,
                      n_avail: int):
    """Where the backend's map lives, as the JAX Backend resolves
    ``tpu.backend_device`` (backend.py:56-88), with the knob's GPU
    meaning. Returns (device, own_stream, note): ``own_stream`` asks for
    a CUDA stream of the backend's own on that device, ``note`` is a line
    to print or None.

      "off" / "": the frontend's device and stream.
      a BA group of more than one device: ignored, the group owns
        placement.
      "auto": cuda:1 when two or more cards are attached; on one card the
        frontend's card, on a stream of the backend's own.
      an index: that card (on a stream of its own); at or past the count,
        ignored.
    On the CPU every value stays on the frontend's device and stream.
    """
    bd = str(backend_device)
    if bd in ("off", ""):
        return device, False, None
    if ba_group > 1:
        return device, False, ("[gaus] tpu.backend_device ignored: the "
                               "multi-device BA group owns device placement")
    if bd == "auto" and n_avail < 2:
        return device, device.type == "cuda", None
    idx = 1 if bd == "auto" else int(bd)
    if idx >= n_avail:
        return device, False, (f"[gaus] tpu.backend_device={bd} ignored: "
                               f"only {n_avail} device(s) attached")
    if device.type != "cuda":
        return device, False, None
    return (torch.device("cuda", idx), True,
            f"[gaus] backend map placed on cuda:{idx} (frontend stays on "
            f"{device})")


def _on_own_stream(fn):
    """Runs a public Backend entry inside ``Backend.stream_context``."""
    @functools.wraps(fn)
    def entry(self, *a, **kw):
        with self.stream_context():
            return fn(self, *a, **kw)
    return entry


class Backend:
    # consecutive mapping tasks fused into one mapping_loop call (only
    # full batches; partial ones fall back to per-step mapping)
    MAP_BATCH = 4

    def __init__(self, config: dict, wandb_run=None, backend: str = "pallas",
                 device="cuda", devices=None):
        """``device``: the frontend's device. ``devices``: the BA group
        (parallel.devices_from_config), the counterpart of the JAX
        Backend's ``mesh``."""
        self.config = config
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.devices = list(devices) if devices else None
        self.ba_group = len(self.devices) if self.devices else 1
        self.ba_group_calls = 0
        n_avail = torch.cuda.device_count() if device.type == "cuda" else 1
        self.device, own_stream, note = resolve_placement(
            config.get("tpu", {}).get("backend_device", "off"),
            self.ba_group, device, n_avail)
        if note:
            print(note)
        self.stream = (torch.cuda.Stream(device=self.device) if own_stream
                       else None)
        be = config["backend"]
        self.sys = SystemConfig.from_config(config, backend=backend,
                                            device=self.device)
        self.wandb_run = wandb_run
        self.rng = random.Random(config.get("seed", 0) + 1)
        # the reference's live Open3D viewers need a display; this build
        # writes per-submap dashboards instead
        for knob, sub in (("mesh_vis", "scripts/gen_video.py --mesh"),
                          ("render_vis", "scripts/gen_video.py")):
            if be.get(knob, False):
                print(f"[gaus] warning: backend.{knob} requires a display "
                      f"(Open3D live viewer); this headless build writes "
                      f"dashboards per submap instead — see {sub}")
        self.num_ba_iters = int(be["num_ba_iters"])
        self.num_covis = int(be["num_covis_submaps"])
        # 3DGS-style clone / split on the global map (Backend.py:117-128)
        self.gs_densify = bool(be.get("gs_densify", False))
        self.densify_interval = int(config["densify"].get("densify_interval",
                                                          20))
        self.mapping_iter = 0
        self.grad_accum = None  # [C] on the device, sized to the capacity
        self.grad_denom = None
        self.enable_random = bool(be.get("random_process", True))
        self.final_refinement = int(be.get("final_refinement", -1))
        tpu = config.get("tpu", {})
        self.capacity_quantum = int(tpu.get("capacity_quantum", 1 << 16))
        self.capacity_margin = float(tpu.get("capacity_margin", 1.3))
        # floor capacity: the global map is pre-sized so that merges do
        # not flip the capacity bucket every submap
        self.capacity_floor = int(tpu.get("backend_capacity", 0))
        # when a merge does need a bigger bucket, jump far enough ahead to
        # cover the next `capacity_horizon` merges' predicted peaks
        self.capacity_horizon = int(tpu.get("capacity_horizon", 4))
        self._peak_hist: list[int] = []  # merge-peak history
        self.bucket_flips = 0
        # coarse strides of the fused mapping batches: post-prune tasks
        # (and idle refinement) / pre-prune tasks; 1 = every tile
        self.coarse_map_stride = int(tpu.get("backend_coarse_map_stride", 1))
        self.coarse_pre_stride = int(tpu.get("backend_coarse_pre_stride", 1))
        # running phase offsets per class (a 4-task batch is shorter than
        # the stride^2 phase rotation)
        self._map_phase = 0
        self._map_phase_pre = 0

        self.map: G.GaussianMap | None = None
        # host mirror of map.n_active: merges add the donor count, prune's
        # _fit_capacity refreshes it, so a merge never syncs the device
        self.n_active_host = 0
        self.local_maps = Localmaps()
        self.cur_lmid = -1
        self.task_queue: collections.deque = collections.deque()
        self.covis_idxs: list[int] = []
        self.exposure = init_exposure(self.device)  # placeholder when off
        # per-submap exposure (Backend.py:106-124): stepped once a
        # submap's mapping_times exceeds exposure_start, composed with the
        # frame's frozen exposure
        self.enable_exposure = bool(config["render"].get("enable_exposure",
                                                         False))
        self.exposure_start = int(be.get("exposure_start", 120))
        self.ape_rec = []
        self.totalpts_rec = []
        # the steps' binning diagnostics, folded on the device into one
        # readback at an idle moment or at the end of a merge
        self._diag = DiagFold()
        # the captured steps and the map's buffers they step in place
        # (slam/programs.py), apart from the frontend's
        self.programs = programs.Owner("backend")

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def stream_context(self):
        """The enclosed work runs on the backend's own stream (when it has
        one), after everything the caller's stream has queued so far:
        the donor snapshot and the frontend's cached tiles are written
        there."""
        s = self.stream
        if s is None or torch.cuda.current_stream(s.device) == s:
            yield
            return
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            yield

    def wait(self):
        """Make the caller's current stream wait for the backend's queued
        work. Every reader of backend state outside the backend (the
        checkpoint, the dashboards, evaluation, the saved scene) calls it
        first."""
        if self.stream is None:
            return
        torch.cuda.current_stream().wait_stream(self.stream)
        if torch.cuda.current_device() != self.device.index:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)

    def _adopt(self, t):
        """A tensor the caller's stream made, for the backend's use: moved
        to the backend's card, or marked as in use on the backend's stream
        so that the caching allocator does not hand its memory to the
        caller's stream before the backend has read it."""
        if t is None or self.stream is None:
            return t
        if t.device != self.device:
            return t.to(self.device, non_blocking=True)
        t.record_stream(self.stream)
        return t

    def _note_diag(self, aux):
        if aux and "overflow" in aux:
            self._diag.add(aux)
            if self._diag.n >= 256:  # read back at least this often
                self._check_escalation()

    def _check_escalation(self):
        if not self._diag.n:
            return
        # one device-to-host copy for the three folded scalars
        diag = dict(zip(("overflow", "n_shrunk", "demand"),
                        self._diag.v.to(torch.int64).tolist()))
        self._diag = DiagFold()
        cap = self.map.capacity if self.map is not None else 0
        if os.environ.get("GAUS_DEMAND"):
            print(f"[prof] backend pair demand={int(diag['demand'])} "
                  f"r_max={self.sys.opts.r_max(cap)} cap={cap}", flush=True)
        new = self.sys.maybe_escalate(
            overflow=bool(diag["overflow"]), n_shrunk=int(diag["n_shrunk"]),
            n_active=cap, demand=int(diag["demand"]))
        if new is not None:
            print(f"[gaus] backend pair budget escalation: "
                  f"factor {self.sys.opts.pair_budget_factor}->"
                  f"{new.opts.pair_budget_factor}, pair_cap "
                  f"{self.sys.opts.pair_cap}->{new.opts.pair_cap}, d_max "
                  f"{self.sys.opts.max_tiles_per_gaussian}->"
                  f"{new.opts.max_tiles_per_gaussian}")
            self.sys = new

    # ------------------------------------------------------------------
    def _merge_horizon(self) -> int:
        """Predicted merge-peak growth over the next ``capacity_horizon``
        merges, from the measured peak history, capped at 75% of the
        current need (an overshoot would tax every per-pair op for the
        rest of the run)."""
        if len(self._peak_hist) < 2 or self.capacity_horizon <= 0:
            return 0
        # merge peaks only: the first entry is the first donor count
        real = self._peak_hist[1:]
        if len(real) >= 3:
            recent = real[-4:]
            deltas = sorted(max(b - a, 0) for a, b in zip(recent, recent[1:]))
            mid = len(deltas) // 2   # true median (even lengths average)
            g = (deltas[mid] if len(deltas) % 2
                 else (deltas[mid - 1] + deltas[mid]) // 2)
            return min(self.capacity_horizon * g, (3 * real[-1]) // 4)
        # first flip, no growth data yet: a quarter of the current need
        d = max(self._peak_hist[-1] - self._peak_hist[-2], 0)
        return min(d, self._peak_hist[-1] // 4)

    def _fit_capacity(self, needed: int | None = None, horizon: int = 0):
        gm = self.map
        if needed is None:
            # one device sync; it refreshes the host mirror too
            needed = int(gm.n_active)
            self.n_active_host = needed
        n = needed
        cap = G.bucket_capacity(n, self.capacity_quantum,
                                self.capacity_margin, self.capacity_floor)
        if cap < gm.capacity:
            if n > 0.35 * gm.capacity:
                return
            # never shrink below the last merge peak: the post-prune count
            # dips under it every cycle and would flip the bucket twice
            if self._peak_hist:
                floor = G.bucket_capacity(int(1.05 * self._peak_hist[-1]),
                                          self.capacity_quantum, 1.0,
                                          self.capacity_floor)
                cap = max(cap, floor)
                if cap >= gm.capacity:
                    return
        if cap > gm.capacity and horizon > 0:
            # this merge flips the bucket anyway: cover the horizon
            cap = G.bucket_capacity(n + horizon, self.capacity_quantum,
                                    self.capacity_margin, self.capacity_floor)
        if cap != gm.capacity:
            self.bucket_flips += 1
            print(f"[gaus] backend capacity bucket {gm.capacity} -> {cap} "
                  f"(needed {n}, horizon {horizon})", flush=True)
        self.map = G.resize_map(gm, cap)

    def _tile_gt(self, frame):
        if getattr(frame, "gt_tiled", None) is None:
            frame.gt_tiled = frame_to_tiles(frame.gt_color, frame.gt_depth,
                                            self.sys.opts.grid)
        return frame.gt_tiled

    def _tensor(self, a) -> torch.Tensor:
        """Host data of a task (a frame's pose, an exposure) on the
        backend's device, copied without a host wait."""
        return host_to_device(a, self.device)

    def _frame_w2c(self, lm: LocalMap, fid: int) -> ComposedW2C:
        """A kept frame's camera, lm.get_frame_w2c(fid), composed inside
        the step that uses it."""
        tf = lm.transform
        return ComposedW2C(self._tensor(lm.frames[fid].est_w2c), tf.quat,
                           tf.trans)

    # ------------------------------------------------------------------
    def mapping(self, lm_idx: int):
        s = self.sys
        lm: LocalMap = self.local_maps[lm_idx]
        if not lm.saved_idxs:  # e.g. a 1-frame submap retains nothing
            return {}
        fid = self.rng.choice(lm.saved_idxs)
        frame = lm.frames[fid]
        # the submap's exposure steps once mapping_times, counted after
        # this call, exceeds exposure_start (Backend.py:121-124)
        live_exp = self.enable_exposure and lm.exposure is not None
        gm, exp_out, aux = mapping_step(
            self.map, self._frame_w2c(lm, fid), self._tile_gt(frame),
            lm.exposure if live_exp else self.exposure,
            live_exp and lm.mapping_times + 1 > self.exposure_start,
            s.exp_sched_back, s.cam, s.opts, s.mcfg, s.lcfg,
            frame_exp=self._tensor(lm.frame_exp(fid)) if live_exp else None,
            owner=self.programs)
        self.map = gm
        if live_exp:
            lm.exposure = exp_out
        lm.mapping_times += 1
        self._note_diag(aux)
        if self.gs_densify:
            self._gs_densify_step(aux)
        return aux

    def _gs_densify_step(self, aux):
        """Accumulate the view-space gradient statistic; every
        densify_interval mapping steps run clone / split / prune, refit
        the capacity and reset the statistics (Backend.py:117-128)."""
        cap = self.map.capacity
        if self.grad_accum is None or self.grad_accum.shape[0] != cap:
            self.grad_accum = torch.zeros(cap, device=self.device)
            self.grad_denom = torch.zeros(cap, device=self.device)
        stat, vis = aux["densify_stat"], aux["visible"]
        self.grad_accum[:stat.shape[0]] += stat
        self.grad_denom[:vis.shape[0]] += vis.float()
        self.mapping_iter += 1
        if (self.mapping_iter + 1) % self.densify_interval == 0:
            dens = self.config["densify"]
            grads = self.grad_accum / torch.clamp(self.grad_denom, min=1.0)
            # the JAX package draws its PRNG key here, so the schedule's
            # later draws from self.rng stay the same
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.rng.getrandbits(31))
            self.map = G.densify_and_prune(
                self.map, grads, gen,
                grad_threshold=float(dens["densify_grad_threshold"]),
                percent_dense=float(dens["percent_dense"]),
                extent=float(dens.get("extent", 2.0)),
                min_opacity=float(dens.get("opacity_cuil", 0.05)),
                min_scale=float(dens.get("scale_cuil", 5e-4)),
            )
            self._fit_capacity()
            # the point set changed: the statistics restart
            self.grad_accum = None
            self.grad_denom = None

    def mapping_batch(self, lm_idxs: list[int], coarse: bool = False):
        """len(lm_idxs) mapping tasks as one mapping_loop call: each task
        re-bins against the current map, as the per-step path does.
        ``coarse``: the post-prune class (coarse_map_stride); pre-prune
        batches use coarse_pre_stride, each class with its own phase
        rotation."""
        stride = self.coarse_map_stride if coarse else self.coarse_pre_stride
        s = self.sys
        w2cs, gts, touched = [], [], []
        for i in lm_idxs:
            lm: LocalMap = self.local_maps[i]
            if not lm.saved_idxs:
                continue
            fid = self.rng.choice(lm.saved_idxs)
            w2cs.append(self._frame_w2c(lm, fid))
            gts.append(self._tile_gt(lm.frames[fid]))
            touched.append(lm)
        if not w2cs:
            return {}
        if len(w2cs) != len(lm_idxs):
            # a selected submap retained nothing: per-step mapping instead
            # of a partial batch, as the JAX package does
            for i in lm_idxs:
                self.mapping(i)
            return {}
        phase0 = self._map_phase if coarse else self._map_phase_pre
        gm, aux = mapping_loop(self.map, w2cs, gts, s.cam, s.opts, s.mcfg,
                               s.lcfg, rebin_every=1, coarse_stride=stride,
                               phase0=phase0, owner=self.programs)
        if stride > 1:
            nxt = (phase0 + len(w2cs)) % (stride * stride)
            if coarse:
                self._map_phase = nxt
            else:
                self._map_phase_pre = nxt
        self.map = gm
        for lm in touched:
            lm.mapping_times += 1
        self._note_diag(aux)
        return aux

    def mapping_group(self, lm_idxs: list[int]):
        """One sharded BA step over a group of keyframes, one per device
        of the group; a partial group is padded with zero weight."""
        from ..parallel import sharded_ba_step

        s = self.sys
        entries = []
        for i in lm_idxs:
            lm: LocalMap = self.local_maps[i]
            if not lm.saved_idxs:  # e.g. a 1-frame submap retains nothing
                continue
            entries.append((lm, self.rng.choice(lm.saved_idxs)))
        if not entries:
            return {}
        w2cs, gts, wts = [], [], []
        for k in range(self.ba_group):
            lm, fid = entries[k % len(entries)]
            w2cs.append(lm.get_frame_w2c(fid))
            gts.append(self._tile_gt(lm.frames[fid]))
            wts.append(1.0 if k < len(entries) else 0.0)
        gm, loss, diag = sharded_ba_step(
            self.devices, self.map, torch.stack(w2cs), torch.stack(gts),
            s.cam, s.opts, s.mcfg, s.lcfg, weights=wts)
        self.map = gm
        self.ba_group_calls += 1
        self._note_diag(diag)
        for lm, _ in entries:
            lm.mapping_times += 1
        return {"loss": loss, **diag}

    def tracking(self, lm_idx: int, tcfg=None):
        s = self.sys
        lm: LocalMap = self.local_maps[lm_idx]
        if not lm.saved_idxs:
            return {}
        fid = self.rng.choice(lm.saved_idxs)
        frame = lm.frames[fid]
        live_exp = self.enable_exposure and lm.exposure is not None
        pose, aux = backend_tracking_step(
            self.map, lm.transform, self._tensor(frame.est_w2c),
            self._tile_gt(frame), s.cam, s.opts, tcfg or s.track_back, s.lcfg,
            exposure=lm.exposure if live_exp else None,
            frame_exp=self._tensor(lm.frame_exp(fid)) if live_exp else None,
            owner=self.programs)
        lm.transform = pose
        self._note_diag(aux)
        return aux

    def ba(self, lm_idx: int):
        """Backend "ba" task (Backend.py:130-155): a mapping step at the
        composed frame pose plus a step advance of the submap transform
        (see steps.ba_step). The shipped schedule never enqueues it (as in
        the reference); process() reaches it."""
        s = self.sys
        lm: LocalMap = self.local_maps[lm_idx]
        if not lm.saved_idxs:
            return {}
        fid = self.rng.choice(lm.saved_idxs)
        frame = lm.frames[fid]
        live_exp = self.enable_exposure and lm.exposure is not None
        gm, pose, exp_out, aux = ba_step(
            self.map, lm.transform, self._tensor(frame.est_w2c),
            self._tile_gt(frame), lm.exposure if live_exp else self.exposure,
            s.cam, s.opts, s.mcfg, s.lcfg, s.exp_sched_back,
            frame_exp=self._tensor(lm.frame_exp(fid)) if live_exp else None,
            owner=self.programs)
        self.map = gm
        lm.transform = pose
        if live_exp:
            lm.exposure = exp_out
        self._note_diag(aux)
        return aux

    @_on_own_stream
    def re_tracking(self, lm_idx: int):
        """Recover a lost submap against the global map with doubled
        frontend-style tracking (Backend.re_tracking, :54-79)."""
        for _ in range(2 * self.sys.track_front.num_iters):
            self.tracking(lm_idx, tcfg=self.sys.track_front)

    def prune(self):
        self.map = prune_gaussians(self.map, self.sys.dcfg)
        self._fit_capacity()

    # ------------------------------------------------------------------
    @_on_own_stream
    def process(self):
        """Drain one task (Backend.process, :174-194)."""
        q = self.task_queue
        if q:
            cmd = q.popleft()
            if cmd[0] == "prune":
                self.prune()
            elif cmd[0] == "tracking":
                self.tracking(cmd[1])
            elif cmd[0] == "ba":
                self.ba(cmd[1])
            elif cmd[0] == "mapping":
                coarse = bool(cmd[2]) if len(cmd) > 2 else False
                if self.enable_exposure or self.gs_densify:
                    # the fused and sharded batches cannot step per-submap
                    # exposure, nor emit per-step densify statistics
                    self.mapping(cmd[1])
                    return
                idxs = [cmd[1]]
                if self.ba_group > 1:
                    # up to ba_group consecutive mapping tasks of either
                    # class as one sharded BA step
                    while (len(idxs) < self.ba_group and q
                           and q[0][0] == "mapping"):
                        idxs.append(q.popleft()[1])
                    self.mapping_group(idxs)
                    return
                # fuse up to MAP_BATCH consecutive mapping tasks of the
                # same class; only full batches run fused
                while (len(idxs) < self.MAP_BATCH and q and q[0][0] == "mapping"
                       and (bool(q[0][2]) if len(q[0]) > 2 else False) == coarse):
                    idxs.append(q.popleft()[1])
                if len(idxs) == self.MAP_BATCH:
                    self.mapping_batch(idxs, coarse=coarse)
                else:
                    for i in idxs:
                        self.mapping(i)
        elif self.enable_random and len(self.local_maps) > 0:
            self._check_escalation()  # idle: fold in the last diagnostics
            # idle refinement is post-prune steady state: coarse class
            q.append(("mapping", self.rng.choice(range(len(self.local_maps))),
                      True))

    @_on_own_stream
    def process_localmap(self, lm: LocalMap, multi_process: bool = False):
        """Merge one submap (Backend.process_localmap, :196-248)."""
        self.local_maps.add_localmap(lm)
        self.cur_lmid += 1
        params, active, n_active = lm.map_params
        lm.map_params = None
        # the handoff: the donor snapshot and the kept frames' images and
        # tiles come from the frontend's stream (or card)
        params = G.Params(*(self._adopt(p) for p in params))
        active, n_active = self._adopt(active), self._adopt(n_active)
        for f in lm.frames:
            for name in ("gt_color", "gt_depth", "gt_tiled"):
                if getattr(f, name, None) is not None:
                    setattr(f, name, self._adopt(getattr(f, name)))
        # the donor count from the cut's host mirror (reading the device
        # scalar would wait for the whole queue)
        n_donor = (lm.n_active_host if lm.n_active_host is not None
                   else int(n_active))

        if self.cur_lmid == 0:
            initial_w2kf = np.eye(4, dtype=np.float32)
        else:
            initial_w2kf = self.local_maps[self.cur_lmid - 1].get_frame_w2c(-1)

        if not lm.tracking_ok:
            print("backend global tracking for local tracking lost")
            lm.start_optimizer(initial_w2kf, self.enable_exposure, self.device)
            self.re_tracking(self.cur_lmid)
            initial_w2kf = lm.get_w2c.detach()
        lm.start_optimizer(initial_w2kf, self.enable_exposure, self.device)

        if self.cur_lmid == 0:
            self._peak_hist.append(n_donor)
            cap = G.bucket_capacity(n_donor, self.capacity_quantum,
                                    self.capacity_margin, self.capacity_floor)
            self.map = G.add_params(G.empty_map(cap, self.device), params,
                                    active)
            self.n_active_host = n_donor
            # the first donors enter at full opacity, no prune follows:
            # coarse mapping is safe here
            self.task_queue.extend([("mapping", 0, True)] * self.num_ba_iters)
        else:
            transfer = invert_se3(lm.get_w2c.detach()) @ self._tensor(lm.ref2f0)
            params = transform_params(params, transfer)
            # merged gaussians start almost transparent (Backend.py:226)
            cap_logit = float(np.log(0.01 / 0.99))
            params = params._replace(
                opacity_logit=torch.clamp(params.opacity_logit, max=cap_logit))
            peak = self.n_active_host + n_donor
            self._peak_hist.append(peak)
            self._fit_capacity(peak, horizon=self._merge_horizon())
            self.n_active_host += n_donor
            self.map = G.add_params(self.map, params, active)
            self.covis_idxs = self.local_maps.query_covisable(
                self.cur_lmid, self.num_covis)
            near = self.covis_idxs[: max(self.num_covis // 2, 1)]
            q, rng, n = self.task_queue, self.rng, self.num_ba_iters
            # pre-prune mapping stays dense: it must re-opacify the capped
            # donors before the prune task reaps them
            for _ in range(n):
                q.append(("mapping", rng.choice(near), False))
            q.append(("prune", None))
            q.extend([("tracking", self.cur_lmid)] * (n // 2))
            for _ in range(n):
                q.append(("mapping", rng.choice(self.covis_idxs), True))
            for _ in range(n):
                q.append(("tracking", rng.choice(self.covis_idxs)))

        if not multi_process:
            while self.task_queue:
                self.process()
            self._check_escalation()
        # host mirror: merges add the donor count, prune refreshes it
        self.totalpts_rec.append(self.n_active_host)

    def update_common_visualization(self):
        """Per-submap backend dashboards (Backend.py:271-331): the aligned
        trajectory plot, point count, per-frame translation error and APE
        history; fills ape_rec and logs to wandb when enabled. Gated by
        config['backend']['common_vis'] as in the reference."""
        if not self.config["backend"].get("common_vis", False):
            return
        self.wait()
        if len(self.local_maps) == 0 or self.local_maps[-1].transform is None:
            return
        from ..utils import viz
        from ..utils.trajectory import ate_rmse

        out_dir = self.config.get("vis_base_dir", "output")
        os.makedirs(out_dir, exist_ok=True)
        w2cs = self.local_maps.get_w2cs()
        gts = self.local_maps.get_gt_w2cs()
        keep = [i for i in range(len(gts)) if np.isfinite(gts[i]).all()]
        w2cs = [w2cs[i] for i in keep]
        gts = [gts[i] for i in keep]
        if len(w2cs) > 3:
            ate = ate_rmse(w2cs, gts)["rmse"]
            self.ape_rec.append(float(ate))
            viz.save_trajectory_plot(w2cs, gts,
                                     os.path.join(out_dir, "evo_2dplot.png"),
                                     ate=ate)
            if self.wandb_run is not None:
                self.wandb_run.log({"cur_lmid": self.cur_lmid, "APE": ate})
        viz.save_series(self.totalpts_rec,
                        os.path.join(out_dir, "backend_numpts.png"))
        dif = [float(np.linalg.norm((np.asarray(w) @ np.linalg.inv(g))[:3, 3]))
               for w, g in zip(w2cs, gts)]
        viz.save_series(dif, os.path.join(out_dir, "trackloss.png"))
        viz.save_series(self.ape_rec, os.path.join(out_dir, "ape.png"))
        if self.wandb_run is not None:
            self.wandb_run.log({"backend_numpts": self.totalpts_rec[-1]
                                if self.totalpts_rec else 0})

    @_on_own_stream
    def final_refine(self, progress=False):
        """Final refinement over random submaps (Backend.final_refine,
        :163-172); -1 iterations means one per processed frame. With
        ``progress`` a line is printed per fused batch."""
        iters = self.final_refinement
        if iters == -1:
            iters = self.local_maps[-1].frames[-1].time_idx
        done = 0
        while done < iters:
            k = min(self.MAP_BATCH, iters - done)
            idxs = [self.rng.choice(range(len(self.local_maps)))
                    for _ in range(k)]
            if (not self.gs_densify and not self.enable_exposure
                    and k == self.MAP_BATCH):
                self.mapping_batch(idxs)
            else:
                for i in idxs:
                    self.mapping(i)
            done += k
            if progress:
                print(f"final_refine {done}/{iters}", flush=True)
