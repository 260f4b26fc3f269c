"""SLAM optimization loops (port of gaus_slam_tpu/slam/steps.py).

The JAX package compiles a whole tracking loop (``lax.while_loop``) and
a whole mapping schedule (``lax.scan``) into single XLA programs, and
jits a mapping step and a backend tracking step. Here each of those
steps is a program of ``slam/programs.py`` (a CUDA graph captured once
per key and replayed): ``mapping_step``, ``ba_step``,
``backend_tracking_step``, a whole ``mapping_loop`` and a whole
``tracking_loop`` are one program each; the tracking loop's while_loops
are CUDA graph conditional WHILE nodes, so the card decides when each
level stops, as the JAX program's cond does. Every per-step value is a
device value, as JAX traces it: the Adam step counters and the tables
they index, the exposure flag, the coarse phase, the tracking loop's
convergence counter. The uncapturable reference backend keeps a loop
that the host queues an iteration at a time: every queued iteration is
masked by a device flag, and the host learns of the stop a few
iterations late through a pinned copy (``_LaggedFlag``), never by
reading the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models import gaussians as G
from ..models.frame import (ExposureState, LrSchedule, PoseState,
                            exposure_adam_step, init_exposure, pose_adam_step,
                            zero_step)
from ..ops.camera import Camera
from ..ops.consts import cached, constant
from ..ops.se3 import invert_se3, pose_matrix, pose_params_from_matrix
from ..render import (PairCache, RenderOptions, bin_for_tracking, bin_full,
                      capturable, phase_budget, render_full, render_tracking,
                      track_coarse_budget)
from . import programs
from .loss import LossConfig, mapping_loss, tracking_loss


class TrackConfig(NamedTuple):
    num_iters: int
    converged_th: float         # <= 0 disables the early exit
    rot_sched: LrSchedule
    trans_sched: LrSchedule
    betas: tuple = (0.7, 0.99)
    # coarse-to-fine: the first `coarse_iters` iterations render only a
    # `coarse_stride`-strided checkerboard of image tiles
    coarse_iters: int = 0
    coarse_stride: int = 2
    # pyramid schedule ((iters, stride), ...) coarse -> fine; supersedes
    # coarse_iters / coarse_stride when non-empty
    coarse_levels: tuple = ()

    def levels(self) -> tuple:
        if self.coarse_levels:
            return tuple((int(i), int(s)) for i, s in self.coarse_levels)
        if self.coarse_iters > 0:
            return ((self.coarse_iters, self.coarse_stride),)
        return ()




def _coarse_tile_ids(grid, stride: int, device) -> torch.Tensor:
    """Strided checkerboard of image-tile ids."""
    ty = torch.arange(0, grid.tiles_y, stride, dtype=torch.int32, device=device)
    tx = torch.arange(0, grid.tiles_x, stride, dtype=torch.int32, device=device)
    return (ty[:, None] * grid.tiles_x + tx[None, :]).reshape(-1)


class _LaggedFlag:
    """The host's view of the tracking loop's device flags (``live``, the
    count of live iterations), ``lag`` queued iterations late. Iteration k
    copies its flags into slot k % (lag + 1) of a ring (pinned memory on a
    card, ``programs.FlagRing``) and an event is recorded once it is
    queued; ``read(k)`` waits on that event alone. With lag + 1 slots no
    copy overwrites a slot before the host has read it. ``reads`` counts
    the reads (on a card, the event waits)."""

    def __init__(self, ring):
        self.ring = ring
        self.reads = 0

    def read(self, k: int) -> tuple[bool, int]:
        """(live, live iterations) as they stood after iteration k."""
        i = k % self.ring.n
        self.ring.wait(i)
        self.reads += 1
        live, iters = self.ring.buf[i].tolist()
        return bool(live), int(iters)


class _Carry(NamedTuple):
    """The tracking loop's device state besides the pose (the JAX
    while_loop's carry)."""
    loss: torch.Tensor
    depth_l1: torch.Tensor
    conv: torch.Tensor       # int32 count of converged iterations
    live: torch.Tensor       # bool: the early exit has not fired
    iters: torch.Tensor      # int32 count of live iterations


def _level_tile_ids(grid, stride: int, device) -> torch.Tensor:
    """``_coarse_tile_ids``, made once per (grid, stride, device)."""
    return cached(("coarse_tile_ids", grid, stride),
                  lambda: _coarse_tile_ids(grid, stride, "cpu"), device)


def _track_iter(cache, gt, pose, carry, cam_proj, *, opts, tcfg, lcfg,
                stride, pair_hi, masked, ring=None, slot=0):
    """One tracking iteration (the JAX loop's body) on the level of
    checkerboard ``stride`` (1: every tile). ``masked``: the step applies
    only while ``carry.live`` holds, and the carry counts the convergence
    and the live iterations (the JAX body and cond on the device); then
    with a ``ring`` the iteration's flags go into its slot ``slot``.
    Unmasked (no early exit) it counts the iterations alone."""
    tile_ids = (_level_tile_ids(opts.grid, stride, gt.device) if stride > 1
                else None)
    gt_sub = gt if tile_ids is None else gt[tile_ids.long()]
    quat = pose.quat.detach().requires_grad_()
    trans = pose.trans.detach().requires_grad_()
    out = render_tracking(cache, quat, trans, cam_proj, opts,
                          tile_ids=tile_ids, pair_hi=pair_hi)
    loss_k, aux = tracking_loss(out, gt_sub, lcfg)
    g_q, g_t = torch.autograd.grad(loss_k, (quat, trans))
    pose = pose._replace(quat=quat.detach(), trans=trans.detach())
    new_pose = pose_adam_step(pose, g_q, g_t, tcfg.rot_sched,
                              tcfg.trans_sched, tcfg.betas)
    if not masked:
        return new_pose, carry._replace(loss=loss_k.detach(),
                                        depth_l1=aux["depth_l1"].detach(),
                                        iters=carry.iters + 1)
    # the JAX body and cond on the device: the step (and the step count)
    # applies only while live; the test in float64, as a host float
    # compares the float32 norm with the threshold
    live = carry.live
    delta = torch.linalg.norm(new_pose.trans - pose.trans)
    new_pose = PoseState(*(torch.where(live, a, b)
                           for a, b in zip(new_pose, pose)))
    loss = torch.where(live, loss_k.detach(), carry.loss)
    depth_l1 = torch.where(live, aux["depth_l1"].detach(), carry.depth_l1)
    near = delta.double() < tcfg.converged_th
    conv = torch.where(live, torch.where(
        near, carry.conv + 1, torch.zeros_like(carry.conv)), carry.conv)
    iters = carry.iters + live.to(torch.int32)
    live = live & (conv <= 3)
    if ring is not None:
        ring.push(slot, torch.stack([live.to(torch.int32), iters]))
    return new_pose, _Carry(loss, depth_l1, conv, live, iters)


def _track_tail(cache, pose, prev_pose, cam_proj, *, opts, want_view,
                predict, use_vel):
    """After the iterations: the final pose's w2c, the constant-velocity
    init of the next frame (``predict``), the detached final-pose render
    and its low-alpha pixel count (``want_view``)."""
    aux = {"w2c": pose.w2c}
    if predict:
        w2c_f = aux["w2c"]
        pred_m = (w2c_f @ invert_se3(prev_pose.w2c) @ w2c_f
                  if use_vel else w2c_f)
        q, t = pose_params_from_matrix(pred_m)
        t = t.contiguous()   # as init_pose lays it out
        z4, z3 = torch.zeros_like(q), torch.zeros_like(t)
        aux["pred_pose"] = PoseState(q, t, z4, z4.clone(), z3, z3.clone(),
                                     zero_step(q.device))
        aux["pred_w2c"] = aux["pred_pose"].w2c
    if want_view:
        with torch.no_grad():
            out = render_tracking(cache, pose.quat, pose.trans, cam_proj,
                                  opts)
        aux["view"] = out
        aux["n_low"] = torch.sum(out[:, 4] < 0.5).to(torch.int32)
    return aux


def _levels(cache: PairCache, opts: RenderOptions, tcfg: TrackConfig,
            compact_coarse: bool) -> list:
    """The loop's levels, coarse to fine: (kmax, checkerboard stride,
    pair_hi); a level runs while fewer than kmax iterations ran."""
    out, consumed = [], 0
    # the reference backend renders all tiles only: no coarse phase
    for it_l, s_l in (tcfg.levels() if opts.backend != "reference" else ()):
        n_l = min(it_l, tcfg.num_iters - consumed)
        if n_l <= 0 or s_l <= 1:
            continue
        consumed += n_l
        out.append((consumed, s_l,
                    track_coarse_budget(cache.raw_t.shape[1], s_l)
                    if compact_coarse else None))
    return out + [(tcfg.num_iters, 1, None)]


def _carry0(dev) -> _Carry:
    f32, i32 = torch.float32, torch.int32
    return _Carry(constant(0.0, f32, dev), constant(0.0, f32, dev),
                  constant(0, i32, dev), constant(True, torch.bool, dev),
                  constant(0, i32, dev))


def tracking_loop(cache: PairCache, pose0: PoseState, gt_tiled: torch.Tensor,
                  cam_proj: Camera, opts: RenderOptions, tcfg: TrackConfig,
                  lcfg: LossConfig, want_view: bool = False,
                  prev_pose: PoseState | None = None, predict: bool = False,
                  use_vel: bool = True, compact_coarse: bool = False,
                  lag: int | None = None, owner=None):
    """Full tracking optimization for one frame.

    ``want_view=True`` also renders the final pose (detached, all tiles,
    same pair cache: K3) and counts its low-alpha pixels (the keyframe
    test). ``predict=True`` also emits the constant-velocity pose init of
    the next frame. Returns (pose, aux); ``aux["iters"]`` is the device
    count of iterations run, as in the JAX loop. The returned pose and
    aux are the caller's own (copies of the loop's state), except the
    tail's results, which the owner's next loop rewrites.

    Where the steps can be captured (``render.capturable``), the whole
    loop is one program of ``owner`` (``programs.while_loop``): one launch
    runs every iteration of every level and the tail, and the card
    decides when each level stops, as the JAX while_loop's cond does
    (``_track_iter`` with ``masked``, with the early exit on: its
    early-exit math). Under ``programs.eager()`` the same loop runs as
    while_loop's host loop on plain calls. aux["host_waits"] and
    aux["queued"] are 0 on both.

    Otherwise (the reference backend; a caller that passes ``lag``) the
    host queues the iterations, each one program
    (per level and ring slot), the tail another. The early exit
    (``converged_th`` > 0) is decided on the device all the same: each
    queued iteration computes its Adam step and applies it (pose and its
    step count, moments, loss, depth_l1) only while the device flag
    ``live`` holds; ``live`` falls once the convergence counter passes 3.
    The host stops queuing when it sees the fall, ``lag`` (default 1)
    iterations late: before it queues iteration j it waits on the flags
    copied after iteration j - 1 - lag (lag 0 waits for the iteration
    before). The masked iterations leave every value where the stop left
    it, so the result does not depend on ``lag``. When the loop ends
    without a seen stop, the host waits once, at the end, for the newest
    flags. aux["host_waits"] counts the waits, aux["queued"] the queued
    iterations."""
    dev = gt_tiled.device
    early = tcfg.converged_th > 0
    levels = _levels(cache, opts, tcfg, compact_coarse)
    if lag is None and (capturable(opts) or programs.is_eager()):
        static = dict(opts=opts, tcfg=tcfg, lcfg=lcfg, masked=early)
        done, aux = programs.while_loop(
            owner, "tracking_loop", _track_iter,
            [(dict(static, stride=s_l, pair_hi=hi), kmax, early)
             for kmax, s_l, hi in levels],
            dict(cache=cache, gt=gt_tiled, pose=pose0, carry=_carry0(dev),
                 cam_proj=cam_proj, prev_pose=prev_pose if predict else None),
            carry=("pose", "carry"),
            cond=lambda a: (a["carry"].iters, a["carry"].live),
            body_args=("cache", "gt", "pose", "carry", "cam_proj"),
            tail=_track_tail, tail_args=("cache", "pose", "prev_pose",
                                         "cam_proj"),
            tail_static=dict(opts=opts, want_view=want_view, predict=predict,
                             use_vel=use_vel))
        pose, carry = done["pose"], done["carry"]
        aux.update(iters=carry.iters.clone(), loss=carry.loss.clone(),
                   depth_l1=carry.depth_l1.clone(), host_waits=0, queued=0)
        return PoseState(*(t.detach().clone() for t in pose)), aux
    lag = 1 if lag is None else lag
    own = None if programs.is_eager() else programs.resolve(owner, dev)
    ring = None
    if early:
        ring = (own.ring(lag + 1, dev) if own is not None else
                programs.FlagRing(lag + 1, dev))
    flags = _LaggedFlag(ring) if early else None
    carry = _carry0(dev)
    pose = pose0
    state = {"k": 0, "seen": None}  # queued; (live, iters) of a seen stop

    def run(kmax, stride, pair_hi):
        nonlocal pose, carry
        while state["k"] < kmax and state["seen"] is None:
            k = state["k"]
            if early and k - 1 - lag >= 0:
                seen = flags.read(k - 1 - lag)
                if not seen[0]:
                    state["seen"] = seen
                    return
            slot = k % (lag + 1) if early else 0
            pose, carry = programs.call(
                own, "tracking_iter", _track_iter,
                dict(cache=cache, gt=gt_tiled, pose=pose, carry=carry,
                     cam_proj=cam_proj),
                dict(opts=opts, tcfg=tcfg, lcfg=lcfg, stride=stride,
                     pair_hi=pair_hi, masked=early, ring=ring, slot=slot),
                outs=("pose", "carry"), capture=capturable(opts))
            if early:
                ring.queued(slot)
            state["k"] = k + 1

    for kmax, s_l, pair_hi in levels:
        run(kmax, s_l, pair_hi)

    aux = programs.call(
        own, "tracking_tail", _track_tail,
        dict(cache=cache, pose=pose, prev_pose=prev_pose if predict else None,
             cam_proj=cam_proj),
        dict(opts=opts, want_view=want_view, predict=predict,
             use_vel=use_vel), outs="aux", capture=capturable(opts))
    # the loop's state lives in the owner's buffers: hand out copies
    pose = PoseState(*(t.detach().clone() for t in pose))
    aux.update(iters=carry.iters.clone(), loss=carry.loss.clone(),
               depth_l1=carry.depth_l1.clone())
    if early and state["seen"] is None and state["k"] > 0:
        # everything is queued: the one wait for the newest flags
        flags.read(state["k"] - 1)
    aux["host_waits"] = flags.reads if early else 0
    aux["queued"] = state["k"]
    return pose, aux


def _bin_tracking(gm, w2c, cam_proj, *, opts, coarse_strides):
    """``bin_tracking``'s body."""
    return bin_for_tracking(gm, cam_proj.replace_w2c(_as_w2c(w2c)), opts,
                            coarse_strides=coarse_strides)


def bin_tracking(gm: G.GaussianMap, w2c, cam_proj: Camera,
                 opts: RenderOptions, coarse_strides: tuple = (),
                 owner=None, into: str = "cache") -> PairCache:
    """``render.bin_for_tracking`` at ``w2c`` (a [4, 4] tensor or a
    ``ComposedW2C``) as a captured program of ``owner``. Its PairCache
    lands in the buffers of the tracking programs' argument ``into``
    ("cache": the next tracking loop reads it where it lies; another name
    keeps it apart, for a later loop)."""
    return programs.call(
        owner, "bin_for_tracking", _bin_tracking,
        dict(gm=gm, w2c=w2c, cam_proj=cam_proj),
        dict(opts=opts, coarse_strides=tuple(coarse_strides)),
        outs="." + into, capture=capturable(opts))


def _bin_mapping(gm, w2c, cam_proj, *, opts):
    """``bin_mapping``'s body: the Binning's one python field (its d_max,
    ``num_tiles_touched``) left out of the results."""
    bins = bin_full(gm.params, gm.active, cam_proj.replace_w2c(_as_w2c(w2c)),
                    opts)
    return bins._replace(num_tiles_touched=None)


def bin_mapping(gm: G.GaussianMap, w2c, cam_proj: Camera,
                opts: RenderOptions, owner=None):
    """``render.bin_full`` at ``w2c`` (the mapping binning a group of
    per-step mapping iterations shares; the JAX frontend's
    ``_bin_full_jit``) as a captured program of ``owner``. Its Binning
    lands in the buffers of the mapping programs' argument ``bins``, where
    the next ``mapping_step`` reads it."""
    bins = programs.call(owner, "bin_mapping", _bin_mapping,
                         dict(gm=gm, w2c=w2c, cam_proj=cam_proj),
                         dict(opts=opts), outs=".bins",
                         capture=capturable(opts))
    return bins._replace(num_tiles_touched=opts.max_tiles_per_gaussian)


def pack_diag(aux) -> torch.Tensor:
    """A step's binning diagnostics as one [3] int32 device vector
    (overflow, n_shrunk, demand; demand 0 where a step has none)."""
    ns = aux["n_shrunk"]
    dm = aux.get("demand")
    dm = torch.zeros_like(ns) if dm is None else dm
    return torch.stack([t.to(torch.int32) for t in (aux["overflow"], ns, dm)])


class DiagFold:
    """The running OR / max of steps' binning diagnostics, on the device:
    ``add`` reads a step's ``aux["diag"]`` (``pack_diag``) once, so the
    step's own buffers may be rewritten after it."""

    def __init__(self):
        self.v = None
        self.n = 0

    def add(self, aux):
        d = aux["diag"] if "diag" in aux else pack_diag(aux)
        self.v = d.clone() if self.v is None else torch.maximum(self.v, d)
        self.n += 1

    def folded(self) -> dict:
        """{"overflow", "n_shrunk", "demand"} as device scalars."""
        return {"overflow": self.v[0] > 0, "n_shrunk": self.v[1],
                "demand": self.v[2]}


class MapConfig(NamedTuple):
    lrs: tuple                  # sorted tuple of (lr_key, value)
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-15
    isotropic: bool = False
    gs_stats: bool = False      # emit per-gaussian view-space grad stats
                                # (backend gs_densify, Backend.py:117-128)


class ComposedW2C(NamedTuple):
    """A task's camera, composed inside the step that uses it: a pose
    (quat, trans), left-multiplied by ``est`` [4, 4] when given (a backend
    task: the frame's pose in its submap left of the submap transform,
    LocalMap.get_frame_w2c; a frontend frame: Frame.get_w2c)."""
    est: torch.Tensor | None
    quat: torch.Tensor
    trans: torch.Tensor

    @property
    def w2c(self) -> torch.Tensor:
        m = pose_matrix(self.quat, self.trans)
        return m if self.est is None else self.est @ m


def _as_w2c(w2c) -> torch.Tensor:
    return w2c.w2c if isinstance(w2c, ComposedW2C) else w2c


def _take(t: torch.Tensor, i) -> torch.Tensor:
    """Row ``i`` (a python int or a device int scalar) of ``t``."""
    if isinstance(i, int):
        return t[i]
    return t.index_select(0, i.reshape(1))[0]


def _mapping_step(gm, w2c, gt_tiled, exposure, do_exposure, cam_proj,
                  bins=None, tile_ids=None, tile_valid=None, phase=None,
                  frame_exp=None, *, exp_sched, opts, mcfg, lcfg,
                  coarse_stride=0):
    """``mapping_step``'s body; ``do_exposure`` a device bool."""
    w2c = _as_w2c(w2c)
    cam = cam_proj.replace_w2c(w2c.detach())
    if bins is None:
        bins = bin_full(gm.params, gm.active, cam, opts,
                        phase_stride=coarse_stride if phase is not None else 0)
    gt_sub = gt_tiled if tile_ids is None else gt_tiled[tile_ids.long()]

    params = G.Params(*(p.detach().requires_grad_() for p in gm.params))
    live = list(params)
    exp = None
    if lcfg.enable_exposure:
        gain = exposure.gain.detach().requires_grad_()
        bias = exposure.bias.detach().requires_grad_()
        if frame_exp is None:
            exp = exposure._replace(gain=gain, bias=bias)
        else:
            exp = exposure._replace(gain=gain * frame_exp[0],
                                    bias=gain * frame_exp[1] + bias)
        live += [gain, bias]
    out, _ = render_full(params, gm.active, cam, opts, bins=bins,
                         need_normal=opts.normals_in_tracking,
                         tile_ids=tile_ids, tile_valid=tile_valid,
                         phase=phase, coarse_stride=coarse_stride)
    loss, aux = mapping_loss(out, gt_sub, lcfg, exposure=exp)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    g_exp = grads[5:]
    grads = G.Params(*grads[:5])

    overflow = bins.overflow
    if phase is not None:
        sizes = bins.phase_start[1:] - bins.phase_start[:-1]
        overflow = overflow | torch.any(
            sizes > phase_budget(opts, gm.params.xyz.shape[0],
                                 coarse_stride) - 127)
    diag = {"num_pairs": bins.num_pairs, "overflow": overflow,
            "n_shrunk": bins.n_shrunk, "demand": bins.demand}
    diag["diag"] = pack_diag(diag)
    if mcfg.gs_stats:
        # view-space positional gradient for clone / split selection (the
        # reference's means2D gradient, Gaussians.py:58-62): the world xyz
        # gradient rotated into the camera frame, through the projection
        # Jacobian's inverse z / f, in NDC scaling (W / 2, H / 2); the
        # z-coupled term is ignored, as in the JAX package
        w2c_d = w2c.detach()
        g_cam = grads.xyz @ w2c_d[:3, :3].T
        z = torch.clamp((gm.params.xyz.detach() @ w2c_d[:3, :3].T
                         + w2c_d[:3, 3])[:, 2], min=1e-6)
        gu = g_cam[:, 0] * z / cam_proj.fx * (cam_proj.width / 2.0)
        gv = g_cam[:, 1] * z / cam_proj.fy * (cam_proj.height / 2.0)
        visible = bins.counts > 0
        diag["densify_stat"] = torch.where(
            visible, torch.sqrt(gu * gu + gv * gv), torch.zeros_like(gu))
        diag["visible"] = visible
    gm = G.adam_step(gm, grads, dict(mcfg.lrs), mcfg.betas, mcfg.eps,
                     isotropic=mcfg.isotropic)
    if lcfg.enable_exposure:
        # the exposure steps where the device flag says so (JAX: a traced
        # bool), its step count with it
        stepped = exposure_adam_step(exposure, g_exp[0], g_exp[1], exp_sched)
        exposure = ExposureState(*(torch.where(do_exposure, a, b)
                                   for a, b in zip(stepped, exposure)))
    return gm, exposure, {"loss": loss.detach(),
                          **{k: v.detach() for k, v in aux.items()}, **diag}


def _device_bool(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return constant(bool(x), torch.bool, device)


def mapping_step(gm: G.GaussianMap, w2c, gt_tiled: torch.Tensor,
                 exposure: ExposureState, do_exposure, exp_sched: LrSchedule,
                 cam_proj: Camera, opts: RenderOptions, mcfg: MapConfig,
                 lcfg: LossConfig, bins=None, tile_ids=None, tile_valid=None,
                 phase=None, coarse_stride: int = 0,
                 frame_exp: torch.Tensor | None = None, owner=None):
    """One mapping iteration: render at a fixed pose with the map
    parameters live, then one Adam step. Under ``lcfg.enable_exposure``
    the (gain, bias) of ``exposure`` are live in the loss too, and step
    where ``do_exposure`` (a host or device bool; JAX traces it) holds.

    ``w2c``: a [4, 4] tensor or a ``ComposedW2C``. ``frame_exp``:
    optional [2] (gain, bias) of the frame's frozen exposure, composed
    with the live one as the reference's get_frame_exposure
    (scene/Frame.py:250-257): A = gain * f_gain, B = gain * f_bias +
    bias; the gradient reaches the live pair through the composition.
    One captured program of ``owner``. Returns (gm, exposure, aux); aux
    holds ``diag``, the diagnostics packed (``pack_diag``)."""
    dev = gt_tiled.device
    return programs.call(
        owner, "mapping_step", _mapping_step,
        dict(gm=gm, w2c=w2c, gt_tiled=gt_tiled, exposure=exposure,
             do_exposure=_device_bool(do_exposure, dev), cam_proj=cam_proj,
             bins=bins, tile_ids=tile_ids, tile_valid=tile_valid,
             phase=phase, frame_exp=frame_exp),
        dict(exp_sched=exp_sched, opts=opts, mcfg=mcfg, lcfg=lcfg,
             coarse_stride=coarse_stride),
        outs=("gm", "exposure", "aux"), copies=("exposure",),
        capture=capturable(opts))


def _coarse_map_phases_host(grid, stride: int):
    """([stride^2, Ts] tile-id phases, [stride^2, Ts] validity) as host
    arrays: the rotating checkerboard schedule; shorter phases are padded
    with repeats marked invalid (rendered empty)."""
    phases, valids = [], []
    for oy in range(stride):
        for ox in range(stride):
            ty = np.arange(oy, grid.tiles_y, stride)
            tx = np.arange(ox, grid.tiles_x, stride)
            ids = (ty[:, None] * grid.tiles_x + tx[None, :]).reshape(-1)
            phases.append(ids)
            valids.append(np.ones(len(ids), bool))
    ts = max(len(p) for p in phases)
    out = np.stack([np.resize(p, ts) for p in phases]).astype(np.int32)
    val = np.stack([np.concatenate([v, np.zeros(ts - len(v), bool)])
                    for v in valids])
    return out, val


def _coarse_map_phases(grid, stride: int, device):
    """``_coarse_map_phases_host`` on ``device``, made once per (grid,
    stride, device)."""
    key = ("coarse_map_phases", grid, stride)
    return (cached(key + ("ids",),
                   lambda: _coarse_map_phases_host(grid, stride)[0], device),
            cached(key + ("valid",),
                   lambda: _coarse_map_phases_host(grid, stride)[1], device))


def _mapping_loop(gm, w2cs, gts, cam_proj, phase0, *, opts, mcfg, lcfg,
                  rebin_every, coarse_stride):
    """``mapping_loop``'s body; ``phase0`` a device int32 scalar."""
    dev = gts[0].device
    dummy_exp = init_exposure(dev)
    no_exp = constant(False, torch.bool, dev)
    n_phase = coarse_stride * coarse_stride
    phases = pvalid = None
    if coarse_stride > 1:
        phases, pvalid = _coarse_map_phases(opts.grid, coarse_stride, dev)
    fold, losses = DiagFold(), []
    for g_idx in range(len(w2cs)):
        w2c = _as_w2c(w2cs[g_idx])
        cam = cam_proj.replace_w2c(w2c.detach())
        bins = bin_full(gm.params, gm.active, cam, opts,
                        phase_stride=coarse_stride if coarse_stride > 1 else 0)
        for j in range(rebin_every):
            if phases is None:
                ids = wt = ph = None
            else:
                # the traced phase of JAX's scan
                ph = torch.remainder(phase0 + (g_idx * rebin_every + j),
                                     n_phase)
                ids, wt = _take(phases, ph), _take(pvalid, ph)
            gm, _, aux = _mapping_step(
                gm, w2c, gts[g_idx], dummy_exp, no_exp, cam_proj, bins=bins,
                tile_ids=ids, tile_valid=wt, phase=ph,
                exp_sched=LrSchedule(0.0, 0.0, 1), opts=opts, mcfg=mcfg,
                lcfg=lcfg,
                coarse_stride=coarse_stride if phases is not None else 0)
            fold.add(aux)
            losses.append(aux["loss"])
    losses = torch.stack(losses)
    return gm, {**fold.folded(), "diag": fold.v, "loss": losses[-1],
                "losses": losses}


def mapping_loop(gm: G.GaussianMap, w2cs, gts, cam_proj: Camera,
                 opts: RenderOptions, mcfg: MapConfig, lcfg: LossConfig,
                 rebin_every: int = 1, coarse_stride: int = 1, phase0=0,
                 owner=None):
    """K x rebin_every mapping iterations: group g re-bins once against
    the current map at w2cs[g], then runs ``rebin_every`` Adam steps on
    gts[g]. ``coarse_stride`` > 1 renders each iteration on a rotating
    checkerboard of 1/stride^2 of the tiles through the compact
    per-phase path; ``phase0`` (a host or device int, traced as in JAX)
    offsets the rotation. ``w2cs`` / ``gts``: stacked tensors or lists
    (a list's entries bind one by one, and ``w2cs`` entries may be
    ``ComposedW2C``).

    One captured program of ``owner``, as JAX's scan is one program.
    Returns (gm, aux) with the binning diagnostics folded over every
    iteration (and packed as ``diag``) and ``losses``, the loss of every
    iteration."""
    dev = gts[0].device
    if not isinstance(phase0, torch.Tensor):
        phase0 = constant(int(phase0), torch.int32, dev)
    return programs.call(
        owner, "mapping_loop", _mapping_loop,
        dict(gm=gm, w2cs=w2cs, gts=gts, cam_proj=cam_proj, phase0=phase0),
        dict(opts=opts, mcfg=mcfg, lcfg=lcfg, rebin_every=rebin_every,
             coarse_stride=coarse_stride), outs=("gm", "aux"),
        capture=capturable(opts))


def _backend_tracking_step(gm, pose, frame_w2c, gt_tiled, cam_proj,
                           exposure=None, frame_exp=None, *, opts, tcfg,
                           lcfg):
    """``backend_tracking_step``'s body."""
    exp = None
    if exposure is not None and lcfg.enable_exposure:
        fe = (frame_exp if frame_exp is not None
              else constant((1.0, 0.0), torch.float32, exposure.gain.device))
        exp = exposure._replace(
            gain=(exposure.gain * fe[0]).detach(),
            bias=(exposure.gain * fe[1] + exposure.bias).detach())
    cache = bin_for_tracking(gm, cam_proj.replace_w2c(frame_w2c @ pose.w2c),
                             opts)
    quat = pose.quat.detach().requires_grad_()
    trans = pose.trans.detach().requires_grad_()
    out = render_tracking(cache, quat, trans, cam_proj, opts,
                          pre_w2c=frame_w2c)
    loss, aux = tracking_loss(out, gt_tiled, lcfg, exposure=exp)
    g_q, g_t = torch.autograd.grad(loss, (quat, trans))
    pose = pose_adam_step(pose, g_q, g_t, tcfg.rot_sched, tcfg.trans_sched,
                          tcfg.betas)
    diag = {"overflow": cache.overflow, "n_shrunk": cache.n_shrunk,
            "demand": cache.demand}
    return pose, {"loss": loss.detach(), "depth_l1": aux["depth_l1"].detach(),
                  **diag, "diag": pack_diag(diag)}


def backend_tracking_step(gm: G.GaussianMap, pose: PoseState,
                          frame_w2c: torch.Tensor, gt_tiled: torch.Tensor,
                          cam_proj: Camera, opts: RenderOptions,
                          tcfg: TrackConfig, lcfg: LossConfig,
                          exposure: ExposureState | None = None,
                          frame_exp: torch.Tensor | None = None, owner=None):
    """Backend tracking step (Backend.tracking, Backend.py:81-99): the
    global map is fixed and only the submap transform ``pose`` moves.

    Through the pair cache: bin at the effective pose frame_w2c @ pose,
    then render_tracking with ``pre_w2c=frame_w2c`` and the live
    transform, so the pose gradient flows through the composed means as
    in frontend tracking. ``exposure`` / ``frame_exp``: the composed
    exposure of Backend.py:86-92, applied detached (tracking never steps
    the exposure). One captured program of ``owner``, its binning
    included. Returns (pose, aux)."""
    return programs.call(
        owner, "backend_tracking_step", _backend_tracking_step,
        dict(gm=gm, pose=pose, frame_w2c=frame_w2c, gt_tiled=gt_tiled,
             cam_proj=cam_proj, exposure=exposure, frame_exp=frame_exp),
        dict(opts=opts, tcfg=tcfg, lcfg=lcfg), outs=("pose", "aux"),
        copies=("pose",), capture=capturable(opts))


def _ba_step(gm, pose, frame_w2c, gt_tiled, exposure, do_exposure, cam_proj,
             frame_exp=None, *, opts, mcfg, lcfg, exp_sched):
    gm, exposure, aux = _mapping_step(
        gm, frame_w2c @ pose.w2c, gt_tiled, exposure, do_exposure, cam_proj,
        frame_exp=frame_exp, exp_sched=exp_sched, opts=opts, mcfg=mcfg,
        lcfg=lcfg)
    return gm, pose._replace(step=pose.step + 1), exposure, aux


def ba_step(gm, pose, frame_w2c, gt_tiled, exposure, cam_proj, opts, mcfg,
            lcfg, exp_sched, frame_exp=None, owner=None):
    """Backend "ba" task (Backend.py:130-155): a mapping step at the
    composed pose frame_w2c @ pose, plus a step-count advance of the
    submap transform. The reference's Renderer_mapping detaches that pose
    (render/__init__.py:60), so the transform receives no gradient; the
    exposure steps whenever it is on (no mapping_times gate). One
    captured program of ``owner``. Returns (gm, pose, exposure, aux)."""
    dev = gt_tiled.device
    return programs.call(
        owner, "ba_step", _ba_step,
        dict(gm=gm, pose=pose, frame_w2c=frame_w2c, gt_tiled=gt_tiled,
             exposure=exposure,
             do_exposure=_device_bool(lcfg.enable_exposure, dev),
             cam_proj=cam_proj, frame_exp=frame_exp),
        dict(opts=opts, mcfg=mcfg, lcfg=lcfg, exp_sched=exp_sched),
        outs=("gm", "pose", "exposure", "aux"), copies=("pose", "exposure"),
        capture=capturable(opts))
