"""SLAM optimization loops (port of gaus_slam_tpu/slam/steps.py).

The JAX package compiles a whole tracking loop (``lax.while_loop``) and
a whole mapping schedule (``lax.scan``) into single XLA programs; here
they are Python loops over eagerly launched kernels. Where the JAX
program tests a device scalar (the convergence counter of the tracking
early exit), the port keeps it on the device too: every queued iteration
is masked by a device flag, and the host learns of the stop a few
iterations late through a pinned copy (``_LaggedFlag``), never by reading
the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models import gaussians as G
from ..models.frame import (ExposureState, LrSchedule, PoseState,
                            exposure_adam_step, init_exposure, pose_adam_step)
from ..ops.camera import Camera
from ..ops.consts import cached, constant
from ..ops.se3 import invert_se3, pose_params_from_matrix
from ..render import (PairCache, RenderOptions, bin_for_tracking, bin_full,
                      phase_budget, render_full, render_tracking,
                      track_coarse_budget)
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
    count of live iterations), ``lag`` queued iterations late. After
    iteration k is queued its flags are copied into slot k % (lag + 1) of
    a pinned ring (non-blocking) and an event is recorded; ``read(k)``
    waits on that event alone. With lag + 1 slots no copy overwrites a
    slot before the host has read it. On the CPU the copy is the value
    itself and the read a plain read. ``reads`` counts the reads (on a
    card, the event waits)."""

    def __init__(self, lag: int, device: torch.device):
        self.n = lag + 1
        self.cuda = device.type == "cuda"
        self.reads = 0
        if self.cuda:
            self.buf = torch.empty((self.n, 2), dtype=torch.int32,
                                   pin_memory=True)
            self.events = [torch.cuda.Event() for _ in range(self.n)]
        else:
            self.buf = [None] * self.n

    def push(self, k: int, live: torch.Tensor, iters: torch.Tensor):
        flags = torch.stack([live.to(torch.int32), iters])
        i = k % self.n
        if self.cuda:
            self.buf[i].copy_(flags, non_blocking=True)
            self.events[i].record()
        else:
            self.buf[i] = flags

    def read(self, k: int) -> tuple[bool, int]:
        """(live, live iterations) as they stood after iteration k."""
        i = k % self.n
        if self.cuda:
            self.events[i].synchronize()
        self.reads += 1
        live, iters = self.buf[i].tolist()
        return bool(live), int(iters)


def tracking_loop(cache: PairCache, pose0: PoseState, gt_tiled: torch.Tensor,
                  cam_proj: Camera, opts: RenderOptions, tcfg: TrackConfig,
                  lcfg: LossConfig, want_view: bool = False,
                  prev_pose: PoseState | None = None, predict: bool = False,
                  use_vel: bool = True, compact_coarse: bool = False,
                  lag: int = 1):
    """Full tracking optimization for one frame.

    ``want_view=True`` also renders the final pose (detached, all tiles,
    same pair cache: K3) and counts its low-alpha pixels (the keyframe
    test). ``predict=True`` also emits the constant-velocity pose init of
    the next frame. Returns (pose, aux); ``aux["iters"]`` is the device
    count of iterations run, as in the JAX loop.

    The early exit (``converged_th`` > 0) is decided on the device, as
    the JAX while_loop's carry does: each queued iteration computes its
    Adam step and applies it (pose, moments, loss, depth_l1) only while
    the device flag ``live`` holds; ``live`` falls once the convergence
    counter passes 3. The host stops queuing when it sees the fall,
    ``lag`` iterations late: before it queues iteration j it waits on the
    flags copied after iteration j - 1 - lag (lag 0 waits for the
    iteration before). The masked iterations leave every value where the
    stop left it, so the result does not depend on ``lag``. The returned
    pose's host step counts the live iterations; when the loop ends
    without a seen stop, the host waits once, at the end, for the newest
    flags. aux["host_waits"] counts the waits, aux["queued"] the queued
    iterations."""
    dev = gt_tiled.device
    early = tcfg.converged_th > 0
    pose = pose0
    loss = torch.zeros((), device=dev)
    depth_l1 = torch.zeros((), device=dev)
    conv = torch.zeros((), dtype=torch.int32, device=dev)
    live = torch.ones((), dtype=torch.bool, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    flags = _LaggedFlag(lag, dev) if early else None
    state = {"k": 0, "seen": None}  # queued; (live, iters) of a seen stop

    def run(kmax, tile_ids, gt_sub, pair_hi):
        nonlocal pose, loss, depth_l1, conv, live, iters
        while state["k"] < kmax and state["seen"] is None:
            k = state["k"]
            if early and k - 1 - lag >= 0:
                seen = flags.read(k - 1 - lag)
                if not seen[0]:
                    state["seen"] = seen
                    return
            quat = pose.quat.detach().requires_grad_()
            trans = pose.trans.detach().requires_grad_()
            out = render_tracking(cache, quat, trans, cam_proj, opts,
                                  tile_ids=tile_ids, pair_hi=pair_hi)
            loss_k, aux = tracking_loss(out, gt_sub, lcfg)
            g_q, g_t = torch.autograd.grad(loss_k, (quat, trans))
            pose = pose._replace(quat=quat.detach(), trans=trans.detach())
            new_pose = pose_adam_step(pose, g_q, g_t, tcfg.rot_sched,
                                      tcfg.trans_sched, tcfg.betas)
            if early:
                # the JAX body and cond on the device: the step applies
                # only while live; the test in float64, as a host float
                # compares the float32 norm with the threshold
                delta = torch.linalg.norm(new_pose.trans - pose.trans)
                new_pose = PoseState(*(torch.where(live, a, b) for a, b in
                                       zip(new_pose[:6], pose[:6])),
                                     new_pose.step)
                loss = torch.where(live, loss_k.detach(), loss)
                depth_l1 = torch.where(live, aux["depth_l1"].detach(),
                                       depth_l1)
                near = delta.double() < tcfg.converged_th
                conv = torch.where(live, torch.where(
                    near, conv + 1, torch.zeros_like(conv)), conv)
                iters = iters + live.to(torch.int32)
                live = live & (conv <= 3)
                flags.push(k, live, iters)
            else:
                loss = loss_k.detach()
                depth_l1 = aux["depth_l1"].detach()
            pose = new_pose
            state["k"] = k + 1

    consumed = 0
    # the reference backend renders all tiles only: no coarse phase
    levels = tcfg.levels() if opts.backend != "reference" else ()
    for it_l, s_l in levels:
        n_l = min(it_l, tcfg.num_iters - consumed)
        if n_l <= 0 or s_l <= 1:
            continue
        ids = _coarse_tile_ids(opts.grid, s_l, dev)
        pair_hi = (track_coarse_budget(cache.raw_t.shape[1], s_l)
                   if compact_coarse else None)
        run(consumed + n_l, ids, gt_tiled[ids.long()], pair_hi)
        consumed += n_l
    run(tcfg.num_iters, None, gt_tiled, None)

    pose = pose._replace(quat=pose.quat.detach(), trans=pose.trans.detach())
    if not early:
        iters = torch.full((), state["k"], dtype=torch.int32, device=dev)
    aux = {"iters": iters, "loss": loss, "depth_l1": depth_l1,
           "w2c": pose.w2c}
    if predict:
        w2c_f = aux["w2c"]
        pred_m = (w2c_f @ invert_se3(prev_pose.w2c) @ w2c_f
                  if use_vel else w2c_f)
        q, t = pose_params_from_matrix(pred_m)
        z4, z3 = torch.zeros_like(q), torch.zeros_like(t)
        aux["pred_pose"] = PoseState(q, t, z4, z4.clone(), z3, z3.clone(), 0)
        aux["pred_w2c"] = aux["pred_pose"].w2c
    if want_view:
        with torch.no_grad():
            out = render_tracking(cache, pose.quat, pose.trans, cam_proj, opts)
        aux["view"] = out
        aux["n_low"] = torch.sum(out[:, 4] < 0.5).to(torch.int32)
    if early:
        # everything is queued: the one wait for the live count, unless
        # the seen stop already carried it
        seen = state["seen"]
        if seen is None and state["k"] > 0:
            seen = flags.read(state["k"] - 1)
        pose = pose._replace(step=pose0.step + (seen[1] if seen else 0))
    aux["host_waits"] = flags.reads if early else 0
    aux["queued"] = state["k"]
    return pose, aux


def fold_diags(diags):
    """OR/max-reduce a list of per-step binning diagnostics."""
    ov = torch.stack([torch.as_tensor(d["overflow"]) for d in diags])
    ns = torch.stack([torch.as_tensor(d["n_shrunk"]) for d in diags])
    dm = torch.stack([torch.as_tensor(d.get("demand", 0)) for d in diags])
    return {"overflow": torch.any(ov), "n_shrunk": torch.max(ns),
            "demand": torch.max(dm)}


class MapConfig(NamedTuple):
    lrs: tuple                  # sorted tuple of (lr_key, value)
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-15
    isotropic: bool = False
    gs_stats: bool = False      # emit per-gaussian view-space grad stats
                                # (backend gs_densify, Backend.py:117-128)


def mapping_step(gm: G.GaussianMap, w2c: torch.Tensor, gt_tiled: torch.Tensor,
                 exposure: ExposureState, do_exposure, exp_sched: LrSchedule,
                 cam_proj: Camera, opts: RenderOptions, mcfg: MapConfig,
                 lcfg: LossConfig, bins=None, tile_ids=None, tile_valid=None,
                 phase: int | None = None, coarse_stride: int = 0,
                 frame_exp: torch.Tensor | None = None):
    """One mapping iteration: render at a fixed pose with the map
    parameters live, then one Adam step. Under ``lcfg.enable_exposure``
    the (gain, bias) of ``exposure`` are live in the loss too, and step
    when ``do_exposure`` (a host bool here; a device bool in JAX).

    ``frame_exp``: optional [2] (gain, bias) of the frame's frozen
    exposure, composed with the live one as the reference's
    get_frame_exposure (scene/Frame.py:250-257): A = gain * f_gain,
    B = gain * f_bias + bias; the gradient reaches the live pair through
    the composition. Returns (gm, exposure, aux)."""
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
    if lcfg.enable_exposure and bool(do_exposure):
        exposure = exposure_adam_step(exposure, g_exp[0], g_exp[1], exp_sched)
    return gm, exposure, {"loss": loss.detach(),
                          **{k: v.detach() for k, v in aux.items()}, **diag}


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


def mapping_loop(gm: G.GaussianMap, w2cs: torch.Tensor, gts: torch.Tensor,
                 cam_proj: Camera, opts: RenderOptions, mcfg: MapConfig,
                 lcfg: LossConfig, rebin_every: int = 1,
                 coarse_stride: int = 1, phase0: int = 0):
    """K x rebin_every mapping iterations: group g re-bins once against
    the current map at w2cs[g], then runs ``rebin_every`` Adam steps on
    gts[g]. ``coarse_stride`` > 1 renders each iteration on a rotating
    checkerboard of 1/stride^2 of the tiles through the compact
    per-phase path; ``phase0`` offsets the rotation.

    Returns (gm, aux) with the binning diagnostics folded over every
    iteration and ``losses``, the loss of every iteration."""
    dev = gts.device
    dummy_exp = init_exposure(dev)
    n_phase = coarse_stride * coarse_stride
    phases = pvalid = None
    if coarse_stride > 1:
        phases, pvalid = _coarse_map_phases(opts.grid, coarse_stride, dev)
    diags, losses = [], []
    for g_idx in range(w2cs.shape[0]):
        w2c = w2cs[g_idx]
        cam = cam_proj.replace_w2c(w2c.detach())
        bins = bin_full(gm.params, gm.active, cam, opts,
                        phase_stride=coarse_stride if coarse_stride > 1 else 0)
        for j in range(rebin_every):
            if phases is None:
                ids = wt = ph = None
            else:
                ph = (phase0 + g_idx * rebin_every + j) % n_phase
                ids, wt = phases[ph], pvalid[ph]
            gm, _, aux = mapping_step(
                gm, w2c, gts[g_idx], dummy_exp, False, LrSchedule(0.0, 0.0, 1),
                cam_proj, opts, mcfg, lcfg, bins=bins,
                tile_ids=ids, tile_valid=wt, phase=ph,
                coarse_stride=coarse_stride if phases is not None else 0)
            diags.append(aux)
            losses.append(aux["loss"])
    folded = fold_diags(diags)
    losses = torch.stack(losses)
    return gm, {**folded, "loss": losses[-1], "losses": losses}


def backend_tracking_step(gm: G.GaussianMap, pose: PoseState,
                          frame_w2c: torch.Tensor, gt_tiled: torch.Tensor,
                          cam_proj: Camera, opts: RenderOptions,
                          tcfg: TrackConfig, lcfg: LossConfig,
                          exposure: ExposureState | None = None,
                          frame_exp: torch.Tensor | None = None):
    """Backend tracking step (Backend.tracking, Backend.py:81-99): the
    global map is fixed and only the submap transform ``pose`` moves.

    Through the pair cache: bin at the effective pose frame_w2c @ pose,
    then render_tracking with ``pre_w2c=frame_w2c`` and the live
    transform, so the pose gradient flows through the composed means as
    in frontend tracking. ``exposure`` / ``frame_exp``: the composed
    exposure of Backend.py:86-92, applied detached (tracking never steps
    the exposure). Returns (pose, aux)."""
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
    return pose, {"loss": loss.detach(), "depth_l1": aux["depth_l1"].detach(),
                  "overflow": cache.overflow, "n_shrunk": cache.n_shrunk,
                  "demand": cache.demand}


def ba_step(gm, pose, frame_w2c, gt_tiled, exposure, cam_proj, opts, mcfg,
            lcfg, exp_sched, frame_exp=None):
    """Backend "ba" task (Backend.py:130-155): a mapping step at the
    composed pose frame_w2c @ pose, plus a step-count advance of the
    submap transform. The reference's Renderer_mapping detaches that pose
    (render/__init__.py:60), so the transform receives no gradient; the
    exposure steps whenever it is on (no mapping_times gate).
    Returns (gm, pose, exposure, aux)."""
    gm, exposure, aux = mapping_step(
        gm, frame_w2c @ pose.w2c, gt_tiled, exposure, lcfg.enable_exposure,
        exp_sched, cam_proj, opts, mcfg, lcfg, frame_exp=frame_exp)
    return gm, pose._replace(step=pose.step + 1), exposure, aux
