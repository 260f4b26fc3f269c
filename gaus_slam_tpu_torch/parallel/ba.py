"""Keyframe-parallel bundle adjustment (port of
gaus_slam_tpu/parallel/ba.py).

The reference's backend optimizes the global map one random keyframe at
a time (slam/Backend.py:101-128). One sharded BA step renders a group of
keyframes of the covisible set, one per device of the group, against the
same map, averages their map gradients and takes one Adam step: the work
of ``len(devices)`` mapping iterations.

One controller, as ``jax.shard_map`` is one program over a mesh driven
from one process: the Backend is one object in one driver process, so
the group is a list of torch.devices and no process group is formed.
Shard k puts the map's parameters on ``devices[k]`` (no copy when that
is the map's own device), renders keyframe k there and takes its
gradients with ``torch.autograd.grad``. No step of a shard waits on the
host for its card (tools/sync_audit.py), so the host goes on to the next
shard's launches at once; but the host issues a shard's many small
kernels no faster than one card runs them, so on four cards a step took
about as long as on four slots of one card (PERF.md, section 6).
The gradients come back to the map's device and are summed there in
shard order, so the result does not depend on which shard finishes
first.
"""
from __future__ import annotations

import contextlib

import torch

from ..models import gaussians as G
from ..ops.camera import Camera
from ..ops.consts import constant
from ..render import RenderOptions, render_full
from ..slam.loss import LossConfig, mapping_loss


def make_devices(n_devices: int | None = None, device="cuda") -> list:
    """The first ``n_devices`` cards (all of them by default); on the CPU,
    ``n_devices`` times the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * (n_devices or 1)
    n = n_devices or torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n)]


def _ba_loss(params, active, w2c, gt_tiled, cam_proj: Camera,
             opts: RenderOptions, lcfg: LossConfig):
    cam = cam_proj.replace_w2c(w2c)
    out, bins = render_full(params, active, cam, opts,
                            need_normal=opts.normals_in_tracking)
    loss, _ = mapping_loss(out, gt_tiled, lcfg)
    # the binning diagnostics ride along so the caller's escalation
    # ladder sees an overflow on the sharded path too
    return loss, (bins.overflow, bins.n_shrunk, bins.demand)


def _on(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else \
        contextlib.nullcontext()


def _shard(gm: G.GaussianMap, w2c, gt_tiled, cam_proj, opts, lcfg, dev):
    """(loss, grads, diag) of one keyframe on ``dev``."""
    with _on(dev):
        params = [p.to(dev, non_blocking=True).detach().requires_grad_()
                  for p in gm.params]
        loss, diag = _ba_loss(G.Params(*params),
                              gm.active.to(dev, non_blocking=True),
                              w2c.to(dev, non_blocking=True).detach(),
                              gt_tiled.to(dev, non_blocking=True), cam_proj,
                              opts, lcfg)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
    return loss.detach(), grads, diag


def sharded_ba_step(devices, gm: G.GaussianMap, w2cs: torch.Tensor,
                    gt_tiled: torch.Tensor, cam_proj: Camera,
                    opts: RenderOptions, mcfg, lcfg: LossConfig,
                    weights=None):
    """One keyframe-parallel BA step: keyframe k (``w2cs`` [n, 4, 4],
    ``gt_tiled`` [n, T, 4, P]) renders on ``devices[k]``, the map
    gradients are reduced to a weighted mean, and one Adam step updates
    the map on its own device. ``weights`` ([n] host numbers, 1 each by
    default; 0 masks a padded slot) lets a partly filled group contribute
    an unbiased mean.

    Returns (map, loss, diag): diag holds the binning diagnostics of the
    live shards, OR / max reduced, and ``losses``, each shard's loss."""
    n = len(devices)
    w = [1.0] * n if weights is None else [float(x) for x in weights]
    home = gm.params.xyz.device
    shards = [_shard(gm, w2cs[k], gt_tiled[k], cam_proj, opts, lcfg,
                     devices[k]) for k in range(n)]
    wsum = max(sum(w), 1e-9)
    grads = loss = None
    for (l_k, g_k, _), w_k in zip(shards, w):
        g_k = [g.to(home, non_blocking=True) * w_k for g in g_k]
        l_k = l_k.to(home, non_blocking=True) * w_k
        if grads is None:
            grads, loss = g_k, l_k
        else:
            grads = [a + b for a, b in zip(grads, g_k)]
            loss = loss + l_k
    grads = G.Params(*(g / wsum for g in grads))
    loss = loss / wsum
    live = constant(tuple(x > 0 for x in w), torch.bool, home)
    ov, ns, dm = (torch.stack([s[2][i].to(home, non_blocking=True)
                               for s in shards]) for i in range(3))
    diag = {"overflow": torch.any(ov & live),
            "n_shrunk": torch.max(torch.where(live, ns, 0)),
            "demand": torch.max(torch.where(live, dm, 0)),
            "losses": torch.stack([s[0].to(home, non_blocking=True)
                                   for s in shards])}
    # isotropic ties the scale columns as the sequential mapping step
    # does (the JAX step leaves it out; 2DGS surfels run with False)
    gm = G.adam_step(gm, grads, dict(mcfg.lrs), mcfg.betas, mcfg.eps,
                     isotropic=mcfg.isotropic)
    return gm, loss, diag
