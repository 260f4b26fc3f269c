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
gradients with ``torch.autograd.grad``: one captured program
(slam/programs.py) of its own owner on that device, so the host issues
a shard as one graph launch and goes on to the next card's at once. The
gradients come back to the map's device and are summed there in shard
order, so the result does not depend on which shard finishes first;
the sum, the diagnostics and the Adam step are one more program, of the
map's owner.
"""
from __future__ import annotations

import contextlib

import torch

from ..models import gaussians as G
from ..ops.camera import Camera
from ..ops.consts import constant
from ..render import RenderOptions, capturable, render_full
from ..slam import programs
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


def _shard_body(params, active, w2cs, gts, cam_proj, *, k, dev, opts, lcfg):
    """Shard k's program on ``dev``: keyframe k's loss, its map gradients
    (zeros where a field gets none) and its binning diagnostics. Its
    arguments lie on ``dev`` already in a program (the owner's buffers);
    eagerly they move there first."""
    params = [p.to(dev, non_blocking=True).detach().requires_grad_()
              for p in params]
    loss, diag = _ba_loss(G.Params(*params),
                          active.to(dev, non_blocking=True),
                          w2cs[k].to(dev, non_blocking=True).detach(),
                          gts[k].to(dev, non_blocking=True), cam_proj, opts,
                          lcfg)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    return loss.detach(), G.Params(*grads), diag


def _reduce_body(gm, shards, *, weights, mcfg):
    """The map's program: the weighted mean of the shards' gradients and
    losses (summed in shard order), their diagnostics OR / max reduced
    over the live shards, and one Adam step. The shards' results lie on
    the map's device already in a program; eagerly they move there."""
    home = gm.params.xyz.device
    wsum = max(sum(weights), 1e-9)
    grads = loss = None
    for (l_k, g_k, _), w_k in zip(shards, weights):
        g_k = [g.to(home, non_blocking=True) * w_k for g in g_k]
        l_k = l_k.to(home, non_blocking=True) * w_k
        if grads is None:
            grads, loss = g_k, l_k
        else:
            grads = [a + b for a, b in zip(grads, g_k)]
            loss = loss + l_k
    grads = G.Params(*(g / wsum for g in grads))
    loss = loss / wsum
    live = constant(tuple(x > 0 for x in weights), torch.bool, home)
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


_SHARD_OWNERS: dict = {}


def default_owners(devices) -> list:
    """The owners of a call that names none: shard k's per (device, k),
    distinct also for slots of one card, and the default owner of the
    map's device for the reduction (programs.default_owner, appended by
    ``sharded_ba_step``)."""
    out = []
    for k, dev in enumerate(devices):
        key = (torch.device(dev), k)
        if key not in _SHARD_OWNERS:
            _SHARD_OWNERS[key] = programs.Owner(f"shard{k}", device=dev)
        out.append(_SHARD_OWNERS[key])
    return out


def sharded_ba_step(devices, gm: G.GaussianMap, w2cs: torch.Tensor,
                    gt_tiled: torch.Tensor, cam_proj: Camera,
                    opts: RenderOptions, mcfg, lcfg: LossConfig,
                    weights=None, owners=None):
    """One keyframe-parallel BA step: keyframe k (``w2cs`` [n, 4, 4],
    ``gt_tiled`` [n, T, 4, P]) renders on ``devices[k]``, the map
    gradients are reduced to a weighted mean, and one Adam step updates
    the map on its own device. ``weights`` ([n] host numbers, 1 each by
    default; 0 masks a padded slot) lets a partly filled group contribute
    an unbiased mean.

    The counterpart of the JAX package's one jit over its shard_map: each
    shard is a captured program of its owner on ``devices[k]`` (the map's
    parameters, its render, its gradients and diagnostics), the reduction
    and the Adam step one program of the map's owner. ``owners``: n shard
    owners and the map's owner last (``Backend.ba_owners``); by default
    ``default_owners`` and the map device's default owner, which hands
    out copies. A shard on the map's card reads the map where it lies
    when it lies in an owner's buffers (a map stepped in place), and the
    reduction reads the gradients of such shards where they lie; for a
    shard on another card the map and the results cross as stream-ordered
    copies between the graphs (PyTorch's copies between cards make each
    card's stream wait on the other's), so the host never waits.

    Returns (map, loss, diag): diag holds the binning diagnostics of the
    live shards, OR / max reduced, and ``losses``, each shard's loss."""
    n = len(devices)
    w = tuple(1.0 for _ in range(n)) if weights is None else tuple(
        float(x) for x in weights)
    capture = capturable(opts)
    if owners is None:
        owners = default_owners(devices) + [None]
    shards = []
    for k in range(n):
        dev = torch.device(devices[k])
        with _on(dev):
            shards.append(programs.call(
                owners[k], "ba_shard", _shard_body,
                dict(params=gm.params, active=gm.active, w2cs=w2cs,
                     gts=gt_tiled, cam_proj=cam_proj),
                dict(k=k, dev=dev, opts=opts, lcfg=lcfg),
                outs=("loss", "grads", "diag"), capture=capture,
                capacity=gm.capacity, borrow=("params", "active")))
    return programs.call(
        owners[n], "ba_reduce", _reduce_body, dict(gm=gm, shards=shards),
        dict(weights=w, mcfg=mcfg), outs=("gm", "loss", "diag"),
        capture=capture, borrow=("shards",))
