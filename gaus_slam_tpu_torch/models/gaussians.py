"""Static-capacity Gaussian surfel map with optimizer-surgery semantics
(port of gaus_slam_tpu/models/gaussians.py).

A preallocated structure-of-arrays of capacity ``C`` with an active
count; grow / prune / opacity capping reproduce the reference's Adam
state surgery:

  * grow: new rows get zeroed Adam moments, the step count is kept;
  * prune: surviving rows keep their moments, compacted in stable order;
  * replace (opacity capping): the replaced tensor's moments are zeroed.

Adam matches torch.optim.Adam (betas=(0.9, 0.999), eps=1e-15 inside the
denominator, bias correction with a per-tensor step count).
The functions return new maps and never modify their inputs.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.consts import at, div_by_entry, host_scalar_divisor, step_table

PARAM_FIELDS = ("xyz", "log_scales", "quats", "opacity_logit", "rgb")
PARAM_DIMS = {"xyz": 3, "log_scales": 2, "quats": 4, "opacity_logit": 1, "rgb": 3}
LR_KEYS = {
    "xyz": "xyz_lr", "log_scales": "scaling_lr", "quats": "rotation_lr",
    "opacity_logit": "opacity_lr", "rgb": "rgb_lr",
}


class Params(NamedTuple):
    xyz: torch.Tensor            # [C, 3]
    log_scales: torch.Tensor     # [C, 2]
    quats: torch.Tensor          # [C, 4] (w, x, y, z)
    opacity_logit: torch.Tensor  # [C, 1]
    rgb: torch.Tensor            # [C, 3]


class GaussianMap(NamedTuple):
    params: Params
    m: Params                    # Adam first moments
    v: Params                    # Adam second moments
    step: torch.Tensor           # shared Adam step count (device int32)
    active: torch.Tensor         # [C] bool
    n_active: torch.Tensor       # scalar int32 (device)

    @property
    def capacity(self) -> int:
        return self.params.xyz.shape[0]


def _zeros_params(capacity: int, device) -> Params:
    return Params(**{
        f: torch.zeros((capacity, PARAM_DIMS[f]), dtype=torch.float32,
                       device=device)
        for f in PARAM_FIELDS
    })


def _identity_quats(n: int, device) -> torch.Tensor:
    q = torch.zeros((n, 4), dtype=torch.float32, device=device)
    q[:, 0] = 1.0
    return q


def empty_map(capacity: int, device="cuda") -> GaussianMap:
    p = _zeros_params(capacity, device)
    # identity quats on inactive rows keep preprocess numerics benign
    p = p._replace(quats=_identity_quats(capacity, device))
    return GaussianMap(
        params=p, m=_zeros_params(capacity, device),
        v=_zeros_params(capacity, device),
        step=torch.zeros((), dtype=torch.int32, device=device),
        active=torch.zeros((capacity,), dtype=torch.bool, device=device),
        n_active=torch.zeros((), dtype=torch.int32, device=device),
    )


def bucket_capacity(n: int, quantum: int = 1 << 16, margin: float = 1.0,
                    floor: int = 0) -> int:
    """Quantized capacity bucket for ``n`` active gaussians."""
    cap = max(quantum, -(-int(n * margin) // quantum) * quantum)
    return max(cap, floor)


def resize_map(gm: GaussianMap, cap: int) -> GaussianMap:
    """Pad (or truncate) every map array to capacity ``cap``; padded
    rows get identity quats."""
    if cap == gm.capacity:
        return gm

    def resize(x):
        if cap > x.shape[0]:
            pad = torch.zeros((cap - x.shape[0],) + x.shape[1:],
                              dtype=x.dtype, device=x.device)
            return torch.cat([x, pad])
        return x[:cap]

    dev = gm.active.device
    params = Params(*(resize(p) for p in gm.params))
    keep = (torch.arange(cap, device=dev) < gm.n_active)[:, None]
    params = params._replace(quats=torch.where(keep, params.quats,
                                               _identity_quats(cap, dev)))
    return gm._replace(
        params=params,
        m=Params(*(resize(p) for p in gm.m)),
        v=Params(*(resize(p) for p in gm.v)),
        active=resize(gm.active),
    )


def map_to(gm: GaussianMap, device) -> GaussianMap:
    """The map with every array copied to ``device``."""
    def move(ps):
        return Params(*(p.to(device) for p in ps))
    return gm._replace(params=move(gm.params), m=move(gm.m), v=move(gm.v),
                       step=gm.step.to(device), active=gm.active.to(device),
                       n_active=gm.n_active.to(device))


def _orientation_quats(normals, n: int, device) -> torch.Tensor:
    from ..ops.geometry import surfel_quat_from_normal

    if normals is None:
        return _identity_quats(n, device)
    return surfel_quat_from_normal(normals)


def _wide(gm: GaussianMap) -> torch.Tensor:
    return torch.cat(list(gm.params) + list(gm.m) + list(gm.v)
                     + [gm.active[:, None].float()], dim=1)


def _unpack_wide(dst: torch.Tensor):
    """Split a [C, 40] (params | m | v | active) block back into parts."""
    dims = [PARAM_DIMS[f] for f in PARAM_FIELDS]
    offs = np.cumsum([0] + dims * 3).tolist()

    def unpack(base):
        return Params(*(dst[:, offs[base + i]:offs[base + i + 1]]
                        for i in range(len(dims))))

    return unpack(0), unpack(5), unpack(10), dst[:, offs[-1]] > 0.5


def add_params(gm: GaussianMap, new: Params, valid: torch.Tensor) -> GaussianMap:
    """Compact the ``valid`` rows of ``new`` onto rows [n_active, ...)
    with zeroed moments; rows past capacity are dropped. The backend's
    merge appends a submap's snapshot this way (Backend.py:227 ->
    Gaussians.add_params), as does densification."""
    C = gm.capacity
    vi = valid.to(torch.int32)
    rank = torch.cumsum(vi, 0) - vi
    n_new = torch.sum(vi)
    dest = torch.where(valid, gm.n_active + rank, torch.full_like(rank, C))
    keep = dest < C
    zeros_src = [torch.zeros_like(s) for s in new]
    src = torch.cat(list(new) + zeros_src + zeros_src
                    + [valid[:, None].float()], dim=1)
    # every dropped row lands on one spare row past capacity, cut off
    # after: no boolean mask, so the host never waits for the row count
    wide = _wide(gm)
    wide = torch.cat([wide, wide.new_zeros((1, wide.shape[1]))])
    dst = wide.index_put((torch.where(keep, dest, C).long(),), src)[:C]
    params, m, v, active = _unpack_wide(dst)
    return gm._replace(
        params=params, m=m, v=v, active=active,
        n_active=torch.clamp(gm.n_active + n_new, max=C).to(torch.int32),
    )


def create_from_points_masked(capacity, points, colors, normals, init_scale,
                              valid=None) -> GaussianMap:
    """Gaussians.create_from_pcd: log-scale from the depth-derived initial
    scale, surfel orientation from normals, opacity logit 0."""
    gm = empty_map(capacity, points.device)
    return add_gaussians(gm, points, colors, normals, init_scale, valid=valid)


def add_gaussians(gm: GaussianMap, points, colors, normals, init_scale,
                  valid=None) -> GaussianMap:
    """Append candidate gaussians where ``valid`` with zeroed moments
    (cat_tensors_to_optimizer semantics)."""
    n = points.shape[0]
    dev = points.device
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    ls = torch.log(torch.clamp(init_scale, min=1e-12))[:, None].expand(n, 2)
    new = Params(
        xyz=points.float(),
        log_scales=ls.float(),
        quats=_orientation_quats(normals, n, dev),
        opacity_logit=torch.zeros((n, 1), dtype=torch.float32, device=dev),
        rgb=colors.float(),
    )
    return add_params(gm, new, valid)


def transform(gm: GaussianMap, transfer: torch.Tensor) -> GaussianMap:
    """Rigid transform of the whole map (transform_gaussians,
    Gaussians.py:404-416): xyz and quats move, their Adam moments reset."""
    from ..ops.se3 import quat_multiply, rotmat_to_quat

    R, t = transfer[:3, :3], transfer[:3, 3]
    params = gm.params._replace(
        xyz=gm.params.xyz @ R.T + t,
        quats=quat_multiply(rotmat_to_quat(R)[None, :], gm.params.quats))
    zeros3, zeros4 = torch.zeros_like(gm.m.xyz), torch.zeros_like(gm.m.quats)
    return gm._replace(params=params,
                       m=gm.m._replace(xyz=zeros3, quats=zeros4),
                       v=gm.v._replace(xyz=zeros3, quats=zeros4))


def prune(gm: GaussianMap, prune_mask: torch.Tensor) -> GaussianMap:
    """Remove gaussians where prune_mask is True, compacting in stable
    order with moments preserved."""
    keep = gm.active & ~prune_mask
    order = torch.argsort((~keep).to(torch.int32), stable=True)
    n_new = torch.sum(keep).to(torch.int32)
    wide = torch.cat(list(gm.params) + list(gm.m) + list(gm.v), dim=1)[order]
    active = torch.arange(gm.capacity, device=keep.device) < n_new
    params, m, v, _ = _unpack_wide(torch.cat([wide, active[:, None].float()],
                                             dim=1))
    return gm._replace(params=params, m=m, v=v, active=active, n_active=n_new)


def cap_opacity(gm: GaussianMap, max_opacity: float = 0.01) -> GaussianMap:
    """opacity <- min(opacity, logit(max)) with opacity moments reset."""
    cap = float(np.log(max_opacity / (1.0 - max_opacity)))
    params = gm.params._replace(
        opacity_logit=torch.clamp(gm.params.opacity_logit, max=cap))
    z = torch.zeros_like(gm.m.opacity_logit)
    return gm._replace(
        params=params,
        m=gm.m._replace(opacity_logit=z),
        v=gm.v._replace(opacity_logit=z),
    )


def _bias_correction(b: float, step: int) -> float:
    """1 - b ** step in float32, as the JAX version computes it."""
    t = torch.tensor(float(step), dtype=torch.float32)
    return float(1.0 - torch.tensor(b, dtype=torch.float32) ** t)


def bias_table(b: float, device) -> torch.Tensor:
    """The divisors of ``_bias_correction(b, t)`` for the device Adam steps
    t = 0 .. saturation_step(b), as ``device`` divides by a host float;
    t = 0 is never read."""
    from .frame import saturation_step

    n = saturation_step(b)

    def entries():
        assert _bias_correction(b, n) == 1.0, (b, n)
        return [1.0] + [host_scalar_divisor(_bias_correction(b, t), device)
                        for t in range(1, n + 1)]
    return step_table(("map_bias", float(b)), entries, device)


def adam_step(gm: GaussianMap, grads: Params, lrs: dict,
              betas: tuple = (0.9, 0.999), eps: float = 1e-15,
              isotropic: bool = False) -> GaussianMap:
    """One torch-semantics Adam step over all param groups, masked to
    active rows. ``isotropic`` ties the two scale columns. The bias
    corrections come from tables indexed by the device step."""
    if isotropic:
        tied = torch.sum(grads.log_scales, dim=-1, keepdim=True)
        grads = grads._replace(log_scales=tied.expand_as(grads.log_scales))
    b1, b2 = betas
    dev = gm.active.device
    step = gm.step + 1
    d1, d2 = at(bias_table(b1, dev), step), at(bias_table(b2, dev), step)
    act = gm.active[:, None]

    new_p, new_m, new_v = [], [], []
    for name, p, m, v, g in zip(PARAM_FIELDS, gm.params, gm.m, gm.v, grads):
        g = torch.where(act, g, torch.zeros_like(g))
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        upd = div_by_entry(m, d1) / (torch.sqrt(div_by_entry(v, d2)) + eps)
        p = p - lrs[LR_KEYS[name]] * torch.where(act, upd, torch.zeros_like(upd))
        new_p.append(p)
        new_m.append(m)
        new_v.append(v)
    return gm._replace(params=Params(*new_p), m=Params(*new_m),
                       v=Params(*new_v), step=step)


def densify_masks(gm: GaussianMap, grad_stat: torch.Tensor, *,
                  grad_threshold: float, percent_dense: float,
                  extent: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(clone, split) masks of densify_and_prune: active gaussians whose
    view-space gradient statistic reaches the threshold, cloned when
    their largest scale is at most percent_dense * extent, else split."""
    max_scale = torch.exp(gm.params.log_scales).max(dim=-1).values
    hot = (grad_stat >= grad_threshold) & gm.active
    small = max_scale <= percent_dense * extent
    return hot & small, hot & ~small


def densify_and_prune(gm: GaussianMap, grad_stat: torch.Tensor,
                      generator: torch.Generator | None = None, *,
                      grad_threshold: float, percent_dense: float,
                      extent: float, min_opacity: float, min_scale: float,
                      split_n: int = 2, noise=None) -> GaussianMap:
    """3DGS-style clone / split / prune (the reference's
    Gaussians.densify_and_prune, scene/Gaussians.py:532-593, run by the
    backend's gs_densify, Backend.py:117-128).

      clone: small gaussians with a large view-space gradient are copied
        in place (new rows, zeroed Adam moments);
      split: large ones are replaced by ``split_n`` children at
        parent + R[:, :, 0] n0 + R[:, :, 1] n1, n ~ N(0, 1) * scales,
        with log-scales shrunk by log(0.8 * split_n);
      prune: opacity under min_opacity, mean scale under min_scale, or
        largest scale over 0.1 * extent (the world-space bound; the
        reference's screen-space one is never re-populated), and the
        split parents.

    The draws come from ``generator`` (on the map's device); ``noise``,
    one [C, 2] standard-normal tensor per child, replaces them."""
    scales = torch.exp(gm.params.log_scales)
    clone_mask, split_mask = densify_masks(
        gm, grad_stat, grad_threshold=grad_threshold,
        percent_dense=percent_dense, extent=extent)

    gm = add_params(gm, gm.params, clone_mask)

    from ..ops.se3 import quat_to_rotmat

    R = quat_to_rotmat(gm.params.quats)
    child = gm.params._replace(
        log_scales=gm.params.log_scales - float(np.log(0.8 * split_n)))
    for i in range(split_n):
        if noise is not None:
            n01 = noise[i].to(scales.device, scales.dtype)
        else:
            n01 = torch.randn(scales.shape, generator=generator,
                              dtype=scales.dtype, device=scales.device)
        nz = n01 * scales
        off = R[..., :, 0] * nz[:, 0:1] + R[..., :, 1] * nz[:, 1:2]
        gm = add_params(gm, child._replace(xyz=child.xyz + off), split_mask)

    opac = torch.sigmoid(gm.params.opacity_logit[:, 0])
    scales = torch.exp(gm.params.log_scales)
    prune_mask = ((opac < min_opacity)
                  | (scales.mean(dim=-1) < min_scale)
                  | (scales.max(dim=-1).values > 0.1 * extent))
    return prune(gm, (prune_mask | split_mask) & gm.active)


def extract_params(gm: GaussianMap) -> tuple[Params, torch.Tensor, torch.Tensor]:
    """Detached snapshot for submap handoff (Gaussians.extract_params): a
    copy, since a captured step rewrites the map's buffers in place
    (slam/programs.py)."""
    return (Params(*(p.detach().clone() for p in gm.params)),
            gm.active.clone(), gm.n_active.clone())
