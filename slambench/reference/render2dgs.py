"""Plain PyTorch renderer of a 2D Gaussian surfel map: the reference that
judges the maps and poses the timed path produced.

Frozen copies of the port's plain math (``ops/preprocess.py::
preprocess_t``, ``ops/binning.py::gaussian_rects`` and the rectangle
shrink of ``bin_gaussians``, ``ops/compositing.py::composite_chunk`` in
float32 with surface-aware depth, ``finalize``), without autograd, the
pair budget or the kernels: every (pair, tile) that the rectangles give
is composited, tile by tile in windows of ``chunk`` depth-sorted pairs,
a block of tiles at a time so that a 680x1200 frame fits.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

NEAR_N = 0.2
FAR_N = 100.0
FILTER_INV_SQUARE = 100.0
CUTOFF = 3.0
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
BLOCK = 16  # tile side in pixels (ops/binning.py::make_grid)


class Cam(NamedTuple):
    h: int
    w: int
    fx: float
    fy: float
    cx: float
    cy: float
    near: float = 0.01
    far: float = 100.0


def world_to_pix3(cam: Cam, w2c: torch.Tensor) -> torch.Tensor:
    """[3, 4]: world homogeneous -> pixel homogeneous (OpenGL projection,
    then ndc2pix: pixel = ((ndc + 1) * S - 1) / 2)."""
    w, h, n, f = cam.w, cam.h, cam.near, cam.far
    dev = w2c.device
    proj = torch.tensor([
        [2 * cam.fx / w, 0.0, -(w - 2 * cam.cx) / w, 0.0],
        [0.0, 2 * cam.fy / h, -(h - 2 * cam.cy) / h, 0.0],
        [0.0, 0.0, f / (f - n), -(f * n) / (f - n)],
        [0.0, 0.0, 1.0, 0.0]], dtype=torch.float32, device=dev)
    n2p = torch.tensor([[w / 2.0, 0.0, 0.0, (w - 1) / 2.0],
                        [0.0, h / 2.0, 0.0, (h - 1) / 2.0],
                        [0.0, 0.0, 0.0, 1.0]], dtype=torch.float32,
                       device=dev)
    return n2p @ (proj @ w2c.float())


def surfel_attrs(xyz, log_scales, quats, opacity_logit, rgb, w2c,
                 cam: Cam) -> tuple:
    """Per-surfel [N, 21] attributes (a0, a1, a2, t_w, centre, normal,
    opacity, colour; the layout of the port's pair attributes without
    its padding), validity, centre [N, 2], radius [N], view depth [N]."""
    w2c = w2c.float()
    sc = torch.exp(log_scales)
    op = torch.sigmoid(opacity_logit.reshape(-1))
    qw, qx, qy, qz = quats.unbind(-1)
    n2 = qw * qw + qx * qx + qy * qy + qz * qz
    s = 2.0 / torch.clamp(n2, min=1e-24)
    R = torch.stack([
        torch.stack([1 - s * (qy * qy + qz * qz), s * (qx * qy - qw * qz),
                     s * (qx * qz + qw * qy)], -1),
        torch.stack([s * (qx * qy + qw * qz), 1 - s * (qx * qx + qz * qz),
                     s * (qy * qz - qw * qx)], -1),
        torch.stack([s * (qx * qz - qw * qy), s * (qy * qz + qw * qx),
                     1 - s * (qx * qx + qy * qy)], -1)], -2)
    L0 = R[..., :, 0] * sc[:, 0:1]
    L1 = R[..., :, 1] * sc[:, 1:2]
    nw = R[..., :, 2]

    def rows(M, v, translate=False):
        # M @ v row by row, summed in preprocess_t's order
        out = []
        for i in range(3):
            r = M[i, 0] * v[:, 0] + M[i, 1] * v[:, 1] + M[i, 2] * v[:, 2]
            out.append(r + M[i, 3] if translate else r)
        return torch.stack(out, -1)

    pv = rows(w2c, xyz, translate=True)
    valid = pv[:, 2] > 0.2
    M = world_to_pix3(cam, w2c)
    hu, hv, hp = rows(M, L0), rows(M, L1), rows(M, xyz, translate=True)
    tu = torch.stack([hu[:, 0], hv[:, 0], hp[:, 0]], -1)
    tv = torch.stack([hu[:, 1], hv[:, 1], hp[:, 1]], -1)
    tw = torch.stack([hu[:, 2], hv[:, 2], hp[:, 2]], -1)
    def cross(a, b):
        return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                            a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                            a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], -1)

    a0, a1, a2 = cross(tv, tw), cross(tw, tu), cross(tu, tv)
    nc = rows(w2c, nw)
    cosv = -(pv[:, 0] * nc[:, 0] + pv[:, 1] * nc[:, 1] + pv[:, 2] * nc[:, 2])
    valid = valid & (cosv != 0.0)
    nc = nc * torch.where(cosv > 0, 1.0, -1.0)[:, None]
    c2 = CUTOFF * CUTOFF
    dist = c2 * (tw[:, 0] ** 2 + tw[:, 1] ** 2) - tw[:, 2] ** 2
    valid = valid & (dist != 0.0)
    inv_d = 1.0 / torch.where(dist == 0.0, torch.ones_like(dist), dist)
    cx = (c2 * (tu[:, 0] * tw[:, 0] + tu[:, 1] * tw[:, 1])
          - tu[:, 2] * tw[:, 2]) * inv_d
    cy = (c2 * (tv[:, 0] * tw[:, 0] + tv[:, 1] * tw[:, 1])
          - tv[:, 2] * tw[:, 2]) * inv_d
    tx = (c2 * (tu[:, 0] ** 2 + tu[:, 1] ** 2) - tu[:, 2] ** 2) * inv_d
    ty = (c2 * (tv[:, 0] ** 2 + tv[:, 1] ** 2) - tv[:, 2] ** 2) * inv_d
    ex = torch.sqrt(torch.clamp(cx * cx - tx, min=1e-4))
    ey = torch.sqrt(torch.clamp(cy * cy - ty, min=1e-4))
    radius = torch.ceil(torch.maximum(ex, ey))
    op = torch.where(valid, op, torch.zeros_like(op))
    attrs = torch.cat([a0, a1, a2, tw, cx[:, None], cy[:, None], nc,
                       op[:, None], rgb], dim=1)
    return attrs, valid, torch.stack([cx, cy], -1), radius, pv[:, 2]


def _rects(center, radius, valid, tiles_x, tiles_y):
    def cell(v, hi):
        return torch.clamp(torch.trunc(v), 0, hi).long()

    cx, cy = center[:, 0], center[:, 1]
    x0 = cell((cx - radius) / BLOCK, tiles_x)
    y0 = cell((cy - radius) / BLOCK, tiles_y)
    x1 = cell((cx + radius + BLOCK - 1) / BLOCK, tiles_x)
    y1 = cell((cy + radius + BLOCK - 1) / BLOCK, tiles_y)
    w = torch.clamp(x1 - x0, min=0)
    h = torch.clamp(y1 - y0, min=0)
    return x0, y0, w, torch.where(valid, w * h, torch.zeros_like(w))


def tile_pairs(center, radius, depth, valid, tiles_x, tiles_y, d_max):
    """(pair gaussian index, pair tile) in the binning's order: by tile,
    then by the depth key (the float's top bits that fit beside the tile
    id), then by slab slot (tile-in-rectangle * N + gaussian). A surfel
    over more than ``d_max`` tiles has its radius shrunk until its
    rectangle fits (ops/binning.py::bin_gaussians)."""
    n = center.shape[0]
    dev = center.device
    _, _, _, counts = _rects(center, radius, valid, tiles_x, tiles_y)
    shrink = torch.sqrt(d_max / torch.clamp(counts, min=1).float())
    r_fit = torch.where(counts > d_max, radius * shrink * 0.999, radius)
    x0, y0, w, counts = _rects(center, r_fit, valid, tiles_x, tiles_y)
    counts = torch.clamp(counts, max=d_max)
    d = torch.arange(d_max, device=dev)[:, None]
    ws = torch.clamp(w, min=1)[None, :]
    tile = (y0[None, :] + d // ws) * tiles_x + x0[None, :] + d % ws
    live = d < counts[None, :]
    tile_bits = max(int(tiles_x * tiles_y).bit_length(), 1)
    depth_bits = 31 - tile_bits
    dq = torch.clamp(depth, min=1e-12).float().contiguous().view(torch.int32)
    dq = (dq.long() & 0xFFFFFFFF) >> (32 - depth_bits)
    key = (tile << depth_bits) | dq[None, :]
    key = torch.where(live, key, torch.full_like(key, 1 << 62)).reshape(-1)
    key, order = torch.sort(key, stable=True)
    keep = key < (1 << 62)
    order = order[keep]
    return order % n, key[keep] >> depth_bits


def _excl(x):
    c = torch.cumsum(x, dim=-2)
    return torch.cat([torch.zeros_like(c[..., :1, :]), c[..., :-1, :]], -2)


def _composite(state: dict, a, px, py, valid):
    """One window of G depth-sorted pairs a [n, G, 21] into the pixel
    state (every field [n, 1, P])."""
    def col(i):
        return a[..., i:i + 1]

    f32 = torch.float32
    p_x = px * col(0) + py * col(3) + col(6)
    p_y = px * col(1) + py * col(4) + col(7)
    p_z = px * col(2) + py * col(5) + col(8)
    pz_ok = p_z != 0.0
    inv_pz = pz_ok.to(f32) / torch.where(pz_ok, p_z, torch.ones_like(p_z))
    sx, sy = p_x * inv_pz, p_y * inv_pz
    rho3d = sx * sx + sy * sy
    dx, dy = col(12) - px, col(13) - py
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    rho = torch.minimum(rho3d, rho2d)
    d3 = sx * col(9) + sy * col(10) + col(11)
    d_raw = torch.where(rho3d <= rho2d, d3, col(11).expand_as(d3))
    alpha_raw = col(17) * torch.exp(-0.5 * rho)
    alpha_c = torch.minimum(alpha_raw, torch.full_like(alpha_raw, ALPHA_MAX))
    ok = (pz_ok & (d_raw >= NEAR_N) & (alpha_raw >= ALPHA_MIN) & valid
          & (state["done"] < 0.5)).to(f32)
    alpha_eff = alpha_c * ok
    log1ma = torch.log1p(-alpha_eff)
    T_pref = state["T"] * torch.exp(_excl(log1ma))
    below = (T_pref * (1.0 - alpha_eff) < T_EPS).to(f32)
    af = ok * (1.0 - below)
    w = alpha_c * af * T_pref
    T_out = state["T"] * torch.exp(torch.sum(log1ma * af, -2, keepdim=True))
    G = a.shape[-2]
    gidx = torch.arange(G, dtype=f32, device=a.device)[:, None] + state["base"]
    mcf = af * (T_pref > 0.5).to(f32)
    med_idx = torch.amax(gidx * mcf, -2, keepdim=True)
    mm_new = torch.sum(d_raw * (gidx == med_idx).to(f32) * mcf, -2,
                       keepdim=True)
    mm = torch.where(med_idx > 0.0, mm_new, state["mm"])
    # surface-aware depth fusion at per-pair granularity
    wd = w * d_raw
    d_pref = state["D"] + _excl(wd)
    d2_pref = state["D2"] + _excl(wd * d_raw)
    denom = torch.clamp(1.0 - T_pref, min=1e-12)
    exp_std = torch.clamp((d2_pref - 2.0 * d_pref * mm) / denom + mm * mm,
                          min=1e-7)
    conf = torch.exp(-((mm - d_raw) ** 2) / (4.0 * exp_std))
    conf = torch.where((T_pref > 0.5) | (d_pref <= 0.0),
                       torch.ones_like(conf), conf)
    d_fused = conf * d_raw + (1.0 - conf) * mm
    rgb = a[..., 18:21].transpose(-1, -2) @ w
    state.update(
        T=T_out,
        done=torch.maximum(state["done"],
                           torch.amax(ok * below, -2, keepdim=True)),
        rgb=state["rgb"] + rgb,
        D=state["D"] + torch.sum(d_fused * w, -2, keepdim=True),
        D2=state["D2"] + torch.sum(d_fused * d_fused * w, -2, keepdim=True),
        mm=mm, base=state["base"] + G)
    return state


@torch.no_grad()
def render(params: dict, w2c, cam: Cam, d_max: int, *, chunk: int = 128,
           tiles_per_block: int = 512) -> dict:
    """Colour [H, W, 3], depth [H, W] (D / (alpha + 1e-6), the losses'
    normalised depth) and alpha [H, W] of the surfel map ``params``
    (xyz, log_scales, quats, opacity_logit, rgb: the active rows) seen
    through ``w2c``."""
    dev = params["xyz"].device
    w2c = torch.as_tensor(w2c, dtype=torch.float32, device=dev)
    attrs, valid, center, radius, depth = surfel_attrs(
        params["xyz"], params["log_scales"], params["quats"],
        params["opacity_logit"], params["rgb"], w2c, cam)
    tx, ty = -(-cam.w // BLOCK), -(-cam.h // BLOCK)
    n_tiles = tx * ty
    gid, tile = tile_pairs(center, radius, depth, valid, tx, ty, d_max)
    counts = torch.bincount(tile, minlength=n_tiles)
    start = torch.cumsum(counts, 0) - counts
    P = BLOCK * BLOCK
    p = torch.arange(P, device=dev)
    out_rgb = torch.zeros((n_tiles, 3, P), device=dev)
    out_d = torch.zeros((n_tiles, 1, P), device=dev)
    out_a = torch.zeros((n_tiles, 1, P), device=dev)
    ar = torch.arange(chunk, device=dev)
    rows = attrs[gid]
    for b0 in range(0, n_tiles, tiles_per_block):
        ids = torch.arange(b0, min(b0 + tiles_per_block, n_tiles), device=dev)
        n = ids.numel()
        px = ((ids % tx) * BLOCK)[:, None] + p % BLOCK
        py = ((ids // tx) * BLOCK)[:, None] + p // BLOCK
        px, py = px.float()[:, None, :], py.float()[:, None, :]
        z = torch.zeros((n, 1, P), device=dev)
        st = dict(T=torch.ones_like(z), done=z, rgb=torch.zeros((n, 3, P),
                  device=dev), D=z, D2=z, mm=z,
                  base=torch.ones((n, 1, 1), device=dev))
        lens, s0 = counts[ids], start[ids]
        longest = int(lens.max()) if n else 0
        for c0 in range(0, longest, chunk):
            live = (lens > c0) & (st["done"].amin(dim=(-2, -1)) < 0.5)
            li = torch.nonzero(live)[:, 0]
            if li.numel() == 0:
                break
            gi = s0[li, None] + c0 + ar
            ok = (c0 + ar)[None, :] < lens[li, None]
            a = rows[torch.clamp(gi, max=max(rows.shape[0] - 1, 0))]
            sub = {k: v[li] for k, v in st.items()}
            sub = _composite(sub, a, px[li], py[li], ok[..., None])
            for k, v in sub.items():
                st[k] = torch.index_put(st[k], (li,), v)
        alpha = 1.0 - st["T"]
        out_rgb[ids] = st["rgb"]
        out_d[ids] = st["D"] / (alpha + 1e-6)
        out_a[ids] = alpha

    def image(t):
        c = t.shape[1]
        img = t.reshape(ty, tx, c, BLOCK, BLOCK).permute(2, 0, 3, 1, 4)
        return img.reshape(c, ty * BLOCK, tx * BLOCK)[:, :cam.h, :cam.w]

    return {"color": image(out_rgb).permute(1, 2, 0),
            "depth": image(out_d)[0], "alpha": image(out_a)[0]}


def psnr(mse: float) -> float:
    return -10.0 * math.log10(max(mse, 1e-20))
