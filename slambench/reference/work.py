"""The kernels' work and the card's peaks: frozen copies of
``chip_smoke.py``'s ``pair_pixel_work``, ``cull_rejects``, ``op_bound``
and its per-(pair, pixel) counts, float32 path only.

A roofline share counts the (pair, pixel) work that the run's data needs
(evaluations until each pixel terminates, those the cull test rejects,
those accepted), whatever kernel computes it, and the bytes read once
and written once; its bound is the larger of the operation time and the
byte time at the published peaks.
"""
from __future__ import annotations

import torch

from .render2dgs import ALPHA_MIN, FILTER_INV_SQUARE, NEAR_N

# One H100 SXM (NVIDIA data sheet, at a 700 W limit). The special-function
# units give 16 results (reciprocal, exp2, log2) per SM per clock against
# 128 f32 lanes doing an FMA (2 FLOP) each: the f32 rate / 16.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
SFU_PER_S = F32_FLOP_PER_S / 16
# (FLOP, SFU) per (pair, pixel), counted once from composite_chunk (SA
# on, normals off) without a kernel's own recompute. FLOP: add, sub, mul,
# min, max and compare 1 each, a fused multiply-add 2; SFU: reciprocals,
# exp and log. Per evaluation: ray-splat geometry and alpha 38 + (rcp,
# exp); accept test and transmittance 7 + (log1p, exp).
FWD_EVAL = (45, 4)
# Per evaluation that the cull test rejects, which needs that test alone.
CULL_EVAL = (25, 0)
# Per accepted (pair, pixel): weight, median test, colour, SA prefixes and
# log-sum 13; SA's fusion weight and fused depth 25 + (rcp, rcp, exp).
FWD_ACCEPTED = (38, 3)
# K2 per accepted (pair, pixel): the forward's per-pair values without
# its colour and depth sums (38 - 11), the hand-derived vjp 64 + (rcp),
# and the sum over pixels of the 18 gradient rows it touches 18.
BWD_ACCEPTED = (27 + 64 + 18, 4)


def tile_pixel_coords(tiles_x: int, block: int, t: torch.Tensor):
    """Pixel x, y [n, 1, P] of tiles ``t`` (row-major pixels)."""
    ids = t.long()[:, None]
    p = torch.arange(block * block, device=ids.device)
    x = (ids % tiles_x) * block + p % block
    y = (ids // tiles_x) * block + p // block
    return x.float().unsqueeze(-2), y.float().unsqueeze(-2)


def cull_rejects(op, dx, dy, p_x, p_y, p_z):
    """The kernels' conservative cull on tensors: both squared distances
    of a (pair, pixel) past the pair's cull radius rho_cull(op) (-1 where
    no pixel can pass the alpha test), the 3D one without the division."""
    m = 1.0 / 1024.0
    lim = torch.where(op < ALPHA_MIN, torch.full_like(op, -1.0),
                      2.0 * torch.log(op / ALPHA_MIN) * (1.0 + m) + m)
    return ((FILTER_INV_SQUARE * (dx * dx + dy * dy) > lim)
            & (p_x * p_x + p_y * p_y > lim * (p_z * p_z)))


def pair_pixel_work(pattrs, ts, te, out, tiles_x, block=16, chunk=16384):
    """(evaluations, culled, accepted, wrongly culled) of one render:
    pair attributes [24, R], tile ranges ts / te of tiles 0..T-1 and the
    forward's output [T, 16, P] (n_contrib in row 13, done in row 15). A
    pixel evaluates its tile's pairs until it terminates, just past its
    last contributor; it accepts a pair at or before that whose depth and
    alpha tests pass. Wrongly culled (must be 0): rejected by the cull
    although the alpha test passes."""
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
    px, py = tile_pixel_coords(tiles_x, block,
                               torch.arange(lens.numel(), device=dev))
    accepted = culled = wrong = 0
    for c0 in range(0, tile.numel(), chunk):
        t, kk = tile[c0:c0 + chunk], k[c0:c0 + chunk]
        a = pattrs[:, ts.long()[t] + kk].T[..., None]
        x, y = px[t, 0], py[t, 0]
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
        rej = cull_rejects(a[:, 17], a[:, 12] - x, a[:, 13] - y, p_x, p_y,
                           p_z)
        ok = (pz_ok & (d_raw >= NEAR_N) & (alpha >= ALPHA_MIN)
              & ((kk + 1)[:, None].float() <= nc[t]))
        accepted += int(ok.sum())
        ev = kk[:, None].double() < upto[t]
        culled += int((rej & ev).sum())
        wrong += int((rej & pz_ok & (alpha >= ALPHA_MIN)).sum())
    return evals, float(culled), float(accepted), wrong


def op_bound(evals, accepted, per_accepted, nbytes, culled=0.0):
    """(bound ms, 'operations' or 'bytes'): the f32 and special-function
    pipes run side by side, so the operation time is the larger of the
    two; the bound is the larger of that and the bytes' time."""
    kept = evals - culled
    flop = (kept * FWD_EVAL[0] + culled * CULL_EVAL[0]
            + accepted * per_accepted[0])
    sfu = (kept * FWD_EVAL[1] + culled * CULL_EVAL[1]
           + accepted * per_accepted[1])
    t_ops = max(flop / F32_FLOP_PER_S, sfu / SFU_PER_S) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def kernel_bytes(pattrs, n_tiles, out, kexit) -> dict:
    """Bytes each kernel reads once and writes once: K1 the pair
    attributes and tile ranges in, its output and stash out; K2 those in
    and its gradient rows (the attributes' size) and output's cotangent."""
    in_bytes = pattrs.numel() * 4 + 3 * n_tiles * 4
    out_bytes = out.numel() * 4
    stash_bytes = int(kexit.sum()) * 8 * 256 * 4
    return {"k1": in_bytes + out_bytes + stash_bytes,
            "k2": 2 * in_bytes + 2 * out_bytes + stash_bytes}
