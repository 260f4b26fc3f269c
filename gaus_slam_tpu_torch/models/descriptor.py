"""Global image descriptors for submap covisibility retrieval (port of
gaus_slam_tpu/models/descriptor.py).

A fixed, training-free multi-scale colour + gradient signature stands in
for the reference's NetVLAD (no pretrained weights without network):
images [H, W, 3] -> L2-normalised [D], ranked by a cosine top-k query.
"""
from __future__ import annotations

import numpy as np
import torch

GRID = 8  # spatial pooling grid


def describe_image(img: torch.Tensor) -> torch.Tensor:
    """img [H, W, 3] (0..1) -> L2-normalised descriptor [D]: GRIDxGRID
    average colour (3) and GRIDxGRID gradient energy (1), D = 256."""
    h, w, _ = img.shape
    gh, gw = h // GRID, w // GRID
    img = img[: gh * GRID, : gw * GRID]
    cells = img.reshape(GRID, gh, GRID, gw, 3)
    mean_color = cells.mean(dim=(1, 3))                       # [G, G, 3]

    gray = img.mean(-1)
    gx = torch.abs(torch.diff(gray, dim=1, prepend=gray[:, :1]))
    gy = torch.abs(torch.diff(gray, dim=0, prepend=gray[:1]))
    grad = (gx + gy).reshape(GRID, gh, GRID, gw).mean(dim=(1, 3))

    d = torch.cat([mean_color.reshape(-1), grad.reshape(-1)])
    d = d - d.mean()
    return d / torch.clamp(torch.linalg.norm(d), min=1e-8)


def describe_frames(imgs) -> torch.Tensor:
    """Stack of images -> [B, D] (reference MyDesc.__call__)."""
    return torch.stack([describe_image(im) for im in imgs])


def query_covisible(desc_matrix, query, k: int):
    """Cosine top-k over per-submap descriptor stacks, on the host.

    desc_matrix: [num_submaps, reps, D]; query: [reps, D]. Per-submap max
    similarity over representative images, then the top-k submap indices
    (Localmaps.query_covisable, scene/Frame.py:284-293)."""
    dm = np.asarray(desc_matrix)
    q = np.asarray(query)
    i = dm.shape[0]
    sims = np.einsum("ird,qd->irq", dm, q).reshape(i, -1)
    max_sims = sims.max(axis=1)
    k = min(k, i)
    idx = np.argsort(-max_sims, kind="stable")[:k]
    return [int(x) for x in idx]
