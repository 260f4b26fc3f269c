"""Headless scene inspector (port of scripts/vis_final.py, which replaces
the reference's interactive Open3D viewer).

    python -m gaus_slam_tpu_torch.scripts.vis_final <scene_dir> \
        [--backend pallas|interpret|reference] [--device cuda|cpu] \
        [--num_views N] [--mesh]

Renders ``num_views`` views along the saved trajectory (K3 on the card)
into <scene_dir>/views/view_<frame>.png (imageio where installed, else
utils/png.py) and, with ``--mesh``, TSDF-fuses the renders into
<scene_dir>/mesh.npz.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def _imwrite(path: str, img: np.ndarray) -> None:
    try:
        import imageio.v2 as imageio
    except ImportError:
        from ..utils.png import write_png

        write_png(path, img)
    else:
        imageio.imwrite(path, img)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene_dir")
    ap.add_argument("--backend", default="pallas",
                    choices=("pallas", "interpret", "reference"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--num_views", type=int, default=24)
    ap.add_argument("--mesh", action="store_true")
    args = ap.parse_args(argv)

    from ..ops.composite_ref import tiles_to_image
    from ..render import render_view
    from ..utils.config import SystemConfig
    from ..utils.scene_io import load_scene

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the "
                           "CPU")
    device = torch.device(args.device)
    config, gm, w2cs, _ = load_scene(args.scene_dir, device=device)
    s = SystemConfig.from_config(config, backend=args.backend, device=device)
    out_dir = os.path.join(args.scene_dir, "views")
    os.makedirs(out_dir, exist_ok=True)

    written = []
    idxs = np.linspace(0, len(w2cs) - 1, args.num_views).astype(int)
    for i in idxs:
        out = render_view(gm, s.cam.replace_w2c(torch.as_tensor(
            w2cs[i], dtype=torch.float32, device=device)), s.opts)
        img = tiles_to_image(out[:, 0:3], s.opts.grid, s.cam.height,
                             s.cam.width)
        rgb = np.clip(img.permute(1, 2, 0).cpu().numpy() * 255, 0,
                      255).astype(np.uint8)
        path = os.path.join(out_dir, f"view_{i:05d}.png")
        _imwrite(path, rgb)
        written.append(path)
    print(f"wrote {len(idxs)} views to {out_dir}")

    if args.mesh:
        from ..utils.eval_mesh import fuse_render_mesh

        verts, _, _ = fuse_render_mesh(
            config, gm, list(w2cs), out_dir=args.scene_dir,
            backend=args.backend, device=device)
        print(f"mesh: {len(verts)} vertices -> {args.scene_dir}/mesh.npz")
        written.append(os.path.join(args.scene_dir, "mesh.npz"))
    return written


if __name__ == "__main__":
    main()
