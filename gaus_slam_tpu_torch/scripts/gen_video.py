"""Render a flythrough video of a saved scene (port of scripts/gen_video.py;
the reference captures a mesh video with Open3D, here the map is rendered
by the port's rasterizer).

    python -m gaus_slam_tpu_torch.scripts.gen_video <scene_dir> \
        [--backend pallas|interpret|reference] [--device cuda|cpu] \
        [--fps 30] [--stride 2] [--mesh [--n_frames 180] [--size 480]]

The trajectory flythrough renders every ``--stride``-th saved pose: RGB
beside the depth normalized to its frame's maximum (flythrough.mp4).
``--mesh`` fuses the TSDF mesh from renders (utils/eval_mesh.py::
fuse_render_mesh), draws area-weighted colored surface samples and
z-buffer-splats them along a circular orbit around the scene
(mesh_flythrough.mp4). utils/viz.py::frames_to_video writes the file: an
mp4 through imageio where it imports, else a GIF of the port's own
encoder beside it. ``flythrough_frames`` and ``mesh_flythrough_frames``
return the frames before encoding.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def flythrough_frames(scene_dir: str, backend: str = "pallas", stride: int = 2,
                      device="cuda") -> list:
    """[H, 2W, 3] float frames: RGB | normalized depth at every
    ``stride``-th saved pose."""
    from ..ops.composite_ref import tiles_to_image
    from ..render import render_view
    from ..slam.loss import normalized_depth
    from ..utils.config import SystemConfig
    from ..utils.scene_io import load_scene

    dev = torch.device(device)
    config, gm, w2cs, _ = load_scene(scene_dir, device=dev)
    s = SystemConfig.from_config(config, backend=backend, device=dev)
    frames = []
    with torch.no_grad():
        for i in range(0, len(w2cs), stride):
            w2c = torch.as_tensor(np.asarray(w2cs[i]), dtype=torch.float32,
                                  device=dev)
            out = render_view(gm, s.cam.replace_w2c(w2c), s.opts)
            img = tiles_to_image(
                torch.cat([out[:, 0:3],
                           normalized_depth(out, s.lcfg)[:, None]], 1),
                s.opts.grid, s.cam.height, s.cam.width).cpu().numpy()
            rgb = np.clip(img[:3].transpose(1, 2, 0), 0, 1)
            d = img[3]
            dn = np.clip(d / max(d.max(), 1e-6), 0, 1)
            frames.append(np.concatenate(
                [rgb, np.repeat(dn[..., None], 3, -1)], axis=1))
    return frames


def mesh_flythrough_frames(scene_dir: str, backend: str = "pallas",
                           n_frames: int = 180, size: int = 480,
                           device="cuda"):
    """TSDF-mesh orbit, the headless analogue of the reference's
    gen_animation Open3D capture (open3d_ui/vis_mesh.py:319-325): fuse the
    final mesh from renders, then z-buffer-splat 2M colored surface
    samples (area-weighted, barycentric colors) into ``n_frames`` views
    of ``size`` x ``size`` along a circle around the scene. Returns
    (frames, number of mesh vertices)."""
    from ..utils.eval_mesh import (_oriented_bounds, _viewmatrix,
                                   fuse_render_mesh)
    from ..utils.scene_io import load_scene

    config, gm, w2cs, _ = load_scene(scene_dir, device=torch.device(device))
    verts, cols, tris = fuse_render_mesh(
        config, gm, list(w2cs), out_dir=scene_dir, backend=backend,
        mesh_interval=config.get("eval", {}).get("mesh_interval", 5),
        voxel_size=config.get("eval", {}).get("voxel_size", 0.01),
        device=device)

    rng = np.random.default_rng(0)
    n = 2_000_000
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    p = area / max(area.sum(), 1e-12)
    idx = rng.choice(len(tris), n, p=p)
    u, v = rng.random(n), rng.random(n)
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    w = 1 - u - v
    pts = (w[:, None] * v0[idx] + u[:, None] * v1[idx]
           + v[:, None] * v2[idx])
    c0, c1, c2 = cols[tris[idx, 0]], cols[tris[idx, 1]], cols[tris[idx, 2]]
    pcol = w[:, None] * c0 + u[:, None] * c1 + v[:, None] * c2

    extents, to_world = _oriented_bounds(verts)
    center = to_world[:3, 3]
    radius = 0.7 * float(np.linalg.norm(extents[:2]) / 2)
    focal = size * 0.8
    cx = cy = size / 2.0 - 0.5
    frames = []
    for k in range(n_frames):
        th = 2 * np.pi * k / n_frames
        local = np.array([radius * np.cos(th), radius * np.sin(th),
                          -0.4 * extents[2]])
        origin = to_world[:3, :3] @ local + center
        c2w = _viewmatrix(center - origin, np.array([0.0, 0.0, -1.0]),
                          origin)
        w2c = np.linalg.inv(c2w)
        pc = pts @ w2c[:3, :3].T + w2c[:3, 3]
        z = pc[:, 2]
        m = z > 0.05
        uu = np.round(pc[m, 0] / z[m] * focal + cx).astype(np.int64)
        vv = np.round(pc[m, 1] / z[m] * focal + cy).astype(np.int64)
        inb = (uu >= 0) & (uu < size) & (vv >= 0) & (vv < size)
        lin = vv[inb] * size + uu[inb]
        zi = z[m][inb]
        depth = np.full(size * size, np.inf, np.float32)
        np.minimum.at(depth, lin, zi.astype(np.float32))
        img = np.zeros((size * size, 3), np.float32)
        win = zi <= depth[lin] * 1.001  # points on the visible surface
        img[lin[win]] = pcol[m][inb][win]
        frames.append(img.reshape(size, size, 3))
    return frames, len(verts)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene_dir")
    ap.add_argument("--backend", default="pallas",
                    choices=("pallas", "interpret", "reference"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--fps", type=int, default=30)
    ap.add_argument("--stride", type=int, default=2)
    ap.add_argument("--mesh", action="store_true",
                    help="TSDF-mesh orbit animation (gen_animation "
                         "analogue) instead of the trajectory flythrough")
    ap.add_argument("--n_frames", type=int, default=180,
                    help="--mesh: frames of the orbit")
    ap.add_argument("--size", type=int, default=480,
                    help="--mesh: frame edge in pixels")
    args = ap.parse_args(argv)

    from ..utils.viz import frames_to_video

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the "
                           "CPU")
    if args.mesh:
        frames, n_verts = mesh_flythrough_frames(
            args.scene_dir, args.backend, args.n_frames, args.size,
            args.device)
        path = frames_to_video(frames, os.path.join(
            args.scene_dir, "mesh_flythrough.mp4"), fps=args.fps)
        print(f"wrote {path} ({len(frames)} frames, {n_verts} mesh "
              f"vertices)")
        return path
    frames = flythrough_frames(args.scene_dir, args.backend, args.stride,
                               args.device)
    path = frames_to_video(frames, os.path.join(args.scene_dir,
                                                "flythrough.mp4"),
                           fps=args.fps)
    print(f"wrote {path} ({len(frames)} frames)")
    return path


if __name__ == "__main__":
    main()
