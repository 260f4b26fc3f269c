"""Binary PLY I/O of the gaussian map in pure numpy (the port's own copy
of the gaussian part of gaus_slam_tpu/utils/ply.py; the mesh readers and
writers come with eval_mesh).

Schema matches the reference checkpoint format
(scene/Gaussians.py:434-466): vertex properties
x y z nx ny nz opacity scale_0 scale_1 rot_0..rot_3 r g b — all f4.
Normals are written as zeros; opacity/scales are the RAW (logit / log)
parameters.
"""
from __future__ import annotations

import os

import numpy as np


def write_gaussians_ply(path, xyz, log_scales, quats, opacity_logit, rgb):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = xyz.shape[0]
    names = (
        ["x", "y", "z", "nx", "ny", "nz", "opacity"]
        + [f"scale_{i}" for i in range(log_scales.shape[1])]
        + [f"rot_{i}" for i in range(quats.shape[1])]
        + ["r", "g", "b"]
    )
    dtype = [(name, "<f4") for name in names]
    data = np.concatenate(
        [xyz, np.zeros_like(xyz), opacity_logit.reshape(n, 1),
         log_scales, quats, rgb], axis=1,
    ).astype("<f4")
    arr = np.rec.fromarrays(list(data.T), dtype=dtype)

    header = "\n".join(
        ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        + [f"property float {name}" for name in names]
        + ["end_header", ""]
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        arr.tofile(f)


def read_gaussians_ply(path):
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = 0
        names = []
        for line in header:
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                names.append(line.split()[-1])
        data = np.fromfile(f, dtype="<f4", count=n * len(names))
    data = data.reshape(n, len(names))
    cols = {name: data[:, i] for i, name in enumerate(names)}
    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
    scale_names = sorted((k for k in cols if k.startswith("scale_")),
                         key=lambda s: int(s.split("_")[-1]))
    rot_names = sorted((k for k in cols if k.startswith("rot_")),
                       key=lambda s: int(s.split("_")[-1]))
    return {
        "xyz": xyz,
        "log_scales": np.stack([cols[k] for k in scale_names], axis=1),
        "quats": np.stack([cols[k] for k in rot_names], axis=1),
        "opacity_logit": cols["opacity"][:, None],
        "rgb": np.stack([cols["r"], cols["g"], cols["b"]], axis=1),
    }
