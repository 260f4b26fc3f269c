"""PLY I/O in pure numpy (the port's own copy of
gaus_slam_tpu/utils/ply.py): the gaussian map, and triangle meshes
(``write_mesh_ply`` / ``read_mesh_ply``, for the mesh evaluation).

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


def write_mesh_ply(path, verts, tris, colors=None):
    """Binary triangle-mesh PLY (the `final_mesh.ply` artifact the
    reference writes via o3d.io.write_triangle_mesh, utils/eval.py:466).
    colors: optional [N,3] float 0..1 vertex colors."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    verts = np.asarray(verts, "<f4")
    tris = np.asarray(tris, "<i4")
    n, m = len(verts), len(tris)
    props = ["property float x", "property float y", "property float z"]
    if colors is not None:
        props += [f"property uchar {c}" for c in ("red", "green", "blue")]
    header = "\n".join(
        ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        + props
        + [f"element face {m}",
           "property list uchar int vertex_indices", "end_header", ""]
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if colors is not None:
            c8 = np.clip(np.asarray(colors) * 255.0, 0, 255).astype(np.uint8)
            vd = np.zeros(n, dtype=[("v", "<f4", 3), ("c", "u1", 3)])
            vd["v"], vd["c"] = verts, c8
            vd.tofile(f)
        else:
            verts.tofile(f)
        fd = np.zeros(m, dtype=[("k", "u1"), ("i", "<i4", 3)])
        fd["k"], fd["i"] = 3, tris
        fd.tofile(f)


def read_mesh_ply(path):
    """Read a triangle-mesh PLY (gt meshes like Replica's
    cull_replica_mesh/*.ply, consumed by the reference at
    utils/eval.py:470-472). Supports binary_little_endian and ascii,
    float/double vertex properties, uchar/int face index lists.
    Returns (verts [N,3] f32, tris [M,3] i32)."""
    _SZ = {"float": ("<f4", 4), "float32": ("<f4", 4),
           "double": ("<f8", 8), "float64": ("<f8", 8),
           "uchar": ("u1", 1), "uint8": ("u1", 1),
           "char": ("i1", 1), "int8": ("i1", 1),
           "short": ("<i2", 2), "ushort": ("<u2", 2),
           "int": ("<i4", 4), "int32": ("<i4", 4),
           "uint": ("<u4", 4), "uint32": ("<u4", 4)}
    with open(path, "rb") as f:
        fmt = None
        elements = []  # (name, count, [(prop_name, type) | ('list', ct, it)])
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                elements.append((tok[1], int(tok[2]), []))
            elif tok[0] == "property":
                if tok[1] == "list":
                    elements[-1][2].append(("list", tok[2], tok[3], tok[-1]))
                else:
                    elements[-1][2].append((tok[1], tok[-1]))
            elif tok[0] == "end_header":
                break
        verts = tris = None
        if fmt == "ascii":
            for name, count, props in elements:
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    idx = [i for i, p in enumerate(props)
                           if p[-1] in ("x", "y", "z")]
                    verts = np.array([[float(r[i]) for i in idx]
                                      for r in rows], np.float32)
                elif name == "face":
                    if any(int(r[0]) != 3 for r in rows):
                        raise ValueError(
                            "only triangular faces supported (found a "
                            "face with vertex count != 3)")
                    tris = np.array([[int(v) for v in r[1:4]] for r in rows],
                                    np.int32)
        else:
            if not fmt.startswith("binary_little"):
                raise ValueError(f"unsupported ply format {fmt}")
            for name, count, props in elements:
                if name == "vertex":
                    dt = np.dtype([(p[-1], _SZ[p[0]][0]) for p in props])
                    data = np.fromfile(f, dtype=dt, count=count)
                    verts = np.stack([data[c].astype(np.float32)
                                      for c in ("x", "y", "z")], 1)
                elif name == "face" and props[0][0] == "list":
                    ct, it = _SZ[props[0][1]], _SZ[props[0][2]]
                    raw = f.read(count * (ct[1] + 3 * it[1]))
                    dt = np.dtype([("k", ct[0]), ("i", it[0], 3)])
                    n_got = len(raw) // dt.itemsize
                    data = np.frombuffer(raw, dtype=dt, count=n_got)
                    # the fixed stride assumes triangles; a quad/mixed
                    # mesh would silently shift the stream — fail loudly
                    if n_got != count or not (data["k"] == 3).all():
                        raise ValueError(
                            "only triangular faces supported (face list "
                            "with vertex count != 3 in binary ply)")
                    tris = data["i"].astype(np.int32)
                else:  # skip unknown fixed-size element
                    row = sum(_SZ[p[0]][1] for p in props if p[0] != "list")
                    f.seek(count * row, 1)
    return verts, tris


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
