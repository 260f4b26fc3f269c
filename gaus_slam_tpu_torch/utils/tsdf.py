"""Python wrapper over the native TSDF fusion library (port of
gaus_slam_tpu/utils/tsdf.py, over the port's own copy of the source in
native/)."""
from __future__ import annotations

import ctypes

import numpy as np


class TSDFVolume:
    """Scalable TSDF volume (native C++). Replaces Open3D's
    ScalableTSDFVolume in the reference mesh-eval pipeline
    (utils/eval.py:337-399)."""

    def __init__(self, voxel_size: float = 0.01, sdf_trunc: float | None = None):
        from ..native import load_tsdf_lib

        self._lib = load_tsdf_lib()
        self.voxel_size = voxel_size
        self.sdf_trunc = sdf_trunc if sdf_trunc is not None else 4 * voxel_size
        self._h = self._lib.tsdf_create(
            ctypes.c_float(voxel_size), ctypes.c_float(self.sdf_trunc)
        )

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tsdf_destroy(self._h)
            self._h = None

    @property
    def num_blocks(self) -> int:
        return int(self._lib.tsdf_num_blocks(self._h))

    def integrate(self, color, depth, intrinsics, c2w, depth_trunc=8.0):
        """color [H,W,3] 0..1; depth [H,W] meters; intrinsics 3x3/4x4;
        c2w 4x4."""
        depth = np.ascontiguousarray(depth, np.float32)
        color = np.ascontiguousarray(color, np.float32)
        h, w = depth.shape
        k = np.asarray(intrinsics, np.float32)
        intr = np.array([k[0, 0], k[1, 1], k[0, 2], k[1, 2]], np.float32)
        c2w = np.ascontiguousarray(c2w, np.float32)
        f32p = ctypes.POINTER(ctypes.c_float)
        self._lib.tsdf_integrate(
            self._h,
            depth.ctypes.data_as(f32p), color.ctypes.data_as(f32p),
            h, w, intr.ctypes.data_as(f32p), c2w.ctypes.data_as(f32p),
            ctypes.c_float(depth_trunc),
        )

    def extract_mesh(self, min_weight: float = 1.0):
        """-> (vertices [V,3], colors [V,3], triangles [T,3]).

        The native marching-tetrahedra pass emits per-tet triangles with
        duplicated vertices; shared edges are welded here (quantized to
        voxel_size/1024) so the mesh has real connectivity — required by
        clean_mesh's connected-components filter and by downstream
        viewers."""
        m = self._lib.tsdf_extract_mesh(self._h, ctypes.c_float(min_weight))
        nv = int(self._lib.mesh_num_vertices(m))
        nt = int(self._lib.mesh_num_triangles(m))
        verts = np.empty((nv, 6), np.float32)
        tris = np.empty((nt, 3), np.int32)
        if nv:
            self._lib.mesh_copy(
                m,
                verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
        self._lib.mesh_destroy(m)
        if not nv:
            return verts[:, :3], verts[:, 3:], tris
        q = np.round(verts[:, :3] / (self.voxel_size / 1024.0)).astype(
            np.int64)
        _, first, inv = np.unique(q, axis=0, return_index=True,
                                  return_inverse=True)
        welded = verts[first]
        new_tris = inv[tris].astype(np.int32)
        nondeg = ((new_tris[:, 0] != new_tris[:, 1])
                  & (new_tris[:, 1] != new_tris[:, 2])
                  & (new_tris[:, 0] != new_tris[:, 2]))
        return welded[:, :3], welded[:, 3:], new_tris[nondeg]
