"""RGB-D dataset loaders (port of gaus_slam_tpu/data/basedataset.py;
reference datasets/gradslam_datasets).

Numpy on the host, as in the JAX package. Each dataset yields
``(color [H,W,3] float 0..255, depth [H,W,1] meters, intrinsics 4x4,
c2w pose 4x4)`` with poses normalized relative to the first frame
(basedataset.py:296-341), images resized to the desired shape (bilinear
color / nearest depth) and intrinsics rescaled accordingly.

Per-dataset camera parameters come from the YAML profiles in
configs/data/*.yaml with `inherit_from` support (dataconfig.py:5-54),
read by utils/yaml_lite.py. Images are read with cv2 where it is
installed, else imageio, else utils/png.py (PNG only: a JPEG then raises
``RuntimeError`` naming the file).
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

try:
    import imageio.v2 as imageio
except Exception:  # pragma: no cover
    imageio = None

from ..utils import png, yaml_lite


def _imread(path: str) -> np.ndarray:
    """imageio's read where it is installed, else the PNG reader."""
    if imageio is not None:
        return np.asarray(imageio.imread(path))
    if not path.lower().endswith(".png"):
        raise RuntimeError(f"{path}: neither cv2 nor imageio is installed, "
                           f"and without them only PNG files are read")
    return png.read_png(path)


def load_dataset_config(path: str, default_path: str | None = None) -> dict:
    cfg_special = yaml_lite.load(path)
    inherit = cfg_special.get("inherit_from")
    if inherit is not None:
        cfg = load_dataset_config(inherit, default_path)
    elif default_path is not None:
        cfg = yaml_lite.load(default_path)
    else:
        cfg = {}

    def _update(d, u):
        for k, v in u.items():
            if isinstance(v, dict):
                d[k] = _update(d.get(k, {}), v)
            else:
                d[k] = v
        return d

    return _update(cfg, cfg_special)


class RGBDDataset:
    """Base loader. Subclasses implement get_filepaths() and
    load_poses()."""

    def __init__(self, config_path, basedir, sequence, start=0, end=-1,
                 stride=1, desired_height=480, desired_width=640,
                 relative_pose=True, **kwargs):
        cfg = load_dataset_config(config_path) if config_path else {}
        camp = cfg.get("camera_params", {})
        self.orig_height = camp.get("image_height", desired_height)
        self.orig_width = camp.get("image_width", desired_width)
        self.fx = camp.get("fx", desired_width)
        self.fy = camp.get("fy", desired_width)
        self.cx = camp.get("cx", self.orig_width / 2.0)
        self.cy = camp.get("cy", self.orig_height / 2.0)
        self.png_depth_scale = camp.get("png_depth_scale", 1000.0)
        self.distortion = np.asarray(camp["distortion"], np.float32) \
            if camp.get("distortion") else None
        self.crop_edge = camp.get("crop_edge", 0) or 0

        self.basedir = basedir
        self.sequence = sequence
        self.desired_height = desired_height
        self.desired_width = desired_width
        self.relative_pose = relative_pose

        self.color_paths, self.depth_paths = self.get_filepaths()
        self.poses = self.load_poses()
        n = len(self.color_paths)
        if end == -1:
            end = n
        sl = slice(start, end, stride)
        self.color_paths = self.color_paths[sl]
        self.depth_paths = self.depth_paths[sl]
        self.poses = self.poses[sl]
        if self.relative_pose and len(self.poses):
            p0_inv = np.linalg.inv(self.poses[0])
            self.poses = [p0_inv @ p for p in self.poses]

        h_eff = self.orig_height - 2 * self.crop_edge
        w_eff = self.orig_width - 2 * self.crop_edge
        self.h_ratio = desired_height / h_eff
        self.w_ratio = desired_width / w_eff

    # -- subclass API --------------------------------------------------
    def get_filepaths(self):
        raise NotImplementedError

    def load_poses(self):
        raise NotImplementedError

    # ------------------------------------------------------------------
    def __len__(self):
        return len(self.color_paths)

    @property
    def intrinsics(self) -> np.ndarray:
        k = np.eye(4, dtype=np.float32)
        k[0, 0] = self.fx * self.w_ratio
        k[1, 1] = self.fy * self.h_ratio
        k[0, 2] = (self.cx - self.crop_edge) * self.w_ratio
        k[1, 2] = (self.cy - self.crop_edge) * self.h_ratio
        return k

    def _read_color(self, path) -> np.ndarray:
        if cv2 is not None:
            img = cv2.imread(path)
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        else:
            img = _imread(path)[..., :3]
        if self.distortion is not None and cv2 is not None:
            k = np.eye(3)
            k[0, 0], k[1, 1], k[0, 2], k[1, 2] = (self.fx, self.fy,
                                                  self.cx, self.cy)
            img = cv2.undistort(img, k, self.distortion)
        return img

    def _read_depth(self, path) -> np.ndarray:
        if path.endswith(".npy"):
            d = np.load(path)
        elif cv2 is not None:
            d = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        else:
            d = _imread(path)
        return d.astype(np.float32) / self.png_depth_scale

    def _resize(self, color, depth):
        if self.crop_edge:
            e = self.crop_edge
            color = color[e:-e, e:-e]
            depth = depth[e:-e, e:-e]
        hw = (self.desired_width, self.desired_height)
        if color.shape[:2] != (self.desired_height, self.desired_width):
            if cv2 is not None:
                color = cv2.resize(color, hw, interpolation=cv2.INTER_LINEAR)
                depth = cv2.resize(depth, hw, interpolation=cv2.INTER_NEAREST)
            else:  # nearest fallback
                ys = (np.linspace(0, color.shape[0] - 1,
                                  self.desired_height)).astype(int)
                xs = (np.linspace(0, color.shape[1] - 1,
                                  self.desired_width)).astype(int)
                color = color[ys][:, xs]
                depth = depth[ys][:, xs]
        return color, depth

    def __getitem__(self, idx):
        color = self._read_color(self.color_paths[idx]).astype(np.float32)
        depth = self._read_depth(self.depth_paths[idx])
        color, depth = self._resize(color, depth)
        return (
            color,
            depth[..., None].astype(np.float32),
            self.intrinsics,
            self.poses[idx].astype(np.float32),
        )


class ReplicaDataset(RGBDDataset):
    """Replica (iMAP/NICE-SLAM capture): results/frame*.jpg + depth*.png,
    poses in traj.txt as flattened 4x4 c2w per line."""

    def get_filepaths(self):
        d = os.path.join(self.basedir, self.sequence)
        colors = sorted(glob.glob(os.path.join(d, "results", "frame*.jpg")))
        depths = sorted(glob.glob(os.path.join(d, "results", "depth*.png")))
        return colors, depths

    def load_poses(self):
        d = os.path.join(self.basedir, self.sequence)
        lines = open(os.path.join(d, "traj.txt")).read().strip().splitlines()
        return [np.array(list(map(float, ln.split()))).reshape(4, 4)
                for ln in lines]


class ReplicaV2Dataset(ReplicaDataset):
    """ReplicaV2 (vMAP capture layout)."""

    def get_filepaths(self):
        d = os.path.join(self.basedir, self.sequence, "imap", "00")
        colors = sorted(glob.glob(os.path.join(d, "rgb", "rgb_*.png")))
        depths = sorted(glob.glob(os.path.join(d, "depth", "depth_*.png")))
        return colors, depths

    def load_poses(self):
        d = os.path.join(self.basedir, self.sequence, "imap", "00")
        lines = open(os.path.join(d, "traj_w_c.txt")).read().strip().splitlines()
        return [np.array(list(map(float, ln.split()))).reshape(4, 4)
                for ln in lines]


class TUMDataset(RGBDDataset):
    """TUM RGB-D: nearest-timestamp association of rgb.txt / depth.txt /
    groundtruth.txt (tum.py:44-76)."""

    @staticmethod
    def _parse_list(path, skiprows=0):
        return np.loadtxt(path, delimiter=" ", dtype=np.str_,
                          skiprows=skiprows)

    @staticmethod
    def _associate(tstamp_image, tstamp_depth, tstamp_pose, max_dt=0.08):
        assoc = []
        for i, t in enumerate(tstamp_image):
            j = np.argmin(np.abs(tstamp_depth - t))
            if tstamp_pose is None:
                if abs(tstamp_depth[j] - t) < max_dt:
                    assoc.append((i, j))
            else:
                k = np.argmin(np.abs(tstamp_pose - t))
                if (abs(tstamp_depth[j] - t) < max_dt
                        and abs(tstamp_pose[k] - t) < max_dt):
                    assoc.append((i, j, k))
        return assoc

    @staticmethod
    def _pose_matrix_from_quaternion(vec):
        # vec: tx ty tz qx qy qz qw
        t = vec[:3]
        qx, qy, qz, qw = vec[3:]
        # rotation from quaternion (x,y,z,w)
        R = np.array([
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
             2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
             2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
             1 - 2 * (qx * qx + qy * qy)],
        ])
        m = np.eye(4)
        m[:3, :3] = R
        m[:3, 3] = t
        return m

    def _load_all(self):
        d = os.path.join(self.basedir, self.sequence)
        img_list = self._parse_list(os.path.join(d, "rgb.txt"), skiprows=3)
        depth_list = self._parse_list(os.path.join(d, "depth.txt"), skiprows=3)
        pose_list = self._parse_list(os.path.join(d, "groundtruth.txt"),
                                     skiprows=3)
        t_img = img_list[:, 0].astype(np.float64)
        t_dep = depth_list[:, 0].astype(np.float64)
        t_pose = pose_list[:, 0].astype(np.float64)
        assoc = self._associate(t_img, t_dep, t_pose)
        colors, depths, poses = [], [], []
        for i, j, k in assoc:
            colors.append(os.path.join(d, img_list[i, 1]))
            depths.append(os.path.join(d, depth_list[j, 1]))
            poses.append(self._pose_matrix_from_quaternion(
                pose_list[k, 1:].astype(np.float64)))
        return colors, depths, poses

    def get_filepaths(self):
        if not hasattr(self, "_cache"):
            self._cache = self._load_all()
        return self._cache[0], self._cache[1]

    def load_poses(self):
        if not hasattr(self, "_cache"):
            self._cache = self._load_all()
        return self._cache[2]


class ScannetDataset(RGBDDataset):
    """ScanNet (exported): color/%d.jpg depth/%d.png pose/%d.txt."""

    def get_filepaths(self):
        d = os.path.join(self.basedir, self.sequence)
        colors = sorted(glob.glob(os.path.join(d, "color", "*.jpg")),
                        key=lambda p: int(os.path.basename(p).split(".")[0]))
        depths = sorted(glob.glob(os.path.join(d, "depth", "*.png")),
                        key=lambda p: int(os.path.basename(p).split(".")[0]))
        return colors, depths

    def load_poses(self):
        d = os.path.join(self.basedir, self.sequence)
        pose_files = sorted(glob.glob(os.path.join(d, "pose", "*.txt")),
                            key=lambda p: int(os.path.basename(p).split(".")[0]))
        return [np.loadtxt(p).reshape(4, 4) for p in pose_files]


class ScannetPPDataset(RGBDDataset):
    """ScanNet++ DSLR capture via the NeRFStudio transforms json
    (scannetpp.py:18-141). Supports the NVS test split + bad-frame
    skipping."""

    def __init__(self, *args, split="train", ignore_bad=True, **kwargs):
        self.split = split
        self.ignore_bad = ignore_bad
        super().__init__(*args, relative_pose=False, **kwargs)

    def _load_meta(self):
        d = os.path.join(self.basedir, self.sequence)
        meta_path = os.path.join(d, "dslr", "nerfstudio",
                                 "transforms_undistorted.json")
        if not os.path.exists(meta_path):
            meta_path = os.path.join(d, "dslr", "nerfstudio",
                                     "transforms.json")
        meta = json.load(open(meta_path))
        self.fx = meta.get("fl_x", self.fx)
        self.fy = meta.get("fl_y", self.fy)
        self.cx = meta.get("cx", self.cx)
        self.cy = meta.get("cy", self.cy)
        self.orig_height = meta.get("h", self.orig_height)
        self.orig_width = meta.get("w", self.orig_width)
        frames = meta["frames"] if self.split == "train" \
            else meta.get("test_frames", [])
        if self.ignore_bad:
            frames = [f for f in frames if not f.get("is_bad", False)]
        frames = sorted(frames, key=lambda f: f["file_path"])
        colors, depths, poses = [], [], []
        gl2cv = np.diag([1.0, -1.0, -1.0, 1.0])
        for f in frames:
            name = os.path.basename(f["file_path"])
            colors.append(os.path.join(
                d, "dslr", "undistorted_images", name))
            depths.append(os.path.join(
                d, "dslr", "undistorted_depths",
                name.replace(".JPG", ".png").replace(".jpg", ".png")))
            c2w = np.asarray(f["transform_matrix"], np.float64) @ gl2cv
            poses.append(c2w)
        return colors, depths, poses

    def get_filepaths(self):
        if not hasattr(self, "_cache"):
            self._cache = self._load_meta()
        return self._cache[0], self._cache[1]

    def load_poses(self):
        if not hasattr(self, "_cache"):
            self._cache = self._load_meta()
        return self._cache[2]


class ICLDataset(RGBDDataset):
    """ICL-NUIM (TUM-format poses in livingRoomN.gt.freiburg)."""

    def get_filepaths(self):
        d = os.path.join(self.basedir, self.sequence)
        colors = sorted(glob.glob(os.path.join(d, "rgb", "*.png")),
                        key=lambda p: int(os.path.basename(p).split(".")[0]))
        depths = sorted(glob.glob(os.path.join(d, "depth", "*.png")),
                        key=lambda p: int(os.path.basename(p).split(".")[0]))
        return colors, depths

    def load_poses(self):
        d = os.path.join(self.basedir, self.sequence)
        gt = glob.glob(os.path.join(d, "*.gt.freiburg"))
        lines = np.loadtxt(gt[0])
        return [TUMDataset._pose_matrix_from_quaternion(row[1:8])
                for row in lines]


class AzureKinectDataset(ScannetDataset):
    """Azure Kinect exports share the ScanNet directory layout."""


class NeRFCaptureDataset(ScannetPPDataset):
    """NeRFCapture app exports (NeRFStudio transforms.json layout)."""


def _natkey(p):
    """Natural sort key (the reference loaders use natsort.natsorted)."""
    import re

    return [int(t) if t.isdigit() else t
            for t in re.split(r"(\d+)", os.path.basename(p))]


_P_FLIP = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float64)


class Record3DDataset(RGBDDataset):
    """Record3D capture (reference record3d.py:13-67): rgb/*.png +
    depth/*.png, per-frame c2w .npy poses conjugated by diag(1,-1,-1,1)
    (the ARKit->OpenCV axis flip)."""

    def get_filepaths(self):
        d = os.path.join(self.basedir, self.sequence)
        colors = sorted(glob.glob(os.path.join(d, "rgb", "*.png")),
                        key=_natkey)
        depths = sorted(glob.glob(os.path.join(d, "depth", "*.png")),
                        key=_natkey)
        return colors, depths

    def load_poses(self):
        d = os.path.join(self.basedir, self.sequence, "poses")
        files = sorted(glob.glob(os.path.join(d, "*.npy")), key=_natkey)
        return [_P_FLIP @ np.load(f) @ _P_FLIP.T for f in files]


class RealsenseDataset(Record3DDataset):
    """Realsense tabletop capture (reference realsense.py:13-70): same
    pose convention as Record3D, rgb stored as jpg."""

    def get_filepaths(self):
        d = os.path.join(self.basedir, self.sequence)
        colors = sorted(glob.glob(os.path.join(d, "rgb", "*.jpg")),
                        key=_natkey)
        depths = sorted(glob.glob(os.path.join(d, "depth", "*.png")),
                        key=_natkey)
        return colors, depths


class Ai2thorDataset(RGBDDataset):
    """AI2-THOR export (reference ai2thor.py): color/*.png depth/*.png
    pose/*.txt."""

    def get_filepaths(self):
        d = os.path.join(self.basedir, self.sequence)
        colors = sorted(glob.glob(os.path.join(d, "color", "*.png")),
                        key=_natkey)
        depths = sorted(glob.glob(os.path.join(d, "depth", "*.png")),
                        key=_natkey)
        return colors, depths

    def load_poses(self):
        d = os.path.join(self.basedir, self.sequence)
        files = sorted(glob.glob(os.path.join(d, "pose", "*.txt")),
                       key=_natkey)
        return [np.loadtxt(f).reshape(4, 4) for f in files]


DATASET_REGISTRY = {
    "replica": ReplicaDataset,
    "replicav2": ReplicaV2Dataset,
    "tum": TUMDataset,
    "scannet": ScannetDataset,
    "scannetpp": ScannetPPDataset,
    "icl": ICLDataset,
    "azure": AzureKinectDataset,
    "azurekinect": AzureKinectDataset,
    "nerfcapture": NeRFCaptureDataset,
    "record3d": Record3DDataset,
    "realsense": RealsenseDataset,
    "ai2thor": Ai2thorDataset,
}
