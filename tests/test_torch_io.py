"""The port's file I/O against the JAX package's: PNG, YAML profiles and
every dataset loader.

  * PNG: ``utils.png.read_png`` equals ``imageio.imread`` bit for bit on
    8-bit gray / RGB / RGBA and 16-bit gray files written by imageio and
    by cv2 (hypothesis over shapes), and on rows written with each of the
    five filter types; ``write_png`` round-trips bit for bit.
  * YAML: ``utils.yaml_lite`` equals ``yaml.full_load`` on every profile
    under configs/data/ and on tests/test_loaders.py's camera profile;
    what it does not read raises ValueError with the line number.
  * Loaders: on small directory trees of every layout of
    ``DATASET_REGISTRY`` (numpy-seeded images and poses), the port's
    color, depth, K and c2w are bit-equal to the JAX loader's, with cv2,
    with cv2 set to None in both modules (the nearest-resize branch), and
    with neither cv2 nor imageio in the port (its PNG reader), at the
    files' size and at a size that forces the resize.

The JAX TUM loader parses its lists with ``np.unicode_``, which NumPy 2
removed; the tests put the alias back for it (the port uses ``np.str_``).
"""
import json
import os
import struct
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from gaus_slam_tpu_torch.utils import png, yaml_lite

REPO = os.path.join(os.path.dirname(__file__), "..")
H0, W0 = 24, 32


# ---------------------------------------------------------------------------
# PNG


def _rand_image(rng, h, w, kind):
    if kind == "gray16":
        return rng.integers(0, 65536, (h, w)).astype(np.uint16)
    ch = {"gray8": None, "rgb": 3, "rgba": 4}[kind]
    shape = (h, w) if ch is None else (h, w, ch)
    # half noise, half a smooth ramp, so encoders pick several filters
    ramp = (np.arange(h)[:, None] * 3 + np.arange(w)[None] * 5) % 256
    img = rng.integers(0, 256, shape).astype(np.uint8)
    img[: h // 2] = (ramp[: h // 2] if ch is None
                     else ramp[: h // 2, :, None]).astype(np.uint8)
    return img


@settings(max_examples=25, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40),
       kind=st.sampled_from(["gray8", "gray16", "rgb", "rgba"]),
       seed=st.integers(0, 2**16))
def test_png_reader_matches_imageio(tmp_path_factory, h, w, kind, seed):
    import cv2
    import imageio.v2 as imageio

    d = tmp_path_factory.mktemp("png")
    img = _rand_image(np.random.default_rng(seed), h, w, kind)
    paths = [str(d / "imageio.png"), str(d / "cv2.png")]
    imageio.imwrite(paths[0], img)
    bgr = img if img.ndim == 2 else cv2.cvtColor(
        img, cv2.COLOR_RGB2BGR if img.shape[2] == 3 else cv2.COLOR_RGBA2BGRA)
    assert cv2.imwrite(paths[1], bgr)
    for p in paths:
        want = np.asarray(imageio.imread(p))
        got = png.read_png(p)
        assert got.dtype == want.dtype and got.shape == want.shape, p
        np.testing.assert_array_equal(got, want)
    png.write_png(str(d / "own.png"), img)
    np.testing.assert_array_equal(png.read_png(str(d / "own.png")), img)
    np.testing.assert_array_equal(imageio.imread(str(d / "own.png")), img)


def _filtered_png(path, img, ftype):
    """A PNG of 8-bit RGB ``img`` with every row encoded by filter
    ``ftype`` (0 none, 1 sub, 2 up, 3 average, 4 paeth), written here from
    the PNG specification."""
    h, w, _ = img.shape
    bpp, rows = 3, img.reshape(h, -1).astype(np.int64)
    out = []
    for y in range(h):
        cur = rows[y]
        prev = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        out.append(bytes([ftype]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(b"".join(out))))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_reader_every_filter_type(tmp_path, ftype):
    import imageio.v2 as imageio

    img = _rand_image(np.random.default_rng(ftype), 13, 17, "rgb")
    path = str(tmp_path / f"f{ftype}.png")
    _filtered_png(path, img, ftype)
    np.testing.assert_array_equal(imageio.imread(path), img)
    np.testing.assert_array_equal(png.read_png(path), img)


def test_png_refuses_what_it_does_not_read(tmp_path):
    import cv2

    path = str(tmp_path / "rgb16.png")
    assert cv2.imwrite(path, np.zeros((4, 4, 3), np.uint16))
    with pytest.raises(ValueError, match="rgb16.png"):
        png.read_png(path)
    with pytest.raises(ValueError):
        png.write_png(str(tmp_path / "x.png"), np.zeros((4, 4), np.float32))


# ---------------------------------------------------------------------------
# YAML


def _profiles():
    root = os.path.join(REPO, "configs", "data")
    return sorted(os.path.relpath(os.path.join(d, f), REPO)
                  for d, _, fs in os.walk(root) for f in fs
                  if f.endswith(".yaml"))


CAM_YAML = ("dataset_name: test\ncamera_params:\n"
            "  image_height: 24\n  image_width: 32\n"
            "  fx: 30.0\n  fy: 30.0\n  cx: 16.0\n  cy: 12.0\n"
            "  png_depth_scale: 1000.0\n")


@pytest.mark.parametrize("path", _profiles())
def test_yaml_lite_matches_pyyaml_on_profiles(path):
    import yaml

    with open(os.path.join(REPO, path)) as f:
        text = f.read()
    assert yaml_lite.loads(text) == yaml.full_load(text)


def test_yaml_lite_matches_pyyaml_on_scalars():
    import yaml

    text = CAM_YAML + (
        "flags:\n  a: yes\n  b: Off\n  c: ~\n  d: null\n  e:\n"
        "  f: 1e-4\n  g: 1.0e-4\n  h: -3\n  i: +0.5\n  j: .inf\n"
        "  k: 'quoted # not a comment'\n  l: \"q\"\n  m: [1, -2.5, x y, ~]\n"
        "  n: []\n  o: plain words  # a comment\n  p: 1_000\n")
    assert yaml_lite.loads(text) == yaml.full_load(text)
    assert yaml_lite.loads("# only a comment\n") is None
    assert yaml.full_load("# only a comment\n") is None


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb:\n  - 1\n", 3), ("a: &x 1\n", 1), ("a: 0x1f\n", 1),
    ("a: 2020-01-01\n", 1), ("a: 1\n   b: 2\n", 2), ("a: [1, [2]]\n", 1),
    ("a: 1\na: 2\n", 2), ("a: |\n  text\n", 1), ("just text\n", 1)])
def test_yaml_lite_refuses_with_line_number(text, line):
    with pytest.raises(ValueError, match=f"line {line}"):
        yaml_lite.loads(text)


# ---------------------------------------------------------------------------
# loaders


def _imwrite(path, arr):
    import cv2

    if arr.ndim == 3:
        arr = cv2.cvtColor(arr, cv2.COLOR_RGB2BGR)
    assert cv2.imwrite(path, arr)


def _rgbd(rng, i):
    c = rng.uniform(0, 255, (H0, W0, 3)).astype(np.uint8)
    d = (1000 + 37 * i + rng.integers(0, 500, (H0, W0))).astype(np.uint16)
    d[0, :3] = 0  # holes
    return c, d


def _pose(rng):
    """A c2w with a random rotation and translation."""
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    m = np.eye(4)
    m[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)],
                 [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)],
                 [2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)]]
    m[:3, 3] = rng.uniform(-2, 2, 3)
    return m


def _write_frames(rng, n, color_path, depth_path):
    for i in range(n):
        c, d = _rgbd(rng, i)
        _imwrite(color_path(i), c)
        _imwrite(depth_path(i), d)


def _mk(*parts):
    p = os.path.join(*parts)
    os.makedirs(p, exist_ok=True)
    return p


def _tree(root, name, n=12):
    """Write a ``name`` sequence "seq" of n frames under ``root``."""
    rng = np.random.default_rng(sum(map(ord, name)))
    seq = os.path.join(root, "seq")
    poses = [_pose(rng) for _ in range(n)]
    if name == "replica":
        res = _mk(seq, "results")
        _write_frames(rng, n, lambda i: f"{res}/frame{i:06d}.jpg",
                      lambda i: f"{res}/depth{i:06d}.png")
        np.savetxt(f"{seq}/traj.txt", [p.ravel() for p in poses])
    elif name == "replicav2":
        d = _mk(seq, "imap", "00")
        _mk(d, "rgb"), _mk(d, "depth")
        _write_frames(rng, n, lambda i: f"{d}/rgb/rgb_{i:04d}.png",
                      lambda i: f"{d}/depth/depth_{i:04d}.png")
        np.savetxt(f"{d}/traj_w_c.txt", [p.ravel() for p in poses])
    elif name == "tum":
        _mk(seq, "rgb"), _mk(seq, "depth")
        t0 = 1305031102.175304
        hdr = "# a\n# b\n# c\n"
        rgb, dep, gt = [hdr], [hdr], [hdr]
        for i in range(n):
            t = t0 + 0.0333 * i
            rgb.append(f"{t:.6f} rgb/{t:.6f}.png\n")
            dep.append(f"{t + 0.004:.6f} depth/{t + 0.004:.6f}.png\n")
            c, d = _rgbd(rng, i)
            _imwrite(f"{seq}/rgb/{t:.6f}.png", c)
            _imwrite(f"{seq}/depth/{t + 0.004:.6f}.png", d)
        for i in range(2 * n + 4):  # denser than the images, as in TUM
            t = t0 - 0.02 + 0.0170 * i
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            tr = rng.uniform(-1, 1, 3)
            gt.append(f"{t:.4f} " + " ".join(f"{v:.4f}" for v in (*tr, *q))
                      + "\n")
        for fname, lines in (("rgb.txt", rgb), ("depth.txt", dep),
                             ("groundtruth.txt", gt)):
            with open(f"{seq}/{fname}", "w") as f:
                f.writelines(lines)
    elif name in ("scannet", "azure", "azurekinect"):
        for sub in ("color", "depth", "pose"):
            _mk(seq, sub)
        _write_frames(rng, n, lambda i: f"{seq}/color/{i}.jpg",
                      lambda i: f"{seq}/depth/{i}.png")
        for i, p in enumerate(poses):
            np.savetxt(f"{seq}/pose/{i}.txt", p)
    elif name in ("scannetpp", "nerfcapture"):
        ns = _mk(seq, "dslr", "nerfstudio")
        im = _mk(seq, "dslr", "undistorted_images")
        dp = _mk(seq, "dslr", "undistorted_depths")
        _write_frames(rng, n, lambda i: f"{im}/DSC{i:05d}.JPG",
                      lambda i: f"{dp}/DSC{i:05d}.png")
        frames = [{"file_path": f"images/DSC{i:05d}.JPG",
                   "transform_matrix": p.tolist(), "is_bad": i == 3}
                  for i, p in enumerate(poses)]
        meta = {"fl_x": 28.0, "fl_y": 29.0, "cx": 15.5, "cy": 11.5,
                "h": H0, "w": W0, "frames": frames[::-1][:n - 2],
                "test_frames": frames[n - 2:]}
        with open(f"{ns}/transforms_undistorted.json", "w") as f:
            json.dump(meta, f)
    elif name == "icl":
        _mk(seq, "rgb"), _mk(seq, "depth")
        _write_frames(rng, n, lambda i: f"{seq}/rgb/{i}.png",
                      lambda i: f"{seq}/depth/{i}.png")
        rows = [[i, *rng.uniform(-1, 1, 3), *(q / np.linalg.norm(q))]
                for i, q in enumerate(rng.normal(size=(n, 4)))]
        np.savetxt(f"{seq}/livingRoom0.gt.freiburg", rows)
    elif name in ("record3d", "realsense"):
        for sub in ("rgb", "depth", "poses"):
            _mk(seq, sub)
        ext = "png" if name == "record3d" else "jpg"
        _write_frames(rng, n, lambda i: f"{seq}/rgb/{i}.{ext}",
                      lambda i: f"{seq}/depth/{i}.png")
        for i, p in enumerate(poses):
            np.save(f"{seq}/poses/{i}.npy", p)
    elif name == "ai2thor":
        for sub in ("color", "depth", "pose"):
            _mk(seq, sub)
        _write_frames(rng, n, lambda i: f"{seq}/color/{i}.png",
                      lambda i: f"{seq}/depth/{i}.png")
        for i, p in enumerate(poses):
            np.savetxt(f"{seq}/pose/{i}.txt", p)
    else:
        raise KeyError(name)
    # crop and undistortion are exercised by the TUM profile
    prof = CAM_YAML
    if name == "tum":
        prof = prof.replace("png_depth_scale: 1000.0",
                            "png_depth_scale: 5000.0\n  crop_edge: 2\n"
                            "  distortion: [0.2624, -0.9531, -0.0054, "
                            "0.0026, 1.1633]")
    with open(os.path.join(root, "cam.yaml"), "w") as f:
        f.write(prof)
    return os.path.join(root, "cam.yaml")


def _registry():
    from gaus_slam_tpu_torch.data.basedataset import DATASET_REGISTRY

    return sorted(DATASET_REGISTRY)


JPEG = {"replica", "scannet", "azure", "azurekinect", "scannetpp",
        "nerfcapture", "realsense"}


def _data_cfg(root, name, cam, h, w, **kw):
    return dict(dataset_name=name, basedir=str(root), sequence="seq",
                gradslam_data_cfg=cam, desired_image_height=h,
                desired_image_width=w, **kw)


def _loaders(monkeypatch, mode):
    """(JAX get_dataset, port get_dataset) with the image libraries of
    ``mode``: "cv2" as installed, "imageio" without cv2 in either
    package, "png" without cv2 in either and without imageio in the
    port."""
    from gaus_slam_tpu.data import basedataset as JB
    from gaus_slam_tpu.data import get_dataset as j_get
    from gaus_slam_tpu_torch.data import basedataset as TB
    from gaus_slam_tpu_torch.data import get_dataset as t_get

    monkeypatch.setattr(np, "unicode_", np.str_, raising=False)
    if mode in ("imageio", "png"):
        monkeypatch.setattr(JB, "cv2", None)
        monkeypatch.setattr(TB, "cv2", None)
    if mode == "png":
        monkeypatch.setattr(TB, "imageio", None)
    return j_get, t_get


def _assert_same(jds, tds):
    assert len(tds) == len(jds) > 0
    for i in range(len(jds)):
        for a, b in zip(jds[i], tds[i]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", [(H0, W0), (18, 26)], ids=["native",
                                                            "resized"])
@pytest.mark.parametrize("mode", ["cv2", "imageio", "png"])
@pytest.mark.parametrize("name", _registry())
def test_loader_bit_equal_to_jax(tmp_path, monkeypatch, name, mode, size):
    cam = _tree(str(tmp_path), name)
    j_get, t_get = _loaders(monkeypatch, mode)
    cfg = _data_cfg(tmp_path, name, cam, *size, start=1, end=-1, stride=2)
    tds = t_get(cfg)
    if mode == "png" and name in JPEG:
        with pytest.raises(RuntimeError, match=r"\.(jpg|JPG)"):
            tds[0]
        return
    _assert_same(j_get(cfg), tds)


def test_profile_inherit_from(tmp_path, monkeypatch):
    """``inherit_from`` resolves as in the JAX package (paths from the
    working directory)."""
    from gaus_slam_tpu.data.basedataset import load_dataset_config as j_load
    from gaus_slam_tpu_torch.data.basedataset import (
        load_dataset_config as t_load)

    monkeypatch.chdir(REPO)
    for prof in ("configs/data/tum_fr2.yaml", "configs/data/tum_fr3.yaml",
                 "configs/data/TUM/freiburg1_desk.yaml"):
        assert t_load(prof) == j_load(prof)


def test_get_dataset_unknown_name():
    from gaus_slam_tpu_torch.data import get_dataset

    with pytest.raises(ValueError, match="Unknown dataset"):
        get_dataset({"dataset_name": "kitti", "basedir": "", "sequence": ""})
