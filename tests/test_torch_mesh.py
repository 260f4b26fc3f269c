"""The port's mesh evaluation and LPIPS against the JAX package's.

  * TSDF: the port's ``TSDFVolume`` (its own copy of
    native/tsdf_fusion.cpp, built into build/torch_native/) and the JAX
    package's give the same vertices, colors and triangles bit for bit:
    the plane of tests/test_native_tsdf.py and a seeded three-view
    integrate.
  * Mesh metrics: fscore, icp_align, calc_2d_metric, splat_depth,
    check_proj, clean_mesh, sample_mesh_points and load_gt_mesh_assets
    (meshdir and the gt-depth fallback) on seeded inputs: floats within
    1e-6 relative, integers and masks exact. Mesh PLY files (ASCII and
    binary, float and double) read the same in both packages.
  * evaluate_reconstruction on a 48x64 map carried over by convert.py
    (the JAX package in interpret mode; the port under "reference" and
    under "pallas"): F-score, precision and recall within 1e-3 absolute.
  * LPIPS: random weights in the export schema, 64x64 seeded images: the
    port within rtol 1e-5 of lpips_jax.load_lpips and of
    tests/test_lpips.py's torch reference.
"""
import os

import numpy as np
import pytest
import torch

from gaus_slam_tpu_torch import convert
from test_mesh_2d_metric import make_box_mesh

RTOL = 1e-6


def _pair(name):
    """(JAX function, port function) of utils.eval_mesh."""
    from gaus_slam_tpu.utils import eval_mesh as J
    from gaus_slam_tpu_torch.utils import eval_mesh as T

    return getattr(J, name), getattr(T, name)


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif a is None or isinstance(a, (bool, np.bool_)):
        assert a == b
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=0)


# ---------------------------------------------------------------------------
# TSDF


def _plane_frame(h=60, w=80, z=2.0, fx=60.0):
    depth = np.full((h, w), z, np.float32)
    color = np.full((h, w, 3), 0.5, np.float32)
    k = np.eye(3, dtype=np.float32)
    k[0, 0] = k[1, 1] = fx
    k[0, 2], k[1, 2] = w / 2, h / 2
    return color, depth, k


def _three_views(seed=0):
    rng = np.random.default_rng(seed)
    h, w = 48, 64
    k = np.eye(3, dtype=np.float32)
    k[0, 0] = k[1, 1] = 50.0
    k[0, 2], k[1, 2] = w / 2, h / 2
    views = []
    for i in range(3):
        depth = (1.5 + 0.3 * rng.random((h, w))).astype(np.float32)
        depth[rng.random((h, w)) < 0.05] = 0.0
        color = rng.random((h, w, 3)).astype(np.float32)
        c2w = np.eye(4)
        c2w[:3, 3] = [0.05 * i, -0.03 * i, 0.02 * i]
        views.append((color, depth, k, c2w))
    return views


@pytest.mark.parametrize("scene", ["plane", "three_views"])
def test_tsdf_mesh_bit_equal(scene):
    from gaus_slam_tpu.utils.tsdf import TSDFVolume as J
    from gaus_slam_tpu_torch.utils.tsdf import TSDFVolume as T

    if scene == "plane":
        color, depth, k = _plane_frame()
        views, voxel = [(color, depth, k, np.eye(4))] * 3, 0.05
    else:
        views, voxel = _three_views(), 0.02
    meshes = []
    for cls in (J, T):
        vol = cls(voxel_size=voxel)
        for color, depth, k, c2w in views:
            vol.integrate(color, depth, k, c2w)
        meshes.append((vol.num_blocks, *vol.extract_mesh(min_weight=1.0)))
    (jn, jv, jc, jt), (tn, tv, tc, tt) = meshes
    assert tn == jn > 0 and len(tv) > 100 and len(tt) > 100
    for a, b in ((jv, tv), (jc, tc), (jt, tt)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_native_builds_outside_the_package():
    from gaus_slam_tpu_torch import native

    lib = native.load_tsdf_lib()
    assert lib is native.load_tsdf_lib()
    built = list(native.BUILD_DIR.glob("libtsdf_fusion_*.so"))
    assert built and native.BUILD_DIR.parts[-2:] == ("build", "torch_native")
    pkg = os.path.dirname(native.__file__)
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]


# ---------------------------------------------------------------------------
# mesh metrics


def _cloud(seed, n=4000):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3))


def test_fscore_and_icp():
    pts = _cloud(0)
    shifted = pts + np.array([0.05, -0.01, 0.02])
    rot = _pair("icp_align")
    _same(rot[0](shifted, pts, iters=10, sample=3000, seed=3),
          rot[1](shifted, pts, iters=10, sample=3000, seed=3))
    j, t = _pair("fscore")
    for align in (False, True):
        for thr in (0.01, 0.05):
            _same(j(shifted, pts, threshold=thr, align=align),
                  t(shifted, pts, threshold=thr, align=align))
    _same(_pair("_nn_dists")[0](pts, shifted), _pair("_nn_dists")[1](
        pts, shifted))


def test_sample_splat_check_proj():
    v, f = make_box_mesh()
    js, ts = _pair("sample_mesh_points")
    pts = js(v, f, 50_000, seed=4)
    _same(pts, ts(v, f, 50_000, seed=4))
    w2c = np.eye(4)
    w2c[:3, 3] = [0.1, -0.2, 0.3]
    jd, td = _pair("splat_depth")
    _same(jd(pts, w2c, 60, 80, 50.0, 50.0, 39.5, 29.5),
          td(pts, w2c, 60, 80, 50.0, 50.0, 39.5, 29.5))
    jc, tc = _pair("check_proj")
    for p in (np.array([[0.0, 0.0, 1.0]]), np.array([[0.0, 0.0, -1.0]]),
              _cloud(5, 50) * 10):
        assert jc(p, 100, 100, 60, 60, 50, 50, np.eye(4)) == tc(
            p, 100, 100, 60, 60, 50, 50, np.eye(4))


def test_calc_2d_metric():
    gt = make_box_mesh(half=(2.0, 1.5, 2.0))
    rec = make_box_mesh(half=(1.8, 1.4, 1.9))
    j, t = _pair("calc_2d_metric")
    unseen = np.array([[100.0, 100.0, 100.0]])
    kw = dict(align=False, n_imgs=4, samples_per_mesh=60_000, seed=2)
    jm, tm = j(rec, gt, unseen_pc=unseen, **kw), t(rec, gt, unseen_pc=unseen,
                                                   **kw)
    assert jm["depth l1"] is not None
    _same(jm, tm)


def test_clean_mesh():
    g = 20
    yy, xx = np.mgrid[:g, :g].astype(np.float64)
    plane = np.stack([xx.ravel(), yy.ravel(), np.zeros(g * g)], 1)
    quads = (yy[:-1, :-1] * g + xx[:-1, :-1]).astype(np.int64).ravel()
    tris = np.concatenate([np.stack([quads, quads + 1, quads + g], 1),
                           np.stack([quads + 1, quads + g + 1, quads + g], 1)])
    bv, bf = make_box_mesh(half=(0.5, 0.5, 0.5), center=(100, 100, 100))
    verts = np.concatenate([plane, bv])
    tris = np.concatenate([tris, bf + len(plane), [[0, 0, 1]]])
    cols = np.random.default_rng(6).random((len(verts), 3))
    j, t = _pair("clean_mesh")
    _same(j(verts, cols, tris), t(verts, cols, tris))


def test_load_gt_mesh_assets_meshdir(tmp_path):
    from gaus_slam_tpu_torch.utils.ply import write_mesh_ply

    v, f = make_box_mesh()
    write_mesh_ply(str(tmp_path / "room0.ply"), v, f)
    np.save(tmp_path / "room0_pc_unseen.npy", _cloud(7, 10))
    config = {"data": {"meshdir": str(tmp_path), "sequence": "room0"}}
    j, t = _pair("load_gt_mesh_assets")
    got = t(config, n_gt_points=1000, seed=1)
    _same(j(config, n_gt_points=1000, seed=1), got)
    assert got[2].shape == (1000, 3)


class _RelDataset:
    """The synthetic sequence with poses relative to frame 0 (the frame
    of a map initialized from frame 0)."""

    def __init__(self, ds, n):
        self.ds, self.n = ds, n
        self.c2w0_inv = np.linalg.inv(ds[0][3])

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        c, d, k, c2w = self.ds[i]
        return c, d, k, (self.c2w0_inv @ c2w).astype(np.float32)


def test_load_gt_mesh_assets_fallback():
    from test_torch_backend import _dataset

    ds = _RelDataset(_dataset(), 12)
    j, t = _pair("load_gt_mesh_assets")
    got = t({"data": {"sequence": "box"}}, ds)
    _same(j({"data": {"sequence": "box"}}, ds), got)
    assert got[0] is None and got[1] is None and len(got[2]) > 1000
    with pytest.raises(FileNotFoundError):
        t({"data": {"meshdir": "/nonexistent", "sequence": "x"}})


@pytest.mark.parametrize("form", ["binary", "binary_colors", "ascii_double",
                                  "binary_double"])
def test_mesh_ply_parity(tmp_path, form):
    from gaus_slam_tpu.utils.ply import read_mesh_ply as j_read
    from gaus_slam_tpu.utils.ply import write_mesh_ply as j_write
    from gaus_slam_tpu_torch.utils.ply import read_mesh_ply as t_read
    from gaus_slam_tpu_torch.utils.ply import write_mesh_ply as t_write

    v, f = make_box_mesh()
    v = v + np.random.default_rng(8).normal(0, 1e-3, v.shape)
    path = str(tmp_path / "m.ply")
    if form.startswith("binary") and "double" not in form:
        cols = (np.linspace(0, 1, v.size).reshape(v.shape)
                if form == "binary_colors" else None)
        t_write(path, v, f, colors=cols)
        j_write(str(tmp_path / "j.ply"), v, f, colors=cols)
        with open(path, "rb") as a, open(tmp_path / "j.ply", "rb") as b:
            assert a.read() == b.read()
    else:
        ascii_ = form == "ascii_double"
        with open(path, "wb") as fh:
            hdr = ("ply\nformat " + ("ascii" if ascii_ else
                                     "binary_little_endian") + " 1.0\n"
                   f"element vertex {len(v)}\nproperty double x\n"
                   "property double y\nproperty double z\n"
                   f"element face {len(f)}\n"
                   "property list uchar int vertex_indices\nend_header\n")
            fh.write(hdr.encode())
            if ascii_:
                for row in v:
                    fh.write((" ".join(f"{x:.9f}" for x in row) + "\n")
                             .encode())
                for tri in f:
                    fh.write(("3 " + " ".join(map(str, tri)) + "\n").encode())
            else:
                v.astype("<f8").tofile(fh)
                fd = np.zeros(len(f), dtype=[("k", "u1"), ("i", "<i4", 3)])
                fd["k"], fd["i"] = 3, f
                fd.tofile(fh)
    (jv, jf), (tv, tf) = j_read(path), t_read(path)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, v, atol=1e-6)


# ---------------------------------------------------------------------------
# evaluate_reconstruction


@pytest.fixture(scope="module")
def recon_case(tmp_path_factory):
    """(config, JAX map, w2cs, gt points, the JAX package's metrics): the
    JAX package fuses 3 renders (mesh_interval 5 over 12 frames) of a map
    at 48x64 and scores the cleaned mesh against the gt-depth fallback
    cloud. Its renders run the Pallas kernels in interpret mode: the
    reference backend's render takes minutes to compile on the CPU."""
    from gaus_slam_tpu.utils.eval_mesh import evaluate_reconstruction
    from test_torch_backend import _config, _rel_w2c, _scene

    ds, _, jgm = _scene()
    cfg = _config(ds)
    w2cs = [_rel_w2c(ds, t) for t in range(12)]
    _, _, gt_points = _pair("load_gt_mesh_assets")[1](cfg, _RelDataset(ds, 12))
    jm = evaluate_reconstruction(
        cfg, jgm, w2cs, gt_points, out_dir=str(tmp_path_factory.mktemp("j")),
        backend="interpret", **RECON)
    return cfg, jgm, w2cs, gt_points, jm


RECON = dict(mesh_interval=5, voxel_size=0.04, threshold=0.05)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_evaluate_reconstruction_matches_jax(tmp_path, recon_case, backend):
    """The port's renders through the plain compositor ("reference") and
    through K3's plain version ("pallas", the port's main path on a CPU
    tensor): F-score, precision and recall within 1e-3 of the JAX
    package's."""
    from gaus_slam_tpu_torch.utils.eval_mesh import evaluate_reconstruction

    cfg, jgm, w2cs, gt_points, jm = recon_case
    tm = evaluate_reconstruction(
        cfg, convert.gaussian_map_from_numpy(jgm, "cpu"), w2cs, gt_points,
        out_dir=str(tmp_path), backend=backend, device="cpu", **RECON)
    print(f"\n{backend}: F-score JAX {jm['fscore']:.6f} port "
          f"{tm['fscore']:.6f}; precision {jm['precision']:.6f} / "
          f"{tm['precision']:.6f}; recall {jm['recall']:.6f} / "
          f"{tm['recall']:.6f}; vertices {jm['num_vertices']} / "
          f"{tm['num_vertices']}")
    assert 0.0 < tm["fscore"] <= 1.0
    for k in ("fscore", "precision", "recall"):
        assert abs(tm[k] - jm[k]) <= 1e-3, k
    for name in ("reconstruction_metrics.json", "mesh.npz",
                 "mesh/final_mesh.ply", "mesh/cleaned_mesh.ply"):
        assert (tmp_path / name).exists(), name


# ---------------------------------------------------------------------------
# LPIPS


def test_lpips_matches_jax_and_torch_reference(tmp_path):
    from gaus_slam_tpu.utils.lpips_jax import load_lpips as j_load
    from gaus_slam_tpu_torch.utils.lpips import load_lpips as t_load
    from test_lpips import _random_weights, _torch_lpips

    rng = np.random.default_rng(0)
    path = str(tmp_path / "w.npz")
    w = _random_weights(path, rng)
    x = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    model = t_load(path, device="cpu")
    got = float(model(x, y))
    np.testing.assert_allclose(got, float(j_load(path)(x, y)), rtol=1e-5)
    np.testing.assert_allclose(got, _torch_lpips(w, x, y), rtol=1e-5)
    # tensors in, the same value
    assert float(model(torch.as_tensor(x), torch.as_tensor(y))) == got
    assert float(model(x, x)) < 1e-8
    assert t_load("", device="cpu") is None
    assert t_load(str(tmp_path / "missing.npz"), device="cpu") is None


def test_image_metrics_lpips_reads_the_env(tmp_path, monkeypatch):
    from gaus_slam_tpu_torch.utils.image_metrics import lpips, lpips_available
    from test_lpips import _random_weights

    img = np.random.default_rng(1).random((64, 64, 3)).astype(np.float32)
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    assert not lpips_available() and np.isnan(lpips(img, img * 0.5))
    path = str(tmp_path / "w.npz")
    _random_weights(path, np.random.default_rng(2))
    monkeypatch.setenv("LPIPS_WEIGHTS", path)
    assert lpips_available()
    v = lpips(img, img * 0.5)
    assert np.isfinite(v) and v > 0
