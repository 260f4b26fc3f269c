"""The port's eval_nvs and gen_video scripts and its GIF writer, against the
JAX package's scripts on a 48x64 scene saved by the JAX package (the
synthetic scene's frame-0 map in world coordinates, the first three
poses moved by a few mm, a dataset of three frames).

Tolerances:
  * eval_nvs without pose refinement: PSNR within 0.05 dB, MS-SSIM within
    1e-3, depth L1 within 1e-4, LPIPS NaN in both without weights (the
    renders differ by float32 summation order, the plain versions against
    the interpret-mode Pallas kernels); with refinement (slow): the same
    keys after 100 tracking iterations from the same pose, depth L1
    within 1e-3 and PSNR within 0.5 dB. On this one-frame map the
    tracker walks every pose away (both packages end near 0.28 m depth
    L1 from 0.006 unrefined), and 100 iterations amplify the float32
    differences of the renders: the two land 0.42 dB apart in PSNR and
    8e-6 apart in depth L1 (measured on the CPU);
  * gen_video's flythrough frames within 1e-4 (the renders again); the
    mesh orbit frames bit for bit, both packages given the port's fused
    mesh (the sampling and the splat are the same numpy code);
  * the GIF writer: decoded by PIL, every frame equal to the palette
    colours of its quantized pixels, bit for bit.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_backend import _config, _dataset

REPO = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A scene directory written by the JAX package's save_scene."""
    import jax.numpy as jnp

    from gaus_slam_tpu.data import get_dataset
    from gaus_slam_tpu.ops.camera import camera_from_intrinsics
    from gaus_slam_tpu.slam.init_map import initialize_map
    from gaus_slam_tpu.utils.scene_io import save_scene

    cfg = _config(_dataset())
    cfg["data"]["num_frames_total"] = 3
    cfg["eval"]["mesh_interval"] = 1
    cfg["eval"]["voxel_size"] = 0.05     # a mesh of ~1e5, not ~2e6, faces
    ds = get_dataset(cfg["data"])
    color, depth, k, c2w = ds[0]
    h, w = np.asarray(depth).shape[:2]
    cam = camera_from_intrinsics(h, w, k, np.eye(4))
    gm = initialize_map(4096, jnp.asarray(color / 255.0, jnp.float32),
                        jnp.asarray(depth),
                        jnp.asarray(np.linalg.inv(c2w), jnp.float32), cam)
    # the poses moved by a few mm: at frame 0's own pose the freshly
    # seeded surfels sit at equal depths, and the two packages' depth
    # sorts may break those ties in another order
    rng = np.random.default_rng(4)
    w2cs = []
    for i in range(3):
        w2c = np.linalg.inv(ds[i][3]).astype(np.float32)
        w2c[:3, 3] += rng.normal(0.0, 0.005, 3).astype(np.float32)
        w2cs.append(w2c)
    path = str(tmp_path_factory.mktemp("scene") / "scene")
    save_scene(cfg, gm, w2cs, w2cs, path)
    return path


def _jax_script(name, argv, monkeypatch):
    sys.path.insert(0, REPO)
    mod = __import__(f"scripts.{name}", fromlist=["main"])
    monkeypatch.setattr(sys, "argv", [name, *argv])
    return mod


def _nvs_pair(scene, monkeypatch, refine):
    from gaus_slam_tpu_torch.scripts import eval_nvs

    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    extra = [] if refine else ["--no_pose_refine"]
    _jax_script("eval_nvs", [scene, "--backend", "interpret", *extra],
                monkeypatch).main()
    with open(os.path.join(scene, "nvs_result.json")) as f:
        jr = json.load(f)
    tr = eval_nvs.main([scene, "--backend", "interpret", "--device", "cpu",
                        *extra])
    with open(os.path.join(scene, "nvs_result.json")) as f:
        assert json.load(f).keys() == tr.keys() == jr.keys()
    return jr, tr


def test_eval_nvs_matches_jax(scene, monkeypatch):
    jr, tr = _nvs_pair(scene, monkeypatch, refine=False)
    assert tr["num_views"] == jr["num_views"] == 3
    np.testing.assert_allclose(tr["NVS PSNR"], jr["NVS PSNR"], atol=0.05)
    np.testing.assert_allclose(tr["NVS MS-SSIM"], jr["NVS MS-SSIM"],
                               atol=1e-3)
    np.testing.assert_allclose(tr["NVS Depth L1"], jr["NVS Depth L1"],
                               atol=1e-4)
    assert np.isnan(tr["NVS LPIPS"]) and np.isnan(jr["NVS LPIPS"])
    assert tr["NVS PSNR"] > 15.0


def test_eval_nvs_pose_refinement_runs(scene, monkeypatch):
    """The port's refinement path on one frame, cut from 100 tracking
    iterations to 5 (the CPU takes ~0.5 s an iteration here; the slow
    test below runs all 100 against the JAX script): finite metrics, and
    the tracked pose renders differently."""
    from gaus_slam_tpu_torch.scripts import eval_nvs
    from gaus_slam_tpu_torch.slam import steps

    config = steps.TrackConfig
    monkeypatch.setattr(steps, "TrackConfig", lambda **kw: config(
        **dict(kw, num_iters=5)))
    kw = dict(backend="interpret", device="cpu", frames=[0])
    plain = eval_nvs.evaluate(scene, pose_refine=False, **kw)
    refined = eval_nvs.evaluate(scene, **kw)
    assert plain["num_views"] == refined["num_views"] == 1
    for k in ("NVS PSNR", "NVS MS-SSIM", "NVS Depth L1"):
        assert np.isfinite(refined[k]), k
    assert refined["NVS PSNR"] != plain["NVS PSNR"]


@pytest.mark.slow
def test_eval_nvs_refined_matches_jax(scene, monkeypatch):
    jr, tr = _nvs_pair(scene, monkeypatch, refine=True)
    print(f"eval_nvs refined: JAX {json.dumps(jr)}; port {json.dumps(tr)}")
    np.testing.assert_allclose(tr["NVS PSNR"], jr["NVS PSNR"], atol=0.5)
    np.testing.assert_allclose(tr["NVS Depth L1"], jr["NVS Depth L1"],
                               atol=1e-3)
    assert tr["num_views"] == jr["num_views"] == 3


def _capture(monkeypatch):
    """JAX's frames_to_video replaced by a recorder of its frames."""
    import gaus_slam_tpu.utils.viz as jviz

    frames = []
    monkeypatch.setattr(jviz, "frames_to_video",
                        lambda fr, path, fps=30: frames.append(
                            [np.asarray(f) for f in fr]))
    return frames


def test_gen_video_flythrough_matches_jax(scene, monkeypatch):
    from gaus_slam_tpu_torch.scripts.gen_video import flythrough_frames

    got = _capture(monkeypatch)
    _jax_script("gen_video", [scene, "--backend", "interpret", "--stride",
                              "1"], monkeypatch).main()
    (jf,) = got
    tf = flythrough_frames(scene, "interpret", stride=1, device="cpu")
    assert len(tf) == len(jf) == 3
    for t, j in zip(tf, jf):
        assert t.shape == j.shape == (48, 128, 3)
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-4)
    assert max(float(f.max()) for f in tf) > 0.5


def test_gen_video_mesh_orbit_matches_jax(scene, monkeypatch):
    import gaus_slam_tpu.utils.eval_mesh as jmesh
    from gaus_slam_tpu_torch.scripts.gen_video import mesh_flythrough_frames
    from gaus_slam_tpu_torch.utils.eval_mesh import fuse_render_mesh
    from gaus_slam_tpu_torch.utils.scene_io import load_scene

    config, gm, w2cs, _ = load_scene(scene, device="cpu")
    mesh = fuse_render_mesh(config, gm, list(w2cs), backend="interpret",
                            mesh_interval=1, voxel_size=0.05, device="cpu")
    assert len(mesh[2]) > 100
    monkeypatch.setattr(jmesh, "fuse_render_mesh", lambda *a, **kw: mesh)
    got = _capture(monkeypatch)
    _jax_script("gen_video", [scene], monkeypatch).mesh_flythrough(
        scene, "interpret", 30, n_frames=2, size=64)
    (jf,) = got
    tf, n_verts = mesh_flythrough_frames(scene, "interpret", n_frames=2,
                                         size=64, device="cpu")
    assert n_verts == len(mesh[0])
    assert len(tf) == len(jf) == 2
    for t, j in zip(tf, jf):
        np.testing.assert_array_equal(t, j)
    assert float(tf[0].max()) > 0.1


def test_gif_writer_decodes_to_quantized_frames(tmp_path, monkeypatch):
    """frames_to_video without imageio writes <stem>.gif with the port's
    encoder; PIL decodes it to the palette colours of the quantized
    frames, as does the port's own reader; quantize picks the nearest
    palette entry."""
    from PIL import Image

    from gaus_slam_tpu_torch.utils import gif
    from gaus_slam_tpu_torch.utils.viz import frames_to_video

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:40, :72] / 72.0
    frames = [np.stack([xx, yy, (xx + yy + 0.1 * t) % 1.0], -1)
              for t in range(3)]
    frames.append(rng.uniform(size=(40, 72, 3)))        # incompressible
    frames.append(np.repeat(xx[..., None], 3, -1))      # a grey ramp
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    path = frames_to_video(frames, str(tmp_path / "v.mp4"), fps=10)
    assert path == str(tmp_path / "v.gif") and os.path.exists(path)
    want = [gif.quantize(np.clip(f * 255, 0, 255).astype(np.uint8))
            for f in frames]
    im = Image.open(path)
    assert im.n_frames == len(frames)
    for i, q in enumerate(want):
        im.seek(i)
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")),
                                      gif.PALETTE[q])
    palette, idx = gif.read_gif(path)
    np.testing.assert_array_equal(palette, gif.PALETTE)
    np.testing.assert_array_equal(idx, np.stack(want))
    # a frame long enough to fill the 4096-entry code table several times
    big = rng.integers(0, 256, (300, 400, 3)).astype(np.uint8)
    gif.write_gif(str(tmp_path / "big.gif"), [big])
    im = Image.open(str(tmp_path / "big.gif"))
    np.testing.assert_array_equal(np.asarray(im.convert("RGB")),
                                  gif.PALETTE[gif.quantize(big)])
    x = rng.integers(0, 256, (5000, 3))
    d = ((x[:, None, :] - gif.PALETTE[None].astype(np.int64)) ** 2).sum(-1)
    q = gif.quantize(x.astype(np.uint8))
    np.testing.assert_array_equal(d[np.arange(len(x)), q], d.min(1))
