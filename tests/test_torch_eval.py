"""The port's evaluation against the JAX package's.

  * psnr (with and without the valid-depth mask), ssim and ms_ssim at
    48x64 (3 MS-SSIM levels) and 340x600 (5 levels): within 1e-5
    relative; both packages filter in float32, in different orders.
  * ate_rmse: equal (the same numpy float64 code).
  * eval_final on one converted map and pose list at 48x64: PSNR within
    1e-3 dB, MS-SSIM and the depth errors within 1e-5, the same
    result.json keys and per-frame files, LPIPS NaN without weights.
  * save_scene / load_scene: a scene written by either package loads in
    the other with the same map and poses.
"""
import json
import os

import numpy as np
import pytest
import torch

from gaus_slam_tpu_torch import convert
from test_torch_backend import _config, _dataset, _rel_w2c, _scene


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", [(48, 64), (340, 600)],
                         ids=["48x64", "340x600"])
def test_image_metrics_match_jax(shape):
    import jax.numpy as jnp

    from gaus_slam_tpu.data.synthetic import SyntheticDataset
    from gaus_slam_tpu.utils import image_metrics as J
    from gaus_slam_tpu_torch.utils import image_metrics as T

    h, w = shape
    color, depth, _, _ = SyntheticDataset(height=h, width=w, num_frames=2)[1]
    gt = (color / 255.0).astype(np.float32)
    rng = np.random.default_rng(5)
    img = np.clip(gt + rng.normal(0.0, 0.03, gt.shape), 0, 1).astype(
        np.float32)
    mask = depth > np.median(depth)        # half the pixels
    jx, jy, tx, ty = (jnp.asarray(img), jnp.asarray(gt), torch.tensor(img),
                      torch.tensor(gt))
    pairs = [
        (T.psnr(tx, ty), J.psnr(jx, jy)),
        (T.psnr(tx, ty, mask=torch.tensor(mask)),
         J.psnr(jx, jy, mask=jnp.asarray(mask))),
        (T.ssim(tx, ty), J.ssim(jx, jy)),
        (T.ms_ssim(tx, ty), J.ms_ssim(jx, jy)),
    ]
    for k, (t, j) in enumerate(pairs):
        np.testing.assert_allclose(float(t), float(j), rtol=1e-5,
                                   err_msg=str(k))
    assert float(pairs[1][0]) != float(pairs[0][0])   # the mask mattered


def test_ate_rmse_matches_jax():
    from gaus_slam_tpu.utils.trajectory import ate_rmse as j_ate
    from gaus_slam_tpu_torch.utils.trajectory import ate_rmse as t_ate

    ds = _dataset()
    rng = np.random.default_rng(2)
    gts = [np.linalg.inv(ds[t][3]) for t in range(10)]
    gts[4] = np.full((4, 4), np.nan)       # excluded, as in the reference
    est = []
    for g in gts:
        e = np.eye(4)
        e[:3, 3] = rng.normal(0.0, 0.01, 3)
        est.append((e @ np.nan_to_num(g)).astype(np.float32))
    for align in (True, False):
        assert t_ate(est, gts, align=align) == j_ate(est, gts, align=align)


def test_eval_final_matches_jax(tmp_path):
    """Renders of frame 0's map at four perturbed poses, against the
    synthetic frames 0-3."""
    from gaus_slam_tpu.utils.eval import eval_final as j_eval
    from gaus_slam_tpu_torch.utils.eval import eval_final as t_eval

    ds, _, jgm = _scene()
    cfg = _config(ds)
    rng = np.random.default_rng(4)
    gts = [np.linalg.inv(ds[t][3]) for t in range(4)]
    w2cs = []
    for t in range(4):
        w = _rel_w2c(ds, t)
        w[:3, 3] += rng.normal(0.0, 0.005, 3).astype(np.float32)
        w2cs.append(w)
    ds4 = type(ds)(height=ds.h, width=ds.w, num_frames=60)
    jr = j_eval(cfg, jgm, w2cs, gts, _Head(ds4, 4), out_dir=str(tmp_path / "j"),
                backend="interpret")
    tr = t_eval(cfg, convert.gaussian_map_from_numpy(jgm, "cpu"), w2cs, gts,
                _Head(ds4, 4), out_dir=str(tmp_path / "t"),
                backend="interpret", device="cpu")
    assert list(tr) == list(jr)
    assert np.isnan(tr["LPIPS"]) and np.isnan(jr["LPIPS"])
    assert tr["lpips_note"] == jr["lpips_note"]
    np.testing.assert_allclose(tr["PSNR"], jr["PSNR"], rtol=0, atol=1e-3)
    for k in ("MS-SSIM", "Depth RMSE", "Depth L1"):
        np.testing.assert_allclose(tr[k], jr[k], rtol=0, atol=1e-5, err_msg=k)
    assert tr["ATE RMSE"] == jr["ATE RMSE"]
    assert tr["num_gaussians"] == jr["num_gaussians"]
    for name in ("result.json", "psnr.txt", "ssim.txt", "lpips.txt",
                 "rmse.txt", "l1.txt"):
        assert (tmp_path / "t" / name).exists(), name
    t_psnr = np.loadtxt(tmp_path / "t" / "psnr.txt")
    np.testing.assert_allclose(t_psnr, np.loadtxt(tmp_path / "j" / "psnr.txt"),
                               rtol=0, atol=1e-3)
    assert json.loads((tmp_path / "t" / "result.json").read_text())[
        "num_gaussians"] == tr["num_gaussians"]


class _Head:
    """The first n frames of a dataset."""

    def __init__(self, ds, n):
        self.ds, self.n = ds, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.ds[i]


def test_eval_refuses_mesh_and_lpips_weights(tmp_path, monkeypatch):
    """eval.eval_mesh and LPIPS weights, refused before the mesh
    evaluation was ported, now run: result.json gains the mesh metrics'
    keys and reconstruction_metrics.json is written, and LPIPS is finite
    with weights present (NaN without)."""
    from gaus_slam_tpu_torch.utils.eval import eval_final
    from gaus_slam_tpu_torch.utils.image_metrics import lpips
    from test_lpips import _random_weights

    ds, _, jgm = _scene()
    cfg = _config(ds)
    gm = convert.gaussian_map_from_numpy(jgm, "cpu")
    img = np.zeros((8, 8, 3), np.float32)
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    assert np.isnan(lpips(img, img))
    weights = tmp_path / "lpips.npz"
    _random_weights(str(weights), np.random.default_rng(0))
    monkeypatch.setenv("LPIPS_WEIGHTS", str(weights))
    cfg["eval"]["eval_mesh"] = True
    cfg["eval"]["voxel_size"] = 0.05
    res = eval_final(cfg, gm, [np.eye(4)], [np.eye(4)], _Head(ds, 1),
                     out_dir=str(tmp_path), device="cpu")
    for k in ("Mesh F-score", "Mesh precision", "Mesh recall"):
        assert k in res and 0.0 <= res[k] <= 1.0, k
    assert np.isfinite(res["LPIPS"]) and "lpips_note" not in res
    assert (tmp_path / "reconstruction_metrics.json").exists()
    rgb = np.random.default_rng(1).random((64, 64, 3)).astype(np.float32)
    assert np.isfinite(lpips(rgb, img.repeat(8, 0).repeat(8, 1)))


def test_scene_round_trip_between_packages(tmp_path):
    from gaus_slam_tpu.utils.scene_io import load_scene as j_load
    from gaus_slam_tpu.utils.scene_io import save_scene as j_save
    from gaus_slam_tpu_torch.utils.scene_io import load_scene as t_load
    from gaus_slam_tpu_torch.utils.scene_io import save_scene as t_save

    ds, _, jgm = _scene()
    cfg = _config(ds)
    tgm = convert.gaussian_map_from_numpy(jgm, "cpu")
    w2cs = [_rel_w2c(ds, t) for t in range(3)]
    gts = [np.linalg.inv(ds[t][3]) for t in range(3)]
    t_save(cfg, tgm, w2cs, gts, str(tmp_path / "t"))
    j_save(cfg, jgm, w2cs, gts, str(tmp_path / "j"))
    n = int(jgm.n_active)
    for path in ("t", "j"):
        cfg2, tg2, tw, tgt = t_load(str(tmp_path / path), device="cpu")
        _, jg2, jw, jgt = j_load(str(tmp_path / path))
        assert cfg2["cameras"] == json.loads(json.dumps(cfg["cameras"]))
        assert int(tg2.n_active) == int(jg2.n_active) == n
        assert tg2.capacity == jg2.capacity
        np.testing.assert_array_equal(tg2.active.numpy(), np.asarray(jg2.active))
        for f, p in zip(tg2.params._fields, tg2.params):
            np.testing.assert_array_equal(p.numpy(),
                                          np.asarray(getattr(jg2.params, f)))
            np.testing.assert_array_equal(
                p.numpy()[:n], np.asarray(getattr(jgm.params, f))[:n])
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(tgt, jgt)
    assert os.path.getsize(tmp_path / "t" / "gaussians.ply") == \
        os.path.getsize(tmp_path / "j" / "gaussians.ply")
