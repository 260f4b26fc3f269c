"""The port's descriptor and LocalMap against the JAX package's.

Inputs made from a numpy seed go to both. Descriptors agree to 1e-6
(float32 means over the same cells, summed in another order); the cut
keeps the same frames (the same draws from the same random.Random), and
freezes and rebases the same poses (to 1e-6: one 4x4 product in float32).
"""
import random

import numpy as np
import pytest
import torch

from gaus_slam_tpu_torch.models import descriptor as TD
from gaus_slam_tpu_torch.models import gaussians as TG
from gaus_slam_tpu_torch.models.frame import Frame as TFrame
from gaus_slam_tpu_torch.models.submap import LocalMap as TLocalMap

H, W = 48, 64


def _images(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (H, W, 3)).astype(np.float32) for _ in range(n)]


def test_descriptor_matches_jax():
    import jax.numpy as jnp

    from gaus_slam_tpu.models import descriptor as JD

    imgs = _images(0, 3)
    jd = np.asarray(JD.describe_frames([jnp.asarray(i) for i in imgs]))
    td = TD.describe_frames([torch.tensor(i) for i in imgs]).numpy()
    assert td.shape == jd.shape == (3, 256)
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-6)
    mats = np.stack([td[:2], td[1:], td[[0, 2]]])
    assert TD.query_covisible(mats, td[:2], 2) == \
        JD.query_covisible(mats, jd[:2], 2)


def _poses(seed, n):
    """n random rigid w2c matrices (float32)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                       2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                       2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x),
                       1 - 2 * (x * x + y * y)]])
        m = np.eye(4, dtype=np.float32)
        m[:3, :3], m[:3, 3] = R, rng.normal(0, 0.5, 3)
        out.append(m.astype(np.float32))
    return out


@pytest.mark.parametrize("n_frames,saved", [(6, 2), (3, 5)])
def test_localmap_cut_matches_jax(n_frames, saved):
    import jax.numpy as jnp

    from gaus_slam_tpu.models import gaussians as JG
    from gaus_slam_tpu.models.frame import Frame as JFrame
    from gaus_slam_tpu.models.submap import LocalMap as JLocalMap

    imgs, poses = _images(1, n_frames), _poses(2, n_frames)
    types = [0] + [1 if i % 2 else 2 for i in range(1, n_frames)]
    jframes, tframes = [], []
    for i in range(n_frames):
        depth = np.full((H, W), 1.0 + i, np.float32)
        jf = JFrame(time_idx=i, gt_color=jnp.asarray(imgs[i]),
                    gt_depth=jnp.asarray(depth), gt_w2c=np.eye(4),
                    frame_type=types[i])
        tf = TFrame(time_idx=i, gt_color=torch.tensor(imgs[i]),
                    gt_depth=torch.tensor(depth), gt_w2c=np.eye(4),
                    frame_type=types[i], device="cpu")
        jf.start_optimizer(poses[i], enable_exposure=i == 1)
        tf.start_optimizer(poses[i], enable_exposure=i == 1)
        jframes.append(jf)
        tframes.append(tf)
    jm, tm = JG.empty_map(256), TG.empty_map(256, "cpu")
    jrng, trng = random.Random(7), random.Random(7)
    jlm = JLocalMap.cut(3, jframes, JG.extract_params(jm), saved, rng=jrng,
                        n_active_host=0)
    tlm = TLocalMap.cut(3, tframes, TG.extract_params(tm), saved, rng=trng,
                        n_active_host=0)
    assert jrng.getstate() == trng.getstate()
    assert (tlm.lmid, tlm.saved_idxs, tlm.tracking_ok) == \
        (jlm.lmid, jlm.saved_idxs, jlm.tracking_ok)
    assert len(tlm.saved_idxs) == min(saved, n_frames - 1)
    np.testing.assert_allclose(tlm.map_desc, np.asarray(jlm.map_desc),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tlm.ref2f0, jlm.ref2f0, rtol=0, atol=1e-6)
    for i, (t, j) in enumerate(zip(tframes, jframes)):
        assert t.pose is None and j.pose is None and t.exposure is None
        assert (t.gt_color is None) == (j.gt_color is None) == \
            (i not in tlm.saved_idxs)
        assert t.est_exposure == j.est_exposure
        np.testing.assert_allclose(t.est_w2c, j.est_w2c, rtol=0, atol=1e-6)
    # frame 0 is the submap's origin after the rebase
    np.testing.assert_allclose(tframes[0].est_w2c, np.eye(4), atol=1e-6)

    jlm.start_optimizer(poses[0])
    tlm.start_optimizer(poses[0], device="cpu")
    np.testing.assert_allclose(tlm.get_frame_w2c(1).numpy(),
                               np.asarray(jlm.get_frame_w2c(1)), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tlm.frame_exp(1), jlm.frame_exp(1))
