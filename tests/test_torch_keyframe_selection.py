"""Port parity of utils/keyframe_selection.py against the JAX package's.

The synthetic scene at 48x64: frame 6's depth and pose against the poses
of frames 0, 3, 9, 12 and two far from the scene. The JAX function draws
its pixels with ``jax.random.choice(PRNGKey(0), ...)``; the test draws the
same indices and hands the port's ``points_overlap`` the same points:
the overlaps must agree to 1e-6 (float32 projections in the same order).
Each package's sampled overlap (200000 draws, a standard error under
1.2e-3) must come within 0.01 of the exact overlap over every valid
pixel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from gaus_slam_tpu.data.synthetic import SyntheticDataset
from gaus_slam_tpu.ops.camera import camera_from_intrinsics as j_cam
from gaus_slam_tpu.ops.geometry import points_from_depth as j_points
from gaus_slam_tpu.ops.se3 import invert_se3 as j_inv
from gaus_slam_tpu.ops.se3 import transform_points as j_tf
from gaus_slam_tpu.utils.keyframe_selection import \
    keyframe_overlap as j_overlap
from gaus_slam_tpu_torch.ops.camera import camera_from_intrinsics as t_cam
from gaus_slam_tpu_torch.ops.geometry import points_from_depth
from gaus_slam_tpu_torch.ops.se3 import invert_se3, transform_points
from gaus_slam_tpu_torch.utils.keyframe_selection import (keyframe_overlap,
                                                          points_overlap)


def _scene():
    ds = SyntheticDataset(height=48, width=64, num_frames=14)
    _, depth, k, c2w = ds[6]
    depth = np.asarray(depth, np.float32).squeeze()
    w2c = np.linalg.inv(c2w).astype(np.float32)
    kfs = [np.linalg.inv(ds[i][3]) for i in (0, 3, 9, 12)]
    far = np.eye(4)
    far[:3, 3] = (0.0, 0.0, -50.0)         # the scene behind the camera
    turned = np.diag([-1.0, 1.0, -1.0, 1.0])
    kfs = np.stack(kfs + [far, turned @ kfs[0]]).astype(np.float32)
    return depth, w2c, np.asarray(k), kfs


def test_points_overlap_matches_jax():
    depth, w2c, k, kfs = _scene()
    h, w = depth.shape
    jc = j_cam(h, w, k, np.eye(4))
    jr = np.asarray(j_overlap(jnp.asarray(depth), jnp.asarray(w2c), jc,
                              jnp.asarray(kfs), pixels=1600))
    # the JAX function's own draw
    pts = j_points(jnp.asarray(depth), jc).reshape(-1, 3)
    valid = (jnp.asarray(depth) > 0).reshape(-1)
    idx = np.asarray(jax.random.choice(
        jax.random.PRNGKey(0), pts.shape[0], (1600,),
        p=valid / jnp.maximum(valid.sum(), 1)))
    tc = t_cam(h, w, k, np.eye(4), device="cpu")
    pts_cam = points_from_depth(torch.tensor(depth), tc).reshape(-1, 3)
    pts_w = transform_points(invert_se3(torch.tensor(w2c)),
                             pts_cam[torch.tensor(idx)])
    got = points_overlap(pts_w, torch.tensor(kfs), tc, h, w).numpy()
    np.testing.assert_allclose(got, jr, rtol=0, atol=1e-6)
    assert jr.max() > 0.5 and jr.min() == 0.0     # informative candidates


def test_sampled_overlap_is_near_exact():
    depth, w2c, k, kfs = _scene()
    h, w = depth.shape
    tc = t_cam(h, w, k, np.eye(4), device="cpu")
    t_depth = torch.tensor(depth)
    pts_cam = points_from_depth(t_depth, tc).reshape(-1, 3)
    pts_w = transform_points(invert_se3(torch.tensor(w2c)),
                             pts_cam[(t_depth > 0).reshape(-1)])
    exact = points_overlap(pts_w, torch.tensor(kfs), tc, h, w).numpy()
    g = torch.Generator()
    g.manual_seed(0)
    port = keyframe_overlap(t_depth, torch.tensor(w2c), tc, torch.tensor(kfs),
                            pixels=200_000, generator=g).numpy()
    jc = j_cam(h, w, k, np.eye(4))
    jr = np.asarray(j_overlap(jnp.asarray(depth), jnp.asarray(w2c), jc,
                              jnp.asarray(kfs), pixels=200_000))
    assert np.abs(port - exact).max() < 0.01, (port, exact)
    assert np.abs(jr - exact).max() < 0.01, (jr, exact)
    # the JAX package's back-projection gives the same exact overlaps
    jpts = j_tf(j_inv(jnp.asarray(w2c)), j_points(jnp.asarray(depth), jc)
                .reshape(-1, 3))
    np.testing.assert_allclose(np.asarray(jpts)[depth.reshape(-1) > 0],
                               pts_w.numpy(), rtol=0, atol=1e-5)
