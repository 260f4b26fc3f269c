"""The traffic generator: the motion a frame of each mix carries, the
forward-and-back walk, what the seed changes, and the torch box renderer
against the port's numpy one."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from slambench import registry
from slambench.frames import FrameStream
from slambench.reference import boxscene


@pytest.mark.parametrize("name, n, mean_mm, max_mm, mean_deg, max_deg", [
    ("orbit", 60, 23.6, 37.2, 0.68, 1.09),
    ("handheld", 102, 13.8, 21.8, 0.40, 0.64),
])
def test_motion_per_frame(name, n, mean_mm, max_mm, mean_deg, max_deg):
    traffic = registry.traffic(name)
    poses = boxscene.pass_poses(traffic)
    assert len(poses) == n
    # one period of the walk: forward, then back
    tr, rot = boxscene.motion_per_frame(poses + poses[-2::-1])
    assert np.mean(tr) * 1000 == pytest.approx(mean_mm, abs=0.05)
    assert np.max(tr) * 1000 == pytest.approx(max_mm, abs=0.05)
    assert np.mean(rot) == pytest.approx(mean_deg, abs=0.005)
    assert np.max(rot) == pytest.approx(max_deg, abs=0.005)


def test_walk_forward_and_back():
    n = 5
    seq = [boxscene.pass_index(p, n) for p in range(12)]
    assert seq == [0, 1, 2, 3, 4, 3, 2, 1, 0, 1, 2, 3]


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 12345, 2**33 + 7])
def test_seed_changes_texture_phases_only(seed):
    cam = dict(h=12, w=16, fx=9.6, fy=9.6, cx=7.5, cy=5.5, depth_scale=6553.5)
    traffic = registry.traffic("orbit")
    a = FrameStream(cam, traffic, seed, "cpu")
    b = FrameStream(cam, traffic, seed, "cpu")
    c = FrameStream(cam, traffic, seed + 1, "cpu")
    # same seed, same frames; another seed, the same poses at the same speed
    assert all(np.array_equal(x, y) for x, y in zip(a.color8, b.color8))
    assert np.array_equal(a.phases, b.phases)
    assert all(np.array_equal(x, y) for x, y in zip(a.poses, c.poses))
    assert a.start == c.start == traffic["start"]
    assert not np.array_equal(a.phases, c.phases)
    assert not all(np.array_equal(x, y) for x, y in zip(a.color8, c.color8))
    assert all(np.array_equal(x, y) for x, y in zip(a.depth16, c.depth16))
    color, depth, k, c2w = a[3]
    assert color.dtype == np.float32 and depth.dtype == np.float32
    assert np.allclose(c2w, a.c2w(3))


def test_cosine_timing_turns_back_smoothly():
    traffic = registry.traffic("orbit")
    walk = boxscene.pass_poses(traffic)
    tr, _ = boxscene.motion_per_frame(walk + walk[-2::-1])
    # the camera slows to a stop at each end: the moves next to a turn are
    # the smallest of the walk, under 1.5 mm, and grow from there
    assert max(tr[0], tr[58], tr[59]) * 1000 < 1.5
    assert tr[0] < tr[1] < tr[2] and tr[59] < tr[60] < tr[61]
    uniform = boxscene.pass_poses(dict(traffic, timing="uniform"))
    tr_u, _ = boxscene.motion_per_frame(uniform)
    assert np.mean(tr_u) * 1000 == pytest.approx(23.6, abs=0.05)


def test_box_renderer_matches_the_port():
    from gaus_slam_tpu_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(height=24, width=32, num_frames=60)
    cam = dict(h=24, w=32, fx=ds.fx, fy=ds.fy, cx=ds.cx, cy=ds.cy)
    for i in (0, 17, 59):
        c2w = boxscene.orbit_c2w(i / 59, boxscene.ORBIT)
        assert np.allclose(c2w, ds._poses[i])
        color, depth = boxscene.render_frame(c2w, cam, (3.0, 2.0, 3.0),
                                             np.zeros(6), "cpu")
        ref_c, ref_d = ds.render_frame(ds._poses[i])
        assert torch.allclose(color, torch.from_numpy(ref_c), atol=1e-5)
        assert torch.allclose(depth, torch.from_numpy(ref_d), atol=1e-5)
