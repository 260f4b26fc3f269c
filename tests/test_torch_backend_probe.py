"""tools/backend_probe.py's port against the JAX calls it makes.

The JAX tool has no importable function, so the test writes its map
construction out (tools/backend_probe.py:59-84) and holds the port's
``build_map`` to it at 48x64 with a small ``n_target`` (capacity 131072,
the 2^17 quantum): n_active and the active rows exact, every parameter
within 1e-6, but for the orientation of surfels whose normal sits on a
coordinate axis. There the reference's construction is degenerate
(``surfel_quat_from_normal`` falls back to the identity when
|up x n| < 1e-9), and the one float32 matmul of ``transform_points``,
which rounds differently in XLA and in PyTorch (by one ulp on a quarter
of frame 12's points), decides it (ROADMAP Queue 3 item 6): each such
row must hold the identity in one package. Since the bins depend on those
orientations, the bins of the probe's two budgets (factor 1.75 and the
demand-keyed pair cap) are compared on the JAX map carried into the
port, and must agree exactly; so must one mapping_step and one
backend_tracking_step on it, at tests/test_torch_steps.py's tolerances
(pose 5e-5, loss 1e-4 relative, the map within one Adam step). JAX runs
its Pallas kernels in interpret mode; the port runs the plain versions
on the CPU. Last, the tool's own ``main`` on the CPU at 32x48 with one
rep: every key of the JAX tool's JSON, each time finite and > 0.
"""
import numpy as np
import pytest
import torch

from gaus_slam_tpu_torch import convert
from test_torch_frontend import _assert_map_close

H, W = 48, 64
N_TARGET = 10000
LRS = (("opacity_lr", 0.05), ("rgb_lr", 0.0025), ("rotation_lr", 0.001),
       ("scaling_lr", 0.001), ("xyz_lr", 0.0001))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_map(ds):
    """tools/backend_probe.py:59-84 at H x W with N_TARGET."""
    import jax.numpy as jnp

    from gaus_slam_tpu.models import gaussians as G
    from gaus_slam_tpu.ops.camera import camera_from_intrinsics
    from gaus_slam_tpu.ops.geometry import (depth_scale_init,
                                            normals_from_points,
                                            points_from_depth,
                                            valid_depth_mask)
    from gaus_slam_tpu.ops.se3 import invert_se3, transform_points

    cam0 = camera_from_intrinsics(H, W, ds.intrinsics, np.eye(4))
    gm = G.empty_map(G.bucket_capacity(N_TARGET, 1 << 17, 1.2, 0))
    for t in (0, 12, 24):
        color, depth, _, c2w = ds[t]
        w2c = jnp.asarray(np.linalg.inv(c2w), jnp.float32)
        cam = cam0.replace_w2c(w2c)
        pts_cam = points_from_depth(jnp.asarray(depth), cam)
        pts_w = transform_points(invert_se3(w2c), pts_cam.reshape(-1, 3))
        normals = normals_from_points(pts_w.reshape(pts_cam.shape))
        gm = G.add_gaussians(
            gm, pts_w.reshape(-1, 3),
            jnp.asarray(color / 255.0).reshape(-1, 3),
            normals.reshape(-1, 3),
            depth_scale_init(jnp.asarray(depth), cam).reshape(-1),
            valid_depth_mask(jnp.asarray(depth)).reshape(-1))
    return cam0, gm


class Both:
    """The two packages' maps, cameras, options and frame 24."""

    def __init__(self):
        import jax.numpy as jnp

        from gaus_slam_tpu.data.synthetic import SyntheticDataset
        from gaus_slam_tpu.ops import binning as JB
        from gaus_slam_tpu.ops.composite_ref import frame_to_tiles as j_tiles
        from gaus_slam_tpu_torch.ops import binning as TB
        from gaus_slam_tpu_torch.ops.composite_ref import \
            frame_to_tiles as t_tiles
        from gaus_slam_tpu_torch.tools import backend_probe

        self.jcam, self.jgm = _jax_map(SyntheticDataset(height=H, width=W,
                                                        num_frames=30))
        ds, self.tcam, self.own = backend_probe.build_map(H, W, "cpu",
                                                          N_TARGET)
        # the JAX map in the port: the same state for both packages
        self.tgm = convert.gaussian_map_from_numpy(self.jgm, device="cpu")
        color, depth, _, c2w = ds[24]
        self.w2c = np.linalg.inv(c2w).astype(np.float32)
        self.jgrid = JB.make_grid(self.jcam, 16, 16)
        self.tgrid = TB.make_grid(self.tcam, 16, 16)
        self.jgt = j_tiles(jnp.asarray(color / 255.0), jnp.asarray(depth),
                           self.jgrid)
        self.tgt = t_tiles(torch.as_tensor((color / 255.0).astype(
            np.float32)), torch.as_tensor(depth), self.tgrid)

    def opts(self, pair_cap=0):
        from gaus_slam_tpu.render import RenderOptions as JOpts
        from gaus_slam_tpu_torch.render import RenderOptions as TOpts

        kw = dict(pair_budget_factor=1.75, pair_cap=pair_cap,
                  max_tiles_per_gaussian=4)
        return (JOpts(grid=self.jgrid, backend="interpret", **kw),
                TOpts(grid=self.tgrid, backend="interpret", **kw))


@pytest.fixture(scope="module")
def both():
    return Both()


def test_build_map_matches_jax(both):
    n = int(both.jgm.n_active)
    assert both.own.capacity == both.jgm.capacity == 131072
    assert int(both.own.n_active) == n > 0.9 * 3 * H * W
    np.testing.assert_array_equal(both.own.active.numpy(),
                                  np.asarray(both.jgm.active))
    for f in both.jgm.params._fields:
        if f == "quats":
            continue
        np.testing.assert_allclose(getattr(both.own.params, f).numpy(),
                                   np.asarray(getattr(both.jgm.params, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    tq, jq = both.own.params.quats.numpy(), np.asarray(both.jgm.params.quats)
    apart = np.abs(tq - jq).max(axis=1) > 1e-6
    ident = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    fallback = (np.abs(tq - ident).max(axis=1) == 0) ^ \
        (np.abs(jq - ident).max(axis=1) == 0)
    assert not (apart & ~fallback).any()
    # frame 0 (at the identity pose, no matmul rounding) is exact; the
    # degenerate rows are a minority of the other frames' surfels
    assert not apart[:H * W].any() and apart.sum() < 0.1 * n


@pytest.mark.parametrize("budget", ["factor1.75", "paircap"])
def test_bins_match_jax(both, budget):
    """bin_full at the probe's frame under the factor budget and under the
    demand-keyed pair cap (the port's pair_cap_for against the JAX tool's
    arithmetic on the JAX demand)."""
    import jax.numpy as jnp

    from gaus_slam_tpu.render import bin_full as j_bin
    from gaus_slam_tpu_torch.render import bin_full as t_bin
    from gaus_slam_tpu_torch.tools.backend_probe import pair_cap_for

    pc = 0
    if budget == "paircap":
        jo, _ = both.opts()
        jdemand = int(j_bin(both.jgm.params, both.jgm.active,
                            both.jcam.replace_w2c(jnp.asarray(both.w2c)),
                            jo).demand)
        q = 1 << 17
        pc = -(-int(jdemand * 1.3) // q) * q     # tools/backend_probe.py:96
        assert pair_cap_for(jdemand) == pc
    jo, to = both.opts(pc)
    jb = j_bin(both.jgm.params, both.jgm.active,
               both.jcam.replace_w2c(jnp.asarray(both.w2c)), jo)
    tcam = both.tcam.replace_w2c(torch.as_tensor(both.w2c))
    tb = t_bin(both.tgm.params, both.tgm.active, tcam, to)
    got = [int(tb.demand), int(tb.num_pairs), bool(tb.overflow),
           to.r_max(both.tgm.capacity)]
    want = [int(jb.demand), int(jb.num_pairs), bool(jb.overflow),
            jo.r_max(both.jgm.capacity)]
    assert got == want
    assert got[0] == got[1] > 0 and not got[2]
    np.testing.assert_array_equal(tb.tile_start.numpy(),
                                  np.asarray(jb.tile_start))
    # the port's own map: the same budget, its demand moved only by the
    # degenerate orientations
    own = t_bin(both.own.params, both.own.active, tcam, to)
    assert not bool(own.overflow)
    assert abs(int(own.demand) - got[0]) <= 1e-3 * got[0]


def test_mapping_step_matches_jax(both):
    """The probe's map1 stage: one mapping step at frame 24's pose."""
    import jax.numpy as jnp

    from gaus_slam_tpu.models.frame import LrSchedule as JLr
    from gaus_slam_tpu.models.frame import init_exposure as j_exp
    from gaus_slam_tpu.slam.loss import LossConfig as JLoss
    from gaus_slam_tpu.slam.steps import MapConfig as JMap
    from gaus_slam_tpu.slam.steps import mapping_step as j_step
    from gaus_slam_tpu_torch.models.frame import LrSchedule as TLr
    from gaus_slam_tpu_torch.models.frame import init_exposure as t_exp
    from gaus_slam_tpu_torch.slam.loss import LossConfig as TLoss
    from gaus_slam_tpu_torch.slam.steps import MapConfig as TMap
    from gaus_slam_tpu_torch.slam.steps import mapping_step as t_step

    jo, to = both.opts()
    jgm2, _, jaux = j_step(both.jgm, jnp.asarray(both.w2c), both.jgt,
                           j_exp(), jnp.bool_(False), JLr(0.0, 0.0, 1),
                           both.jcam, jo, JMap(lrs=LRS), JLoss())
    tgm2, _, taux = t_step(both.tgm, torch.as_tensor(both.w2c), both.tgt,
                           t_exp("cpu"), False, TLr(0.0, 0.0, 1), both.tcam,
                           to, TMap(lrs=LRS), TLoss())
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               rtol=1e-4)
    assert int(taux["num_pairs"]) == int(jaux["num_pairs"])
    _assert_map_close(tgm2, jgm2, steps_bound=1)
    # the step moved the map
    assert float((tgm2.params.rgb - both.tgm.params.rgb).abs().max()) > 1e-4


def test_backend_tracking_step_matches_jax(both):
    """The probe's trk stage: one step of the transform from the identity
    under frame 24's fixed pose."""
    import jax.numpy as jnp

    from gaus_slam_tpu.models.frame import LrSchedule as JLr
    from gaus_slam_tpu.models.frame import init_pose as j_pose
    from gaus_slam_tpu.slam.loss import LossConfig as JLoss
    from gaus_slam_tpu.slam.steps import TrackConfig as JTrack
    from gaus_slam_tpu.slam.steps import backend_tracking_step as j_step
    from gaus_slam_tpu_torch.models.frame import LrSchedule as TLr
    from gaus_slam_tpu_torch.slam.loss import LossConfig as TLoss
    from gaus_slam_tpu_torch.slam.steps import TrackConfig as TTrack
    from gaus_slam_tpu_torch.slam.steps import backend_tracking_step as t_step

    jo, to = both.opts()
    kw = dict(num_iters=1, converged_th=-1.0)
    jt = JTrack(rot_sched=JLr(1e-4, 0.0, 40), trans_sched=JLr(5e-4, 0.0, 40),
                **kw)
    tt = TTrack(rot_sched=TLr(1e-4, 0.0, 40), trans_sched=TLr(5e-4, 0.0, 40),
                **kw)
    jpose = j_pose(np.eye(4, dtype=np.float32))
    jp, jaux = j_step(both.jgm, jpose, jnp.asarray(both.w2c), both.jgt,
                      both.jcam, jo, jt, JLoss())
    tp, taux = t_step(both.tgm, convert.pose_from_numpy(jpose, device="cpu"),
                      torch.as_tensor(both.w2c), both.tgt, both.tcam, to, tt,
                      TLoss())
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(tp.w2c.numpy(), np.asarray(jp.w2c), rtol=0,
                               atol=5e-5)
    assert int(taux["demand"]) == int(jaux["demand"])
    assert np.abs(tp.w2c.numpy() - np.eye(4)).max() > 1e-5   # it moved


def test_main_on_cpu(monkeypatch, capsys):
    """The tool at 32x48, one rep: the JAX tool's keys, every time finite
    and > 0 (the cached tracking step included), the pair cap's bin
    without overflow and with every pair placed."""
    import json

    from gaus_slam_tpu_torch.tools import backend_probe

    for k, v in dict(PROBE_H="32", PROBE_W="48", PROBE_REPS="1").items():
        monkeypatch.setenv(k, v)
    res = backend_probe.main(["--device", "cpu"], n_target=N_TARGET)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(res))
    assert res["demand"] > 0
    for tag in ("factor1.75", "paircap"):
        times = res[tag]
        assert set(times) == {"bin", "map1", "map4", "map4c", "trk", "trkc"}
        assert all(v is not None and np.isfinite(v) and v > 0
                   for v in times.values()), times
    pc = res["bins"]["paircap"]
    assert pc["pair_cap"] == pc["r_max"] == 131072
    assert not pc["overflow"] and pc["num_pairs"] == pc["demand"] == \
        res["demand"]
    with pytest.raises(SystemExit):
        backend_probe.main(["--device", "tpu"])
