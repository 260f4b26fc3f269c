"""The port's Frontend against the JAX package's, driven by the same
config file (configs/synthetic/config.py at 48x64, submaps of 3 frames,
8 tracking and 4 mapping iterations, tau_k 0.02 so that frame 2 is a
keyframe and frame 3 cuts the first submap; capacity floor 8192). JAX
runs its Pallas kernels in interpret mode; the port runs the plain
versions on the CPU.

  * One process_frame from identical state: before frames 1 (tracked),
    2 (keyframe) and 3 (submap cut) the JAX frontend's state is carried
    into a port Frontend (convert.frontend_state_from_jax); both process
    the frame. Decisions, RNG state and map size must be equal; poses
    agree to 5e-5 m / 1e-4 (a fortieth of a tracking step, lr 2e-3: the
    two packages sum in different orders); map parameters within the
    drift two Adam runs can reach (2 * lr * steps) and 90% of them within
    2e-3 relative, as tests/test_torch_slice.py.
  * The 6-frame schedule, each package from frame 0 on its own: keyframe
    and cut decisions equal, poses within 1.5e-3 m / 1e-3, and the
    LocalMaps (kept frames, frame count, frozen poses, descriptors, map
    size to 0.1%: after drift a pixel of a densify test can sit at its
    threshold) alike. Drift compounds through mapping, and surfel orientation on the
    box's walls is decided by rounding in both map init and densify
    (ROADMAP queue 3): the packages part by 0.06 mm after one frame and
    0.76 mm by frame 5, while either one's error to the ground truth is
    18-34 mm on this short schedule.
  * The knobs the default config leaves off (tracking_refresh, the
    keyframe view by render_view, the host pose init) over three frames,
    and the dequantization of uint8 / uint16 frames.
"""
import os
import queue
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gaus_slam_tpu_torch import convert

H, W, N_FRAMES = 48, 64, 6
ENV = dict(SYN_H=str(H), SYN_W=str(W), SYN_MAX_FRAMES="3",
           SYN_TRACK_ITERS="8", SYN_MAP_ITERS="4", SYN_TAU_K="0.02")
CARRIED = {1: "tracked", 2: "keyframe", 3: "cut"}
CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs",
                      "synthetic", "config.py")
LRS = {"xyz": 0.0001, "log_scales": 0.001, "quats": 0.001,
       "opacity_logit": 0.05, "rgb": 0.0025}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(load, probe, ds):
    old = {k: os.environ.get(k) for k in ENV}
    os.environ.update(ENV)
    try:
        cfg = load(CONFIG)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    probe(cfg, ds[0][0], ds.intrinsics)
    cfg["tpu"]["frontend_capacity"] = 8192
    cfg["tpu"]["capacity_quantum"] = 4096
    return cfg


def _drain(q, into):
    while not q.empty():
        into.append(q.get())


def _frame_args(ds, t):
    c, d, _, c2w = ds[t]
    return t, np.asarray(c, np.float32) / np.float32(255), np.asarray(d), c2w


def _record(fe, lms):
    """What a frontend holds after a frame: its decisions and poses."""
    last = fe.local_frames[-1]
    cut = len(fe.local_frames) == 1 and lms
    tracked = lms[-1].frames[-1] if cut else last
    return SimpleNamespace(
        frame_type=0 if cut else last.frame_type,
        # the tracked pose of the frame (submap-relative after a cut)
        w2c=(tracked.est_w2c if cut else np.asarray(last._w2c_host)),
        n_active=int(fe.n_active_host), cur_lmid=fe.cur_lmid,
        rng=fe.rng.getstate(), vel=np.asarray(fe.vel), n_lms=len(lms),
        map=fe.map)


def _run(n_frames, carried=()):
    """Both frontends over frames 0 .. n_frames-1, then process_final;
    before each frame of ``carried`` a third, port frontend takes the JAX
    one's state and processes that frame alone."""
    from gaus_slam_tpu.data.synthetic import SyntheticDataset
    from gaus_slam_tpu.slam.frontend import Frontend as JFrontend
    from gaus_slam_tpu.utils.config import load_config, probe_cameras
    from gaus_slam_tpu_torch.slam.frontend import Frontend as TFrontend

    ds = SyntheticDataset(height=H, width=W, num_frames=60)
    cfg = _config(load_config, probe_cameras, ds)
    jq, tq = queue.Queue(), queue.Queue()
    jf = JFrontend(cfg, jq, backend="interpret")
    tf = TFrontend(cfg, tq, backend="interpret", device="cpu")
    jl, tl = [], []
    out = SimpleNamespace(jax=[], port=[], carried={}, jlms=jl, tlms=tl)
    for t in range(n_frames):
        args = _frame_args(ds, t)
        if t in carried:
            cq, clms = queue.Queue(), []
            cf = TFrontend(cfg, cq, backend="interpret", device="cpu")
            vars(cf).update(convert.frontend_state_from_jax(jf, "cpu"))
            cf.process_frame(*args)
            _drain(cq, clms)
            out.carried[t] = (_record(cf, clms), clms)
        jf.process_frame(*args)
        _drain(jq, jl)
        out.jax.append(_record(jf, list(jl)))
        tf.process_frame(*args)
        _drain(tq, tl)
        out.port.append(_record(tf, list(tl)))
    jf.process_final()
    tf.process_final()
    _drain(jq, jl)
    _drain(tq, tl)
    return out


@pytest.fixture(scope="module")
def runs():
    return _run(N_FRAMES, CARRIED)


def _assert_map_close(tgm, jgm, steps_bound):
    n = int(np.asarray(jgm.n_active))
    assert int(tgm.n_active) == n
    np.testing.assert_array_equal(tgm.active.numpy(), np.asarray(jgm.active))
    for f, lr in LRS.items():
        a = np.asarray(getattr(jgm.params, f))[:n]
        b = getattr(tgm.params, f).numpy()[:n]
        assert np.abs(a - b).max() <= 2 * lr * steps_bound, f
        rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-2)
        assert np.mean(rel > 2e-3) < 0.1, (f, np.mean(rel > 2e-3))


def _assert_lm_close(tlm, jlm, t_atol, r_atol, desc_atol=1e-5, n_tol=0.0):
    assert (tlm.lmid, tlm.saved_idxs, len(tlm.frames)) == \
        (jlm.lmid, jlm.saved_idxs, len(jlm.frames))
    np.testing.assert_allclose(tlm.map_desc, np.asarray(jlm.map_desc),
                               rtol=0, atol=desc_atol)
    for tfr, jfr in zip(tlm.frames, jlm.frames):
        assert (tfr.time_idx, tfr.frame_type, tfr.mapping_times) == \
            (jfr.time_idx, jfr.frame_type, jfr.mapping_times)
        assert (tfr.gt_color is None) == (jfr.gt_color is None)
        assert tfr.pose is None and jfr.pose is None
        np.testing.assert_allclose(tfr.est_w2c[:3, 3], jfr.est_w2c[:3, 3],
                                   rtol=0, atol=t_atol)
        np.testing.assert_allclose(tfr.est_w2c[:3, :3], jfr.est_w2c[:3, :3],
                                   rtol=0, atol=r_atol)
    np.testing.assert_allclose(tlm.ref2f0, jlm.ref2f0, rtol=0, atol=t_atol)
    n = int(np.asarray(jlm.map_params[2]))
    assert abs(int(tlm.map_params[2]) - n) <= n_tol * n


def test_schedule_has_each_kind_of_frame(runs):
    kinds = [r.frame_type for r in runs.jax]
    assert kinds[1:4] == [2, 1, 0], kinds        # tracked, keyframe, cut
    assert [r.n_lms for r in runs.jax][3] == 1


@pytest.mark.parametrize("t", sorted(CARRIED), ids=list(CARRIED.values()))
def test_one_frame_from_carried_state_matches_jax(runs, t):
    (c, clms), j = runs.carried[t], runs.jax[t]
    assert (c.frame_type, c.n_active, c.cur_lmid) == \
        (j.frame_type, j.n_active, j.cur_lmid)
    assert c.rng == j.rng                     # the same draws, in order
    np.testing.assert_allclose(c.w2c[:3, 3], j.w2c[:3, 3], rtol=0, atol=5e-5)
    np.testing.assert_allclose(c.w2c[:3, :3], j.w2c[:3, :3], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(c.vel, j.vel, rtol=0, atol=1e-4)
    # map steps taken in this frame: a keyframe's or a new submap's mapping
    _assert_map_close(c.map, j.map, steps_bound=4)
    if CARRIED[t] == "cut":
        (lm,) = clms
        _assert_lm_close(lm, runs.jlms[lm.lmid], 5e-5, 1e-4)
    else:
        assert clms == []


def check_schedule(runs, n_lms, t_atol=1.5e-3):
    for t, (tr, jr) in enumerate(zip(runs.port, runs.jax)):
        assert (tr.frame_type, tr.n_lms, tr.cur_lmid) == \
            (jr.frame_type, jr.n_lms, jr.cur_lmid), t
        np.testing.assert_allclose(tr.w2c[:3, 3], jr.w2c[:3, 3], rtol=0,
                                   atol=t_atol, err_msg=str(t))
        np.testing.assert_allclose(tr.w2c[:3, :3], jr.w2c[:3, :3], rtol=0,
                                   atol=1e-3, err_msg=str(t))
    assert len(runs.tlms) == len(runs.jlms) == n_lms
    for tlm, jlm in zip(runs.tlms, runs.jlms):
        _assert_lm_close(tlm, jlm, t_atol, 1e-3, desc_atol=1e-5,
                         n_tol=1e-3)
        assert all(np.isfinite(f.est_w2c).all() for f in tlm.frames)


def test_schedule_matches_jax(runs):
    check_schedule(runs, n_lms=2)


@pytest.mark.slow
def test_twelve_frames_match_jax():
    """The same schedule over 12 frames (4 submaps; ~40 s on the CPU),
    with the drift allowed to reach twice the 6-frame bound."""
    check_schedule(_run(12), n_lms=4, t_atol=3e-3)


def test_frontend_knobs_match_jax():
    """The other paths of tracking and the keyframe test, from carried
    state after frame 0: tracking_refresh (the coarse phase on the
    init-pose cache, then a re-bin), the keyframe view rendered by
    render_view (fused_kf_view off) and the host pose init
    (speculative_bin off), over frames 1-3 (tracked, keyframe, cut)."""
    from gaus_slam_tpu.data.synthetic import SyntheticDataset
    from gaus_slam_tpu.slam.frontend import Frontend as JFrontend
    from gaus_slam_tpu.utils.config import load_config, probe_cameras
    from gaus_slam_tpu_torch.slam.frontend import Frontend as TFrontend

    ds = SyntheticDataset(height=H, width=W, num_frames=60)
    cfg = _config(load_config, probe_cameras, ds)
    cfg["frontend"]["tracking_refresh"] = True
    cfg["tpu"].update(fused_kf_view=False, speculative_bin=False)
    jq, tq = queue.Queue(), queue.Queue()
    jf = JFrontend(cfg, jq, backend="interpret")
    jf.process_frame(*_frame_args(ds, 0))
    tf = TFrontend(cfg, tq, backend="interpret", device="cpu")
    vars(tf).update(convert.frontend_state_from_jax(jf, "cpu"))
    assert tf.tracking_refresh and not tf.fused_kf_view and tf._spec is None
    jl, tl = [], []
    for t in (1, 2, 3):
        jf.process_frame(*_frame_args(ds, t))
        tf.process_frame(*_frame_args(ds, t))
        _drain(jq, jl)
        _drain(tq, tl)
        j, c = _record(jf, list(jl)), _record(tf, list(tl))
        assert (c.frame_type, c.n_active, c.cur_lmid, c.rng) == \
            (j.frame_type, j.n_active, j.cur_lmid, j.rng), t
        # frame 1 starts from identical state (as the carried tests);
        # frames 2-3 follow a keyframe, whose densify drifts by rounding
        np.testing.assert_allclose(c.w2c[:3, 3], j.w2c[:3, 3], rtol=0,
                                   atol=5e-5 if t == 1 else 5e-4,
                                   err_msg=str(t))
    assert j.frame_type == 0 and len(tl) == len(jl) == 1


def test_frame_dequantizes_like_jax():
    """uint8 colour and uint16 depth go through the same float32
    multiplies as the JAX frontend's on-device dequant."""
    import jax.numpy as jnp

    from gaus_slam_tpu.slam.frontend import _dequant_rgbd
    from gaus_slam_tpu_torch.slam.frontend import _to_device

    rng = np.random.default_rng(0)
    c8 = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    d16 = rng.integers(0, 65536, (H, W), dtype=np.uint16)
    jc, jd = _dequant_rgbd(jnp.asarray(c8), jnp.asarray(d16))
    np.testing.assert_array_equal(_to_device(c8, "cpu").numpy(), np.asarray(jc))
    np.testing.assert_array_equal(_to_device(d16, "cpu").numpy(),
                                  np.asarray(jd))
    np.testing.assert_array_equal(
        _to_device(torch.from_numpy(c8), "cpu").numpy(), np.asarray(jc))
