"""The port's keyframe-parallel BA and backend placement (parallel/,
slam/backend.py) against the JAX package's (parallel/, tests/
test_parallel.py), on the CPU.

  * devices_from_config takes every value mesh_from_config takes, with an
    injected device count; the backend_device resolution covers each
    branch on one and on two cards, and on the CPU.
  * sharded_ba_step over [cpu] * 8 against the JAX package's on
    make_mesh(8) (conftest's 8 virtual devices, interpret mode), on
    tests/test_parallel.py's inputs: the step's loss to rtol 3e-3, the
    tolerance the JAX test itself gives (interpret-mode Pallas output
    differs at the 1e-3 level between differently fused programs); each
    shard's loss against the JAX _ba_loss of that keyframe run eagerly,
    to 1e-5; the stepped map by the JAX test's criteria (each change
    within 2 * lr, direction cosine > 0.95 on xyz, rgb and opacity); the
    port's sharded step against its own sequential mean-gradient step to
    1e-6 of each field's scale, a group with zero-weight slots too.
  * The Backend with devices=[cpu] * 8 (after tests/test_parallel.py::
    test_backend_uses_sharded_ba_on_mesh) against the JAX Backend on
    make_mesh(8), both fed the same donor maps through convert.py (the
    frontend's densify rounding would otherwise part them: ROADMAP queue
    3): the same schedule, mapping counts and n_active; the maps'
    median row within MEDIAN_STEPS_APART and their first moments within
    M_REL_L2 of each other (see there, with the readings of three
    planted faults).
  * On a host with two cards or more (marked cuda, skipped here): the
    sharded step and a Backend's group across the cards bit-equal to
    the same over slots of one card, a Backend with its map on cuda:1
    bit-equal to a colocated one, and both drivers end to end at 340x600
    with the map on cuda:1 (gaus_mp also resumed there) or the BA over
    every card, within the chip smoke's quality bounds.
"""
import os
import random

import numpy as np
import pytest
import torch

from gaus_slam_tpu_torch import convert

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs",
                      "synthetic", "config.py")
LRS = (("opacity_lr", 5e-2), ("rgb_lr", 2.5e-3), ("rotation_lr", 1e-3),
       ("scaling_lr", 1e-3), ("xyz_lr", 1e-4))
N_DEV = 8


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the knobs


def test_devices_from_config_knob(monkeypatch):
    """Every case of test_parallel.py::test_mesh_from_config_knob, with the
    device count injected: "auto" takes every attached device, an int
    pins the count, off / 0 / 1 give no group, more than attached raises;
    the Backend sizes its groups by the list."""
    from gaus_slam_tpu_torch.parallel import devices_from_config
    from gaus_slam_tpu_torch.slam.backend import Backend

    cpu = torch.device("cpu")
    for md in ("off", 0, 1, "0", "1", None, False):
        assert devices_from_config({"tpu": {"mesh_devices": md}}, cpu,
                                   n_avail=8) is None
    assert devices_from_config({"tpu": {}}, cpu, n_avail=8) == [cpu] * 8
    assert devices_from_config({"tpu": {}}, cpu) is None  # one CPU
    assert devices_from_config({"tpu": {"mesh_devices": 4}}, cpu,
                               n_avail=8) == [cpu] * 4
    assert devices_from_config({"tpu": {"mesh_devices": "2"}}, "cuda",
                               n_avail=2) == [torch.device("cuda", 0),
                                              torch.device("cuda", 1)]
    assert devices_from_config({"tpu": {}}, "cuda", n_avail=1) is None
    with pytest.raises(ValueError, match="devices attached"):
        devices_from_config({"tpu": {"mesh_devices": 64}}, cpu, n_avail=8)

    monkeypatch.setenv("SYN_H", "48")
    monkeypatch.setenv("SYN_W", "64")
    from gaus_slam_tpu_torch.utils.config import load_config

    config = load_config(CONFIG)
    config["cameras"].update(height=48, width=64,
                             intrinsics=np.eye(3).tolist())
    be = Backend(config, backend="interpret", device="cpu",
                 devices=[cpu] * 4)
    assert be.ba_group == 4 and be.stream is None
    assert Backend(config, backend="interpret", device="cpu").ba_group == 1


CUDA0, CUDA1, CPU = (torch.device("cuda", 0), torch.device("cuda", 1),
                     torch.device("cpu"))


@pytest.mark.parametrize("bd,group,dev,n,want", [
    # "off": the frontend's device and stream
    ("off", 1, CUDA0, 1, (CUDA0, False, None)),
    ("", 1, CUDA0, 2, (CUDA0, False, None)),
    ("off", 4, CUDA0, 4, (CUDA0, False, None)),
    # a BA group owns placement
    ("auto", 4, CUDA0, 4, (CUDA0, False, "BA group owns")),
    ("1", 2, CUDA0, 2, (CUDA0, False, "BA group owns")),
    # "auto": a second card, else a stream of its own on the one card
    ("auto", 1, CUDA0, 1, (CUDA0, True, None)),
    ("auto", 1, CUDA0, 2, (CUDA1, True, "placed on cuda:1")),
    # an index: that card, or ignored past the count
    ("1", 1, CUDA0, 2, (CUDA1, True, "placed on cuda:1")),
    ("0", 1, CUDA0, 1, (CUDA0, True, "placed on cuda:0")),
    ("1", 1, CUDA0, 1, (CUDA0, False, "ignored: only 1")),
    ("2", 1, CUDA0, 2, (CUDA0, False, "ignored: only 2")),
    # the CPU: always colocated, no stream
    ("auto", 1, CPU, 1, (CPU, False, None)),
    ("0", 1, CPU, 1, (CPU, False, None)),
    ("1", 1, CPU, 1, (CPU, False, "ignored: only 1")),
])
def test_backend_placement(bd, group, dev, n, want):
    """tpu.backend_device resolves as the JAX Backend does (backend.py:
    56-88), with "auto" on one card meaning a stream of the backend's
    own."""
    from gaus_slam_tpu_torch.slam.backend import resolve_placement

    got_dev, stream, note = resolve_placement(bd, group, dev, n)
    assert (got_dev, stream) == want[:2]
    if want[2] is None:
        assert note is None
    else:
        assert want[2] in note


# ---------------------------------------------------------------------------
# sharded_ba_step on tests/test_parallel.py's inputs


@pytest.fixture(scope="module")
def ba_case():
    """test_parallel.py's inputs through the JAX sharded step and the JAX
    _ba_loss of each keyframe (eager), with the port's counterparts."""
    import jax
    import jax.numpy as jnp

    from gaus_slam_tpu.models import gaussians as JG
    from gaus_slam_tpu.ops.binning import make_grid as j_grid
    from gaus_slam_tpu.ops.camera import Camera as JCam
    from gaus_slam_tpu.ops.composite_ref import image_to_tiles
    from gaus_slam_tpu.parallel import make_mesh, sharded_ba_step
    from gaus_slam_tpu.parallel.ba import _ba_loss
    from gaus_slam_tpu.render import RenderOptions as JOpts
    from gaus_slam_tpu.slam.loss import LossConfig as JLoss
    from gaus_slam_tpu.slam.steps import MapConfig as JMap
    from gaus_slam_tpu_torch.ops.binning import make_grid as t_grid
    from gaus_slam_tpu_torch.ops.camera import Camera as TCam
    from gaus_slam_tpu_torch.render import RenderOptions as TOpts
    from gaus_slam_tpu_torch.slam.loss import LossConfig as TLoss
    from gaus_slam_tpu_torch.slam.steps import MapConfig as TMap

    assert len(jax.devices()) == N_DEV
    jcam = JCam(32, 32, 40.0, 40.0, 16.0, 16.0, jnp.eye(4))
    jopts = JOpts(grid=j_grid(jcam, 16, 16), backend="interpret",
                  pair_budget_factor=8)
    rng = np.random.default_rng(0)
    n = 48
    z = rng.uniform(1, 3, n).astype(np.float32)
    xyz = np.stack([
        (rng.uniform(8, 24, n) - 16) * z / 40.0,
        (rng.uniform(8, 24, n) - 16) * z / 40.0, z], -1).astype(np.float32)
    jgm = JG.add_gaussians(
        JG.empty_map(64), jnp.asarray(xyz),
        jnp.asarray(rng.uniform(0, 1, (n, 3))), None, jnp.asarray(z / 40.0))
    w2cs = np.tile(np.eye(4, dtype=np.float32), (N_DEV, 1, 1))
    gt_imgs = jnp.asarray(rng.uniform(0, 1, (N_DEV, 4, 32, 32)), jnp.float32)
    gt = np.asarray(jnp.stack([image_to_tiles(g, jopts.grid)
                               for g in gt_imgs]))
    jstep, jloss, _ = sharded_ba_step(
        make_mesh(N_DEV), jgm, jnp.asarray(w2cs), jnp.asarray(gt), jcam,
        jopts, JMap(lrs=LRS), JLoss())
    eager = np.asarray([float(_ba_loss(jgm.params, jgm.active,
                                       jnp.asarray(w2cs[i]),
                                       jnp.asarray(gt[i]), jcam, jopts,
                                       JLoss())[0]) for i in range(N_DEV)])
    tcam = TCam(32, 32, 40.0, 40.0, 16.0, 16.0, torch.eye(4))
    port = dict(gm=convert.gaussian_map_from_numpy(jgm, "cpu"), cam=tcam,
                opts=TOpts(grid=t_grid(tcam, 16, 16), backend="interpret",
                           pair_budget_factor=8),
                mcfg=TMap(lrs=LRS), lcfg=TLoss(),
                w2cs=torch.as_tensor(w2cs), gt=torch.tensor(gt))
    return dict(port=port, j_map=convert.gaussian_map_from_numpy(jstep, "cpu"),
                j_loss=float(jloss), j_eager=eager)


def _sharded(p, weights=None):
    from gaus_slam_tpu_torch.parallel import make_devices, sharded_ba_step

    return sharded_ba_step(make_devices(N_DEV, "cpu"), p["gm"], p["w2cs"],
                           p["gt"], p["cam"], p["opts"], p["mcfg"], p["lcfg"],
                           weights=weights)


def _sequential(p, keyframes):
    """The mean-gradient step the sharded one stands for: each keyframe's
    loss through render_full and mapping_loss, its gradients accumulated
    in .grad, then one Adam step."""
    from gaus_slam_tpu_torch.models import gaussians as G
    from gaus_slam_tpu_torch.render import render_full
    from gaus_slam_tpu_torch.slam.loss import mapping_loss

    gm = p["gm"]
    params = [t.detach().clone().requires_grad_() for t in gm.params]
    total = 0.0
    for k in keyframes:
        out, _ = render_full(G.Params(*params), gm.active,
                             p["cam"].replace_w2c(p["w2cs"][k]), p["opts"],
                             need_normal=p["opts"].normals_in_tracking)
        loss = mapping_loss(out, p["gt"][k], p["lcfg"])[0]
        loss.backward()
        total += float(loss.detach())
    grads = G.Params(*(t.grad / len(keyframes) for t in params))
    return (G.adam_step(gm, grads, dict(p["mcfg"].lrs), p["mcfg"].betas,
                        p["mcfg"].eps), total / len(keyframes))


def _assert_maps_close(a, b, tol=1e-6):
    for f, x, y in zip(a.params._fields, a.params, b.params):
        scale = max(float(y.abs().max()), 1e-30)
        assert float((x - y).abs().max()) <= tol * scale, f


def test_sharded_ba_loss_matches_jax(ba_case):
    p = ba_case["port"]
    _, loss, diag = _sharded(p)
    np.testing.assert_allclose(float(loss), ba_case["j_loss"], rtol=3e-3)
    # each shard against the JAX loss of its keyframe, run eagerly
    np.testing.assert_allclose(diag["losses"].numpy(), ba_case["j_eager"],
                               rtol=1e-5)
    assert not bool(diag["overflow"]) and int(diag["n_shrunk"]) >= 0


def test_sharded_ba_step_matches_jax(ba_case):
    """The JAX test's criteria between the port's stepped map and the JAX
    one: post-Adam changes are sign-like, so their size is bounded and
    their direction compared on the well-conditioned fields."""
    from gaus_slam_tpu_torch.models import gaussians as G

    p = ba_case["port"]
    gm, _, _ = _sharded(p)
    lrs = dict(LRS)
    for f, a, b, p0 in zip(G.PARAM_FIELDS, gm.params, ba_case["j_map"].params,
                           p["gm"].params):
        da = (a - p0).numpy().ravel()
        db = (b - p0).numpy().ravel()
        assert np.isfinite(da).all()
        assert np.abs(da).max() <= 2.0 * lrs[G.LR_KEYS[f]] + 1e-8, f
        if f in ("xyz", "rgb", "opacity_logit"):
            denom = np.linalg.norm(da) * np.linalg.norm(db)
            if denom > 1e-12:
                assert float(np.dot(da, db) / denom) > 0.95, f


@pytest.mark.parametrize("weights", [None, [1, 1, 1, 0, 0, 0, 0, 0]])
def test_sharded_ba_matches_sequential_step(ba_case, weights):
    """The sharded step against the port's sequential mean-gradient step
    over its live keyframes; zero-weight slots drop out of the mean."""
    p = ba_case["port"]
    live = [k for k in range(N_DEV) if weights is None or weights[k]]
    gm, loss, diag = _sharded(p, weights)
    seq, seq_loss = _sequential(p, live)
    np.testing.assert_allclose(float(loss), seq_loss, rtol=1e-6)
    _assert_maps_close(gm, seq)
    assert gm.step == seq.step == p["gm"].step + 1
    if weights is not None:
        np.testing.assert_allclose(float(loss), ba_case["j_eager"][live].mean(),
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# the Backend's mesh path

# Tolerances of the two Backends' maps after the two merges. A post-Adam
# change is lr-sized whatever its gradient's size, so a rounding
# difference (interpret-mode Pallas against the plain PyTorch versions)
# on a near-zero gradient can flip a row's step: single rows part by up
# to 4.4 lr after 6 sharded steps, a planted fault's by 3.0-9.4 lr, so
# the largest row tells little. The median row tells them apart. Readings (on the CPU, per field over
# xyz / log_scales / quats / opacity_logit / rgb), median |port - JAX|
# in lr: this code 0.0016-0.0050; the padded slots' zero weights ignored
# 0.0133-0.0230; one live shard given zero weight 0.032-0.057; the
# weighted sum in place of the mean 0.31-0.43. Adam is close to blind to
# a gradient's scale, so the first moments are held too: relative L2 of
# m, this code 0.017-0.048, the sum 4.19-4.40.
MEDIAN_STEPS_APART = 0.008
M_REL_L2 = 0.2


def test_backend_mesh_matches_jax(tmp_path, monkeypatch):
    """Two merges through a Backend with an 8-device BA group in both
    packages, from the same donor submaps."""
    import jax.numpy as jnp

    from gaus_slam_tpu.data import get_dataset
    from gaus_slam_tpu.models import gaussians as JG
    from gaus_slam_tpu.models.frame import Frame
    from gaus_slam_tpu.models.submap import LocalMap
    from gaus_slam_tpu.parallel import make_mesh
    from gaus_slam_tpu.slam.backend import Backend as JBackend
    from gaus_slam_tpu.slam.init_map import initialize_map
    from gaus_slam_tpu.utils.config import load_config, probe_cameras
    from gaus_slam_tpu_torch.parallel import make_devices
    from gaus_slam_tpu_torch.slam.backend import Backend as TBackend

    # 11 backend iterations per block of tasks: a full group of 8, then 3
    # live keyframes padded with 5 zero-weight slots (which repeat the
    # live ones unevenly, so ignoring the weights would show)
    for k, v in dict(SYN_H="32", SYN_W="32", SYN_FRAMES="8",
                     SYN_BA_ITERS="11").items():
        monkeypatch.setenv(k, v)
    config = load_config(CONFIG)
    config["vis_base_dir"] = str(tmp_path)
    # the 32x32 camera's init scales exceed the profile's scale_max prune
    # bound (as in tests/test_parallel.py)
    config["densify"]["scale_max"] = 1.0
    dataset = get_dataset(config["data"])
    color0, _, intrinsics, _ = dataset[0]
    probe_cameras(config, color0, intrinsics)

    jb = JBackend(config, backend="interpret", mesh=make_mesh(N_DEV))
    tb = TBackend(config, backend="interpret", device="cpu",
                  devices=make_devices(N_DEV, "cpu"))
    assert jb.ba_group == tb.ba_group == N_DEV
    rng = random.Random(0)

    def make_lm(lmid, idxs):
        frames = []
        for t in idxs:
            color, depth, _, c2w = dataset[t]
            fr = Frame(time_idx=t, gt_color=jnp.asarray(color) / 255.0,
                       gt_depth=jnp.asarray(depth),
                       gt_w2c=np.linalg.inv(np.asarray(c2w)), kfid=lmid)
            fr.start_optimizer(fr.gt_w2c, enable_exposure=False)
            frames.append(fr)
        gm = initialize_map(4096, frames[0].gt_color, frames[0].gt_depth,
                            jnp.asarray(frames[0].gt_w2c), jb.sys.cam)
        return LocalMap.cut(lmid, frames, JG.extract_params(gm), 2, rng=rng)

    for lmid, idxs in ((0, [0, 1, 2, 3]), (1, [4, 5, 6, 7])):
        jlm = make_lm(lmid, idxs)
        tb.process_localmap(convert.localmap_from_jax(jlm, "cpu"))
        jb.process_localmap(jlm)
        if lmid == 0:
            # every task entry counts, also when grouped
            assert (tb.local_maps[0].mapping_times
                    == jb.local_maps[0].mapping_times == tb.num_ba_iters)
        assert tb.rng.getstate() == jb.rng.getstate()
        assert tb.ba_group_calls == jb.ba_group_calls
        assert int(tb.map.n_active) == int(jb.map.n_active)
        assert tb.map.capacity == jb.map.capacity

    # 11 mapping tasks per block at group size 8: 2 calls each
    assert tb.ba_group_calls >= 6
    assert [lm.mapping_times for lm in tb.local_maps] == \
        [lm.mapping_times for lm in jb.local_maps]
    from gaus_slam_tpu_torch.models.gaussians import LR_KEYS

    jmap = convert.gaussian_map_from_numpy(jb.map, "cpu")
    assert torch.equal(tb.map.active, jmap.active)
    lrs = dict(tb.sys.mcfg.lrs)
    act = tb.map.active
    for f, a, b, ma, mb in zip(tb.map.params._fields, tb.map.params,
                               jmap.params, tb.map.m, jmap.m):
        assert torch.isfinite(a).all(), f
        d = (a - b).abs()[act] / lrs[LR_KEYS[f]]
        assert float(d.median()) <= MEDIAN_STEPS_APART, (f, float(d.median()))
        rel = float((ma - mb)[act].norm() / mb[act].norm())
        assert rel <= M_REL_L2, (f, rel)


# ---------------------------------------------------------------------------
# across cards: two or more, on configs/synthetic/config.py at 340x600
# (skipped on a host with fewer)

H_FULL, W_FULL = 340, 600
# the chip smoke's bounds at 340x600 (phases 6 and 10c): ATE under twice
# the JAX system's 5.5 mm, first-submap PSNR over 35 dB
ATE_MAX, PSNR_MIN = 0.011, 35.0


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _full_config(out, **env):
    """configs/synthetic/config.py at 340x600 with ``env`` (placement
    off unless given), output under ``out``, random_process off, cameras
    probed; the process environment is left as it was."""
    from gaus_slam_tpu_torch.data import get_dataset
    from gaus_slam_tpu_torch.utils.config import load_config, probe_cameras

    env = dict(dict(SYN_H=str(H_FULL), SYN_W=str(W_FULL), SYN_OUT=str(out),
                    MESH_DEVICES="off", BACKEND_DEVICE="off"), **env)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        config = load_config(CONFIG)
    config["backend"]["random_process"] = False
    dataset = get_dataset(config["data"])
    color0, _, intrinsics, _ = dataset[0]
    probe_cameras(config, color0, intrinsics)
    return config, dataset


@pytest.fixture(scope="module")
def full_localmaps(tmp_path_factory):
    """A Frontend's first two cuts (frames 0-20) at 340x600 on cuda:0."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    import queue

    from gaus_slam_tpu_torch.slam.frontend import Frontend

    config, dataset = _full_config(tmp_path_factory.mktemp("lms"))
    to_backend = queue.Queue()
    fe = Frontend(config, to_backend, device=torch.device("cuda", 0))
    lms = []
    for t in range(21):
        color, depth, _, c2w = dataset[t]
        fe.process_frame(t, np.asarray(color, np.float32) / np.float32(255),
                         np.asarray(depth), c2w)
        while not to_backend.empty():
            lms.append(to_backend.get())
    assert len(lms) == 2
    return config, dataset, lms


def _bit_equal(a: dict, b: dict) -> list:
    """The checkpoint paths whose arrays differ."""
    assert a.keys() == b.keys()
    return [k for k in a if not np.array_equal(a[k], b[k], equal_nan=True)]


@pytest.mark.cuda
def test_sharded_ba_across_cards(cards, full_localmaps):
    """sharded_ba_step over cuda:0 .. cuda:n-1 against the same step over
    n slots of cuda:0: the same renders and the same fixed-order
    reduction, so the two agree to the bit."""
    from gaus_slam_tpu_torch.ops.composite_ref import frame_to_tiles
    from gaus_slam_tpu_torch.parallel import sharded_ba_step
    from gaus_slam_tpu_torch.slam.init_map import initialize_map
    from gaus_slam_tpu_torch.utils.config import SystemConfig

    config, dataset, _ = full_localmaps
    dev = cards[0]
    s = SystemConfig.from_config(config, device=dev)

    def frame(t):
        color, depth, _, c2w = dataset[t]
        depth = np.asarray(depth)
        depth = depth[..., 0] if depth.ndim == 3 else depth
        return (torch.as_tensor(color / 255.0, dtype=torch.float32,
                                device=dev),
                torch.as_tensor(depth, dtype=torch.float32, device=dev),
                np.asarray(c2w))

    color0, depth0, c2w0 = frame(0)
    gm = initialize_map(int(config["tpu"]["frontend_capacity"]), color0,
                        depth0, torch.eye(4, device=dev), s.cam)
    w2cs, gts = [], []
    for t in range(len(cards)):
        color, depth, c2w = frame(t)
        w2cs.append(torch.as_tensor(
            (np.linalg.inv(c2w) @ c2w0).astype(np.float32), device=dev))
        gts.append(frame_to_tiles(color, depth, s.opts.grid))
    w2cs, gts = torch.stack(w2cs), torch.stack(gts)
    got = {}
    for name, devs in (("cards", cards), ("slots", [dev] * len(cards))):
        stepped, loss, diag = sharded_ba_step(devs, gm, w2cs, gts, s.cam,
                                              s.opts, s.mcfg, s.lcfg)
        got[name] = ([t.cpu() for t in stepped.params], float(loss),
                     diag["losses"].cpu())
    assert np.isfinite(got["cards"][1])
    assert got["cards"][1] == got["slots"][1]
    assert torch.equal(got["cards"][2], got["slots"][2])
    for f, a, b in zip(gm.params._fields, got["cards"][0], got["slots"][0]):
        assert torch.equal(a, b), f


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["backend_device auto", "BA group"])
def test_backend_across_cards(cards, full_localmaps, placement):
    """Two merges of the same LocalMaps: a Backend with its map on cuda:1
    (backend_device "auto") against one on the frontend's stream, and one
    whose BA group is every card against one whose group is as many slots
    of cuda:0; each pair bit-equal, map, Adam moments and transforms."""
    import copy

    from gaus_slam_tpu_torch.slam.backend import Backend
    from gaus_slam_tpu_torch.utils.checkpoint import backend_state_arrays

    config, _, lms = full_localmaps
    if placement == "BA group":
        runs = (("off", cards), ("off", [cards[0]] * len(cards)))
    else:
        runs = (("auto", None), ("off", None))
    state, backends = [], []
    for bd, devs in runs:
        c = copy.deepcopy(config)
        c["tpu"]["backend_device"] = bd
        be = Backend(c, device=cards[0], devices=devs)
        for lm in copy.deepcopy(lms):
            be.process_localmap(lm)
        state.append(backend_state_arrays(be))
        backends.append(be)
    be = backends[0]
    if placement == "BA group":
        assert be.ba_group == len(cards) and be.ba_group_calls > 0
    else:
        assert be.map.params.xyz.device == cards[1]
        assert be.stream is not None and be.stream.device == cards[1]
    assert np.isfinite(state[0]["backend_map/params/xyz"]).all()
    assert _bit_equal(*state) == []


@pytest.mark.cuda
@pytest.mark.parametrize("driver,env", [
    ("gaus", dict(BACKEND_DEVICE="auto")),
    ("gaus_mp", dict(BACKEND_DEVICE="auto")),
    ("gaus_mp", dict(MESH_DEVICES="auto")),
], ids=["gaus-map on cuda:1", "gaus_mp-map on cuda:1",
        "gaus_mp-BA group over every card"])
def test_driver_across_cards(cards, tmp_path, monkeypatch, driver, env):
    """A driver end to end at 340x600 x 30 with the backend's map on the
    second card, or its BA over every card: the frames stay on cuda:0,
    the evaluation reads the backend's map there, and the run holds the
    chip smoke's ATE and first-submap PSNR bounds. The map-on-cuda:1
    pipelined run also checkpoints every merge and is resumed from the
    first, on the second card again."""
    import importlib
    import shutil

    from gaus_slam_tpu_torch.slam.backend import Backend
    from gaus_slam_tpu_torch.utils import checkpoint as C

    mod = importlib.import_module(f"gaus_slam_tpu_torch.scripts.{driver}")
    on_card1 = env.get("BACKEND_DEVICE") == "auto"
    resume = driver == "gaus_mp" and on_card1
    seen = []
    merge = Backend.process_localmap

    def spy(be, lm, *a, **kw):
        seen.append((be, [f.time_idx for f in lm.frames]))
        return merge(be, lm, *a, **kw)

    monkeypatch.setattr(Backend, "process_localmap", spy)
    first_ckpt = tmp_path / "first_ckpt"
    if resume:
        save = C.save_run_state

        def keep_first(path, *a, **kw):
            save(path, *a, **kw)
            if not first_ckpt.exists():
                shutil.copytree(path, first_ckpt)

        monkeypatch.setattr(C, "save_run_state", keep_first)

    def run(out, resume_from=None):
        seen.clear()
        config, _ = _full_config(out, **env)
        config["backend"]["save_ckpt"] = resume
        result = mod.rgbd_slam(config, backend="pallas", device="cuda:0",
                               resume_from=resume_from)
        be = seen[0][0]
        if on_card1:
            assert be.map.params.xyz.device == cards[1]
        else:
            assert be.ba_group == len(cards) and be.ba_group_calls > 0
        for name in ("result.json", "time.json", "scene/gaussians.ply"):
            assert (out / name).exists(), name
        return result, seen[0][1]

    result, frames = run(tmp_path / "run")
    psnrs = np.loadtxt(tmp_path / "run" / "psnr.txt")
    first = psnrs[frames[0]:frames[-1]]
    print(f"[{driver}, {env}] ATE RMSE {result['ATE RMSE']}, PSNR over "
          f"the first submap's frames {first.mean()}")
    assert result["ATE RMSE"] < ATE_MAX
    assert len(first) and first.mean() > PSNR_MIN
    if resume:
        resumed, frames = run(tmp_path / "resumed", str(first_ckpt))
        print(f"[{driver}, {env}, resumed] ATE RMSE {resumed['ATE RMSE']}")
        assert frames[0] > 0     # it went on from the second submap
        assert resumed["ATE RMSE"] < ATE_MAX
        assert np.isfinite(resumed["PSNR"])
