"""The port's captured steps (slam/programs.py), the counterpart of the
JAX package's jitted steps.

* Each program, called N times through ``programs`` (its static-buffer
  body, built once per key and then called with no arguments, the map
  stepped in place), equals N calls under ``programs.eager()`` bit for
  bit: ``tracking_loop`` with an early stop at lags 0-2, with and without
  the view and the next frame's prediction; ``mapping_step`` with the
  exposure stepping and not; ``mapping_loop`` dense and at coarse stride
  3 with a rotating phase; ``backend_tracking_step``; ``ba_step``.
* The same runs match the JAX package at test_torch_steps.py's
  tolerances (poses to 5e-5, losses to 1e-4 relative, the exposure to
  1e-6 a step, map parameters within 2 * lr a step), all under the
  reference render backend at 32x32, capacity 1024; the device step
  counters are int32 scalars equal to JAX's.
* The bias-correction and learning-rate tables the steps index equal
  the host arithmetic the steps used before (bit for bit, steps 1..N and
  past the saturation), and so does a division by their entries.
* A copy of the map held across a step is unchanged by it; a second
  call of a key reuses its program; a capacity change makes a new one
  and drops the old.
Their ``cuda`` counterpart (real graphs on a card) is
tests/test_torch_programs_cuda.py, which imports no JAX.
"""
import numpy as np
import pytest
import torch

from gaus_slam_tpu_torch.slam import programs
from test_torch_frontend import _assert_map_close
from test_torch_programs_cuda import (CHAINS, LRS, N, TRACK_ITERS,
                                      TRACK_LR, TRACK_TH, TRACKS,
                                      assert_bit_equal, both, port_scene,
                                      targets, track, track_run)
from test_torch_steps import _tiny_scene

@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_scene():
    """The 32x32 tiny scene of test_torch_steps.py (capacity 1024): frames
    1-3 as targets at their ground-truth poses relative to frame 0."""
    ds, jcam, jgm = _tiny_scene()
    return dict(ds=ds, hw=(jcam.height, jcam.width), jcam=jcam, jgm=jgm,
                gm=jgm, **targets(ds))


@pytest.fixture(scope="module")
def scene(jax_scene):
    return port_scene(jax_scene, "cpu")


@pytest.mark.parametrize("name", list(CHAINS))
def test_program_equals_eager(scene, name):
    got, want, own = both(lambda own: CHAINS[name](scene, own))
    assert_bit_equal(got, want)
    # one program per key (an argument's layout is part of it), reused by
    # every later call: the chain again adds none and gives the same bits
    n = len(own.programs)
    assert 1 <= n <= N
    assert_bit_equal(programs._clone(CHAINS[name](scene, own)), want)
    assert len(own.programs) == n


@pytest.fixture(scope="module")
def eager_tracks(scene):
    """The eager loop's results with and without the view and the
    prediction (the lag moves none of them: test_torch_device_branch.py)."""
    with programs.eager():
        return {view: track_run(scene, 1, view)(None) for view in (False,
                                                                   True)}


@pytest.mark.parametrize("lag,view", TRACKS)
def test_tracking_program_equals_eager(scene, eager_tracks, lag, view):
    own = programs.Owner("test")
    got = programs._clone(track_run(scene, lag, view)(own))
    assert_bit_equal(got, eager_tracks[view])
    assert got[1]["iters"] < scene["tcfg"].num_iters    # stopped early
    assert got[0].step.dtype == torch.int32
    assert int(got[0].step) == int(got[1]["iters"])
    # an iteration program per ring slot (the first iteration's inputs,
    # laid out as the caller made them, one more) and the tail; the loop
    # again adds none and gives the same bits
    n = len(own.programs)
    assert n <= min(lag + 1, int(got[1]["iters"])) + 2
    assert_bit_equal(programs._clone(track_run(scene, lag, view)(own)),
                     eager_tracks[view])
    assert len(own.programs) == n


# ---------------------------------------------------------------------------
# against the JAX package


# the JAX chains' lengths: one call of a mapping program (the map
# tolerances are one step's), N of the backend tracking step
JAX_CALLS = {"mapping_step exposure on": 1, "mapping_step exposure off": 1,
             "mapping_loop dense": 1, "backend_tracking_step": N,
             "ba_step": 1}
# one JAX compile (~25 s on the CPU) serves both of these; the other
# chains' (~30 s each) run in the slow test
FAST = ("mapping_step exposure on", "mapping_step exposure off")


def _jax_inputs(jax_scene):
    import jax.numpy as jnp

    from gaus_slam_tpu.models.frame import LrSchedule as JLr
    from gaus_slam_tpu.ops import binning as JB
    from gaus_slam_tpu.ops.composite_ref import frame_to_tiles as j_tiles
    from gaus_slam_tpu.render import RenderOptions as JOpts
    from gaus_slam_tpu.slam import steps as JS
    from gaus_slam_tpu.slam.loss import LossConfig as JLoss

    jcam = jax_scene["jcam"]
    jo = JOpts(grid=JB.make_grid(jcam, 16, 16), **jax_scene["kw"])
    gts = jnp.stack([j_tiles(jnp.asarray(c), jnp.asarray(d), jo.grid)
                     for c, d in jax_scene["frames"]])
    return dict(jcam=jcam, jgm=jax_scene["jgm"], jo=jo, gts=gts,
                w2cs=jnp.asarray(np.stack(jax_scene["w2cs"])),
                mcfg=JS.MapConfig(lrs=LRS), lexp=JLoss(enable_exposure=True),
                exp_sched=JLr(0.005, 0.0001, 60))


@pytest.fixture(scope="module")
def jax_runs(jax_scene):
    """The JAX package's mapping_step (reference backend), its exposure
    stepping and not: one compile (the flag is traced)."""
    import jax.numpy as jnp

    from gaus_slam_tpu.models.frame import init_exposure as j_exp
    from gaus_slam_tpu.slam import steps as JS

    j = _jax_inputs(jax_scene)
    return {f"mapping_step exposure {'on' if on else 'off'}": JS.mapping_step(
        j["jgm"], j["w2cs"][0], j["gts"][0], j_exp(), jnp.bool_(on),
        j["exp_sched"], j["jcam"], j["jo"], j["mcfg"], j["lexp"])
        for on in (True, False)}


@pytest.fixture(scope="module")
def jax_runs_slow(jax_scene):
    """The JAX package's side of the other chains (reference backend):
    one compile each of tracking_loop, mapping_loop, backend_tracking_step
    and ba_step."""
    import jax.numpy as jnp

    from gaus_slam_tpu.models.frame import LrSchedule as JLr
    from gaus_slam_tpu.models.frame import init_exposure as j_exp
    from gaus_slam_tpu.models.frame import init_pose as j_pose
    from gaus_slam_tpu.render import bin_for_tracking as j_bin
    from gaus_slam_tpu.slam import steps as JS
    from gaus_slam_tpu.slam.loss import LossConfig as JLoss

    j = _jax_inputs(jax_scene)
    jcam, jgm, jo, gts, w2cs = (j[k] for k in ("jcam", "jgm", "jo", "gts",
                                               "w2cs"))
    r0, r1, t0, t1 = TRACK_LR
    tcfg = JS.TrackConfig(num_iters=TRACK_ITERS, converged_th=TRACK_TH,
                          rot_sched=JLr(r0, r1, TRACK_ITERS),
                          trans_sched=JLr(t0, t1, TRACK_ITERS))
    tback = JS.TrackConfig(num_iters=1, converged_th=-1.0,
                           rot_sched=JLr(r0, r1, 40),
                           trans_sched=JLr(t0, t1, 40))
    pose0 = j_pose(jax_scene["w2cs"][1])
    out = {}
    cache = j_bin(jgm, jcam.replace_w2c(pose0.w2c), jo)
    out["tracking_loop"] = JS.tracking_loop(
        cache, pose0, gts[1], jcam, jo, tcfg, JLoss(), want_view=True,
        prev_pose=pose0, predict=True)
    # one group: the map tolerances are one step's
    out["mapping_loop dense"] = JS.mapping_loop(
        jgm, w2cs[:1], gts[:1], jcam, jo, j["mcfg"], JLoss(),
        coarse_stride=1, phase0=jnp.int32(0))
    p = pose0
    for _ in range(N):
        p, aux = JS.backend_tracking_step(jgm, p, w2cs[0], gts[0], jcam, jo,
                                          tback, JLoss())
    out["backend_tracking_step"] = (p, aux)
    out["ba_step"] = JS.ba_step(jgm, pose0, w2cs[0], gts[0], j_exp(), jcam,
                                jo, j["mcfg"], j["lexp"], j["exp_sched"])
    return out


def _assert_pose_close(tp, jp):
    np.testing.assert_allclose(tp.w2c.cpu().numpy(), np.asarray(jp.w2c),
                               rtol=0, atol=5e-5)
    assert tp.step.dtype == torch.int32 and tp.step.dim() == 0
    assert int(tp.step) == int(np.asarray(jp.step))


def _assert_exposure_close(te, je):
    np.testing.assert_allclose([float(te.gain), float(te.bias)],
                               [float(je.gain), float(je.bias)], rtol=0,
                               atol=1e-6)
    assert te.step.dtype == torch.int32
    assert int(te.step) == int(np.asarray(je.step))


def _assert_gm_close(tgm, jgm, steps):
    _assert_map_close(tgm, jgm, steps_bound=steps)
    assert tgm.step.dtype == torch.int32 and tgm.step.dim() == 0
    assert int(tgm.step) == int(np.asarray(jgm.step))


def _check_against_jax(scene, name, want):
    own = programs.Owner("jax")
    if name == "tracking_loop":
        tp, taux = track(scene, own, 1, True, True, scene["pose"])
        jp, jaux = want
        _assert_pose_close(tp, jp)
        assert int(taux["iters"]) == int(jaux["iters"])
        np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(taux["pred_w2c"].numpy(),
                                   np.asarray(jaux["pred_w2c"]), rtol=0,
                                   atol=1e-4)
        assert abs(int(taux["n_low"]) - int(jaux["n_low"])) <= 1
        return
    if name == "mapping_loop dense":
        from gaus_slam_tpu_torch.slam.steps import mapping_loop

        got = mapping_loop(scene["gm"], scene["w2cs"][:1], scene["gts"][:1],
                           scene["cam"], scene["opts"], scene["mcfg"],
                           scene["lcfg"], owner=own)
        got = (got[0], [got[1]])
    else:
        got = CHAINS[name](scene, own, JAX_CALLS[name])
    if name.startswith("mapping_step"):
        _assert_gm_close(got[0], want[0], 1)
        _assert_exposure_close(got[1], want[1])
        assert (abs(float(got[1].gain) - 1.0) > 1e-4) == name.endswith("on")
    elif name == "mapping_loop dense":
        _assert_gm_close(got[0], want[0], 1)
        np.testing.assert_allclose(float(got[1][-1]["loss"]),
                                   float(want[1]["loss"]), rtol=1e-4)
    elif name == "backend_tracking_step":
        _assert_pose_close(got[0], want[0])
        np.testing.assert_allclose(float(got[1][-1]["loss"]),
                                   float(want[1]["loss"]), rtol=1e-4)
    else:
        _assert_gm_close(got[0], want[0], 1)
        assert int(got[1].step) == int(np.asarray(want[1].step)) == 1
        _assert_exposure_close(got[2], want[2])


@pytest.mark.parametrize("name", FAST)
def test_program_matches_jax(scene, jax_runs, name):
    _check_against_jax(scene, name, jax_runs[name])


@pytest.mark.slow
@pytest.mark.parametrize("name", [n for n in JAX_CALLS if n not in FAST]
                         + ["tracking_loop"])
def test_program_matches_jax_slow(scene, jax_runs_slow, name):
    _check_against_jax(scene, name, jax_runs_slow[name])


# ---------------------------------------------------------------------------
# the step tables


def test_tables_equal_host_arithmetic():
    """The tables hold what the host computed per step before the
    counters moved to the device: the map's bias corrections in float32,
    the pose's and exposure's through _f32_pow, the learning rates of
    LrSchedule.at; a division by an entry equals the division by the host
    float here (chip_smoke phase 13 checks the card's entries, the
    reciprocals CUDA multiplies by)."""
    from gaus_slam_tpu_torch.models import gaussians as G
    from gaus_slam_tpu_torch.models.frame import (LrSchedule, _f32_pow,
                                                  bias_table, lr_table,
                                                  saturation_step)
    from gaus_slam_tpu_torch.ops.consts import at, host_scalar_divisor

    x = torch.tensor(np.random.default_rng(0).standard_normal(4096),
                     dtype=torch.float32)
    for b in (0.9, 0.999, 0.7, 0.99):
        n = saturation_step(b)
        steps = list(range(1, 40)) + list(range(n - 3, n + 50))
        for kind, table, host in (
                ("map", G.bias_table(b, "cpu"), lambda t: float(
                    1.0 - torch.tensor(b, dtype=torch.float32)
                    ** torch.tensor(float(t), dtype=torch.float32))),
                ("pose", bias_table(b, "cpu"),
                 lambda t: 1 - _f32_pow(b, t))):
            for t in steps:
                c = host(t)
                d = at(table, torch.tensor(t, dtype=torch.int32))
                assert d.item() == np.float32(c), (kind, b, t)
                assert torch.equal(x / d, x / c), (kind, b, t)
                # the card's entries: 1 / c in double, rounded
                assert host_scalar_divisor(c, "cuda") == np.float32(1.0 / c)
    for sched in (LrSchedule(4e-4, 8e-5, 20), LrSchedule(0.005, 1e-4, 60),
                  LrSchedule(0.0, 0.0, 1)):
        table = lr_table(sched, "cpu")
        for k in range(sched.max_steps + 30):
            got = at(table, torch.tensor(k, dtype=torch.int32)).item()
            assert got == sched.at(k), (sched, k)


# ---------------------------------------------------------------------------
# buffers, reuse, capacity


def test_held_copy_unchanged_and_program_reused(scene):
    from gaus_slam_tpu_torch.models import gaussians as G
    from gaus_slam_tpu_torch.models.frame import init_exposure
    from gaus_slam_tpu_torch.slam.steps import mapping_step

    own = programs.Owner("frontend-like")
    exp = init_exposure("cpu")

    def step(gm):
        return mapping_step(gm, scene["w2cs"][0], scene["gts"][0], exp, False,
                            scene["exp_sched"], scene["cam"], scene["opts"],
                            scene["mcfg"], scene["lcfg"], owner=own)[0]

    gm1 = step(scene["gm"])
    held = G.extract_params(gm1)            # the submap cut's snapshot
    want = [p.clone() for p in gm1.params]
    prog = next(iter(own.programs.values()))
    gm2 = step(gm1)                         # stepped in place
    assert gm2.params.xyz.data_ptr() == gm1.params.xyz.data_ptr()
    assert not torch.equal(gm1.params.xyz, want[0])
    for a, b in zip(held[0], want):
        assert torch.equal(a, b)
    assert list(own.programs.values()) == [prog]     # reused
    assert int(gm2.step) == 2
    # a bigger bucket: a new program, the old one and its buffers dropped
    gm3 = step(G.resize_map(gm2, 2 * gm2.capacity))
    assert own.resets == 1 and len(own.programs) == 1
    assert next(iter(own.programs.values())) is not prog
    shapes = [d[1] for k in own.buffers if k[0] == "mirror" for d in k[1]
              if d[0].startswith(".gm.") and d[1]]
    assert shapes and all(sh[0] == gm3.capacity for sh in shapes)
    assert int(gm3.step) == 3


def test_program_rejects_baked_python_values(scene):
    def fn(x):
        return {"y": x + 1, "n": 3}

    with pytest.raises(TypeError, match="bake"):
        programs.call(programs.Owner("t"), "fn", fn,
                      {"x": torch.zeros(2)}, {}, outs="aux")


