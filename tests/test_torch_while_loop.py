"""The tracking loop as one program (``programs.while_loop``), the port's
counterpart of the JAX package's jitted ``tracking_loop`` with its two
``lax.while_loop``s. On a card one launch runs a graph of CUDA graph
conditional WHILE nodes (ops/graph_loop.py, csrc/graph_loop.cu); here,
on the CPU, the same static-buffer bodies run in a host loop over
``while_cond_plain``, the plain version of the kernel ``while_cond``.

* Against the JAX package's ``tracking_loop`` (both under "interpret",
  the Pallas kernels' stand-ins, with a stride-2 coarse level and the
  compact coarse slice) at tests/test_torch_device_branch.py's size
  (32x32, frame 2 from frame 1's pose): the iteration count and the
  pose's step equal, the loss within 1e-4 relative, w2c within 5e-5; with
  the early stop inside the coarse level, inside the full-resolution
  level, without the early exit, and with the view and the next frame's
  prediction.
* Bit for bit the loop that the host queues an iteration at a time, at
  lags 0-2, and the loop under ``programs.eager()``.
* One loop program per key, reused by a second call with the same bits.
* ``while_cond_plain``'s truth table, and ``while_loop`` over a counter
  (``kmax`` 0, a stop before the entry, in either level).
"""
import numpy as np
import pytest
import torch

from gaus_slam_tpu_torch.ops.graph_loop import while_cond_plain
from gaus_slam_tpu_torch.slam import programs
from test_torch_programs_cuda import assert_bit_equal
from test_torch_steps import _tiny_scene


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


LR = (4e-4, 8e-5, 5e-4, 1e-4)
N_ITERS, TH = 20, 5e-4
# the schedules: (TrackConfig fields, view and prediction on)
CASES = {
    "stop in coarse": (dict(coarse_levels=((18, 2),)), False),
    "stop in fine": (dict(coarse_levels=((6, 2),)), False),
    "no early exit": (dict(coarse_levels=((3, 2),), num_iters=8,
                           converged_th=-1.0), False),
    "view and predict": (dict(coarse_levels=((6, 2),)), True),
}


def _cfg(mod_steps, mod_frame, case):
    fields, _ = CASES[case]
    mk = dict(dict(num_iters=N_ITERS, converged_th=TH), **fields)
    r0, r1, t0, t1 = LR
    return mod_steps.TrackConfig(
        rot_sched=mod_frame.LrSchedule(r0, r1, N_ITERS),
        trans_sched=mod_frame.LrSchedule(t0, t1, N_ITERS), **mk)


@pytest.fixture(scope="module")
def scene():
    """Both packages' inputs and the JAX loop's results per case."""
    import jax.numpy as jnp

    from gaus_slam_tpu.models import frame as JF
    from gaus_slam_tpu.ops import binning as JB
    from gaus_slam_tpu.ops.composite_ref import frame_to_tiles as j_tiles
    from gaus_slam_tpu.render import RenderOptions as JOpts
    from gaus_slam_tpu.render import bin_for_tracking as j_bin
    from gaus_slam_tpu.slam import steps as JS
    from gaus_slam_tpu.slam.loss import LossConfig as JLoss
    from gaus_slam_tpu_torch import convert
    from gaus_slam_tpu_torch.ops import binning as TB
    from gaus_slam_tpu_torch.ops.camera import camera_from_intrinsics
    from gaus_slam_tpu_torch.ops.composite_ref import frame_to_tiles
    from gaus_slam_tpu_torch.render import RenderOptions, bin_for_tracking

    ds, jcam, jgm = _tiny_scene()
    c2w0, (color, depth, _, _) = ds[0][3], ds[2]
    init = np.linalg.inv(np.linalg.inv(c2w0) @ ds[1][3]).astype(np.float32)
    kw = dict(pair_budget_factor=1.35, max_tiles_per_gaussian=4,
              backend="interpret")
    jo = JOpts(grid=JB.make_grid(jcam, 16, 16), **kw)
    jpose = JF.init_pose(init)
    jgt = j_tiles(jnp.asarray(color / 255.0), jnp.asarray(depth), jo.grid)
    jcache = j_bin(jgm, jcam.replace_w2c(jpose.w2c), jo, coarse_strides=(2,))
    jax_runs = {}
    for case, (_, view) in CASES.items():
        jp, jaux = JS.tracking_loop(
            jcache, jpose, jgt, jcam, jo, _cfg(JS, JF, case), JLoss(),
            want_view=view, prev_pose=jpose if view else None,
            predict=view, compact_coarse=True)
        jax_runs[case] = (jp, jaux)

    cam = camera_from_intrinsics(jcam.height, jcam.width, ds.intrinsics,
                                 np.eye(4), device="cpu")
    opts = RenderOptions(grid=TB.make_grid(cam, 16, 16), **kw)
    gm = convert.gaussian_map_from_numpy(jgm, "cpu")
    pose = convert.pose_from_numpy(jpose, device="cpu")
    return dict(cam=cam, opts=opts, pose=pose, jax=jax_runs,
                cache=bin_for_tracking(gm, cam.replace_w2c(pose.w2c), opts,
                                       coarse_strides=(2,)),
                gt=frame_to_tiles(torch.tensor((color / 255.0).astype(
                    np.float32)), torch.tensor(depth), opts.grid))


def run(sc, case, lag=None, owner=None):
    """The port's loop on ``case`` (``lag`` None: the one program), its
    results copied out of the owner's buffers."""
    from gaus_slam_tpu_torch.models import frame as TF
    from gaus_slam_tpu_torch.slam import steps as TS
    from gaus_slam_tpu_torch.slam.loss import LossConfig

    _, view = CASES[case]
    pose, aux = TS.tracking_loop(
        sc["cache"], sc["pose"], sc["gt"], sc["cam"], sc["opts"],
        _cfg(TS, TF, case), LossConfig(), want_view=view,
        prev_pose=sc["pose"] if view else None, predict=view,
        compact_coarse=True, lag=lag, owner=owner)
    waits = (aux.pop("host_waits"), aux.pop("queued"))
    return programs._clone((pose, aux)), waits


@pytest.fixture(scope="module")
def loops(scene):
    """{case: (the one program's results, its owner)}."""
    out = {}
    for case in CASES:
        own = programs.Owner(f"loop {case}")
        got, waits = run(scene, case, owner=own)
        assert waits == (0, 0)
        out[case] = (got, own)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_loop_program_matches_jax(scene, loops, case):
    (tp, taux), _ = loops[case]
    jp, jaux = scene["jax"][case]
    fields, view = CASES[case]
    iters = int(taux["iters"])
    assert iters == int(jaux["iters"]) == int(tp.step) == int(jp.step)
    coarse = fields["coarse_levels"][0][0]
    n = fields.get("num_iters", N_ITERS)
    if case == "stop in coarse":
        assert iters < coarse
    elif case == "no early exit":
        assert iters == n
    else:
        assert coarse < iters < n
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(tp.w2c.numpy(), np.asarray(jp.w2c), rtol=0,
                               atol=5e-5)
    np.testing.assert_allclose(taux["w2c"].numpy(), np.asarray(jaux["w2c"]),
                               rtol=0, atol=5e-5)
    if view:
        assert abs(int(taux["n_low"]) - int(jaux["n_low"])) <= 1
        np.testing.assert_allclose(taux["pred_w2c"].numpy(),
                                   np.asarray(jaux["pred_w2c"]), rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("ref", ["lag 0", "lag 1", "lag 2", "eager"])
@pytest.mark.parametrize("case", list(CASES))
def test_loop_program_bit_equal(scene, loops, case, ref):
    """The one program against the host-queued loop at each lag (its own
    owner's captured per-iteration programs) and under eager()."""
    got, _ = loops[case]
    if ref == "eager":
        with programs.eager():
            want, _ = run(scene, case)
    else:
        want, waits = run(scene, case, lag=int(ref[-1]),
                          owner=programs.Owner(ref))
        assert waits[1] >= int(want[1]["iters"])
    assert_bit_equal(got, want)


def test_loop_program_reused(scene, loops):
    """A second call of a key: the same program, no other made, the same
    bits (its carry starts again from the call's inputs)."""
    case = "view and predict"
    first, own = loops[case]
    progs = dict(own.programs)
    assert [p.name for p in progs.values()] == ["tracking_loop"]
    got, _ = run(scene, case, owner=own)
    assert_bit_equal(got, first)
    assert own.programs == progs


# ---------------------------------------------------------------------------
# the condition and the loop machinery


@pytest.mark.parametrize("early", [False, True])
@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("kmax", [0, 1, 5])
def test_while_cond_plain_table(kmax, live, early):
    for iters in (0, 1, 4, 5, 6):
        got = while_cond_plain(torch.tensor(iters, dtype=torch.int32),
                               torch.tensor(live), kmax, early)
        assert got.dtype == torch.bool and got.dim() == 0
        assert bool(got) == (iters < kmax and (live or not early))


def _count(n, live, *, stop):
    """A counter's iteration: one more; live while under ``stop``."""
    n = n + 1
    return n, live & (n < stop)


# (kmax of each level, stop): a stop inside either level, before the
# entry (stop 0: live is false from the start), past both, kmax 0
COUNTER = [((0,), 3), ((4,), 0), ((4,), 2), ((4,), 9), ((3, 7), 5),
           ((3, 7), 2), ((3, 7), 10), ((0, 0), 4), ((2, 2), 9)]


def counter_loop(kmaxs, stop, early, owner=None):
    """``while_loop`` over ``_count`` with a level per kmax and a tail that
    doubles the count; returns (count, live, tail)."""
    i32 = torch.int32
    args = {"n": torch.zeros((), dtype=i32),
            "live": torch.tensor(stop > 0), "stop": torch.tensor(stop)}
    done, tail = programs.while_loop(
        owner, "counter", lambda n, live, stop: _count(n, live, stop=stop),
        [({}, k, early) for k in kmaxs], args, carry=("n", "live"),
        cond=lambda a: (a["n"], a["live"]),
        body_args=("n", "live", "stop"),
        tail=lambda n: {"twice": 2 * n}, tail_args=("n",))
    return int(done["n"]), bool(done["live"]), int(tail["twice"])


@pytest.mark.parametrize("early", [True, False])
@pytest.mark.parametrize("kmaxs,stop", COUNTER)
def test_while_loop_counter(kmaxs, stop, early):
    """The program against a python loop, and under eager(); a second call
    reuses the program."""
    n, live = 0, stop > 0
    for k in kmaxs:
        while n < k and (live or not early):
            n += 1
            live = live and n < stop
    want = (n, live, 2 * n)
    own = programs.Owner("counter")
    assert counter_loop(kmaxs, stop, early, own) == want
    assert counter_loop(kmaxs, stop, early, own) == want
    assert len(own.programs) == 1
    with programs.eager():
        assert counter_loop(kmaxs, stop, early) == want


def test_while_loop_rejects_a_carry_laid_out_otherwise():
    """An iteration whose results cannot land in the buffers it read (the
    counter passed as a view into a larger storage, its result a tensor
    of its own) cannot be a loop's carry: the program raises."""
    block = torch.zeros(4, dtype=torch.int32)
    args = {"n": block[1], "live": torch.tensor(True),
            "stop": torch.tensor(3)}
    with pytest.raises(RuntimeError, match="not laid out as its carry"):
        programs.while_loop(
            programs.Owner("bad"), "counter",
            lambda n, live, stop: _count(n, live, stop=stop),
            [({}, 5, True)], args, carry=("n", "live"),
            cond=lambda a: (a["n"], a["live"]),
            body_args=("n", "live", "stop"))

