"""The port's ``lax.cond`` (``ops/graph_loop.py::cond``) and the gradient
reduction that takes it.

On the CPU ``cond`` runs both branches and ``torch.where``s on the flag;
on a card, inside an owner's capture, an IF node runs the branch the flag
picks. Here (the CPU):

* ``if_cond_plain``'s table, and ``cond`` against ``torch.where`` for
  both flag values;
* ``Binning.slab_scatter_grads`` on an overflowing binning (the pair
  budget cut below demand, as tests/test_torch_reduce.py builds it) and
  on one that fits, against the JAX package's ``lax.cond`` within 1e-5;
* one whole ``mapping_step`` on an overflowing and a fitting binning
  against the JAX package's ``mapping_step``: the map within
  test_torch_steps.py's bounds (2 * lr, 90% within 2e-3 relative), the
  loss within 1e-4 relative, the Adam moments 90% within 2e-3 of each
  field's scale.

Marked ``cuda`` (skipped without a card): a captured mapping step with
and without overflow is bit-equal to its ``programs.eager()`` run, its
graph holds one conditional node, the device tally shows one branch per
replay, and K4 launches only on a replay without overflow. The JAX
imports stay inside the CPU tests: the card's machine has no JAX.
"""
import numpy as np
import pytest
import torch

from gaus_slam_tpu_torch import convert
from gaus_slam_tpu_torch.ops.graph_loop import cond, if_cond_plain
from gaus_slam_tpu_torch.slam import programs

LRS = (("opacity_lr", 0.05), ("rgb_lr", 0.0025), ("rotation_lr", 0.001),
       ("scaling_lr", 0.001), ("xyz_lr", 0.0001))
# the mapping step's scene: the synthetic frame 0 at 48x64, capacity 4096;
# a pair budget of 1024 rows sits under its demand (~2900 pairs)
H, W, CAP, TIGHT = 48, 64, 4096, 1024


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("flag,branch", [(True, 0), (False, 1)])
def test_if_cond_plain_table(flag, branch):
    got = if_cond_plain(torch.tensor(flag))
    assert got.dtype == torch.int64 and got.shape == ()
    assert int(got) == branch


@pytest.mark.parametrize("flag", [True, False])
def test_cond_on_the_cpu_is_where(flag):
    rng = np.random.default_rng(int(flag))
    a = torch.tensor(rng.normal(size=(7, 5)).astype(np.float32))
    b = torch.tensor(rng.normal(size=(7, 5)).astype(np.float32))
    pred = torch.tensor(flag)
    out = torch.empty(7, 5)
    ran = []

    def branch(x, name):
        def fn(o):
            ran.append(name)
            return torch.mul(x, 2.0, out=o)
        return fn

    got = cond(pred, branch(a, "then"), branch(b, "else"), out)
    assert got is out
    assert torch.equal(got, torch.where(pred, 2.0 * a, 2.0 * b))
    assert ran == ["then", "else"]       # both run: no host read of pred


@pytest.mark.parametrize("backend", [None, "interpret"])
@pytest.mark.parametrize("r_max,overflow", [(2048, False), (384, True)])
def test_reduction_cond_matches_jax(r_max, overflow, backend):
    """slab_scatter_grads (through cond) against the JAX lax.cond, and the
    branch it keeps against the reduction the flag names."""
    import jax.numpy as jnp

    from test_torch_reduce import binnings

    n = 256
    jb, tb, rng = binnings(0, n, r_max)
    assert bool(tb.overflow) == overflow == bool(jb.overflow)
    g = rng.normal(size=(r_max, 24)).astype(np.float32)
    ref = np.asarray(jb.slab_scatter_grads(jnp.asarray(g), n,
                                           backend="interpret"))
    got = tb.slab_scatter_grads(torch.tensor(g), n, backend=backend)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    g0 = torch.where(tb.pair_ok[:, None], torch.tensor(g), torch.zeros(()))
    taken = (tb._slab_reduce(g0, n, 4) if overflow
             else tb._run_reduce(g0, n, 4, backend))
    assert torch.equal(got, taken)


def _assert_moments_close(tgm, jgm):
    """Adam's first and second moments of the active rows: 90% of each
    field within 2e-3 of the larger of the value and 1e-2 of the field's
    largest value."""
    n = int(np.asarray(jgm.n_active))
    for which in ("m", "v"):
        for f in tgm.params._fields:
            a = np.asarray(getattr(getattr(jgm, which), f))[:n]
            b = getattr(getattr(tgm, which), f).numpy()[:n]
            floor = max(1e-2 * float(np.abs(a).max()), 1e-30)
            rel = np.abs(a - b) / np.maximum(np.abs(a), floor)
            assert np.mean(rel > 2e-3) < 0.1, (which, f,
                                               np.mean(rel > 2e-3))


@pytest.mark.parametrize("overflow", [True, False])
def test_mapping_step_on_overflow_matches_jax(overflow):
    """One mapping_step (backend "interpret": the kernels' plain versions
    and K4's plain gather; exposure on) from the same state and frame, on
    a pair budget under demand (the slab reduction) and on the factor
    budget (the run reduction)."""
    import jax.numpy as jnp

    from gaus_slam_tpu.models.frame import LrSchedule as JLr
    from gaus_slam_tpu.models.frame import init_exposure as j_exp
    from gaus_slam_tpu.ops import binning as JB
    from gaus_slam_tpu.ops.composite_ref import frame_to_tiles as j_tiles
    from gaus_slam_tpu.render import RenderOptions as JOpts
    from gaus_slam_tpu.slam.loss import LossConfig as JLoss
    from gaus_slam_tpu.slam.steps import MapConfig as JMap
    from gaus_slam_tpu.slam.steps import mapping_step as j_step
    from gaus_slam_tpu_torch.models.frame import LrSchedule as TLr
    from gaus_slam_tpu_torch.models.frame import init_exposure as t_exp
    from gaus_slam_tpu_torch.ops import binning as TB
    from gaus_slam_tpu_torch.ops.camera import camera_from_intrinsics as t_cam
    from gaus_slam_tpu_torch.ops.composite_ref import frame_to_tiles as t_tiles
    from gaus_slam_tpu_torch.render import RenderOptions as TOpts
    from gaus_slam_tpu_torch.slam.loss import LossConfig as TLoss
    from gaus_slam_tpu_torch.slam.steps import MapConfig as TMap
    from gaus_slam_tpu_torch.slam.steps import mapping_step as t_step
    from test_torch_frontend import _assert_map_close
    from test_torch_steps import _tiny_scene

    ds, jcam, jgm = _tiny_scene(H, W, CAP)
    color, depth = ds[1][0] / 255.0, ds[1][1]
    w2c = (np.linalg.inv(ds[1][3]) @ ds[0][3]).astype(np.float32)
    kw = dict(pair_budget_factor=1.35, max_tiles_per_gaussian=4,
              pair_cap=TIGHT if overflow else 0, backend="interpret")
    jo = JOpts(grid=JB.make_grid(jcam, 16, 16), **kw)
    jl = JLoss(enable_exposure=True)
    e0 = j_exp()._replace(gain=jnp.float32(1.1), bias=jnp.float32(-0.05))
    jgm2, _, jaux = j_step(jgm, jnp.asarray(w2c),
                           j_tiles(jnp.asarray(color), jnp.asarray(depth),
                                   jo.grid), e0, jnp.bool_(True),
                           JLr(0.005, 0.0001, 60), jcam, jo, JMap(lrs=LRS),
                           jl)
    assert bool(jaux["overflow"]) == overflow

    tcam = t_cam(H, W, ds.intrinsics, np.eye(4), device="cpu")
    to = TOpts(grid=TB.make_grid(tcam, 16, 16), **kw)
    tgm = convert.gaussian_map_from_numpy(jgm, device="cpu")
    te0 = t_exp("cpu")._replace(gain=torch.tensor(1.1),
                               bias=torch.tensor(-0.05))
    tgm2, _, taux = t_step(tgm, torch.tensor(w2c),
                           t_tiles(torch.tensor(color.astype(np.float32)),
                                   torch.tensor(depth), to.grid), te0, True,
                           TLr(0.005, 0.0001, 60), tcam, to, TMap(lrs=LRS),
                           TLoss(enable_exposure=True))
    assert bool(taux["overflow"]) == overflow
    assert int(taux["demand"]) == int(jaux["demand"])
    assert int(taux["num_pairs"]) == int(jaux["num_pairs"])
    if overflow:
        assert int(taux["num_pairs"]) < int(taux["demand"])
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               rtol=1e-4)
    _assert_map_close(tgm2, jgm2, steps_bound=1)
    _assert_moments_close(tgm2, jgm2)
    # the step moved the map
    assert float((tgm2.params.xyz - tgm.params.xyz).abs().max()) > 0


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture(scope="module")
def cuda_map_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: an IF node is built only in a "
                    "capture there")
    from test_torch_programs_cuda import port_scene, synthetic_scene

    sc = synthetic_scene(H, W, CAP)
    sc["kw"] = dict(sc["kw"], backend="pallas")
    return port_scene(sc, "cuda")


def _map_run(sc, overflow, own, n=2):
    """n chained mapping steps (exposure on) on the factor budget or on a
    pair budget under demand; (the map, the auxes)."""
    from gaus_slam_tpu_torch.models.frame import init_exposure
    from gaus_slam_tpu_torch.slam.steps import mapping_step

    opts = sc["opts"]._replace(pair_cap=TIGHT if overflow else 0)
    gm, exp, out = sc["gm"], init_exposure(sc["gts"].device), []
    for k in range(n):
        gm, exp, aux = mapping_step(
            gm, sc["w2cs"][k % 2], sc["gts"][k % 2], exp, True,
            sc["exp_sched"], sc["cam"], opts, sc["mcfg"], sc["lcfg_exp"],
            owner=own)
        out.append(programs._clone(aux))
    return programs._clone((gm, exp)), out


@pytest.mark.cuda
@pytest.mark.parametrize("overflow", [True, False])
def test_cuda_captured_mapping_step_runs_one_branch(cuda_map_scene,
                                                    overflow):
    from gaus_slam_tpu_torch.ops import _cuda
    from test_torch_programs_cuda import assert_bit_equal

    sc = cuda_map_scene
    with programs.eager():
        want = _map_run(sc, overflow, None)
    assert all(bool(a["overflow"]) == overflow for a in want[1])
    own = programs.Owner("cond")
    assert_bit_equal(_map_run(sc, overflow, own), want)
    progs = [p for p in own.programs.values() if p.name == "mapping_step"]
    assert progs and all(p.graph is not None and p.tally is not None
                         for p in progs)
    assert all(p.types.count("conditional") == 1 for p in progs), [
        p.types for p in progs]
    # replays only: one branch each, by the device tally; K4 lands the run
    # reduction, so it launches only without overflow
    _cuda.clear_launches()
    seen = [p.tally.parts[0][0].tolist() for p in progs]
    n0 = programs.GRAPH_LAUNCHES["mapping_step"]
    assert_bit_equal(_map_run(sc, overflow, own), want)
    counts = _cuda.fold_launches()
    assert programs.GRAPH_LAUNCHES["mapping_step"] == n0 + 2
    ran = np.sum([np.array(p.tally.parts[0][0].tolist()) - np.array(s0)
                  for p, s0 in zip(progs, seen)], axis=0).tolist()
    assert ran == ([2, 0] if overflow else [0, 2])
    assert counts["if_cond"] == 2
    assert counts.get("monotone_row_gather", 0) == (0 if overflow else 2)
    assert counts["raster_forward_stash"] == counts[
        "raster_backward_stash"] == 2
