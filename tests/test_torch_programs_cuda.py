"""The port's captured steps on a card: each program of
tests/test_torch_programs.py, called N times with real CUDA graphs,
equals N calls under ``programs.eager()`` bit for bit, at 32x32 on the
synthetic scene's frame-0 map (capacity 1024). This file imports no JAX:
the card's machine has none. The CPU file imports its chains."""
import numpy as np
import pytest
import torch

from gaus_slam_tpu_torch import convert
from gaus_slam_tpu_torch.slam import programs

N = 2                      # chained calls per comparison
LRS = (("opacity_lr", 0.05), ("rgb_lr", 0.0025), ("rotation_lr", 0.001),
       ("scaling_lr", 0.001), ("xyz_lr", 0.0001))
TRACK_LR = (4e-4, 8e-5, 5e-4, 1e-4)
# the tracking loop stops early, at 4 of 12 iterations
TRACK_ITERS, TRACK_TH = 12, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_scene(sc, device):
    """The port's steps' inputs on ``device`` from a scene's numpy
    pieces: the synthetic dataset ``ds``, the map ``gm`` (numpy fields),
    the target ``frames`` and their ``w2cs``, the render options ``kw``."""
    from gaus_slam_tpu_torch.models.frame import LrSchedule, init_pose
    from gaus_slam_tpu_torch.ops import binning as TB
    from gaus_slam_tpu_torch.ops.camera import camera_from_intrinsics
    from gaus_slam_tpu_torch.ops.composite_ref import frame_to_tiles
    from gaus_slam_tpu_torch.render import RenderOptions
    from gaus_slam_tpu_torch.slam.loss import LossConfig
    from gaus_slam_tpu_torch.slam.steps import MapConfig, TrackConfig

    h, w = sc["hw"]
    cam = camera_from_intrinsics(h, w, sc["ds"].intrinsics, np.eye(4),
                                 device=device)
    opts = RenderOptions(grid=TB.make_grid(cam, 16, 16), **sc["kw"])
    gts = torch.stack([frame_to_tiles(
        torch.tensor(c.astype(np.float32)), torch.tensor(d), opts.grid)
        for c, d in sc["frames"]]).to(device)
    r0, r1, t0, t1 = TRACK_LR
    return dict(
        cam=cam, opts=opts, gts=gts,
        colors=[torch.tensor(c.astype(np.float32)).to(device)
                for c, _ in sc["frames"]],
        depths=[torch.tensor(d).to(device) for _, d in sc["frames"]],
        w2cs=torch.tensor(np.stack(sc["w2cs"])).to(device),
        gm=convert.gaussian_map_from_numpy(sc["gm"], device=device),
        pose=init_pose(sc["w2cs"][1], device=device),
        mcfg=MapConfig(lrs=LRS), lcfg=LossConfig(),
        lcfg_exp=LossConfig(enable_exposure=True),
        exp_sched=LrSchedule(0.005, 0.0001, 60),
        tcfg=TrackConfig(num_iters=TRACK_ITERS, converged_th=TRACK_TH,
                         rot_sched=LrSchedule(r0, r1, TRACK_ITERS),
                         trans_sched=LrSchedule(t0, t1, TRACK_ITERS)),
        tcfg_back=TrackConfig(num_iters=1, converged_th=-1.0,
                              rot_sched=LrSchedule(r0, r1, 40),
                              trans_sched=LrSchedule(t0, t1, 40)))


def leaves(tree):
    out = []
    programs._flatten(tree, "", out)
    return out


def assert_bit_equal(got, want):
    g, w = leaves(got), leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a.cpu(), b.cpu()), path


def both(run):
    """run() under eager() and through programs (a fresh owner whose map
    is stepped in place); the second result copied out of its buffers."""
    with programs.eager():
        want = run(None)
    own = programs.Owner("test")
    got = programs._clone(run(own))
    return got, want, own


# ---------------------------------------------------------------------------
# the steps' N-call chains


def track(sc, own, lag, view, predict, prev=None):
    from gaus_slam_tpu_torch.render import bin_for_tracking
    from gaus_slam_tpu_torch.slam.steps import tracking_loop

    cam, opts = sc["cam"], sc["opts"]
    cache = bin_for_tracking(sc["gm"], cam.replace_w2c(sc["pose"].w2c), opts)
    pose, aux = tracking_loop(cache, sc["pose"], sc["gts"][1], cam, opts,
                              sc["tcfg"], sc["lcfg"], want_view=view,
                              prev_pose=prev, predict=predict, lag=lag,
                              owner=own)
    aux.pop("host_waits")
    aux.pop("queued")
    return pose, aux


def _map_steps(sc, own, exposure_on, n=N):
    from gaus_slam_tpu_torch.models.frame import init_exposure
    from gaus_slam_tpu_torch.slam.steps import mapping_step

    gm, exp = sc["gm"], init_exposure(sc["gts"].device)
    out = []
    for k in range(n):
        gm, exp, aux = mapping_step(
            gm, sc["w2cs"][k % 2], sc["gts"][k % 2], exp, exposure_on,
            sc["exp_sched"], sc["cam"], sc["opts"], sc["mcfg"],
            sc["lcfg_exp"], owner=own)
        out.append(programs._clone(aux))
    return gm, exp, out


def _map_loops(sc, own, stride, n=N):
    from gaus_slam_tpu_torch.slam.steps import mapping_loop

    # the reference backend renders every tile: the coarse phases render
    # through the stash kernels' plain versions
    opts = sc["opts"]
    if stride > 1 and opts.backend == "reference":
        opts = opts._replace(backend="interpret")
    gm, out = sc["gm"], []
    for k in range(n):
        gm, aux = mapping_loop(gm, sc["w2cs"], sc["gts"], sc["cam"],
                               opts, sc["mcfg"], sc["lcfg"],
                               coarse_stride=stride, phase0=3 * k,
                               owner=own)
        out.append(programs._clone(aux))
    return gm, out


def _back_track(sc, own, n=N):
    from gaus_slam_tpu_torch.slam.steps import backend_tracking_step

    pose, out = sc["pose"], []
    for k in range(n):
        pose, aux = backend_tracking_step(
            sc["gm"], pose, sc["w2cs"][0], sc["gts"][0], sc["cam"],
            sc["opts"], sc["tcfg_back"], sc["lcfg"], owner=own)
        out.append(programs._clone(aux))
    return pose, out


def _ba(sc, own, n=N):
    from gaus_slam_tpu_torch.models.frame import init_exposure
    from gaus_slam_tpu_torch.slam.steps import ba_step

    gm, pose, exp = sc["gm"], sc["pose"], init_exposure(sc["gts"].device)
    for k in range(n):
        gm, pose, exp, aux = ba_step(
            gm, pose, sc["w2cs"][0], sc["gts"][k % 2], exp, sc["cam"],
            sc["opts"], sc["mcfg"], sc["lcfg_exp"], sc["exp_sched"],
            owner=own)
    return gm, pose, exp, programs._clone(aux)


# the keyframe and submap programs: a map with room to grow, a prune
# that drops the rows of mean scale past 0.15 (about half of the tiny
# scene's frame-0 map)
GROW_CAP = 2048
PRUNE = dict(scale_max=0.15)


def _dcfg():
    from gaus_slam_tpu_torch.slam.densify import DensifyConfig

    return DensifyConfig(**PRUNE)


def _views(sc, own, n=N):
    from gaus_slam_tpu_torch.render import render_view

    return [programs._clone(render_view(
        sc["gm"], sc["cam"].replace_w2c(sc["w2cs"][k % 3]), sc["opts"],
        owner=own)) for k in range(n)]


def _densify(sc, own, n=N):
    """The frontend's keyframe densification: render_view, then
    add_and_prune on that view, chained."""
    from gaus_slam_tpu_torch.models import gaussians as G
    from gaus_slam_tpu_torch.render import render_view
    from gaus_slam_tpu_torch.slam.densify import add_and_prune

    gm, views = G.resize_map(sc["gm"], GROW_CAP), []
    for k in range(n):
        w2c = sc["w2cs"][k % 3]
        view = render_view(gm, sc["cam"].replace_w2c(w2c), sc["opts"],
                           owner=own)
        views.append(programs._clone(view))
        gm = add_and_prune(gm, w2c, sc["colors"][k % 3], sc["depths"][k % 3],
                           view, sc["cam"], sc["opts"], _dcfg(), sc["lcfg"],
                           owner=own)
    return gm, views


def _prunes(sc, own, n=N):
    """prune_gaussians after a mapping step, chained."""
    from gaus_slam_tpu_torch.models.frame import init_exposure
    from gaus_slam_tpu_torch.slam.densify import prune_gaussians
    from gaus_slam_tpu_torch.slam.steps import mapping_step

    gm, exp = sc["gm"], init_exposure(sc["gts"].device)
    counts = []
    for k in range(n):
        gm, exp, _ = mapping_step(gm, sc["w2cs"][k % 2], sc["gts"][k % 2],
                                  exp, False, sc["exp_sched"], sc["cam"],
                                  sc["opts"], sc["mcfg"], sc["lcfg"],
                                  owner=own)
        gm = prune_gaussians(gm, _dcfg(), owner=own)
        counts.append(gm.n_active.clone())
    return gm, counts


def _inits(sc, own, n=N):
    from gaus_slam_tpu_torch.slam.init_map import initialize_map

    return [programs._clone(initialize_map(
        GROW_CAP, sc["colors"][k % 3], sc["depths"][k % 3],
        sc["w2cs"][k % 3], sc["cam"], owner=own)) for k in range(n)]


def _binned_steps(sc, own, n=N):
    """The frontend's per-step mapping group: bin_mapping, then
    mapping_step on that binning, chained."""
    from gaus_slam_tpu_torch.models.frame import init_exposure
    from gaus_slam_tpu_torch.slam.steps import bin_mapping, mapping_step

    gm, exp, out = sc["gm"], init_exposure(sc["gts"].device), []
    for k in range(n):
        w2c, gt = sc["w2cs"][k % 2], sc["gts"][k % 2]
        bins = bin_mapping(gm, w2c, sc["cam"], sc["opts"], owner=own)
        gm, exp, aux = mapping_step(gm, w2c, gt, exp, False, sc["exp_sched"],
                                    sc["cam"], sc["opts"], sc["mcfg"],
                                    sc["lcfg"], bins=bins, owner=own)
        out.append(programs._clone(aux))
    return gm, out


def _evals(sc, own, n=N):
    from gaus_slam_tpu_torch.utils.eval import _eval_frame

    out = []
    for k in range(n):
        vals, rgb = _eval_frame(sc["gm"], sc["w2cs"][k % 3],
                                sc["colors"][k % 3], sc["depths"][k % 3],
                                sc["cam"], sc["opts"], sc["lcfg"], owner=own)
        out.append((vals, rgb.clone()))
    return out


def _sharded(sc, own, weights, n=N):
    """sharded_ba_step over four slots of the scene's device, chained: the
    shard owners beside ``own``, the map's."""
    from gaus_slam_tpu_torch.parallel import sharded_ba_step

    devs = [sc["gts"].device] * 4
    owners = None
    if own is not None:
        # the shard owners live as long as the map's (a Backend's do)
        if not hasattr(own, "shards"):
            own.shards = [programs.Owner(f"{own.name}-shard{k}", device=d)
                          for k, d in enumerate(devs)]
        owners = own.shards + [own]
    idx = [0, 1, 2, 0]
    gm, out = sc["gm"], []
    for _ in range(n):
        gm, loss, diag = sharded_ba_step(
            devs, gm, sc["w2cs"][idx], sc["gts"][idx], sc["cam"], sc["opts"],
            sc["mcfg"], sc["lcfg"], weights=weights, owners=owners)
        out.append(programs._clone((loss, diag)))
    return gm, out


CHAINS = {
    "mapping_step exposure on": lambda sc, own, n=N: _map_steps(sc, own,
                                                                 True, n),
    "mapping_step exposure off": lambda sc, own, n=N: _map_steps(sc, own,
                                                                  False, n),
    "mapping_loop dense": lambda sc, own, n=N: _map_loops(sc, own, 1, n),
    "mapping_loop coarse 3": lambda sc, own, n=N: _map_loops(sc, own, 3, n),
    "backend_tracking_step": _back_track,
    "ba_step": _ba,
    "render_view": _views,
    "add_and_prune": _densify,
    "prune_gaussians": _prunes,
    "initialize_map": _inits,
    "bin_mapping": _binned_steps,
    "eval_frame": _evals,
    "sharded_ba_step": lambda sc, own, n=N: _sharded(sc, own, None, n),
    "sharded_ba_step [1, 1, 1, 0]": lambda sc, own, n=N: _sharded(
        sc, own, (1, 1, 1, 0), n),
}
# programs a chain's owner may hold: a step's own, plus one per layout
# or address its inputs come in (the first map from the scene, the later
# ones from the owner's buffers) and per program of a two-program chain
PROGRAMS_AT_MOST = {"add_and_prune": 2 * N, "prune_gaussians": 2 * N,
                    "bin_mapping": 2 * N}
TRACKS = [(lag, view) for lag in (0, 1, 2) for view in (False, True)]


def track_run(sc, lag, view):
    def run(own):
        prev = sc["pose"] if view else None
        return track(sc, own, lag, view, view, prev)
    return run




def synthetic_scene(h=32, w=32, cap=1024):
    """The port's own tiny scene: the synthetic frame 0's map, frames 1-3
    as targets at their ground-truth poses relative to frame 0."""
    from gaus_slam_tpu_torch.data.synthetic import SyntheticDataset
    from gaus_slam_tpu_torch.ops.camera import camera_from_intrinsics
    from gaus_slam_tpu_torch.slam.init_map import initialize_map

    ds = SyntheticDataset(height=h, width=w, num_frames=4)
    cam = camera_from_intrinsics(h, w, ds.intrinsics, np.eye(4),
                                 device="cpu")
    color, depth = ds[0][0] / 255.0, ds[0][1]
    gm = initialize_map(cap, torch.tensor(color.astype(np.float32)),
                        torch.tensor(np.asarray(depth, np.float32)),
                        torch.eye(4), cam)
    return dict(ds=ds, hw=(h, w), gm=convert.gaussian_map_to_numpy(gm),
                **targets(ds))


def targets(ds):
    c2w0 = ds[0][3]
    frames, w2cs = [], []
    for t in (1, 2, 3):
        color, depth, _, c2w = ds[t]
        frames.append(((color / 255.0).astype(np.float32),
                       np.asarray(depth, np.float32)))
        w2cs.append((np.linalg.inv(c2w) @ c2w0).astype(np.float32))
    return dict(frames=frames, w2cs=w2cs,
                kw=dict(pair_budget_factor=1.35, max_tiles_per_gaussian=4,
                        backend="reference"))


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture(scope="module")
def cuda_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs are captured only there")
    sc = synthetic_scene()
    # the kernels (the reference backend's plain compositor reads the
    # device, so its steps are not captured)
    sc["kw"] = dict(sc["kw"], backend="pallas")
    return port_scene(sc, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CHAINS) + ["tracking"])
def test_cuda_graphs_equal_eager(cuda_scene, name):
    run = (track_run(cuda_scene, 1, True) if name == "tracking" else
           (lambda own: CHAINS[name](cuda_scene, own)))
    got, want, own = both(run)
    assert_bit_equal(got, want)
    assert all(p.graph is not None for p in own.programs.values())
    # the chain again: every call replays a graph
    n0 = sum(programs.GRAPH_LAUNCHES.values())
    assert_bit_equal(programs._clone(run(own)), want)
    assert sum(programs.GRAPH_LAUNCHES.values()) > n0


def loop_run(sc, lag, view, owner=None):
    """The tracking loop with a stride-2 coarse level (the cache binned
    phase-major for it, the compact slice on), at ``lag`` (None: the one
    loop program)."""
    from gaus_slam_tpu_torch.render import bin_for_tracking
    from gaus_slam_tpu_torch.slam.steps import tracking_loop

    cam, opts = sc["cam"], sc["opts"]
    tcfg = sc["tcfg"]._replace(coarse_levels=((3, 2),))
    cache = bin_for_tracking(sc["gm"], cam.replace_w2c(sc["pose"].w2c), opts,
                             coarse_strides=(2,))
    pose, aux = tracking_loop(cache, sc["pose"], sc["gts"][1], cam, opts,
                              tcfg, sc["lcfg"], want_view=view,
                              prev_pose=sc["pose"] if view else None,
                              predict=view, compact_coarse=True, lag=lag,
                              owner=owner)
    aux.pop("host_waits")
    aux.pop("queued")
    return programs._clone((pose, aux))


@pytest.mark.cuda
@pytest.mark.parametrize("view", [False, True])
def test_cuda_loop_program_equals_eager_and_lagged(cuda_scene, view):
    """The one loop program (WHILE nodes) against the same loop under
    programs.eager() and through the lagged per-iteration programs: bit
    for bit; its second call is one launch with the same bits, and the
    folded launch counts hold K1 and K2 once per iteration that ran."""
    from gaus_slam_tpu_torch.ops import _cuda

    with programs.eager():
        want = loop_run(cuda_scene, None, view)
    assert_bit_equal(loop_run(cuda_scene, 1, view, programs.Owner("lag")),
                     want)
    own = programs.Owner("loop")
    assert_bit_equal(loop_run(cuda_scene, None, view, own), want)
    loops = [p for p in own.programs.values() if p.name == "tracking_loop"]
    assert len(loops) == 1 and loops[0].loop is not None
    n0 = programs.GRAPH_LAUNCHES["tracking_loop"]
    _cuda.clear_launches()
    got = loop_run(cuda_scene, None, view, own)
    assert_bit_equal(got, want)
    assert programs.GRAPH_LAUNCHES["tracking_loop"] == n0 + 1
    assert len(own.programs) == 1
    counts = _cuda.fold_launches()
    iters = int(got[1]["iters"])
    assert 0 < iters < cuda_scene["tcfg"].num_iters
    assert counts["raster_forward_stash"] == iters
    assert counts["raster_backward_stash"] == iters
    assert counts["raster_forward"] == (1 if view else 0)
    assert counts["while_cond"] == 2 + iters


@pytest.mark.cuda
def test_cuda_retired_loop_tally_is_folded_and_dropped(cuda_scene):
    """A capacity change retires an owner's loop program: once it is gone,
    the next loop program's assembly queues the copy of its device tally,
    a later one folds it and drops it from ``_cuda.TALLIES``, and every
    iteration that ran stays counted."""
    import gc

    from gaus_slam_tpu_torch.ops import _cuda

    _cuda.clear_launches()
    own = programs.Owner("retire")
    own.set_capacity(1)
    first = loop_run(cuda_scene, None, False, own)
    loop_run(cuda_scene, None, False, own)
    [tally] = [p.tally for p in own.programs.values()]
    own.set_capacity(2)
    torch.cuda.synchronize()
    own.set_capacity(3)
    gc.collect()
    assert tally.prog() is None and tally in _cuda.TALLIES
    loop_run(cuda_scene, None, False, own)
    torch.cuda.synchronize()
    view = loop_run(cuda_scene, None, True, own)
    assert tally not in _cuda.TALLIES
    counts = _cuda.fold_launches()
    iters = int(first[1]["iters"])
    assert counts["raster_forward_stash"] == 3 * iters + int(view[1]["iters"])


# ---------------------------------------------------------------------------
# the warm-up's memory and the owner's pools


def _segments_mib(pool_ids) -> float:
    """MiB of the caching allocator's segments in the pools ``pool_ids``
    ((0, 0): the default pool)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) in pool_ids) / 2**20


def _pool_ids(own) -> set:
    return {tuple(ids) for (pool, branches) in own._pools.values()
            for ids in (pool[0], branches.id)}


def _big_temporary(x):
    """x plus a reduction of a 256 MiB temporary, freed before the step
    returns."""
    big = x.repeat(64)
    return x + big.view(64, -1).sum(0)


@pytest.mark.cuda
def test_cuda_warm_up_takes_its_temporaries_from_the_pool():
    """A step's eager warm-up and its capture use the same blocks of the
    owner's graph pool: a step with a 256 MiB temporary adds less than
    that to the caching allocator's default pool, the pool holds it once,
    and the replays equal the eager step bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs are captured only there")
    x = torch.rand(1 << 20, device="cuda")
    want = _big_temporary(x)
    own = programs.Owner("warm")
    # the owner's stream, its cuBLAS workspaces and pools, and x's buffer
    programs.call(own, "plus", lambda x: x + 1, {"x": x}, {}, "y")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()     # the eager step's 256 MiB, cached
    default0 = _segments_mib({(0, 0)})
    got = programs._clone(programs.call(own, "warm", _big_temporary,
                                        {"x": x}, {}, "y"))
    torch.cuda.synchronize()
    assert _segments_mib({(0, 0)}) - default0 < 64
    assert 256 <= _segments_mib(_pool_ids(own)) < 2 * 256 + 64
    assert torch.equal(got, want)
    assert torch.equal(programs.call(own, "warm", _big_temporary, {"x": x},
                                     {}, "y"), want)


@pytest.mark.cuda
def test_cuda_first_capture_under_no_grad():
    """An owner whose first program is called under ``torch.no_grad``
    (the mesh evaluation's renders) captures it: the owner's stream is
    made ready for the autograd engine with grad enabled."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs are captured only there")
    x = torch.rand(1 << 10, device="cuda")
    own = programs.Owner("no_grad")
    with torch.no_grad():
        got = programs._clone(programs.call(own, "plus", lambda x: x + 1,
                                            {"x": x}, {}, "y"))
    assert torch.equal(got, x + 1) and own.programs


@pytest.mark.cuda
def test_cuda_warm_up_that_keeps_a_block_of_the_pool_raises():
    """A step that keeps a tensor it made beyond the call would hold it in
    the graph pool, where a later replay writes: the warm-up raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs are captured only there")
    kept = []

    def step(x):
        kept.append(x * 2)
        return x + 1

    own = programs.Owner("keep")
    with pytest.raises(RuntimeError, match="bytes allocated in the graph"):
        programs.call(own, "keep", step,
                      {"x": torch.ones(1 << 16, device="cuda")}, {}, "y")


@pytest.mark.cuda
def test_cuda_growing_map_releases_the_owners_pools():
    """When an owner's map grows its programs and pools go, and the card
    gets their memory back; a map that shrinks keeps the pools."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs are captured only there")
    x = torch.rand(1 << 20, device="cuda")
    own = programs.Owner("grow")
    own.set_capacity(2)
    programs.call(own, "warm", _big_temporary, {"x": x}, {}, "y")
    own.set_capacity(1)
    assert own._pools and not own.programs
    programs.call(own, "warm", _big_temporary, {"x": x}, {}, "y")
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved() / 2**20
    own.set_capacity(3)
    assert not own._pools and not own.programs
    assert torch.cuda.memory_reserved() / 2**20 <= reserved - 256
