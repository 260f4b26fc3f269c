"""Port parity of the backend's gs_densify path against the JAX package:
``models/gaussians.py::densify_and_prune`` (3DGS clone / split / prune,
with the JAX draws fed through ``noise``), ``mapping_step``'s
view-space gradient statistics (``MapConfig.gs_stats``), and
``Backend._gs_densify_step``'s accumulation and interval.

Tolerances: the same ``n_active`` and active rows to 1e-6 (relative to
each field's scale); the statistic to 1e-5 of its scale under 3DGS
(1e-3 relative L2 under 2DGS, whose xyz gradient agrees to that only,
as in test_torch_render.py), ``visible`` exactly.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaus_slam_tpu.data.synthetic import SyntheticDataset
from gaus_slam_tpu.models import gaussians as JG
from gaus_slam_tpu.ops.camera import camera_from_intrinsics as j_cam
from gaus_slam_tpu.slam.init_map import initialize_map as j_init_map
from gaus_slam_tpu_torch import convert
from gaus_slam_tpu_torch.models import gaussians as TG

REPO = os.path.join(os.path.dirname(__file__), "..")
CONFIG = os.path.join(REPO, "configs", "synthetic", "config.py")
KW = dict(grad_threshold=0.5, percent_dense=0.01, extent=2.0,
          min_opacity=0.05, min_scale=5e-4)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _to_torch(jgm):
    return convert.gaussian_map_from_numpy(
        {"params": jgm.params._asdict(), "m": jgm.m._asdict(),
         "v": jgm.v._asdict(), "step": jgm.step, "active": jgm.active,
         "n_active": jgm.n_active}, device="cpu")


def _small_map(scales, opacs, extra=16):
    """tests/test_gs_densify.py's map: gaussian i at (3i, 3i+1, 3i+2)."""
    n = len(scales)
    gm = JG.empty_map(n + extra)
    gm = JG.add_gaussians(
        gm, jnp.asarray(np.arange(n * 3).reshape(n, 3), jnp.float32),
        jnp.full((n, 3), 0.5), None, jnp.asarray(scales, jnp.float32))
    logits = np.log(np.asarray(opacs) / (1 - np.asarray(opacs)))
    return gm._replace(params=gm.params._replace(
        opacity_logit=gm.params.opacity_logit.at[:n, 0].set(
            jnp.asarray(logits, jnp.float32))))


def _full_map():
    """Frame 0 of the synthetic scene at 32x32 with random scales and a
    random statistic: every branch at once, at the size of a real map."""
    ds = SyntheticDataset(height=32, width=32, num_frames=60)
    color, depth, K, _ = ds[0]
    jc = j_cam(32, 32, K, np.eye(4))
    gm = j_init_map(1536, jnp.asarray(color / 255.0), jnp.asarray(depth),
                    jnp.eye(4), jc)
    rng = np.random.default_rng(0)
    n = gm.capacity
    act = np.asarray(gm.active)[:, None]
    gm = gm._replace(params=gm.params._replace(
        log_scales=jnp.asarray(np.where(act, np.log(rng.uniform(
            1e-4, 0.3, (n, 2))), 0.0).astype(np.float32)),
        quats=gm.params.quats + act * rng.normal(
            0, 0.3, (n, 4)).astype(np.float32),
        opacity_logit=jnp.asarray(np.where(act, rng.normal(
            0, 2.0, (n, 1)), 0.0).astype(np.float32))))
    grads = rng.uniform(0, 1, n).astype(np.float32)
    return gm, grads


def _case(name):
    if name == "clone_split_prune":
        # clone / split (parent pruned) / untouched / low opacity pruned
        gm = _small_map([0.01, 0.05, 0.01, 0.01], [0.5, 0.5, 0.5, 0.01])
        g = [1.0, 1.0, 0.0, 0.0]
    elif name == "cold":
        gm = _small_map([0.01, 0.05], [0.5, 0.5])
        g = []
    elif name == "clone_only":
        gm = _small_map([0.01, 0.015, 0.02, 0.005], [0.5, 0.6, 0.7, 0.8])
        g = [1.0, 0.7, 0.2, 0.9]
    elif name == "split_and_scale_prune":
        # split children of a 0.3 parent exceed 0.1 * extent and are
        # pruned; a 2e-4 gaussian falls under min_scale
        gm = _small_map([0.3, 0.05, 2e-4, 0.04], [0.5, 0.9, 0.5, 0.5])
        g = [1.0, 0.6, 0.0, 0.4]
    else:
        return _full_map()
    return gm, np.asarray(g + [0.0] * (gm.capacity - len(g)), np.float32)


@pytest.mark.parametrize("name", ["clone_split_prune", "cold", "clone_only",
                                  "split_and_scale_prune", "full_map"])
def test_densify_and_prune_matches_jax(name):
    jgm, grads = _case(name)
    tgm = _to_torch(jgm)
    key = jax.random.PRNGKey(3)
    out_j = JG.densify_and_prune(jgm, jnp.asarray(grads), key, **KW)
    shape = jgm.params.log_scales.shape
    noise = [torch.tensor(np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), shape))) for i in range(2)]
    out_t = TG.densify_and_prune(tgm, torch.tensor(grads), noise=noise, **KW)
    n = int(out_j.n_active)
    assert int(out_t.n_active) == n
    np.testing.assert_array_equal(out_t.active.numpy(),
                                  np.asarray(out_j.active))
    for part in ("params", "m", "v"):
        for f, t, j in zip(TG.PARAM_FIELDS, getattr(out_t, part),
                           getattr(out_j, part)):
            j = np.asarray(j)[:n]
            scale = max(float(np.abs(j).max()), 1e-6)
            np.testing.assert_allclose(t.numpy()[:n], j, rtol=0,
                                       atol=1e-6 * scale,
                                       err_msg=f"{part}.{f}")
    if name == "clone_split_prune":
        assert n == 5
    if name == "cold":
        assert n == int(jgm.n_active)


def test_densify_and_prune_draws_from_the_generator():
    """Without ``noise`` the split offsets come from the generator: the
    same seed gives the same children, another seed other ones."""
    jgm, grads = _case("clone_split_prune")
    tgm, g = _to_torch(jgm), torch.tensor(grads)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return TG.densify_and_prune(tgm, g, gen, **KW)

    a, b, c = run(1), run(1), run(2)
    assert int(a.n_active) == 5
    assert torch.equal(a.params.xyz, b.params.xyz)
    assert not torch.equal(a.params.xyz, c.params.xyz)


def _configs(method, gs_densify=True):
    """configs/synthetic/config.py at 32x32 for both packages."""
    sys.path.insert(0, REPO)
    from gaus_slam_tpu.utils.config import load_config

    cfg = load_config(CONFIG)
    cfg["render"]["method"] = method
    cfg["backend"]["gs_densify"] = gs_densify
    cfg["densify"]["densify_interval"] = 3
    cfg["cameras"]["height"] = cfg["cameras"]["width"] = 32
    ds = SyntheticDataset(height=32, width=32, num_frames=60)
    cfg["cameras"]["intrinsics"] = np.asarray(ds.intrinsics)[:3, :3].tolist()
    return cfg, ds


@pytest.mark.parametrize("method", ["2dgs", "3dgs"])
def test_mapping_step_gs_stats_match_jax(method):
    """densify_stat to 1e-5 of its scale under 3DGS, whose xyz gradient
    agrees that far; under 2DGS (surfels, SA on) the xyz gradient itself
    agrees to test_torch_render.py's 1e-3 relative L2 only (elementwise
    1.8e-4 of the scale without SA, 1.8e-4 with it), so the statistic is
    held there."""
    from gaus_slam_tpu.models.frame import init_exposure as j_exp
    from gaus_slam_tpu.ops.composite_ref import frame_to_tiles as j_tiles
    from gaus_slam_tpu.slam.steps import mapping_step as j_step
    from gaus_slam_tpu.utils.config import SystemConfig as JSys
    from gaus_slam_tpu_torch.models.frame import init_exposure as t_exp
    from gaus_slam_tpu_torch.ops.composite_ref import frame_to_tiles as t_tiles
    from gaus_slam_tpu_torch.slam.steps import mapping_step as t_step
    from gaus_slam_tpu_torch.utils.config import SystemConfig as TSys

    cfg, ds = _configs(method)
    js = JSys.from_config(cfg, backend="interpret")
    ts = TSys.from_config(cfg, backend="interpret", device="cpu")
    assert js.mcfg.gs_stats and ts.mcfg.gs_stats
    jgm, _ = _full_map()
    tgm = _to_torch(jgm)
    color, depth, _, c2w = ds[2]
    c0 = np.asarray(ds[0][3])
    w2c = (np.linalg.inv(c2w) @ c0).astype(np.float32)
    color = (np.asarray(color) / 255.0).astype(np.float32)
    depth = np.asarray(depth, np.float32).reshape(32, 32)
    jgt = j_tiles(jnp.asarray(color), jnp.asarray(depth), js.opts.grid)
    tgt = t_tiles(torch.tensor(color), torch.tensor(depth), ts.opts.grid)
    _, _, ja = j_step(jgm, jnp.asarray(w2c), jgt, j_exp(), jnp.bool_(False),
                      js.exp_sched_back, js.cam, js.opts, js.mcfg, js.lcfg)
    _, _, ta = t_step(tgm, torch.tensor(w2c), tgt, t_exp("cpu"), False,
                      ts.exp_sched_back, ts.cam, ts.opts, ts.mcfg, ts.lcfg)
    np.testing.assert_array_equal(ta["visible"].numpy(),
                                  np.asarray(ja["visible"]))
    js_ = np.asarray(ja["densify_stat"])
    assert js_.max() > 0 and np.asarray(ja["visible"]).sum() > 100
    ts_ = ta["densify_stat"].numpy()
    if method == "2dgs":
        err = np.linalg.norm(ts_ - js_) / np.linalg.norm(js_)
        assert err <= 1e-3, err
    else:
        np.testing.assert_allclose(ts_, js_, rtol=0,
                                   atol=1e-5 * float(js_.max()))


def test_backend_gs_densify_step_matches_jax(monkeypatch):
    """Both backends fed the same statistics: densify_and_prune runs at
    the same mapping steps, on the same mean statistic, with the same
    draws taken from the schedule's RNG; the statistics restart after."""
    from gaus_slam_tpu.slam import backend as JB
    from gaus_slam_tpu_torch.slam import backend as TB

    cfg, _ = _configs("2dgs")
    cfg["tpu"]["mesh_devices"] = "off"
    jb = JB.Backend(cfg, backend="interpret")
    tb = TB.Backend(cfg, backend="interpret", device="cpu")
    jgm, _ = _full_map()
    jb.map, tb.map = jgm, _to_torch(jgm)
    calls = {"jax": [], "torch": []}

    def spy(lib, real):
        def f(gm, grads, key_or_gen, **kw):
            calls[lib].append((np.asarray(grads).copy(), kw))
            return real(gm, grads, key_or_gen, **kw)
        return f

    monkeypatch.setattr(JG, "densify_and_prune",
                        spy("jax", JG.densify_and_prune))
    monkeypatch.setattr(TG, "densify_and_prune",
                        spy("torch", TG.densify_and_prune))
    rng = np.random.default_rng(1)
    cap = jgm.capacity
    for it in range(7):
        stat = rng.uniform(0, 1e-3, cap).astype(np.float32)
        vis = rng.uniform(size=cap) > 0.3
        jb._gs_densify_step({"densify_stat": jnp.asarray(stat),
                             "visible": jnp.asarray(vis)})
        tb._gs_densify_step({"densify_stat": torch.tensor(stat),
                             "visible": torch.tensor(vis)})
        assert tb.mapping_iter == jb.mapping_iter == it + 1
        assert (tb.grad_accum is None) == (jb.grad_accum is None)
        if tb.grad_accum is not None:
            np.testing.assert_allclose(tb.grad_accum.numpy(), jb.grad_accum,
                                       rtol=1e-6)
            np.testing.assert_array_equal(tb.grad_denom.numpy(),
                                          jb.grad_denom)
    # interval 3: after mapping steps 2 and 5
    assert len(calls["torch"]) == len(calls["jax"]) == 2
    for (tg, tkw), (jg, jkw) in zip(calls["torch"], calls["jax"]):
        assert tkw == jkw
        np.testing.assert_allclose(tg, jg, rtol=1e-6)
    assert tb.rng.random() == jb.rng.random()
    assert int(tb.map.n_active) == int(jb.map.n_active)
    assert tb.map.capacity == jb.map.capacity
