"""The port's SystemConfig against the JAX package's, from the same config
file: every field equal for each backend and component, the same
escalation ladder, and the configurations the port refuses."""
import os

import numpy as np
import pytest

from gaus_slam_tpu_torch.utils import config as TC

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs",
                      "synthetic", "config.py")


def _configs():
    from gaus_slam_tpu.data.synthetic import SyntheticDataset
    from gaus_slam_tpu.utils import config as JC

    ds = SyntheticDataset(height=120, width=160, num_frames=4)
    j, t = JC.load_config(CONFIG), TC.load_config(CONFIG)
    JC.probe_cameras(j, ds[0][0], ds.intrinsics)
    TC.probe_cameras(t, ds[0][0], ds.intrinsics)
    assert t == j
    return JC, j


def _plain(x):
    """NamedTuples and tuples as nested plain tuples."""
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    return x


def _assert_same(tsys, jsys):
    for f in ("height", "width", "fx", "fy", "cx", "cy"):
        assert getattr(tsys.cam, f) == getattr(jsys.cam, f), f
    np.testing.assert_array_equal(tsys.cam.w2c.numpy(), np.asarray(jsys.cam.w2c))
    # every RenderOptions field of the port; JAX's extra ones are the
    # values the port supports
    for f in tsys.opts._fields:
        assert _plain(getattr(tsys.opts, f)) == _plain(getattr(jsys.opts, f)), f
    assert (jsys.opts.method, jsys.opts.compute_dtype) == ("2dgs", "f32")
    for name in ("lcfg", "dcfg", "mcfg", "track_front", "track_back",
                 "exp_sched_front", "exp_sched_back"):
        t, j = getattr(tsys, name), getattr(jsys, name)
        # MapConfig.gs_stats (backend gs_densify) waits for the backend
        assert set(j._fields) - set(t._fields) <= {"gs_stats"}, name
        for f in t._fields:
            assert _plain(getattr(t, f)) == _plain(getattr(j, f)), (name, f)
    assert tsys.adam_betas == jsys.adam_betas
    assert tsys.DMAX_LADDER == jsys.DMAX_LADDER


@pytest.mark.parametrize("backend", ["pallas", "interpret", "reference"])
@pytest.mark.parametrize("component", ["frontend", "backend"])
def test_system_config_matches_jax(backend, component):
    JC, cfg = _configs()
    jsys = JC.SystemConfig.from_config(cfg, backend=backend,
                                       component=component)
    tsys = TC.SystemConfig.from_config(cfg, backend=backend,
                                       component=component, device="cpu")
    _assert_same(tsys, jsys)
    assert tsys.opts.backend == backend


def test_knobs_that_change_numerics_follow_the_config():
    JC, cfg = _configs()
    tpu = cfg["tpu"]
    tpu.update(pair_budget_factor_frontend=1.6, max_tiles_per_gaussian=6,
               frontend_pair_cap=300000)
    cfg["frontend"].update(converged_th=1e-3, coarse_levels=[(10, 4), (6, 2)])
    cfg["render"]["enable_exposure"] = True
    jsys = JC.SystemConfig.from_config(cfg, component="frontend")
    tsys = TC.SystemConfig.from_config(cfg, component="frontend", device="cpu")
    _assert_same(tsys, jsys)
    assert (tsys.opts.pair_budget_factor, tsys.opts.max_tiles_per_gaussian,
            tsys.opts.pair_cap) == (1.6, 6, 300000)
    assert tsys.track_front.levels() == ((10, 4), (6, 2))
    assert tsys.opts.r_max(1 << 17) == jsys.opts.r_max(1 << 17)


def test_escalation_ladder_matches_jax():
    """The same diagnostics walk both packages up the same ladder: a
    factor sized to demand, the minimal 1.125x step, the blind 1.5x step,
    d_max up the ladder, the explicit pair cap in 2^17-row steps, and no
    change when budgets hold."""
    JC, cfg = _configs()
    steps = [dict(overflow=True, n_shrunk=0, n_active=1 << 17,
                  demand=400000),
             dict(overflow=True, n_shrunk=0, n_active=1 << 17, demand=1000),
             dict(overflow=True, n_shrunk=0, n_active=0, demand=0),
             dict(overflow=False, n_shrunk=5000, n_active=1 << 17),
             dict(overflow=False, n_shrunk=5000, n_active=1 << 17),
             dict(overflow=False, n_shrunk=10, n_active=1 << 17)]
    for cap in (0, 250000):
        cfg["tpu"]["frontend_pair_cap"] = cap
        j = JC.SystemConfig.from_config(cfg, component="frontend")
        t = TC.SystemConfig.from_config(cfg, component="frontend",
                                        device="cpu")
        walked = []
        for d in steps:
            jn, tn = j.maybe_escalate(**d), t.maybe_escalate(**d)
            assert (jn is None) == (tn is None), d
            if jn is not None:
                j, t = jn, tn
            _assert_same(t, j)
            walked.append((t.opts.pair_budget_factor, t.opts.pair_cap,
                           t.opts.max_tiles_per_gaussian))
        assert len(set(walked)) >= 4, walked


@pytest.mark.parametrize("key,value", [
    (("tpu", "compute_dtype"), "bf16"),
    (("render", "method"), "3dgs"),
    (("frontend", "coarse_levels"), [(10, 3), (6, 2)]),
])
def test_refused_configs(key, value):
    """Unnested pyramid strides are refused. The 3DGS method and the bf16
    compute dtype are ported: each loads, and an unknown method or dtype
    is refused."""
    _, cfg = _configs()
    cfg[key[0]][key[1]] = value
    if key == ("render", "method"):
        assert TC.SystemConfig.from_config(cfg, device="cpu").opts.method \
            == value
        cfg["render"]["method"] = "nerf"
    if key == ("tpu", "compute_dtype"):
        opts = TC.SystemConfig.from_config(cfg, device="cpu").opts
        assert opts.compute_dtype == value
        assert opts.settings().compute_dtype == value
        cfg["tpu"]["compute_dtype"] = "f16"
    with pytest.raises(ValueError):
        TC.SystemConfig.from_config(cfg, device="cpu")


def test_unknown_backend_is_refused():
    _, cfg = _configs()
    with pytest.raises(ValueError):
        TC.SystemConfig.from_config(cfg, backend="triton", device="cpu")
