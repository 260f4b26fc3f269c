"""Port parity of the map and pose state (models/gaussians.py,
models/frame.py) against the JAX package on the same numpy-seeded
inputs: optimizer surgery (grow, prune, resize, opacity cap) exactly,
and the Adam steps to 1e-6 relative (the same float32 formulas; the bias
corrections are evaluated in float32 by both).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaus_slam_tpu.models import frame as JF
from gaus_slam_tpu.models import gaussians as JG
from gaus_slam_tpu_torch import convert
from gaus_slam_tpu_torch.models import frame as TF
from gaus_slam_tpu_torch.models import gaussians as TG


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


FIELDS = JG.PARAM_FIELDS
LRS = {"xyz_lr": 1e-4, "scaling_lr": 1e-3, "rotation_lr": 1e-3,
       "opacity_lr": 5e-2, "rgb_lr": 2.5e-3}


def _to_np(p):
    return {f: np.asarray(getattr(p, f)) for f in FIELDS}


def jax_to_port(gm):
    return convert.gaussian_map_from_numpy(
        {"params": _to_np(gm.params), "m": _to_np(gm.m), "v": _to_np(gm.v),
         "step": np.asarray(gm.step), "active": np.asarray(gm.active),
         "n_active": np.asarray(gm.n_active)}, device="cpu")


def assert_maps_equal(jgm, tgm, rtol=0.0):
    assert int(tgm.n_active) == int(jgm.n_active)
    assert tgm.step == int(jgm.step)
    np.testing.assert_array_equal(tgm.active.numpy(), np.asarray(jgm.active))
    for part in ("params", "m", "v"):
        for f in FIELDS:
            a = np.asarray(getattr(getattr(jgm, part), f))
            b = getattr(getattr(tgm, part), f).numpy()
            np.testing.assert_allclose(b, a, rtol=rtol, atol=0 if rtol == 0
                                       else 1e-12, err_msg=f"{part}.{f}")


def grown_maps(seed, cap=96, n=64):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    col = rng.uniform(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    scale = rng.uniform(0.01, 0.1, n).astype(np.float32)
    valid = rng.uniform(size=n) < 0.7
    jgm = JG.add_gaussians(JG.empty_map(cap), jnp.asarray(pts),
                           jnp.asarray(col), jnp.asarray(nrm),
                           jnp.asarray(scale), valid=jnp.asarray(valid))
    tgm = TG.add_gaussians(TG.empty_map(cap, device="cpu"), torch.tensor(pts),
                           torch.tensor(col), torch.tensor(nrm),
                           torch.tensor(scale), valid=torch.tensor(valid))
    return jgm, tgm, rng


def test_grow_prune_resize_cap_match_jax():
    jgm, tgm, rng = grown_maps(0)
    assert_maps_equal(jgm, tgm, rtol=1e-6)
    # a second grow past capacity drops the overflow rows in both
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    scale = rng.uniform(0.01, 0.1, 64).astype(np.float32)
    jgm = JG.add_gaussians(jgm, jnp.asarray(pts), jnp.asarray(pts), None,
                           jnp.asarray(scale))
    tgm = TG.add_gaussians(tgm, torch.tensor(pts), torch.tensor(pts), None,
                           torch.tensor(scale))
    assert int(jgm.n_active) == jgm.capacity
    assert_maps_equal(jgm, tgm, rtol=1e-6)
    tgm = jax_to_port(jgm)
    mask = rng.uniform(size=jgm.capacity) < 0.3
    jp = JG.prune(jgm, jnp.asarray(mask))
    tp = TG.prune(tgm, torch.tensor(mask))
    assert_maps_equal(jp, tp)
    assert_maps_equal(JG.resize_map(jp, 160), TG.resize_map(tp, 160))
    assert_maps_equal(JG.resize_map(jp, 64), TG.resize_map(tp, 64))
    assert_maps_equal(JG.cap_opacity(jp, 0.01), TG.cap_opacity(tp, 0.01))
    for n in (0, 5, 70000, 300000):
        assert TG.bucket_capacity(n, 1 << 16, 1.2, 131072) == \
            JG.bucket_capacity(n, 1 << 16, 1.2, 131072)


@pytest.mark.parametrize("isotropic", [False, True])
def test_adam_step_matches_jax(isotropic):
    jgm, _, rng = grown_maps(2)
    tgm = jax_to_port(jgm)
    for _ in range(3):
        g = {f: rng.normal(size=np.asarray(getattr(jgm.params, f)).shape)
             .astype(np.float32) for f in FIELDS}
        jgm = JG.adam_step(jgm, JG.Params(**{k: jnp.asarray(v)
                                             for k, v in g.items()}),
                           LRS, isotropic=isotropic)
        tgm = TG.adam_step(tgm, TG.Params(**{k: torch.tensor(v)
                                             for k, v in g.items()}),
                           LRS, isotropic=isotropic)
    assert_maps_equal(jgm, tgm, rtol=1e-6)


def test_pose_and_exposure_adam_match_jax():
    rng = np.random.default_rng(3)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = rng.normal(size=3)
    jp = JF.init_pose(jnp.asarray(w2c))
    tp = TF.init_pose(w2c, device="cpu")
    js = (JF.LrSchedule(4e-4, 8e-5, 30), JF.LrSchedule(2e-3, 4e-4, 30))
    ts = (TF.LrSchedule(4e-4, 8e-5, 30), TF.LrSchedule(2e-3, 4e-4, 30))
    je, te = JF.init_exposure(), TF.init_exposure(device="cpu")
    esj, est = JF.LrSchedule(5e-3, 1e-4, 60), TF.LrSchedule(5e-3, 1e-4, 60)
    for k in range(5):
        gq = rng.normal(size=4).astype(np.float32)
        gt = rng.normal(size=3).astype(np.float32)
        jp = JF.pose_adam_step(jp, jnp.asarray(gq), jnp.asarray(gt), *js)
        tp = TF.pose_adam_step(tp, torch.tensor(gq), torch.tensor(gt), *ts)
        ge = rng.normal(size=2).astype(np.float32)
        je = JF.exposure_adam_step(je, jnp.asarray(ge[0]), jnp.asarray(ge[1]),
                                   esj)
        te = TF.exposure_adam_step(te, torch.tensor(ge[0]),
                                   torch.tensor(ge[1]), est)
        assert ts[1].at(k) == pytest.approx(float(js[1].at(k)), rel=1e-7)
    for f in ("quat", "trans", "m_q", "v_q", "m_t", "v_t"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), rtol=1e-6,
                                   atol=1e-9, err_msg=f)
    np.testing.assert_allclose(tp.w2c.numpy(), np.asarray(jp.w2c), rtol=1e-6,
                               atol=1e-7)
    for f in ("gain", "bias", "m", "v"):
        np.testing.assert_allclose(getattr(te, f).numpy(),
                                   np.asarray(getattr(je, f)), rtol=1e-6,
                                   atol=1e-9, err_msg=f)
    assert tp.step == int(jp.step) == 5 and te.step == int(je.step)
    back = convert.pose_from_numpy(convert.pose_to_numpy(tp), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back[:6], tp[:6]))
