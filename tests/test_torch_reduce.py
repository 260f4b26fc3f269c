"""Port parity of the per-gaussian gradient reduction (ops/binning.py):
``Binning.slab_scatter_grads`` on its run path (no budget truncation)
and its slab path (overflow), and ``phase_reduce`` of a phase-major
binning, against the JAX package on the same binning and the same
numpy-seeded pair gradients. The JAX run/phase paths land through the
interpret-mode gather kernel (backend="interpret").

Tolerance: 1e-5 absolute — the same sums of a handful of floats in
another association (segmented doubling scan in both; slab tree-sum).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaus_slam_tpu.ops import binning as JB
from gaus_slam_tpu.ops import preprocess as JP
from gaus_slam_tpu.ops.camera import Camera as JCam
from gaus_slam_tpu_torch.ops import binning as TB
from gaus_slam_tpu_torch.ops import preprocess as TP


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


H, W, F = 48, 64, 50.0


def binnings(seed, n, r_max, stride=0):
    rng = np.random.default_rng(seed)
    z = rng.uniform(0.8, 3.0, n)
    u, v = rng.uniform(-4, W + 4, n), rng.uniform(-4, H + 4, n)
    xyz = np.stack([(u - W / 2) * z / F, (v - H / 2) * z / F, z], -1)
    sc = np.exp(rng.uniform(np.log(0.02), np.log(0.2), (n, 2)))
    q = rng.normal(size=(n, 4)) * 0.3
    q[:, 0] += 1.0
    op = rng.uniform(0.1, 0.9, n)
    f = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    cam = JCam(H, W, F, F, W / 2, H / 2, jnp.eye(4))
    pre = JP.preprocess(f(xyz), f(sc), f(q), f(op), cam)
    s = {k: np.asarray(getattr(pre, k)) for k in JP.PreSummary._fields}
    grid = JB.TileGrid(-(-W // 16), -(-H // 16), 16, 16)
    kw = dict(r_max=r_max, max_tiles_per_gaussian=4, reduce_perm=True,
              phase_stride=stride)
    jb = JB.bin_gaussians(JP.PreSummary(**{k: jnp.asarray(v)
                                           for k, v in s.items()}), grid, **kw)
    tb = TB.bin_gaussians(TP.PreSummary(**{k: torch.tensor(v)
                                           for k, v in s.items()}),
                          TB.TileGrid(*grid), **kw)
    return jb, tb, rng


@pytest.mark.parametrize("r_max,overflow", [(2048, False), (384, True)])
def test_slab_scatter_grads_matches_jax(r_max, overflow):
    n = 256   # a multiple of 128: the JAX run path then uses its kernel
    jb, tb, rng = binnings(0, n, r_max)
    assert bool(tb.overflow) == overflow == bool(jb.overflow)
    g = rng.normal(size=(r_max, 24)).astype(np.float32)
    ref = np.asarray(jb.slab_scatter_grads(jnp.asarray(g), n,
                                           backend="interpret"))
    got = tb.slab_scatter_grads(torch.tensor(g), n).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # and the dense oracle: sum of the kept pairs' rows per gaussian
    oracle = np.zeros((n, 24), np.float64)
    pg, ok = tb.pair_gauss.numpy(), tb.pair_ok.numpy()
    np.add.at(oracle, pg[ok], g[ok])
    np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-5)


@pytest.mark.parametrize("phase", [0, 4, 8])
def test_phase_reduce_matches_jax(phase):
    n, stride = 256, 3
    jb, tb, rng = binnings(1, n, 2048, stride=stride)
    r_phase = -(-(2 * 2048) // (stride * stride * 128)) * 128 + 128
    g = rng.normal(size=(r_phase, 24)).astype(np.float32)
    ref = np.asarray(jb.phase_reduce(jnp.asarray(g), phase, n, 4,
                                     backend="interpret"))
    got = tb.phase_reduce(torch.tensor(g), phase, n, 4).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert np.abs(got).max() > 0
