"""Port parity: compositing.composite_chunk and finalize (the plain
PyTorch version of the rasterizer kernels' per-block math) against the
JAX function on the same [128, 256] block, forward and vjp.

Tolerances: forward 1e-5 relative to each field's scale, vjp 1e-4 —
float32 reassociation (the JAX version sums prefixes with a triangular
matmul, the port with cumsum). Integer fields (done, n_contrib,
med_contrib) must match exactly: the block is drawn away from the
termination threshold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaus_slam_tpu.ops import compositing as JC
from gaus_slam_tpu.ops.camera import Camera as JCam
from gaus_slam_tpu.ops.preprocess import pack_pair_attrs, preprocess
from gaus_slam_tpu_torch.ops import compositing as TC


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_block(seed, G=128):
    """Depth-sorted attributes of G random surfels over one 16x16 tile,
    a random incoming pixel state and a validity mask."""
    rng = np.random.default_rng(seed)
    cam = JCam(16, 16, 20.0, 20.0, 8.0, 8.0, jnp.eye(4))
    z = rng.uniform(1.0, 3.0, G)
    u = rng.uniform(0.0, 16.0, (G, 2))
    xyz = np.stack([(u[:, 0] - 8) * z / 20, (u[:, 1] - 8) * z / 20, z], -1)
    sc = rng.uniform(0.05, 0.3, (G, 2))
    q = rng.normal(size=(G, 4)) * 0.3
    q[:, 0] += 1
    op = rng.uniform(0.2, 0.99, G)
    col = rng.uniform(0, 1, (G, 3))
    f = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    pre = preprocess(f(xyz), f(sc), f(q), f(op), cam)
    attrs = np.asarray(pack_pair_attrs(pre, f(col)).T)
    attrs = attrs[np.argsort(np.asarray(pre.depth))].astype(np.float32)
    p = np.arange(256)
    px = (p % 16).astype(np.float32)[None]
    py = (p // 16).astype(np.float32)[None]
    valid = np.ones((G, 1), np.float32)
    valid[:5] = 0.0   # the block starts before the tile's range
    st = {k: rng.uniform(0, 0.3, (1, 256)).astype(np.float32)
          for k in JC.PixelState._fields}
    st["T"] = rng.uniform(0.3, 1.0, (1, 256)).astype(np.float32)
    st["done"] = (rng.uniform(size=(1, 256)) < 0.1).astype(np.float32)
    st["n_contrib"] = np.zeros((1, 256), np.float32)
    st["med_contrib"] = np.zeros((1, 256), np.float32)
    return attrs, px, py, valid, st, rng


def _scale(a):
    return max(float(np.abs(a).max()), 1e-3)


@pytest.mark.parametrize("use_sa", [True, False])
@pytest.mark.parametrize("need_normal", [True, False])
def test_composite_chunk_forward_and_vjp(use_sa, need_normal):
    attrs, px, py, valid, st, rng = make_block(0 if use_sa else 1)
    idx_base = -4
    kw = dict(use_sa=use_sa, need_normal=need_normal)

    def jf(state, a):
        return JC.composite_chunk(state, a, jnp.asarray(px), jnp.asarray(py),
                                  jnp.int32(idx_base), jnp.asarray(valid), **kw)

    js = JC.PixelState(**{k: jnp.asarray(v) for k, v in st.items()})
    jo, vjp = jax.vjp(jf, js, jnp.asarray(attrs))
    cot = {k: rng.normal(size=(1, 256)).astype(np.float32)
           for k in JC.PixelState._fields}
    jd_state, jd_attrs = vjp(JC.PixelState(**{k: jnp.asarray(v)
                                              for k, v in cot.items()}))

    ts = TC.PixelState(**{k: torch.tensor(v, requires_grad=True)
                          for k, v in st.items()})
    ta = torch.tensor(attrs, requires_grad=True)
    to = TC.composite_chunk(ts, ta, torch.tensor(px), torch.tensor(py),
                            torch.tensor(idx_base), torch.tensor(valid), **kw)
    for f in JC.PixelState._fields:
        a, b = np.asarray(getattr(jo, f)), getattr(to, f).detach().numpy()
        if f in ("done", "n_contrib", "med_contrib"):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * _scale(a),
                                       err_msg=f)
    assert float(np.asarray(jo.done).max()) == 1.0   # some pixels terminate

    outs, gouts = [], []
    for f in JC.PixelState._fields:
        o = getattr(to, f)
        if o.requires_grad:
            outs.append(o)
            gouts.append(torch.tensor(cot[f]))
    inputs = list(ts) + [ta]
    grads = torch.autograd.grad(outs, inputs, gouts, allow_unused=True)
    for f, g in zip(JC.PixelState._fields, grads[:-1]):
        a = np.asarray(getattr(jd_state, f))
        b = np.zeros_like(a) if g is None else g.numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * _scale(a),
                                   err_msg=f)
    a = np.asarray(jd_attrs)
    for c in range(a.shape[1]):
        np.testing.assert_allclose(grads[-1].numpy()[:, c], a[:, c], rtol=0,
                                   atol=1e-4 * _scale(a[:, c]),
                                   err_msg=f"attr {c}")
    assert np.abs(a).max() > 0


def test_finalize_matches_jax():
    rng = np.random.default_rng(3)
    st = {k: rng.uniform(0, 1, (1, 256)).astype(np.float32)
          for k in JC.PixelState._fields}
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    for use_sa in (True, False):
        a = JC.finalize(JC.PixelState(**{k: jnp.asarray(v)
                                         for k, v in st.items()}),
                        jnp.asarray(bg), use_sa=use_sa)
        b = TC.finalize(TC.PixelState(**{k: torch.tensor(v)
                                         for k, v in st.items()}),
                        torch.tensor(bg), use_sa=use_sa)
        assert b.shape == (TC.OUT_C, 256)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)
