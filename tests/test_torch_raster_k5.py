"""K5 — the reference render backend's no-stash backward — and the
reference forward, against the JAX package.

  * JAX ``pallas_backward.raster_backward(interpret=True)`` against the
    port's ``raster_backward_plain``, for use_sa x need_normal;
  * K5's CUDA tile logic (re-forward into a scratch stash, then the
    reverse sweep; csrc/pixel_math_host.cpp built with g++) against
    ``raster_backward_plain``;
  * ``raster_backward_plain`` against the stash path (plain K1 + plain K2)
    on the same input: the same function when no tile exceeds the
    512-block cap, so bit for bit;
  * ``render_pairs`` under backend="reference", forward and vjp, against
    JAX's (its forward traces num_tiles x R/128 chunks, so a 32x32 image
    and R <= 2048);
  * K5 on a card against its plain version and against K2.

Tolerances as tests/test_torch_raster.py: gradients to 1e-3 relative L2
per attribute row and every element within 1e-2 of the row's scale
(float32 prefix sums in another order, amplified by SA's fusion weight);
forward float channels to 1e-4 of the channel's scale, integer channels
equal except on < 0.5% of the pixels.
"""

import numpy as np
import pytest
import torch

from gaus_slam_tpu_torch.ops import binning as TB
from gaus_slam_tpu_torch.ops import preprocess as TP
from gaus_slam_tpu_torch.ops import raster_backward as TRB
from gaus_slam_tpu_torch.ops import raster_forward as TRF
from gaus_slam_tpu_torch.ops.binning import TileGrid
from gaus_slam_tpu_torch.ops.camera import Camera as TCam
from gaus_slam_tpu_torch.ops.raster import RenderSettings, render_pairs
from test_torch_raster import (_ptr, assert_grad_close, assert_out_close,
                               host_math)  # noqa: F401  (fixture)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


F = 50.0


def scene(seed, n, h=48, w=64, r_max=None):
    """Pair-expanded attributes [24, R] of n random surfels binned onto the
    tile grid of an h x w camera, the forward's output (plain K1) as the
    saved output, and a loss cotangent."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 3.0, n)
    u, v = rng.uniform(0, w, n), rng.uniform(0, h, n)
    xyz = np.stack([(u - w / 2) * z / F, (v - h / 2) * z / F, z], -1)
    sc = rng.uniform(0.02, 0.12, (n, 2))
    q = rng.normal(size=(n, 4)) * 0.3
    q[:, 0] += 1.0
    op = rng.uniform(0.2, 0.99, n)
    col = rng.uniform(0, 1, (n, 3))
    f = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    cam = TCam(h, w, F, F, w / 2, h / 2, torch.eye(4))
    pre = TP.preprocess(f(xyz), f(sc), f(q), f(op), cam)
    grid = TB.make_grid(cam, 16, 16)
    bins = TB.bin_gaussians(pre, grid, r_max=r_max or -(-n * 6 // 128) * 128,
                            max_tiles_per_gaussian=6)
    attrs_t = TP.pack_pair_attrs(pre, f(col)).T
    pattrs = attrs_t[bins.pair_gauss.long()].T.contiguous()
    ts, te = bins.tile_start, bins.tile_stop
    out = TRF.raster_forward_plain(pattrs, ts, te, grid=grid)[0]
    d_out = rng.normal(size=tuple(out.shape)).astype(np.float32)
    d_out[:, 10:] = 0.0
    return grid, ts, te, pattrs, out, torch.tensor(d_out)


@pytest.mark.parametrize("use_sa,nn", [(True, False), (True, True),
                                       (False, False), (False, True)])
def test_raster_backward_plain_matches_jax(use_sa, nn):
    jnp = pytest.importorskip("jax.numpy")
    from gaus_slam_tpu.ops.binning import TileGrid as JGrid
    from gaus_slam_tpu.ops.pallas_backward import raster_backward as j_k5

    grid, ts, te, pattrs, out, d_out = scene(5, 1300)
    assert int((te - ts).max()) > 256          # tiles span several blocks
    assert float(out[:, 15].max()) == 1.0      # some pixels terminate
    jg = np.asarray(j_k5(
        jnp.asarray(pattrs.numpy()), jnp.asarray(ts.numpy()),
        jnp.asarray(te.numpy()), jnp.asarray(out.numpy()),
        jnp.asarray(d_out.numpy()), grid=JGrid(*grid), use_sa=use_sa,
        need_normal=nn, interpret=True))
    tg = TRB.raster_backward_plain(pattrs, ts, te, out, d_out, grid=grid,
                                   use_sa=use_sa, need_normal=nn).numpy()
    assert_grad_close(tg, jg, 1e-3)
    assert np.abs(tg).max() > 0.0


def host_k5(lib, pattrs, ts, te, out, d_out, tiles_x, use_sa, nn):
    r, n = pattrs.shape[1], ts.shape[0]
    soff = TRF.stash_offsets(torch.tensor(ts), torch.tensor(te)).numpy()
    rows = TRF.stash_rows(r, n)
    scratch = np.zeros((rows, 8, 256), np.float32)
    d = np.zeros((24, r), np.float32)
    args = [np.ascontiguousarray(a) for a in (pattrs, ts, te, soff)]
    out, d_out = np.ascontiguousarray(out), np.ascontiguousarray(d_out)
    lib.host_raster_backward_restash(
        _ptr(args[0]), r, *map(_ptr, args[1:]), _ptr(scratch), rows,
        _ptr(out), _ptr(d_out), n, tiles_x, int(use_sa), int(nn), _ptr(d))
    return d


@pytest.mark.parametrize("use_sa,nn", [(True, False), (False, True)])
def test_k5_kernel_math_matches_plain(host_math, use_sa, nn):
    """K5's CUDA tile logic run on the CPU (re-forward with the block cap,
    then K2's hand-derived sweep) against the plain version."""
    grid, ts, te, pattrs, out, d_out = scene(6, 1300)
    ts32, te32 = ts.numpy().astype(np.int32), te.numpy().astype(np.int32)
    hg = host_k5(host_math, pattrs.numpy(), ts32, te32, out.numpy(),
                 d_out.numpy(), grid.tiles_x, use_sa, nn)
    pg = TRB.raster_backward_plain(pattrs, ts, te, out, d_out, grid=grid,
                                   use_sa=use_sa, need_normal=nn).numpy()
    assert_grad_close(hg, pg, 1e-3)
    assert np.abs(hg).max() > 0.0


def test_k5_plain_equals_stash_path():
    """Below the block cap K5's plain version is the stash path's: the
    plain K1 walk, then the plain K2 sweep over its stash."""
    grid, ts, te, pattrs, out, d_out = scene(7, 1300)
    kw = dict(grid=grid, use_sa=True, need_normal=False)
    o1, stash, kexit = TRF.raster_forward_plain(pattrs, ts, te, **kw)
    assert int(kexit.max()) < TRB.MAX_CHUNKS_PER_TILE
    k2 = TRB.raster_backward_stash_plain(pattrs, ts, te, stash, kexit, o1,
                                         d_out, **kw)
    k5 = TRB.raster_backward_plain(pattrs, ts, te, o1, d_out, **kw)
    assert torch.equal(k5, k2)


@pytest.mark.parametrize("use_sa", [True, False])
def test_reference_render_pairs_matches_jax(use_sa):
    """Forward (JAX composite_ref.render_tiles: tile-local windows, no
    stash) and vjp (K5) of render_pairs under backend="reference"."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from gaus_slam_tpu.ops.binning import TileGrid as JGrid
    from gaus_slam_tpu.ops.raster import RenderSettings as JSettings
    from gaus_slam_tpu.ops.raster import render_pairs as j_render

    grid, ts, te, pattrs, _, _ = scene(8, 300, h=32, w=32, r_max=1920)
    assert pattrs.shape[1] <= 2048 and int((te - ts).max()) > 128
    rng = np.random.default_rng(9)
    dw = rng.normal(size=(grid.num_tiles, 16, 256)).astype(np.float32)
    dw[:, 10:] = 0.0
    st = JSettings(grid=JGrid(*grid), use_sa=use_sa, backend="reference")

    def jloss(a):
        out = j_render(a, jnp.asarray(ts.numpy()), jnp.asarray(te.numpy()),
                       None, st)
        return jnp.sum(out * dw), out

    (_, jo), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(pattrs.numpy()))
    ta = pattrs.clone().requires_grad_()
    out = render_pairs(ta, ts, te, None,
                       RenderSettings(TileGrid(*grid), use_sa,
                                      backend="reference"))
    assert_out_close(out.detach().numpy(), np.asarray(jo))
    (tg,) = torch.autograd.grad(torch.sum(out * torch.tensor(dw)), ta)
    assert_grad_close(tg.numpy(), np.asarray(jg), 1e-3)
    with pytest.raises(ValueError):
        render_pairs(ta, ts[:2], te[:2], torch.arange(2, dtype=torch.int32),
                     RenderSettings(TileGrid(*grid), use_sa,
                                    backend="reference"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("use_sa", [True, False])
def test_cuda_k5_matches_plain_and_k2(cuda_device, use_sa):
    """K5 on the card against its plain version, and against K2 on K1's
    stash (the same carries, so the same gradient bit for bit: all three
    kernels are built with -fmad=false)."""
    grid, ts, te, pattrs, out, d_out = scene(10, 1300)
    a, t0, t1 = (x.to(cuda_device) for x in (pattrs, ts, te))
    kw = dict(grid=grid, use_sa=use_sa, need_normal=False)
    ko, kst, kk = TRF.raster_forward_stash(a, t0, t1, **kw)
    d = d_out.to(cuda_device)
    k5 = TRB.raster_backward(a, t0, t1, ko, d, **kw)
    p5 = TRB.raster_backward_plain(a, t0, t1, ko, d, **kw)
    k2 = TRB.raster_backward_stash(a, t0, t1, kst, kk, ko, d, **kw)
    torch.cuda.synchronize()
    assert_grad_close(k5.cpu().numpy(), p5.cpu().numpy(), 1e-3)
    assert torch.equal(k5, k2)
