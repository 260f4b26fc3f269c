"""Port parity of the differentiable rasterizer (ops/raster.py and the
plain versions of K1/K2/K3) against the JAX ``render_pairs`` with the
Pallas kernels in interpret mode, plus the CUDA kernels' per-pixel math
(csrc/raster_common.cuh, built for the CPU with g++) against the plain
PyTorch versions, plus the kernels themselves on a card.

Tolerances, each relative to the channel's scale over the scene:
  * forward float channels 1e-4 and stash rows 1e-4 — float32 prefix
    sums in another order (cumsum / sequential / triangular matmul);
  * gradients: relative L2 1e-3 per attribute row and every element
    within 1e-2 of the row's scale, against JAX and for the kernel math —
    the same rounding through the reverse sweep, amplified where SA's
    fusion weight reads the cancelling variance estimate D2 - 2*D*mm,
    and moved where a pixel's termination test sits at its cutoff;
  * integer channels (n_contrib, med_contrib, done) and kexit exactly,
    except on pixels whose termination test sits within float rounding
    of its cutoff: those must stay under 0.5% of the pixels.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

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


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


H, W, F = 48, 64, 50.0
INT_CH = (13, 14, 15)
CSRC = Path(__file__).resolve().parent.parent / "gaus_slam_tpu_torch" / "csrc"


@pytest.fixture(scope="module")
def jref():
    """The JAX package's rasterizer, imported here and not at module level
    so the card-only tests of this file also run where jax is absent."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from gaus_slam_tpu.ops import binning as JB
    from gaus_slam_tpu.ops.pallas_forward import raster_forward_stash
    from gaus_slam_tpu.ops.raster import RenderSettings as JSettings
    from gaus_slam_tpu.ops.raster import render_pairs as j_render

    return SimpleNamespace(jax=jax, jnp=jnp, TileGrid=JB.TileGrid,
                           fwd=raster_forward_stash, Settings=JSettings,
                           render=j_render)


def scene(seed, n):
    """Pair-expanded attributes [24, R] of n random surfels binned onto the
    3x4 tile grid of a 48x64 camera (the port's preprocess and binning;
    test_torch_ops holds them to the JAX package), and the numpy
    generator for the loss cotangent."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 3.0, n)
    u, v = rng.uniform(0, W, n), rng.uniform(0, H, n)
    xyz = np.stack([(u - W / 2) * z / F, (v - H / 2) * z / F, z], -1)
    sc = rng.uniform(0.02, 0.12, (n, 2))
    q = rng.normal(size=(n, 4)) * 0.3
    q[:, 0] += 1.0
    op = rng.uniform(0.2, 0.99, n)
    col = rng.uniform(0, 1, (n, 3))
    f = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    cam = TCam(H, W, F, F, W / 2, H / 2, torch.eye(4))
    pre = TP.preprocess(f(xyz), f(sc), f(q), f(op), cam)
    grid = TB.make_grid(cam, 16, 16)
    bins = TB.bin_gaussians(pre, grid, r_max=-(-n * 6 // 128) * 128,
                            max_tiles_per_gaussian=6)
    attrs_t = TP.pack_pair_attrs(pre, f(col)).T
    pattrs = attrs_t[bins.pair_gauss.long()].T.contiguous().numpy()
    return grid, bins.tile_start.numpy(), bins.tile_stop.numpy(), pattrs, rng


def _mismatch(a, b):
    """Fraction of pixels whose integer channels differ."""
    bad = np.zeros(a.shape[:1] + a.shape[2:], bool)
    for c in INT_CH:
        bad |= a[:, c] != b[:, c]
    return bad, float(bad.mean())


def assert_out_close(got, ref, tol=1e-4):
    bad, frac = _mismatch(got, ref)
    assert frac < 5e-3, frac
    for c in range(13):
        scale = max(np.abs(ref[:, c]).max(), 1e-3)
        err = np.abs(got[:, c] - ref[:, c])[~bad]
        assert err.max(initial=0.0) <= tol * scale, (c, err.max(), scale)


def assert_stash_close(got, ref, soff, kexit, tol=1e-4):
    """Rows the forward wrote (tile i owns soff[i] .. soff[i]+kexit[i])."""
    rows = np.concatenate([np.arange(int(o), int(o) + int(k))
                           for o, k in zip(soff, kexit)]).astype(np.int64)
    for c in range(8):
        r = ref[rows, c]
        scale = max(np.abs(r).max(), 1e-3)
        np.testing.assert_allclose(got[rows, c], r, rtol=0, atol=tol * scale,
                                   err_msg=f"stash row {c}")


def assert_grad_close(got, ref, tol_l2, tol_max=1e-2):
    """Per attribute row: relative L2 error <= tol_l2, and every element
    within tol_max of the row's scale — a pair composited by a pixel
    whose termination test sits at its cutoff takes a different gradient
    share, so single elements may move more than the row as a whole."""
    for c in range(24):
        err = np.abs(got[c] - ref[c])
        norm = max(np.linalg.norm(ref[c]), 1e-12)
        scale = max(np.abs(ref[c]).max(), 1e-12)
        assert np.linalg.norm(err) <= tol_l2 * norm + 1e-30, \
            (c, np.linalg.norm(err) / norm)
        assert err.max() <= tol_max * scale, (c, err.max() / scale)
    assert np.abs(got[21:]).max() == 0.0


CASES = [(True, False), (False, False), (True, True)]


@pytest.mark.parametrize("use_sa,subset", CASES)
def test_render_pairs_matches_jax(jref, use_sa, subset):
    """Forward, stash, kexit and the gradient through torch.autograd vs
    jax.grad through the JAX render_pairs (interpret-mode kernels), on
    multi-block tiles with early termination; ``subset`` renders every
    other tile (tile_ids)."""
    grid, ts, te, pattrs, rng = scene(0, 1300)
    assert (te - ts).max() > 256          # tiles span several blocks
    ids = np.arange(grid.num_tiles, dtype=np.int32)
    if subset:
        ids = ids[1::2]
    ts_s, te_s = ts[ids], te[ids]
    tgrid = TileGrid(*grid)
    jgrid, jnp = jref.TileGrid(*grid), jref.jnp

    jo, js, jk = jref.fwd(jnp.asarray(pattrs), jnp.asarray(ts_s),
                          jnp.asarray(te_s), grid=jgrid, use_sa=use_sa,
                          interpret=True, tile_ids=jnp.asarray(ids))
    to, tst, tk = TRF.raster_forward_stash(
        torch.tensor(pattrs), torch.tensor(ts_s), torch.tensor(te_s),
        grid=tgrid, use_sa=use_sa, tile_ids=torch.tensor(ids))
    jo, js, jk = map(np.asarray, (jo, js, jk))
    np.testing.assert_array_equal(tk.numpy(), jk)
    assert_out_close(to.numpy(), jo)
    assert float(to[:, 15].max()) == 1.0      # some pixels terminate
    soff = TRF.stash_offsets(torch.tensor(ts_s), torch.tensor(te_s)).numpy()
    assert_stash_close(tst.numpy(), js, soff, jk)

    dw = rng.normal(size=(len(ids), 16, 256)).astype(np.float32)
    dw[:, 10:] = 0.0
    st = jref.Settings(grid=jgrid, use_sa=use_sa, backend="interpret")

    def jloss(a):
        out = jref.render(a, jnp.asarray(ts_s), jnp.asarray(te_s),
                          jnp.asarray(ids), st)
        return jnp.sum(out * dw)

    jg = np.asarray(jref.jax.grad(jloss)(jnp.asarray(pattrs)))
    ta = torch.tensor(pattrs, requires_grad=True)
    out = render_pairs(ta, torch.tensor(ts_s), torch.tensor(te_s),
                       torch.tensor(ids), RenderSettings(tgrid, use_sa))
    np.testing.assert_allclose(out.detach().numpy(), to.numpy(), rtol=0,
                               atol=0)
    (tg,) = torch.autograd.grad(torch.sum(out * torch.tensor(dw)), ta)
    assert_grad_close(tg.numpy(), jg, 1e-3)
    if subset:
        # pairs of tiles outside tile_ids get exactly zero gradient
        other = np.ones(pattrs.shape[1], bool)
        for a, b in zip(ts_s, te_s):
            other[a:b] = False
        assert np.abs(tg.numpy()[:, other]).max() == 0.0


def test_render_pairs_without_grad_uses_plain_forward():
    grid, ts, te, pattrs, _ = scene(1, 300)
    tgrid = TileGrid(*grid)
    with torch.no_grad():
        out = render_pairs(torch.tensor(pattrs), torch.tensor(ts),
                           torch.tensor(te), None, RenderSettings(tgrid, True))
    ref = TRF.raster_forward(torch.tensor(pattrs), torch.tensor(ts),
                             torch.tensor(te), grid=tgrid)
    assert out.shape == (grid.num_tiles, 16, 256)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


@pytest.fixture(scope="module")
def host_math(tmp_path_factory):
    """csrc/pixel_math_host.cpp (the kernels' per-pixel math) built for the
    CPU with g++."""
    gxx = shutil.which("g++")
    assert gxx is not None, "g++ is needed to build the kernel math for the CPU"
    lib = tmp_path_factory.mktemp("pixel_math") / "libpixel_math_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(lib), str(CSRC / "pixel_math_host.cpp")],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def host_forward(lib, pattrs, ts, te, ids, tiles_x, use_sa, nn):
    r, n_sub = pattrs.shape[1], len(ids)
    soff = TRF.stash_offsets(torch.tensor(ts), torch.tensor(te)).numpy()
    out = np.zeros((n_sub, 16, 256), np.float32)
    n_rows = TRF.stash_rows(r, n_sub)
    stash = np.zeros((n_rows, 8, 256), np.float32)
    kexit = np.zeros(n_sub, np.int32)
    args = [np.ascontiguousarray(a) for a in (pattrs, ids, ts, te, soff)]
    lib.host_raster_forward(_ptr(args[0]), r, *map(_ptr, args[1:]), n_sub,
                            tiles_x, int(use_sa), int(nn), 1, n_rows,
                            _ptr(out), _ptr(stash), _ptr(kexit))
    return out, stash, kexit


def host_backward(lib, pattrs, ts, te, ids, tiles_x, use_sa, nn, stash,
                  kexit, out, d_out):
    r, n_sub = pattrs.shape[1], len(ids)
    soff = TRF.stash_offsets(torch.tensor(ts), torch.tensor(te)).numpy()
    d0 = TRB.finalize_cotangents(torch.tensor(out), torch.tensor(d_out),
                                 torch.zeros(3), use_sa=use_sa).numpy()
    d = np.zeros((24, r), np.float32)
    args = [np.ascontiguousarray(a) for a in
            (pattrs, ids, ts, te, soff, kexit, stash, d0)]
    lib.host_raster_backward(_ptr(args[0]), r, *map(_ptr, args[1:7]),
                             stash.shape[0], _ptr(args[7]), n_sub, tiles_x,
                             int(use_sa), int(nn), _ptr(d))
    return d


@pytest.mark.parametrize("use_sa,nn,subset", [(True, False, False),
                                              (False, True, False),
                                              (True, True, True)])
def test_kernel_math_matches_plain(host_math, use_sa, nn, subset):
    """The CUDA kernels' arithmetic (forward, stash, kexit and the
    hand-derived reverse sweep) run on the CPU, against the plain
    versions (torch.autograd through composite_chunk for the gradient)."""
    grid, ts, te, pattrs, rng = scene(2, 1300)
    ids = np.arange(grid.num_tiles, dtype=np.int32)
    if subset:
        ids = ids[::3]
    ts_s, te_s = ts[ids].astype(np.int32), te[ids].astype(np.int32)
    tgrid = TileGrid(*grid)
    kw = dict(grid=tgrid, use_sa=use_sa, need_normal=nn,
              tile_ids=torch.tensor(ids))
    po, pst, pk = TRF.raster_forward_plain(
        torch.tensor(pattrs), torch.tensor(ts_s), torch.tensor(te_s), **kw)
    ho, hst, hk = host_forward(host_math, pattrs, ts_s, te_s, ids,
                               grid.tiles_x, use_sa, nn)
    np.testing.assert_array_equal(hk, pk.numpy())
    assert_out_close(ho, po.numpy())
    soff = TRF.stash_offsets(torch.tensor(ts_s), torch.tensor(te_s)).numpy()
    assert_stash_close(hst, pst.numpy(), soff, hk)

    d_out = rng.normal(size=ho.shape).astype(np.float32)
    d_out[:, 10:] = 0.0
    pg = TRB.raster_backward_stash_plain(
        torch.tensor(pattrs), torch.tensor(ts_s), torch.tensor(te_s),
        torch.tensor(hst), torch.tensor(hk), torch.tensor(ho),
        torch.tensor(d_out), **kw).numpy()
    hg = host_backward(host_math, pattrs, ts_s, te_s, ids, grid.tiles_x,
                       use_sa, nn, hst, hk, ho, d_out)
    assert_grad_close(hg, pg, 1e-3)
    assert np.abs(hg).max() > 0.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("use_sa", [True, False])
def test_cuda_kernels_match_plain(cuda_device, use_sa):
    """K1 / K3 / K2 on the card against their plain versions."""
    grid, ts, te, pattrs, rng = scene(3, 1300)
    ids = torch.arange(1, grid.num_tiles, 2, dtype=torch.int32,
                       device=cuda_device)
    tgrid = TileGrid(*grid)
    dev = dict(device=cuda_device)
    a = torch.tensor(pattrs, **dev)
    t0 = torch.tensor(ts, **dev)[ids.long()]
    t1 = torch.tensor(te, **dev)[ids.long()]
    kw = dict(grid=tgrid, use_sa=use_sa, tile_ids=ids)
    ko, kst, kk = TRF.raster_forward_stash(a, t0, t1, **kw)
    po, pst, pk = TRF.raster_forward_plain(a, t0, t1, **kw)
    k3 = TRF.raster_forward(a, t0, t1, **kw)
    assert torch.equal(k3, ko)
    assert torch.equal(kk, pk)
    assert_out_close(ko.cpu().numpy(), po.cpu().numpy())
    d_out = torch.tensor(rng.normal(size=ko.shape).astype(np.float32), **dev)
    d_out[:, 10:] = 0.0
    args = (a, t0, t1, kst, kk, ko, d_out)
    kg = TRB.raster_backward_stash(*args, **kw)
    pg = TRB.raster_backward_stash_plain(*args, **kw)
    assert_grad_close(kg.cpu().numpy(), pg.cpu().numpy(), 1e-3)
