"""The CUDA kernels' per-pixel math (csrc/raster_common.cuh, built for the
CPU with g++ as in test_torch_raster.py) on 3DGS pair attributes: the
EWA conic as a pixel-linear map with p_z == 1, t_w = (0, 0, z), and
surface-aware fusion off, the instantiation the "3dgs" render method
drives K1, K2 and K3 in.

  * K1's forward walk, its stash and kexit, and K2's reverse sweep
    against the plain versions: outputs and stash rows 1e-4 of each
    channel's scale; without SA the gradient is well conditioned, so
    every attribute row within 1e-5 relative L2 (and 1e-2 of its scale
    elementwise, as test_torch_raster.py holds pixels at their cutoff).
  * The walk's skips are bit-neutral on these attributes too: the math
    built with -DGS_FWD_NO_SKIP gives the same bits.
  * raster_common.cuh::pair_culled stays conservative: with p_z == 1 its
    3D test reads p_x^2 + p_y^2 > lim, and no pair it rejects for a
    pixel may pass that pixel's alpha test.
"""
import numpy as np
import pytest
import torch
from test_torch_raster import (_build_host_math, assert_grad_close,
                               assert_out_close, assert_stash_close,
                               cull_counts, host_backward, host_forward)

from gaus_slam_tpu_torch.ops import binning as TB
from gaus_slam_tpu_torch.ops import preprocess as TP
from gaus_slam_tpu_torch.ops import raster_backward as TRB
from gaus_slam_tpu_torch.ops import raster_forward as TRF
from gaus_slam_tpu_torch.ops.binning import TileGrid
from gaus_slam_tpu_torch.ops.camera import Camera as TCam
from gaus_slam_tpu_torch.ops.preprocess_3dgs import (preprocess_3dgs,
                                                     scales_to_3d)

H, W, F = 48, 64, 50.0


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host_math(tmp_path_factory):
    return _build_host_math(tmp_path_factory)


@pytest.fixture(scope="module")
def host_math_no_skip(tmp_path_factory):
    return _build_host_math(tmp_path_factory, "-DGS_FWD_NO_SKIP")


def scene_3dgs(seed, n, iso):
    """Pair-expanded 3DGS attributes [24, R] of n random gaussians on the
    3x4 tile grid of a 48x64 camera, and the numpy generator."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 3.0, n)
    u, v = rng.uniform(0, W, n), rng.uniform(0, H, n)
    xyz = np.stack([(u - W / 2) * z / F, (v - H / 2) * z / F, z], -1)
    sc = rng.uniform(0.01, 0.06, (n, 2))
    q = rng.normal(size=(n, 4))
    op = rng.uniform(0.2, 0.99, n)
    col = rng.uniform(0, 1, (n, 3))
    f = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    cam = TCam(H, W, F, F, W / 2, H / 2, torch.eye(4))
    pre = preprocess_3dgs(f(xyz), scales_to_3d(f(sc), iso), f(q), f(op), cam)
    grid = TB.make_grid(cam, 16, 16)
    bins = TB.bin_gaussians(pre, grid, r_max=-(-n * 6 // 128) * 128,
                            max_tiles_per_gaussian=6)
    assert not bool(bins.overflow)
    attrs_t = TP.pack_pair_attrs(pre, f(col)).T
    pattrs = attrs_t[bins.pair_gauss.long()].T.contiguous().numpy()
    return grid, bins.tile_start.numpy(), bins.tile_stop.numpy(), pattrs, rng


@pytest.mark.parametrize("iso,nn,subset", [(False, False, False),
                                           (True, True, False),
                                           (False, False, True)])
def test_kernel_math_on_3dgs_attrs(host_math, host_math_no_skip, iso, nn,
                                   subset):
    grid, ts, te, pattrs, rng = scene_3dgs(2, 700, iso)
    # the pixel-linear map: p_z == 1 for every pair and pixel
    assert (pattrs[2] == 0).all() and (pattrs[5] == 0).all()
    live = pattrs[17] > 0
    assert (pattrs[8][live] == 1).all()
    ids = np.arange(grid.num_tiles, dtype=np.int32)
    if subset:
        ids = ids[::3]
    ts_s, te_s = ts[ids].astype(np.int32), te[ids].astype(np.int32)
    tgrid = TileGrid(*grid)
    kw = dict(grid=tgrid, use_sa=False, need_normal=nn,
              tile_ids=torch.tensor(ids))
    po, pst, pk = TRF.raster_forward_plain(
        torch.tensor(pattrs), torch.tensor(ts_s), torch.tensor(te_s), **kw)
    ho, hst, hk = host_forward(host_math, pattrs, ts_s, te_s, ids,
                               grid.tiles_x, False, nn)
    np.testing.assert_array_equal(hk, pk.numpy())
    assert_out_close(ho, po.numpy())
    soff = TRF.stash_offsets(torch.tensor(ts_s), torch.tensor(te_s)).numpy()
    assert_stash_close(hst, pst.numpy(), soff, hk)
    assert ho[:, 4].max() > 0.5
    no = host_forward(host_math_no_skip, pattrs, ts_s, te_s, ids,
                      grid.tiles_x, False, nn)
    for a, b in zip((ho, hst, hk), no):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))

    d_out = rng.normal(size=ho.shape).astype(np.float32)
    d_out[:, 10:] = 0.0
    pg = TRB.raster_backward_stash_plain(
        torch.tensor(pattrs), torch.tensor(ts_s), torch.tensor(te_s),
        torch.tensor(hst), torch.tensor(hk), torch.tensor(ho),
        torch.tensor(d_out), **kw).numpy()
    hg = host_backward(host_math, pattrs, ts_s, te_s, ids, grid.tiles_x,
                       False, nn, hst, hk, ho, d_out)
    assert_grad_close(hg, pg, 1e-5)
    assert np.abs(hg).max() > 0.0


@pytest.mark.parametrize("iso", [False, True])
def test_cull_is_conservative_on_3dgs_attrs(host_math, iso):
    """No (pair, pixel) the cull rejects passes the alpha test, and the
    cull still rejects most of the walk."""
    grid, ts, te, pattrs, _ = scene_3dgs(5, 700, iso)
    evals, culled, wrong, _ = cull_counts(host_math, grid, ts, te, pattrs)
    assert wrong == 0
    assert culled > 0.5 * evals, (culled, evals)
