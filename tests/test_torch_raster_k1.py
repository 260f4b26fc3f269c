"""The forward walk's skips (csrc/raster_common.cuh: composite_block)
change no bit: K1 / K3 (and K5's re-forward) skip a pixel that is done, a
pair the cull rejects, the rest of a block once a pixel has triggered, and
SA's second pass outside the step mask. The kernels' per-pixel
math (csrc/pixel_math_host.cpp, built with g++) is built once as the card
runs it and once with -DGS_FWD_NO_SKIP, which evaluates every pair of the
tile's range for every pixel and re-walks them all in SA's second pass;
out, stash, kexit and the sweeps' gradients must agree bit for bit, on a
random scene, on one where most pixels trigger in mid-block and on one
with degenerate pairs. The card-only test holds K3, K5's re-forward and
K5's gradient to K1 and K2 on the card.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gaus_slam_tpu_torch.ops import raster_backward as TRB
from gaus_slam_tpu_torch.ops import raster_forward as TRF
from gaus_slam_tpu_torch.ops.binning import TileGrid
from gaus_slam_tpu_torch.ops.camera import ALPHA_MIN, FILTER_INV_SQUARE, NEAR_N
from test_torch_raster import (_build_host_math, _ptr, assert_out_close,
                               cull_counts, host_backward, host_forward,
                               host_math, scene)  # noqa: F401


@pytest.fixture(scope="module")
def host_math_no_skip(tmp_path_factory):
    """The kernels' per-pixel math with every skip of the forward walk off."""
    return _build_host_math(tmp_path_factory, "-DGS_FWD_NO_SKIP")


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


def assert_bit_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def run_all(lib, pattrs, ts, te, ids, tiles_x, use_sa, nn, seed=11):
    """K1 (out, stash, kexit), K2's gradient on that stash, and K5's
    re-forward stash and gradient (all tiles)."""
    out, stash, kexit = host_forward(lib, pattrs, ts, te, ids, tiles_x,
                                     use_sa, nn)
    d_out = np.random.default_rng(seed).normal(size=out.shape).astype(np.float32)
    d_out[:, 10:] = 0.0
    g2 = host_backward(lib, pattrs, ts, te, ids, tiles_x, use_sa, nn, stash,
                       kexit, out, d_out)
    return out, stash, kexit, g2, d_out


def k5_with_stash(lib, pattrs, ts, te, out, d_out, tiles_x, use_sa, nn):
    """K5 on the CPU (test_torch_raster_k5.host_k5), returning the
    re-forward's stash beside the gradient."""
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
    return scratch, d


CASES = [(sa, nn, sub) for sa in (True, False) for nn in (False, True)
         for sub in (False, True)]


@pytest.mark.parametrize("use_sa,nn,subset", CASES)
def test_forward_skips_change_no_bit(host_math, host_math_no_skip, use_sa, nn,
                                     subset):
    """K1's out / stash / kexit and K2's gradient with every skip on and
    off, SA x normals x the stride-3 tile subset."""
    grid, ts, te, pattrs, _ = scene(2, 1300)
    assert (te - ts).max() > 256          # tiles span several blocks
    ids = np.arange(grid.num_tiles, dtype=np.int32)
    if subset:
        ids = ids[::3]
    ts_s, te_s = ts[ids].astype(np.int32), te[ids].astype(np.int32)
    a = run_all(host_math, pattrs, ts_s, te_s, ids, grid.tiles_x, use_sa, nn)
    b = run_all(host_math_no_skip, pattrs, ts_s, te_s, ids, grid.tiles_x,
                use_sa, nn)
    assert_bit_equal(a[:4], b[:4])
    assert np.abs(a[3]).max() > 0.0


@pytest.mark.parametrize("use_sa,nn", [(True, False), (False, True)])
def test_k5_reforward_is_k1(host_math, host_math_no_skip, use_sa, nn):
    """K5's re-forward writes K1's stash and its sweep K2's gradient, bit
    for bit, with the skips on and off."""
    grid, ts, te, pattrs, _ = scene(3, 1300)
    ids = np.arange(grid.num_tiles, dtype=np.int32)
    ts, te = ts.astype(np.int32), te.astype(np.int32)
    got = []
    for lib in (host_math, host_math_no_skip):
        out, stash, _, g2, d_out = run_all(lib, pattrs, ts, te, ids,
                                           grid.tiles_x, use_sa, nn)
        s5, g5 = k5_with_stash(lib, pattrs, ts, te, out, d_out, grid.tiles_x,
                               use_sa, nn)
        assert_bit_equal((s5, g5), (stash, g2))
        got.append((s5, g5))
    assert_bit_equal(got[0], got[1])
    assert np.abs(got[0][1]).max() > 0.0


def opaque_scene():
    """A denser random scene with every pair at opacity 0.98: nearly every
    pixel terminates inside a block with pairs of its range still after
    the trigger, so K1's walk leaves blocks early."""
    grid, ts, te, pattrs, rng = scene(4, 2500)
    pattrs = pattrs.copy()
    pattrs[17] = 0.98
    return grid, ts.astype(np.int32), te.astype(np.int32), pattrs


def mid_block_trigger_share(pattrs, ts, te, out, tiles_x):
    """Share of the pixels whose trigger (the first pair after their last
    contributor that passes the alpha test) has more pairs of their range
    after it in its block; float64 geometry, for a statistic."""
    n_mid = 0
    for i in range(ts.shape[0]):
        tx, ty = i % tiles_x, i // tiles_x
        p = np.arange(256)
        px, py = (tx * 16 + p % 16)[None], (ty * 16 + p // 16)[None]
        a = pattrs[:, ts[i]:te[i]].astype(np.float64)[..., None]
        p_x = px * a[0] + py * a[3] + a[6]
        p_y = px * a[1] + py * a[4] + a[7]
        p_z = px * a[2] + py * a[5] + a[8]
        with np.errstate(divide="ignore", invalid="ignore"):
            sx, sy = p_x / p_z, p_y / p_z
        r3 = sx * sx + sy * sy
        r2 = FILTER_INV_SQUARE * ((a[12] - px) ** 2 + (a[13] - py) ** 2)
        d = np.where(r3 <= r2, sx * a[9] + sy * a[10] + a[11], a[11])
        ok = ((p_z != 0) & (d >= NEAR_N)
              & (a[17] * np.exp(-0.5 * np.minimum(r3, r2)) >= ALPHA_MIN))
        nc = out[i, 13].astype(np.int64)           # 1-based, 0 if none
        for q in np.nonzero(out[i, 15] > 0.5)[0]:
            after = np.nonzero(ok[nc[q]:, q])[0]
            if after.size == 0:
                continue
            t = ts[i] + nc[q] + after[0]            # the trigger's slab index
            n_mid += int(t + 1 < min(te[i], (t // 128 + 1) * 128))
    return n_mid / (ts.shape[0] * 256)


@pytest.mark.parametrize("use_sa,nn", [(True, False), (False, True)])
def test_triggered_pixels_leave_the_block(host_math, host_math_no_skip,
                                          use_sa, nn):
    """A pixel that triggered accepts nothing more in its block (a later
    okf pair's T_pref * (1 - a) stays under T_EPS): leaving the block at
    the trigger changes no bit, on a scene where most pixels trigger with
    pairs still after them in the block."""
    grid, ts, te, pattrs = opaque_scene()
    ids = np.arange(grid.num_tiles, dtype=np.int32)
    a = run_all(host_math, pattrs, ts, te, ids, grid.tiles_x, use_sa, nn)
    b = run_all(host_math_no_skip, pattrs, ts, te, ids, grid.tiles_x, use_sa,
                nn)
    assert_bit_equal(a[:4], b[:4])
    assert float(a[0][:, 15].mean()) > 0.9          # done
    assert mid_block_trigger_share(pattrs, ts, te, a[0], grid.tiles_x) > 0.9
    # the plain version agrees (the existing tolerances of the host math)
    po, _, pk = TRF.raster_forward_plain(
        torch.tensor(pattrs), torch.tensor(ts), torch.tensor(te),
        grid=TileGrid(*grid), use_sa=use_sa, need_normal=nn)
    np.testing.assert_array_equal(a[2], pk.numpy())
    assert_out_close(a[0], po.numpy())


def degenerate_scene():
    """The random scene with every 5th pair made degenerate, in turn: p_z
    = 0 at every pixel, a depth below NEAR_N, an opacity below ALPHA_MIN,
    a NaN in the ray's x row, a NaN opacity."""
    grid, ts, te, pattrs, rng = scene(5, 1300)
    pattrs = pattrs.copy()
    cols = np.arange(0, pattrs.shape[1], 5)
    kinds = np.arange(cols.size) % 5
    pattrs[np.ix_([2, 5, 8], cols[kinds == 0])] = 0.0
    near = cols[kinds == 1]
    pattrs[np.ix_([9, 10], near)] = 0.0
    pattrs[11, near] = 0.5 * NEAR_N
    pattrs[17, cols[kinds == 2]] = 0.5 * ALPHA_MIN
    pattrs[0, cols[kinds == 3]] = np.nan
    pattrs[17, cols[kinds == 4]] = np.nan
    return grid, ts.astype(np.int32), te.astype(np.int32), pattrs


@pytest.mark.parametrize("use_sa,nn", [(True, False), (False, True),
                                       (True, True)])
def test_degenerate_pairs(host_math, host_math_no_skip, use_sa, nn):
    """Pairs with p_z = 0, a depth below NEAR_N, an opacity below
    ALPHA_MIN or a NaN: the cull drops none that passes the alpha test
    at any pixel, and the skips change no bit (NaN included) of K1, K2
    and K5."""
    grid, ts, te, pattrs = degenerate_scene()
    evals, culled, wrong, _ = cull_counts(host_math, grid, ts, te, pattrs)
    assert wrong == 0 and culled > 0.5 * evals
    ids = np.arange(grid.num_tiles, dtype=np.int32)
    a = run_all(host_math, pattrs, ts, te, ids, grid.tiles_x, use_sa, nn)
    b = run_all(host_math_no_skip, pattrs, ts, te, ids, grid.tiles_x, use_sa,
                nn)
    assert_bit_equal(a[:4], b[:4])
    for lib, ref in ((host_math, a), (host_math_no_skip, b)):
        s5, g5 = k5_with_stash(lib, pattrs, ts, te, ref[0], ref[4],
                               grid.tiles_x, use_sa, nn)
        assert_bit_equal((s5, g5), (ref[1], ref[3]))


def load_chip_smoke():
    """chip_smoke.py from the repository root, for its bound counting."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [2, 5])
def test_bound_counts_the_kernels_cull(host_math, seed):
    """chip_smoke.py charges an evaluation that the cull rejects the cull
    test alone; its count of such evaluations (cull_rejects, on tensors)
    is the kernels' own pair_culled count over every (pair, pixel) of the
    tiles' blocks, up to the float rounding of the cull radius' log."""
    cs = load_chip_smoke()
    grid, ts, te, pattrs, _ = scene(seed, 1300)
    evals, culled, _, _ = cull_counts(host_math, grid, ts, te, pattrs)
    a = torch.tensor(pattrs)
    n_eval = n_culled = 0
    for i in range(grid.num_tiles):
        tw0, tw1 = int(ts[i]), int(te[i])
        if tw1 <= tw0:
            continue
        cols = torch.arange(tw0 // 128 * 128, -(-tw1 // 128) * 128)
        p = torch.arange(256)
        px = (i % grid.tiles_x * 16 + p % 16).float()[None]
        py = (i // grid.tiles_x * 16 + p // 16).float()[None]
        b = a[:, cols][..., None]                     # [24, pairs, 1]
        rej = cs.cull_rejects(b[17], b[12] - px, b[13] - py,
                              px * b[0] + py * b[3] + b[6],
                              px * b[1] + py * b[4] + b[7],
                              px * b[2] + py * b[5] + b[8])
        n_eval += rej.numel()
        n_culled += int(rej.sum())
    assert n_eval == evals
    assert culled > 0.5 * evals
    assert abs(n_culled - culled) <= 1e-4 * evals, (n_culled, culled)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("use_sa,nn", [(True, False), (False, True)])
def test_cuda_k3_k5_follow_k1(cuda_device, use_sa, nn):
    """On the card: K3's out is K1's, K5's re-forward stash is K1's and
    K5's gradient is K2's on it, bit for bit; K1 matches the host math."""
    grid, ts, te, pattrs, rng = scene(3, 1300)
    tgrid = TileGrid(*grid)
    dev = dict(device=cuda_device)
    a, t0, t1 = (torch.tensor(x, **dev) for x in (pattrs, ts, te))
    kw = dict(grid=tgrid, use_sa=use_sa, need_normal=nn)
    ko, kst, kk = TRF.raster_forward_stash(a, t0, t1, **kw)
    assert torch.equal(TRF.raster_forward(a, t0, t1, **kw), ko)
    d_out = torch.tensor(rng.normal(size=ko.shape).astype(np.float32), **dev)
    d_out[:, 10:] = 0.0
    scratch = torch.zeros_like(kst)
    k5 = TRB.raster_backward(a, t0, t1, ko, d_out, scratch=scratch, **kw)
    k2 = TRB.raster_backward_stash(a, t0, t1, kst, kk, ko, d_out, **kw)
    torch.cuda.synchronize()
    assert torch.equal(scratch, kst)
    assert torch.equal(k5, k2)
