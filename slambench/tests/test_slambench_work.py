"""The frozen work count and bounds against chip_smoke.py's, on a small
map on the CPU; and the reference renderer against the port's plain
compositor on the same map."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from slambench.reference import render2dgs, work


@pytest.fixture(scope="module")
def small_map():
    import chip_smoke
    from gaus_slam_tpu_torch.data.synthetic import SyntheticDataset
    from gaus_slam_tpu_torch.render import RenderOptions
    from gaus_slam_tpu_torch.ops.binning import make_grid
    from gaus_slam_tpu_torch.ops.camera import Camera

    ds = SyntheticDataset(height=48, width=64, num_frames=60)
    cam = Camera(48, 64, ds.fx, ds.fy, ds.cx, ds.cy, torch.eye(4))
    opts = RenderOptions(grid=make_grid(cam), max_tiles_per_gaussian=4)
    gm = chip_smoke.random_map(ds, cam, 8192, "cpu", seed=3)
    return chip_smoke, cam, opts, gm


def test_pair_pixel_work_and_bound_match_chip_smoke(small_map):
    from gaus_slam_tpu_torch.ops.raster_forward import raster_forward_plain

    chip_smoke, cam, opts, gm = small_map
    _, cases = chip_smoke.kernel_inputs(gm, cam, opts, 2)
    pattrs, ts, te, _ = cases["full"]
    out, _, kexit = raster_forward_plain(pattrs, ts, te, grid=opts.grid,
                                         use_sa=True, need_normal=False)
    ours = work.pair_pixel_work(pattrs, ts, te, out, opts.grid.tiles_x,
                                chunk=1000)
    theirs = chip_smoke.pair_pixel_work(pattrs, ts, te, out, opts.grid,
                                        chunk=1000)
    assert ours == theirs
    evals, culled, accepted, wrong = ours
    assert evals > 0 and accepted > 0 and wrong == 0
    nb = work.kernel_bytes(pattrs, int(ts.shape[0]), out, kexit)
    for per, k in ((work.FWD_ACCEPTED, "k1"), (work.BWD_ACCEPTED, "k2")):
        assert work.op_bound(evals, accepted, per, nb[k], culled) == \
            chip_smoke.op_bound(evals, accepted, per, nb[k], culled=culled)
    assert (work.HBM_BYTES_PER_S, work.F32_FLOP_PER_S, work.SFU_PER_S) == \
        (chip_smoke.HBM_BYTES_PER_S, chip_smoke.F32_FLOP_PER_S,
         chip_smoke.SFU_PER_S)


def test_reference_render_matches_the_port(small_map):
    from gaus_slam_tpu_torch.ops.composite_ref import tiles_to_image
    from gaus_slam_tpu_torch.render import render_view

    _, cam, opts, gm = small_map
    w2c = torch.eye(4)
    w2c[0, 3] = 0.01
    port = render_view(gm, cam.replace_w2c(w2c), opts)
    img = tiles_to_image(port, opts.grid, cam.height, cam.width)
    act = gm.active
    params = {f: getattr(gm.params, f)[act] for f in
              ("xyz", "log_scales", "quats", "opacity_logit", "rgb")}
    ref = render2dgs.render(params, w2c, render2dgs.Cam(
        cam.height, cam.width, cam.fx, cam.fy, cam.cx, cam.cy), 4)
    assert torch.allclose(ref["color"], img[:3].permute(1, 2, 0), atol=1e-5)
    assert torch.allclose(1.0 - ref["alpha"], 1.0 - img[4], atol=1e-5)
    cover = img[4] > 0.5
    depth = img[3] / (img[4] + 1e-6)
    # surface-aware depth fuses towards a median found per window of 128
    # pairs: tile-local windows here, 128-aligned blocks in the port's walk
    rel = ((ref["depth"] - depth).abs() / depth)[cover]
    assert float((rel < 1e-3).float().mean()) > 0.99
    assert float(rel.mean()) < 1e-3
    assert float(np.mean(cover.numpy())) > 0.5
