"""What a traced run reads after its window: the kernel probe (K1 and K2
on the frontend's map and last frame, at the cell's shapes, timed by the
device operations that torch.profiler's trace records for their launches,
against the frozen work count and peaks) and the device's activity in the
profiler's record of the window."""
from __future__ import annotations

import collections

import torch

from .reference import work


def _device_ms(fn, reps: int, warm: int = 2) -> float | None:
    """ms a call of ``fn`` keeps the device busy: the durations of the
    device operations in the profiler's trace of ``reps`` calls, over
    ``reps``; None where the trace holds no device operation."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ns = sum(ev.duration_ns() for ev in prof.profiler.kineto_results.events()
             if ev.device_type() == torch.autograd.DeviceType.CUDA
             and ev.duration_ns() > 0 and not _annotation(ev))
    return ns / 1e6 / reps if ns else None


def _annotation(ev) -> bool:
    return (ev.name().startswith("slambench.")
            or (hasattr(ev, "is_user_annotation")
                and ev.is_user_annotation()))


def kernel_probe(frontend, seed: int) -> dict:
    """K1 (raster_forward_stash) and K2 (raster_backward_stash) through
    the port's render facade on the frontend's map seen from its last
    frame: ms per launch, the bound's ms and what bounds it."""
    from gaus_slam_tpu_torch.ops.raster_backward import raster_backward_stash
    from gaus_slam_tpu_torch.ops.raster_forward import raster_forward_stash
    from gaus_slam_tpu_torch.render import _prep_attrs, bin_full, expand_pairs

    gm, s = frontend.map, frontend.sys
    frame = frontend.local_frames[-1]
    cam = s.cam.replace_w2c(frame.get_w2c.detach())
    opts = s.opts
    grid = opts.grid
    with torch.no_grad():
        bins = bin_full(gm.params, gm.active, cam, opts)
        attrs, _ = _prep_attrs(gm.params, gm.active, cam, opts)
        pattrs = expand_pairs(attrs.T, bins,
                              opts.max_tiles_per_gaussian).contiguous()
        ts, te = bins.tile_start, bins.tile_stop
        kw = dict(grid=grid, use_sa=opts.use_sa, need_normal=False,
                  compute_dtype=opts.compute_dtype)
        out, stash, kexit = raster_forward_stash(pattrs, ts, te, **kw)
        gen = torch.Generator(device=pattrs.device).manual_seed(seed)
        d_out = torch.zeros_like(out)
        d_out[:, :10] = torch.randn(d_out[:, :10].shape, generator=gen,
                                    device=pattrs.device)
        bargs = (pattrs, ts, te, stash, kexit, out, d_out)
        k1_ms = _device_ms(
            lambda: raster_forward_stash(pattrs, ts, te, **kw), 20)
        k2_ms = _device_ms(lambda: raster_backward_stash(*bargs, **kw), 10)
        evals, culled, accepted, wrong = work.pair_pixel_work(
            pattrs, ts, te, out, grid.tiles_x)
    nb = work.kernel_bytes(pattrs, int(ts.shape[0]), out, kexit)
    b1 = work.op_bound(evals, accepted, work.FWD_ACCEPTED, nb["k1"], culled)
    b2 = work.op_bound(evals, accepted, work.BWD_ACCEPTED, nb["k2"], culled)
    return dict(k1_ms=k1_ms, k2_ms=k2_ms, k1_bound_ms=b1[0],
                k1_bound_by=b1[1], k2_bound_ms=b2[0], k2_bound_by=b2[1],
                pairs=int((te - ts).clamp(min=0).sum()), evals=evals,
                accepted=accepted, culled=culled, wrongly_culled=wrong)


def device_activity(prof, window_s: float) -> dict:
    """busy_s (the union of the device's operations in the window),
    the ten device operations that took most time, and idle time by what
    the host was doing (the benchmark's spans around frontend and backend
    calls; 'host, between calls' elsewhere). The profiler does not record
    every run of a CUDA graph WHILE body, so busy_s undercounts the
    tracking loop's device time."""
    dev_iv, spans = [], []
    by_name = collections.Counter()
    for ev in prof.profiler.kineto_results.events():
        t0, dur = ev.start_ns(), ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if dur > 0 and not _annotation(ev):
                dev_iv.append((t0, t0 + dur))
                by_name[ev.name()] += dur
        elif ev.name().startswith("slambench."):
            spans.append((t0, t0 + dur, ev.name()[len("slambench."):]))
    dev_iv.sort()
    spans.sort()
    busy = 0
    gaps = []
    cur0 = cur1 = None
    for a, b in dev_iv:
        if cur1 is None:
            cur0, cur1 = a, b
        elif a > cur1:
            busy += cur1 - cur0
            gaps.append((cur1, a))
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        busy += cur1 - cur0
    idle = collections.Counter()
    j = 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while j < len(spans) and spans[j][1] < mid:
            j += 1
        label = ("host, between calls" if j >= len(spans)
                 or spans[j][0] > mid else f"host in {spans[j][2]} calls")
        idle[label] += g1 - g0
    return dict(
        busy_s=busy / 1e9, window_s=window_s,
        device_ops=[[k, v / 1e9] for k, v in by_name.most_common(10)],
        idle_gaps=[[k, v / 1e9] for k, v in idle.most_common(10)])
