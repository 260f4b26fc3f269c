"""One run of a cell, from set-up to the result line (run.py is the
command line around it; the CPU tests drive it without a card)."""
from __future__ import annotations

import sys
import time

import torch

from . import check, loop, registry

FORBIDDEN = ("jax", "jaxlib", "flax", "gaus_slam_tpu")
# seconds of the traced run's window that torch.profiler records (from
# before the first window frame): busy_s, window_s and the breakdown read
# them; the whole window is too long a record to read within a run's time
TRACED_S = 20.0


def forbidden_modules() -> list:
    """Modules of JAX or the JAX package loaded in this process, compared
    by whole top-level names (the port's name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _load_kernels(device) -> None:
    """The port's CUDA libraries, built into build/torch_kernels/ of the
    checkout by the first run there and loaded by every later one."""
    if device.type != "cuda":
        return
    from gaus_slam_tpu_torch.ops import _cuda

    _cuda.build_all()
    for name in _cuda.SOURCES:
        _cuda.library(name)


def _merge(*layers) -> dict:
    """Config group updates, later layers over earlier ones."""
    out: dict = {}
    for layer in layers:
        for group, kv in (layer or {}).items():
            out.setdefault(group, {}).update(kv)
    return out


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, *, t_start: float, device="cuda",
             variant: str | None = None, overrides: dict | None = None,
             limits: dict | None = None) -> tuple:
    """(result dict, lines for standard error). The configuration is
    updated by overrides/<cell>.json where it exists, then by
    overrides/<variant>.json (the precision control), then by
    ``overrides`` (the CPU tests' sizes). ``limits``: instead of
    limits/<cell>.json."""
    device = torch.device(device)
    wl = registry.cell(bench, cell_name)
    cfg_mod = registry.config(wl["config"])
    traffic = registry.traffic(wl["traffic"])
    updates = _merge(registry.overrides(cell_name),
                     registry.overrides(variant, required=True)
                     if variant else None, overrides)
    _load_kernels(device)
    cell = loop.Cell(cfg_mod, traffic, seed, device=device,
                     chips=int(wl["chips"]), overrides=updates)
    cell.start_feeder()
    try:
        cell.warm_up()
        prof = None
        if trace and device.type == "cuda":
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            cell.prof, cell.prof_stop = prof, time.perf_counter() + TRACED_S
            cell.rec["prof_t0"] = time.perf_counter()
        rec = cell.window(seconds, trace=trace)
        if cell.prof is not None:  # a window shorter than TRACED_S
            rec["traced_s"] = time.perf_counter() - rec["prof_t0"]
            cell.prof.stop()
        rec["setup_s"] = rec["t_first"] - t_start
        rec["traced"] = trace
        cell.stop_feeder()
        activity = None
        if trace and device.type == "cuda":
            from . import probe
            from .reference.pools import pool_mib

            rec["pool_mib"] = pool_mib()
            rec["probe"] = probe.kernel_probe(cell.frontend, seed)
            activity = probe.device_activity(prof, rec["traced_s"])
        prof = None
        outputs = check.collect(cell)
    finally:
        cell.stop_feeder()
    config = cell.config
    frames = cell.frames
    first_t = rec["first_window_t"]
    check.free(cell)
    t_check = time.perf_counter()
    nums = check.judge(outputs, frames, first_t, config, seed, device)
    check_s = time.perf_counter() - t_check
    if limits is None:
        limits = registry.limits(cell_name)
    correct, compared = check.verdict(nums, limits, rec["frames"],
                                      rec["failed"])

    metrics = {}
    for m in registry.metrics_for(bench, cell_name, trace):
        v = registry.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(wl["chips"]),
           "memory_peak_bytes": int(rec.get("peak_bytes", 0))}
    result = {"correct": correct, "attempted": int(rec["frames"]),
              "failed": int(rec["failed"]), "metrics": metrics,
              "device": dev}
    if activity is not None:
        dev["busy_s"] = activity["busy_s"]
        dev["window_s"] = activity["window_s"]
        result["breakdown"] = {"device_ops": activity["device_ops"],
                               "idle_gaps": activity["idle_gaps"]}
    result["compared"] = compared
    lines = [f"[slambench] {cell_name} seed {seed}: {rec['frames']} frames "
             f"in {rec['window_s']:.3f} s, set-up {rec['setup_s']:.3f} s, "
             f"check {check_s:.1f} s, captures {rec['captures']}, "
             f"tasks {rec['tasks']}"]
    if "probe" in rec:
        lines.append(f"[slambench] probe {rec['probe']}")
    lines += [f"[slambench] number {k} {v:.6g}" for k, v in nums.items()]
    lines += [f"compared {k} {c['value']:.6g} limit {c['limit']:.6g}"
              for k, c in compared.items()]
    return result, lines
