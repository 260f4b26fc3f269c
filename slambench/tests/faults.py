"""A run of a cell with the timed path broken underneath, for the tests
that see ``correct`` come out false:

    python slambench/tests/faults.py --workload <cell> --fault <name> \
        --seed <n> --seconds <s> [--device cpu]

Faults (planted in the program's modules before the run):
  tracking_unchanged  the frontend's tracking loop returns its pose unchanged
  pose_altered        the tracked pose moved 2 cm, alternately left and right
  front_map_unchanged the frontend's mapping steps return the map unchanged
  back_map_unchanged  the backend's mapping steps return the map unchanged
  ba_unchanged        the backend's BA tracking steps return the submap
                      transforms (pose and optimizer state) unchanged
  none                the program as it is
Prints the result line as run.py does. Skips run.py's look for a card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

import torch  # noqa: E402

SHIFT_M = 0.02


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return type(x)(*(_clone(v) for v in x))
    return x


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, tuple):
        for a, b in zip(dst, src):
            _copy_into(a, b)


def _tracking(shift: float | None):
    from gaus_slam_tpu_torch.slam import frontend

    real = frontend.tracking_loop
    calls = [0]

    def broken(cache, pose0, *a, **kw):
        start = _clone(pose0)
        pose, aux = real(cache, pose0, *a, **kw)
        calls[0] += 1
        if shift is None:
            pose = start
        else:
            sign = 1.0 if calls[0] % 2 else -1.0
            d = torch.zeros_like(pose.trans)
            d[0] = sign * shift
            pose = pose._replace(trans=pose.trans + d)
        return pose, dict(aux, w2c=pose.w2c)

    frontend.tracking_loop = broken


def _mapping(module: str):
    import importlib

    mod = importlib.import_module(f"gaus_slam_tpu_torch.slam.{module}")

    def unchanged(real):
        def broken(gm, *a, **kw):
            start = _clone(gm.params)
            out = real(gm, *a, **kw)
            _copy_into(out[0].params, start)
            return out
        return broken

    for name in ("mapping_loop", "mapping_step"):
        setattr(mod, name, unchanged(getattr(mod, name)))


def _ba_tracking():
    from gaus_slam_tpu_torch.slam import backend

    real = backend.backend_tracking_step

    def broken(gm, pose, *a, **kw):
        start = _clone(pose)
        _, aux = real(gm, pose, *a, **kw)
        return start, aux

    backend.backend_tracking_step = broken


FAULTS = {
    "none": lambda: None,
    "tracking_unchanged": lambda: _tracking(None),
    "pose_altered": lambda: _tracking(SHIFT_M),
    "front_map_unchanged": lambda: _mapping("frontend"),
    "back_map_unchanged": lambda: _mapping("backend"),
    "ba_unchanged": _ba_tracking,
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS), required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from slambench import harness, registry

    FAULTS[args.fault]()
    result, lines = harness.run_cell(
        registry.benchmark(), args.workload, args.seed, args.seconds, False,
        t_start=T0, device=args.device)
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
