"""The benchmark of the port (gaus_slam_tpu_torch) on NVIDIA cards.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of BENCHMARK.json in this process on the card(s) the cell
asks for and prints one JSON line as the last line of standard output:
correct, attempted, failed, metrics (the cell's end-to-end metrics, or
with --trace 1 its per-layer ones), device. The numbers that ``correct``
compares, each beside its limit, are the last lines of standard error and
the result's last key, ``compared``. ``--variant <name>`` updates the
configuration by overrides/<name>.json (``--variant bf16``: the program's
bf16 compute dtype, the precision control), never a benchmark run.
"""
import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout; a library
# that would load JAX by itself is kept from doing so
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CHECKOUT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CHECKOUT, "build", "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, CHECKOUT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--variant", default=None,
                    help="overrides/<name>.json on top of the cell's config")
    args = ap.parse_args(argv)

    from slambench import harness, registry

    bench = registry.benchmark()
    chips = int(registry.cell(bench, args.workload)["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"slambench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines = harness.run_cell(
        bench, args.workload, args.seed, args.seconds, bool(args.trace),
        t_start=_T_START, device="cuda",
        variant=args.variant)
    found = harness.forbidden_modules()
    if found:
        print(f"slambench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
