"""Multi-seed quality A/B sweep of the speed knobs (port of
tools/quality_ab.py).

Runs the port's full SLAM driver per (seed x variant) on the procedural
synthetic sequence and aggregates PSNR / ATE-RMSE mean +- sd per
variant. The VARIANTS are the JAX tool's (env overrides that
configs/synthetic/config.py and the port's frontend and backend read);
the adoption rule is its own: a knob ships as default only if its
seed-mean PSNR is within 0.3 dB of the ``default`` row and its ATE-RMSE
mean is not worse than default + 1 pooled sd.

Each variant is one child process (``python -m
gaus_slam_tpu_torch.tools.ab_runner``) that runs all its seeds, so a
variant's env knobs never leak into another's config. Variants run in
the order given (variant-major: a sweep cut short leaves complete
multi-seed stats for the first ones); rows stream to --out per seed, and
(seed, variant) pairs already there are skipped on resume. Prints a
markdown table for PERF.md; --summarize-only prints it from --out and
writes nothing.

    python -m gaus_slam_tpu_torch.tools.quality_ab --seeds 0 1 2 \
        --frames 100 [--variants default coarse0 ...] [--device cuda|cpu] \
        [--out artifacts/quality_ab_torch.jsonl]

On the card the driver runs the hand-written kernels; ``--device cpu``
runs their plain versions.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# variant -> env overrides (configs/synthetic/config.py reads these)
VARIANTS = {
    # shipped defaults: coarse 18/30 iters, mapping rebin 2, frozen cache
    "default": {},
    # no coarse-to-fine (reference-faithful full-res every iteration)
    "coarse0": {"COARSE_ITERS": "0"},
    # deeper coarse phase (24 of 30 iterations at stride 2)
    "coarse24": {"COARSE_ITERS": "24"},
    # deeper + sparser coarse phase (1/9 of the tiles per iteration)
    "coarse24s3": {"COARSE_ITERS": "24", "COARSE_STRIDE": "3"},
    # re-bin mapping every iteration (reference-exact)
    "rebin1": {"REBIN_EVERY": "1"},
    # staler mapping bins
    "rebin4": {"REBIN_EVERY": "4"},
    # tracking cache refreshed mid-loop (closer to reference re-binning)
    "refresh": {"TRACK_REFRESH": "1"},
    # longer submaps (reference Replica shape is 40): cuts/merges are
    # the most expensive events, fewer of them may be quality-free
    "submap20": {"SYN_MAX_FRAMES": "20"},
    # the reference Replica profile's own submap length
    "submap40": {"SYN_MAX_FRAMES": "40"},
    # reference shape, faithfully COUPLED: the reference ties
    # num_mapping_iters to localmap_max_frames (configs/replica/
    # config.py:27,52-55), so longer submaps must also raise the
    # per-keyframe mapping budget — submap40 alone halves relative
    # mapping effort and loses ~3 dB PSNR
    "refshape": {"SYN_MAX_FRAMES": "40", "SYN_MAP_ITERS": "40"},
    # reference shape with the BA budget scaled too (reference BA 60
    # on Replica vs the synthetic default 20)
    "refshape_ba": {"SYN_MAX_FRAMES": "40", "SYN_MAP_ITERS": "40",
                    "SYN_BA_ITERS": "40"},
    # the reference config_fast's keyframe threshold (tau_k 0.15 vs the
    # full profile's 0.01; fewer keyframes = far less mapping work)
    "tauk15": {"SYN_TAU_K": "0.15"},
    # config_fast-analogue shape: long submaps + sparse keyframes
    "fast": {"SYN_TAU_K": "0.15", "SYN_MAX_FRAMES": "40"},
    # keyframe test + densify input from a fresh render_view instead of
    # the fused tracking-cache view (reference-exact kf semantics)
    "kfview0": {"FUSED_KF_VIEW": "0"},
    # coarse mapping: every frontend mapping iteration renders a rotating
    # stride-2 checkerboard (1/4 of the tiles; full coverage each 4
    # iterations) — unbiased stochastic gradient of the per-pixel loss
    "cmap2": {"COARSE_MAP_STRIDE": "2"},
    # coarse mapping at 1/9 of the tiles per iteration
    "cmap3": {"COARSE_MAP_STRIDE": "3"},
    # sparser coarse TRACKING phase at the default depth (18 of 30
    # iters): coarse24s3 coupled depth+stride and lost 0.51 dB; this
    # isolates the stride
    "cs3": {"COARSE_STRIDE": "3"},
    # combined candidate defaults: coarse mapping + sparser tracking
    "cmap3cs3": {"COARSE_MAP_STRIDE": "3", "COARSE_STRIDE": "3"},
    # coarse mapping in the BACKEND's fused batches too (global-map
    # refinement at 1/9 tiles per task, phase carried across batches)
    "cmapb3": {"BACKEND_COARSE_MAP_STRIDE": "3"},
    # the shipped defaults AFTER the compact phase-major rework (same
    # config as "default"; distinct label so rows measured under the
    # new code path aren't averaged with pre-rework default rows)
    "defaultc": {},
    # compact coarse TRACKING cache off (full-cache coarse iterations;
    # isolates the phase-major tracking-cache slice, which only regroups
    # f32 accumulation chunks — expected quality-free)
    "ctrack0": {"COMPACT_TRACK": "0"},
    # shipped defaults after compact coarse tracking landed (fresh rows
    # under the new default code path, same config as "default")
    "defaultt": {},
    # ---- round 4: fullres rows (run with --height 680 --width 1200;
    # labels kept distinct so they never average with 340x600 rows) ----
    # fullres shipped defaults (no pyramid)
    "defaultf": {},
    # pyramid coarse tracking: 12 iters at stride 4, 12 at stride 2,
    # remainder full-res — at 680x1200 a stride-2 tile has the same
    # angular footprint as a full-res 340x600 tile, so the quality-free
    # result there transfers; the stride-4 level is the new risk this
    # row gates
    "pyrf": {"COARSE_LEVELS": "12x4,12x2"},
    # shallower pyramid (less stride-4 exposure)
    "pyrf6": {"COARSE_LEVELS": "6x4,16x2"},
    # round-4 re-measurement of the contaminated r3 "cs3" row (sparser
    # coarse TRACKING stride at default depth, 340x600)
    "cs3r4": {"COARSE_STRIDE": "3"},
    # ---- round 5 ----
    # POST-PRUNE backend coarse mapping: the all-coarse "cmapb3" row was
    # catastrophic (PSNR 16) because pre-prune coarse coverage starved
    # the merged donors' re-opacification before the prune task reaped
    # them; the knob now applies only to post-prune/idle mapping tasks
    # (slam/backend.py coarse_map_stride) — this row gates that
    "cmapb3pp": {"BACKEND_COARSE_MAP_STRIDE": "3"},
    # ... plus the PRE-prune block at stride 2 (5 full covers per
    # 20-task re-opacification block — the aggressive end of the
    # backend-coarse package)
    "cmapb2pre": {"BACKEND_COARSE_MAP_STRIDE": "3",
                  "BACKEND_COARSE_PRE_STRIDE": "2"},
    # fullres anchor at the pre-round-5 conservative tracking stride
    # (COARSE_STRIDE default flipped to 3 after the clean cs3r4 rows;
    # this gates the flip AT FULLRES against the old default)
    "cs2f": {"COARSE_STRIDE": "2"},
}


def run_variant(variant: str, seeds: list[int], frames: int, h: int,
                w: int, on_row, device: str, out_root: str) -> int:
    """All seeds of one variant in one child process. Streams rows to
    ``on_row`` as each seed finishes, so a sweep cut short mid-variant
    still keeps its completed seeds. Returns the child's exit code."""
    env = dict(os.environ)
    # backend floor for the 100-frame peak: no capacity-bucket flips
    env["BACKEND_CAP_MULT"] = env.get("BACKEND_CAP_MULT", "4.0")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gaus_slam_tpu_torch.tools.ab_runner",
         "--variant", variant, "--env", json.dumps(VARIANTS[variant]),
         "--seeds", *[str(s) for s in seeds],
         "--frames", str(frames), "--height", str(h), "--width", str(w),
         "--device", device, "--out-root", out_root],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, text=True,
    )
    assert proc.stdout is not None
    for line in proc.stdout:
        if line.startswith("ABROW "):
            on_row(json.loads(line[len("ABROW "):]))
    return proc.wait()


def main(argv=None) -> list:
    """Runs the sweep (unless --summarize-only); returns every row of
    --out."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--height", type=int, default=340)
    ap.add_argument("--width", type=int, default=600)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    ap.add_argument("--out", default="artifacts/quality_ab_torch.jsonl")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out-root", default="output",
                    help="the drivers write under "
                         "<out-root>/ab_<variant>_s<seed>")
    ap.add_argument("--summarize-only", action="store_true",
                    help="print the aggregate table from --out and exit")
    args = ap.parse_args(argv)
    unknown = [v for v in args.variants if v not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}")

    rows = []
    out_path = os.path.join(ROOT, args.out)
    if os.path.exists(out_path):
        with open(out_path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
    done = {(r["seed"], r["variant"]) for r in rows
            if r.get("psnr") is not None}

    def on_row(row):
        rows.append(row)
        with open(out_path, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
        print(json.dumps(row), flush=True)

    if not args.summarize_only:
        if args.device == "cuda":
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device: pass --device cpu to run "
                                   "on the CPU")
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        for variant in args.variants:
            seeds = [s for s in args.seeds if (s, variant) not in done]
            if seeds:
                rc = run_variant(variant, seeds, args.frames, args.height,
                                 args.width, on_row, args.device,
                                 args.out_root)
                if rc != 0:
                    print(f"{variant}: ab_runner exited with {rc}",
                          file=sys.stderr, flush=True)

    # aggregate table (markdown, for PERF.md). Adoption rule: a perf
    # knob ships as default only if its seed-mean PSNR is within the
    # 0.3 dB parity budget of the `default` row (BASELINE.md) and its
    # ATE-RMSE mean is not worse than default + 1 pooled std.
    import statistics as st

    def stats(variant):
        vs = [r for r in rows if r["variant"] == variant
              and r.get("psnr") is not None]
        if not vs:
            return None
        p = [r["psnr"] for r in vs]
        a = [r["ate_rmse"] for r in vs]
        w = [r.get("wall_s", float("nan")) for r in vs]
        return {
            "n": len(vs),
            "psnr": st.mean(p), "psnr_sd": st.stdev(p) if len(p) > 1 else 0.0,
            "ate": st.mean(a), "ate_sd": st.stdev(a) if len(a) > 1 else 0.0,
            "wall": st.mean(w),
        }

    base = stats("default")
    print("\n| variant | PSNR (dB) | ATE-RMSE | wall s/run | runs | "
          "within budget |")
    print("|---|---|---|---|---|---|")
    for variant in args.variants:
        s = stats(variant)
        if s is None:
            print(f"| {variant} | failed | failed | - | 0 | - |")
            continue
        verdict = "-"
        if base is not None and variant != "default":
            ok_psnr = s["psnr"] >= base["psnr"] - 0.3
            ok_ate = s["ate"] <= base["ate"] + max(base["ate_sd"],
                                                   s["ate_sd"])
            verdict = "yes" if (ok_psnr and ok_ate) else "NO"
        print(f"| {variant} | {s['psnr']:.2f} +- {s['psnr_sd']:.2f} "
              f"| {s['ate']:.4f} +- {s['ate_sd']:.4f} "
              f"| {s['wall']:.0f} | {s['n']} | {verdict} |")

    return rows


if __name__ == "__main__":
    main()
