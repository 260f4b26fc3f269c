"""A/B timing of the forward walk (K1, K3, and K5's re-forward) and of the
reverse sweep (K2) against an older version of the kernels, on
chip_smoke.py's phase-2 cases (340x600: all 836 tiles, and the stride-3
tile subset of the coarse tracking path), with variants that each remove
one cost.

Run on a card, from the repository root, with an older ``csrc/`` beside
the tree (one whose K2 / K5 already form the first cotangent themselves):

    git archive <rev> gaus_slam_tpu_torch/csrc | tar -x -C build/old
    python -m gaus_slam_tpu_torch.tools.kernel_ab \\
        --old build/old/gaus_slam_tpu_torch/csrc [--out DIR]

Every variant is a copy of a source with textual patches or extra nvcc
flags, built by its own nvcc (all at once) into ``--out``; each copy also
gets a C function that reports its CTAs per SM, and the ptxas reports
(registers, spills) of every instantiation are printed. Variants of the
old K1 attribute its time to causes, each removing one: SA's second pass
elided (values wrong), the backward's cull in the first pass (bit-equal),
log1p and the prefix exp only for pairs that pass the alpha test
(bit-equal), the block staged only once (values wrong: a bound on
overlapping the copy), the whole library at -fmad=true (a bound on
explicit fmaf), and two to six CTAs per SM asked of ptxas.
Variants of the current K1: every skip of the forward walk off
(-DGS_FWD_NO_SKIP), the block staged once (values wrong), -fmad=true, and
two to six CTAs per SM asked of ptxas, with the skips and without.

Checks, bit for bit: every K1 variant's out / stash / kexit against the
old K1 on both cases, SA on and off, normals on and off (the variants that
change values fail it by design); K3's out against K1's; K5's re-forward stash against K1's, K5's gradient against K2's, and
the current K2 against the old. The current kernels' bf16 instantiation
(compute type BF16) has no old counterpart: every current K1 variant's
bf16 out / stash / kexit against the current K1's on every case, K3-BF16's
out against K1-BF16's, and K2-BF16 with and without the forward walk's
skips; K1 / K3 / K2 in bf16 are timed beside the f32 ones. Times are CUDA events around 10 launches
(K5: 5), rounds interleaved (forward, then reverse order), the median
printed; the timed case is the full one, SA on, normals off, as phase 2
times it. The last line is a JSON summary.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

FWD, COM, BWD = "raster_forward.cu", "raster_common.cuh", "raster_backward.cu"

# patches of the old forward walk (before the cull-first redesign), one
# cause each
SA2 = ("  if (USE_SA) {\n    // second pass: the fusion weights need the "
       "block's final median")
SA2_ELIDED = "  if (false) {\n    // second pass elided"
FIRST_LOOP = """  for (int j = 0; j < CHUNK; ++j) {
    const Run pre = run;
    const Step st = pair_step<USE_SA>(sa, j, gstart + j, start, stop, px, py,
                                      T_in, live, run);
    trig = trig || (st.okf && st.below);"""
FIRST_LOOP_CULL = FIRST_LOOP.replace(
    "++j) {\n", "++j) {\n    if (pair_culled(sa, j, px, py)) continue;\n")
STAGE = "    stage_block(sa, attrs, R, gstart);"
EAGER_SFU = """  st.l = log1pf(-a_eff);
  st.T_pref = T_in * expf(run.cum);
  run.cum = run.cum + st.l;
  st.below = st.T_pref * (1.f - a_eff) < T_EPS;"""
LAZY_SFU = """  st.l = -0.f;
  st.T_pref = T_in;
  st.below = false;
  if (st.okf) {
    st.l = log1pf(-a_eff);
    st.T_pref = T_in * expf(run.cum);
    run.cum = run.cum + st.l;
    st.below = st.T_pref * (1.f - a_eff) < T_EPS;
  }"""
# the current walk stages block k + 1 (copy and cull radii) during block k;
# staged once, every block reads block 0's buffer, as the old variant does
NEW_STAGE = [("    if (more) {\n      stage_async(",
              "    if (false) {\n      stage_async("),
             ("    if (more && p < CHUNK) nxt[", "    if (false) nxt["),
             ("    float* cur = sa + (k & 1) * (ATTR_C * CHUNK);",
              "    float* cur = sa;")]
BOUNDS = "__global__ void __launch_bounds__(P) raster_forward_kernel("

# appended to every copy of raster_forward.cu / raster_backward.cu: the
# CTAs per SM of each instantiation (F32 where the kernels take a compute
# type CT), from the occupancy calculator
OCC_FWD = """
extern "C" int ab_occupancy(int stash, int sa, int nn) {
  int n = -1;
#define GS_OCC(S, A, N) if (stash == S && sa == A && nn == N) \\
  cudaOccupancyMaxActiveBlocksPerMultiprocessor( \\
      &n, raster_forward_kernel<(S) != 0, (A) != 0, (N) != 0 CT_ARG>, P, 0)
  GS_OCC(1, 1, 1); GS_OCC(1, 1, 0); GS_OCC(1, 0, 1); GS_OCC(1, 0, 0);
  GS_OCC(0, 1, 1); GS_OCC(0, 1, 0); GS_OCC(0, 0, 1); GS_OCC(0, 0, 0);
#undef GS_OCC
  return n;
}
"""
OCC_BWD = """
extern "C" int ab_occupancy(int restash, int sa, int nn) {
  int n = -1;
#define K5_KERNEL(A, N) K5_FIRST<A, N>
#define SWEEP_KERNEL(A, N) raster_backward_kernel<A, N CT_ARG>
#define GS_OCC(K, A, N, SMEM) if (sa == A && nn == N) { \\
  cudaFuncSetAttribute(K((A) != 0, (N) != 0), \\
                       cudaFuncAttributeMaxDynamicSharedMemorySize, \\
                       (int)SMEM); \\
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, K((A) != 0, (N) != 0), \\
                                                P, SMEM); }
  if (restash) {
    GS_OCC(K5_KERNEL, 1, 1, K5_SMEM); GS_OCC(K5_KERNEL, 1, 0, K5_SMEM);
    GS_OCC(K5_KERNEL, 0, 1, K5_SMEM); GS_OCC(K5_KERNEL, 0, 0, K5_SMEM);
  } else {
    GS_OCC(SWEEP_KERNEL, 1, 1, SWEEP_SMEM);
    GS_OCC(SWEEP_KERNEL, 1, 0, SWEEP_SMEM);
    GS_OCC(SWEEP_KERNEL, 0, 1, SWEEP_SMEM);
    GS_OCC(SWEEP_KERNEL, 0, 0, SWEEP_SMEM);
  }
#undef GS_OCC
#undef SWEEP_KERNEL
#undef K5_KERNEL
  return n;
}
"""
# K5's first kernel: one fused kernel (raster_backward_restash_kernel,
# with the sweep's shared memory) before the forward walk's redesign, a
# separate re-forward kernel (raster_reforward_kernel) since
K5_SPLIT = "raster_reforward_kernel"


# the kernels take a compute type (and their C functions a bf16 flag)
CT_API = "class CT>"


def occ_fwd(text):
    return OCC_FWD.replace("CT_ARG", ", F32" if CT_API in text else "")


def occ_bwd(text):
    split = K5_SPLIT in text
    return OCC_BWD.replace("K5_FIRST", K5_SPLIT if split else
                           "raster_backward_restash_kernel").replace(
        "K5_SMEM", "0" if split else "SWEEP_SMEM").replace(
        "CT_ARG", ", F32" if CT_API in text else "")


def _patched(text, patches):
    for a, b in patches:
        if a not in text:
            raise ValueError(f"patch target not found: {a[:60]!r}")
        text = text.replace(a, b)
    return text


def variants(cur: Path, old: Path, flags):
    """{name: (main source, {file: text}, nvcc flags)}: the old and the
    current K1 (raster_forward.cu) and K2 / K5 (raster_backward.cu). A
    variant whose patch does not apply to its source is left out."""
    src = {d: {f: (d / f).read_text() for f in (FWD, COM, BWD)}
           for d in (cur, old)}
    fmad = [f if f != "-fmad=false" else "-fmad=true" for f in flags]

    def old_fwd(fwd_patches=(), com_patches=(), fl=flags):
        return (FWD, {FWD: _patched(src[old][FWD], fwd_patches),
                      COM: _patched(src[old][COM], com_patches)}, fl)

    def cur_fwd(defines=(), fwd_patches=(), com_patches=(), fl=flags):
        return (FWD, {FWD: _patched(src[cur][FWD], fwd_patches),
                      COM: _patched(src[cur][COM], com_patches)},
                fl + list(defines))

    def opt(make, *a, **kw):
        try:
            return make(*a, **kw)
        except ValueError as e:
            print(f"[ab] variant left out: {e}", flush=True)
            return None

    vs = {
        "k1_old": old_fwd(),
        "k1_old_sa2_elided": opt(old_fwd, com_patches=[(SA2, SA2_ELIDED)]),
        "k1_old_cull": opt(old_fwd, com_patches=[
            (FIRST_LOOP, FIRST_LOOP_CULL),
            (STAGE, STAGE.replace("stage_block(", "stage_block<true>("))]),
        "k1_old_lazy_sfu": opt(old_fwd, com_patches=[(EAGER_SFU, LAZY_SFU)]),
        "k1_old_stage_once": opt(old_fwd, com_patches=[
            (STAGE, STAGE.replace("    stage", "    if (k == 0) stage"))]),
        "k1_old_fmad_true": old_fwd(fl=fmad),
        "k1_new": cur_fwd(),
        "k1_new_no_skip": cur_fwd(["-DGS_FWD_NO_SKIP"]),
        "k1_new_stage_once": opt(cur_fwd, com_patches=NEW_STAGE),
        "k1_new_fmad_true": cur_fwd(fl=fmad),
        "bwd_old": (BWD, {BWD: src[old][BWD], COM: src[old][COM]}, flags),
        "bwd_new": (BWD, {BWD: src[cur][BWD], COM: src[cur][COM]}, flags),
        "bwd_new_no_skip": (BWD, {BWD: src[cur][BWD], COM: src[cur][COM]},
                            flags + ["-DGS_FWD_NO_SKIP"]),
    }
    for n in (2, 3, 4, 5, 6):
        vs[f"k1_old_min_blocks_{n}"] = opt(old_fwd, fwd_patches=[
            (BOUNDS, BOUNDS.replace("(P)", f"(P, {n})"))])
        vs[f"k1_new_min_blocks_{n}"] = opt(cur_fwd, fwd_patches=[
            (BOUNDS, BOUNDS.replace("(P)", f"(P, {n})"))])
        vs[f"k1_new_no_skip_min_blocks_{n}"] = opt(
            cur_fwd, ["-DGS_FWD_NO_SKIP"],
            fwd_patches=[(BOUNDS, BOUNDS.replace("(P)", f"(P, {n})"))])
    return {k: v for k, v in vs.items() if v is not None}


ENTRY = re.compile(r"Compiling entry function "
                   r"'_Z\d+(\w+?)I((?:Lb[01]E)+)(?:N2gs\d+(\w+?)E)?E")
REGS = re.compile(r"Used (\d+) registers")
SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_table(log):
    """[(kernel<flags>, registers, spill store bytes, spill load bytes)]
    from an -Xptxas -v report."""
    rows, entry, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = ENTRY.search(line)
        if m:
            entry = m.group(1) + "<" + ",".join(
                re.findall(r"Lb([01])E", m.group(2))
                + ([m.group(3)] if m.group(3) else [])) + ">"
            continue
        m = SPILL.search(line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = REGS.search(line)
        if m and entry and "ab_occupancy" not in entry:
            rows.append((entry, int(m.group(1)), *spill))
            entry = None
    return rows


def build(vs, out: Path, nvcc):
    """Every variant by its own nvcc, all at once; {name: (CDLL, ptxas
    rows)}."""
    procs = {}
    for name, (main, files, flags) in vs.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            if f == main:
                text += occ_fwd(text) if main == FWD else occ_bwd(text)
            (d / f).write_text(text)
        lib = d / "libk.so"
        procs[name] = (subprocess.Popen(
            [nvcc, *flags, "-o", str(lib), str(d / main)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib,
            K5_SPLIT in files.get(BWD, ""), CT_API in files[COM])
    libs = {}
    for name, (p, lib, split, ct) in procs.items():
        log, _ = p.communicate()
        (out / f"{name}.ptxas.log").write_text(log)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        rows = ptxas_table(log)
        print(f"[ab] {name}: " + "; ".join(
            f"{e} {r} regs, spill {s}/{l} B" for e, r, s, l in rows),
            flush=True)
        libs[name] = (ctypes.CDLL(str(lib)), rows, split, ct)
    return libs


def touch_stats(pattrs, ts, te, stash, kex, soff, grid):
    """The forward walk's work, per walked (block, pixel): live share,
    pairs passing the alpha test (okf) per live one, the share of the
    live in-range (pair, pixel) evaluations the cull rejects, and per
    (block, pair, warp) the share with a live lane that the cull keeps
    or that okf touches."""
    import torch

    import chip_smoke as cs
    from gaus_slam_tpu_torch.ops.camera import (ALPHA_MIN, FILTER_INV_SQUARE,
                                                NEAR_N)
    from gaus_slam_tpu_torch.ops.composite_ref import tile_pixel_coords

    dev = pattrs.device
    n = ts.shape[0]
    px, py = tile_pixel_coords(grid, torch.arange(n, device=dev))
    px, py = px.reshape(n, -1), py.reshape(n, -1)
    kl = kex.long()
    tile = torch.repeat_interleave(torch.arange(n, device=dev), kl)
    k = torch.arange(tile.numel(), device=dev) - (torch.cumsum(kl, 0) - kl)[tile]
    acc = dict(live=0.0, okf=0.0, evals=0.0, culled=0.0, warp_kept=0.0,
               warp_okf=0.0)
    nb = tile.numel()
    for c0 in range(0, nb, 32):
        t, kk = tile[c0:c0 + 32], k[c0:c0 + 32]
        live = stash[soff.long()[t] + kk, 1] < 0.5                 # [b, P]
        gstart = (ts.long()[t] // 128 + kk) * 128
        gi = gstart[:, None] + torch.arange(128, device=dev)      # [b, 128]
        valid = (gi >= ts.long()[t, None]) & (gi < te.long()[t, None])
        a = pattrs[:, gi.clamp(max=pattrs.shape[1] - 1)]          # [24, b, 128]
        x, y = px[t][:, None, :], py[t][:, None, :]               # [b, 1, P]

        def A(c):
            return a[c][..., None]
        p_x = x * A(0) + y * A(3) + A(6)
        p_y = x * A(1) + y * A(4) + A(7)
        p_z = x * A(2) + y * A(5) + A(8)
        ok_z = p_z != 0
        inv = torch.where(ok_z, 1.0 / torch.where(ok_z, p_z,
                                                  torch.ones_like(p_z)),
                          torch.zeros_like(p_z))
        sx, sy = p_x * inv, p_y * inv
        r3 = sx * sx + sy * sy
        r2 = FILTER_INV_SQUARE * ((A(12) - x) ** 2 + (A(13) - y) ** 2)
        d = torch.where(r3 <= r2, sx * A(9) + sy * A(10) + A(11),
                        A(11).expand_as(sx))
        alpha = A(17) * torch.exp(-0.5 * torch.minimum(r3, r2))
        walk = valid[..., None] & live[:, None, :]
        ok = (ok_z & (d >= NEAR_N) & (alpha >= ALPHA_MIN)) & walk
        culled = cs.cull_rejects(A(17), A(12) - x, A(13) - y, p_x, p_y,
                                 p_z) & walk
        kept = walk & ~culled
        acc["live"] += float(live.float().sum())
        acc["okf"] += float(ok.float().sum())
        acc["evals"] += float(walk.float().sum())
        acc["culled"] += float(culled.float().sum())
        for name, m in (("warp_kept", kept), ("warp_okf", ok)):
            acc[name] += float(m.reshape(m.shape[0], 128, 8, 32).any(-1)
                               .float().sum())
    stats = dict(blocks=nb, live_share=acc["live"] / (nb * 256),
                 okf_per_live=acc["okf"] / max(acc["live"], 1.0),
                 culled_share=acc["culled"] / max(acc["evals"], 1.0),
                 pair_warp_kept_share=acc["warp_kept"] / (nb * 128 * 8),
                 pair_warp_okf_share=acc["warp_okf"] / (nb * 128 * 8))
    print(f"[ab] walked (block, pixel): {stats}", flush=True)
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="an older gaus_slam_tpu_torch/csrc directory")
    ap.add_argument("--out", type=Path, default=Path("build") / "kernel_ab")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from gaus_slam_tpu_torch.ops import _cuda
    from gaus_slam_tpu_torch.ops.raster_backward import (raster_backward,
                                                         raster_backward_stash)
    from gaus_slam_tpu_torch.ops.raster_forward import (raster_forward,
                                                        raster_forward_stash,
                                                        stash_offsets,
                                                        stash_rows)

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    args.out.mkdir(parents=True, exist_ok=True)
    card = cs.card_line()
    print(f"[card] {card}", flush=True)
    t0 = time.time()
    vs = variants(_cuda.CSRC, args.old, list(_cuda.NVCC_FLAGS))
    libs = build(vs, args.out, _cuda._nvcc())
    print(f"[ab] built {len(libs)} libraries in {time.time() - t0:.1f} s",
          flush=True)
    summary = {"card": card, "k1": {}, "k3": {}, "k5": {}, "k2": {},
               "ptxas": {}, "ctas_per_sm": {}}
    for name, (lib, rows, _, _) in libs.items():
        summary["ptxas"][name] = rows
        lib.ab_occupancy.argtypes = [ctypes.c_int] * 3
        if name.startswith("k1"):
            summary["ctas_per_sm"][name] = {
                f"{s}{a}{n}": lib.ab_occupancy(s, a, n)
                for s in (1, 0) for a in (1, 0) for n in (1, 0)}
        else:
            summary["ctas_per_sm"][name] = {
                f"{k}{a}{n}": lib.ab_occupancy(k, a, n)
                for k in (1, 0) for a in (1, 0) for n in (1, 0)}
        print(f"[ab] {name}: CTAs per SM {summary['ctas_per_sm'][name]}",
              flush=True)

    cfg, ds, sys_cfg, capacity = cs.make_setup(dev)
    opts = sys_cfg.opts
    gm = cs.random_map(ds, sys_cfg.cam, capacity, dev)
    _, cases = cs.kernel_inputs(gm, sys_cfg.cam, opts,
                                sys_cfg.track_front.coarse_stride)
    P, I, V = _cuda.ptr, ctypes.c_int, ctypes.c_void_p
    tiles_x = opts.grid.tiles_x

    def k1_call(name, case, sa, nn, want_stash=True, bf16=False):
        lib, _, _, ct = libs[name]
        pattrs, ts, te, ids = cases[case]
        n_sub, r = int(ts.shape[0]), int(pattrs.shape[1])
        ids = (torch.arange(n_sub, device=dev) if ids is None else ids) \
            .to(torch.int32).contiguous()
        ts32, te32 = ts.to(torch.int32).contiguous(), te.to(torch.int32).contiguous()
        soff = stash_offsets(ts32, te32).contiguous()
        nrows = stash_rows(r, n_sub)
        out = torch.empty((n_sub, 16, 256), device=dev)
        stash = torch.zeros((nrows, 8, 256), device=dev)
        kexit = torch.zeros((n_sub,), dtype=torch.int32, device=dev)
        fn = lib.raster_forward
        fn.argtypes = [V, I] + [V] * 4 + [I] * (7 if ct else 6) + [V] * 4
        flag = [int(bf16)] if ct else []
        assert ct or not bf16, name

        def run():
            rc = fn(P(pattrs), r, P(ids), P(ts32), P(te32), P(soff), n_sub,
                    tiles_x, int(sa), int(nn), int(want_stash), nrows, *flag,
                    P(out), P(stash), P(kexit), _cuda.stream())
            assert rc == 0, rc
            return out, stash, kexit
        return run

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    # bit-equality with the old K1 on every case (both cases, SA and
    # normals on and off), for every K1 variant, and of K3 with K1
    combos = [(c, sa, nn) for c in cases for sa in (True, False)
              for nn in (False, True)]
    refs = {cb: [x.clone() for x in k1_call("k1_old", *cb)()]
            for cb in combos}
    refs16 = {cb: [x.clone() for x in k1_call("k1_new", *cb, bf16=True)()]
              for cb in combos}
    eq = {}
    for cb in combos:
        n = k1_call("k1_new", *cb)()
        k3 = k1_call("k1_new", *cb, want_stash=False)()[0]
        k3b = k1_call("k1_new", *cb, want_stash=False, bf16=True)()[0]
        tag = f"{cb[0]} sa={int(cb[1])} nn={int(cb[2])}"
        eq[tag] = dict(k1_equal_old=same(n, refs[cb]),
                       k3_out_equal_k1=bool(torch.equal(k3, n[0])),
                       k3_bf16_out_equal_k1_bf16=bool(
                           torch.equal(k3b, refs16[cb][0])),
                       bf16_differs_from_f32=not torch.equal(
                           refs16[cb][0], n[0]))
        print(f"[ab] {tag}: {eq[tag]}", flush=True)
    summary["k1"]["equal"] = eq
    for name, (_, _, _, ct) in libs.items():
        if name.startswith("k1"):
            n_eq = sum(same(k1_call(name, *cb)(), refs[cb]) for cb in combos)
            summary["k1"].setdefault(name, {})["cases_equal_old"] = n_eq
            msg = (f"[ab] {name}: out / stash / kexit bit-equal to the old K1 "
                   f"on {n_eq} of {len(combos)} cases")
            if ct:
                n16 = sum(same(k1_call(name, *cb, bf16=True)(), refs16[cb])
                          for cb in combos)
                summary["k1"][name]["bf16_cases_equal_new"] = n16
                msg += (f"; in bf16, to the current K1-BF16 on {n16} of "
                        f"{len(combos)}")
            print(msg, flush=True)

    # K5's re-forward stash and gradient, the current K2 against the old
    pattrs, ts, te, _ = cases["full"]
    n_sub, r = int(ts.shape[0]), int(pattrs.shape[1])
    ts32, te32 = ts.to(torch.int32).contiguous(), te.to(torch.int32).contiguous()
    soff = stash_offsets(ts32, te32).contiguous()
    ids = torch.arange(n_sub, dtype=torch.int32, device=dev)
    nrows = stash_rows(r, n_sub)
    rng = np.random.default_rng(1)
    d_out = torch.zeros((n_sub, 16, 256), device=dev)
    d_out[:, :10] = torch.as_tensor(
        rng.normal(size=(n_sub, 10, 256)).astype(np.float32), device=dev)

    def k2_call(name, out, stash, kexit, sa, bf16=False):
        lib, _, _, ct = libs[name]
        fn = lib.raster_backward
        fn.argtypes = ([V, I] + [V] * 6 + [I] + [V] * 2
                       + [I] * (5 if ct else 4) + [V] * 2)
        flag = [int(bf16)] if ct else []
        assert ct or not bf16, name
        g = torch.zeros((24, r), device=dev)
        kex = kexit.to(torch.int32).contiguous()

        def run():
            assert fn(P(pattrs), r, P(ids), P(ts32), P(te32), P(soff), P(kex),
                      P(stash), nrows, P(out), P(d_out), n_sub, tiles_x,
                      int(sa), 0, *flag, P(g), _cuda.stream()) == 0
            return g
        return run

    def k5_call(name, out, sa):
        lib, _, split, _ = libs[name]
        fn = lib.raster_backward_restash
        # the split K5 takes a scratch kexit and tile ids after the stash
        fn.argtypes = ([V, I] + [V] * 4 + [I] + [V] * (4 if split else 2)
                       + [I] * 4 + [V] * 2)
        g = torch.zeros((24, r), device=dev)
        scratch = torch.zeros((nrows, 8, 256), device=dev)
        kex_ids = torch.zeros((2, n_sub), dtype=torch.int32, device=dev)
        kex = [P(kex_ids[0]), P(kex_ids[1])] if split else []

        def run():
            assert fn(P(pattrs), r, P(ts32), P(te32), P(soff), P(scratch),
                      nrows, *kex, P(out), P(d_out), n_sub, tiles_x, int(sa),
                      0, P(g), _cuda.stream()) == 0
            return g, scratch
        return run

    for sa in (True, False):
        out, stash, kexit = [x.clone() for x in
                             k1_call("k1_new", "full", sa, False)()]
        g2n = k2_call("bwd_new", out, stash, kexit, sa)().clone()
        g2o = k2_call("bwd_old", out, stash, kexit, sa)().clone()
        g5, s5 = [x.clone() for x in k5_call("bwd_new", out, sa)()]
        o16, s16, k16 = refs16[("full", sa, False)]
        g16 = k2_call("bwd_new", o16, s16, k16, sa, bf16=True)().clone()
        g16n = k2_call("bwd_new_no_skip", o16, s16, k16, sa, bf16=True)()
        tag = f"sa={int(sa)}"
        summary["k5"][tag] = dict(
            k5_stash_equal_k1=bool(torch.equal(s5, stash)),
            k5_grad_equal_k2=bool(torch.equal(g5, g2n)),
            k2_equal_old=bool(torch.equal(g2n, g2o)),
            k2_bf16_equal_no_skip=bool(torch.equal(g16, g16n)))
        print(f"[ab] K5 / K2 full {tag}: {summary['k5'][tag]}", flush=True)

    out, stash, kexit = [x.clone() for x in
                         k1_call("k1_new", "full", True, False)()]
    o16, s16, k16 = refs16[("full", True, False)]
    print(f"[ab] case full: {n_sub} tiles, R {r}, pairs "
          f"{int((te - ts).clamp(min=0).sum())}, composited blocks "
          f"{int(kexit.sum())} (max {int(kexit.max())} per tile)", flush=True)
    summary["touch"] = touch_stats(pattrs, ts32, te32, stash, kexit, soff,
                                   opts.grid)
    kw = dict(grid=opts.grid, use_sa=True, need_normal=False)
    runs = {name: k1_call(name, "full", True, False)
            for name in libs if name.startswith("k1")}
    runs["k1_new_bf16"] = k1_call("k1_new", "full", True, False, bf16=True)
    runs["k1_wrapper"] = lambda: raster_forward_stash(pattrs, ts, te, **kw)
    runs["k3_old"] = k1_call("k1_old", "full", True, False, want_stash=False)
    runs["k3_new"] = k1_call("k1_new", "full", True, False, want_stash=False)
    runs["k3_new_bf16"] = k1_call("k1_new", "full", True, False,
                                  want_stash=False, bf16=True)
    runs["k3_wrapper"] = lambda: raster_forward(pattrs, ts, te, **kw)
    runs["k2_old"] = k2_call("bwd_old", out, stash, kexit, True)
    runs["k2_new"] = k2_call("bwd_new", out, stash, kexit, True)
    runs["k2_new_bf16"] = k2_call("bwd_new", o16, s16, k16, True, bf16=True)
    runs["k2_new_no_skip"] = k2_call("bwd_new_no_skip", out, stash, kexit,
                                     True)
    runs["k5_old"] = k5_call("bwd_old", out, True)
    runs["k5_new"] = k5_call("bwd_new", out, True)
    runs["k5_new_no_skip"] = k5_call("bwd_new_no_skip", out, True)
    runs["k5_wrapper"] = lambda: raster_backward(pattrs, ts, te, out, d_out,
                                                 **kw)
    runs["k2_wrapper"] = lambda: raster_backward_stash(
        pattrs, ts, te, stash, kexit, out, d_out, **kw)
    e = same(runs["k1_wrapper"](), refs[("full", True, False)])
    summary["k1"]["k1_wrapper"] = {"equal_old": e}
    print(f"[ab] k1_wrapper: bit-equal to the old K1: {e}", flush=True)
    times = {n: [] for n in runs}
    for _ in range(args.rounds):
        for n in list(runs) + list(reversed(list(runs))):
            reps = 5 if n.startswith(("k5", "k2")) else 10
            times[n].append(cs.time_ms(runs[n], reps))
    for n, t in times.items():
        group = n.split("_")[0]
        summary[group].setdefault(n, {})["ms"] = float(np.median(t))
        print(f"[ab] {n}: ms {np.median(t):.4f} "
              f"(all {' '.join('%.4f' % x for x in t)})", flush=True)
    print(f"[card] {cs.card_line()}", flush=True)
    (args.out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
