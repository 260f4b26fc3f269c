"""A/B timing of the reverse sweep (K2, K5) and the row gather (K4)
against an older version of the kernels, on chip_smoke.py's phase-2 full
case (340x600, 836 tiles), with variants that each remove one cost.

Run on a card, from the repository root, with an older ``csrc/`` beside
the tree (one whose sweep still takes the first cotangent from its
caller, before the kernels formed it themselves):

    git archive <rev> gaus_slam_tpu_torch/csrc | tar -x -C build/old
    python -m gaus_slam_tpu_torch.tools.kernel_ab \\
        --old build/old/gaus_slam_tpu_torch/csrc [--out DIR]

Every variant is a copy of a source with one textual patch, built by its
own nvcc (all at once) into ``--out``; the ptxas reports (registers,
spills, shared memory) go there too. Variants of the old sweep attribute
its time to four causes: the 21 warp trees of the per-pair sum elided,
the per-pixel records elided (values wrong: a bound on moving them on
chip), the whole library at -fmad=true (a bound on explicit fmaf), and
the tiles launched longest first (the inputs permuted). Variants of the
current sweep take back one of its parts each (and its tiles, too, are
launched longest first). Times are CUDA events around 10 launches (K4:
50 launches in one CUDA graph), rounds interleaved, the median printed;
every variant's output is compared with the current kernel's. The last
line is a JSON summary.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REDUCE_OLD = """        if (__any_sync(0xffffffffu, okf)) {
#pragma unroll
          for (int q = 0; q < GRAD_C; ++q) {
            float v = gv[q];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              v += __shfl_down_sync(0xffffffffu, v, off);
            if (lane == 0) part[warp][jj][q] = v;
          }
        } else if (lane == 0) {"""
REDUCE_OLD_ELIDED = """        if (__any_sync(0xffffffffu, okf)) {
          float v = 0.f;
#pragma unroll
          for (int q = 0; q < GRAD_C; ++q) v += gv[q];
          if (lane < GRAD_C) part[warp][jj][lane] = v * 0.f;
        } else if (lane == 0) {"""
# the old sweep's per-pixel records (local-memory arrays) elided
RECORDS_ELIDED = [
    ("if (STORE) cumx[j] = cum;", ""),
    ("if (STORE) { pre1[j] = dp; pre2[j] = d2p; }", ""),
    ("if (STORE) { pre1[j] = M1p; pre2[j] = M2p; }", ""),
    ("const float e = expf(cumx[j]);", "const float e = expf(rc.gTin * 0.f);"),
    ("sa_conf(T_pref, pre1[j], pre2[j],", "sa_conf(T_pref, rc.S_w, rc.S_wm,"),
    ("const float M1p = pre1[j], M2p = pre2[j];",
     "const float M1p = rc.S_w, M2p = rc.S_wm;"),
]

RS_CALL = """        const float row = warp_reduce_scatter(gv, lane);
        if (lane < GRAD_C) prow[lane] = row;"""
TREES = """#pragma unroll
        for (int q = 0; q < GRAD_C; ++q) {
          float v = gv[q];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_down_sync(0xffffffffu, v, off);
          if (lane == 0) prow[q] = v;
        }"""
RS_ELIDED = """        float v = 0.f;
#pragma unroll
        for (int q = 0; q < GRAD_C; ++q) v += gv[q];
        if (lane < GRAD_C) prow[lane] = v * 0.f;"""
MIN_BLOCKS = "constexpr int MIN_BLOCKS = 3;"
CULL = "|| pair_culled(sa, j, px, py)) continue;"


def _patched(text, patches):
    for a, b in patches:
        if a not in text:
            raise ValueError(f"patch target not found: {a[:60]!r}")
        text = text.replace(a, b)
    return text


def variants(cur: Path, old: Path, flags):
    """{name: (raster_backward.cu, raster_common.cuh, nvcc flags, abi)}."""
    bwd = (cur / "raster_backward.cu").read_text()
    com = (cur / "raster_common.cuh").read_text()
    obwd = (old / "raster_backward.cu").read_text()
    ocom = (old / "raster_common.cuh").read_text()
    fmad = [f if f != "-fmad=false" else "-fmad=true" for f in flags]
    return {
        "old": (obwd, ocom, flags, "old"),
        "old_trees_elided": (_patched(obwd, [(REDUCE_OLD, REDUCE_OLD_ELIDED)]),
                             ocom, flags, "old"),
        "old_records_elided": (obwd, _patched(ocom, RECORDS_ELIDED), flags,
                               "old"),
        "old_fmad_true": (obwd, ocom, fmad, "old"),
        "new": (bwd, com, flags, "new"),
        "new_21_trees": (_patched(bwd, [(RS_CALL, TREES)]), com, flags, "new"),
        "new_reduction_elided": (_patched(bwd, [(RS_CALL, RS_ELIDED)]), com,
                                 flags, "new"),
        "new_no_cull": (bwd, _patched(com, [(CULL, "|| false) continue;")]),
                        flags, "new"),
        "new_min_blocks_2": (_patched(bwd, [(MIN_BLOCKS, MIN_BLOCKS.replace(
            "3", "2"))]), com, flags, "new"),
        "new_rec_cap_8": (bwd, com, flags + ["-DGS_REC_CAP=8"], "new"),
    }


def build(vs, old: Path, out: Path, nvcc):
    """Every variant (and the old gather) by its own nvcc, all at once."""
    procs = {}
    for name, (bwd, com, flags, _) in vs.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "raster_backward.cu").write_text(bwd)
        (d / "raster_common.cuh").write_text(com)
        lib = d / "libk2.so"
        procs[name] = (subprocess.Popen(
            [nvcc, *flags, "-o", str(lib), str(d / "raster_backward.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    from gaus_slam_tpu_torch.ops import _cuda
    lib = out / "libgather_old.so"
    procs["gather_old"] = (subprocess.Popen(
        [nvcc, *_cuda.NVCC_FLAGS, "-o", str(lib), str(old / "gather.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (p, lib) in procs.items():
        log, _ = p.communicate()
        (out / f"{name}.ptxas.log").write_text(log)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ab] {name}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def touch_stats(pattrs, ts, te, stash, kex, soff, grid, rec_cap=16):
    """How much of the sweep's walk touches a pixel: per walked (block,
    pixel) whether it is live and how many pairs pass its alpha test
    (okf), per (block, pair, warp) whether any lane is touched."""
    import torch

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
    live_n = okf_sum = touched = 0.0
    okf_max = over = 0
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
        ok = (ok_z & (d >= NEAR_N) & (alpha >= ALPHA_MIN) & valid[..., None]
              & live[:, None, :])
        live_n += float(live.float().sum())
        cnt = ok.sum(1)                                           # [b, P]
        okf_sum += float(cnt.float().sum())
        okf_max = max(okf_max, int(cnt.max()))
        over += int((cnt > rec_cap).sum())
        touched += float(ok.reshape(ok.shape[0], 128, 8, 32).any(-1)
                         .float().sum())
    stats = dict(blocks=nb, live_share=live_n / (nb * 256),
                 okf_per_live_mean=okf_sum / max(live_n, 1.0),
                 okf_per_live_max=okf_max,
                 over_rec_cap_share=over / (nb * 256),
                 pair_warp_touched_share=touched / (nb * 128 * 8))
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
    from gaus_slam_tpu_torch.ops.gather import (monotone_row_gather_rows,
                                                monotone_row_gather_rows_plain)
    from gaus_slam_tpu_torch.ops.raster_backward import (
        finalize_cotangents, raster_backward, raster_backward_stash)
    from gaus_slam_tpu_torch.ops.raster_forward import (raster_forward_stash,
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
    libs = build(vs, args.old, args.out, _cuda._nvcc())
    print(f"[ab] built {len(libs)} libraries in {time.time() - t0:.1f} s",
          flush=True)

    cfg, ds, sys_cfg, capacity = cs.make_setup(dev)
    opts = sys_cfg.opts
    gm = cs.random_map(ds, sys_cfg.cam, capacity, dev)
    bins, cases = cs.kernel_inputs(gm, sys_cfg.cam, opts,
                                   sys_cfg.track_front.coarse_stride)
    pattrs, ts, te, _ = cases["full"]
    kw = dict(grid=opts.grid, use_sa=True, need_normal=False)
    k_out, k_stash, k_kexit = raster_forward_stash(pattrs, ts, te, **kw)
    rng = np.random.default_rng(1)
    n_sub, r = int(ts.shape[0]), int(pattrs.shape[1])
    d_out = torch.zeros_like(k_out)
    d_out[:, :10] = torch.as_tensor(
        rng.normal(size=(n_sub, 10, 256)).astype(np.float32), device=dev)
    ids = torch.arange(n_sub, dtype=torch.int32, device=dev)
    ts32, te32 = ts.to(torch.int32).contiguous(), te.to(torch.int32).contiguous()
    soff = stash_offsets(ts32, te32).contiguous()
    kex = k_kexit.to(torch.int32).contiguous()
    d0 = finalize_cotangents(k_out, d_out, torch.zeros(3, device=dev),
                             use_sa=True).contiguous()
    # the tiles as they come, and permuted longest kexit first (the CTAs
    # take them in launch order)
    as_is = dict(ids=ids, ts=ts32, te=te32, soff=soff, kex=kex, d0=d0,
                 out=k_out, dout=d_out)
    perm = torch.argsort(kex.long(), descending=True, stable=True)
    by_kexit = {k: v[perm].contiguous() for k, v in as_is.items()}
    print(f"[ab] case full: {n_sub} tiles, R {r}, pairs "
          f"{int((te - ts).clamp(min=0).sum())}, swept blocks {int(kex.sum())}"
          f" (max {int(kex.max())} per tile)", flush=True)
    P, I, V = _cuda.ptr, ctypes.c_int, ctypes.c_void_p

    def old_call(lib, a):
        fn = lib.raster_backward
        fn.argtypes = [V, I] + [V] * 6 + [I, V] + [I] * 4 + [V] * 2
        out = torch.zeros((24, r), dtype=torch.float32, device=dev)

        def run():
            rc = fn(P(pattrs), r, P(a["ids"]), P(a["ts"]), P(a["te"]),
                    P(a["soff"]), P(a["kex"]), P(k_stash), k_stash.shape[0],
                    P(a["d0"]), n_sub, opts.grid.tiles_x, 1, 0, P(out),
                    _cuda.stream())
            assert rc == 0, rc
            return out
        return run

    def new_call(lib, a):
        fn = lib.raster_backward
        fn.argtypes = [V, I] + [V] * 6 + [I] + [V] * 2 + [I] * 4 + [V] * 2
        out = torch.zeros((24, r), dtype=torch.float32, device=dev)

        def run():
            rc = fn(P(pattrs), r, P(a["ids"]), P(a["ts"]), P(a["te"]),
                    P(a["soff"]), P(a["kex"]), P(k_stash), k_stash.shape[0],
                    P(a["out"]), P(a["dout"]), n_sub, opts.grid.tiles_x, 1, 0,
                    P(out), _cuda.stream())
            assert rc == 0, rc
            return out
        return run

    stats = touch_stats(pattrs, ts32, te32, k_stash, kex, soff, opts.grid)
    runs = {n: (old_call if vs[n][3] == "old" else new_call)(lib, as_is)
            for n, lib in libs.items() if n in vs}
    runs["old_tiles_by_kexit"] = old_call(libs["old"], by_kexit)
    runs["new_tiles_by_kexit"] = new_call(libs["new"], by_kexit)
    bargs = (pattrs, ts, te, k_stash, k_kexit, k_out, d_out)
    old_kernel = runs["old"]

    def old_wrapper():
        # the old wrapper: finalize_cotangents' eager launches, then K2
        d0.copy_(finalize_cotangents(k_out, d_out, torch.zeros(3, device=dev),
                                     use_sa=True))
        return old_kernel()
    runs["old_wrapper"] = old_wrapper
    runs["new_wrapper"] = lambda: raster_backward_stash(*bargs, **kw)
    ref = runs["new"]().clone()
    old_ref = runs["old"]().clone()
    torch.cuda.synchronize()
    summary = {"card": card, "touch": stats, "k2": {}, "k5": {}, "k4": {}}
    for name, fn in runs.items():
        g = fn().clone()
        torch.cuda.synchronize()
        rel = max(float((g[c] - old_ref[c]).norm() / old_ref[c].norm())
                  for c in range(21) if float(old_ref[c].norm()) > 0)
        eq = bool(torch.equal(g, ref))
        print(f"[ab] {name}: bit-equal to new {eq}; largest relative L2 "
              f"row difference from old {rel:.2e}", flush=True)
        summary["k2"][name] = {"equal_to_new": eq, "rel_l2_vs_old": rel}
    times = {n: [] for n in runs}
    for _ in range(args.rounds):
        for n in list(runs) + list(reversed(list(runs))):
            times[n].append(cs.time_ms(runs[n], 10))
    for n, t in times.items():
        summary["k2"][n]["ms"] = float(np.median(t))
        print(f"[ab] K2 {n}: ms {np.median(t):.4f} "
              f"(all {' '.join('%.4f' % x for x in t)})", flush=True)

    # K5: the old kernel through ctypes, the new through its wrapper
    fn5 = libs["old"].raster_backward_restash
    fn5.argtypes = [V, I] + [V] * 4 + [I, V] + [I] * 4 + [V] * 2
    nrows = stash_rows(r, n_sub)
    scratch = torch.empty((nrows, 8, 256), device=dev)
    out5 = torch.zeros((24, r), device=dev)

    def k5_old():
        assert fn5(P(pattrs), r, P(ts32), P(te32), P(soff), P(scratch), nrows,
                   P(d0), n_sub, opts.grid.tiles_x, 1, 0, P(out5),
                   _cuda.stream()) == 0
        return out5

    def k5_new():
        return raster_backward(pattrs, ts, te, k_out, d_out, **kw)
    eq5 = bool(torch.equal(k5_new(), ref))
    eq5_old = bool(torch.equal(k5_old().clone(), old_ref))
    t5 = {"old": [], "new": []}
    for _ in range(args.rounds):
        for n, f in (("old", k5_old), ("new", k5_new), ("new", k5_new),
                     ("old", k5_old)):
            t5[n].append(cs.time_ms(f, 5))
    summary["k5"] = {"new_equal_to_new_k2": eq5, "old_equal_to_old_k2": eq5_old,
                     **{f"{n}_ms": float(np.median(v)) for n, v in t5.items()}}
    print(f"[ab] K5: {summary['k5']}", flush=True)

    # K4 at the reduction's shapes: the old [C, R] kernel (alone, and as
    # the old _land called it, after a transposed copy), the row kernel,
    # index_select on either layout and the plain version
    rr = int(bins.pair_gauss.shape[0])
    acc = torch.as_tensor(rng.normal(size=(rr, 24)).astype(np.float32),
                          device=dev)
    pos = torch.clamp(torch.cumsum(bins.counts, 0) - 1, 0, rr - 1).to(torch.int32)
    pos_l, n = pos.long(), int(pos.numel())
    fn4 = libs["gather_old"].monotone_row_gather
    fn4.argtypes = [V] * 3 + [I] * 3 + [V]
    out_t = torch.empty((24, n), device=dev)

    def k4_old(data_t):
        assert fn4(P(data_t), P(pos), P(out_t), rr, n, 24, _cuda.stream()) == 0
        return out_t
    data_t = acc.T.contiguous()
    new4 = monotone_row_gather_rows(acc, pos)
    summary["k4"]["bit_exact"] = bool(
        torch.equal(new4, monotone_row_gather_rows_plain(acc, pos))
        and torch.equal(new4, k4_old(data_t).T)
        and torch.equal(new4, torch.index_select(acc, 0, pos_l)))
    t4 = {}
    for _ in range(args.rounds):
        for name, f in (
                ("old_kernel", lambda: k4_old(data_t)),
                ("old_land", lambda: k4_old(acc.T.contiguous())),
                ("new_rows", lambda: monotone_row_gather_rows(acc, pos)),
                ("index_select_rows", lambda: torch.index_select(acc, 0, pos_l)),
                ("index_select_cols",
                 lambda: torch.index_select(data_t, 1, pos_l)),
                ("plain_rows", lambda: monotone_row_gather_rows_plain(acc, pos))):
            t4.setdefault(name, []).append(cs.time_graph_ms(f, 50))
    distinct = int(torch.unique(pos).numel())
    bound = (distinct * 24 + n * 24 + n) * 4 / cs.HBM_BYTES_PER_S * 1e3
    summary["k4"].update(n=n, r=rr, distinct=distinct, bound_ms=bound,
                         **{f"{k}_ms": float(np.median(v)) for k, v in t4.items()})
    print(f"[ab] K4: {summary['k4']}", flush=True)
    print(f"[card] {cs.card_line()}", flush=True)
    (args.out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
