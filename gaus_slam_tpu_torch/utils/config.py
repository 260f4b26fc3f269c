"""Config-as-code loading + typed views (port of
gaus_slam_tpu/utils/config.py).

The same ``configs/*/config.py`` files drive both packages: a python
module exporting a nested ``config`` dict, loaded from its path and
mutated in place with the probed camera height/width/intrinsics.
``SystemConfig`` converts the dict into the static config objects the
step functions take, with the same values as the JAX package's for the
same dict; the camera lives on ``device``. Both render methods load
("2dgs" surfels, "3dgs" volumetric gaussians, isotropic when
``gaussians.gaussian_distribution`` says so), and ``backend.gs_densify``
sets ``MapConfig.gs_stats``, the view-space gradient statistics the
backend's clone / split / prune reads.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from importlib.machinery import SourceFileLoader

import numpy as np

from ..models.frame import LrSchedule
from ..ops.binning import make_grid
from ..ops.camera import Camera, camera_from_intrinsics
from ..ops.raster import BACKENDS
from ..render import RenderOptions
from ..slam.densify import DensifyConfig
from ..slam.loss import LossConfig
from ..slam.steps import MapConfig, TrackConfig


def load_config(path: str) -> dict:
    module = SourceFileLoader("exp_config", path).load_module()
    return module.config


def probe_cameras(config: dict, color, intrinsics) -> None:
    """Fill config['cameras'] h/w/K from the first frame
    (scripts/gaus.py:75-78)."""
    config["cameras"]["height"] = int(color.shape[0])
    config["cameras"]["width"] = int(color.shape[1])
    k = np.asarray(intrinsics)
    config["cameras"]["intrinsics"] = k[:3, :3].tolist()


def _sched(lr_cfg: dict, prefix: str) -> LrSchedule:
    return LrSchedule(
        float(lr_cfg[f"{prefix}_lr_init"]),
        float(lr_cfg[f"{prefix}_lr_final"]),
        int(lr_cfg[f"{prefix}_lr_max_step"]),
    )


@dataclass(frozen=True)
class SystemConfig:
    cam: Camera                # intrinsics carrier (w2c = identity)
    opts: RenderOptions
    lcfg: LossConfig
    dcfg: DensifyConfig
    mcfg: MapConfig
    track_front: TrackConfig
    track_back: TrackConfig
    exp_sched_front: LrSchedule
    exp_sched_back: LrSchedule
    adam_betas: tuple

    # pair-budget escalation ladder for max_tiles_per_gaussian
    DMAX_LADDER = (4, 6, 9, 16)

    def maybe_escalate(self, *, overflow: bool, n_shrunk: int,
                       n_active: int,
                       demand: int = 0) -> "SystemConfig | None":
        """Escalated copy of this config, or None if budgets hold.

        Capacities are static, so on pair-budget overflow the budget
        grows (the explicit ``pair_cap`` in 2^17-row steps sized to
        ``demand`` with 15% headroom, else the factor, sized to demand in
        1/8 steps or 1.5x without a demand signal), and when more than
        2% of the gaussians had their tile rect shrunk to fit d_max,
        d_max moves up the ladder."""
        opts = self.opts
        factor = opts.pair_budget_factor
        pair_cap = opts.pair_cap
        dmax = opts.max_tiles_per_gaussian
        if overflow and pair_cap > 0:
            q = 1 << 17
            need = int(demand * 1.15) if demand > pair_cap \
                else int(pair_cap * 1.25)
            pair_cap = max(-(-need // q) * q, pair_cap + q)
        elif overflow and factor < 16:
            if demand > 0 and n_active > 0:
                need = -(-(demand * 1.15 / n_active) * 8 // 1) / 8
                factor = min(16.0, need if need > factor
                             else round(factor * 1.125, 3))
            else:
                factor = round(factor * 1.5, 3)
        if n_shrunk > max(64, 0.02 * max(n_active, 1)):
            for step in self.DMAX_LADDER:
                if step > dmax:
                    dmax = step
                    break
        if (factor, pair_cap, dmax) == (opts.pair_budget_factor,
                                        opts.pair_cap,
                                        opts.max_tiles_per_gaussian):
            return None
        return dataclasses.replace(
            self,
            opts=opts._replace(pair_budget_factor=factor,
                               pair_cap=pair_cap,
                               max_tiles_per_gaussian=dmax),
        )

    @classmethod
    def from_config(cls, config: dict, backend: str = "pallas",
                    component: str = "backend", device="cuda"):
        """``backend`` takes the JAX package's names: "pallas" and
        "interpret" select the stash kernels (K1-K4 on a CUDA device, their
        plain versions on the CPU), "reference" the plain compositor with
        K5 as its backward."""
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of "
                             f"{BACKENDS}")
        camcfg = config["cameras"]
        h, w = camcfg["height"], camcfg["width"]
        cam = camera_from_intrinsics(
            h, w, np.asarray(camcfg["intrinsics"]), np.eye(4, dtype=np.float32),
            device=device,
        )
        grid = make_grid(cam, 16, 16)
        r = config["render"]
        method = r.get("method", "2dgs")
        if method not in ("2dgs", "3dgs"):
            raise ValueError(f"unknown render method {method!r}")
        tpu = config.get("tpu", {})
        # the stash path's pair chain in float32 or bfloat16: the CUDA
        # kernels' bf16 instantiation on "pallas", the plain versions on
        # "interpret" (the JAX package refuses bf16 on "pallas" only
        # because v5e Mosaic cannot lower bf16 comparisons);
        # the reference backend ignores it, as in the JAX package
        compute_dtype = str(tpu.get("compute_dtype", "f32"))
        if compute_dtype not in ("f32", "bf16"):
            raise ValueError(f"tpu.compute_dtype={compute_dtype!r}: "
                             f"one of 'f32', 'bf16'")
        # pyramid coarse tracking: several levels need the NESTED phase
        # order, which exists for coarsest stride 2 or 4 only, with each
        # level dividing the previous
        lvl_strides = [int(s) for _, s in
                       (config["frontend"].get("coarse_levels") or ())
                       if int(s) > 1]
        if len(lvl_strides) > 1:
            if lvl_strides[0] not in (2, 4):
                raise ValueError(
                    f"frontend.coarse_levels coarsest stride "
                    f"{lvl_strides[0]} unsupported: the nested "
                    f"phase-major cache exists for strides 2 and 4")
            for a, b in zip(lvl_strides, lvl_strides[1:]):
                if a % b != 0:
                    raise ValueError(
                        f"frontend.coarse_levels strides {lvl_strides} "
                        f"must nest (each divides the previous)")
        # per-component pair budgets: r_max = factor * capacity bucket
        factor = float(tpu.get("pair_budget_factor", 2))
        pair_cap = int(tpu.get("backend_pair_cap", 0))
        iso = config["gaussians"].get(
            "gaussian_distribution", "anisotropic") == "isotropic"
        if component == "frontend":
            factor = float(tpu.get("pair_budget_factor_frontend", factor))
            pair_cap = int(tpu.get("frontend_pair_cap", 0))
        opts = RenderOptions(
            grid=grid, use_sa=bool(r.get("use_sa", True)), backend=backend,
            pair_budget_factor=factor,
            pair_cap=pair_cap,
            max_tiles_per_gaussian=int(tpu.get("max_tiles_per_gaussian", 4)),
            normals_in_tracking=bool(
                config["loss"].get("use_normal_loss", False)),
            method=method,
            iso3d=iso,
            compute_dtype=compute_dtype,
        )
        loss = config["loss"]
        dens = config["densify"]
        lcfg = LossConfig(
            use_weight_norm=bool(r.get("use_weight_norm", True)),
            eps=float(r.get("eps", 1e-6)),
            depth_far=float(r.get("depth_far", 1e2)),
            depth_near=float(r.get("depth_near", 1e-2)),
            enable_exposure=bool(r.get("enable_exposure", False)),
            silmask_th=float(loss.get("silmask_th", 0.9)),
            ignore_outliers=bool(loss.get("ignore_outliners", False)),
            w_color_tracking=float(loss["tracking"]["color"]),
            w_depth_tracking=float(loss["tracking"]["depth"]),
            w_color_mapping=float(loss["mapping"]["color"]),
            w_depth_mapping=float(loss["mapping"]["depth"]),
            w_dist=float(loss["mapping"].get("dist", 0.0)),
            use_edge_growth=bool(dens.get("use_edge_growth", False)),
            edge_thres=float(dens.get("edge_thres", 0.4)),
        )
        dcfg = DensifyConfig(
            sil_thres=float(dens["sil_thres"]),
            dep_thres=float(dens.get("dep_thres", 0.1)),
            opacity_cull=float(dens.get("opacity_cuil", 0.05)),
            scale_cull=float(dens.get("scale_cuil", 5e-4)),
            scale_max=float(dens.get("scale_max", 0.1)),
            use_edge_growth=bool(dens.get("use_edge_growth", False)),
            edge_thres=float(dens.get("edge_thres", 0.4)),
        )
        ta = config["gaussians"]["training_args"]
        mcfg = MapConfig(
            lrs=tuple(sorted(
                (k, float(v)) for k, v in ta.items()
                if k in ("xyz_lr", "scaling_lr", "rotation_lr",
                         "opacity_lr", "rgb_lr")
            )),
            isotropic=iso,
            gs_stats=bool(config["backend"].get("gs_densify", False)),
        )
        betas = tuple(camcfg.get("adam_betas", (0.9, 0.99)))
        fe, be = camcfg["frontend_lr"], camcfg["backend_lr"]
        fr = config["frontend"]
        nb = config["backend"]["num_ba_iters"]
        track_front = TrackConfig(
            num_iters=int(fr["num_tracking_iters"]),
            converged_th=float(fr.get("converged_th", -1)),
            rot_sched=_sched(fe, "cam_rot"),
            trans_sched=_sched(fe, "cam_trans"),
            betas=betas,
            coarse_iters=int(fr.get("coarse_iters", 0)),
            coarse_stride=int(fr.get("coarse_stride", 2)),
            coarse_levels=tuple(
                (int(i), int(s))
                for i, s in (fr.get("coarse_levels") or ())),
        )
        track_back = TrackConfig(
            num_iters=nb,
            converged_th=-1.0,
            rot_sched=_sched(be, "cam_rot"),
            trans_sched=_sched(be, "cam_trans"),
            betas=betas,
        )
        return cls(
            cam=cam, opts=opts, lcfg=lcfg, dcfg=dcfg, mcfg=mcfg,
            track_front=track_front, track_back=track_back,
            exp_sched_front=_sched(fe, "exposure"),
            exp_sched_back=_sched(be, "exposure"),
            adam_betas=betas,
        )
