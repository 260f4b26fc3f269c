"""The port imports neither jax nor the JAX package.

Run in a subprocess: this test process has already imported jax (the
test configuration does), so only a fresh interpreter can show that
importing every module of gaus_slam_tpu_torch pulls in neither.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

PROBE = r"""
import importlib, json, pkgutil, sys
import gaus_slam_tpu_torch as pkg
names = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "gaus_slam_tpu"
             or m.startswith("gaus_slam_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["bad"] == [], res["bad"]
    # every module of the slice was imported
    for mod in ("ops.camera", "ops.se3", "ops.geometry", "ops.preprocess",
                "ops.binning", "ops.compositing", "ops.composite_ref",
                "ops.raster_forward", "ops.raster_backward", "ops.gather",
                "ops.raster", "render", "models.gaussians", "models.frame",
                "slam.loss", "slam.init_map", "slam.densify", "slam.steps",
                "data.synthetic", "convert", "utils.config", "utils.stage",
                "utils.fence", "models.descriptor", "models.submap",
                "slam.frontend", "slam.backend", "utils.trajectory",
                "utils.image_metrics", "utils.eval", "utils.ply",
                "utils.scene_io", "utils.viz", "data", "scripts",
                "scripts.gaus", "ops.bf16_probe", "tools",
                "tools.bf16_probe", "tools.kernel_ab", "data.basedataset",
                "utils.png", "utils.yaml_lite", "utils.tsdf",
                "utils.eval_mesh", "utils.lpips", "utils.checkpoint",
                "native", "scripts.eval", "scripts.vis_final", "ops.sh",
                "ops.knn", "ops.preprocess_3dgs", "scripts.splatam",
                "parallel", "parallel.ba", "scripts.gaus_mp",
                "scripts.eval_nvs", "scripts.gen_video", "utils.gif",
                "utils.keyframe_selection", "tools.microbench",
                "tools.backend_probe", "tools.ab_runner", "tools.quality_ab",
                "tools.test_spread"):
        assert "gaus_slam_tpu_torch." + mod in res["modules"], mod


def test_chip_smoke_imports_no_jax():
    probe = ("import json, sys; sys.argv = ['chip_smoke']; import chip_smoke; "
             "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' "
             "or m.startswith('jax.') or m.startswith('gaus_slam_tpu.') "
             "or m == 'gaus_slam_tpu')))")
    r = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []
