"""gaus_slam_tpu_torch — the PyTorch/CUDA port of gaus_slam_tpu.

Same module layout as the JAX package, so each module's counterpart is
easy to find; inside it is plain PyTorch: functions on tensors,
``NamedTuple`` state, an explicit ``device`` on every entry point
(``"cuda"`` unless the caller asks for ``"cpu"``), and
``torch.autograd.Function`` wherever a kernel needs a gradient.

The differentiable rasterizer runs four hand-written CUDA kernels
(``csrc/``, built with nvcc at first use into ``build/torch_kernels``):

  K1 raster_forward_stash   forward + per-block carry stash (grad path)
  K2 raster_backward_stash  reverse sweep, hand-derived vjp per block
  K3 raster_forward         forward without stash (no-grad renders)
  K4 monotone_row_gather    landing gather of the pair->gaussian reduction

On a CPU tensor every wrapper runs its kernel's plain PyTorch version;
on a CUDA tensor it launches the kernel or raises.

Layout:
  ops/     camera, SE(3), preprocess, binning, compositing, raster kernels
  render/  render facade (tracking / mapping / view modes)
  models/  static-capacity gaussian map, pose and exposure state
  slam/    losses, map init, densify, tracking and mapping loops
  parallel/ keyframe-parallel BA over a group of devices
  scripts/ the drivers (gaus, gaus_mp pipelined, splatam, eval, vis_final)
  data/    procedural synthetic RGB-D scene
  convert  numpy <-> port state (to feed both packages the same map)
"""

__version__ = "0.1.0"
