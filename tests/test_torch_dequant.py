"""The Frontend's frame dequantization (``slam/frontend.py::_to_device``,
the JAX frontend's ``_dequant_u8`` / ``_dequant_u16``) as a program of
the Frontend's owner: the widen-and-multiply captured (on the CPU its
static-buffer body), the host-to-card copy outside it. Its result equals
the eager call's bit for bit, for uint8 colour, uint16 depth and float32
input (which needs no program), and is the caller's own: the next
frame's call does not overwrite it."""
import numpy as np
import pytest
import torch

from gaus_slam_tpu_torch.slam import programs
from gaus_slam_tpu_torch.slam.frontend import _to_device


def _frames(dtype, n=2, seed=0):
    rng = np.random.default_rng(seed)
    shape = (24, 32, 3) if dtype == np.uint8 else (24, 32)
    if dtype == np.float32:
        return [rng.random(shape, dtype=np.float32) for _ in range(n)]
    return [rng.integers(0, np.iinfo(dtype).max, shape, dtype=dtype,
                         endpoint=True) for _ in range(n)]


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_dequant_program_equals_eager(dtype, as_tensor):
    own = programs.Owner("frontend")
    frames = _frames(dtype)
    got = []
    for f in frames:
        x = torch.from_numpy(f) if as_tensor else f
        got.append(_to_device(x, "cpu", own))
    for f, g in zip(frames, got):
        with programs.eager():
            want = _to_device(torch.from_numpy(f) if as_tensor else f, "cpu")
        assert g.dtype == want.dtype == torch.float32
        assert torch.equal(g, want)
    names = [p.name for p in own.programs.values()]
    assert names == ([] if dtype == np.float32 else ["dequant"])
