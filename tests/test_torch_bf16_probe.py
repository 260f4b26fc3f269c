"""K6, the f32 vs bf16 elementwise-rate probe.

The plain version against the JAX kernel bodies (tools/bf16_probe.py:
_kern_fma, _kern_exp, _kern_mixed), run eagerly on jnp arrays through a
stand-in for the Pallas refs, on a [256, 512] numpy-seeded input: equal in
bf16 (every operation rounds to bf16 in both), within 1e-6 relative in
f32 (the packages' exp differ in the last bit). On the card the kernel
against the plain version at the probe's [4096, 512]: within 2e-5
relative in f32 (the kernel's FMA rounds once per step, the plain
version twice) and one bf16 ulp in bf16.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from gaus_slam_tpu_torch.ops.bf16_probe import (CHAIN_LEN, SHAPE, probe,
                                                probe_plain)

REPO = Path(__file__).resolve().parent.parent
CASES = [(c, d) for c in CHAIN_LEN for d in ("float32", "bfloat16")]


def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_bf16_probe", REPO / "tools" / "bf16_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Ref:
    """What a Pallas kernel body reads and writes through ``ref[:]``."""

    def __init__(self, a=None):
        self.a = a

    def __getitem__(self, idx):
        return self.a[idx]

    def __setitem__(self, idx, v):
        self.a = v


def _input(shape):
    return np.random.default_rng(0).uniform(0.5, 1.5, shape).astype(np.float32)


@pytest.mark.parametrize("chain,dtype", CASES)
def test_plain_matches_jax_kernel_bodies(chain, dtype):
    import jax.numpy as jnp

    jp = _jax_probe()
    body = {"fma": jp._kern_fma, "exp": jp._kern_exp,
            "mixed": jp._kern_mixed}[chain]
    x = _input((256, 512))
    out = _Ref()
    body(_Ref(jnp.asarray(x).astype(getattr(jnp, dtype))), out,
         dtype=getattr(jnp, dtype), n=CHAIN_LEN[chain])
    j = np.asarray(out.a.astype(jnp.float32))
    t = probe(torch.tensor(x).to(getattr(torch, dtype)), chain,
              CHAIN_LEN[chain]).float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
    assert np.isfinite(t).all() and not np.array_equal(t, x)


def test_probe_refuses_unknown_chain():
    with pytest.raises(ValueError, match="chain"):
        probe(torch.ones(8), "sqrt", 4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K6 runs only there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("chain,dtype", CASES)
def test_cuda_kernel_matches_plain(cuda_device, chain, dtype):
    x = torch.tensor(_input(SHAPE), device=cuda_device).to(
        getattr(torch, dtype))
    k = probe(x, chain, CHAIN_LEN[chain]).float()
    p = probe_plain(x, chain, CHAIN_LEN[chain]).float()
    rel = float(((k - p).abs() / p.abs()).max())
    assert rel <= (2e-5 if dtype == "float32" else 2.0 ** -7), rel
