"""Port parity of the monotone row gather (K4, ops/gather.py): the cases
of tests/test_gather.py, against the JAX kernel in interpret mode and
against numpy indexing, bit for bit (the gather only moves floats)."""
import numpy as np
import pytest
import torch

from gaus_slam_tpu_torch.ops import _cuda
from gaus_slam_tpu_torch.ops.gather import (monotone_row_gather,
                                            monotone_row_gather_plain)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cases():
    out = []
    for seed, d_max in [(0, 4), (1, 9), (2, 1)]:
        rng = np.random.default_rng(seed)
        n = 512
        steps = rng.integers(0, d_max + 1, size=n)
        pos = np.clip(np.cumsum(steps) - 1, 0, None).astype(np.int32)
        r = -(-int(pos[-1] + 1) // 128) * 128
        data = rng.standard_normal((r, 24)).astype(np.float32)
        out.append((f"random-{seed}-{d_max}", data, pos, d_max))
    # degenerate: every output row reads the same source row
    out.append(("all-equal", np.arange(128 * 8, dtype=np.float32)
                .reshape(128, 8), np.full((256,), 7, np.int32), 4))
    # positions at the very end of the data array (the band clamp)
    rng = np.random.default_rng(3)
    r, n = 256, 128
    out.append(("tail", rng.standard_normal((r, 8)).astype(np.float32),
                np.minimum(np.arange(n, dtype=np.int32) + (r - n), r - 1), 2))
    return out


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_matches_jax_bit_exact(case):
    # imported here so the card-only tests also run where jax is absent
    jnp = pytest.importorskip("jax.numpy")
    from gaus_slam_tpu.ops.gather import monotone_row_gather as j_gather

    _, data, pos, d_max = case
    ref = np.asarray(j_gather(jnp.asarray(data.T), jnp.asarray(pos),
                              max_step=d_max, interpret=True))
    got = monotone_row_gather(torch.tensor(data.T.copy()), torch.tensor(pos),
                              max_step=d_max)
    assert got.shape == (data.shape[1], pos.shape[0])
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), data[pos].T)


def test_cpu_wrapper_launches_nothing():
    before = dict(_cuda.LAUNCHES)
    monotone_row_gather(torch.zeros(8, 128), torch.zeros(128, dtype=torch.int32),
                        max_step=1)
    assert dict(_cuda.LAUNCHES) == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_cuda_kernel_bit_exact(cuda_device, case):
    _, data, pos, d_max = case
    d = torch.tensor(data.T.copy(), device=cuda_device)
    p = torch.tensor(pos, device=cuda_device)
    n0 = _cuda.LAUNCHES["monotone_row_gather"]
    got = monotone_row_gather(d, p, max_step=d_max)
    assert _cuda.LAUNCHES["monotone_row_gather"] == n0 + 1
    assert torch.equal(got, monotone_row_gather_plain(d, p))
