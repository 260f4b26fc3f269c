"""Port parity of the monotone row gather (K4, ops/gather.py): the cases
of tests/test_gather.py, against the JAX kernel in interpret mode and
against numpy indexing, bit for bit (the gather only moves floats); and
the row-layout function the gradient reduction calls
(``monotone_row_gather_rows``, [R, C] -> [N, C]) for several widths,
ragged and empty N, repeated and out-of-range positions (NaN rows)."""
import numpy as np
import pytest
import torch

from gaus_slam_tpu_torch.ops import _cuda
from gaus_slam_tpu_torch.ops.gather import (monotone_row_gather,
                                            monotone_row_gather_plain,
                                            monotone_row_gather_rows,
                                            monotone_row_gather_rows_plain)


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

WIDTHS = (24, 21, 3)
N_KINDS = ("multiple-of-4", "ragged", "empty")


def _row_case(c, n_kind, seed=0):
    """[R, C] data and monotone positions with runs of repeats; the
    ragged case also holds positions past either end of the data."""
    rng = np.random.default_rng(seed + c)
    n = {"multiple-of-4": 516, "ragged": 389, "empty": 0}[n_kind]
    pos = np.clip(np.cumsum(rng.integers(0, 5, size=n)) - 1, 0, None)
    r = -(-int(pos.max(initial=0) + 1) // 128) * 128
    pos = pos.astype(np.int32)
    if n_kind == "ragged":
        pos[:3] = -1
        pos[-2:] = r + 7
    data = rng.standard_normal((r, c)).astype(np.float32)
    return data, pos


def _numpy_rows(data, pos):
    ok = (pos >= 0) & (pos < data.shape[0])
    rows = data[np.clip(pos, 0, data.shape[0] - 1)]
    return np.where(ok[:, None], rows, np.float32(np.nan)).astype(np.float32)


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


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


@pytest.mark.parametrize("n_kind", N_KINDS)
@pytest.mark.parametrize("c", WIDTHS)
def test_rows_match_numpy(c, n_kind):
    """The row-layout function on the CPU (its plain version) against
    numpy indexing, NaN rows for out-of-range positions included."""
    data, pos = _row_case(c, n_kind)
    got = monotone_row_gather_rows(torch.tensor(data), torch.tensor(pos))
    assert got.shape == (pos.shape[0], c)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(_numpy_rows(data, pos)))
    if n_kind == "ragged":
        assert np.isnan(got.numpy()[:3]).all() and np.isnan(got.numpy()[-2:]).all()
    # the JAX contract is the transposed view of the same gather
    t = monotone_row_gather(torch.tensor(data.T.copy()), torch.tensor(pos),
                            max_step=4)
    np.testing.assert_array_equal(_bits(t.numpy().T), _bits(got.numpy()))


@pytest.mark.parametrize("c", WIDTHS)
def test_rows_match_jax(c):
    """The row-layout function against the JAX kernel in interpret mode.
    The JAX kernel takes C a multiple of 8, N a multiple of 128 and
    positions inside the data, so its call gets zero channels and repeats
    of the last position as padding, which the comparison drops."""
    jnp = pytest.importorskip("jax.numpy")
    from gaus_slam_tpu.ops.gather import monotone_row_gather as j_gather

    data, pos = _row_case(c, "multiple-of-4", seed=11)
    n = pos.shape[0]
    c_pad, n_pad = -(-c // 8) * 8, -(-n // 128) * 128
    data_p = np.zeros((data.shape[0], c_pad), np.float32)
    data_p[:, :c] = data
    pos_p = np.concatenate([pos, np.full(n_pad - n, pos[-1], np.int32)])
    ref = np.asarray(j_gather(jnp.asarray(data_p.T), jnp.asarray(pos_p),
                              max_step=4, interpret=True))[:c, :n].T
    got = monotone_row_gather_rows(torch.tensor(data), torch.tensor(pos))
    np.testing.assert_array_equal(got.numpy(), ref)


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


@pytest.mark.cuda
@pytest.mark.parametrize("n_kind", N_KINDS)
@pytest.mark.parametrize("c", WIDTHS)
def test_cuda_rows_kernel_bit_exact(cuda_device, c, n_kind):
    """The row kernel (16-byte vectors at C = 24, its scalar loop at 21
    and 3) against its plain version and numpy, NaN rows included."""
    data, pos = _row_case(c, n_kind)
    d = torch.tensor(data, device=cuda_device)
    p = torch.tensor(pos, device=cuda_device)
    n0 = _cuda.LAUNCHES["monotone_row_gather"]
    got = monotone_row_gather_rows(d, p)
    # an empty gather launches nothing
    assert _cuda.LAUNCHES["monotone_row_gather"] == n0 + (n_kind != "empty")
    want = monotone_row_gather_rows_plain(d, p)
    np.testing.assert_array_equal(_bits(got.cpu().numpy()),
                                  _bits(want.cpu().numpy()))
    np.testing.assert_array_equal(_bits(got.cpu().numpy()),
                                  _bits(_numpy_rows(data, pos)))


@pytest.mark.cuda
def test_cuda_rows_kernel_unaligned_rows(cuda_device):
    """Rows that do not start on 16 bytes take the kernel's scalar loop."""
    data, pos = _row_case(24, "ragged")
    flat = torch.zeros(data.size + 1, device=cuda_device)
    flat[1:] = torch.tensor(data.reshape(-1), device=cuda_device)
    d = flat[1:].view(data.shape)
    assert d.data_ptr() % 16 != 0
    got = monotone_row_gather_rows(d, torch.tensor(pos, device=cuda_device))
    np.testing.assert_array_equal(_bits(got.cpu().numpy()),
                                  _bits(_numpy_rows(data, pos)))
