"""Port parity: se3, camera, preprocess and binning (gaus_slam_tpu_torch.ops
against gaus_slam_tpu.ops) on the same numpy-seeded inputs.

Tolerances: rtol 1e-5, with an absolute 1e-5 of each array's scale, for
float math (float32 reassociation between XLA and PyTorch; both run the
same formulas). Binning is fed *the same* PreSummary arrays in both
packages, so its integer outputs must agree bit for bit (a stable sort
of the same int32 keys).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaus_slam_tpu.ops import binning as JB
from gaus_slam_tpu.ops import camera as JC
from gaus_slam_tpu.ops import preprocess as JP
from gaus_slam_tpu.ops import se3 as JS
from gaus_slam_tpu_torch.ops import binning as TB
from gaus_slam_tpu_torch.ops import camera as TC
from gaus_slam_tpu_torch.ops import preprocess as TP
from gaus_slam_tpu_torch.ops import se3 as TS


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


H, W, F = 48, 64, 50.0
RTOL, ATOL = 1e-5, 1e-5


def surfels(seed, n):
    """Random surfels in front of a 48x64 camera (some off-screen)."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(0.5, 3.0, n)
    u = rng.uniform(-8, W + 8, n)
    v = rng.uniform(-8, H + 8, n)
    xyz = np.stack([(u - W / 2) * z / F, (v - H / 2) * z / F, z], -1)
    scales = np.exp(rng.uniform(np.log(0.01), np.log(0.15), (n, 2)))
    quats = rng.normal(size=(n, 4)) * 0.4
    quats[:, 0] += 1.0
    opac = rng.uniform(0.05, 0.99, n)
    colors = rng.uniform(0, 1, (n, 3))
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return tuple(map(f32, (xyz, scales, quats, opac, colors)))


def pose(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4) * 0.1
    q[0] += 1.0
    R = np.asarray(JS.quat_to_rotmat(jnp.asarray(q, jnp.float32)))
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = R
    m[:3, 3] = rng.normal(size=3) * 0.1
    return m


def cams(w2c):
    jc = JC.Camera(H, W, F, F, W / 2, H / 2, jnp.asarray(w2c))
    tc = TC.Camera(H, W, F, F, W / 2, H / 2, torch.tensor(w2c))
    return jc, tc


def close(a, b, rtol=RTOL, atol=ATOL):
    """rtol, plus atol relative to the array's scale: entries that are
    differences of large products (the a0/a1/a2 cross products) carry
    the rounding of their terms, not of their small result."""
    a = np.asarray(a)
    scale = max(float(np.abs(a).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(np.asarray(b), a, rtol=rtol, atol=atol * scale)


def test_se3_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    t = rng.normal(size=(64, 3)).astype(np.float32)
    close(JS.quat_to_rotmat(jnp.asarray(q)), TS.quat_to_rotmat(torch.tensor(q)))
    R = np.asarray(JS.quat_to_rotmat(jnp.asarray(q)))
    close(JS.rotmat_to_quat(jnp.asarray(R)), TS.rotmat_to_quat(torch.tensor(R)))
    close(JS.quat_multiply(jnp.asarray(q), jnp.asarray(q[::-1].copy())),
          TS.quat_multiply(torch.tensor(q), torch.tensor(q[::-1].copy())))
    close(JS.quat_multiply_rows(jnp.asarray(q[0]), jnp.asarray(q.T)),
          TS.quat_multiply_rows(torch.tensor(q[0]), torch.tensor(q.T.copy())))
    M = np.asarray(JS.pose_matrix(jnp.asarray(q), jnp.asarray(t)))
    close(M, TS.pose_matrix(torch.tensor(q), torch.tensor(t)))
    close(JS.invert_se3(jnp.asarray(M)), TS.invert_se3(torch.tensor(M)))
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    close(JS.transform_points(jnp.asarray(M[0]), jnp.asarray(pts)),
          TS.transform_points(torch.tensor(M[0]), torch.tensor(pts)))


def test_camera_matches_jax():
    jc, tc = cams(pose(1))
    close(JC.world_to_pix3(jc), TC.world_to_pix3(tc))
    pts = surfels(2, 32)[0]
    jxy, jz = JC.project_points(jc, jnp.asarray(pts))
    txy, tz = TC.project_points(tc, torch.tensor(pts))
    close(jxy, txy)
    close(jz, tz)
    assert TC.T_EPS == JC.T_EPS and TC.ALPHA_MAX == JC.ALPHA_MAX
    assert TC.ALPHA_MIN == JC.ALPHA_MIN and TC.NEAR_N == JC.NEAR_N


@pytest.mark.parametrize("seed", [0, 1])
def test_preprocess_matches_jax(seed):
    xyz, sc, q, op, col = surfels(seed, 300)
    jc, tc = cams(pose(seed + 10))
    active = np.random.default_rng(seed).uniform(size=300) < 0.9
    jp = JP.preprocess(*map(jnp.asarray, (xyz, sc, q, op)), jc,
                       active=jnp.asarray(active))
    tp = TP.preprocess(*map(torch.tensor, (xyz, sc, q, op)), tc,
                       active=torch.tensor(active))
    for f in JP.PreprocResult._fields:
        a, b = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            close(a, b)
    # packed [24, N] slab and the lane-major production path
    close(JP.pack_pair_attrs(jp, jnp.asarray(col)),
          TP.pack_pair_attrs(tp, torch.tensor(col)))
    ja, js = JP.preprocess_t(*(jnp.asarray(a.T) for a in (xyz, sc, q)),
                             jnp.asarray(op), jnp.asarray(col.T), jc,
                             active=jnp.asarray(active))
    ta, ts = TP.preprocess_t(*(torch.tensor(a.T.copy()) for a in (xyz, sc, q)),
                             torch.tensor(op), torch.tensor(col.T.copy()), tc,
                             active=torch.tensor(active))
    assert ta.shape == (TP.PAIR_C, 300)
    close(ja, ta)
    for f in JP.PreSummary._fields:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b)
        else:
            close(a, b)


def _summary(seed, n):
    """One PreSummary (numpy) from the JAX preprocess, for both binnings."""
    xyz, sc, q, op, _ = surfels(seed, n)
    jc, _ = cams(pose(seed + 20))
    pre = JP.preprocess(*map(jnp.asarray, (xyz, sc, q, op)), jc)
    s = JP.PreSummary(valid=pre.valid, center=pre.center, radius=pre.radius,
                      depth=pre.depth)
    return {f: np.asarray(getattr(s, f)) for f in JP.PreSummary._fields}


BIN_CASES = [
    # (seed, n, r_max, d_max, reduce_perm, phase_stride, nested)
    (0, 400, None, 4, True, 0, False),
    (1, 400, 256, 4, True, 0, False),      # budget overflow: tail dropped
    (2, 500, 2048, 6, True, 3, False),     # phase-major, stride 3
    (3, 500, 2048, 4, True, 2, False),     # phase-major, stride 2
    (4, 500, 2560, 4, False, 4, True),     # nested phase order, stride 4
]


@pytest.mark.parametrize("case", BIN_CASES)
def test_binning_bit_exact(case):
    seed, n, r_max, d_max, rp, stride, nested = case
    s = _summary(seed, n)
    grid = JB.TileGrid(-(-W // 16), -(-H // 16), 16, 16)
    jb = JB.bin_gaussians(JP.PreSummary(**{k: jnp.asarray(v)
                                           for k, v in s.items()}),
                          grid, r_max=r_max, max_tiles_per_gaussian=d_max,
                          reduce_perm=rp, phase_stride=stride,
                          phase_nested=nested)
    tb = TB.bin_gaussians(TP.PreSummary(**{k: torch.tensor(v)
                                           for k, v in s.items()}),
                          TB.TileGrid(*grid), r_max=r_max,
                          max_tiles_per_gaussian=d_max, reduce_perm=rp,
                          phase_stride=stride, phase_nested=nested)
    fields = ["pair_gauss", "pair_slab", "slab_tail", "pair_ok", "tile_start",
              "tile_stop", "num_pairs", "overflow", "demand", "n_shrunk",
              "counts"]
    if rp:
        fields += ["red_keys", "red_perm"]
    if stride:
        fields += ["phase_start", "slab_phase"]
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(jb, f)),
                                      getattr(tb, f).numpy(), err_msg=f)
    assert int(tb.num_pairs) > 0
    if r_max == 256:
        assert bool(tb.overflow)
