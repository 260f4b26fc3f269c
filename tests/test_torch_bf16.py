"""The bf16 compute dtype of K1-K3 (``tpu.compute_dtype = "bf16"``): the
port's plain bf16 chain (ops/compositing.py) against the JAX package's
bf16 path, and the kernels' bf16 instantiation (csrc/raster_common.cuh
with CT = BF16, built for the CPU with g++) against the plain chain.

Tolerances:
  * plain bf16 against JAX bf16 (interpret mode), and against the port's
    own float32 path: tests/test_raster_grad.py:281-316's bounds, each
    relative to the reference's channel or gradient scale — q99 6e-2
    (12e-2 on the median channel 8) and mean 1.5e-2 on channels 0-8, mean
    0.6 on the cancelling distortion channel 9, loss rtol 5e-2, gradient
    q99 0.15 and mean 3e-2, under 1% of the zero structure flipped. XLA
    and torch round bf16 at other places (XLA may fuse ops and round
    less often), so the two chains agree to a tolerance, not to bits;
  * the kernels' bf16 math against the plain chain: both round the same
    ops, but sum the prefixes in another order (sequential per pixel vs
    cumsum), and a prefix that lands across a bf16 rounding boundary
    moves that pair's T_pref by one bf16 step (2^-8 relative) and what
    follows from it, a rare event (92-98% of the float values come out
    bit-equal on these scenes): float channels q99 1e-3 and mean 1e-4 of
    the channel's scale (q99 1e-2 and mean 1e-3 on the distortion channel
    9, which cancels), under 0.5% of the pixels with another contributor
    count, kexit exactly, gradient rows within relative L2 5e-2 of the plain
    version's (torch.autograd of the bf16 chain rounds every cotangent to
    bf16; the kernel's vjp runs in float32 on the rounded forward values);
  * the kernels' bf16 gradient against the plain chain differentiated as
    the kernel differentiates (float32 on the rounded values,
    ``f32_vjp``): q99 1e-4 and mean 1e-5 of the largest gradient, each
    row within relative L2 1e-2 (these scenes read q99 <= 8e-6, rows <=
    3.0e-3; a row scaled by 0.98 fails); the plain forward under
    ``f32_vjp`` bit for bit that of the bf16 tensors;
  * the host math with and without its skips (-DGS_FWD_NO_SKIP), and its
    bf16 rounding against PyTorch's: bit for bit.
"""
import numpy as np
import pytest
import torch

from gaus_slam_tpu_torch.ops import binning as TB
from gaus_slam_tpu_torch.ops import preprocess as TP
from gaus_slam_tpu_torch.ops import raster_backward as TRB
from gaus_slam_tpu_torch.ops import raster_forward as TRF
from gaus_slam_tpu_torch.ops.binning import TileGrid
from gaus_slam_tpu_torch.ops.camera import Camera as TCam
from gaus_slam_tpu_torch.ops.raster import RenderSettings, render_pairs
from test_torch_raster import (_build_host_math, _ptr, cull_counts,
                               host_backward, host_forward,
                               host_math)  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _Bf16:
    """The host library's bf16 entry points under the f32 ones' names."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        return getattr(self.lib, name + "_bf16")


@pytest.fixture(scope="module")
def host_math_no_skip(tmp_path_factory):
    return _build_host_math(tmp_path_factory, "-DGS_FWD_NO_SKIP")


# ---------------------------------------------------------------------------
# the plain chain against the JAX package


@pytest.fixture(scope="module")
def renders():
    """Loss, render and gradient of test_raster_grad.py:259's scene (32x32,
    220 gaussians) through the JAX render_pairs in bf16 (interpret mode)
    and through the port's render_pairs in bf16 and in float32 (the plain
    versions on the CPU), SA on and off."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from gaus_slam_tpu.ops.raster import RenderSettings as JSettings
    from gaus_slam_tpu.ops.raster import render_pairs as j_render
    from gaus_slam_tpu.render import expand_pairs
    from test_raster_grad import build, make_cam, random_cotangent

    cam = make_cam(32, 32)
    attrs_t, bins, grid = build(jax.random.PRNGKey(3), 220, cam, r_max=768)
    dw = random_cotangent(jax.random.PRNGKey(4), grid, grid.num_tiles)
    pg = torch.tensor(np.asarray(bins.pair_gauss)).long()
    ts = torch.tensor(np.asarray(bins.tile_start))
    te = torch.tensor(np.asarray(bins.tile_stop))
    dwt = torch.tensor(np.asarray(dw))
    res = {}
    for use_sa in (False, True):
        st = JSettings(grid=grid, use_sa=use_sa, backend="interpret",
                       compute_dtype="bf16")

        def loss(a):
            pattrs = expand_pairs(a, bins, bins.num_tiles_touched)
            out = j_render(pattrs, bins.tile_start, bins.tile_stop, None, st)
            return jnp.sum(out * dw), out

        (v, o), g = jax.value_and_grad(loss, has_aux=True)(attrs_t)
        res["jax", use_sa] = (float(v), np.asarray(o), np.asarray(g))
        for cd in ("f32", "bf16"):
            ta = torch.tensor(np.asarray(attrs_t), requires_grad=True)
            out = render_pairs(ta[pg].T.contiguous(), ts, te, None,
                               RenderSettings(TileGrid(*grid), use_sa,
                                              "interpret", compute_dtype=cd))
            v = torch.sum(out * dwt)
            (g,) = torch.autograd.grad(v, ta)
            assert out.dtype == torch.float32 and g.dtype == torch.float32
            res[cd, use_sa] = (float(v), out.detach().numpy(), g.numpy())
    return res


def assert_bf16_bounds(got, ref):
    """tests/test_raster_grad.py:281-316's bounds of a bf16 render (loss,
    out, gradient) against a reference."""
    (v, o, g), (vr, orf, gr) = got, ref
    for c in range(9):
        sc = max(np.abs(orf[:, c]).max(), 1e-3)
        err = np.abs(o[:, c] - orf[:, c]) / sc
        q99_tol = 12e-2 if c == 8 else 6e-2
        assert np.quantile(err, 0.99) < q99_tol, (c, np.quantile(err, 0.99))
        assert err.mean() < 1.5e-2, (c, err.mean())
    sc9 = max(np.abs(orf[:, 9]).max(), 1e-3)
    assert (np.abs(o[:, 9] - orf[:, 9]) / sc9).mean() < 0.6
    np.testing.assert_allclose(v, vr, rtol=5e-2)
    sc = max(np.abs(gr).max(), 1e-3)
    gerr = np.abs(g - gr) / sc
    assert np.quantile(gerr, 0.99) < 0.15, np.quantile(gerr, 0.99)
    assert gerr.mean() < 3e-2, gerr.mean()
    assert np.mean((gr == 0.0) != (g == 0.0)) < 0.01
    assert np.abs(g).max() > 0.0


@pytest.mark.parametrize("use_sa", [False, True])
def test_plain_bf16_matches_jax_bf16(renders, use_sa):
    assert_bf16_bounds(renders["bf16", use_sa], renders["jax", use_sa])


@pytest.mark.parametrize("use_sa", [False, True])
def test_plain_bf16_tracks_f32(renders, use_sa):
    """The bounds the JAX package holds its bf16 path to against its
    float32 one, on the port's two paths; and bf16 really rounds."""
    assert_bf16_bounds(renders["bf16", use_sa], renders["f32", use_sa])
    assert not np.array_equal(renders["bf16", use_sa][1],
                              renders["f32", use_sa][1])


# ---------------------------------------------------------------------------
# the kernels' bf16 math (g++) against the plain chain


def wide_scene(seed, n, h=32, w=640, f=60.0):
    """Pair attributes of n random surfels on a h x w camera: pixel
    coordinates past 256 and 512, which bf16 rounds to even numbers and
    to multiples of 4."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 3.0, n)
    u, v = rng.uniform(0, w, n), rng.uniform(0, h, n)
    xyz = np.stack([(u - w / 2) * z / f, (v - h / 2) * z / f, z], -1)
    sc = rng.uniform(0.02, 0.12, (n, 2))
    q = rng.normal(size=(n, 4)) * 0.3
    q[:, 0] += 1.0
    op = rng.uniform(0.2, 0.99, n)
    col = rng.uniform(0, 1, (n, 3))
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    cam = TCam(h, w, f, f, w / 2, h / 2, torch.eye(4))
    pre = TP.preprocess(t(xyz), t(sc), t(q), t(op), cam)
    grid = TB.make_grid(cam, 16, 16)
    bins = TB.bin_gaussians(pre, grid, r_max=-(-n * 6 // 128) * 128,
                            max_tiles_per_gaussian=6)
    attrs_t = TP.pack_pair_attrs(pre, t(col)).T
    pattrs = attrs_t[bins.pair_gauss.long()].T.contiguous().numpy()
    return grid, bins.tile_start.numpy(), bins.tile_stop.numpy(), pattrs, rng


def assert_bf16_out_close(got, ref):
    bad = np.zeros(got.shape[:1] + got.shape[2:], bool)
    for c in (13, 14, 15):
        bad |= got[:, c] != ref[:, c]
    assert bad.mean() < 5e-3, bad.mean()
    for c in range(13):
        scale = max(np.abs(ref[:, c]).max(), 1e-3)
        err = np.abs(got[:, c] - ref[:, c])[~bad] / scale
        assert np.quantile(err, 0.99) <= (1e-2 if c == 9 else 1e-3), \
            (c, np.quantile(err, 0.99))
        assert err.mean() <= (1e-3 if c == 9 else 1e-4), (c, err.mean())


def assert_bf16_grad_close(got, ref):
    for c in range(21):
        norm = np.linalg.norm(ref[c])
        if norm == 0.0:
            assert np.abs(got[c]).max() == 0.0, c
            continue
        rel = np.linalg.norm(got[c] - ref[c]) / norm
        assert rel <= 5e-2, (c, rel)
    assert np.abs(got[21:]).max() == 0.0


SCENES = {"48x64": lambda: __import__("test_torch_raster").scene(2, 1300),
          "32x640": lambda: wide_scene(5, 1500)}


@pytest.mark.parametrize("scene_name", sorted(SCENES))
@pytest.mark.parametrize("use_sa,nn", [(True, False), (False, True)])
def test_kernel_math_bf16_matches_plain(host_math, host_math_no_skip,
                                        scene_name, use_sa, nn):
    """K1-BF16's out / stash / kexit and K2-BF16's gradient (the kernels'
    per-pixel math, g++) against the plain bf16 chain (torch.autograd for
    the gradient); the host math with every skip of the forward walk off
    must give the same bits."""
    grid, ts, te, pattrs, rng = SCENES[scene_name]()
    ids = np.arange(grid.num_tiles, dtype=np.int32)
    ts, te = ts.astype(np.int32), te.astype(np.int32)
    kw = dict(grid=TileGrid(*grid), use_sa=use_sa, need_normal=nn,
              tile_ids=torch.tensor(ids), compute_dtype="bf16")
    po, pst, pk = TRF.raster_forward_plain(
        torch.tensor(pattrs), torch.tensor(ts), torch.tensor(te), **kw)
    lib, lib_ns = _Bf16(host_math), _Bf16(host_math_no_skip)
    ho, hst, hk = host_forward(lib, pattrs, ts, te, ids, grid.tiles_x,
                               use_sa, nn)
    np.testing.assert_array_equal(hk, pk.numpy())
    assert_bf16_out_close(ho, po.numpy())
    assert float(po[:, 15].max()) == 1.0      # some pixels terminate
    d_out = rng.normal(size=ho.shape).astype(np.float32)
    d_out[:, 10:] = 0.0
    pg = TRB.raster_backward_stash_plain(
        torch.tensor(pattrs), torch.tensor(ts), torch.tensor(te),
        torch.tensor(hst), torch.tensor(hk), torch.tensor(ho),
        torch.tensor(d_out), **kw).numpy()
    hg = host_backward(lib, pattrs, ts, te, ids, grid.tiles_x, use_sa, nn,
                       hst, hk, ho, d_out)
    assert_bf16_grad_close(hg, pg)
    # the skips of the forward walk change no bit under BF16 either
    no = host_forward(lib_ns, pattrs, ts, te, ids, grid.tiles_x, use_sa, nn)
    for a, b in zip(no, (ho, hst, hk)):
        np.testing.assert_array_equal(np.ascontiguousarray(a).view(np.int32),
                                      np.ascontiguousarray(b).view(np.int32))
    g_ns = host_backward(lib_ns, pattrs, ts, te, ids, grid.tiles_x, use_sa,
                         nn, hst, hk, ho, d_out)
    np.testing.assert_array_equal(g_ns.view(np.int32), hg.view(np.int32))


def assert_grad_matches_f32_vjp(got, ref):
    """K2-bf16's gradient against the plain chain's float32 vjp on the
    same rounded values: q99 1e-4 and mean 1e-5 of the largest gradient,
    each row within relative L2 1e-2."""
    sc = max(np.abs(ref).max(), 1e-3)
    gerr = np.abs(got - ref) / sc
    assert np.quantile(gerr, 0.99) <= 1e-4, np.quantile(gerr, 0.99)
    assert gerr.mean() <= 1e-5, gerr.mean()
    for c in range(21):
        norm = np.linalg.norm(ref[c])
        if norm == 0.0:
            assert np.abs(got[c]).max() == 0.0, c
            continue
        rel = np.linalg.norm(got[c] - ref[c]) / norm
        assert rel <= 1e-2, (c, rel)


@pytest.mark.parametrize("scene_name", sorted(SCENES))
@pytest.mark.parametrize("use_sa,nn", [(True, False), (False, True)])
def test_kernel_grad_bf16_matches_f32_vjp(host_math, scene_name, use_sa,
                                          nn, monkeypatch):
    """K2-BF16's vjp (float32 arithmetic on the rounded forward values)
    against the plain chain differentiated the same way
    (raster_backward_stash_plain(f32_vjp=True)), whose forward values are
    those of the bf16 tensors bit for bit."""
    grid, ts, te, pattrs, rng = SCENES[scene_name]()
    ids = np.arange(grid.num_tiles, dtype=np.int32)
    ts, te = ts.astype(np.int32), te.astype(np.int32)
    kw = dict(grid=TileGrid(*grid), use_sa=use_sa, need_normal=nn,
              tile_ids=torch.tensor(ids), compute_dtype="bf16")
    args = [torch.tensor(a) for a in (pattrs, ts, te)]
    ref = TRF.raster_forward_plain(*args, **kw)
    chunk = TRF.composite_chunk
    monkeypatch.setattr(TRF, "composite_chunk",
                        lambda *a, **k: chunk(*a, f32_vjp=True, **k))
    for x, y in zip(TRF.raster_forward_plain(*args, **kw), ref):
        np.testing.assert_array_equal(x.numpy().view(np.int32),
                                      y.numpy().view(np.int32))
    lib = _Bf16(host_math)
    ho, hst, hk = host_forward(lib, pattrs, ts, te, ids, grid.tiles_x,
                               use_sa, nn)
    d_out = rng.normal(size=ho.shape).astype(np.float32)
    d_out[:, 10:] = 0.0
    vg = TRB.raster_backward_stash_plain(
        *args, torch.tensor(hst), torch.tensor(hk), torch.tensor(ho),
        torch.tensor(d_out), f32_vjp=True, **kw).numpy()
    hg = host_backward(lib, pattrs, ts, te, ids, grid.tiles_x, use_sa, nn,
                       hst, hk, ho, d_out)
    assert_grad_matches_f32_vjp(hg, vg)
    assert np.abs(hg[21:]).max() == 0.0


@pytest.mark.parametrize("hard", ["opaque", "degenerate"])
def test_bf16_skips_on_hard_scenes(host_math, host_math_no_skip, hard):
    """test_torch_raster_k1's opaque scene (nearly every pixel triggers
    with pairs of its block after it; under BF16 the walk goes on past
    the trigger, since bf16 rounding can let a later pair pass) and its
    degenerate one (p_z = 0, depth below NEAR_N, opacity below ALPHA_MIN,
    NaN in a ray row or the opacity): K1-BF16 and K2-BF16 with and
    without the forward walk's skips give the same bits, and the bf16
    cull drops no pair that passes the bf16 alpha test."""
    import test_torch_raster_k1 as K

    grid, ts, te, pattrs = (K.opaque_scene() if hard == "opaque"
                            else K.degenerate_scene())
    ids = np.arange(grid.num_tiles, dtype=np.int32)
    runs = [K.run_all(_Bf16(lib), pattrs, ts, te, ids, grid.tiles_x, True,
                      False) for lib in (host_math, host_math_no_skip)]
    K.assert_bit_equal(runs[0][:4], runs[1][:4])
    evals, culled, wrong, _ = cull_counts(_Bf16(host_math), grid, ts, te,
                                          pattrs)
    assert wrong == 0 and culled > 0.5 * evals
    if hard == "opaque":
        assert float(runs[0][0][:, 15].mean()) > 0.9       # done


@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_bf16_cull_is_conservative(host_math, scene_name):
    """The BF16 cull (the chain's own rounded rho2d and rho3d against the
    bf16 radius) rejects no (pair, pixel) that passes the chain's alpha
    test, and still rejects most of the walk."""
    grid, ts, te, pattrs, _ = SCENES[scene_name]()
    evals, culled, wrong, _ = cull_counts(_Bf16(host_math), grid, ts, te,
                                          pattrs)
    assert wrong == 0
    assert culled > 0.5 * evals, (culled, evals)


def test_host_bf16_round_is_torchs(host_math):
    """raster_common.cuh::bf16_round on the host against PyTorch's float
    -> bfloat16 conversion: ties, subnormals, overflow, inf and NaN."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, 200000, dtype=np.uint64).astype(np.uint32)
    x = bits.view(np.float32)
    ties = (rng.integers(0, 2**16, 1000).astype(np.uint32) << 16) | 0x8000
    edge = np.array([0.0, -0.0, np.inf, -np.inf, 3.3895314e38, 3.4e38,
                     1e-40, -1e-45, 1.0, 1.00390625, 1.01171875],
                    np.float32)
    x = np.concatenate([x, ties.view(np.float32), edge])
    got = np.zeros_like(x)
    host_math.host_bf16_round(_ptr(x), _ptr(got), x.size)
    want = torch.tensor(x).to(torch.bfloat16).float().numpy()
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))


def test_reference_backend_ignores_the_dtype():
    """The reference backend's compositor and K5 take no dtype, as in the
    JAX package: its render and gradient are the same bits under "bf16";
    only "f32" and "bf16" name a compute dtype."""
    from test_torch_raster import scene

    grid, ts, te, pattrs, rng = scene(1, 300)
    d_out = torch.tensor(rng.normal(size=(grid.num_tiles, 16, 256)),
                         dtype=torch.float32)
    res = []
    for cd in ("f32", "bf16"):
        a = torch.tensor(pattrs, requires_grad=True)
        out = render_pairs(a, torch.tensor(ts), torch.tensor(te), None,
                           RenderSettings(TileGrid(*grid), True, "reference",
                                          compute_dtype=cd))
        (g,) = torch.autograd.grad(torch.sum(out * d_out), a)
        res.append((out.detach(), g))
    assert torch.equal(res[0][0], res[1][0])
    assert torch.equal(res[0][1], res[1][1])
    with pytest.raises(ValueError):
        TRF.dtype_of("f16")


# ---------------------------------------------------------------------------
# the driver


def _bf16_config(lib, out, dtype):
    from test_torch_splatam import SYN, _load

    cfg = _load(SYN, dict(SYN_H="48", SYN_W="64", SYN_FRAMES="12"), lib)
    cfg["vis_base_dir"] = str(out)
    cfg.setdefault("tpu", {})["compute_dtype"] = dtype
    return cfg


@pytest.mark.slow
def test_bf16_driver_matches_jax(tmp_path):
    """configs/synthetic/config.py at 48x64 over 12 frames with
    tpu.compute_dtype = "bf16", in both packages (the JAX one under
    "interpret", which its config requires for bf16), and the JAX
    package's float32 run: the gap between its bf16 and f32 runs is what
    chip_smoke.py phase 11b moves test_full_slam's bounds by."""
    import json
    import sys

    from test_torch_splatam import REPO

    sys.path.insert(0, REPO)
    from gaus_slam_tpu_torch.scripts.gaus import rgbd_slam as t_slam
    from scripts.gaus import rgbd_slam as j_slam

    keys = ("ATE RMSE", "PSNR", "MS-SSIM", "Depth L1")
    jr = j_slam(_bf16_config("jax", tmp_path / "j", "bf16"),
                backend="interpret")
    j32 = j_slam(_bf16_config("jax", tmp_path / "j32", "f32"),
                 backend="interpret")
    tr = t_slam(_bf16_config("torch", tmp_path / "t", "bf16"),
                backend="interpret", device="cpu")
    print("bf16 driver 48x64 x 12: JAX bf16 " + json.dumps(
        {k: jr[k] for k in keys}) + "; JAX f32 " + json.dumps(
        {k: j32[k] for k in keys}) + "; port bf16 " + json.dumps(
        {k: tr[k] for k in keys}))
    for k in keys:
        assert np.isfinite(tr[k]), k
    assert abs(tr["ATE RMSE"] - jr["ATE RMSE"]) < 4e-3
    assert abs(tr["PSNR"] - jr["PSNR"]) < 1.0


@pytest.mark.slow
def test_full_width_render_matches_jax():
    """render_view at 340x600 of the synthetic scene's frame-0 map, 5 mm
    from frame 0's pose, in both packages and both dtypes: the port's
    plain bf16 chain within 2e-3 (q99) of the JAX one, including the
    rounding of pixel coordinates past 256 to even numbers and past 512
    to multiples of 4 that bf16 does in both; and where that rounding
    costs PSNR. Measured on the CPU: JAX bf16 loses 0.73 dB against f32
    on the pixels with x, y < 256 and 4.8 dB on the rest; the port's
    PSNRs within 0.02 dB of JAX's."""
    import jax.numpy as jnp

    from gaus_slam_tpu.data.synthetic import SyntheticDataset
    from gaus_slam_tpu.ops import binning as JB
    from gaus_slam_tpu.ops.camera import camera_from_intrinsics as j_cam
    from gaus_slam_tpu.ops.composite_ref import tiles_to_image as j_image
    from gaus_slam_tpu.render import RenderOptions as JOpts
    from gaus_slam_tpu.render import render_view as j_render
    from gaus_slam_tpu.slam.init_map import initialize_map
    from gaus_slam_tpu_torch import convert
    from gaus_slam_tpu_torch.ops.camera import camera_from_intrinsics
    from gaus_slam_tpu_torch.ops.composite_ref import tiles_to_image
    from gaus_slam_tpu_torch.render import RenderOptions, render_view

    h, w = 340, 600
    ds = SyntheticDataset(height=h, width=w, num_frames=30)
    color, depth, k, c2w = ds[0]
    jc = j_cam(h, w, k, np.eye(4))
    gm = initialize_map(1 << 18, jnp.asarray(color / 255.0, jnp.float32),
                        jnp.asarray(depth),
                        jnp.asarray(np.linalg.inv(c2w), jnp.float32), jc)
    moved = c2w.copy()
    moved[:3, 3] += (0.004, -0.003, 0.002)
    w2c = np.linalg.inv(moved).astype(np.float32)
    gt = color / 255.0
    yy, xx = np.mgrid[:h, :w]
    exact = (xx < 256) & (yy < 256)
    tgm = convert.gaussian_map_from_numpy(gm, "cpu")
    tc = camera_from_intrinsics(h, w, k, np.eye(4), device="cpu")
    jgrid = JB.make_grid(jc, 16, 16)
    tgrid = TB.make_grid(tc, 16, 16)

    def psnr(img, m):
        return float(-10 * np.log10(((np.clip(img, 0, 1) - gt)[m] ** 2)
                                    .mean()))

    res = {}
    for cd in ("f32", "bf16"):
        kw = dict(backend="interpret", pair_budget_factor=2.0,
                  max_tiles_per_gaussian=16, compute_dtype=cd)
        out = j_render(gm, jc.replace_w2c(jnp.asarray(w2c)),
                       JOpts(grid=jgrid, **kw))
        res["jax", cd] = np.asarray(j_image(out[:, 0:3], jgrid, h, w)) \
            .transpose(1, 2, 0)
        with torch.no_grad():
            out = render_view(tgm, tc.replace_w2c(torch.tensor(w2c)),
                              RenderOptions(grid=tgrid, **kw))
        res["port", cd] = tiles_to_image(out[:, 0:3], tgrid, h, w).numpy() \
            .transpose(1, 2, 0)
    d = np.abs(res["port", "bf16"] - res["jax", "bf16"])
    assert np.quantile(d, 0.99) < 2e-3 and d.mean() < 1e-3, \
        (np.quantile(d, 0.99), d.mean())
    p = {key: (psnr(img, exact), psnr(img, ~exact), psnr(img, exact | ~exact))
         for key, img in res.items()}
    print(f"340x600 render PSNR (x, y < 256 / rest / whole image): {p}")
    for cd in ("f32", "bf16"):
        np.testing.assert_allclose(p["port", cd], p["jax", cd], atol=0.05)
    # bf16 costs far more where it rounds the pixel coordinates
    loss = [p["jax", "f32"][i] - p["jax", "bf16"][i] for i in (0, 1, 2)]
    assert loss[1] > 2.0 and loss[1] > 3 * loss[0], loss
