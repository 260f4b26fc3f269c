"""The tracking render's per-pair preprocess (ops/track_preprocess.py):
the pair cache moved by the live pose into the pair attributes, and its
backward down to the pose gradient.

On the CPU: render_tracking's 2DGS path runs the chain it always ran, bit
for bit (all tiles, a head slice of a phase-major cache, a ``pre_w2c``
composition), and K8's closed form in PyTorch (``track_pose_grad_plain``)
equals autograd of the chain to 1e-5 relative (normwise: float32 sums of
the same terms in another order), on inputs with rows behind the near
plane, rows of zero ``distance`` and zero-opacity padding rows.

On a card (marked ``cuda``; this file imports no JAX): K7 against the
chain, K8 against autograd of the chain, K8 twice, a captured graph
replayed at a new pose, and the launches a captured tracking loop folds.

    python -m pytest --noconftest -m cuda -q tests/test_torch_track_preprocess.py
"""
import numpy as np
import pytest
import torch

from gaus_slam_tpu_torch import render as TR
from gaus_slam_tpu_torch.ops import binning as TB
from gaus_slam_tpu_torch.ops import track_preprocess as TP
from gaus_slam_tpu_torch.ops.camera import (camera_from_intrinsics,
                                            world_to_pix3)
from gaus_slam_tpu_torch.ops.preprocess import preprocess_t
from gaus_slam_tpu_torch.ops.se3 import (pose_matrix, quat_multiply,
                                         quat_multiply_rows, quat_normalize,
                                         quat_to_rotmat, rotmat_to_quat)
from gaus_slam_tpu_torch.slam.steps import _coarse_tile_ids

H, W, CAP = 48, 64, 4096
# a pose some 20 deg and 10 cm from the identity, and a frame-in-submap
# pose for the composition
QUAT = (0.97, 0.12, -0.17, 0.09)
TRANS = (0.06, -0.05, 0.08)
PRE = ((0.995, -0.0998, 0.0, 0.02), (0.0998, 0.995, 0.0, -0.01),
       (0.0, 0.0, 1.0, 0.03), (0.0, 0.0, 0.0, 1.0))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def scene(device):
    """(camera, options, phase-major pair cache at stride 2) of the
    synthetic scene's frame-0 map, binned at the identity."""
    from gaus_slam_tpu_torch.data.synthetic import SyntheticDataset
    from gaus_slam_tpu_torch.slam.init_map import initialize_map

    ds = SyntheticDataset(height=H, width=W, num_frames=4)
    cam = camera_from_intrinsics(H, W, ds.intrinsics, np.eye(4),
                                 device=device)
    color, depth = ds[0][0] / 255.0, ds[0][1]
    gm = initialize_map(
        CAP, torch.tensor(color.astype(np.float32), device=device),
        torch.tensor(np.asarray(depth, np.float32), device=device),
        torch.eye(4, device=device), cam)
    opts = TR.RenderOptions(grid=TB.make_grid(cam, 16, 16),
                            pair_budget_factor=1.35,
                            max_tiles_per_gaussian=4)
    with torch.no_grad():
        cache = TR.bin_for_tracking(gm, cam, opts, coarse_strides=(2,))
    return cam, opts, cache


def cam_eye(cam):
    return cam.replace_w2c(torch.eye(4, dtype=torch.float32,
                                     device=cam.w2c.device))


def pose(device, pre=None):
    """(quat, trans) leaves, and the composed w2c and detached rotation
    render_tracking forms from them."""
    quat = torch.tensor(QUAT, device=device, requires_grad=True)
    trans = torch.tensor(TRANS, device=device, requires_grad=True)
    w2c, q = pose_matrix(quat, trans), quat_normalize(quat)
    if pre is not None:
        w2c = pre @ w2c
        q = quat_multiply(rotmat_to_quat(pre[:3, :3])[None, :],
                          q[None, :])[0]
    return quat, trans, w2c, q


def chain(raw, w2c, q, cam, rows=False):
    """The chain render_tracking ran before it had K7: the means through
    ``w2c`` (a matrix product; ``rows``: three rows of elementwise sums in
    the order K7 adds them), the quaternions through ``q``, then
    preprocess_t at the identity camera."""
    if rows:
        xyz_cam = torch.stack([
            w2c[i, 0] * raw[0] + w2c[i, 1] * raw[1] + w2c[i, 2] * raw[2]
            + w2c[i, 3] for i in range(3)])
    else:
        xyz_cam = w2c[:3, :3] @ raw[0:3] + w2c[:3, 3][:, None]
    quats = quat_multiply_rows(q, raw[5:9]).detach()
    return preprocess_t(xyz_cam, raw[3:5], quats, raw[9], raw[10:13],
                        cam_eye(cam))[0]


def track_pose_grad_plain(raw_t, q, eye, d_attrs) -> torch.Tensor:
    """K8's closed form: d_w2c [4, 4] from the pair attributes' gradient
    ``d_attrs`` [>= 12, R]. Only hp = M [xyz_cam, 1] (the third component
    of tu, tv, tw) depends on the pose, so only the x, y components of
    d_a0, d_a1, d_a2 and d_tw's z carry its gradient."""
    M = world_to_pix3(eye)
    Rq = quat_to_rotmat(quat_multiply_rows(q, raw_t[5:9]).T)   # [R, 3, 3]
    Mr = M[:, :3]
    hu = (Rq[:, :, 0] * raw_t[3][:, None]) @ Mr.T              # [R, 3]
    hv = (Rq[:, :, 1] * raw_t[4][:, None]) @ Mr.T
    g = d_attrs
    d0 = (g[3] * hv[:, 2] - g[4] * hu[:, 2]) + (hu[:, 1] * g[7]
                                                - hv[:, 1] * g[6])
    d1 = (hu[:, 2] * g[1] - hv[:, 2] * g[0]) + (g[6] * hv[:, 0]
                                                - g[7] * hu[:, 0])
    d2 = g[11] + (hu[:, 0] * g[4] - hv[:, 0] * g[3]) + (g[0] * hv[:, 1]
                                                        - g[1] * hu[:, 1])
    d_xyz = Mr.T @ torch.stack([d0, d1, d2])                   # [3, R]
    xyz1 = torch.cat([raw_t[0:3], torch.ones_like(raw_t[0:1])])
    top = d_xyz @ xyz1.T                                       # [3, 4]
    return torch.cat([top, torch.zeros_like(top[:1])])


def with_invalid_rows(cache):
    """The cache's rows with some moved behind the camera, some put at
    the camera's centre with zero scales (zero ``distance``); the cache
    already ends in zero-opacity padding rows. For the identity-rotation
    pose ``rows_pose``."""
    raw = cache.raw_t.clone()
    r = raw.shape[1]
    raw[2, 1:r // 4:7] = -0.5                 # behind the camera
    z0 = torch.arange(2, r // 2, 11)
    raw[0:3, z0] = -torch.tensor(TRANS, device=raw.device)[:, None]
    raw[3:5, z0] = 0.0                        # tw = 0: distance 0
    return raw


def rows_pose(device):
    """An identity rotation: xyz_cam = xyz + t exactly, so the rows of
    ``with_invalid_rows`` land on the camera centre."""
    quat = torch.tensor((1.0, 0.0, 0.0, 0.0), device=device,
                        requires_grad=True)
    trans = torch.tensor(TRANS, device=device, requires_grad=True)
    return quat, trans, pose_matrix(quat, trans), quat_normalize(quat)


def rel(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


# ---------------------------------------------------------------------------
# on the CPU


@pytest.fixture(scope="module")
def cpu_scene():
    return scene("cpu")


@pytest.mark.parametrize("case", ["all tiles", "pair_hi", "pre_w2c"])
def test_render_tracking_runs_the_chain_bit_for_bit(cpu_scene, case,
                                                    monkeypatch):
    """The pair attributes render_tracking hands to render_pairs, and the
    pose gradient through them, equal the chain's."""
    cam, opts, cache = cpu_scene
    seen = []
    render_pairs = TR.render_pairs

    def spy(pattrs, *a, **kw):
        seen.append(pattrs)
        return render_pairs(pattrs, *a, **kw)

    monkeypatch.setattr(TR, "render_pairs", spy)
    pre = torch.tensor(PRE) if case == "pre_w2c" else None
    hi = (TR.track_coarse_budget(cache.raw_t.shape[1], 2)
          if case == "pair_hi" else None)
    ids = _coarse_tile_ids(opts.grid, 2, "cpu") if hi else None
    quat, trans, w2c, q = pose("cpu", pre)
    TR.render_tracking(cache, quat, trans, cam, opts, tile_ids=ids,
                       pair_hi=hi, pre_w2c=pre)
    raw = cache.raw_t if hi is None else cache.raw_t[:, :hi]
    want = chain(raw, w2c, q, cam)
    [got] = seen
    assert torch.equal(got, want)
    d = torch.randn(got.shape, generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b) for a, b in zip(
        torch.autograd.grad(got, (quat, trans), d, retain_graph=True),
        torch.autograd.grad(want, (quat, trans), d)))


@pytest.mark.parametrize("case", ["pose", "pose pre_w2c", "invalid rows"])
def test_pose_grad_closed_form_matches_autograd(cpu_scene, case):
    """K8's closed form against autograd of the chain: d_w2c, and d_quat /
    d_trans through pose_matrix (and the composition)."""
    cam, _, cache = cpu_scene
    pre = torch.tensor(PRE) if case == "pose pre_w2c" else None
    if case == "invalid rows":
        raw = with_invalid_rows(cache)
        quat, trans, w2c, q = rows_pose("cpu")
    else:
        raw = cache.raw_t
        quat, trans, w2c, q = pose("cpu", pre)
    attrs = chain(raw, w2c, q, cam)
    if case == "invalid rows":
        # rows behind the near plane, of zero distance, of no opacity
        tw = attrs[9:12]
        dist = 9.0 * (tw[0] ** 2 + tw[1] ** 2) - tw[2] ** 2
        assert (dist == 0).sum() > 10
        assert ((raw[2] + TRANS[2] <= 0.2) & (dist != 0)).sum() > 10
        assert (raw[9] == 0).sum() > 10
    d = torch.randn(attrs.shape, generator=torch.Generator().manual_seed(2))
    want_w2c, want_q, want_t = torch.autograd.grad(
        attrs, (w2c, quat, trans), d, retain_graph=True)
    got_w2c = track_pose_grad_plain(raw, q.detach(), cam_eye(cam), d)
    assert rel(got_w2c, want_w2c) < 1e-5
    got_q, got_t = torch.autograd.grad(w2c, (quat, trans), got_w2c)
    assert rel(got_q, want_q) < 1e-5
    assert rel(got_t, want_t) < 1e-5


def test_closed_form_reads_only_the_pose_rows(cpu_scene):
    """Rows of d_attrs other than a0..a2's x and y and tw's z carry no
    pose gradient through the chain."""
    cam, _, cache = cpu_scene
    quat, trans, w2c, q = pose("cpu")
    attrs = chain(cache.raw_t, w2c, q, cam)
    d = torch.randn(attrs.shape, generator=torch.Generator().manual_seed(3))
    d[[0, 1, 3, 4, 6, 7, 11]] = 0.0
    (g,) = torch.autograd.grad(attrs, (w2c,), d)
    assert float(g.abs().max()) == 0.0
    got = track_pose_grad_plain(cache.raw_t, q.detach(), cam_eye(cam), d)
    assert float(got.abs().max()) == 0.0


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture(scope="module")
def cuda_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K7 and K8 run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return scene("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pose", "pre_w2c", "pair_hi",
                                  "invalid rows"])
def test_cuda_k7_matches_the_chain(cuda_scene, case):
    """K7 equals the chain bit for bit where the chain moves the means by
    elementwise sums in K7's order (the operations are the same under
    -fmad=false). Against the chain's matrix product (cuBLAS: its own sum
    order and contractions, an ulp or two of xyz_cam) the rows that do
    not read xyz_cam are bit-equal, the mask agrees, and a0..a2 and tw
    are within 1e-5 of each row's largest magnitude (products of xyz_cam
    with bounded factors); cx, cy (divided by distance) are held to
    1e-4 of their scale where distance is not below 1e-3 of its own."""
    cam, _, cache = cuda_scene
    raw = cache.raw_t
    if case == "invalid rows":
        raw = with_invalid_rows(cache)
        _, _, w2c, q = rows_pose("cuda")
    else:
        _, _, w2c, q = pose("cuda", torch.tensor(PRE, device="cuda")
                            if case == "pre_w2c" else None)
    if case == "pair_hi":
        raw = raw[:, :TR.track_coarse_budget(raw.shape[1], 2)]
    with torch.no_grad():
        got = TP.track_preprocess(raw, w2c, q, cam_eye(cam))
        exact = chain(raw, w2c, q, cam, rows=True)
        mm = chain(raw, w2c, q, cam)
    assert torch.equal(got, exact)
    for c in (14, 15, 16, 18, 19, 20, 21, 22, 23):
        assert torch.equal(got[c], mm[c]), c
    assert torch.equal(got[17] == 0, mm[17] == 0)
    for c in range(12):
        scale = float(mm[c].abs().max())
        assert float((got[c] - mm[c]).abs().max()) <= 1e-5 * scale, c
    tw = mm[9:12]
    dist = (9.0 * (tw[0] ** 2 + tw[1] ** 2) - tw[2] ** 2).abs()
    far = dist >= 1e-3 * float(dist.max())
    for c in (12, 13):
        scale = float(mm[c][far].abs().max())
        assert float((got[c] - mm[c])[far].abs().max()) <= 1e-4 * scale, c


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pose", "pre_w2c", "pair_hi",
                                  "invalid rows"])
def test_cuda_k8_matches_autograd_and_repeats(cuda_scene, case):
    """K8's d_w2c against autograd of the chain (1e-5 relative, normwise:
    the same float32 terms summed in another order), and the pose's
    gradient through pose_matrix; a second launch gives the same bits."""
    from gaus_slam_tpu_torch.ops import _cuda

    cam, _, cache = cuda_scene
    raw = cache.raw_t
    if case == "invalid rows":
        raw = with_invalid_rows(cache)
        quat, trans, w2c, q = rows_pose("cuda")
    else:
        quat, trans, w2c, q = pose("cuda", torch.tensor(PRE, device="cuda")
                                   if case == "pre_w2c" else None)
    if case == "pair_hi":
        raw = raw[:, :TR.track_coarse_budget(raw.shape[1], 2)]
    d = torch.randn((24, raw.shape[1]),
                    generator=torch.Generator().manual_seed(4)).cuda()
    want = torch.autograd.grad(chain(raw, w2c, q, cam), (w2c, quat, trans),
                               d, retain_graph=True)
    n0 = _cuda.LAUNCHES["track_preprocess_backward"]
    got = [torch.autograd.grad(TP.track_preprocess(raw, w2c, q, cam_eye(cam)),
                               (w2c, quat, trans), d, retain_graph=True)
           for _ in range(2)]
    assert _cuda.LAUNCHES["track_preprocess_backward"] == n0 + 2
    for g, wv in zip(got[0], want):
        assert rel(g, wv) < 1e-5
    for a, b in zip(*got):
        assert torch.equal(a, b)
    assert torch.equal(got[0][0][3], torch.zeros(4, device="cuda"))


@pytest.mark.cuda
def test_cuda_graph_replay_reads_the_new_pose(cuda_scene):
    """K7 and K8 captured in one CUDA graph read the pose from device
    memory: a replay after the pose tensors change gives that pose's
    attributes and gradient, as an eager call does."""
    cam, _, cache = cuda_scene
    quat = torch.tensor(QUAT, device="cuda")
    trans = torch.tensor(TRANS, device="cuda")
    d = torch.randn((24, cache.raw_t.shape[1]),
                    generator=torch.Generator().manual_seed(5)).cuda()
    eye = cam_eye(cam)

    def step():
        qq = quat.detach().requires_grad_()
        tt = trans.detach().requires_grad_()
        attrs = TP.track_preprocess(cache.raw_t, pose_matrix(qq, tt),
                                    quat_normalize(qq), eye)
        return (attrs,) + torch.autograd.grad(attrs, (qq, tt), d)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    quat.copy_(torch.tensor((0.9, -0.2, 0.1, 0.3), device="cuda"))
    trans.copy_(torch.tensor((-0.1, 0.02, 0.2), device="cuda"))
    graph.replay()
    torch.cuda.synchronize()
    want = step()
    assert not torch.equal(want[0], chain(
        cache.raw_t, pose_matrix(torch.tensor(QUAT, device="cuda"),
                                 torch.tensor(TRANS, device="cuda")),
        quat_normalize(torch.tensor(QUAT, device="cuda")), cam, rows=True))
    for a, b in zip(out, want):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def steps_scene():
    """tests/test_torch_programs_cuda.py's scene on the card, through the
    kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: steps are captured only there")
    from test_torch_programs_cuda import port_scene, synthetic_scene

    sc = synthetic_scene()
    sc["kw"] = dict(sc["kw"], backend="pallas")
    return port_scene(sc, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("view", [False, True])
def test_cuda_loop_program_launches_k7_k8_per_iteration(steps_scene, view):
    """A captured tracking loop (WHILE nodes, a stride-2 level and the
    full-resolution one): the folded launches hold one K7 and one K8 per
    iteration that ran, and one more K7 for the tail's view."""
    from gaus_slam_tpu_torch.ops import _cuda
    from gaus_slam_tpu_torch.slam import programs
    from test_torch_programs_cuda import loop_run

    own = programs.Owner("k7k8")
    loop_run(steps_scene, None, view, own)
    _cuda.clear_launches()
    got = loop_run(steps_scene, None, view, own)
    counts = _cuda.fold_launches()
    iters = int(got[1]["iters"])
    assert iters > 0
    assert counts["raster_forward_stash"] == iters
    assert counts["track_preprocess"] == iters + (1 if view else 0)
    assert counts["track_preprocess_backward"] == iters


@pytest.mark.cuda
def test_cuda_backend_tracking_steps_launch_k7_k8(steps_scene):
    """Each captured backend tracking step (the pose composed with the
    frame's ``pre_w2c``) runs one K7 and one K8."""
    from gaus_slam_tpu_torch.ops import _cuda
    from gaus_slam_tpu_torch.slam import programs
    from test_torch_programs_cuda import _back_track

    own = programs.Owner("k7k8-back")
    _back_track(steps_scene, own, 1)
    _cuda.clear_launches()
    _back_track(steps_scene, own, 3)
    counts = _cuda.fold_launches()
    assert counts["track_preprocess"] == 3
    assert counts["track_preprocess_backward"] == 3
