"""The oriented BEV IoU kernel (csrc/iou.cu, ops/cuda/iou.py) against the
plain chain (ops/plain/iou.py), the op tpu3dsad_torch::oriented_bev_iou
that dispatches between them (ops/library.py) and ops/boxes.py's
oriented_bev_iou that flattens its callers' leading dims into the op's
batch:

  * on the CPU, the op and boxes.oriented_bev_iou run the plain chain,
    bitwise as it is called directly and with no launch; the op's fake
    version gives [B, K, L] and checks its arguments (opcheck in
    tests/test_torch_serving.py); torch.export traces
    oriented NMS with one oriented_bev_iou node and no step of the chain;
    the wrapper refuses K or L past MAX_K (tests/test_torch_outdoor_train.py
    holds the chain on the CPU to the JAX package's);
  * on the card (`card` tests, skipped without one), the kernel on the
    cases below at B in {1, 8}, K = L in {24, 256, 1024}: exactly 0.0
    wherever the two footprints' bounds lie apart, within 1e-6 of the
    plain chain on the card on every pair whose footprints are both at
    least 0.1 m across, slivers (a side under 0.1 m) listed and not held,
    and keep through nms_oriented equal to the plain path's; the counters;
    the C entry's refusal past 1024; the served program of
    sadet-kitti-16k replayed from a CUDA graph bitwise its eager call; an
    exported oriented NMS with one oriented_bev_iou node.

The cases: random rotated boxes; the class-shifted corners nms_oriented
builds (KITTI's range, x out to ~200 m); identical, nested, right-angle
turned, touching and disjoint boxes; NaN and infinite corners; slivers at
the decoder's 1e-4 m size floor.

This file imports no JAX, so on the card it runs alone:
    python -m pytest tests/test_torch_iou_kernel.py --noconftest -m card
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

from test_torch_nms_kernel import benchmark_config  # noqa: E402
from tpu3dsad_torch import ops, serving, train_lib  # noqa: E402
from tpu3dsad_torch.config import Config  # noqa: E402
from tpu3dsad_torch.models.detector import SizeAdaptiveDetector  # noqa: E402
from tpu3dsad_torch.ops import boxes, library, nms  # noqa: E402
from tpu3dsad_torch.ops.cuda import build  # noqa: E402
from tpu3dsad_torch.ops.cuda import iou as cuda_iou  # noqa: E402
from tpu3dsad_torch.ops.cuda import nms as cuda_nms  # noqa: E402
from tpu3dsad_torch.ops.plain import oriented_bev_iou as plain_chain  # noqa: E402

CASES = ["random", "shifted", "identical", "nested", "turned", "touching",
         "disjoint", "nan", "slivers"]
SIZES = [(1, 24), (8, 24), (1, 256), (8, 256), (1, 1024), (8, 1024)]
WIDE = 0.1  # m: a footprint side from which the IoU is held to the chain
FLOOR = 1e-4  # m: the decoder's size floor


def shift_by_class(c: torch.Tensor, sem: torch.Tensor) -> torch.Tensor:
    """The class shift of nms_oriented: x moved by class x span."""
    span = c[..., 0].max() - c[..., 0].min() + 1.0
    shift = sem.to(c.dtype) * span
    return torch.cat([c[..., :1] + shift[..., None, None], c[..., 1:]], -1)


def make_pair(name: str, b: int, k: int, seed: int = 0):
    """(corners_a, corners_b) [b, k, 8, 3] fp32 on the CPU."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    kitti = name in ("shifted", "slivers")
    spread = 0.8 * np.sqrt(k)  # dense: many pairs overlap

    def draw():
        if kitti:  # KITTI's range, as the cell decodes into it
            lo, hi = [0.0, -40.0, -3.0], [70.4, 40.0, 1.0]
        else:
            lo, hi = [-spread, -spread, -1.0], [spread, spread, 1.0]
        return (rng.uniform(lo, hi, (b, k, 3)), rng.uniform(0.3, 4.5,
                                                            (b, k, 3)),
                rng.uniform(-np.pi, np.pi, (b, k)))

    center, size, heading = draw()
    a = boxes.box_corners(t(center), t(size), t(heading))
    if name == "random":
        return a, boxes.box_corners(*map(t, draw()))
    if name in ("identical", "nan"):
        if name == "nan":
            a = a.clone()
            flat = a.view(-1)
            pick = rng.choice(flat.numel(), max(2, flat.numel() // 200),
                              replace=False)
            flat[pick] = t(rng.choice([np.nan, np.inf, -np.inf], len(pick)))
        return a, a
    if name == "nested":
        return a, boxes.box_corners(t(center), t(0.5 * size), t(heading))
    if name == "turned":
        turn = (np.pi / 2) * rng.integers(1, 4, (b, k))
        return a, boxes.box_corners(t(center), t(size), t(heading + turn))
    if name == "touching":  # b's -x face on a's +x face
        step = np.stack([np.cos(heading), np.sin(heading),
                         np.zeros_like(heading)], -1) * size[..., :1]
        return a, boxes.box_corners(t(center + step), t(size), t(heading))
    if name == "disjoint":
        return a, boxes.box_corners(t(center + [100.0, 100.0, 0.0]),
                                    t(size), t(heading))
    sem = t(rng.integers(0, 3, (b, k)))
    if name == "slivers":
        thin = rng.random((b, k)) < 0.3
        size[thin, rng.integers(0, 2)] = FLOOR
        a = boxes.box_corners(t(center), t(size), t(heading))
    a = shift_by_class(a, sem)
    return a, a


def footprints(c: torch.Tensor):
    """(bounds [B, K, 4]: x lo, x hi, y lo, y hi of the top face, NaN
    unless finite; the shorter side of the top face [B, K])."""
    top = c[..., :4, :2]
    bounds = torch.stack([top[..., 0].amin(-1), top[..., 0].amax(-1),
                          top[..., 1].amin(-1), top[..., 1].amax(-1)], -1)
    finite = torch.isfinite(top).flatten(-2).all(-1)
    bounds = torch.where(finite[..., None], bounds, torch.nan)
    side = (top[..., 1:3, :] - top[..., 0:2, :]).norm(dim=-1).amin(-1)
    return bounds, side


def apart(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, K, L]: the footprints' bounds strictly apart (NaN: not)."""
    fa, _ = footprints(a)
    fb, _ = footprints(b)
    fa, fb = fa[:, :, None], fb[:, None, :]
    return ((fa[..., 1] < fb[..., 0]) | (fb[..., 1] < fa[..., 0])
            | (fa[..., 3] < fb[..., 2]) | (fb[..., 3] < fa[..., 2]))


def wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, K, L]: both footprints at least WIDE across."""
    _, sa = footprints(a)
    _, sb = footprints(b)
    return (sa >= WIDE)[:, :, None] & (sb >= WIDE)[:, None, :]


# ------------------------------------------------------------- the CPU


@pytest.mark.parametrize("case", CASES)
def test_cpu_op_runs_the_plain_chain(case):
    a, b = make_pair(case, 2, 24)
    want = plain_chain(a, b)
    before = cuda_iou.launches
    got = library.oriented_bev_iou(a, b)
    assert got.dtype == torch.float32 and got.shape == (2, 24, 24)
    assert torch.equal(got, want)  # an IoU is never NaN: NaN reads 0
    assert torch.equal(boxes.oriented_bev_iou(a, b), want)
    assert cuda_iou.launches == before
    if case == "disjoint":
        assert not got.any()
    if case in ("random", "identical", "nested", "turned", "shifted"):
        assert got.any()


@pytest.mark.parametrize("lead_a,lead_b", [((), ()), ((3,), (1,)),
                                           ((2, 2), (2, 1))],
                         ids=["none", "broadcast", "two_dims"])
def test_boxes_iou_flattens_leading_dims(lead_a, lead_b):
    """boxes.oriented_bev_iou broadcasts and flattens its leading dims
    into the op's batch: bitwise the chain on the unflattened corners."""
    a, b = make_pair("random", 1, 6)
    ca = a[0].expand(*lead_a, 6, 8, 3)
    cb = b[0, :5].expand(*lead_b, 5, 8, 3)
    got = boxes.oriented_bev_iou(ca, cb)
    want = plain_chain(ca, cb)
    assert got.shape == want.shape == torch.broadcast_shapes(
        ca.shape[:-3], cb.shape[:-3]) + (6, 5)
    assert torch.equal(got, want)


def test_fake_gives_the_iou_shape():
    with FakeTensorMode():
        iou = library.oriented_bev_iou(torch.empty(3, 7, 8, 3),
                                       torch.empty(3, 5, 8, 3))
        assert iou.shape == (3, 7, 5) and iou.dtype == torch.float32


@pytest.mark.parametrize("shapes,dtype,error", [
    (((3, 7, 8), (3, 5, 8, 3)), torch.float32, ValueError),   # a's rank
    (((3, 7, 4, 3), (3, 5, 8, 3)), torch.float32, ValueError),  # 4 corners
    (((3, 7, 8, 3), (3, 5, 8, 2)), torch.float32, ValueError),  # b's xy
    (((3, 7, 8, 3), (2, 5, 8, 3)), torch.float32, ValueError),  # batch
    (((3, 7, 8, 3), (3, 5, 8, 3)), torch.int32, TypeError),     # integers
], ids=["a_rank", "a_corners", "b_coords", "batch", "dtype"])
def test_fake_checks_arguments(shapes, dtype, error):
    with FakeTensorMode():
        a, b = (torch.empty(s, dtype=dtype) for s in shapes)
        with pytest.raises(error):
            library.oriented_bev_iou(a, b)


class OrientedNMS(torch.nn.Module):
    def forward(self, corners, scores, valid, sem):
        return nms.nms_oriented(corners, scores, valid, 0.25, sem_cls=sem)


def nms_args(c: torch.Tensor, seed: int = 0):
    """(corners, scores, valid, sem) for nms_oriented over c [B, K, 8, 3]."""
    g = torch.Generator().manual_seed(seed)
    B, K = c.shape[:2]
    scores = torch.rand(B, K, generator=g)
    valid = torch.rand(B, K, generator=g) < 0.9
    sem = torch.randint(0, 3, (B, K), generator=g)
    return c, scores, valid, sem


def test_export_holds_one_iou_node():
    """torch.export traces oriented NMS with one oriented_bev_iou node
    beside the walk's one node: no clip step (its cumsum, gather, scatter)
    unrolled; the exported program's keep is the eager one's."""
    a, _ = make_pair("random", 2, 24)
    args = nms_args(a)
    program = torch.export.export(OrientedNMS(), args)
    calls = Counter(str(node.target) for node in program.graph.nodes
                    if node.op == "call_function")
    assert calls["tpu3dsad_torch.oriented_bev_iou.default"] == 1
    assert calls["tpu3dsad_torch.greedy_suppress.default"] == 1
    for unrolled in ("aten.cumsum.default", "aten.gather.default",
                     "aten.scatter.src", "aten.remainder.Scalar"):
        assert calls[unrolled] == 0, unrolled
    assert torch.equal(program.module()(*args), OrientedNMS()(*args))


@pytest.mark.parametrize("side", ["K", "L"])
def test_wrapper_refuses_past_the_cap(side):
    big = cuda_iou.MAX_K + 1
    a = torch.zeros(1, big if side == "K" else 4, 8, 3)
    b = torch.zeros(1, big if side == "L" else 4, 8, 3)
    before = cuda_iou.launches
    with pytest.raises(ValueError, match="MAX_K"):
        cuda_iou.oriented_bev_iou(a, b)
    assert cuda_iou.launches == before


# ------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def plain_on(*args):
    with ops.use_impl("plain"):
        return library.oriented_bev_iou(*args)


@pytest.mark.card
@pytest.mark.parametrize("b,k", SIZES, ids=[f"B{b}-K{k}" for b, k in SIZES])
@pytest.mark.parametrize("case", CASES)
def test_kernel_equals_plain_chain(card, case, b, k):
    a, o = (c.to(card) for c in make_pair(case, b, k, seed=k + b))
    before = cuda_iou.launches
    got = library.oriented_bev_iou(a, o)
    assert cuda_iou.launches == before + 1
    want = plain_on(a, o)
    off = apart(a, o)
    held = wide(a, o)
    assert torch.equal(got[off], torch.zeros_like(got[off]))
    gap = (got - want).abs()
    assert gap[held].max().item() <= 1e-6 if held.any() else True
    thin = ~held & ~off
    print(f"{case} B{b} K{k}: apart {int(off.sum())}, held {int(held.sum())}"
          f", bitwise {int((got == want).sum())} of {got.numel()}; slivers "
          f"{int(thin.sum())}, widest gap there "
          f"{gap[thin].nan_to_num().max().item() if thin.any() else 0.0}")
    if case in ("random", "identical", "nested", "turned", "shifted"):
        assert (got[held] > 0).any()
    if case == "identical":
        diag = torch.diagonal(got, dim1=1, dim2=2)
        assert (diag - 1.0).abs().max().item() < 1e-5

    half = k // 2
    corners = torch.cat([a[:, :half], o[:, :half]], 1)
    args = [x.to(card) for x in nms_args(corners.cpu(), seed=k)]
    keep = nms.nms_oriented(*args[:3], 0.25, sem_cls=args[3])
    with ops.use_impl("plain"):
        want_keep = nms.nms_oriented(*args[:3], 0.25, sem_cls=args[3])
    assert torch.equal(keep, want_keep)


@pytest.mark.card
def test_counters(card):
    a, o = (c.to(card) for c in make_pair("shifted", 8, 256))
    cuda_iou.reset()
    library.oriented_bev_iou(a, o)
    library.oriented_bev_iou(a, o)
    assert cuda_iou.launches == 2
    cuda_iou.reset()
    assert cuda_iou.launches == 0


@pytest.mark.card
def test_c_entry_refuses_past_the_cap(card):
    k = cuda_iou.MAX_K + 1
    a = torch.zeros(1, k, 8, 3, device=card)
    iou = torch.empty(1, k, k, device=card)
    err = build.library().tpu3dsad_oriented_iou(
        a.data_ptr(), a.data_ptr(), iou.data_ptr(), 1, k, k,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="tpu3dsad_oriented_iou"):
        build.check(err, "tpu3dsad_oriented_iou")


@pytest.mark.card
def test_export_on_the_card_holds_one_iou_node(card):
    a, _ = make_pair("shifted", 8, 256)
    args = [x.to(card) for x in nms_args(a)]
    program = torch.export.export(OrientedNMS(), tuple(args))
    calls = Counter(str(node.target) for node in program.graph.nodes
                    if node.op == "call_function")
    assert calls["tpu3dsad_torch.oriented_bev_iou.default"] == 1
    before = cuda_iou.launches
    keep = program.module()(*args)
    assert cuda_iou.launches == before + 1
    assert torch.equal(keep, OrientedNMS()(*args))


@pytest.mark.card
def test_kitti_served_program_eager_and_replayed(card, monkeypatch):
    """The served program of sadet-kitti-16k (oriented NMS) at its cell's
    batch of 8 x 16384 points: the IoU's inputs recorded in an eager call
    (each row in its box's frame: 8 x 256 one-row clouds against their 256
    boxes) and the kernel held to the plain chain on them; then the program
    captured as one CUDA graph (one IoU launch at the capture, none at a
    replay) and replayed on two batches, every output bitwise the eager
    call's."""
    cfg = benchmark_config("sadet-kitti-16k")
    train_lib.apply_runtime_config(cfg)
    try:
        B, n = 8, cfg.data.num_points
        model = SizeAdaptiveDetector(
            cfg.model, device=card, generator=torch.Generator().manual_seed(7))
        gen = torch.Generator(device=card).manual_seed(8)
        scale = torch.tensor([70.4, 80.0, 4.0], device=card)
        shift = torch.tensor([0.0, -40.0, -3.0], device=card)
        batches = []
        for _ in range(2):
            pts = torch.rand(B, n, 3, device=card, generator=gen) * scale \
                + shift
            mask = torch.ones(B, n, dtype=torch.bool, device=card)
            mask[:, n - n // 40:] = False
            batches.append((pts, mask))
        with torch.no_grad():
            model.train()
            model(batches[0][0], mask=batches[0][1], bn_momentum=0.0)
        infer = serving.build_inference_fn(cfg, model, model.mean_sizes)

        seen = []
        op = library.oriented_bev_iou

        def record(*args):
            seen.append([a.clone() for a in args])
            return op(*args)

        monkeypatch.setattr(library, "oriented_bev_iou", record)
        eager = [{k: v.clone() for k, v in infer(*batch).items()}
                 for batch in batches]
        monkeypatch.undo()
        assert len(seen) == 2 and seen[0][0].shape == (B * 256, 1, 8, 3)
        assert seen[0][1].shape == (B * 256, 256, 8, 3)
        for a, o in seen:
            got, want = op(a, o), plain_on(a, o)
            assert torch.equal(got[apart(a, o)], torch.zeros_like(
                got[apart(a, o)]))
            held = wide(a, o)
            assert (got - want).abs()[held].max().item() <= 1e-6
            print(f"served IoU: clipped {int((~apart(a, o)).sum())} of "
                  f"{got.numel()}, bitwise {int((got == want).sum())}")

        static = [t.clone() for t in batches[0]]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            infer(*static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = (cuda_iou.launches, cuda_nms.launches)
        with torch.cuda.graph(graph):
            out = infer(*static)
        assert (cuda_iou.launches, cuda_nms.launches) == (before[0] + 1,
                                                          before[1] + 1)
        for batch, want in zip(batches, eager):
            for s, t in zip(static, batch):
                s.copy_(t)
            graph.replay()
            torch.cuda.synchronize()
            for key, value in want.items():
                assert torch.equal(out[key], value), key
        assert (cuda_iou.launches, cuda_nms.launches) == (before[0] + 1,
                                                          before[1] + 1)
    finally:
        train_lib.apply_runtime_config(Config())
