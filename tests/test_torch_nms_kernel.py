"""The greedy NMS walk kernel (csrc/nms.cu, ops/cuda/nms.py) against the
plain loop (ops/plain/nms.py), whose keep it must equal bit for bit:

  * on the CPU, the plain loop compares the threshold in fp32, the custom
    op's fake version gives [B, K] bool and checks its arguments, and a
    CPU call runs the plain loop (tests/test_torch_detector.py holds the
    op on the CPU to the JAX package's walk on the cases below);
  * on the card (`card` tests, skipped without one), the kernel's keep
    equals the plain loop's on the same cases, in every NMS flavour, and
    in the served program at both benchmark configurations' shapes, eager
    and replayed from a CUDA graph; the wrapper counts one launch a call
    and K above MAX_K raises.

The cases: B in {1, 32}, K in {40, 256, 1024}; IoU of random boxes at the
thresholds 0.02, 0.25 and 0.99, IoU exactly at the fp32-rounded threshold
and one ulp either side, NaN IoU; tied scores, no candidate valid, none
suppressed, one box repeated K times, NaN and signed-zero scores.

This file imports no JAX, so on the card it runs alone:
    python -m pytest tests/test_torch_nms_kernel.py --noconftest -m card
"""

import json
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

from tpu3dsad_torch import ops, serving, train_lib
from tpu3dsad_torch.config import Config
from tpu3dsad_torch.models.detector import SizeAdaptiveDetector
from tpu3dsad_torch.ops import boxes, library, nms
from tpu3dsad_torch.ops.cuda import nms as cuda_nms
from tpu3dsad_torch.ops.plain import greedy_suppress as plain_walk

ROOT = Path(__file__).resolve().parents[1]
SIZES = [(1, 40), (32, 40), (1, 256), (32, 256), (1, 1024), (32, 1024)]
THRESHOLDS = [0.02, 0.25, 0.99]
BY_THRESHOLD = ["random", "at_threshold", "nan_iou"]
AT_025 = ["ties", "all_invalid", "none_suppressed", "repeated",
          "nan_scores", "signed_zero"]
CASES = ([(c, t) for c in BY_THRESHOLD for t in THRESHOLDS]
         + [(c, 0.25) for c in AT_025])


def random_iou(rng, b, k):
    """IoU of random axis-aligned boxes of 0.2-1.5 m in a 2 m cube, where
    many pairs overlap."""
    lo = rng.uniform(-1, 1, (b, k, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.2, 1.5, (b, k, 3)).astype(np.float32)
    return boxes.aabb_iou_3d(*map(torch.from_numpy, (lo, hi, lo, hi))).numpy()


def make_case(name, b, k, thresh, seed=0):
    """(iou [b,k,k] f32, scores [b,k] f32, valid [b,k] bool), numpy."""
    rng = np.random.default_rng(seed)
    iou = random_iou(rng, b, k)
    scores = rng.choice([0.1, 0.4, 0.7, 0.9], (b, k)).astype(np.float32)
    valid = rng.random((b, k)) < 0.8
    t = np.float32(thresh)
    if name == "ties":
        scores[:] = 0.5
    elif name == "all_invalid":
        valid[:] = False
    elif name == "none_suppressed":
        iou = np.where(np.eye(k, dtype=bool), iou, 0.0).astype(np.float32)
    elif name == "repeated":
        iou = np.ones((b, k, k), np.float32)
    elif name == "at_threshold":
        near = np.array([np.nextafter(t, np.float32(0)), t,
                         np.nextafter(t, np.float32(1))], np.float32)
        iou = rng.choice(near, (b, k, k))
    elif name == "nan_iou":
        iou[rng.random((b, k, k)) < 0.2] = np.nan
    elif name == "nan_scores":
        scores[rng.random((b, k)) < 0.2] = np.nan
        scores[rng.random((b, k)) < 0.1] = -np.inf
    elif name == "signed_zero":
        scores = rng.choice(np.array([0.0, -0.0, 0.3], np.float32), (b, k))
    return iou, scores, valid


def case_id(case):
    return f"{case[0]}-{case[1]}"


def torch_case(name, b, k, thresh, device="cpu"):
    return tuple(torch.from_numpy(a).to(device)
                 for a in make_case(name, b, k, thresh))


def test_threshold_is_compared_in_fp32():
    """0.1 rounds up in fp32: an IoU of fp32(0.1) is not above it, though
    it is above the double 0.1; the plain loop (and so the kernel) takes
    the fp32 side."""
    t = 0.1
    iou = torch.full((1, 2, 2), np.float32(t))
    scores = torch.tensor([[0.9, 0.5]])
    valid = torch.ones(1, 2, dtype=torch.bool)
    assert float(np.float32(t)) > t
    assert plain_walk(iou, scores, valid, t).tolist() == [[True, True]]


# ------------------------------------------------------ the op's fake


def test_fake_gives_bool_keep():
    with FakeTensorMode():
        keep = library.greedy_suppress(torch.empty(3, 7, 7),
                                       torch.empty(3, 7),
                                       torch.empty(3, 7, dtype=torch.bool),
                                       0.25)
        assert keep.shape == (3, 7) and keep.dtype == torch.bool


@pytest.mark.parametrize("shapes,error", [
    (((3, 7, 6), (3, 7), (3, 7)), ValueError),   # iou not [B, K, K]
    (((2, 7, 7), (3, 7), (3, 7)), ValueError),   # iou's batch
    (((3, 7, 7), (3, 7, 1), (3, 7)), ValueError),  # scores not [B, K]
    (((3, 7, 7), (3, 7), (3, 6)), ValueError),   # valid's shape
    (((3, 7, 7), (3, 7), None), TypeError),      # valid not bool
], ids=["iou_cols", "iou_batch", "scores_rank", "valid_shape",
        "valid_dtype"])
def test_fake_checks_arguments(shapes, error):
    iou_s, scores_s, valid_s = shapes
    with FakeTensorMode():
        valid = (torch.empty(3, 7, dtype=torch.uint8) if valid_s is None
                 else torch.empty(valid_s, dtype=torch.bool))
        with pytest.raises(error):
            library.greedy_suppress(torch.empty(iou_s),
                                    torch.empty(scores_s), valid, 0.25)


def test_cpu_call_runs_the_plain_loop():
    iou, scores, valid = torch_case("random", 2, 40, 0.25)
    before = cuda_nms.launches
    got = library.greedy_suppress(iou, scores, valid, 0.25)
    assert torch.equal(got, plain_walk(iou, scores, valid, 0.25))
    assert cuda_nms.launches == before


# ------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def plain_on(*args):
    with ops.use_impl("plain"):
        return library.greedy_suppress(*args)


@pytest.mark.card
@pytest.mark.parametrize("b,k", SIZES, ids=[f"B{b}-K{k}" for b, k in SIZES])
@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_kernel_equals_plain_loop(card, case, b, k):
    name, thresh = case
    args = torch_case(name, b, k, thresh, card)
    got = library.greedy_suppress(*args, thresh)
    want = plain_on(*args, thresh)
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert torch.equal(got.cpu(), plain_walk(*(a.cpu() for a in args), thresh))


@pytest.mark.card
@pytest.mark.parametrize("flavour", ["aabb", "aabb_cls", "bev", "oriented"])
def test_every_flavour_equals_plain(card, flavour):
    rng = np.random.default_rng(3)
    B, K = 32, 256
    center = rng.uniform(-2, 2, (B, K, 3)).astype(np.float32)
    size = rng.uniform(0.3, 1.5, (B, K, 3)).astype(np.float32)
    heading = rng.uniform(-np.pi, np.pi, (B, K)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(card)
    corners = boxes.box_corners(t(center), t(size), t(heading))
    bmin, bmax = boxes.corners_to_aabb(corners)
    scores = t(rng.choice([0.2, 0.5, 0.9], (B, K)).astype(np.float32))
    valid = t(rng.random((B, K)) < 0.8)
    sem = t(rng.integers(0, 10, (B, K)))

    def run():
        if flavour == "oriented":
            return nms.nms_oriented(corners, scores, valid, 0.25, sem_cls=sem)
        fn = nms.nms_bev if flavour == "bev" else nms.nms_aabb
        return fn(bmin, bmax, scores, valid, 0.25,
                  sem_cls=sem if flavour != "aabb" else None)

    before = cuda_nms.launches
    got = run()
    assert cuda_nms.launches == before + 1
    with ops.use_impl("plain"):
        want = run()
    assert cuda_nms.launches == before + 1
    assert torch.equal(got, want)
    assert 0 < got.sum() < valid.sum()  # some kept, some suppressed


def benchmark_config(name):
    """The port's Config of portbench/configs/<name>.json (its model,
    data, train and eval sections)."""
    spec = json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())
    cfg = Config()

    def value(v):
        return tuple(value(x) for x in v) if isinstance(v, list) else v

    return dataclasses.replace(cfg, **{
        s: dataclasses.replace(getattr(cfg, s),
                               **{k: value(v) for k, v in spec[s].items()})
        for s in ("model", "data", "train", "eval")})


SERVED = [("sadet-sunrgbd-20k", 32), ("sadet-sunrgbd-20k", 1),
          ("sadet-scannet-40k", 8)]


@pytest.mark.card
@pytest.mark.parametrize("config,b", SERVED,
                         ids=[f"{c}-b{b}" for c, b in SERVED])
def test_served_program_keep_eager_and_replayed(card, config, b, monkeypatch):
    """The served program at the configuration's shapes: the walk's
    inputs recorded in an eager request, the kernel's keep equal to the
    plain loop's on them; then the program captured as one CUDA graph and
    replayed on two batches, its keep equal to the eager program's."""
    cfg = benchmark_config(config)
    train_lib.apply_runtime_config(cfg)
    try:
        n = cfg.data.num_points
        model = SizeAdaptiveDetector(
            cfg.model, device=card, generator=torch.Generator().manual_seed(5))
        gen = torch.Generator(device=card).manual_seed(6)
        batches = []
        for _ in range(2):
            pts = torch.rand(b, n, 3, device=card, generator=gen) * 6 - 3
            mask = torch.ones(b, n, dtype=torch.bool, device=card)
            mask[:, n - n // 40:] = False  # padding, as the cells pad
            batches.append((pts, mask))
        with torch.no_grad():  # BatchNorm's averages from the data
            model.train()
            model(batches[0][0], mask=batches[0][1], bn_momentum=0.0)
        infer = serving.build_inference_fn(cfg, model, model.mean_sizes)

        seen = []
        op = library.greedy_suppress

        def record(*args):
            seen.append(args)
            return op(*args)

        monkeypatch.setattr(library, "greedy_suppress", record)
        eager = [infer(*batch)["keep"].clone() for batch in batches]
        monkeypatch.undo()
        assert len(seen) == 2 and seen[0][0].shape == (b, 256, 256)
        for args, keep in zip(seen, eager):
            assert torch.equal(keep, plain_on(*args))
        assert eager[0].any()

        static = [t.clone() for t in batches[0]]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            infer(*static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = cuda_nms.launches
        with torch.cuda.graph(graph):
            out = infer(*static)
        assert cuda_nms.launches == before + 1  # the capture's one launch
        for batch, keep in zip(batches, eager):
            for s, t in zip(static, batch):
                s.copy_(t)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out["keep"], keep)
        assert cuda_nms.launches == before + 1  # a replay calls no wrapper
    finally:
        train_lib.apply_runtime_config(Config())


@pytest.mark.card
def test_wrapper_counts_one_launch_a_call(card):
    args = torch_case("random", 32, 256, 0.25, card)
    before = cuda_nms.launches
    for i in range(3):
        cuda_nms.greedy_suppress(*args, 0.25)
        assert cuda_nms.launches == before + i + 1


@pytest.mark.card
def test_scores_read_through_their_strides(card):
    """The served program's scores are a column of the objectness
    softmax, [B, K, 2][..., 1]: the kernel reads them in place."""
    iou, scores, valid = torch_case("random", 32, 256, 0.25, card)
    column = torch.stack([torch.rand_like(scores), scores], -1)[..., 1]
    assert not column.is_contiguous() and torch.equal(column, scores)
    got = cuda_nms.greedy_suppress(iou, column, valid, 0.25)
    assert torch.equal(got, plain_on(iou, scores, valid, 0.25))


@pytest.mark.card
def test_k_above_the_limit_raises(card):
    k = cuda_nms.MAX_K + 1
    args = (torch.zeros(1, k, k, device=card), torch.zeros(1, k, device=card),
            torch.ones(1, k, dtype=torch.bool, device=card))
    before = cuda_nms.launches
    with pytest.raises(RuntimeError, match="tpu3dsad_nms_walk"):
        cuda_nms.greedy_suppress(*args, 0.25)
    assert cuda_nms.launches == before
