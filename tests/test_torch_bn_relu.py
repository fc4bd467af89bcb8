"""Eval-mode BatchNorm + ReLU: the op tpu3dsad_torch::bn_relu
(ops/library.py), its plain chain (ops/plain/norm.py), the kernel
(csrc/bn_relu.cu, ops/cuda/bn_relu.py) and where MaskedBatchNorm takes it
(nn/norm.py):

  * on the CPU, the op runs the plain chain, bitwise the module's own
    chain followed by torch.relu (NaN, infinities and signed zeros
    included), with no launch; MaskedBatchNorm(relu=True) takes the op in
    eval mode where no gradient is recorded, and its chain in train mode
    and wherever autograd records (then gradients flow); train mode
    updates the running averages as the statistics' formulas give them;
    the fake version gives the shape and checks the arguments; an export
    of an eval-mode MLP holds one bn_relu node a layer; each configuration
    of the benchmark serves a request with one op call a BatchNorm layer
    (chip_smoke.BN_RELU_REQUEST);
  * on the card (`card` tests, skipped without one), the kernel bitwise
    the plain chain on the card at every BatchNorm width of the four
    benchmark configurations, at odd and other widths, 0, 1 and many rows,
    a misaligned input, NaN, +-inf and -0.0 entries; inv = rsqrt(var +
    eps) on every fp32 bit pattern; a served request of each architecture
    with one launch a layer and every output bitwise the request with the
    plain chain in the kernel's place; an export on the card with one
    bn_relu node a layer, loaded and bitwise eager.

This file imports no JAX, so on the card it runs alone:
    python -m pytest tests/test_torch_bn_relu.py --noconftest -m card
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

from chip_smoke import BN_RELU_REQUEST  # noqa: E402
from test_torch_nms_kernel import benchmark_config  # noqa: E402
from tpu3dsad_torch import serving, train_lib  # noqa: E402
from tpu3dsad_torch.config import Config, parse_cli  # noqa: E402
from tpu3dsad_torch.nn import MaskedBatchNorm, SharedMLP  # noqa: E402
from tpu3dsad_torch.ops import library  # noqa: E402
from tpu3dsad_torch.ops.cuda import bn_relu as cuda_bn_relu  # noqa: E402
from tpu3dsad_torch.ops.plain import bn_relu as plain_chain  # noqa: E402
from tpu3dsad_torch.train_detector import build_detector  # noqa: E402

CONFIGS = ["sadet-sunrgbd-20k", "sadet-scannet-40k", "sadet-kitti-16k",
           "3dssd-kitti-car-16k"]
# every BatchNorm width of the four configurations (pinned by
# test_widths_are_the_configurations'), then odd and other widths
WIDTHS = [16, 32, 64, 96, 128, 192, 256, 512, 1024]
OTHER = [1, 3, 4, 67, 131, 1027, 4100]
ROWS = [0, 1, 5, 4097]


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype == torch.float32
            and torch.equal(a.view(torch.int32), b.view(torch.int32)))


def make_case(rows: int, c: int, seed: int = 0, device="cpu",
              lead: tuple = ()):
    """(x [*lead, rows, c], mean, var, weight, bias) fp32, with NaN, +-inf,
    +-0.0 among x's entries, zero and negative variances, zero and
    negative weights and a -0.0 bias."""
    g = np.random.default_rng(seed)
    x = g.normal(0, 3, (*lead, rows, c)).astype(np.float32)
    flat = x.reshape(-1)
    if flat.size:
        at = g.choice(flat.size, min(flat.size, 8), replace=False)
        flat[at] = [np.nan, np.inf, -np.inf, -0.0, 0.0, np.nan, -1e-42,
                    3e38][:len(at)]
    mean = g.normal(0, 1, c).astype(np.float32)
    var = np.abs(g.normal(0, 2, c)).astype(np.float32)
    weight = g.normal(1, 1, c).astype(np.float32)
    bias = g.normal(0, 0.5, c).astype(np.float32)
    var[::7] = 0.0
    var[3::11] = -1e-3  # rsqrt of a negative sum: NaN on every row
    weight[2::9] = 0.0
    bias[1::5] = -0.0
    return tuple(torch.from_numpy(a).to(device)
                 for a in (x, mean, var, weight, bias))


def module_chain(x, mean, var, weight, bias, eps):
    """MaskedBatchNorm's eval chain with autograd recording, then ReLU:
    the code the op replaces."""
    bn = MaskedBatchNorm(x.shape[-1], eps).to(x.device).eval()
    with torch.no_grad():
        for name, v in (("running_mean", mean), ("running_var", var),
                        ("weight", weight), ("bias", bias)):
            getattr(bn, name).copy_(v)
    with torch.enable_grad():
        return torch.relu(bn(x)).detach()


# ------------------------------------------------------------- the CPU


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
@pytest.mark.parametrize("rows,c", [(0, 8), (1, 5), (37, 64), (9, 1024)])
def test_cpu_op_is_the_module_chain(rows, c, eps):
    args = make_case(rows, c, seed=c + rows)
    before = cuda_bn_relu.launches
    got = library.bn_relu(*args, eps)
    assert same_bits(got, module_chain(*args, eps))
    assert same_bits(got, plain_chain(*args, eps))
    assert cuda_bn_relu.launches == before


def test_module_takes_the_op_only_where_no_gradient_is_recorded(
        monkeypatch):
    """Eval mode with grad mode off, or with nothing that needs a gradient:
    the op; train mode, relu=False and eval mode under autograd: the chain,
    with the same bits, and a gradient there."""
    calls = []
    op = library.bn_relu

    def counted(*args):
        calls.append(args[0].shape)
        return op(*args)

    monkeypatch.setattr(library, "bn_relu", counted)
    x, mean, var, weight, bias = make_case(6, 16, seed=2)
    x = x.nan_to_num(0.0, 5.0, -5.0)
    bn = MaskedBatchNorm(16, 1e-3)
    with torch.no_grad():
        for name, v in (("running_mean", mean), ("running_var", var.abs()),
                        ("weight", weight), ("bias", bias)):
            getattr(bn, name).copy_(v)
    bn.eval()
    want = module_chain(x, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, 1e-3)
    with torch.no_grad():
        assert same_bits(bn(x, relu=True), want)
    assert len(calls) == 1
    with torch.inference_mode():
        assert same_bits(bn(x, relu=True), want)
    assert len(calls) == 2
    with torch.no_grad():
        plain = bn(x)
    assert len(calls) == 2 and same_bits(torch.relu(plain), want)

    y = bn(x, relu=True)  # grad mode on, weight and bias need gradients
    assert len(calls) == 2 and same_bits(y.detach(), want)
    y.sum().backward()
    assert bn.weight.grad is not None and bn.bias.grad is not None

    bn.requires_grad_(False)
    assert same_bits(bn(x, relu=True), want)  # nothing to record
    assert len(calls) == 3
    xg = x.clone().requires_grad_(True)
    yg = bn(xg, relu=True)
    assert len(calls) == 3 and same_bits(yg.detach(), want)
    yg.sum().backward()
    assert xg.grad is not None

    bn.train()
    with torch.no_grad():
        bn(x, relu=True, momentum=0.5)
    assert len(calls) == 3


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("momentum", [0.9, "tensor"])
def test_train_mode_with_relu_updates_the_averages_as_before(masked,
                                                             momentum):
    """relu=True in train mode: bitwise torch.relu of the relu=False call
    of a twin module, whose running averages it updates to the same bits,
    and those are the statistics' formulas (flax's momentum, the biased
    variance over the valid rows); gradients flow."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(3, 10, 8, generator=g) * 2 + 1
    mask = torch.rand(3, 10, generator=g) < 0.7 if masked else None
    mom = torch.tensor(0.8) if momentum == "tensor" else momentum
    bn, twin = MaskedBatchNorm(8).train(), MaskedBatchNorm(8).train()
    with torch.no_grad():
        for name in ("running_mean", "running_var", "weight", "bias"):
            v = torch.rand(8, generator=g) + 0.5
            getattr(bn, name).copy_(v)
            getattr(twin, name).copy_(v)
    old_mean, old_var = bn.running_mean.clone(), bn.running_var.clone()
    y = bn(x, mask=mask, momentum=mom, relu=True)
    want = torch.relu(twin(x, mask=mask, momentum=mom))
    assert same_bits(y, want)
    assert same_bits(bn.running_mean, twin.running_mean)
    assert same_bits(bn.running_var, twin.running_var)

    rows = x.reshape(-1, 8)
    if mask is None:
        mean, var = rows.mean(0), rows.var(0, unbiased=False)
    else:
        m = mask.reshape(-1, 1).float()
        cnt = m.sum().clamp_min(1.0)
        mean = (rows * m).sum(0) / cnt
        var = (m * (rows - mean) ** 2).sum(0) / cnt
    assert same_bits(bn.running_mean,
                     old_mean.mul(mom).add((1.0 - mom) * mean))
    assert same_bits(bn.running_var, old_var.mul(mom).add((1.0 - mom) * var))
    y.sum().backward()
    assert bn.weight.grad is not None


def test_fake_gives_the_shape():
    with FakeTensorMode():
        y = library.bn_relu(torch.empty(2, 7, 5, 12), *(torch.empty(12)
                                                         for _ in range(4)),
                            1e-5)
        assert y.shape == (2, 7, 5, 12) and y.dtype == torch.float32


@pytest.mark.parametrize("shapes,dtype,error", [
    (((4, 6), (5,)), torch.float32, ValueError),     # a vector's width
    (((), (1,)), torch.float32, ValueError),         # 0-d x
    (((4, 6), (6,)), torch.int32, TypeError),        # integers
], ids=["width", "scalar", "dtype"])
def test_fake_checks_arguments(shapes, dtype, error):
    xs, vs = shapes
    with FakeTensorMode():
        x = torch.empty(xs, dtype=dtype)
        with pytest.raises(error):
            library.bn_relu(x, *(torch.empty(vs, dtype=dtype)
                                 for _ in range(4)), 1e-5)


def test_wrapper_refuses_a_cpu_tensor():
    args = make_case(3, 8)
    before = cuda_bn_relu.launches
    with pytest.raises(ValueError, match="CUDA"):
        cuda_bn_relu.bn_relu(*args, 1e-5)
    assert cuda_bn_relu.launches == before


def test_export_of_an_mlp_holds_one_node_a_layer():
    mlp = SharedMLP(5, (8, 16, 12), eps=1e-3).eval()
    x = torch.randn(2, 6, 4, 5, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        program = torch.export.export(mlp, (x,))
        want = mlp(x)
        got = program.module()(x)
    calls = Counter(str(n.target) for n in program.graph.nodes
                    if n.op == "call_function")
    assert calls["tpu3dsad_torch.bn_relu.default"] == 3
    for unrolled in ("aten.rsqrt.default", "aten.relu.default",
                     "aten.sub.Tensor"):
        assert calls[unrolled] == 0, unrolled
    assert same_bits(got, want)


def test_widths_are_the_configurations():
    widths = set()
    for name in CONFIGS:
        model = build_detector(benchmark_config(name), device="cpu")
        widths |= {m.weight.shape[0] for m in model.modules()
                   if isinstance(m, MaskedBatchNorm)}
    assert sorted(widths) == WIDTHS


def small_request(arch: str):
    """(cfg, model, infer, args): a small served request of the VoteNet
    detector or 3DSSD on the CPU, with the layers of the full model."""
    if arch == "sadet":
        cfg = parse_cli(["model.num_classes=10", "data.num_points=2048"])
    else:
        cfg = parse_cli(["preset=3dssd",
                         "model.ssd3d_npoints=((512,),(64,),(32,32))",
                         "model.ssd3d_fps_ranges=((-1,),(-1,),(64,-1))",
                         "data.num_points=2048"])
    train_lib.apply_runtime_config(cfg)
    model = build_detector(cfg, device="cpu")
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform([0, -20, -2], [40, 20, 1],
                                       (2, 2048, 3)).astype(np.float32))
    mask = torch.ones(2, 2048, dtype=torch.bool)
    feats = arch == "ssd3d"
    infer = serving.build_inference_fn(cfg, model, model.mean_sizes,
                                       with_features=feats)
    args = (pts, mask) + ((torch.from_numpy(
        rng.random((2, 2048, 1)).astype(np.float32)),) if feats else ())
    return cfg, model, infer, args


@pytest.mark.parametrize("arch", ["sadet", "ssd3d"])
def test_served_request_calls_the_op_once_a_layer(arch, monkeypatch):
    """chip_smoke's BN_RELU_REQUEST: one bn_relu call a BatchNorm layer of
    the model, and the request's outputs bitwise those of the chain."""
    _, model, infer, args = small_request(arch)
    layers = sum(isinstance(m, MaskedBatchNorm) for m in model.modules())
    assert BN_RELU_REQUEST[arch] == layers
    calls = []
    op = library.bn_relu

    def counted(*a):
        calls.append(a[0].shape)
        return op(*a)

    monkeypatch.setattr(library, "bn_relu", counted)
    got = infer(*args)
    assert len(calls) == layers
    monkeypatch.setattr(MaskedBatchNorm, "_records_grad", lambda self, x:
                        True)  # every layer on its chain
    want = infer(*args)
    assert len(calls) == layers
    for key, value in want.items():
        assert torch.equal(got[key], value), key


# ------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("c", WIDTHS + OTHER)
def test_kernel_is_the_chain_bitwise(card, c, rows):
    for eps in (1e-5, 1e-3):
        args = make_case(rows, c, seed=c * 7 + rows, device=card)
        before = cuda_bn_relu.launches
        got = library.bn_relu(*args, eps)
        assert cuda_bn_relu.launches == before + 1
        assert same_bits(got, plain_chain(*args, eps))
        assert same_bits(got, module_chain(*args, eps))


@pytest.mark.card
@pytest.mark.parametrize("c", [64, 67, 1024])
def test_misaligned_and_batched_inputs(card, c):
    """x at an offset of one float (the scalar path at any C) and x with
    leading dims, as a grouped level's [B, M, K, C]."""
    x, *vecs = make_case(333, c, seed=c, device=card)
    base = torch.empty(x.numel() + 1, device=card)
    shifted = base[1:].view_as(x)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0
    assert same_bits(library.bn_relu(shifted, *vecs, 1e-5),
                     plain_chain(x, *vecs, 1e-5))
    x, *vecs = make_case(9, c, seed=c + 1, device=card, lead=(2, 3))
    assert same_bits(library.bn_relu(x, *vecs, 1e-3),
                     plain_chain(x, *vecs, 1e-3))


@pytest.mark.card
def test_inv_is_torch_rsqrt_on_every_float(card):
    """x = 1, mean = 0, weight = 1, bias = 0, eps = 0: the output is
    relu(rsqrt(var)), over var = every fp32 bit pattern (2^32, in chunks)."""
    n = 1 << 24
    ones, zeros = (torch.full((n,), v, device=card) for v in (1.0, 0.0))
    bad = 0
    for start in range(0, 1 << 32, n):
        var = torch.arange(start, start + n, device=card,
                           dtype=torch.int64).to(torch.int32).view(
                               torch.float32)
        got = library.bn_relu(ones[None], zeros, var, ones, zeros, 0.0)
        want = plain_chain(ones[None], zeros, var, ones, zeros, 0.0)
        bad += int((got.view(torch.int32) != want.view(torch.int32)).sum())
    assert bad == 0


@pytest.mark.card
@pytest.mark.parametrize("config", ["sadet-sunrgbd-20k",
                                    "3dssd-kitti-car-16k"])
def test_served_request_on_the_card(card, config, monkeypatch):
    """A request of 2 scenes at the configuration's widths and point
    count, BatchNorm calibrated as the cells' set-up does: one launch a
    layer; every recorded layer input through the kernel bitwise the
    plain chain; every output bitwise the request with the plain chain in
    the kernel's place."""
    cfg = benchmark_config(config)
    train_lib.apply_runtime_config(cfg)
    try:
        n = cfg.data.num_points
        model = build_detector(cfg, device=card)
        gen = torch.Generator(device=card).manual_seed(3)
        pts = torch.rand(2, n, 3, device=card, generator=gen) * torch.tensor(
            [60.0, 60.0, 4.0], device=card) - torch.tensor(
                [0.0, 30.0, 3.0], device=card)
        mask = torch.ones(2, n, dtype=torch.bool, device=card)
        mask[1, n - n // 8:] = False
        feats = config.startswith("3dssd")
        extra = ((torch.rand(2, n, 1, device=card, generator=gen),)
                 if feats else ())
        with torch.no_grad():
            model.train()
            model(pts, *extra, mask=mask, bn_momentum=0.0)
        infer = serving.build_inference_fn(cfg, model, model.mean_sizes,
                                           with_features=feats)
        args = (pts, mask, *extra)
        infer(*args)
        seen = []
        op = library.bn_relu

        def record(*a):
            seen.append([t.clone() if torch.is_tensor(t) else t for t in a])
            return op(*a)

        monkeypatch.setattr(library, "bn_relu", record)
        before = cuda_bn_relu.launches
        got = infer(*args)
        torch.cuda.synchronize()
        layers = BN_RELU_REQUEST["ssd3d" if feats else "sadet"]
        assert len(seen) == layers
        assert cuda_bn_relu.launches == before + layers
        for a in seen:
            assert same_bits(op(*a), plain_chain(*a))
        monkeypatch.setattr(library, "bn_relu", plain_chain)
        want = infer(*args)
        assert cuda_bn_relu.launches == before + 2 * layers
        for key, value in want.items():
            assert torch.equal(got[key], value), key
    finally:
        train_lib.apply_runtime_config(Config())


@pytest.mark.card
def test_export_on_the_card(card, tmp_path):
    """The served program of sadet-sunrgbd-20k at B = 1 exported on the
    card: one bn_relu node a layer; loaded, a request launches the kernel
    once a layer and gives the eager program's outputs bitwise."""
    cfg = benchmark_config("sadet-sunrgbd-20k")
    train_lib.apply_runtime_config(cfg)
    try:
        model = build_detector(cfg, device=card)
        path = str(tmp_path / "m.pt2")
        serving.export_detector(cfg, model, model.mean_sizes, 1, path)
        program = serving.load(path)
        calls = Counter(str(n.target) for n in program.graph.nodes
                        if n.op == "call_function")
        assert calls["tpu3dsad_torch.bn_relu.default"] == \
            BN_RELU_REQUEST["sadet"]
        n = cfg.data.num_points
        gen = torch.Generator(device=card).manual_seed(5)
        pts = torch.rand(1, n, 3, device=card, generator=gen) * 6 - 3
        mask = torch.ones(1, n, dtype=torch.bool, device=card)
        before = cuda_bn_relu.launches
        with torch.no_grad():
            got = program.module()(pts, mask)
        assert cuda_bn_relu.launches == before + BN_RELU_REQUEST["sadet"]
        want = serving.build_inference_fn(cfg, model, model.mean_sizes)(
            pts, mask)
        for key, value in want.items():
            assert torch.equal(got[key], value), key
    finally:
        train_lib.apply_runtime_config(Config())
