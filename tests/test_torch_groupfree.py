"""Group-Free 3D (models/groupfree.py, model.name='groupfree3d') on the
port's path: the box point-count op, multi-head attention and the decoder
layer, the decode and parse, the factory and preset, the entry points, and
the served program held to the benchmark's plain reference
(portbench/reference/groupfree.py).

On the CPU, at a small size (2 rooms of 1024 points; 3 decoder layers of
32 channels in 4 heads, an FFN of 64, 64 seeds, 16 candidates):

  * the plain point count equals a numpy oracle: points exactly on each
    face (x and y strict, z inclusive), masked points, a box of exactly 5
    points against one of 6, boxes of negative and zero size; the custom op
    passes opcheck (its fake's shapes among them) and its fake checks the
    arguments;
  * the program's attention is torch.nn.MultiheadAttention's with the same
    weights, with and without padded keys; a scene with no valid key
    attends to every key rather than to none;
  * one decoder layer of the reference, and the program's, equal a
    composition of nn.MultiheadAttention, nn.LayerNorm and nn.Linear with
    the same weights (mmcv's post-norm layer, the position term added to
    the query, the key and the value): so the equations are mmcv's own;
  * the decode: centre relative to the candidates at every stage, size =
    mean + residual x mean at the argmax size class; the parse takes the
    last three stages in stage order and walks only the non-empty boxes;
  * the served program (seeded weights, calibrated BatchNorm) equals the
    reference: the same products in the same order on the CPU, so every
    stage's end points, the six fields and the counts are equal (held at
    atol 1e-6: a BLAS that blocks a product otherwise rounds it otherwise)
    and the KPS picks are the same sets;
  * preset=groupfree3d builds Group-Free 3D through
    train_detector.build_detector, serves through
    serving.build_inference_fn and the serving CLI, evaluates through
    eval_detector.run_eval on a ScanNet-format split, exports with one
    box-point node (torch.export), and the train entry refuses it; the
    spans of a forward; a request makes one point-count call, on the last
    three stages' boxes.

On the card (`card` tests, skipped without one): the kernel's counts equal
the plain op's at the cell's shape (16 x 768 boxes, 51200 points), on
ragged, masked, empty and largest inputs, and with points on the faces.
This file imports no JAX, so on the card:
    python -m pytest tests/test_torch_groupfree.py --noconftest -m card
"""

import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch import nn

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

from portbench import weights  # noqa: E402
from portbench.harness import Context  # noqa: E402
from portbench.reference import compare, detector  # noqa: E402
from portbench.reference import groupfree as reference  # noqa: E402
from portbench.traffic.indoor import indoor_scene, padded  # noqa: E402
from tpu3dsad_torch import ops, serving, train_lib  # noqa: E402
from tpu3dsad_torch.config import Config, parse_cli  # noqa: E402
from tpu3dsad_torch.eval.parse import parse_groupfree  # noqa: E402
from tpu3dsad_torch.models.groupfree import GroupFree3D, decode  # noqa: E402
from tpu3dsad_torch.nn.transformer import (  # noqa: E402
    DecoderLayer,
    MultiheadAttention,
    key_padding,
)
from tpu3dsad_torch.ops import library  # noqa: E402
from tpu3dsad_torch.ops.plain import box_points  # noqa: E402
from tpu3dsad_torch.train_detector import build_detector  # noqa: E402
from tpu3dsad_torch.utils import trace  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
B, N = 2, 1024
SMALL = dict(sa_npoints=[256, 64, 32, 16], sa_radii=[0.4, 0.8, 1.2, 1.6],
             sa_nsamples=[16, 8, 8, 8],
             sa_channels=[[16, 16, 32], [32, 32, 32], [32, 32, 32],
                          [32, 32, 32]],
             fp_channels=[[32, 32], [32, 32]], groupfree_candidates=16,
             groupfree_layers=3,
             groupfree_heads=4, groupfree_ffn=64,
             groupfree_head_channels=[32, 32])
SMALL_ARGS = ["model.sa_npoints=(256,64,32,16)",
              "model.sa_radii=(0.4,0.8,1.2,1.6)",
              "model.sa_nsamples=(16,8,8,8)",
              "model.sa_channels=((16,16,32),(32,32,32),(32,32,32),"
              "(32,32,32))",
              "model.fp_channels=((32,32),(32,32))",
              "model.groupfree_candidates=16",
              "model.groupfree_layers=3", "model.groupfree_heads=4",
              "model.groupfree_ffn=64",
              "model.groupfree_head_channels=(32,32)",
              f"data.num_points={N}"]


def small_config() -> dict:
    cfg = json.loads((REPO / "portbench" / "configs"
                      / "groupfree3d-scannet-l12o256.json").read_text())
    cfg["model"].update(SMALL)
    cfg["data"]["num_points"] = N
    return cfg


def port_config(config: dict):
    return Context.port_config(SimpleNamespace(config=config))


def rooms(seed: int, b: int = B):
    """Points [b, N, 3] of indoor rooms of N - 100 points padded to N, and
    their mask."""
    rng = np.random.default_rng(seed)
    scenes = [padded(indoor_scene(rng, N - 100), N) for _ in range(b)]
    return (torch.from_numpy(np.stack([s[0] for s in scenes])),
            torch.from_numpy(np.stack([s[1] for s in scenes])))


def calibrated(model, points, mask):
    with torch.no_grad():
        model.train()
        model(points, mask=mask, bn_momentum=0.0)
        model.eval()


@pytest.fixture(autouse=True)
def tracer_off():
    trace.enable(False)
    trace.collect()
    yield
    trace.enable(False)
    trace.collect()


# ------------------------------------------------------------- point count


def oracle(points, centers, sizes, mask):
    """numpy: for each box the valid points with |d| < s / 2 in x and y and
    |d| <= s / 2 in z, in float32."""
    p = np.asarray(points, np.float32)
    c = np.asarray(centers, np.float32)
    h = np.asarray(sizes, np.float32) * np.float32(0.5)
    out = np.zeros(c.shape[:2], np.int32)
    for b in range(p.shape[0]):
        for j in range(c.shape[1]):
            gap = np.abs((p[b] - c[b, j]).astype(np.float32))
            inside = ((gap[:, 0] < h[b, j, 0]) & (gap[:, 1] < h[b, j, 1])
                      & (gap[:, 2] <= h[b, j, 2]) & mask[b])
            out[b, j] = inside.sum()
    return out


def face_case():
    """One box at (1, 2, 3) of size (2, 4, 6): points exactly on each of
    its six faces (half of them at an edge's middle), inside, outside and
    masked."""
    c = np.array([[[1.0, 2.0, 3.0]]], np.float32)
    s = np.array([[[2.0, 4.0, 6.0]]], np.float32)
    pts = np.array([[[2.0, 2.0, 3.0], [0.0, 2.0, 3.0],    # x faces: out
                     [1.0, 4.0, 3.0], [1.0, 0.0, 3.0],    # y faces: out
                     [1.0, 2.0, 6.0], [1.0, 2.0, 0.0],    # z faces: in
                     [1.5, 3.0, 5.9], [1.0, 2.0, 3.0],    # inside
                     [1.0, 2.0, 6.0001], [3.0, 2.0, 3.0],  # outside
                     [1.0, 2.0, 3.0]]], np.float32)       # masked
    mask = np.ones((1, 11), bool)
    mask[0, 10] = False
    return pts, c, s, mask


def five_and_six():
    """Two boxes of 5 valid points each, the first with a masked point in it
    besides (6 points once it is unmasked)."""
    c = np.array([[[0.0, 0.0, 0.0], [5.0, 0.0, 0.0]]], np.float32)
    s = np.ones((1, 2, 3), np.float32)
    rng = np.random.default_rng(0)
    inner = rng.uniform(-0.4, 0.4, (11, 3)).astype(np.float32)
    pts = np.concatenate([inner[:6], inner[6:] + [5.0, 0.0, 0.0]])[None]
    mask = np.ones((1, 11), bool)
    mask[0, 0] = False
    return pts.astype(np.float32), c, s, mask


def random_case(seed, b, n, p, masked=True):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3, 3, (b, n, 3)).astype(np.float32)
    c = rng.uniform(-3, 3, (b, p, 3)).astype(np.float32)
    s = rng.uniform(-0.5, 2.5, (b, p, 3)).astype(np.float32)  # some < 0
    s[:, :1] = 0.0  # a zero-size box
    mask = rng.random((b, n)) > (0.2 if masked else -1)
    return pts, c, s, mask


CASES = {"faces": face_case, "five-and-six": five_and_six,
         "random": lambda: random_case(1, 2, 300, 17),
         "unmasked": lambda: random_case(2, 3, 129, 5, masked=False)}


@pytest.mark.parametrize("case", CASES, ids=list(CASES))
def test_plain_box_points_equals_a_numpy_oracle(case):
    pts, c, s, mask = CASES[case]()
    got = box_points(*(torch.from_numpy(a) for a in (pts, c, s, mask)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), oracle(pts, c, s, mask))
    if case == "faces":
        assert got.tolist() == [[4]]
    if case == "five-and-six":
        assert got.tolist() == [[5, 5]]
        mask[0, 0] = True
        got = box_points(*(torch.from_numpy(a) for a in (pts, c, s, mask)))
        assert got.tolist() == [[6, 5]]


def test_box_points_blocks_are_the_one_block_count(monkeypatch):
    """A count over blocks of boxes equals the count in one block."""
    import importlib

    module = importlib.import_module("tpu3dsad_torch.ops.plain.box_points")

    pts, c, s, mask = (torch.from_numpy(a)
                       for a in random_case(3, 2, 200, 30))
    whole = box_points(pts, c, s, mask)
    monkeypatch.setattr(module, "SLAB", 2 * 200 * 4)
    assert torch.equal(box_points(pts, c, s, mask), whole)
    assert torch.equal(box_points(pts, c, s), box_points(
        pts, c, s, torch.ones(2, 200, dtype=torch.bool)))


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no-mask"])
def test_box_points_op_passes_opcheck(masked):
    pts, c, s, mask = (torch.from_numpy(a)
                       for a in random_case(4, 2, 64, 9))
    torch.library.opcheck(torch.ops.tpu3dsad_torch.box_points.default,
                          (pts, c, s, mask if masked else None))
    assert torch.equal(ops.box_points(pts, c, s, mask=mask),
                       box_points(pts, c, s, mask))


@pytest.mark.parametrize("shapes, error", [
    (((2, 10, 3), (2, 4, 3), (2, 4, 2), (2, 10)), ValueError),
    (((2, 10, 3), (3, 4, 3), (3, 4, 3), (2, 10)), ValueError),
    (((2, 10, 3), (2, 4, 3), (2, 4, 3), (2, 9)), ValueError),
    (((2, 10, 4), (2, 4, 3), (2, 4, 3), (2, 10)), ValueError),
], ids=["sizes", "batch", "mask", "points"])
def test_box_points_checks_its_arguments(shapes, error):
    from torch._subclasses.fake_tensor import FakeTensorMode

    p, c, s, m = shapes
    args = (torch.zeros(p), torch.zeros(c), torch.zeros(s),
            torch.ones(m, dtype=torch.bool))
    with pytest.raises(error):
        box_points(*args)
    with FakeTensorMode() as mode, pytest.raises(error):
        library.box_points(*(mode.from_tensor(a) for a in args))


def test_box_points_wrapper_refuses_a_cpu_tensor():
    from tpu3dsad_torch.ops.cuda import box_points as cuda_box_points

    with pytest.raises(ValueError, match="CUDA"):
        cuda_box_points.box_points(torch.zeros(1, 4, 3), torch.zeros(1, 2, 3),
                                   torch.zeros(1, 2, 3))


# ------------------------------------------------------------- attention


def torch_mha(ours: MultiheadAttention) -> nn.MultiheadAttention:
    """torch.nn.MultiheadAttention, batch first, with our weights."""
    mha = nn.MultiheadAttention(ours.d, ours.heads, batch_first=True)
    with torch.no_grad():
        mha.in_proj_weight.copy_(ours.in_proj.weight)
        mha.in_proj_bias.copy_(ours.in_proj.bias)
        mha.out_proj.weight.copy_(ours.out_proj.weight)
        mha.out_proj.bias.copy_(ours.out_proj.bias)
    return mha.eval()


@pytest.mark.parametrize("kind", ["self", "cross", "cross-padded"])
def test_attention_is_torch_multihead_attention(kind):
    """Equal within 2e-6: torch adds the padding mask to the scores
    (baddbmm) where ours fills them, the same products otherwise."""
    torch.manual_seed(0)
    ours = MultiheadAttention(32, 4)
    nn.init.normal_(ours.in_proj.bias)
    mha = torch_mha(ours)
    x = torch.randn(2, 16, 32)
    kv = torch.randn(2, 40, 32)
    pad = torch.zeros(2, 40, dtype=torch.bool)
    pad[1, 30:] = True
    with torch.no_grad():
        if kind == "self":
            got, want = ours(x), mha(x, x, x)[0]
        elif kind == "cross":
            got, want = ours(x, kv), mha(x, kv, kv)[0]
        else:
            got = ours(x, kv, pad)
            want = mha(x, kv, kv, key_padding_mask=pad)[0]
            # a padded key moves nothing
            moved = kv.clone()
            moved[1, 30:] += 100.0
            assert torch.equal(ours(x, moved, pad), got)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


def test_a_scene_with_no_valid_key_attends_to_every_key():
    mask = torch.tensor([[True, False, True], [False, False, False]])
    assert key_padding(mask).tolist() == [[False, True, False],
                                          [False, False, False]]
    ours = MultiheadAttention(8, 2)
    out = ours(torch.randn(2, 3, 8), torch.randn(2, 3, 8),
               key_padding(mask))
    assert out.isfinite().all()


def composed_layer(ours: DecoderLayer):
    """mmcv's post-norm layer as torch's modules, with our weights."""
    self_attn, cross_attn = torch_mha(ours.self_attn), torch_mha(
        ours.cross_attn)
    norms = [ours.norm_0, ours.norm_1, ours.norm_2]
    ffn = nn.Sequential(ours.ffn_in, nn.ReLU(), ours.ffn_out)

    def layer(q, k, qp, kp, pad):
        u = q + qp
        q = norms[0](q + self_attn(u, u, u)[0])
        w = k + kp
        q = norms[1](q + cross_attn(q + qp, w, w, key_padding_mask=pad)[0])
        return norms[2](q + ffn(q))
    return layer


def test_decoder_layers_are_mmcvs_composition():
    """The program's layer and the reference's, on the same weights, equal
    nn.MultiheadAttention + nn.LayerNorm + nn.Linear composed as mmcv's
    BaseTransformerLayer('self_attn', 'norm', 'cross_attn', 'norm', 'ffn',
    'norm') with GroupFree3DMHA's value terms, within 1e-5 (the masked
    scores added or filled; LayerNorm's division by ~1e-1 scales a 1e-6
    gap)."""
    torch.manual_seed(1)
    ours = DecoderLayer(32, 4, 64)
    shapes = {f"decoder_layers.0.{n}": tuple(v.shape)
              for n, v in ours.state_dict().items()}
    params = weights.draw(shapes, 11, "cpu")
    ours.load_state_dict({n.split("decoder_layers.0.")[1]: v
                          for n, v in params.items()})
    q, qp = torch.randn(2, 16, 32), torch.randn(2, 16, 32)
    k, kp = torch.randn(2, 40, 32), torch.randn(2, 40, 32)
    pad = torch.zeros(2, 40, dtype=torch.bool)
    pad[0, 33:] = True
    m = {"groupfree_heads": 4}
    with torch.no_grad():
        want = composed_layer(ours)(q, k, qp, kp, pad)
        program = ours(q, k, qp, kp, pad)
        ref = reference.decoder_layer(detector.Net(params, train=False),
                                      "decoder_layers.0", q, k, qp, kp, pad,
                                      m)
    torch.testing.assert_close(program, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(ref, want, rtol=0, atol=1e-5)


def test_reference_layer_norm_is_its_definition():
    """Within 1e-6 of (x - mean) / sqrt(var + eps) * w + b with the biased
    variance, at activations of a few units."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(4, 16, 288, generator=g) * 3 + 1
    p = {"n.weight": torch.rand(288, generator=g) + 0.5,
         "n.bias": torch.randn(288, generator=g)}
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    want = (x - mean) / torch.sqrt(var + 1e-5) * p["n.weight"] + p["n.bias"]
    got = reference.layer_norm(detector.Net(p, train=False), "n", x, 1e-5)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


# ------------------------------------------------------------- decode, parse


def test_decode_is_the_group_free_coder():
    """centre = base + residual; c = argmax of the size classes; size =
    mean[c] + res[c] * mean[c]; objectness is cls's first channel."""
    g = torch.Generator().manual_seed(3)
    NC = 4
    sizes = torch.rand(NC, 3, generator=g) + 0.5
    cls = torch.randn(2, 5, 1 + NC, generator=g)
    reg = torch.randn(2, 5, 5 + 4 * NC, generator=g)
    base = torch.randn(2, 5, 3, generator=g)
    center, size, obj, sem = decode(cls, reg, base, sizes)
    assert torch.equal(center, base + reg[..., :3])
    assert torch.equal(obj, cls[..., 0]) and torch.equal(sem, cls[..., 1:])
    for b in range(2):
        for p in range(5):
            c = int(reg[b, p, 5:5 + NC].argmax())
            res = reg[b, p, 5 + NC:].reshape(NC, 3)[c]
            assert torch.equal(size[b, p], sizes[c] + res * sizes[c])


def stages_of(values: dict, S: int = 4, P: int = 3, NC: int = 2):
    """End points of S stages of P boxes, 2 scenes, from per-stage fills."""
    ep = {"stage_center": torch.zeros(2, S, P, 3),
          "stage_size": torch.ones(2, S, P, 3),
          "stage_obj": torch.zeros(2, S, P),
          "stage_sem": torch.zeros(2, S, P, NC),
          "proposal_mask": torch.ones(2, P, dtype=torch.bool),
          "points": torch.zeros(2, 20, 3),
          "point_mask": torch.ones(2, 20, dtype=torch.bool)}
    for key, fill in values.items():
        ep[key] = fill
    return ep


def test_parse_takes_the_last_three_stages_in_stage_order():
    S, P = 5, 3
    center = torch.arange(2 * S * P, dtype=torch.float32).reshape(
        2, S, P, 1).expand(2, S, P, 3).contiguous()
    ep = stages_of({"stage_center": center,
                    "stage_size": torch.ones(2, S, P, 3),
                    "stage_obj": torch.zeros(2, S, P),
                    "stage_sem": torch.zeros(2, S, P, 2)}, S, P)
    out = parse_groupfree(ep, Config().eval, stages=3, min_points=5)
    assert out["center"].shape == (2, 9, 3)
    want = center[:, 2:].reshape(2, 9, 3)
    assert torch.equal(out["center"], want)
    assert torch.equal(out["heading"], torch.zeros(2, 9))
    one = parse_groupfree(ep, Config().eval, stages=1, min_points=5)
    assert torch.equal(one["center"], center[:, -1])


def test_nonempty_gate_drops_boxes_of_five_points_or_fewer():
    """Unit boxes of one class: 6 points in box 0, 5 in box 1, none in box
    2, and none in box 3, which overlaps box 0 (IoU 0.29) with more
    objectness: box 0 alone is kept, since the walk sees only the
    non-empty boxes. With the points moved into box 3 too, box 3 is kept
    and suppresses box 0."""
    pts = torch.zeros(2, 11, 3)
    pts[:, 6:, 0] = 10.0
    c = torch.tensor([[0.0, 0.0, 0.0], [10.0, 0.0, 0.0], [20.0, 0.0, 0.0],
                      [0.55, 0.0, 0.0]])
    ep = stages_of({"stage_center": c.expand(2, 1, 4, 3).contiguous(),
                    "stage_size": torch.ones(2, 1, 4, 3),
                    "stage_obj": torch.tensor([0.0, 0.0, 0.0, 5.0]).expand(
                        2, 1, 4).contiguous(),
                    "stage_sem": torch.zeros(2, 1, 4, 2),
                    "proposal_mask": torch.ones(2, 4, dtype=torch.bool),
                    "points": pts,
                    "point_mask": torch.ones(2, 11, dtype=torch.bool)},
                   1, 4)
    out = parse_groupfree(ep, Config().eval, stages=1, min_points=5)
    counts = ops.box_points(pts, out["center"], out["size"])
    assert counts[0].tolist() == [6, 5, 0, 0]
    assert out["keep"].tolist() == [[True, False, False, False]] * 2
    ep["points"] = torch.zeros(2, 11, 3) + torch.tensor([0.2, 0.0, 0.0])
    counts = ops.box_points(ep["points"], out["center"], out["size"])
    assert counts[0].tolist() == [11, 0, 0, 11]
    out = parse_groupfree(ep, Config().eval, stages=1, min_points=5)
    assert out["keep"].tolist() == [[False, False, False, True]] * 2


# ------------------------------------------------------------- the model


def served_pair(seed: int):
    """(the batch, the program's end points and six fields, the reference's
    serve and forward) on one seeded batch."""
    config = small_config()
    cfg = port_config(config)
    train_lib.apply_runtime_config(cfg)
    model = build_detector(cfg, device="cpu")
    assert isinstance(model, GroupFree3D)
    shapes = {n: tuple(v.shape) for n, v in model.state_dict().items()
              if v.is_floating_point()}
    assert list(shapes.items()) == list(
        reference.shapes(config["model"]).items())
    params = weights.draw(shapes, seed, "cpu")
    model.load_state_dict(params)
    pts, mask = rooms(seed)
    calibrated(model, pts, mask)
    with torch.no_grad():
        ep = model(pts, mask=mask)
    out = serving.build_inference_fn(cfg, model, model.mean_sizes)(pts, mask)
    ref_params = reference.calibrate(params, config, model.mean_sizes, pts,
                                     mask, "fp32")
    ref = reference.serve(ref_params, config, model.mean_sizes, pts, mask,
                          "fp32")
    with torch.no_grad():
        ref_ep = reference.forward(detector.Net(ref_params, train=False),
                                   config["model"], model.mean_sizes, pts,
                                   mask)
    return (pts, mask), ep, out, ref, ref_ep


@pytest.mark.parametrize("seed", [2400000017, 2**31 + 26])
def test_served_program_equals_the_plain_reference(seed):
    (pts, mask), ep, out, ref, ref_ep = served_pair(seed)
    for key, ref_key in (("stage_center", "center"), ("stage_size", "size"),
                         ("stage_obj", "obj"), ("stage_sem", "sem")):
        assert ep[key].shape[1] == 4  # the proposal stage and 3 layers
        np.testing.assert_allclose(ep[key].numpy(), ref_ep[ref_key].numpy(),
                                   rtol=0, atol=1e-6)
    assert torch.equal(ep["candidate_inds"].sort(-1)[0],
                       ref["picks"].sort(-1)[0])
    fields = {k: ref[k] for k in out}
    assert out["keep"].shape == (B, 48)
    assert compare.slot_mismatches(out, fields) == (0, B * 48)
    for k in ("center", "size", "obj_prob"):
        np.testing.assert_allclose(out[k].numpy(), fields[k].numpy(),
                                   rtol=0, atol=1e-6)
    assert torch.equal(out["keep"], ref["keep"])
    counts = ops.box_points(pts, out["center"], out["size"], mask=mask)
    assert torch.equal(counts, ref["counts"])
    # the filter decides something at this size
    assert 0 < int(ref["valid"].sum()) < B * 48
    assert 0 < int(out["keep"].sum()) <= int(ref["valid"].sum())


def test_planted_value_without_position_is_seen():
    """The slot check tells GroupFree3DMHA from mmcv's plain MHA: the
    reference with the value's position term left out (the plain_value
    control) disagrees on more than the cell's limit (1%) of the slots;
    its KPS picks, made before the decoder, are the sound ones."""
    from portbench.control_groupfree import plain_value_layer, serve

    config = small_config()
    params = weights.draw(reference.shapes(config["model"]), 5, "cpu")
    sizes = GroupFree3D(port_config(config).model, device="cpu").mean_sizes
    batch = rooms(5)
    params = reference.calibrate(params, config, sizes, *batch, "fp32")
    sound = serve(params, config, sizes, batch, "fp32")
    planted = serve(params, config, sizes, batch, "fp32", plain_value_layer)
    fields = ("center", "size", "heading", "sem_cls", "obj_prob", "keep")
    bad = compare.slot_mismatches({k: planted[k] for k in fields},
                                  {k: sound[k] for k in fields})
    assert compare.share([bad]) > 1.0
    assert torch.equal(planted["picks"], sound["picks"])


def test_model_refuses_height_features_and_other_sizes():
    cfg = port_config(small_config())
    with pytest.raises(ValueError, match="append_height"):
        GroupFree3D(dataclasses.replace(cfg.model, append_height=True),
                    device="cpu")
    with pytest.raises(ValueError, match="mean sizes"):
        GroupFree3D(cfg.model, np.ones((3, 3)), device="cpu")
    model = GroupFree3D(cfg.model, device="cpu")
    pts, mask = rooms(1)
    with pytest.raises(ValueError, match="no point features"):
        model(pts, torch.zeros(B, N, 3), mask=mask)


# ------------------------------------------------------------- entry points


def test_preset_builds_group_free_through_the_one_factory():
    cfg = parse_cli(["preset=groupfree3d"])
    assert cfg.model.name == "groupfree3d" and cfg.model.num_classes == 18
    assert cfg.model.fp_channels == ((256, 256), (256, 288))
    assert not cfg.model.append_height and not cfg.train.bf16_matmul
    assert (cfg.model.groupfree_layers, cfg.model.groupfree_candidates,
            cfg.model.groupfree_heads, cfg.model.groupfree_ffn) == (
        12, 256, 8, 2048)
    assert cfg.eval.nms_iou == 0.25 and cfg.eval.objectness_thresh == 0.0
    assert cfg.data.num_points == 51200
    assert Config().model.name == "detector"
    cfg = parse_cli(["preset=groupfree3d", *SMALL_ARGS])
    model = build_detector(cfg, device="cpu")
    pts, mask = rooms(3)
    out = serving.build_inference_fn(cfg, model, model.mean_sizes)(pts, mask)
    assert set(out) == set(serving._EXPORT_KEYS)
    assert out["keep"].shape == (B, 48)
    assert ((out["obj_prob"] > 0) & (out["obj_prob"] < 1)).all()


def write_split(root: Path):
    from tpu3dsad_torch.data import synthetic_indoor

    synthetic_indoor.main([f"out={root}", "scenes=2", "val_scenes=2",
                           "points=1500"])


def test_eval_detector_runs_group_free_on_a_scannet_split(tmp_path):
    from tpu3dsad_torch.eval_detector import run_eval

    write_split(tmp_path / "data")
    cfg = parse_cli(["preset=groupfree3d", *SMALL_ARGS,
                     f"data.root={tmp_path / 'data'}", "train.batch_size=2",
                     "eval.ap_iou_threshs=(0.25,)",
                     f"train.ckpt_dir={tmp_path / 'ckpt'}"])
    out = run_eval(cfg, device="cpu")
    assert out["ckpt_step"] == 0 and out["val_loss"] is None
    assert 0.0 <= out["mAP@0.25"] <= 1.0


def test_serving_cli_exports_and_runs_a_checkpoint(tmp_path, capsys):
    write_split(tmp_path / "data")
    args = ["preset=groupfree3d", *SMALL_ARGS, "train.batch_size=1",
            f"data.root={tmp_path / 'data'}", "device=cpu"]
    cfg = parse_cli(args[:-1])
    model = build_detector(cfg, device="cpu")
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    torch.save({"model": model.state_dict(), "optimizer": {}, "step": 7},
               ckpt / "ckpt_7.pt")
    out = tmp_path / "m.pt2"
    report = serving.main([f"ckpt={ckpt}", f"out={out}", *args])
    assert report["ckpt_step"] == 7 and not report["with_features"]
    assert report["num_points"] == N and report["num_classes"] == 18
    scene = tmp_path / "scene.npy"
    np.save(scene, rooms(4, 1)[0][0, :900].numpy())
    capsys.readouterr()
    serving.main([f"run={out}", f"scene={scene}", "device=cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert isinstance(printed["detections"], list)
    assert all(d["heading"] == 0.0 for d in printed["detections"])


def test_export_holds_one_box_points_node(tmp_path):
    cfg = parse_cli(["preset=groupfree3d", *SMALL_ARGS])
    model = build_detector(cfg, device="cpu")
    pts, mask = rooms(6, 1)
    calibrated(model, pts, mask)
    path = str(tmp_path / "m.pt2")
    serving.export_detector(cfg, model, model.mean_sizes, 1, path,
                            source_dataset="scannet")
    program = serving.load(path)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    for op, calls in (("box_points", 1), ("fps", 4), ("ball_query", 4),
                      ("greedy_suppress", 1)):
        assert sum(f"tpu3dsad_torch.{op}." in t for t in targets) == calls
    with torch.no_grad():
        got = program.module()(pts, mask)
    want = serving.build_inference_fn(cfg, model, model.mean_sizes)(pts,
                                                                    mask)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_train_entry_refuses_group_free(tmp_path):
    from tpu3dsad_torch import train as train_entry
    from tpu3dsad_torch.train_detector import run_detector

    args = ["preset=groupfree3d", *SMALL_ARGS,
            f"train.ckpt_dir={tmp_path}"]
    with pytest.raises(SystemExit, match="no training path"):
        train_entry.main(args, device="cpu")
    with pytest.raises(ValueError, match="losses are not ported"):
        run_detector(parse_cli(args), device="cpu")


def test_spans_of_a_forward():
    cfg = port_config(small_config())
    model = GroupFree3D(cfg.model, device="cpu")
    pts, mask = rooms(7)
    trace.enable()
    with torch.no_grad():
        serving.build_inference_fn(cfg, model, model.mean_sizes)(pts, mask)
    records = trace.collect()
    names = [r["name"] for r in records]
    for name in ("groupfree.backbone", "groupfree.kps", "groupfree.proposal",
                 "groupfree.decoder", "parse.decode", "parse.box_points",
                 "parse.nms", "parse.iou"):
        assert names.count(name) == 1, name
    for name in ("decoder.posembed", "decoder.self_attn",
                 "decoder.cross_attn", "decoder.ffn", "decoder.head"):
        assert names.count(name) == 3, name
        assert {r["parent"] for r in records
                if r["name"] == name} == {"groupfree.decoder"}


def test_a_request_counts_the_last_three_stages_once(monkeypatch):
    """A served request makes one point-count call, through
    ops/library.py's op, on the request's own points and mask and the
    boxes of the last three stages in stage order: the call the benchmark
    records to hold the kernel's counts."""
    cfg = port_config(small_config())
    model = GroupFree3D(cfg.model, device="cpu")
    pts, mask = rooms(11)
    calibrated(model, pts, mask)
    calls, ends = [], []
    sound = library.box_points

    def count(points, centers, sizes, mask=None):
        calls.append((points, centers, sizes, mask))
        return sound(points, centers, sizes, mask)

    monkeypatch.setattr(library, "box_points", count)
    hook = model.register_forward_hook(lambda m, a, out: ends.append(out))
    try:
        serving.build_inference_fn(cfg, model, model.mean_sizes)(pts, mask)
    finally:
        hook.remove()
    assert len(calls) == 1 and len(ends) == 1
    points, centers, sizes, call_mask = calls[0]
    assert torch.equal(points, pts) and torch.equal(call_mask, mask)
    ep = ends[0]
    assert torch.equal(centers, ep["stage_center"][:, -3:].reshape(B, -1, 3))
    assert torch.equal(sizes, ep["stage_size"][:, -3:].reshape(B, -1, 3))


# ------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def kernel_against_plain(points, centers, sizes, mask=None):
    from tpu3dsad_torch.ops.cuda import box_points as cuda_box_points

    before = (cuda_box_points.launches, cuda_box_points.work)
    got = cuda_box_points.box_points(points, centers, sizes, mask)
    with ops.use_impl("plain"):
        want = ops.box_points(points, centers, sizes, mask=mask)
    B, P = centers.shape[:2]
    launched = int(B > 0 and P > 0)
    assert cuda_box_points.launches == before[0] + launched
    assert cuda_box_points.work == before[1] + launched * B * P * \
        points.shape[1]
    assert torch.equal(got, want)
    return got


@pytest.mark.card
def test_kernel_equals_plain_at_the_cells_shape(card):
    """16 rooms of 50000 points padded to 51200, 768 boxes a room of the
    sizes a decode gives."""
    rng = np.random.default_rng(26)
    scenes = [padded(indoor_scene(rng, 50000), 51200) for _ in range(16)]
    pts = torch.from_numpy(np.stack([s[0] for s in scenes])).to(card)
    mask = torch.from_numpy(np.stack([s[1] for s in scenes])).to(card)
    g = torch.Generator(device=card).manual_seed(26)
    centers = torch.rand(16, 768, 3, generator=g, device=card) * 6 - 3
    sizes = torch.rand(16, 768, 3, generator=g, device=card) * 2
    for _ in range(2):
        kernel_against_plain(pts, centers, sizes, mask)


RAGGED = {
    "ragged": (3, 1000, 37, "tail"),
    "unmasked": (2, 777, 33, "none"),
    "faces": (2, 300, 5, "faces"),
    "all-masked": (1, 64, 8, "all"),
    "no-points": (2, 0, 5, "none"),
    "no-boxes": (2, 100, 0, "tail"),
    "one-box": (1, 4097, 1, "none"),
    "largest": (16, 131072, 1024, "tail"),
}


@pytest.mark.card
@pytest.mark.parametrize("case", RAGGED, ids=list(RAGGED))
def test_kernel_equals_plain_on_ragged_inputs(card, case):
    b, n, p, kind = RAGGED[case]
    g = torch.Generator(device=card).manual_seed(n + p)
    pts = torch.rand(b, n, 3, generator=g, device=card) * 6 - 3
    centers = torch.rand(b, p, 3, generator=g, device=card) * 6 - 3
    sizes = torch.rand(b, p, 3, generator=g, device=card) * 2.5 - 0.25
    mask = None
    if kind == "tail":
        mask = torch.arange(n, device=card)[None].expand(b, n) < n * 3 // 4
    elif kind == "all":
        mask = torch.zeros(b, n, dtype=torch.bool, device=card)
    elif kind == "faces":
        half = sizes[:, :1] * 0.5
        for i, (axis, sign) in enumerate([(0, 1), (0, -1), (1, 1), (1, -1),
                                          (2, 1), (2, -1)]):
            pts[:, i] = centers[:, 0]
            pts[:, i, axis] += sign * half[:, 0, axis]
    got = kernel_against_plain(pts, centers, sizes, mask)
    if kind == "all":
        assert not got.any()
