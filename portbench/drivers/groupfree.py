"""Group-Free 3D serving stored indoor scans: a closed loop of one client
sending batches of whole rooms, as an offline evaluation or labelling sweep
over stored scans (ScanNet V2 val's 312 scans, a building's scan archive)
does.

Set-up draws `pool_batches` batches of `batch` rooms of `points` points
padded to `budget` (traffic/indoor.py::sweep_pool, the generator's point
order) into pinned memory, cycled in order; its first batch calibrates
BatchNorm's running averages (one train-mode forward, momentum 0). A
request is the batch's copy to the card, serving.build_inference_fn's call
(the Group-Free forward: the backbone, KPS, the proposal stage, the 12
decoder layers with their box heads; the parse: the last three stages'
boxes, the point count of each box, the class-aware NMS walk), then the
copy of its six output fields back to the host. The end-to-end metric is
the scenes of the requests completed in the window over the window.

A traced run turns the program's tracer (tpu3dsad_torch/utils/trace.py)
on for the measured window alone; `Spans.ms()` then gives the device ms a
request of its spans by name.

`correct`: the reference (reference/groupfree.py) serves `check_batches`
of the pool's batches (drawn from the seed) from the same rooms and seeded
weights, calibrated on the same first batch, and every request of the run
that served one of them is held to it three ways, each read from that
request itself (`Recorder`: the model's KPS picks and the parse's
point-count call, kept on the card as the request made them and read
after the run):

  * `mismatch_share`: its six fields, slot by slot (the sweep's
    tolerances; a field of another shape is wrong in every slot);
  * `kps_mismatch_share`: its KPS picks against the reference's, as a set
    a scene (picks of one side that the other lacks);
  * `box_count_mismatch_share`: the point-count kernel's counts against
    the reference's count over the same points and the boxes the request
    counted (exact; a request that made no count, or two, is wrong in one
    count). The count is held on the kernel's own boxes because the two
    sides' boxes may differ by fp32 roundings, and a rounding moves a
    point that lies on a face across it; that reaches the served keep
    flags, which `mismatch_share` holds.

stderr's "groupfree:" line counts, over the checked batches, the boxes
with more than 5 points in them, the boxes the walk suppresses, the boxes
kept, and the counts that differ between the two sides' own boxes.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import harness, program
from portbench.reference import compare
from portbench.reference import groupfree as reference
from portbench.traffic.detection import class_mean_sizes
from portbench.traffic.indoor import sweep_pool

FIELDS = ("center", "size", "heading", "sem_cls", "obj_prob", "keep")
SPANS = ("groupfree.backbone", "groupfree.kps", "groupfree.proposal",
         "groupfree.decoder", "decoder.posembed", "decoder.self_attn",
         "decoder.cross_attn", "decoder.ffn", "decoder.head",
         "parse.decode", "parse.box_points", "parse.nms", "parse.iou",
         "serve.program")


class Spans:
    """The program's tracer over the measured window (`begin()` at its
    start, `ms()` at its end; `served()` after each request)."""

    def __init__(self, on: bool, trace):
        self.on, self.trace = on, trace
        self.requests = 0
        self.phase = "off"

    def begin(self):
        if self.on and self.phase == "off":
            self.trace.collect()
            self.trace.enable()
            self.phase = "window"

    def served(self):
        self.requests += self.phase == "window"

    def ms(self) -> dict:
        """{span: [device ms a request]} of the measured window."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        records = self.trace.collect()
        self.trace.enable(False)
        self.phase = "profiled"
        out = {}
        for name, ms in self.trace.times(records).items():
            if name in SPANS and self.requests and \
                    len(ms) % self.requests == 0:
                out[name] = np.asarray(ms).reshape(
                    self.requests, -1).sum(1).tolist()
        return out


class Recorder:
    """The KPS picks (the model's `candidate_inds`) and the point-count
    calls ((centers, sizes, counts) of ops/library.py's box_points) of each
    request made while `on`, kept on the card as the request made them:
    `take()` after the request returns its share. A forward hook and the
    op's name in ops/library.py, restored by `close()`."""

    def __init__(self, model):
        from tpu3dsad_torch.ops import library

        self.library, self.sound = library, library.box_points
        self.on = False
        self.picks, self.calls = [], []
        self.hook = model.register_forward_hook(self._forward)
        library.box_points = self._count

    def _forward(self, module, args, out):
        if self.on:
            self.picks.append(out["candidate_inds"])

    def _count(self, points, centers, sizes, mask=None):
        counts = self.sound(points, centers, sizes, mask)
        if self.on:
            self.calls.append((centers, sizes, counts))
        return counts

    def take(self) -> tuple[list, list]:
        """(picks, calls) recorded since the last take."""
        out = (self.picks, self.calls)
        self.picks, self.calls = [], []
        return out

    def close(self):
        self.library.box_points = self.sound
        self.hook.remove()


def pick_mismatches(got, want) -> tuple[int, int]:
    """(picks of either side the other lacks, picks of both sides) of one
    batch's KPS picks [B,P], compared as a set a scene; another shape is
    wrong in every pick."""
    if got.shape != want.shape:
        return max(got.numel(), want.numel()), max(got.numel(),
                                                   want.numel())
    bad = 0
    for g, w in zip(got.tolist(), want.tolist()):
        bad += len(set(g) ^ set(w))
    return bad, 2 * got.numel()


def slot_mismatches(got: dict, want: dict) -> tuple[int, int]:
    """compare.slot_mismatches, with a field of another shape wrong in
    every slot."""
    if any(tuple(got[k].shape) != tuple(want[k].shape) for k in FIELDS):
        n = max(got["keep"].numel(), want["keep"].numel())
        return n, n
    return compare.slot_mismatches(got, {k: want[k] for k in FIELDS})


def run(ctx) -> harness.Result:
    # a program without Group-Free 3D stops here, before any set-up
    from tpu3dsad_torch.models.groupfree import GroupFree3D
    from tpu3dsad_torch import serving, train_lib
    from tpu3dsad_torch.utils import trace

    w, dev = ctx.workload, ctx.device
    P, B = w["pool_batches"], w["batch"]
    cfg = ctx.port_config()
    train_lib.apply_runtime_config(cfg)
    sizes = class_mean_sizes(cfg.model.num_classes)
    model = GroupFree3D(cfg.model, sizes, device=dev)
    weights = ctx.weights(model)

    pts, masks, checked = sweep_pool(np.random.default_rng(ctx.seed), w)
    host = [(program.pinned(pts[i], dev), program.pinned(masks[i], dev))
            for i in range(P)]
    del pts, masks

    def batch(i):
        return tuple(t.to(dev, non_blocking=True) for t in host[i])

    points, mask = batch(0)
    with torch.no_grad():
        model.train()
        model(points, mask=mask, bn_momentum=0.0)
        model.eval()
    infer = serving.build_inference_fn(cfg, model, model.mean_sizes)
    spans = Spans(ctx.trace, trace)
    recorder = Recorder(model)

    def request(i):
        with record_function("h2d"):
            points, mask = batch(i)
        out = infer(points, mask)
        with record_function("d2h"):
            out = {k: out[k].cpu() for k in FIELDS}
        spans.served()
        return out

    for i in range(w["warmup"]):
        request(i % P)
    program.sync(dev)
    ctx.setup_done()

    served, done = [], 0

    def loop(seconds):
        nonlocal done
        spans.begin()
        start = done
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            i = done % P
            recorder.on = i in checked
            out = request(i)
            if recorder.on:
                served.append((i, out, *recorder.take()))
            done += 1
        recorder.on = False
        n = done - start
        return {"units": n, "scenes": n * B,
                "elapsed": time.perf_counter() - t0}

    window, trace_ = harness.measure(ctx, loop, spans)
    metrics = {"serve_scenes_per_s": window["scenes"] / window["elapsed"]}

    def check():
        recorder.close()
        matmul = ctx.matmul()
        params = reference.calibrate(weights, ctx.config, sizes, *batch(0),
                                     matmul)
        slots, picks, counts = [], [], []
        nonempty = suppressed = kept = moved = 0
        for i in sorted(checked):
            points, mask = batch(i)
            ref = reference.serve(params, ctx.config, sizes, points, mask,
                                  matmul)
            for j, out, got_picks, calls in served:
                if j != i:
                    continue
                slots.append(slot_mismatches(out, ref))
                if len(got_picks) != 1:
                    picks.append((1, 1))  # the forward ran no KPS, or twice
                for got in got_picks:
                    picks.append(pick_mismatches(got.cpu(), ref["picks"]))
                if len(calls) != 1:
                    counts.append((1, 1))  # the parse counted no box, or twice
                for centers, box_sizes, got in calls:
                    want = reference.box_points(points, mask, centers,
                                                box_sizes)
                    counts.append((int((got != want).sum()), want.numel()))
                    if got.shape == ref["counts"].shape:
                        moved += int((got.cpu() != ref["counts"]).sum())
            nonempty += int(ref["valid"].sum())
            suppressed += int(ref["valid"].sum() - ref["walked"].sum())
            kept += int(ref["keep"].sum())
        print(f"groupfree: {nonempty} boxes with more than "
              f"{ctx.config['model']['groupfree_min_points']} points, "
              f"{suppressed} suppressed, {kept} kept, {moved} counts that "
              f"differ between the two sides' own boxes, over "
              f"{len(slots)} checked requests", file=sys.stderr)
        lim = w["limits"]
        return [harness.Check("mismatch_share", compare.share(slots),
                              lim["mismatch_share"]),
                harness.Check("kps_mismatch_share", compare.share(picks),
                              lim["kps_mismatch_share"]),
                harness.Check("box_count_mismatch_share",
                              compare.share(counts),
                              lim["box_count_mismatch_share"])]

    return harness.Result(attempted=window["units"], failed=0, metrics=metrics,
                          check=check, trace=trace_)
