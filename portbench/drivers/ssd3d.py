"""3DSSD serving stored KITTI scans: a closed loop of one client sending
batches of scans that were fitted to 16384 points once, as an offline
evaluation or labelling sweep over a stored split does.

Set-up draws `pool_batches` batches of `batch` raw scans of `raw_points`
points from the frozen generator (traffic/outdoor.py) and fits each once
with the program's own fit (data/kitti.py::fit_scene: the range crop, FPS
of the point budget); the pool keeps each batch's fitted rows as
[batch, budget, 4] (xyz + intensity) and their mask in pinned memory. Its
first batch calibrates BatchNorm's running averages (one train-mode
forward, momentum 0). A request is the batch's copy to the card, the split
of xyz and intensity, serving.build_inference_fn's call (the 3DSSD
forward: fusion sampling with the F-FPS kernel, three MSG levels, the
vote layer, candidate generation and the head; the anchor-free decode and
NMS by the oriented BEV IoU, 100 boxes kept), then the copy of its six
output fields back to the host. The end-to-end metric is the scenes of the
requests completed in the window over the window.

A traced run turns the program's tracer (tpu3dsad_torch/utils/trace.py)
on for the measured window alone; `Spans.ms()` then gives the device ms a
request of its spans by name, and, under "ffps.launches", the F-FPS
launches of each request of the profiled window (the kernel wrapper's
counter), filled as that window runs.

`correct`: the reference (reference/ssd3d.py) serves `check_batches` of
the pool's batches (drawn from the seed) from the same fitted scans and
seeded weights, calibrated on the same first batch, and every request of
the run that served one of them is held to it slot by slot
(`mismatch_share`, the sweep's tolerances). After the run each checked
batch is served once more with the inputs of the ops recorded: every
D-FPS and F-FPS call's picks (into its index range) are held to the
reference's
(`pick_mismatch_share`), and the NMS walk's IoU input to the reference's
over every pair of boxes that overlap on either side, both at least 0.1 m
wide and long (`iou_mismatch_share`, reference/outdoor.py). stderr's
"3dssd:" line counts the valid boxes, the boxes the walk suppresses, the
boxes the top-100 cut drops and the pairs compared.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import harness, program
from portbench.drivers.outdoor import iou_share
from portbench.reference import compare
from portbench.reference import outdoor as reference_outdoor
from portbench.reference import ssd3d as reference
from portbench.traffic.outdoor import KITTI_MEAN_SIZES, scan_pool

FIELDS = ("center", "size", "heading", "sem_cls", "obj_prob", "keep")
SPANS = ("ssd3d.sa1", "ssd3d.sa2", "ssd3d.sa3", "sample.dfps",
         "sample.ffps", "ssd3d.vote", "ssd3d.cg", "ssd3d.head",
         "parse.decode", "parse.nms", "parse.iou", "serve.program")


class Spans:
    """The program's tracer over the measured window (`begin()` at its
    start, `ms()` at its end), and the F-FPS launches of each request of
    the profiled window after it (`served()` after each request)."""

    def __init__(self, on: bool, trace, ffps_counter):
        self.on, self.trace, self.ffps = on, trace, ffps_counter
        self.requests = 0
        self.profiled = {"ffps.launches": []}
        self.phase = "off"
        self.last = 0

    def begin(self):
        if self.on and self.phase == "off":
            self.trace.collect()
            self.trace.enable()
            self.phase = "window"

    def request(self):
        self.last = self.ffps.launches

    def served(self):
        self.requests += self.phase == "window"
        if self.phase == "profiled":
            self.profiled["ffps.launches"].append(self.ffps.launches
                                                  - self.last)

    def ms(self) -> dict:
        """{span: [device ms a request]} of the measured window, then the
        profiled window's counter (filled later)."""
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
        out.update(self.profiled)
        return out


def recorded(infer, *args) -> tuple[list, list]:
    """(the picks of every FPS and feature FPS call, the IoU matrices the
    NMS walk read) of the call infer(*args), in call order, on the host."""
    from tpu3dsad_torch.ops import library

    picks, ious = [], []
    saved = {n: getattr(library, n) for n in ("fps", "ffps",
                                              "greedy_suppress")}

    def sampler(name):
        def run(*a, **k):
            out = saved[name](*a, **k)
            picks.append(out.detach().cpu())
            return out
        return run

    def walk(iou, *a, **k):
        ious.append(iou.detach().cpu())
        return saved["greedy_suppress"](iou, *a, **k)

    library.fps, library.ffps = sampler("fps"), sampler("ffps")
    library.greedy_suppress = walk
    try:
        infer(*args)
    finally:
        for n, fn in saved.items():
            setattr(library, n, fn)
    return picks, ious


def pick_mismatches(got: list, want: list) -> tuple[int, int]:
    """(picks that differ, picks) of one batch: the calls' picks in order;
    a call missing or of another shape is wrong in every pick."""
    bad = total = 0
    for i in range(max(len(got), len(want))):
        g = got[i] if i < len(got) else None
        w = want[i] if i < len(want) else None
        size = max(0 if g is None else g.numel(), 0 if w is None
                   else w.numel())
        total += size
        same = g is not None and w is not None and g.shape == w.shape
        bad += int((g != w).sum()) if same else size
    return bad, total


def run(ctx) -> harness.Result:
    # a program without 3DSSD stops here, before any set-up
    from tpu3dsad_torch.models.ssd3d import SSD3D
    from tpu3dsad_torch import serving, train_lib
    from tpu3dsad_torch.data.kitti import fit_scene
    from tpu3dsad_torch.ops.cuda import ffps as cuda_ffps
    from tpu3dsad_torch.utils import trace

    w, dev = ctx.workload, ctx.device
    P, B, N = w["pool_batches"], w["batch"], w["budget"]
    cfg = ctx.port_config()
    train_lib.apply_runtime_config(cfg)
    sizes = KITTI_MEAN_SIZES[:cfg.model.num_classes]
    model = SSD3D(cfg.model, sizes, device=dev)
    weights = ctx.weights(model)

    scans, checked = scan_pool(np.random.default_rng(ctx.seed), w)
    pool = []
    for i in range(P):
        raw = torch.from_numpy(scans[i]).to(dev)
        rows = raw.new_zeros(B, N, 4)
        mask = torch.zeros(B, N, dtype=torch.bool, device=dev)
        for b in range(B):
            fit = fit_scene(raw[b], N, dev)
            rows[b, :fit.rows.shape[0]] = raw[b, fit.rows]
            mask[b] = fit.mask
        pool.append((program.pinned(rows.cpu().numpy(), dev),
                     program.pinned(mask.cpu().numpy(), dev)))
    del scans, raw

    def batch(i):
        rows, mask = (t.to(dev, non_blocking=True) for t in pool[i])
        return rows[..., :3].contiguous(), rows[..., 3:].contiguous(), mask

    points, feats, mask = batch(0)
    with torch.no_grad():
        model.train()
        model(points, feats, mask=mask, bn_momentum=0.0)
        model.eval()
    infer = serving.build_inference_fn(cfg, model, model.mean_sizes,
                                       with_features=True)
    spans = Spans(ctx.trace, trace, cuda_ffps)

    def request(i):
        spans.request()
        with record_function("h2d"):
            points, feats, mask = batch(i)
        out = infer(points, mask, feats)
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
            out = request(i)
            if i in checked:
                served.append((i, out))
            done += 1
        n = done - start
        return {"units": n, "scenes": n * B,
                "elapsed": time.perf_counter() - t0}

    window, trace_ = harness.measure(ctx, loop, spans)
    metrics = {"serve_scenes_per_s": window["scenes"] / window["elapsed"]}

    def check():
        matmul = ctx.matmul()
        params = reference.calibrate(weights, ctx.config, *batch(0), matmul)
        slots, picks, pairs, walked = [], [], [], []
        valid = kept = walked_kept = 0
        for i in sorted(checked):
            points, feats, mask = batch(i)
            ref = reference.serve(params, ctx.config, points, feats, mask,
                                  matmul)
            fields = {k: ref[k] for k in FIELDS}
            for j, out in served:
                if j == i:
                    slots.append(compare.slot_mismatches(out, fields))
            got, ious = recorded(infer, points, mask, feats)
            picks.append(pick_mismatches(got, ref["picks"]))
            pairs.append(reference_outdoor.iou_mismatches(
                ious[0], ref["iou"], ref["size"]) if len(ious) == 1
                else (0, 0))
            walked.append(len(ious) == 1)
            valid += int(ref["valid"].sum())
            kept += int(ref["keep"].sum())
            walked_kept += int(reference_outdoor.greedy(
                ref["iou"], ref["obj_prob"], ref["valid"],
                ctx.config["eval"]["nms_iou"]).sum())
        print(f"3dssd: {valid} valid boxes, {valid - walked_kept} "
              f"suppressed, {walked_kept - kept} past the top "
              f"{ctx.config['model']['ssd3d_max_output']}, "
              f"{sum(t for _, t in pairs)} pairs of boxes compared",
              file=sys.stderr)
        lim = w["limits"]
        return [harness.Check("pick_mismatch_share", compare.share(picks),
                              lim["pick_mismatch_share"]),
                harness.Check("mismatch_share", compare.share(slots),
                              lim["mismatch_share"]),
                harness.Check("iou_mismatch_share", iou_share(pairs, walked),
                              lim["iou_mismatch_share"])]

    return harness.Result(attempted=window["units"], failed=0, metrics=metrics,
                          check=check, trace=trace_)
