"""Offline detection over new LiDAR drives: a closed loop of one client
sending batches of raw KITTI-size scans, each fitted on the card.

A request is the batch's copy of raw scans to the card (from pinned host
memory), then each scan's fit by the program's own fit
(data/kitti.py::fit_scene: the range crop, FPS of the point budget, B2
over a cloud of more than 65536 points, the gather and pad, all on the
card), then serving.build_inference_fn's call (forward, box decode,
class-aware NMS by the oriented BEV IoU), then the copy of its six output
fields back to the host. Nothing is cached between requests: every scan
is fitted anew, as where every scan of a drive is new. The pool holds
`pool_batches` batches of `batch` raw scans of `raw_points` points
(traffic/outdoor.py), cycled in order; its first batch's fitted points
calibrate BatchNorm's running averages in set-up (program.calibrate). The
end-to-end metric is the scenes of the requests completed in the window
over the window.

A traced run turns the program's tracer (tpu3dsad_torch/utils/trace.py)
on for the measured window alone; `Spans.ms()` then gives the device ms a
request of its spans by name (data.fit, fit.crop, fit.fps, parse.nms,
parse.iou), and, under "fps_flat.points" and "fps_flat.launches", the
points the B2 launches of each request of the profiled window were given
and their number (the FPS wrapper's counters), filled as that window
runs.

`correct`: the reference fits and serves `check_batches` of the pool's
batches (drawn from the seed) by its own code (reference/outdoor.py), and
every request of the run that served one of them is held to it: the raw
rows its fit picked, and its six fields slot by slot. With seeded weights
the proposals seldom overlap by more than the NMS threshold, so `keep`
alone could hardly tell one IoU from another; after the run each checked
batch is served once more with the NMS walk's input recorded
(tpu3dsad_torch.ops.library.greedy_suppress), and that IoU matrix is held
to the reference's over every pair of boxes that overlap on either side,
both at least 0.1 m wide and long (reference/outdoor.py::iou_mismatches).
stderr's "kitti:" line counts the valid boxes, the boxes suppressed and
the pairs so compared.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import harness, program
from portbench.reference import compare, detector as reference
from portbench.reference import outdoor as reference_outdoor
from portbench.traffic.outdoor import KITTI_MEAN_SIZES, scan_pool

FIELDS = ("center", "size", "heading", "sem_cls", "obj_prob", "keep")
SPANS = ("data.fit", "fit.crop", "fit.fps", "parse.nms", "parse.iou")


class Spans:
    """The program's tracer over the measured window (`begin()` at its
    start, `ms()` at its end), and the B2 counters of each request of the
    profiled window after it (`served()` after each request)."""

    def __init__(self, on: bool, trace, fps_counters):
        self.on, self.trace, self.fps = on, trace, fps_counters
        self.requests = 0
        self.profiled = {"fps_flat.points": [], "fps_flat.launches": []}
        self.phase = "off"
        self.last = (0, 0)

    def _counters(self):
        return self.fps.flat_points, self.fps.flat_launches

    def begin(self):
        if self.on and self.phase == "off":
            self.trace.collect()
            self.trace.enable()
            self.phase = "window"

    def request(self):
        self.last = self._counters()

    def served(self):
        self.requests += self.phase == "window"
        if self.phase == "profiled":
            points, launches = self._counters()
            self.profiled["fps_flat.points"].append(points - self.last[0])
            self.profiled["fps_flat.launches"].append(launches - self.last[1])

    def ms(self) -> dict:
        """{span: [device ms a request]} of the measured window (a span's
        records summed in chunks of the window's requests), then the
        profiled window's counters (filled later)."""
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


def pick_mismatches(rows: list, ref_rows: list) -> tuple[int, int]:
    """(fitted slots whose raw row differs from the reference's, slots) of
    one batch: each scan's rows in fit order; a scan whose count differs
    is wrong in every slot of the longer."""
    bad = total = 0
    for got, want in zip(rows, ref_rows):
        got, want = got.cpu(), want.cpu()
        size = max(len(got), len(want))
        total += size
        bad += (int((got != want).sum()) if len(got) == len(want)
                else size)
    return bad, total


def iou_share(pairs: list, walked: list) -> float:
    """compare.share of the IoU's (bad, overlapping) pairs; 0 where no
    pair overlaps on either side (both matrices then agree off the
    diagonal), NaN where a served call did not run the walk once."""
    if not all(walked):
        return float("nan")
    return compare.share(pairs) if sum(t for _, t in pairs) else 0.0


def walk_inputs(infer, *args) -> list:
    """The IoU matrices [B, K, K] the NMS walk read in the call
    infer(*args), on the host."""
    from tpu3dsad_torch.ops import library

    seen, walk = [], library.greedy_suppress

    def record(iou, *args, **kwargs):
        seen.append(iou.detach().cpu())
        return walk(iou, *args, **kwargs)

    library.greedy_suppress = record
    try:
        infer(*args)
    finally:
        library.greedy_suppress = walk
    return seen


def run(ctx) -> harness.Result:
    # a program without the fit function stops here, before any set-up
    from tpu3dsad_torch.data.kitti import fit_scene
    from tpu3dsad_torch import serving, train_lib
    from tpu3dsad_torch.models.detector import SizeAdaptiveDetector
    from tpu3dsad_torch.ops.cuda import fps as cuda_fps
    from tpu3dsad_torch.utils import trace

    w, dev = ctx.workload, ctx.device
    P, B, N = w["pool_batches"], w["batch"], w["budget"]
    scans, checked = scan_pool(np.random.default_rng(ctx.seed), w)
    host = [program.pinned(scans[i], dev) for i in range(P)]

    cfg = ctx.port_config()
    train_lib.apply_runtime_config(cfg)
    model = SizeAdaptiveDetector(cfg.model, KITTI_MEAN_SIZES, device=dev)
    weights = ctx.weights(model)

    def fit(raw):
        fits = [fit_scene(raw[b], N, dev) for b in range(B)]
        return (torch.stack([f.points for f in fits]),
                torch.stack([f.mask for f in fits]), [f.rows for f in fits])

    program.calibrate(model, *fit(host[0].to(dev))[:2])
    infer = serving.build_inference_fn(cfg, model, model.mean_sizes)
    spans = Spans(ctx.trace, trace, cuda_fps)

    def request(i):
        spans.request()
        with record_function("h2d"):
            raw = host[i].to(dev, non_blocking=True)
        with record_function("fit"):
            points, mask, rows = fit(raw)
        out = infer(points, mask)
        with record_function("d2h"):
            out = {k: out[k].cpu() for k in FIELDS}
        spans.served()
        return out, rows

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
            out, rows = request(i)
            if i in checked:
                served.append((i, out, rows))
            done += 1
        n = done - start
        return {"units": n, "scenes": n * B,
                "elapsed": time.perf_counter() - t0}

    window, trace_ = harness.measure(ctx, loop, spans)
    metrics = {"serve_scenes_per_s": window["scenes"] / window["elapsed"]}

    def check():
        sizes = KITTI_MEAN_SIZES

        def reference_fit(i):
            return reference_outdoor.fit(host[i].to(dev), N)

        points, mask, _ = reference_fit(0)
        params = reference.calibrate(weights, ctx.config, sizes, points,
                                     mask, ctx.matmul())
        slots, picks, pairs, walked = [], [], [], []
        valid = kept = 0
        for i in sorted(checked):
            points, mask, ref_rows = reference_fit(i)
            ref = reference_outdoor.serve(params, ctx.config, sizes, points,
                                          mask, ctx.matmul())
            for j, out, rows in served:
                if j == i:
                    slots.append(compare.slot_mismatches(out, ref))
                    picks.append(pick_mismatches(rows, ref_rows))
            seen = walk_inputs(infer, *fit(host[i].to(dev))[:2])
            pairs.append(reference_outdoor.iou_mismatches(
                seen[0], ref["iou"], ref["size"]) if len(seen) == 1
                else (0, 0))
            walked.append(len(seen) == 1)
            valid += int(ref["valid"].sum())
            kept += int(ref["keep"].sum())
        print(f"kitti: {valid} valid boxes, {valid - kept} suppressed, "
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
