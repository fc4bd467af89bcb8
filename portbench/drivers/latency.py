"""Detection in one scene as it arrives: a sensor's frames at a fixed
rate (`rate_hz`, an open loop), each request one raw scan served alone,
as the serving CLI's run= serves it, by one server in arrival order.

A request is serving.prepare_scene_batch (the raw scan subsampled on the
host to the program's calling convention, then copied to the card),
serving.build_inference_fn's call at batch 1, then serving.detections (the
kept boxes as the host lists them). The pool holds `pool_scenes` raw
indoor scans of `raw_points` points, served in an order drawn from the
seed; the first `calibrate` scans, fitted by the benchmark, calibrate
BatchNorm's running averages in set-up (program.calibrate). A request's
latency runs from when it was due (its frame's arrival) to its
detections on the host, so a request that waits behind a slow one counts
the wait. The end-to-end metric is the 95th percentile over every request
due in the window. The generator spins to each frame's due time (a thread
that sleeps between frames wakes up to tens of milliseconds late on a
shared host). A traced run records the forward's and parse / NMS's
CUDA-event spans in its measured window, then serves on at the same rate
for trace_seconds under the profiler (harness.measure).

`correct`: `check_scenes` of the requests due in the measured window (a
number fixed by its length and the rate, all of them served), drawn from
the seed (traffic.indoor.pick_checked), each held box by box, once the
window has closed, to the detections of the reference, which serves the request's scan
fitted to the calling convention by its own code. A run whose check
compares no box is not correct.
"""

from __future__ import annotations

import time

import numpy as np
from torch.profiler import record_function

from portbench import harness, program
from portbench.reference import compare, detector as reference
from portbench.traffic.indoor import (
    fit,
    fit_batch,
    frames,
    pick_checked,
    scan_pool,
)


def run(ctx) -> harness.Result:
    from tpu3dsad_torch import serving

    w, dev = ctx.workload, ctx.device
    raws, order = scan_pool(np.random.default_rng(ctx.seed), w)
    manifest = {"batch_size": 1, "num_points": w["budget"],
                "with_features": False}

    cfg, model, weights = program.build(ctx)
    calib = [t.to(dev) for t in fit_batch(raws[:w["calibrate"]],
                                          w["budget"])]
    program.calibrate(model, *calib)
    infer = serving.build_inference_fn(cfg, model, model.mean_sizes)
    spans = program.Spans(model, ctx.trace, dev.type == "cuda")

    def request(i):
        with record_function("prepare"):
            args = serving.prepare_scene_batch(raws[i], manifest, device=dev)
        out = infer(*args)
        spans.end()
        with record_function("detections"):
            return serving.detections(out)

    for i in range(w["warmup"]):
        request(order[i])
    program.sync(dev)
    spans.reset()
    ctx.setup_done()

    interval = 1.0 / w["rate_hz"]
    checked = pick_checked(ctx.seed, frames(ctx.seconds, w["rate_hz"]),
                           w["check_scenes"])
    served, lat, done = {}, [], 0

    def loop(seconds):
        nonlocal done
        start = done
        t0 = time.perf_counter()
        for k in range(frames(seconds, w["rate_hz"])):
            due = t0 + k * interval
            while time.perf_counter() < due:
                pass  # spin: a sleeping thread wakes late on a busy host
            i = int(order[done % len(order)])
            dets = request(i)
            lat.append(time.perf_counter() - due)
            if done in checked:
                served[done] = (i, dets)
            done += 1
        return {"units": done - start, "scenes": done - start,
                "elapsed": time.perf_counter() - t0,
                "latency": lat[start:done]}

    window, trace = harness.measure(ctx, loop, spans)
    metrics = {"request_p95_ms":
               float(np.percentile(window["latency"], 95)) * 1e3}

    def check():
        sizes = program.mean_sizes(ctx)
        params = reference.calibrate(weights, ctx.config, sizes, *calib,
                                     ctx.matmul())
        counts, refs = [], {}
        for i, dets in served.values():
            if i not in refs:
                pts, mask = fit(raws[i], w["budget"])
                refs[i] = compare.detections(reference.serve(
                    params, ctx.config, sizes, pts.to(dev), mask.to(dev),
                    ctx.matmul()))
            counts.append(compare.box_mismatches(dets, refs[i]))
        return [harness.Check("mismatch_share", compare.share(counts),
                              w["limits"]["mismatch_share"])]

    return harness.Result(attempted=window["units"], failed=0, metrics=metrics,
                          check=check, trace=trace)
