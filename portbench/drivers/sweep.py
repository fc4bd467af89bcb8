"""Offline detection over stored scenes: a closed loop of one client
sending batches of whole rooms to the served program.

A request is the batch's copy to the card (from pinned host memory), then
serving.build_inference_fn's call (forward, box decode, class-aware 3D
NMS), then the copy of its six output fields back to the host. The pool
holds `pool_batches` distinct batches of `batch` indoor rooms of `points`
points padded to `budget`, cycled in order; its first batch calibrates
BatchNorm's running averages in set-up (program.calibrate). The
end-to-end metric is the scenes of the requests completed in the window
over the window. A traced run records the forward's and parse / NMS's
CUDA-event spans in its measured window, then serves on for trace_seconds
under the profiler (harness.measure).

`correct`: the reference serves `check_batches` of the pool's batches
(drawn from the seed), and every request of the run that served one of
them is held to it slot by slot.
"""

from __future__ import annotations

import time

import numpy as np
from torch.profiler import record_function

from portbench import harness, program
from portbench.reference import compare, detector as reference
from portbench.traffic.indoor import sweep_pool

FIELDS = ("center", "size", "heading", "sem_cls", "obj_prob", "keep")


def run(ctx) -> harness.Result:
    from tpu3dsad_torch import serving

    w, dev = ctx.workload, ctx.device
    P, B = w["pool_batches"], w["batch"]
    pts, masks, checked = sweep_pool(np.random.default_rng(ctx.seed), w)
    host = [(program.pinned(pts[i], dev), program.pinned(masks[i], dev))
            for i in range(P)]

    cfg, model, weights = program.build(ctx)
    calib = (host[0][0].to(dev), host[0][1].to(dev))
    program.calibrate(model, *calib)
    infer = serving.build_inference_fn(cfg, model, model.mean_sizes)
    spans = program.Spans(model, ctx.trace, dev.type == "cuda")

    def request(i):
        with record_function("h2d"):
            p = host[i][0].to(dev, non_blocking=True)
            m = host[i][1].to(dev, non_blocking=True)
        out = infer(p, m)
        spans.end()
        with record_function("d2h"):
            return {k: out[k].cpu() for k in FIELDS}

    for i in range(w["warmup"]):
        request(i % P)
    program.sync(dev)
    spans.reset()
    ctx.setup_done()

    served, done = [], 0

    def loop(seconds):
        nonlocal done
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

    window, trace = harness.measure(ctx, loop, spans)
    metrics = {"serve_scenes_per_s": window["scenes"] / window["elapsed"]}

    def check():
        sizes = program.mean_sizes(ctx)
        params = reference.calibrate(weights, ctx.config, sizes, *calib,
                                     ctx.matmul())
        counts = []
        for i in sorted(checked):
            ref = reference.serve(params, ctx.config, sizes,
                                  host[i][0].to(dev), host[i][1].to(dev),
                                  ctx.matmul())
            counts += [compare.slot_mismatches(out, ref)
                       for j, out in served if j == i]
        return [harness.Check("mismatch_share", compare.share(counts),
                              w["limits"]["mismatch_share"])]

    return harness.Result(attempted=window["units"], failed=0, metrics=metrics,
                          check=check, trace=trace)
