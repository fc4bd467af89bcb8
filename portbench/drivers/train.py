"""Training of the detector: the train step of train_lib at
train.steps_per_call = k, on host-made scenes copied to the card.

k > 1 drives train_lib.make_detector_train_block (one captured step
replayed k times a call; the block's first call runs its k steps eagerly,
the second captures), fed one stacked block [k, batch, ...] a call, copied
to the card before each call as the train entry's feed copies it. k = 1
drives make_detector_steps' eager step, fed one batch a step. The pool
holds `pool_steps` batches of `batch` scenes (distinct scenes of `points`
points padded to `budget`), cycled. The host reads the losses back every
`sync_steps` steps, as the train entry logs them. The end-to-end metric is
batch x the steps completed in the window over the window, reported
under the workload's `metric`, one end-to-end metric a cell. A traced run
then trains on for trace_seconds under the profiler (harness.measure).

`correct`: set-up makes one model, optimizer and step (or block) and warms
it up with `warmup_calls` calls (k > 1: the eager warm-up, then the
capture and its replays), which move its state. It then puts back, in
place, the state it started from (the seeded weights and BatchNorm
averages, Adam's moments and count, the augmentation generator's seed)
and makes the checked calls, the window's own calls on the pool's first
batches: at k > 1 one replay of the captured graph, so the checked steps
are replayed steps. The plain reference follows the first `check_steps`
of them from the same weights, batches and augmentation seed. Compared
(reference/compare.py): the first step's loss, the first gradient's norm
by leaf (from Adam's first moment after one step) and the parameters'
change by leaf after the last checked step.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import harness, program
from portbench.reference import compare, training as reference
from portbench.traffic.detection import train_pool

B1 = 0.9  # Adam's first-moment decay: mu after one step is (1 - B1) g


class Recorder:
    """Watches the checked steps through the unit of one step on the timed
    path (a replay of the block's graph, or an eager step's update): after
    step 1 the norm of each leaf's gradient as Adam got it (mu / (1 - B1),
    from moments at zero), after step `last` the norm of each leaf's change
    from the starting weights."""

    def __init__(self, optimizer, names: list, start: dict, last: int):
        self.opt, self.names, self.last = optimizer, names, last
        self.start = [start[n] for n in names]
        self.steps = 0
        self.grad1 = self.change = None

    @torch.no_grad()
    def after_step(self):
        self.steps += 1
        if self.steps == 1:
            self.grad1 = torch.stack([(m / (1 - B1)).norm()
                                      for m in self.opt.mu])
        if self.steps == self.last:
            self.change = torch.stack([
                (p - s).norm() for p, s in zip(self.opt.params, self.start)])

    def read(self) -> dict:
        return {"grad1": dict(zip(self.names, self.grad1.tolist())),
                "change": dict(zip(self.names, self.change.tolist()))}


class _Replays:
    """A captured graph whose replays report to a Recorder."""

    def __init__(self, graph, recorder: Recorder):
        self.graph, self.recorder = graph, recorder

    def replay(self):
        self.graph.replay()
        self.recorder.after_step()


@contextlib.contextmanager
def watched(block, optimizer, recorder: Recorder):
    """Route each step of the calls made inside to `recorder`: the block's
    graph replays where it has captured one, else the optimizer's
    updates."""
    graph = getattr(block, "graph", None)
    if graph is not None:
        block.graph = _Replays(graph, recorder)
    else:
        inner = optimizer.step

        def step():
            inner()
            recorder.after_step()

        optimizer.step = step
    try:
        yield
    finally:
        if graph is not None:
            block.graph = graph
        else:
            del optimizer.step


@torch.no_grad()
def restore(model, optimizer, model_state: dict, opt_state: dict) -> None:
    """Copy the saved state back into the program's own tensors (a captured
    graph holds their addresses)."""
    for n, t in model.state_dict().items():
        t.copy_(model_state[n])
    optimizer.load_state_dict(opt_state)


def run(ctx) -> harness.Result:
    from tpu3dsad_torch import train_lib

    w, dev = ctx.workload, ctx.device
    k, B = w["steps_per_call"], w["batch"]
    pool, aug_seed = train_pool(np.random.default_rng(ctx.seed), w,
                                ctx.config)
    host = {n: program.pinned(v, dev) for n, v in pool.items()}

    cfg, model, weights = program.build(ctx)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    # a schedule whose first decay lies past any run: the rate stays cfg.lr
    optimizer = train_lib.make_optimizer(cfg.train, 1 << 40,
                                         model.parameters())
    model_state = {n: t.clone() for n, t in model.state_dict().items()}
    opt_state = {"mu": [torch.zeros_like(m) for m in optimizer.mu],
                 "nu": [torch.zeros_like(v) for v in optimizer.nu],
                 "count": 0}
    gen = torch.Generator(device=dev).manual_seed(aug_seed)
    bn_m = train_lib.bn_momentum_at(cfg.train, 0)
    calls = w["pool_steps"] // k

    if k > 1:
        block = train_lib.make_detector_train_block(model, optimizer, cfg, k)

        def call(c):
            with record_function("block_copy"):
                batches = {n: v[c * k:(c + 1) * k].to(dev, non_blocking=True)
                           for n, v in host.items()}
            with record_function("replay"):
                return block(batches, gen, bn_m)["loss"]
    else:
        block = None
        step = train_lib.make_detector_steps(model, optimizer, cfg)

        def call(c):
            with record_function("batch_copy"):
                batch = {n: v[c].to(dev, non_blocking=True)
                         for n, v in host.items()}
            with record_function("step"):
                return step(batch, gen, bn_m)["loss"][None]

    # set-up: warm up (k > 1: the eager warm-up, then the capture), put the
    # starting state back, then the checked calls on the pool's first
    # batches, the first steps from the seed
    for c in range(w["warmup_calls"]):
        call(c % calls)
    program.sync(dev)
    restore(model, optimizer, model_state, opt_state)
    gen.manual_seed(aug_seed)
    if block is not None and block.mode == "graph" and block.graph is None:
        raise SystemExit("warmup_calls leave the block uncaptured: the "
                         "checked call would capture, not replay")
    recorder = Recorder(optimizer, names, weights, w["check_steps"])
    checked_calls = -(-w["check_steps"] // k)
    with watched(block, optimizer, recorder):
        losses = [call(c) for c in range(checked_calls)]
    losses = torch.cat(losses)[:w["check_steps"]].tolist()
    prog = {"loss": losses, **recorder.read()}
    program.sync(dev)
    ctx.setup_done()

    steps, c = 0, checked_calls

    def loop(seconds):
        nonlocal steps, c
        start = steps
        t0 = time.perf_counter()
        deadline = t0 + seconds
        pending = []
        while time.perf_counter() < deadline:
            pending.append(call(c % calls))
            c += 1
            steps += k
            if steps % w["sync_steps"] == 0:
                with record_function("read_losses"):
                    torch.cat(pending).tolist()
                pending = []
        if pending:
            torch.cat(pending).tolist()
        program.sync(dev)
        n = steps - start
        return {"units": n, "scenes": n * B,
                "elapsed": time.perf_counter() - t0}

    window, trace = harness.measure(ctx, loop)
    metrics = {w["metric"]: window["scenes"] / window["elapsed"]}

    def check():
        batches = [{n: v[i].to(dev) for n, v in host.items()}
                   for i in range(w["check_steps"])]
        gen = torch.Generator(device=dev).manual_seed(aug_seed)
        ref = reference.follow(weights, ctx.config,
                               program.mean_sizes(ctx), batches, gen,
                               ctx.matmul())
        gaps = compare.train_gaps(prog, ref)
        return [harness.Check(n, gaps[n], w["limits"][n])
                for n in ("first_loss_gap", "first_grad_gap",
                          "median_change_gap")]

    return harness.Result(attempted=window["units"], failed=0, metrics=metrics,
                          check=check, trace=trace)
