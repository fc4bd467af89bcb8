"""Run one cell of a benchmark copy on a given device, the harness's look
for a card skipped, with one fault planted in the program:

    python launch.py <bench root> <repo> <fault or ""> <cpu|cuda> \
        --workload ... --seed ... --seconds ... --trace ...

Faults: "answer" (an answer altered where it is produced: the served
objectness, and a served detection's score), "unchanged" (the optimizer
step returns the state unchanged), "half_batch" (the loss over the first
half of each batch), "stale_inputs" (a k-step block's replays read the
static inputs the capture left, not the call's batches).
"""

import sys


def plant(fault: str) -> None:
    if not fault:
        return
    from tpu3dsad_torch import serving, train_lib

    if fault == "answer":
        forward = serving.InferenceProgram.forward

        def altered(self, *args, **kwargs):
            out = dict(forward(self, *args, **kwargs))
            out["obj_prob"] = out["obj_prob"] + 1e-3
            return out

        serving.InferenceProgram.forward = altered
    elif fault == "unchanged":
        train_lib.Optimizer.step = lambda self: None
    elif fault == "half_batch":
        loss = train_lib.detector_loss

        def half(model, cfg, batch, bn_momentum):
            rows = batch["points"].shape[0] // 2
            return loss(model, cfg, {k: v[:rows] for k, v in batch.items()},
                        bn_momentum)

        train_lib.detector_loss = half
    elif fault == "stale_inputs":
        replay = train_lib.DetectorTrainBlock._replay
        train_lib.DetectorTrainBlock._replay = \
            lambda self, batches: replay(self, None)
    else:
        raise SystemExit(f"unknown fault {fault!r}")


if __name__ == "__main__":
    root, repo, fault, device = sys.argv[1:5]
    sys.path[:0] = [root, repo]
    from portbench import harness

    plant(fault)
    sys.exit(harness.main(sys.argv[5:], device=device))
