"""The system under test as the drivers build and watch it: the port's
detector made from a configuration file with the benchmark's weights, and
the spans the benchmark records around the program's layers (CUDA events
and profiler ranges from forward hooks, a copy of profile_port.py's
hook_events)."""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from portbench.traffic.detection import class_mean_sizes


def build(ctx):
    """(cfg, model, weights): the port's SizeAdaptiveDetector of the
    configuration on the device, its runtime knobs set as the program's
    entries set them (grouping tier, TF32), with the benchmark's seeded
    weights loaded (weights: the benchmark's own copy)."""
    from tpu3dsad_torch import train_lib
    from tpu3dsad_torch.models.detector import SizeAdaptiveDetector

    cfg = ctx.port_config()
    train_lib.apply_runtime_config(cfg)
    model = SizeAdaptiveDetector(cfg.model, device=ctx.device)
    weights = ctx.weights(model)
    return cfg, model, weights


@torch.no_grad()
def calibrate(model, points, mask) -> None:
    """Set every BatchNorm's running averages to the statistics of one
    train-mode forward of the program over (points, mask) (momentum 0:
    the old averages get weight 0), as a trained model's averages are its
    data's statistics; then back to eval mode. Without it the seeded
    weights' max-pools pile up a common offset, level after level, that
    no running mean removes, and every proposal of a scene scores alike."""
    model.train()
    model(points, mask=mask, bn_momentum=0.0)
    model.eval()


def mean_sizes(ctx) -> np.ndarray:
    """The size priors the detector is built with, from the benchmark's own
    copy of them."""
    return class_mean_sizes(ctx.config["model"]["num_classes"])


class Spans:
    """Forward pre/post hooks on the detector: a CUDA event and a profiler
    range at the forward's start and end, then `end()` after the program
    returns. `ms()` gives {"forward", "parse_nms"} device ms a request."""

    def __init__(self, model, on: bool, cuda: bool):
        self.on, self.cuda = on, cuda
        self.marks: list = []
        self.ranges: list = []
        self.handles = []
        if on:
            self.handles = [model.register_forward_pre_hook(self._start),
                            model.register_forward_hook(self._stop)]

    def _event(self):
        if not self.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _start(self, *_):
        self.marks.append([self._event(), None, None])
        self._enter("forward")

    def _stop(self, *_):
        self._exit()
        self.marks[-1][1] = self._event()
        self._enter("parse_nms")

    def end(self):
        if self.on:
            self._exit()
            self.marks[-1][2] = self._event()

    def _enter(self, name):
        rf = record_function(name)
        rf.__enter__()
        self.ranges.append(rf)

    def _exit(self):
        self.ranges.pop().__exit__(None, None, None)

    def reset(self):
        self.marks.clear()

    def ms(self) -> dict:
        """The spans recorded since the last reset (the device synchronised
        since), then a reset: the hooks stay, for the profiler's ranges."""
        out = {}
        if self.cuda and self.marks:
            out = {"forward": [a.elapsed_time(b) for a, b, _ in self.marks],
                   "parse_nms": [b.elapsed_time(c)
                                 for _, b, c in self.marks]}
        self.reset()
        return out


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pinned(a: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if device.type == "cuda" else t
