"""Metrics logging: one JSON line per record on stdout, and TensorBoard
scalars beside them where asked for and `torch.utils.tensorboard` imports
(tpu3dsad/utils/metrics.py). Without tensorboard it prints one note on
stderr and writes JSON lines only, as the reference does."""

from __future__ import annotations

import json
import sys


class MetricsLogger:
    """active=False (a rank other than the lead of a data-parallel run)
    logs nothing."""

    def __init__(self, tb_dir: str = "", active: bool = True):
        self._tb = None
        self.active = active
        if tb_dir and active:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:  # tensorboard is optional
                print(f"tensorboard unavailable ({e}); JSONL only",
                      file=sys.stderr)
            else:
                self._tb = SummaryWriter(tb_dir)

    def log(self, step: int, scalars: dict, prefix: str = "") -> None:
        """Print {"step": step, prefix+name: value} for the int and float
        scalars, and write them as TensorBoard scalars where enabled."""
        if not self.active:
            return
        values = {f"{prefix}{k}": v for k, v in scalars.items()
                  if isinstance(v, (int, float))}
        print(json.dumps({"step": step, **values}), flush=True)
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, v, step)

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()
