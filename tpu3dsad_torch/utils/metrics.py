"""Metrics logging: one JSON line per record on stdout
(tpu3dsad/utils/metrics.py; the optional TensorBoard writer is not
ported)."""

from __future__ import annotations

import json


class MetricsLogger:
    def log(self, step: int, scalars: dict, prefix: str = "") -> None:
        """Print {"step": step, prefix+name: value} for the int and float
        scalars."""
        rec = {"step": step}
        rec.update({f"{prefix}{k}": v for k, v in scalars.items()
                    if isinstance(v, (int, float))})
        print(json.dumps(rec), flush=True)
