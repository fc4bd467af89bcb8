#!/usr/bin/env python3
"""The benchmark of tpu3dsad_torch, the PyTorch / CUDA port, on one card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It runs the cell named in BENCHMARK.json
(workloads/<cell>.json) for --seconds after its set-up and prints, as the
last line of standard output, one JSON object: correct, attempted, failed,
the cell's end-to-end metrics (--trace 0) or its per-layer metrics read
from a torch.profiler trace (--trace 1), the device, and the numbers
compared with the plain reference beside their limits (also the last
lines of standard error). Without a CUDA device, or with fewer than the
cell asks for, it exits with 2 and prints no result.

Build and kernel caches stay inside the checkout at fixed paths: the
port's nvcc library in build/tpu3dsad_torch/, Triton's and Inductor's
caches under build/portbench/.
"""

import time

START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" / "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(
    ROOT / "build" / "portbench" / "inductor")
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(start=START))
