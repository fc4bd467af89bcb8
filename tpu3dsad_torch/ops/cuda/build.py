"""Build and load the hand-written CUDA kernels (csrc/*.cu).

At first use, nvcc compiles each source under tpu3dsad_torch/csrc to an
object, all sources at once in parallel,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas=-v -c -o <obj> csrc/<name>.cu

then links the objects into one shared library with a plain C interface
(`nvcc ... -shared -o build/tpu3dsad_torch/libkernels.so <objs>`), which is
loaded with ctypes (no PyTorch headers, so the build takes seconds). The
build is keyed by a hash of the sources and flags, kept next to the
library; a changed source rebuilds it. Any failure raises: there is no
fallback to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tpu3dsad_torch"
LIB_PATH = BUILD_DIR / "libkernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
_PI = ctypes.POINTER(ctypes.c_int)
# C entry points: name -> argtypes; every one returns a cudaError_t as int
_SIGNATURES = {
    # xyz, mask, dist, idx, b, n, m, candidate plans (3 host ints each:
    # cluster, threads, points a thread), their count, position of the one
    # launched (host int out), stream
    "tpu3dsad_fps": (_P, _P, _P, _P, _I, _I, _I, _PI, _I, _PI, _P),
    # the same for one cloud, without b
    "tpu3dsad_fps_flat": (_P, _P, _P, _P, _I, _I, _PI, _I, _PI, _P),
    # xyz, mask, centers, perm, perm_c, scratch, idx, cnt, b, n, m, k, r2,
    # skip_r2, warps a block, centers a warp, shared loads, stream
    "tpu3dsad_ball_query": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _F, _F, _I, _I, _I, _P),
    # xyz, mask, centers, codes_x, codes_c, b, n, m, stream
    "tpu3dsad_morton_codes": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # g, its batch and row strides (floats), idx, out, b, u, c, n, warps a
    # CTA, channel slices, stream
    "tpu3dsad_scatter_rows": (_P, _LL, _LL, _P, _P, _I, _I, _I, _I, _I, _I,
                              _P),
    # warps a CTA, channel slices, c: CTAs an SM holds (-1: error)
    "tpu3dsad_scatter_occupancy": (_I, _I, _I),
}

_lib: ctypes.CDLL | None = None
build_note: str = ""  # how this process got the library: nvcc time or cached
ptxas_log: str = ""  # nvcc's -Xptxas=-v report (registers, spills, smem)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and PATH); the CUDA "
        "kernels of tpu3dsad_torch cannot be built")


def _nvcc_run(cmd: list[str]) -> str:
    """Run one nvcc command; its output, or raise with it."""
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def _build() -> Path:
    global build_note, ptxas_log
    sources = _sources()
    digest = _digest(sources)
    stamp = LIB_PATH.with_suffix(".sha256")
    if LIB_PATH.exists() and stamp.exists() and stamp.read_text() == digest:
        build_note = "cached (source hash matches)"
        return LIB_PATH
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in sources]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
            logs = list(pool.map(
                _nvcc_run, [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                            for src, obj in zip(sources, objs)]))
        lib = str(Path(tmp) / "libkernels.so")
        _nvcc_run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs])
        build_note = (f"nvcc {time.perf_counter() - t0:.1f} s "
                      f"({len(sources)} sources in parallel)")
        ptxas_log = "".join(logs)
        os.replace(lib, LIB_PATH)
    stamp.write_text(digest)
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.tpu3dsad_error_string.argtypes = (ctypes.c_int,)
        lib.tpu3dsad_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def describe() -> str:
    """One line on the loaded library: where it is and how it was got."""
    library()
    return f"build: {build_note} -> {LIB_PATH}"


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error at launch."""
    if err != 0:
        text = library().tpu3dsad_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {text}")
