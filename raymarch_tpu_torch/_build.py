"""Build the package's CUDA kernels with nvcc and bind them with ctypes.

The sources under `csrc/` compile into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), at the first CUDA
launch. The library lands in `build/raymarch_tpu_torch/` beside the package
(git-ignored); its name carries a hash of the sources and flags, so an edit
rebuilds and an unchanged tree reuses the library built before.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "raymarch_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # leaf_params, row_kind, tape, n_instr, op_param, cam, bound, params,
    # t0_out, status_out, stream
    "rmt_coarse_launch": (_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P),
    # ... params, t0_in, status_in, img, stream
    "rmt_fine_launch": (_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P),
}

_lib = None
# Build record of this process: compiles run, seconds spent, ptxas report.
stats = {"builds": 0, "seconds": 0.0, "ptxas": "", "path": None}


def find_nvcc() -> str:
    """nvcc on PATH, then under $CUDA_HOME/bin, then /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found on PATH, in $CUDA_HOME/bin or in /usr/local/cuda/bin: "
        "the CUDA kernels cannot be built"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load() -> ctypes.CDLL:
    """The kernel library, built on first use in this process."""
    global _lib
    if _lib is not None:
        return _lib
    lib_path = BUILD_DIR / f"librmt_kernels_{_digest()}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
            *(str(s) for s in sorted(CSRC.glob("*.cu"))),
        ]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        stats["seconds"] += time.perf_counter() - t0
        report = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{report}")
        lib_path.with_suffix(".log").write_text(report)
        os.replace(tmp, lib_path)
        stats["builds"] += 1
    log = lib_path.with_suffix(".log")
    stats["ptxas"] = log.read_text() if log.exists() else ""
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    stats["path"] = str(lib_path)
    _lib = lib
    return lib
