"""Build the package's CUDA kernels with nvcc and bind them with ctypes.

The sources under `csrc/` compile into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), at the first CUDA
launch: one nvcc per source, all started together, then one link. The
library lands in `build/raymarch_tpu_torch/` beside the package
(git-ignored), or in the directory `utils.cache.enable_persistent_cache`
chose; its name carries a hash of the sources and flags, so an edit
rebuilds and an unchanged tree reuses the library built before. The ranks of
a job share that directory: a file lock lets one process build while the
others wait, then load what it built.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "raymarch_tpu_torch"
# Where the library is built and looked for at its first load in a process
# (utils/cache.py's enable_persistent_cache moves it).
BUILD_DIR = DEFAULT_BUILD_DIR
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Flags of single sources. The backward replays the forward's scene
# evaluations at points where its result is ill-conditioned (taps that
# straddle a CSG crease, grazing rays near the IFT clamp, with per-ray
# gradients 100x the typical one): without FMA contraction its f32 ops round
# as its plain torch version's do, op for op, and the two agree to the
# rounding of the gradient sums instead of to the placement of FMAs. The
# soft fine builds likewise: their closest approach is an argmin over a
# grazing ray's samples, which an FMA's rounding moves by a whole step. So
# do the flat march kernels K5-K7, whose steps per ray are held equal to
# their plain versions' on every ray, and every build of the coarse and fine
# kernels K1/K2 and of the unpacked fine pass K4, whose planes and (t, hit)
# are held equal to theirs, and of the chained pixel kernel K3, whose planes
# are held equal to coarse_px_plain's.
K12_SOURCES = ("prepass.cu", "fine_culled.cu", "prepass_dyn.cu", "fine_dyn_gated.cu", "fine_soft.cu",
               "fine_march.cu", "fine_march_dyn.cu", "intervals_wide.cu", "coarse_px.cu")
# The flat march kernels K5-K7, one source per output (csrc/march.cuh).
MARCH_SOURCES = ("march.cu", "march_render.cu", "march_pixel.cu")
# The unpacked fine pass K4, one source per culling mode (csrc/fine_unpacked.cuh).
K4_SOURCES = ("fine_unpacked.cu", "fine_unpacked_lists.cu", "fine_unpacked_gated.cu", "fine_unpacked_dyn.cu",
              "fine_unpacked_dyn_gated.cu")
SOURCE_FLAGS = {name: ("-fmad=false",)
                for name in ("fused_bwd.cu", "compact_bwd.cu", *MARCH_SOURCES, *K12_SOURCES, *K4_SOURCES)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # leaf_params, row_kind, words, n_instr, op_param, dyn, stk,
    # stack_depth, cam, bound, params, cull, t0_out, status_out,
    # block_params, stream
    "rmt_coarse_launch": (_P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P),
    # leaf_params, row_kind, words, n_instr, op_param, dyn, stk,
    # stack_depth, cam, bound, params, t_blk, status_blk, t0_out,
    # status_out, block_params, stream
    "rmt_coarse_px_launch": (_P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    # leaf_params, row_kind, words, n_instr, op_param, dyn, stk,
    # stack_depth, cam, bound, params, cull, t0_in, status_in, img, t_out,
    # hit_out, mats, block_params, soft, soft_params, stream
    "rmt_fine_launch": (_P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P,
                        _P),
    # leaf_params, row_kind, words, n_instr, op_param, dyn, stk,
    # stack_depth, cam, bound, params, cull, t0_in, status_in, img, t_out,
    # hit_out, mats, shared, max_lanes, block_params, stream
    "rmt_fine_unpacked_launch": (_P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _P, _P),
    # leaf_params, packed tape, n_instr, op_param, shape (host int[7]), cam,
    # params, grad_denom_clamp, t, hit, g_img, mats, soft, rec, partials,
    # max_blocks, out, stream
    "rmt_fused_bwd_launch": (
        _P, _P, _I, _P, _P, _P, _P, ctypes.c_float, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P,
    ),
    # leaf_params, row_kind, tape, n_instr, op_param, cull, cam, params,
    # grad_denom_clamp, t, hit, g_img, shape (host int[8]), mats, soft,
    # hist, tile_next, partials, max_blocks, n_blocks (int*), out, stream
    "rmt_compact_bwd_launch": (
        _P, _P, _P, _I, _P, _P, _P, _P, ctypes.c_float, _P, _P, _P, _P, _I,
        _P, _P, _P, _P, _I, _P, _P, _P,
    ),
    # partials, n_blocks, nscal, out, stream
    "rmt_bwd_finalize_launch": (_P, _I, _I, _P, _P),
    # leaf_params, row_kind, words, n_instr, op_param, dyn, stk,
    # stack_depth, mats, origins, dirs, cam, bound, params, n, out, o0, o1,
    # o2, steps, stream
    "rmt_march_launch": (_P, _P, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P),
}

_lib = None
# Build record of this process: compiles run, seconds spent (and per
# source, from the common start to that nvcc's exit), ptxas report.
stats = {"builds": 0, "seconds": 0.0, "source_seconds": {}, "ptxas": "", "path": None}
# Held around the check, the build and the load: the tiered runtime renders
# on one thread while it warms another tier's renderer on a second, and the
# first use on either must not run nvcc twice or publish a half-set `_lib`.
_LOCK = threading.Lock()


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
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(lib_path: Path) -> str:
    """nvcc every csrc/*.cu to an object in parallel, link them into
    `lib_path`; returns the compilers' report (ptxas -v)."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        t0 = time.perf_counter()
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, ()), "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        outs = {}

        def finish(src, proc):
            outs[src] = proc.communicate()[0]
            stats["source_seconds"][src.name] = round(time.perf_counter() - t0, 1)

        waiters = [threading.Thread(target=finish, args=(src, proc)) for src, _, proc in procs]
        for w in waiters:
            w.start()
        for w in waiters:
            w.join()
        report = []
        for src, _, proc in procs:
            report.append(outs[src])
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{outs[src]}")
        out_tmp = Path(tmp) / lib_path.name
        link = [nvcc, *ARCH, "-shared", "-o", str(out_tmp), *(str(o) for _, o, _ in procs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(out_tmp, lib_path)
    return "".join(report)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use in this process; safe to call
    from several threads at once (one builds, the others wait for it)."""
    if _lib is not None:
        return _lib
    with _LOCK:
        return _lib if _lib is not None else _load_locked()


@contextlib.contextmanager
def build_lock(directory: Path):
    """Hold an exclusive lock on `directory`/build.lock across processes
    (`fcntl.flock`: the kernel releases it when its holder exits, killed or
    not, so no stale lock survives a lost build)."""
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / "build.lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _ensure_built(lib_path: Path) -> None:
    """Build `lib_path` unless it exists. Processes that start at once (the
    ranks of a job) take the file lock in turn: the first builds, the
    others find the library when they get the lock."""
    if lib_path.exists():
        return
    with build_lock(lib_path.parent):
        if lib_path.exists():
            return
        t0 = time.perf_counter()
        report = _compile(lib_path)
        stats["seconds"] += time.perf_counter() - t0
        lib_path.with_suffix(".log").write_text(report)
        stats["builds"] += 1


def _load_locked() -> ctypes.CDLL:
    global _lib
    lib_path = BUILD_DIR / f"librmt_kernels_{_digest()}.so"
    _ensure_built(lib_path)
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
