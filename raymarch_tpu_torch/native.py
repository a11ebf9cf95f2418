"""ctypes bindings for the native (C++) tape core.

A copy of `raymarch_tpu.native` (numpy only), binding the same library:
`native/tape_core.cpp`, the C++ counterpart of the reference's native
(Rust) tape builder and scene model: wire-tape validation, a second
independent oracle evaluator/marcher, and a native fast-path encoder for
large procedural scenes. It loads `native/libtape_core.so` as it stands and
never writes into `native/`: where that library is missing it builds one
from `native/tape_core.cpp` with g++ into `build/raymarch_tpu_torch/`
(git-ignored). Every entry point has a pure-Python/NumPy fallback (the
port's `ops.oracle`, `ops.tape`, `models.csg`), so the package works
without a toolchain; `available()` says whether the library is the one
that runs. tests/test_torch_native.py holds the two copies equal.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libtape_core.so")
_BUILD_PATH = os.path.join(_ROOT, "build", "raymarch_tpu_torch", "libtape_core.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    """Builds native/tape_core.cpp into build/raymarch_tpu_torch/ (the
    Makefile's flags but -march=native) -> the library's path, or None
    without a compiler or on a failed build."""
    src = os.path.join(_NATIVE_DIR, "tape_core.cpp")
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None or not os.path.exists(src):
        return None
    os.makedirs(os.path.dirname(_BUILD_PATH), exist_ok=True)
    tmp = f"{_BUILD_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx, "-O3", "-fPIC", "-std=c++17", "-shared", "-o", tmp, src],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, _BUILD_PATH)
    except (OSError, subprocess.SubprocessError):
        return None
    return _BUILD_PATH


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = next((p for p in (_LIB_PATH, _BUILD_PATH) if os.path.exists(p)), None) or _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None

    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

    lib.tape_validate.restype = ctypes.c_int64
    lib.tape_validate.argtypes = [u32p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)]
    lib.tape_eval.restype = ctypes.c_int32
    lib.tape_eval.argtypes = [
        u32p, ctypes.c_int64, f32p, ctypes.c_int64, ctypes.c_float, f32p,
    ]
    lib.tape_march.restype = ctypes.c_int32
    lib.tape_march.argtypes = [
        u32p, ctypes.c_int64, f32p, f32p, ctypes.c_int64,
        ctypes.c_float, ctypes.c_float, ctypes.c_int32, f32p, u8p,
    ]
    lib.tape_build_sphere_union.restype = ctypes.c_int64
    lib.tape_build_sphere_union.argtypes = [
        f32p, ctypes.c_int64, u32p, ctypes.c_int64,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    """True when the native library runs the entry points below, False when
    their numpy fallbacks do."""
    return _load() is not None


def validate(tape: np.ndarray) -> tuple[int, int]:
    """(cmd_count, max_stack_depth); raises ValueError on malformed tape."""
    lib = _load()
    tape = np.ascontiguousarray(tape, dtype=np.uint32)
    if lib is None:
        from .ops.tape import compile_wire, wire_cmd_count

        spec, arrays = compile_wire(tape, bucket=False)
        real = arrays.tape_ops != 0
        depth = int(arrays.out_slot[real].max()) + 1 if real.any() else 0
        return wire_cmd_count(tape), depth
    depth = ctypes.c_int32(0)
    n = lib.tape_validate(tape, tape.size, ctypes.byref(depth))
    if n < 0:
        raise ValueError(f"malformed wire tape (native error {n})")
    return int(n), int(depth.value)


def eval_tape(tape: np.ndarray, points: np.ndarray, empty_value: float = 100.0) -> np.ndarray:
    """Native oracle: scene SDF at points[N,3] -> f32[N]."""
    lib = _load()
    if lib is None:
        from .ops import oracle

        return oracle.eval_tape(tape, points)
    tape = np.ascontiguousarray(tape, dtype=np.uint32)
    pts = np.ascontiguousarray(points, dtype=np.float32).reshape(-1, 3)
    out = np.empty(pts.shape[0], dtype=np.float32)
    rc = lib.tape_eval(tape, tape.size, pts, pts.shape[0], empty_value, out)
    if rc != 0:
        raise ValueError(f"malformed wire tape (native error {rc})")
    return out


def march(tape, origins, dirs, min_dist=0.01, max_dist=100.0, max_iter=100):
    """Native oracle sphere-trace -> (t f32[N], hit bool[N])."""
    lib = _load()
    if lib is None:
        from .config import RenderConfig
        from .ops import oracle

        cfg = RenderConfig(min_dist=min_dist, max_dist=max_dist, max_iter=max_iter)
        return oracle.march(tape, origins, dirs, cfg)
    tape = np.ascontiguousarray(tape, dtype=np.uint32)
    o = np.ascontiguousarray(origins, dtype=np.float32).reshape(-1, 3)
    d = np.ascontiguousarray(dirs, dtype=np.float32).reshape(-1, 3)
    t = np.empty(o.shape[0], dtype=np.float32)
    hit = np.empty(o.shape[0], dtype=np.uint8)
    rc = lib.tape_march(
        tape, tape.size, o, d, o.shape[0], min_dist, max_dist, max_iter, t, hit
    )
    if rc != 0:
        raise ValueError(f"malformed wire tape (native error {rc})")
    return t, hit.astype(bool)


def build_sphere_union(spheres: np.ndarray) -> np.ndarray:
    """Fast-path native encoder: spheres f32[N,4] (cx,cy,cz,r) -> wire tape
    of their union (postorder left-leaning chain)."""
    spheres = np.ascontiguousarray(spheres, dtype=np.float32).reshape(-1, 4)
    lib = _load()
    if lib is None:
        from .models.csg import sphere
        from .ops.tape import encode_wire

        node = None
        for cx, cy, cz, r in spheres:
            s = sphere(center=(cx, cy, cz), radius=float(r))
            node = s if node is None else (node | s)
        return encode_wire(node)
    cap = spheres.shape[0] * 6 + 8
    out = np.empty(cap, dtype=np.uint32)
    n = lib.tape_build_sphere_union(spheres, spheres.shape[0], out, cap)
    if n < 0:
        raise RuntimeError("tape_build_sphere_union: buffer too small")
    return out[:n].copy()
