"""Where the port's compiled kernels persist across processes.

Port of `raymarch_tpu/utils/cache.py` (24-52). The reference points JAX's
persistent compilation cache at a directory, so that a restarted process
skips XLA for every topology it compiled before. The port compiles no
program per topology: its kernels are one library, built by nvcc at the
first CUDA launch and named by the digest of its sources and flags
(`_build.py`). Its counterpart of the XLA cache is therefore the directory
that library is built into and looked for in: a process that finds the
library of its sources there loads it and runs no nvcc. Nothing else is
configured: no torch setting and no environment variable is touched.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional


def enable_persistent_cache(cache_dir: Optional[str] = None) -> Optional[str]:
    """Choose the directory of the kernel library.

    An explicit `cache_dir` always wins. With `cache_dir=None` a directory
    already chosen (by an earlier call, or by setting `_build.BUILD_DIR`)
    is kept; otherwise `$RAYMARCH_TPU_CACHE_DIR`, else the default
    `build/raymarch_tpu_torch/` beside the package (git-ignored). The
    choice takes effect at the library's first load in this process.
    Returns the active directory, or None when it cannot be created (the
    cache is an optimization, never a requirement: the library is then
    built where it was to be built)."""
    from .. import _build

    if cache_dir is None:
        if _build.BUILD_DIR != _build.DEFAULT_BUILD_DIR:
            return str(_build.BUILD_DIR)
        cache_dir = os.environ.get("RAYMARCH_TPU_CACHE_DIR") or str(_build.DEFAULT_BUILD_DIR)
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError:
        return None
    _build.BUILD_DIR = Path(cache_dir)
    return str(cache_dir)
