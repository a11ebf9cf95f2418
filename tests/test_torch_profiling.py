"""The port's `utils/profiling.py` and `utils/cache.py`, on the CPU, as
tests/test_runtime.py holds the reference's cache: `time_fn` gives a
positive best-of time, `trace` writes a Chrome trace under its directory
(by default a new one for each call), and `enable_persistent_cache` chooses the kernel library's directory in
the order explicit argument, directory already chosen,
$RAYMARCH_TPU_CACHE_DIR, default."""

import json
import os
import shutil
import tempfile

import pytest
import torch

from raymarch_tpu_torch import _build
from raymarch_tpu_torch.utils import enable_persistent_cache, profiling, rays_per_second, time_fn, trace

torch.set_num_threads(1)


def test_time_fn_is_positive_and_waits_for_the_output():
    calls = []

    def fn(x):
        calls.append(1)
        return {"img": x * 2.0, "parts": (x.sum(), [x.mean()])}

    x = torch.ones(64, 64)
    t = time_fn(fn, x, warmup=1, iters=3)
    assert t > 0 and len(calls) == 4
    assert rays_per_second(fn, 4096, x, warmup=0, iters=2) > 0
    # Every leaf is read: nested containers and dataclasses.
    assert len(list(profiling._leaves(fn(x)))) == 3


def test_trace_writes_a_chrome_trace(tmp_path):
    d = tmp_path / "trace"
    with trace(str(d)) as log_dir:
        assert log_dir == str(d)
        torch.ones(32, 32).matmul(torch.ones(32, 32))
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(d / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def test_trace_default_directory_is_new_for_each_call():
    dirs = []
    try:
        for _ in range(2):
            with trace() as d:
                dirs.append(d)
                torch.ones(8, 8).sum()
        assert dirs[0] != dirs[1]
        for d in dirs:
            assert os.path.dirname(d) == tempfile.gettempdir()
            files = os.listdir(d)
            assert len(files) == 1 and files[0].endswith(".json")
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)


@pytest.fixture
def default_dir(monkeypatch):
    """The kernel library's directory as a fresh process has it."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.DEFAULT_BUILD_DIR)
    monkeypatch.delenv("RAYMARCH_TPU_CACHE_DIR", raising=False)


def test_cache_default_is_the_build_directory(default_dir):
    assert enable_persistent_cache() == str(_build.DEFAULT_BUILD_DIR)
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR


def test_cache_order(default_dir, monkeypatch, tmp_path):
    env, explicit, other = (str(tmp_path / n) for n in ("env", "explicit", "other"))
    monkeypatch.setenv("RAYMARCH_TPU_CACHE_DIR", env)
    assert enable_persistent_cache() == env  # the environment, over the default
    assert str(_build.BUILD_DIR) == env and os.path.isdir(env)
    assert enable_persistent_cache(explicit) == explicit  # an explicit directory wins
    assert str(_build.BUILD_DIR) == explicit
    monkeypatch.setenv("RAYMARCH_TPU_CACHE_DIR", other)
    assert enable_persistent_cache() == explicit  # a directory already chosen is kept
    assert not os.path.exists(other)


def test_cache_that_cannot_be_created_returns_none(default_dir, tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    assert enable_persistent_cache(str(blocker / "cache")) is None
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
