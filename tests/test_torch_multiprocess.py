"""The port's row-sharded path over two real processes (gloo, CPU).

Mirrors tests/test_multiprocess.py: two Python processes join one process
group through `initialize_multihost` on a free localhost port, render the
row-sharded frame and take a fit step, and their results are held against
the same program in one process (the port's world of one) at the
reference's rtol 1e-5 (test_multiprocess.py:130-133), against each other
(the replicas stay equal), and against the JAX package's program over 4
virtual devices. Also: the kernel build's cross-process file lock
serializes two processes and builds once, and a rank that cannot reach its
coordinator raises after its retries.

`run_world` and `free_port` serve the other spawned-world files
(tests/test_torch_parallel.py, tests/test_torch_elastic.py).
"""

import dataclasses
import functools
import os
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import raymarch_tpu as rm
import raymarch_tpu_torch as rt
from raymarch_tpu.parallel import make_fit_step as make_fit_step_j
from raymarch_tpu.parallel import make_mesh as make_mesh_j
from raymarch_tpu.parallel import make_sharded_renderer as make_sharded_renderer_j
from raymarch_tpu_torch.parallel import initialize_multihost, make_fit_step, make_mesh, make_sharded_renderer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 300  # seconds for a spawned world to finish


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# Each spawned rank runs this, then the caller's body, with `rank`,
# `world`, `out` (its result file), `mesh` and `save(**arrays)` defined.
_PRELUDE = """
import sys
port, rank, world, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
import numpy as np
from raymarch_tpu_torch.parallel import RAY_AXIS, initialize_multihost, make_mesh

initialize_multihost(f"localhost:{{port}}", world, rank, retries=5, retry_delay=1.0, device="cpu")
mesh = make_mesh(device="cpu")
assert mesh.shape[RAY_AXIS] == world and mesh.rank == rank, mesh


def save(**arrays):
    np.savez(out, **{{k: np.asarray(v) for k, v in arrays.items()}})
"""


def launch_world(body: str, world: int, out_dir, args=(), port=None):
    """Start `world` ranks of `body` (source run after _PRELUDE); rank r
    writes `out_dir`/rank{r}.npz. Returns the processes."""
    src = _PRELUDE.format(repo=REPO) + textwrap.dedent(body)
    port = free_port() if port is None else port
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    return [
        subprocess.Popen(
            [sys.executable, "-c", src, str(port), str(r), str(world), os.path.join(str(out_dir), f"rank{r}.npz"),
             *map(str, args)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True,
        )
        for r in range(world)
    ]


def join_world(procs, timeout=WORLD_TIMEOUT):
    """Wait for every rank (each with its own timeout); a rank that fails
    or hangs fails the caller, and no rank is left running. Returns each
    rank's (stdout, stderr)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed rc={p.returncode}\nstdout:\n{out}\nstderr:\n{err}"
    return outs


def load_world(out_dir, world):
    out = []
    for r in range(world):
        with np.load(os.path.join(str(out_dir), f"rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


def run_world(body, world, out_dir, args=()):
    join_world(launch_world(body, world, out_dir, args))
    return load_world(out_dir, world)


# --- the reference's two-process program (test_multiprocess.py:20-57) ------

def _scene(m):
    return m.sphere(center=(-0.5, 0.0, 0.0), radius=0.8) | m.box(center=(0.7, 0.0, 0.0), half_extents=(0.4, 0.4, 0.4))


CFG = dataclasses.replace(rm.DEFAULT_CONFIG, aa_samples=2, max_iter=48)
CFG_T = rt.RenderConfig(**dataclasses.asdict(CFG))
CAM = rm.Camera.looking_at(position=(0.0, 1.2, 3.5), target=(0.0, 0.0, 0.0))
CAM_T = rt.Camera(CAM.position, CAM.rotation)
W = H = 32
# The fused step of this file: bound_accel, an uneven split (36 rows in 2 x 2
# bands of 9), and Adam.
CFG_F = dataclasses.replace(CFG_T, max_iter=120, min_dist=1e-3, bound_accel=True)
HF = 36


def _port_program(mesh, spec, arrays, k_fused=2):
    """The port's program on `mesh`: the jnp frame and SGD step of the
    reference's worker, the pallas_prepass frame at row_interleave 2 and a
    pallas_fused Adam step at `k_fused`."""
    img = make_sharded_renderer(spec, W, H, mesh, CFG_T)(arrays, CAM_T)
    step = make_fit_step(spec, W, H, mesh, functools.partial(torch.optim.SGD, lr=1e-2), CFG_T)
    a2, _, _, loss = step(arrays, CAM_T, step.init_opt_state(arrays), np.zeros((H, W, 3), np.float32))
    img_p = make_sharded_renderer(spec, W, HF, mesh, CFG_F, backend="pallas_prepass", row_interleave=2)(
        arrays, CAM_T)
    step_f = make_fit_step(spec, W, HF, mesh, functools.partial(torch.optim.Adam, lr=1e-2), CFG_F,
                           backend="pallas_fused", row_interleave=k_fused, fit_camera=True)
    a3, cam3, _, loss_f = step_f(arrays, CAM_T, step_f.init_opt_state(arrays, CAM_T),
                                 np.full((HF, W, 3), 0.2, np.float32))
    return dict(img=img, loss=loss, lp=a2.leaf_params, img_p=img_p, loss_f=loss_f, lp_f=a3.leaf_params,
                op_f=a3.op_param, pos_f=cam3.position, rot_f=cam3.rotation)


_BODY = """
import dataclasses, functools
import raymarch_tpu_torch as rt
from raymarch_tpu_torch.parallel import make_fit_step, make_sharded_renderer
{scene}
{program}
CFG_T = rt.RenderConfig(aa_samples=2, max_iter=48)
CFG_F = dataclasses.replace(CFG_T, max_iter=120, min_dist=1e-3, bound_accel=True)
CAM_T = rt.Camera.looking_at(position=(0.0, 1.2, 3.5), target=(0.0, 0.0, 0.0))
W = H = 32
HF = 36
spec, arrays = rt.compile_scene(_scene(rt), static=True)
res = _port_program(mesh, spec, arrays)
save(**{{k: v.detach() if torch.is_tensor(v) else v for k, v in res.items()}})
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    import inspect

    out = tmp_path_factory.mktemp("world2")
    body = _BODY.format(scene=inspect.getsource(_scene), program=inspect.getsource(_port_program))
    procs = launch_world(body, 2, out)
    # The single-process programs run while the ranks do.
    spec, arrays = rt.compile_scene(_scene(rt), static=True)
    one = {k: v.detach().numpy() for k, v in _port_program(make_mesh(device="cpu"), spec, arrays).items()}
    spec_j, arrays_j = rm.compile_scene(_scene(rm), static=True)
    mesh_j = make_mesh_j(4)
    img_j = np.asarray(jax.jit(make_sharded_renderer_j(spec_j, W, H, mesh_j, CFG))(arrays_j, CAM))
    step_j = make_fit_step_j(spec_j, W, H, mesh_j, optax.sgd(1e-2), CFG)
    a_j, _, _, loss_j = jax.jit(step_j)(arrays_j, CAM, step_j.init_opt_state(arrays_j),
                                        jnp.zeros((H, W, 3), jnp.float32))
    join_world(procs)
    ranks = load_world(out, 2)
    return ranks, one, (img_j, float(loss_j), np.asarray(a_j.leaf_params))


def test_two_process_distributed_matches_single(two_ranks):
    ranks, one, _ = two_ranks
    mp = ranks[0]
    np.testing.assert_allclose(mp["img"].sum(), one["img"].sum(), rtol=1e-5)
    np.testing.assert_allclose(float(mp["loss"]), float(one["loss"]), rtol=1e-5)
    np.testing.assert_allclose(mp["lp"].sum(), one["lp"].sum(), rtol=1e-5)
    # Each pixel is one rank's band, gathered exactly.
    np.testing.assert_array_equal(mp["img"], one["img"])


@pytest.mark.parametrize("key", ["img_p", "loss_f", "lp_f", "op_f", "pos_f", "rot_f"])
def test_two_process_fused_matches_single(two_ranks, key):
    """The pallas_prepass frame at row_interleave 2 and a pallas_fused Adam
    step (fit_camera) over 2 ranks x 2 bands, against one process."""
    ranks, one, _ = two_ranks
    np.testing.assert_allclose(ranks[0][key], one[key], rtol=1e-5, atol=1e-7)


def test_replicas_stay_equal(two_ranks):
    ranks, _, _ = two_ranks
    for key in ranks[0]:
        np.testing.assert_array_equal(ranks[1][key], ranks[0][key], err_msg=key)


def test_two_process_matches_jax(two_ranks):
    """Against the reference's program over 4 virtual devices: the frame in
    the jnp renderer's exact-semantics class, the loss and the updated
    parameters in the fit step's (tests/test_torch_fit.py)."""
    ranks, _, (img_j, loss_j, lp_j) = two_ranks
    assert np.abs(ranks[0]["img"] - img_j).max() < 1e-3
    assert float(ranks[0]["loss"]) == pytest.approx(loss_j, rel=1e-4)
    np.testing.assert_allclose(ranks[0]["lp"], lp_j, atol=1e-5)


def test_initialize_multihost_without_a_cluster_returns():
    import torch.distributed as dist

    initialize_multihost()  # no address, no WORLD_SIZE: nothing to join
    initialize_multihost(num_processes=1)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        initialize_multihost(num_processes=2, process_id=0)


def test_initialize_multihost_raises_after_retries():
    """Rank 1 of a world whose rank 0 never comes up: each attempt times
    out, and the last error is raised after the retries."""
    t0 = time.perf_counter()
    with pytest.raises((RuntimeError, OSError)):
        initialize_multihost(f"localhost:{free_port()}", 2, 1, retries=2, retry_delay=0.2,
                             initialization_timeout=1.0, device="cpu")
    assert time.perf_counter() - t0 >= 1.0  # it waited, then retried
    import torch.distributed as dist

    assert not dist.is_initialized()


def test_mesh_of_more_devices_than_the_world_raises():
    with pytest.raises(ValueError, match="requested"):
        make_mesh(2, device="cpu")
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"rays": 1} and mesh.group is None and mesh.device == torch.device("cpu")


_LOCK_BODY = r"""
import json, time
from pathlib import Path
from raymarch_tpu_torch import _build

d = Path(sys.argv[5])


def stub_compile(lib_path):
    # The build: long enough for the other process to arrive meanwhile.
    with open(d / "compiles.txt", "a") as f:
        f.write(f"{rank}\n")
    time.sleep(0.5)
    lib_path.write_text("built")
    return "stub report"


_build._compile = stub_compile
t0 = time.time()
_build._ensure_built(d / "libstub.so")
t1 = time.time()
with _build.build_lock(d):
    a = time.time()
    time.sleep(0.3)
    b = time.time()
save(ensure=np.array([t0, t1]), held=np.array([a, b]))
"""


def test_build_lock_serializes_processes(tmp_path):
    """Two processes that reach the first-use build at once build once: the
    second waits on the file lock and finds the library; and two holders
    of the lock never overlap. The compile is a stub (no nvcc here)."""
    out = tmp_path / "out"
    out.mkdir()
    ranks = run_world(_LOCK_BODY, 2, out, args=(tmp_path,))
    assert (tmp_path / "compiles.txt").read_text().split() in (["0"], ["1"])
    assert (tmp_path / "libstub.so").read_text() == "built"
    (a0, b0), (a1, b1) = ranks[0]["held"], ranks[1]["held"]
    assert b0 <= a1 or b1 <= a0, (a0, b0, a1, b1)
