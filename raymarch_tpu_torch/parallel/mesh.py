"""The ranks of a row-sharded job, and their start-up.

Port of `raymarch_tpu/parallel/mesh.py`. JAX runs one controller over a
`Mesh` of devices; PyTorch runs one process per device over
`torch.distributed`, and the port takes the second: a `Mesh` here is this
process's view of the job, its process group, its rank, the world size and
its device. `mesh.shape[RAY_AXIS]` is the world size, so code written
against the reference's 1-D mesh reads the same.

Without an initialized process group the world is this one process (the
single-device path). With one, the world is the group: start it with
`torchrun --nproc_per_node=N` (which sets MASTER_ADDR, MASTER_PORT, RANK,
WORLD_SIZE and LOCAL_RANK) and `initialize_multihost()`, or pass the
address, the world size and the rank to `initialize_multihost` yourself.

A mesh of part of the world, `make_mesh(n)` with 1 < n < world, is the
reference's first n devices: ranks 0..n-1 on a `dist.new_group`. JAX's
single controller leaves the other devices idle; here the other ranks are
processes of their own, which every rank's `make_mesh(n)` call reaches
(`new_group` is collective over the whole world), and which get a mesh
with `member` False that nothing can be built on.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..ops.cuda_prepass import resolve_device

RAY_AXIS = "rays"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the job: `group` (None for a mesh of this
    process alone), `rank` (this process's rank in the mesh; None on a rank
    of the world outside it), `size` (the mesh's ranks) and `device`, the
    device this rank renders on."""

    group: Optional[object]
    rank: Optional[int]
    size: int
    device: torch.device

    @property
    def shape(self) -> dict:
        return {RAY_AXIS: self.size}

    @property
    def member(self) -> bool:
        """Whether this process is one of the mesh's ranks."""
        return self.rank is not None


# The groups of the meshes of part of the world, by size: a second
# make_mesh(n) creates no group. Cleared when the world is a new one (a
# process group destroyed and initialized again).
_GROUPS: dict = {"world": None, "by_size": {}}


def _part_group(n: int):
    world = dist.group.WORLD
    if _GROUPS["world"] is not world:
        _GROUPS["world"], _GROUPS["by_size"] = world, {}
    if n not in _GROUPS["by_size"]:
        _GROUPS["by_size"][n] = dist.new_group(ranks=list(range(n)))
    return _GROUPS["by_size"][n]


def _rank_device(device) -> torch.device:
    """`device`; by default "cuda" alone, or in a group this rank's card,
    cuda:{LOCAL_RANK % device_count()}."""
    if device is not None:
        return resolve_device(device)
    if not dist.is_initialized():
        return resolve_device("cuda")
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: CUDA is not available; pass device='cpu' to run the plain versions")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return resolve_device(f"cuda:{local % torch.cuda.device_count()}")


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None, *, device=None) -> Mesh:
    """The mesh of this job's ranks along RAY_AXIS.

    With no initialized process group: a world of this process on `device`
    (default "cuda"). With one: the mesh of `n_devices` ranks (or
    `len(devices)`, the reference's device list; default the world), and
    this rank's device is `device`, by default cuda:{LOCAL_RANK %
    device_count()}; it is the CPU only when the caller asks.

    - n = the world: every rank, on the world's group.
    - n = 1: this rank alone (no group; in a world of one process group,
      the world's group, so its reduction runs through the backend).
    - 1 < n < the world: ranks 0..n-1, as the reference's first n devices,
      on a `dist.new_group` (one per n, made at the first call). Creating
      a group is collective over the WHOLE world: every rank must call
      `make_mesh(n)`, in the same order as the others, those outside the
      mesh too, or the job deadlocks. A rank outside gets a mesh with
      `member` False (`rank` None): the renderers, fit steps and
      checkpointers refuse it with ValueError, before any collective.

    Asking for more than the world raises ValueError, as the reference's
    make_mesh does."""
    if devices is not None:
        n_devices = len(devices)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(
            f"make_mesh: {n} devices requested but the world has {world} process(es): start one process "
            "per device (torchrun --nproc_per_node=N, or initialize_multihost) first"
        )
    if n < 1:
        raise ValueError(f"make_mesh: a mesh needs at least one rank, got {n}")
    dev = _rank_device(device)
    if dist.is_initialized() and n == world:
        return Mesh(dist.group.WORLD, dist.get_rank(), world, dev)
    if n == 1:
        return Mesh(None, 0, 1, dev)
    group = _part_group(n)
    rank = dist.get_rank()
    return Mesh(group, dist.get_rank(group) if rank < n else None, n, dev)


def require_member(mesh: Mesh, what: str) -> None:
    """Raise ValueError when this rank is outside `mesh`: `what` (a
    renderer, a fit step, a checkpointer) would enter collectives that the
    mesh's ranks run without it."""
    if not mesh.member:
        raise ValueError(
            f"{what}: rank {dist.get_rank()} of the world is outside this mesh of ranks 0..{mesh.size - 1}. "
            f"make_mesh({mesh.size}) is called by every rank of the world; build on the mesh only on the ranks "
            "it holds (mesh.member)"
        )


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    retries: int = 3,
    retry_delay: float = 5.0,
    initialization_timeout: Optional[float] = None,
    *,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """Join the job's process group (`torch.distributed.init_process_group`).

    `coordinator_address` is "host:port" of rank 0, else MASTER_ADDR and
    MASTER_PORT; `num_processes` and `process_id` default to WORLD_SIZE
    and RANK. It returns at once when the group is initialized already, or
    when there is no cluster to join (no address, and `num_processes` None
    or 1). A handshake that fails is retried `retries` times, `retry_delay`
    seconds apart (after a relaunch rank 0 may come up after its workers),
    then the last error is raised. `initialization_timeout` (seconds)
    bounds each attempt.

    `backend` defaults to "nccl" when `device` (default "cuda") is a card
    and "gloo" when it is the CPU. Two ranks on one card need "gloo" with
    CUDA tensors (NCCL refuses a duplicate GPU): the caller names it."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None:
        if num_processes in (None, 1):
            return  # no cluster to join
        raise ValueError(f"initialize_multihost: {num_processes} processes need a coordinator address")
    if num_processes is None or process_id is None:
        raise ValueError("initialize_multihost: give num_processes and process_id (or WORLD_SIZE and RANK)")
    if backend is None:
        backend = "nccl" if resolve_device("cuda" if device is None else device).type == "cuda" else "gloo"
    kwargs = {}
    if initialization_timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(initialization_timeout))
    last = None
    for attempt in range(max(1, retries)):
        try:
            dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                    world_size=int(num_processes), rank=int(process_id), **kwargs)
            return
        except (RuntimeError, ValueError, OSError) as e:  # the store's handshake failed
            last = e
            if attempt + 1 < max(1, retries):
                time.sleep(retry_delay)
    raise last


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum `x` over the mesh's ranks (its group), in place (nothing in a
    mesh of one process). The fit step's one collective, and the
    renderer's gather."""
    require_member(mesh, "all_reduce_sum")
    if mesh.group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x
