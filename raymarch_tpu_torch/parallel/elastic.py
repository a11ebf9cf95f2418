"""Checkpoints and stall detection for long fit runs.

Port of `raymarch_tpu/parallel/elastic.py` (50-222). The recoverable unit
is the job: a lost rank cannot be spliced out of a running process group,
so the job dies, is relaunched, and resumes from the last checkpoint.

- **FitCheckpointer**: atomic, versioned checkpoints of the full fit state
  (TapeArrays, camera pose, optimizer state, loss history). A write goes to
  a temporary file, then `os.replace` publishes it, so a crash mid-write
  never corrupts the latest checkpoint; `keep` bounds disk use; a
  checkpoint written for another TapeSpec refuses to restore. In a job of
  several ranks only the mesh's rank 0 writes, into storage every rank of
  the mesh reads, and every rank of the mesh restores from it; ranks
  outside a mesh of part of the world take no part.
- **Watchdog**: a background thread watches step heartbeats and, after
  `timeout` seconds of silence, calls `on_stall`; `exit_code` turns that
  into a hard exit, so a supervisor relaunches the job into the resume
  path. It stays per process: a peer's death shows up here as a wedged
  collective (the step's all_reduce waits on the dead rank), which
  `exit_code` turns into a restart.
- **fit_scene(..., checkpoint_dir=, resume=True)** (fit.py) wires both into
  the fit loop.
"""

from __future__ import annotations

import io
import os
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..io import _host, _spec_fingerprint
from ..ops.tape import TapeArrays, TapeSpec, arrays_from_streams

_PREFIX = "fitckpt_"


class FitCheckpointer:
    """Atomic npz checkpoints of fit state in `directory`.

    State = (step, TapeArrays, camera, optimizer state, loss history). The
    optimizer state (`FitOptState.state_dict()`, tensors and numbers) is
    stored as the bytes `torch.save` writes, and restored into a TEMPLATE
    state from `step.init_opt_state`, whose optimizers and parameters live
    on the fit's device. Checkpoints are keyed by step; the `keep` most
    recent are retained.

    `mesh` (a `Mesh` of make_mesh) is the fit's ranks: its rank 0 writes,
    and `restore` agrees on the step over the mesh's group. None is the
    world: rank 0 of the process group writes and every rank of it
    restores (a world of one process: this process). `directory` must be
    storage every rank of the mesh reads; meshes that fit on their own
    (make_mesh(1) on several ranks) need a directory each. A rank outside
    the mesh gets ValueError.
    """

    def __init__(self, directory: str, keep: int = 3, mesh=None):
        from .mesh import require_member

        if mesh is not None:
            require_member(mesh, "FitCheckpointer")
        self.directory = directory
        self.keep = max(1, int(keep))
        self.mesh = mesh
        os.makedirs(directory, exist_ok=True)

    def _is_writer(self) -> bool:
        if self.mesh is not None:
            return self.mesh.rank == 0
        return not dist.is_initialized() or dist.get_rank() == 0

    def _agree(self, step: Optional[int], device) -> Optional[int]:
        """The step the writer found, on every rank of the mesh (a
        broadcast from the writer over the mesh's group)."""
        if self.mesh is None:
            if not (dist.is_initialized() and dist.get_world_size() > 1):
                return step
            group, src = None, 0
        else:
            if self.mesh.group is None or self.mesh.size == 1:
                return step
            group = self.mesh.group
            src = dist.get_global_rank(group, 0)
        agreed = torch.tensor([-1 if step is None else step], dtype=torch.int64, device=device)
        dist.broadcast(agreed, src, group=group)
        return None if int(agreed) < 0 else int(agreed)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{_PREFIX}{step:08d}.npz")

    def _steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith(_PREFIX) and name.endswith(".npz"):
                try:
                    out.append(int(name[len(_PREFIX):-4]))
                except ValueError:
                    continue
        return sorted(out)

    def save(self, step, spec, arrays, camera, opt_state, losses) -> Optional[str]:
        """Write the checkpoint of `step`; returns its path (None on the
        ranks that do not write)."""
        if not self._is_writer():
            return None
        buf = io.BytesIO()
        torch.save(opt_state.state_dict(), buf)
        payload = {
            "step": np.asarray(int(step)),
            "spec": np.frombuffer(_spec_fingerprint(spec).encode("utf-8"), dtype=np.uint8),
            "leaf_params": _host(arrays.leaf_params),
            "tape_ops": _host(arrays.tape_ops),
            "tape_arg": _host(arrays.tape_arg),
            "op_param": _host(arrays.op_param),
            "out_slot": _host(arrays.out_slot),
            "cam_position": _host(camera.position),
            "cam_rotation": _host(camera.rotation),
            "losses": np.asarray(losses, dtype=np.float64),
            "opt_state": np.frombuffer(buf.getvalue(), dtype=np.uint8),
        }
        path = self._path(int(step))
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)  # atomic publish
        for old in self._steps()[: -self.keep]:
            try:
                os.remove(self._path(old))
            except OSError:  # pragma: no cover - concurrent cleanup
                pass
        return path

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(
        self, spec: TapeSpec, opt_state_template
    ) -> Optional[Tuple[int, TapeArrays, object, object, List[float]]]:
        """Load the newest checkpoint -> (step, arrays, camera, opt_state,
        losses), or None if the directory has no checkpoint. The optimizer
        state is loaded into `opt_state_template`, which is returned. Raises
        if the checkpoint belongs to a different TapeSpec (the topology
        changed: a stale checkpoint must not poison a new run).

        Every rank of the mesh takes the step its writer finds (a
        broadcast of the writer's `latest_step()`): a rank that lists the
        directory while the writer publishes a newer checkpoint, or that
        sees a stale listing of shared storage, still resumes where the
        others do."""
        # The rank's device: NCCL takes no CPU tensor.
        step = self._agree(self.latest_step(), opt_state_template.params[0].device)
        if step is None:
            return None
        from ..utils.camera import Camera

        with np.load(self._path(step)) as z:
            saved = bytes(z["spec"].tobytes()).decode("utf-8")
            if saved != _spec_fingerprint(spec):
                raise ValueError(
                    "checkpoint belongs to a different TapeSpec (scene "
                    "topology/bucketing changed); clear the checkpoint "
                    "directory or recompile the matching scene"
                )
            arrays = arrays_from_streams(
                spec,
                z["leaf_params"],
                z["tape_ops"],
                z["tape_arg"],
                z["op_param"],
                z["out_slot"],
            )
            camera = Camera(position=z["cam_position"], rotation=z["cam_rotation"])
            state = torch.load(io.BytesIO(z["opt_state"].tobytes()), weights_only=True)
            losses = [float(x) for x in z["losses"]]
        opt_state_template.load_state_dict(state)
        return int(step), arrays, camera, opt_state_template, losses


class Watchdog:
    """Detect a stalled training/render loop.

    The loop calls `beat()` once per step. A daemon thread checks the time
    since the last beat every `timeout / 4` seconds (at most every second);
    past `timeout` it fires `on_stall(seconds_since_beat)` once. If
    `exit_code` is not None the process then hard-exits with it, so a
    supervisor can restart the job and resume from the last checkpoint. Use
    as a context manager to guarantee shutdown.
    """

    def __init__(
        self,
        timeout: float,
        on_stall: Optional[Callable[[float], None]] = None,
        exit_code: Optional[int] = None,
    ):
        self.timeout = float(timeout)
        self.on_stall = on_stall
        self.exit_code = exit_code
        self.stalled = False
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        self._last = time.monotonic()

    def _run(self) -> None:
        while not self._stop.wait(min(self.timeout / 4.0, 1.0)):
            silent = time.monotonic() - self._last
            if silent > self.timeout:
                self.stalled = True
                if self.on_stall is not None:
                    self.on_stall(silent)
                else:  # pragma: no cover - default logging path
                    print(
                        f"[raymarch_tpu_torch.Watchdog] no step progress for "
                        f"{silent:.1f}s (timeout {self.timeout}s): a wedged "
                        "step is suspected",
                        flush=True,
                    )
                if self.exit_code is not None:  # pragma: no cover
                    os._exit(self.exit_code)
                return

    def __enter__(self) -> "Watchdog":
        self.beat()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
