"""Scene and parameter serialization (SURVEY.md §5 "Checkpoint / resume").

A copy of `raymarch_tpu.io` (numpy only), so the port saves and restores
scenes without importing the JAX package; tests/test_torch_fit.py holds the
two copies equal.

The reference has no save/load at all (graph state lives in memory only).
Here everything serializes trivially because the scene IS data:

- `save_scene` / `load_scene`: the wire tape (u32 array) — the canonical
  interchange format, stable across versions of the compiled program layout.
- `save_params` / `load_params`: a compiled program's TapeArrays (e.g. mid-
  optimization), restored against the same TapeSpec. Spec compatibility is
  checked via a fingerprint stored alongside.

Plain .npz via NumPy: scenes are KBs. Parameters given as tensors are
copied to the host when saved.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from .ops.tape import TapeArrays, TapeSpec, arrays_from_streams


def save_scene(path: str, wire_tape, **metadata) -> None:
    """Save a wire tape — or a scene DSL node, which is encoded first —
    (+ optional JSON-able metadata, e.g. camera pose)."""
    from .models import csg
    from .ops.tape import encode_wire

    if isinstance(wire_tape, csg.CSGNode):
        wire_tape = encode_wire(wire_tape)
    np.savez(
        path,
        wire_tape=np.asarray(wire_tape, dtype=np.uint32),
        metadata=np.frombuffer(
            json.dumps(metadata).encode("utf-8"), dtype=np.uint8
        ),
    )


def load_scene(path: str):
    """-> (wire_tape u32[...], metadata dict)."""
    with np.load(path) as z:
        tape = z["wire_tape"]
        meta = json.loads(bytes(z["metadata"].tobytes()).decode("utf-8"))
    return tape, meta


def _host(x) -> np.ndarray:
    """A numpy array, or a tensor on any device, as a host numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _spec_fingerprint(spec: TapeSpec) -> str:
    return json.dumps(dataclasses.asdict(spec), sort_keys=True)


def save_params(path: str, spec: TapeSpec, arrays: TapeArrays) -> None:
    np.savez(
        path,
        spec=np.frombuffer(_spec_fingerprint(spec).encode("utf-8"), dtype=np.uint8),
        leaf_params=_host(arrays.leaf_params),
        tape_ops=_host(arrays.tape_ops),
        tape_arg=_host(arrays.tape_arg),
        op_param=_host(arrays.op_param),
        out_slot=_host(arrays.out_slot),
    )


def load_params(path: str, spec: TapeSpec) -> TapeArrays:
    """Restore TapeArrays; raises if saved against a different TapeSpec."""
    with np.load(path) as z:
        saved = bytes(z["spec"].tobytes()).decode("utf-8")
        if saved != _spec_fingerprint(spec):
            raise ValueError(
                "checkpoint was saved for a different TapeSpec (scene "
                "topology/bucketing changed); recompile the matching scene"
            )
        return arrays_from_streams(
            spec,
            z["leaf_params"],
            z["tape_ops"],
            z["tape_arg"],
            z["op_param"],
            z["out_slot"],
        )
