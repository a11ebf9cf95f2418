"""The benchmark's own description of a configuration's scene and camera.

Both sides get their numbers from here: the program compiles them through
its own scene model (`program.py`), the reference evaluates them as they
are (`reference.py`). Pure numpy; imports nothing of the program.

A scene in a configuration file is a tree of JSON values:

- a leaf, `{"sphere": {"center": [x, y, z], "radius": r}}`, `{"box":
  {"center": ..., "half_extents": [..]}}` or `{"torus": {"center": ...,
  "major_radius": R, "minor_radius": r}}` (the torus lies in the xz plane);
- an operation, `["union" | "subtract" | "intersect", a, b]`;
- `{"sphere_union": {"count": n, "center": [[lo, hi] x3], "y": [lo, hi],
  "radius": [lo, hi], "draw_seed": s | null}}`: n spheres in one hard
  union, drawn by `examples/configs.py:config5_tape`'s law (centres
  U(lo, hi) per axis, then y redrawn from `y`, then the radii), from
  `draw_seed`, or from the run's seed where that is null.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

SIZE_KEYS = {"sphere": ("radius",), "box": ("half_extents",), "torus": ("major_radius", "minor_radius")}


@dataclasses.dataclass
class Leaf:
    kind: str
    params: dict  # name -> f32 array (center[3] and the sizes)


@dataclasses.dataclass
class Op:
    kind: str  # "union", "subtract", "intersect"
    a: object
    b: object


@dataclasses.dataclass
class SphereUnion:
    spheres: np.ndarray  # f32[n, 4]: centre xyz, radius


def _leaf(kind: str, spec: dict) -> Leaf:
    if kind not in SIZE_KEYS:
        raise ValueError(f"unknown primitive {kind!r}")
    params = {"center": np.asarray(spec["center"], np.float32).reshape(3)}
    for k in SIZE_KEYS[kind]:
        params[k] = np.asarray(spec[k], np.float32).reshape(-1)
    return Leaf(kind, params)


def draw_spheres(spec: dict, seed: int) -> np.ndarray:
    """The sphere union's spheres, f32[n, 4], by config5_tape's law."""
    rng = np.random.default_rng(spec["draw_seed"] if spec.get("draw_seed") is not None else seed)
    n = int(spec["count"])
    lo, hi = spec["center"]
    s = np.zeros((n, 4), np.float32)
    s[:, :3] = rng.uniform(lo, hi, (n, 3))
    s[:, 1] = rng.uniform(*spec["y"], n)
    s[:, 3] = rng.uniform(*spec["radius"], n)
    return s


def describe(node, seed: int):
    """A configuration's scene JSON -> its tree of Leaf, Op and SphereUnion."""
    if isinstance(node, list):
        kind, a, b = node
        if kind not in ("union", "subtract", "intersect"):
            raise ValueError(f"unknown operation {kind!r}")
        return Op(kind, describe(a, seed), describe(b, seed))
    (kind, spec), = node.items()
    if kind == "sphere_union":
        return SphereUnion(draw_spheres(spec, seed))
    return _leaf(kind, spec)


def leaves(scene) -> list[Leaf]:
    """The scene's leaves, in the order of the description."""
    if isinstance(scene, Op):
        return leaves(scene.a) + leaves(scene.b)
    if isinstance(scene, Leaf):
        return [scene]
    return []


def perturb(scene, rng: np.random.Generator, frac: float):
    """A copy of the scene with every centre moved and every size scaled by
    up to `frac` of the primitive's size, drawn from `rng`."""
    if isinstance(scene, Op):
        return Op(scene.kind, perturb(scene.a, rng, frac), perturb(scene.b, rng, frac))
    if isinstance(scene, SphereUnion):
        raise ValueError("the sphere union is not fitted")
    size = max(float(np.max(np.concatenate([scene.params[k] for k in SIZE_KEYS[scene.kind]]))), 1e-3)
    out = {}
    for k, v in scene.params.items():
        u = rng.uniform(-1.0, 1.0, v.shape)
        out[k] = (v + frac * size * u if k == "center" else v * (1.0 + frac * u)).astype(np.float32)
    return Leaf(scene.kind, out)


def bound_sphere(scene, margin: float = 0.05):
    """A conservative bounding sphere (centre, radius) of the scene: the
    union of its positive primitives' own bounding spheres (a subtraction
    lies inside its first operand), widened by `margin`."""
    def spheres(node):
        if isinstance(node, Op):
            return spheres(node.a) if node.kind == "subtract" else spheres(node.a) + spheres(node.b)
        if isinstance(node, SphereUnion):
            return [(s[:3].astype(np.float64), float(s[3])) for s in node.spheres]
        p = node.params
        r = {"sphere": lambda: float(p["radius"][0]),
             "box": lambda: float(np.linalg.norm(p["half_extents"].astype(np.float64))),
             "torus": lambda: float(p["major_radius"][0] + p["minor_radius"][0])}[node.kind]()
        return [(p["center"].astype(np.float64), r)]

    ss = spheres(scene)
    c = np.mean([s[0] for s in ss], axis=0)
    r = max(float(np.linalg.norm(s[0] - c)) + s[1] for s in ss) + margin
    return c, r


def look_at(position, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)) -> tuple[np.ndarray, np.ndarray]:
    """(position f32[3], rotation f32[4] (w, x, y, z)): a camera at
    `position` that looks down its -z axis toward `target`; the rotation
    takes camera space to world space."""
    pos = np.asarray(position, np.float64)
    z = pos - np.asarray(target, np.float64)
    z /= np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.stack([x, y, z], axis=1)
    # The quaternion of a rotation matrix, from its largest component.
    w2 = 1.0 + m[0, 0] + m[1, 1] + m[2, 2]
    x2 = 1.0 + m[0, 0] - m[1, 1] - m[2, 2]
    y2 = 1.0 - m[0, 0] + m[1, 1] - m[2, 2]
    z2 = 1.0 - m[0, 0] - m[1, 1] + m[2, 2]
    k = int(np.argmax([w2, x2, y2, z2]))
    s = 2.0 * math.sqrt(max(w2, x2, y2, z2))
    if k == 0:
        q = [s / 4, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
    elif k == 1:
        q = [(m[2, 1] - m[1, 2]) / s, s / 4, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s]
    elif k == 2:
        q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, s / 4, (m[1, 2] + m[2, 1]) / s]
    else:
        q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, s / 4]
    q = np.asarray(q)
    return pos.astype(np.float32), (q / np.linalg.norm(q)).astype(np.float32)


def orbit_camera(camera: dict, angle: float) -> tuple[np.ndarray, np.ndarray]:
    """The configuration's camera turned about the y axis through its
    target by `angle` radians: the same radius in the xz plane and height."""
    px, py, pz = camera["position"]
    tx, ty, tz = camera.get("target", (0.0, 0.0, 0.0))
    r = math.hypot(px - tx, pz - tz)
    a0 = math.atan2(px - tx, pz - tz)
    pos = (tx + r * math.sin(a0 + angle), py, tz + r * math.cos(a0 + angle))
    return look_at(pos, (tx, ty, tz))
