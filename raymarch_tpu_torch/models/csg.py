"""CSG scene model: a typed SDF expression tree (the scene DSL).

Plays the role of the reference's `enum CSGNode` AST
(reference src/ray_marching/csg/mod.rs:30-45 and csg/primitives/, csg/operations/),
but as plain Python frozen dataclasses with operator sugar, built for programmatic
scene construction (the reference's visual node editor is replaced by this DSL plus
`raymarch_tpu_torch.models.graph`).

Supported nodes (reference parity and the BASELINE-mandated extensions):

- Primitives: Sphere, Box (reference active variants), Torus, Plane
  (reference roadmap variants, csg/mod.rs:34 and builder.rs:2-24 reserved opcodes).
- Binary ops: Union, Subtraction (reference active), Intersection (reference
  roadmap), SmoothUnion / SmoothSubtraction / SmoothIntersection with
  differentiable blend radius k (BASELINE north star).
- Unary ops: Round (offset), Onion (shell).
- Space transforms: Translate, Rotate (quaternion), Scale (uniform) — reserved
  opcode space 200+ in the reference (builder.rs:18-23); here they are *folded
  into the leaves at compile time* (`fold_transforms`), exploiting that every
  supported SDF is 1-homogeneous (d(a*p; a*params) = a*d(p; params)), so scale
  folds into parameters and no transform stack is needed at eval time.

Convenience constructors are lowercase (`sphere`, `box_`, ...); operators:
`a | b` union, `a & b` intersection, `a - b` subtraction.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np

from ..utils import math3d

Vec3 = Tuple[float, float, float]
Quat = Tuple[float, float, float, float]


def _vec3(v) -> Vec3:
    a = np.asarray(v, dtype=np.float64).reshape(-1)
    if a.shape != (3,):
        raise ValueError(f"expected 3-vector, got shape {a.shape}")
    return (float(a[0]), float(a[1]), float(a[2]))


def _quat(q) -> Quat:
    a = math3d.quat_normalize(q)
    return (float(a[0]), float(a[1]), float(a[2]), float(a[3]))


@dataclasses.dataclass(frozen=True)
class CSGNode:
    """Base class for all scene nodes."""

    # -- operator sugar -------------------------------------------------
    def __or__(self, other: "CSGNode") -> "CSGNode":
        return Union(self, other)

    def __and__(self, other: "CSGNode") -> "CSGNode":
        return Intersection(self, other)

    def __sub__(self, other: "CSGNode") -> "CSGNode":
        return Subtraction(self, other)

    # -- fluent API -----------------------------------------------------
    def union(self, other: "CSGNode", k: Optional[float] = None) -> "CSGNode":
        return Union(self, other) if k is None else SmoothUnion(self, other, float(k))

    def intersect(self, other: "CSGNode", k: Optional[float] = None) -> "CSGNode":
        return (
            Intersection(self, other)
            if k is None
            else SmoothIntersection(self, other, float(k))
        )

    def subtract(self, other: "CSGNode", k: Optional[float] = None) -> "CSGNode":
        return (
            Subtraction(self, other)
            if k is None
            else SmoothSubtraction(self, other, float(k))
        )

    def translate(self, offset) -> "CSGNode":
        return Translate(self, _vec3(offset))

    def rotate(self, quat) -> "CSGNode":
        return Rotate(self, _quat(quat))

    def rotate_axis_angle(self, axis, angle: float) -> "CSGNode":
        return Rotate(self, _quat(math3d.quat_from_axis_angle(axis, angle)))

    def rotate_euler(self, roll: float, pitch: float, yaw: float) -> "CSGNode":
        return Rotate(self, _quat(math3d.quat_from_euler(roll, pitch, yaw)))

    def scale(self, factor: float) -> "CSGNode":
        return Scale(self, float(factor))

    def round(self, radius: float) -> "CSGNode":
        return Round(self, float(radius))

    def onion(self, thickness: float) -> "CSGNode":
        return Onion(self, float(thickness))

    def paint(self, albedo, overwrite: bool = False) -> "CSGNode":
        """Material system (reference roadmap, README.md:10): return a copy
        of this subtree with `albedo` (r,g,b) attached to every primitive
        leaf. Leaves already painted keep their material unless `overwrite`.
        Materials propagate through CSG ops to the surface that wins each
        min/max (smooth ops blend them) — see ops.oracle.eval_tape_color."""
        mat = _vec3(albedo)

        def go(n: CSGNode) -> CSGNode:
            if isinstance(n, Primitive):
                if n.material is not None and not overwrite:
                    return n
                return dataclasses.replace(n, material=mat)
            if isinstance(n, BinaryOp):
                return dataclasses.replace(n, a=go(n.a), b=go(n.b))
            if isinstance(n, UnaryOp):
                return dataclasses.replace(n, child=go(n.child))
            raise TypeError(f"unknown CSG node type: {type(n).__name__}")

        return go(self)


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Primitive(CSGNode):
    """Base for leaf SDFs. `rotation` is folded in by `fold_transforms`."""


@dataclasses.dataclass(frozen=True)
class Sphere(Primitive):
    """d(p) = |p - center| - radius (reference csg/primitives/sphere.rs:9-13,
    ray_marching.wgsl:229-233)."""

    center: Vec3 = (0.0, 0.0, 0.0)
    radius: float = 1.0
    material: Optional[Vec3] = None


@dataclasses.dataclass(frozen=True)
class Box(Primitive):
    """Axis-aligned (pre-rotation) box; `half_extents` matches the reference's
    `radius: [f32;3]` (csg/primitives/box.rs:9-12, ray_marching.wgsl:235-240).
    `rotation` rotates the box about its center."""

    center: Vec3 = (0.0, 0.0, 0.0)
    half_extents: Vec3 = (1.0, 1.0, 1.0)
    rotation: Quat = math3d.IDENTITY_QUAT
    material: Optional[Vec3] = None


@dataclasses.dataclass(frozen=True)
class Torus(Primitive):
    """Torus in the local xz plane: d = |(|p.xz| - R, p.y)| - r.
    Reference roadmap primitive (BASELINE north star)."""

    center: Vec3 = (0.0, 0.0, 0.0)
    major_radius: float = 1.0
    minor_radius: float = 0.25
    rotation: Quat = math3d.IDENTITY_QUAT
    material: Optional[Vec3] = None


@dataclasses.dataclass(frozen=True)
class Plane(Primitive):
    """Half-space: d = dot(p, normal) + offset. Reserved opcode in the
    reference (csg/builder.rs:5)."""

    normal: Vec3 = (0.0, 1.0, 0.0)
    offset: float = 0.0
    material: Optional[Vec3] = None


@dataclasses.dataclass(frozen=True)
class Cylinder(Primitive):
    """Capped cylinder along local y (iq's sdCappedCylinder, exact):
    q = (|p.xz| - r, |p.y| - h); d = min(max(q), 0) + |max(q, 0)|."""

    center: Vec3 = (0.0, 0.0, 0.0)
    radius: float = 0.5
    half_height: float = 1.0
    rotation: Quat = math3d.IDENTITY_QUAT
    material: Optional[Vec3] = None


@dataclasses.dataclass(frozen=True)
class Capsule(Primitive):
    """Vertical capsule (iq's sdVerticalCapsule, exact): the y in [-h, h]
    segment inflated by radius."""

    center: Vec3 = (0.0, 0.0, 0.0)
    radius: float = 0.5
    half_height: float = 1.0
    rotation: Quat = math3d.IDENTITY_QUAT
    material: Optional[Vec3] = None


@dataclasses.dataclass(frozen=True)
class Cone(Primitive):
    """Capped cone along local y (iq's sdCappedCone, exact): radius
    `r_bottom` at y=-h, `r_top` at y=+h. r_top=0 gives a sharp cone."""

    center: Vec3 = (0.0, 0.0, 0.0)
    half_height: float = 1.0
    r_bottom: float = 0.5
    r_top: float = 0.0
    rotation: Quat = math3d.IDENTITY_QUAT
    material: Optional[Vec3] = None


# ---------------------------------------------------------------------------
# Operations
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BinaryOp(CSGNode):
    a: CSGNode = None  # type: ignore[assignment]
    b: CSGNode = None  # type: ignore[assignment]


@dataclasses.dataclass(frozen=True)
class Union(BinaryOp):
    """min(a, b) (reference operations/mod.rs:53, wgsl:242-246)."""


@dataclasses.dataclass(frozen=True)
class Subtraction(BinaryOp):
    """max(a, -b): a minus b (reference operations/mod.rs:54, wgsl:248-252)."""


@dataclasses.dataclass(frozen=True)
class Intersection(BinaryOp):
    """max(a, b). Reference roadmap op (csg/mod.rs:41, builder.rs:11)."""


@dataclasses.dataclass(frozen=True)
class SmoothBinaryOp(BinaryOp):
    k: float = 0.25  # blend radius, differentiable


@dataclasses.dataclass(frozen=True)
class SmoothUnion(SmoothBinaryOp):
    """Quadratic polynomial smooth-min (iq):
    h = max(k - |a-b|, 0)/k; smin = min(a,b) - h^2*k/4."""


@dataclasses.dataclass(frozen=True)
class SmoothSubtraction(SmoothBinaryOp):
    """smax(a, -b, k) = -smin(-a, b, k)."""


@dataclasses.dataclass(frozen=True)
class SmoothIntersection(SmoothBinaryOp):
    """smax(a, b, k) = -smin(-a, -b, k)."""


@dataclasses.dataclass(frozen=True)
class UnaryOp(CSGNode):
    child: CSGNode = None  # type: ignore[assignment]


@dataclasses.dataclass(frozen=True)
class Round(UnaryOp):
    """d - radius: rounds edges / inflates the child."""

    radius: float = 0.1


@dataclasses.dataclass(frozen=True)
class Onion(UnaryOp):
    """|d| - thickness: hollow shell of the child."""

    thickness: float = 0.1


@dataclasses.dataclass(frozen=True)
class Transform(UnaryOp):
    pass


@dataclasses.dataclass(frozen=True)
class Translate(Transform):
    offset: Vec3 = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class Rotate(Transform):
    quat: Quat = math3d.IDENTITY_QUAT


@dataclasses.dataclass(frozen=True)
class Scale(Transform):
    """Uniform scale only: SDFs stay exact distances under uniform scaling."""

    factor: float = 1.0


# ---------------------------------------------------------------------------
# Convenience constructors
# ---------------------------------------------------------------------------


def _mat(material) -> Optional[Vec3]:
    return None if material is None else _vec3(material)


def sphere(center=(0.0, 0.0, 0.0), radius: float = 1.0, material=None) -> Sphere:
    return Sphere(_vec3(center), float(radius), _mat(material))


def box(
    center=(0.0, 0.0, 0.0), half_extents=(1.0, 1.0, 1.0), rotation=None,
    material=None,
) -> Box:
    q = math3d.IDENTITY_QUAT if rotation is None else _quat(rotation)
    return Box(_vec3(center), _vec3(half_extents), q, _mat(material))


def torus(
    center=(0.0, 0.0, 0.0),
    major_radius: float = 1.0,
    minor_radius: float = 0.25,
    rotation=None,
    material=None,
) -> Torus:
    q = math3d.IDENTITY_QUAT if rotation is None else _quat(rotation)
    return Torus(
        _vec3(center), float(major_radius), float(minor_radius), q, _mat(material)
    )


def plane(normal=(0.0, 1.0, 0.0), offset: float = 0.0, material=None) -> Plane:
    n = np.asarray(normal, dtype=np.float64)
    n = n / np.linalg.norm(n)
    return Plane(_vec3(n), float(offset), _mat(material))


def cylinder(
    center=(0.0, 0.0, 0.0), radius: float = 0.5, half_height: float = 1.0,
    rotation=None, material=None,
) -> Cylinder:
    q = math3d.IDENTITY_QUAT if rotation is None else _quat(rotation)
    return Cylinder(_vec3(center), float(radius), float(half_height), q, _mat(material))


def capsule(
    center=(0.0, 0.0, 0.0), radius: float = 0.5, half_height: float = 1.0,
    rotation=None, material=None,
) -> Capsule:
    q = math3d.IDENTITY_QUAT if rotation is None else _quat(rotation)
    return Capsule(_vec3(center), float(radius), float(half_height), q, _mat(material))


def cone(
    center=(0.0, 0.0, 0.0), half_height: float = 1.0, r_bottom: float = 0.5,
    r_top: float = 0.0, rotation=None, material=None,
) -> Cone:
    q = math3d.IDENTITY_QUAT if rotation is None else _quat(rotation)
    return Cone(
        _vec3(center), float(half_height), float(r_bottom), float(r_top), q,
        _mat(material),
    )


# ---------------------------------------------------------------------------
# Transform folding
# ---------------------------------------------------------------------------


def fold_transforms(node: CSGNode) -> CSGNode:
    """Eliminate Translate/Rotate/Scale nodes by folding them into leaves.

    Returns an equivalent tree containing no `Transform` nodes. Uses:

    - composition: an outer (q1, t1, s1) applied to an inner (q2, t2, s2) is
      (q1*q2, t1 + s1*R1@t2, s1*s2);
    - 1-homogeneity: d(a*p; a*params) = a*d(p; params) for all supported
      primitives, so the scale folds entirely into parameters (sphere radius,
      box half-extents, torus radii, plane offset) and into the op parameters
      (smooth blend k, round radius, onion thickness) of scaled subtrees;
    - spheres and planes are rotation-invariant (the plane normal just
      rotates), so only Box and Torus retain a `rotation` quaternion.
    """

    def go(n: CSGNode, q: np.ndarray, t: np.ndarray, s: float) -> CSGNode:
        if isinstance(n, Translate):
            return go(n.child, q, t + s * math3d.quat_rotate(q, n.offset), s)
        if isinstance(n, Rotate):
            return go(n.child, math3d.quat_multiply(q, n.quat), t, s)
        if isinstance(n, Scale):
            if n.factor <= 0.0:
                raise ValueError("Scale factor must be positive")
            return go(n.child, q, t, s * n.factor)

        if isinstance(n, Sphere):
            c = t + s * math3d.quat_rotate(q, n.center)
            return Sphere(_vec3(c), n.radius * s, n.material)
        if isinstance(n, Box):
            c = t + s * math3d.quat_rotate(q, n.center)
            rq = math3d.quat_multiply(q, n.rotation)
            he = tuple(x * s for x in n.half_extents)
            return Box(_vec3(c), he, _quat(rq), n.material)
        if isinstance(n, Torus):
            c = t + s * math3d.quat_rotate(q, n.center)
            rq = math3d.quat_multiply(q, n.rotation)
            return Torus(
                _vec3(c), n.major_radius * s, n.minor_radius * s, _quat(rq),
                n.material,
            )
        if isinstance(n, Plane):
            # s*(dot(R^-1(p-t)/s, n) + h) = dot(p, R@n) + (s*h - dot(t, R@n))
            nn = math3d.quat_rotate(q, n.normal)
            off = s * n.offset - float(np.dot(t, nn))
            return Plane(_vec3(nn), off, n.material)
        if isinstance(n, Cylinder):
            c = t + s * math3d.quat_rotate(q, n.center)
            rq = math3d.quat_multiply(q, n.rotation)
            return Cylinder(
                _vec3(c), n.radius * s, n.half_height * s, _quat(rq), n.material
            )
        if isinstance(n, Capsule):
            c = t + s * math3d.quat_rotate(q, n.center)
            rq = math3d.quat_multiply(q, n.rotation)
            return Capsule(
                _vec3(c), n.radius * s, n.half_height * s, _quat(rq), n.material
            )
        if isinstance(n, Cone):
            c = t + s * math3d.quat_rotate(q, n.center)
            rq = math3d.quat_multiply(q, n.rotation)
            return Cone(
                _vec3(c), n.half_height * s, n.r_bottom * s, n.r_top * s,
                _quat(rq), n.material,
            )

        if isinstance(n, SmoothBinaryOp):
            return type(n)(go(n.a, q, t, s), go(n.b, q, t, s), n.k * s)
        if isinstance(n, BinaryOp):
            return type(n)(go(n.a, q, t, s), go(n.b, q, t, s))
        if isinstance(n, Round):
            return Round(go(n.child, q, t, s), n.radius * s)
        if isinstance(n, Onion):
            return Onion(go(n.child, q, t, s), n.thickness * s)
        raise TypeError(f"unknown CSG node type: {type(n).__name__}")

    return go(node, np.array(math3d.IDENTITY_QUAT), np.zeros(3), 1.0)


def iter_postorder(node: CSGNode) -> Iterator[CSGNode]:
    """Postorder traversal (children before parents), matching the reference's
    tape emission order (operations/mod.rs:13-17)."""
    if isinstance(n := node, BinaryOp):
        yield from iter_postorder(n.a)
        yield from iter_postorder(n.b)
    elif isinstance(node, UnaryOp):
        yield from iter_postorder(node.child)
    yield node
