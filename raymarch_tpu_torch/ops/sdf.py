"""Scene SDF evaluation in torch: the static-tape part of `raymarch_tpu.ops.sdf`.

Leaf SDFs over struct-of-arrays parameter rows (`TapeArrays.leaf_params`),
quaternion rotation, the smooth blends, and the unrolled combine phase over a
static tape (`TapeSpec.static_tape`). Formulas and f32 op order follow the JAX
package (which follows the reference kernels, wgsl:229-252, and their
standard extensions). `_apply_static_tape` takes the per-tile cull hook of the
JAX version (sdf.py:212-275) per leaf: a culled leaf's distance is `FAR`.
"""

from __future__ import annotations

import torch

from . import opcodes as oc
from .tape import TapeSpec


def _safe_norm(v, dim=-1):
    """L2 norm with a tiny floor (error ~1e-20/|v|, far below f32
    resolution)."""
    return torch.sqrt(torch.sum(v * v, dim=dim) + 1e-20)


def quat_rotate(q, v):
    """Rotate vectors v[..., 3] by unit quaternions q[..., 4] (w,x,y,z)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v, dim=-1)
    uuv = torch.linalg.cross(u, uv, dim=-1)
    return v + 2.0 * (w * uv + uuv)


def quat_rotate_inv(q, v):
    return quat_rotate(q * q.new_tensor([1.0, -1.0, -1.0, -1.0]), v)


def smooth_min(a, b, k):
    """iq's quadratic polynomial smooth-min; equals min(a,b) when
    |a-b| >= k."""
    k = torch.clamp_min(k, 1e-8) if torch.is_tensor(k) else max(k, 1e-8)
    h = torch.clamp_min(k - torch.abs(a - b), 0.0) / k
    return torch.minimum(a, b) - h * h * k * 0.25


def smooth_max(a, b, k):
    return -smooth_min(-a, -b, k)


# --- per-type leaf distance kernels ----------------------------------------
# local: [C, N, 3] leaf-local query points; P: [C, LEAF_PARAM_WIDTH] params.


def _leaf_sphere(local, P):
    return _safe_norm(local) - P[:, 7:8]


def _leaf_box(local, P):
    q = torch.abs(local) - P[:, None, 7:10]
    outside = _safe_norm(torch.clamp_min(q, 0.0))
    inside = torch.clamp_max(
        torch.maximum(q[..., 0], torch.maximum(q[..., 1], q[..., 2])), 0.0
    )
    return outside + inside


def _leaf_plane(local, P):
    # local already has (zero) center subtracted; plane ignores rotation/center.
    return torch.einsum("cnd,cd->cn", local, P[:, 7:10]) + P[:, 10:11]


def _leaf_torus(local, P):
    ring = torch.sqrt(local[..., 0] ** 2 + local[..., 2] ** 2 + 1e-20) - P[:, 7:8]
    return torch.sqrt(ring * ring + local[..., 1] ** 2 + 1e-20) - P[:, 8:9]


def _leaf_cylinder(local, P):
    """Capped y-axis cylinder (iq sdCappedCylinder, exact): radius @7, h @8."""
    qx = torch.sqrt(local[..., 0] ** 2 + local[..., 2] ** 2 + 1e-20) - P[:, 7:8]
    qy = torch.abs(local[..., 1]) - P[:, 8:9]
    outside = torch.sqrt(
        torch.clamp_min(qx, 0.0) ** 2 + torch.clamp_min(qy, 0.0) ** 2 + 1e-20
    )
    inside = torch.clamp_max(torch.maximum(qx, qy), 0.0)
    return outside + inside


def _leaf_capsule(local, P):
    """Vertical capsule (iq sdVerticalCapsule, exact): radius @7, h @8."""
    y = local[..., 1]
    y = y - torch.minimum(torch.maximum(y, -P[:, 8:9]), P[:, 8:9])
    return (
        torch.sqrt(local[..., 0] ** 2 + y * y + local[..., 2] ** 2 + 1e-20)
        - P[:, 7:8]
    )


def _leaf_cone(local, P):
    """Capped y-axis cone (iq sdCappedCone, exact): h @7, r_bottom @8,
    r_top @9 (radii at y = -h and y = +h)."""
    h = P[:, 7:8]
    r1 = P[:, 8:9]
    r2 = P[:, 9:10]
    qx = torch.sqrt(local[..., 0] ** 2 + local[..., 2] ** 2 + 1e-20)
    qy = local[..., 1]
    k2x = r2 - r1
    k2y = 2.0 * h
    cax = qx - torch.minimum(qx, torch.where(qy < 0.0, r1, r2))
    cay = torch.abs(qy) - h
    denom = torch.clamp_min(k2x * k2x + k2y * k2y, 1e-20)
    tt = torch.clamp(((r2 - qx) * k2x + (h - qy) * k2y) / denom, 0.0, 1.0)
    cbx = qx - r2 + k2x * tt
    cby = qy - h + k2y * tt
    s = torch.where((cbx < 0.0) & (cay < 0.0), -1.0, 1.0)
    return s * torch.sqrt(
        torch.minimum(cax * cax + cay * cay, cbx * cbx + cby * cby) + 1e-20
    )


_LEAF_FNS = {
    oc.LEAF_SPHERE: _leaf_sphere,
    oc.LEAF_BOX: _leaf_box,
    oc.LEAF_PLANE: _leaf_plane,
    oc.LEAF_TORUS: _leaf_torus,
    oc.LEAF_CYLINDER: _leaf_cylinder,
    oc.LEAF_CAPSULE: _leaf_capsule,
    oc.LEAF_CONE: _leaf_cone,
}


def _leaf_row_types(spec: TapeSpec):
    """row -> (leaf_type, rotated) map from the static bank layout."""
    out = {}
    for t, start, stop in spec.type_slices:
        for r in range(start, stop):
            out[r] = (t, bool(spec.rotated_types[t]))
    return out


def _single_leaf_distance(points, row_params, ltype, rotated):
    """Distance from points[N,3] to one leaf (row_params f32[16])."""
    local = points - row_params[4:7]
    if rotated:
        local = quat_rotate_inv(row_params[0:4], local)
    return _LEAF_FNS[ltype](local[None, :, :], row_params[None, :])[0]


def _static_tree(spec: TapeSpec):
    """Static tape (RPN) -> expression tree. Node = (cop_or_"leaf",
    instr_index, payload, leaf_row_frozenset); payload is the leaf row for
    leaves, else the child tuple. Returns None for the empty tape."""
    stack: list = []
    for i, (cop, arg, _slot) in enumerate(spec.static_tape):
        if cop == oc.COP_PUSH:
            stack.append(("leaf", i, arg, frozenset((arg,))))
        elif cop in (oc.COP_ROUND, oc.COP_ONION):
            a = stack.pop()
            stack.append((cop, i, (a,), a[3]))
        else:
            b = stack.pop()
            a = stack.pop()
            stack.append((cop, i, (a, b), a[3] | b[3]))
    return stack[0] if stack else None


def _combine_static(cop, a, b, kp):
    if cop == oc.COP_UNION:
        return torch.minimum(a, b)
    if cop == oc.COP_INTERSECTION:
        return torch.maximum(a, b)
    if cop == oc.COP_SUBTRACTION:
        return torch.maximum(a, -b)
    if cop == oc.COP_SMOOTH_UNION:
        return smooth_min(a, b, kp)
    if cop == oc.COP_SMOOTH_INTERSECTION:
        return smooth_max(a, b, kp)
    if cop == oc.COP_SMOOTH_SUBTRACTION:
        return smooth_max(a, -b, kp)
    raise ValueError(f"bad static op {cop}")


def _apply_static_tape(spec: TapeSpec, op_param, leaf_fn, max_dist, like, cull=None):
    """Unrolled combine phase over the static tape. `leaf_fn(row)` yields a
    leaf-distance tensor; `like` gives shape/dtype/device for the empty
    scene, which is `max_dist` everywhere. Blend radii come from the dynamic
    `op_param` (indexed by instruction), so parameter edits need no
    rebuild.

    `cull(row)`, when given, is a bool tensor that broadcasts against the
    points: True where the leaf is active for the point's tile. Elsewhere
    the leaf's distance is `culling.FAR`. The JAX version gates whole
    subtrees behind scalar branches; per leaf, a fully culled subtree folds
    to FAR less at most the sum of its |op_param| instead of FAR, which is
    above max_dist all the same, so hits, shading and the escape test are those of the gated
    tape (the lemma of culling.py). This is the plain version of the
    kernels' masked `scene_distance`."""
    from .culling import FAR

    root = _static_tree(spec)
    if root is None:
        return like * 0.0 + max_dist

    def eval_node(node):
        kind, i, payload, _rows = node
        if kind == "leaf":
            if cull is not None:
                return torch.where(cull(payload), leaf_fn(payload), FAR)
            return leaf_fn(payload)
        kp = op_param[i]
        if kind == oc.COP_ROUND:
            return eval_node(payload[0]) - kp
        if kind == oc.COP_ONION:
            return torch.abs(eval_node(payload[0])) - kp
        a = eval_node(payload[0])
        b = eval_node(payload[1])
        return _combine_static(kind, a, b, kp)

    return eval_node(root)


def scene_distance(spec: TapeSpec, leaf_params, op_param, points, max_dist):
    """Static-tape scene SDF at points[N,3] -> d[N] (the bank-row form of
    `_apply_static_tape`, as the JAX package evaluates it on jnp arrays)."""
    if spec.static_tape is None:
        raise NotImplementedError(
            "dynamic tapes are not ported yet (ROADMAP §1.12 dynamic tape, "
            "tiered runtime and viewer)"
        )
    rows = _leaf_row_types(spec)

    def leaf_fn(row):
        t, rot = rows[row]
        return _single_leaf_distance(points, leaf_params[row], t, rot)

    return _apply_static_tape(spec, op_param, leaf_fn, max_dist, points[:, 0])
