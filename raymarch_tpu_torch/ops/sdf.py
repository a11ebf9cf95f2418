"""Scene SDF evaluation in torch: `raymarch_tpu.ops.sdf`.

Leaf SDFs over struct-of-arrays parameter rows (`TapeArrays.leaf_params`),
quaternion rotation, the smooth blends, the unrolled combine phase over a
static tape (`TapeSpec.static_tape`) and the stack machine over a dynamic
one (`TapeArrays.tape_ops` / `tape_arg` / `out_slot`), and the scene
functions `make_scene_fn` / `make_scene_color_fn` built from them. Formulas
and f32 op order follow the JAX package (which follows the reference
kernels, wgsl:229-252, and their standard extensions). `_apply_static_tape`
takes the per-tile cull hook of the JAX version (sdf.py:212-275) per leaf: a
culled leaf's distance is `FAR`. Everything is differentiable through torch
autograd with respect to `leaf_params`, `op_param` and the points.
"""

from __future__ import annotations

import numpy as np
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
    kernels' masked `words_distance`."""
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


def _mat_weight_smooth(da, db, k):
    """Winner weight of operand a for smooth blends (sdf.py:272): the
    material field is continuous exactly where the distance blend is."""
    k = torch.clamp_min(k, 1e-8) if torch.is_tensor(k) else max(k, 1e-8)
    return torch.clamp(0.5 + 0.5 * (db - da) / k, 0.0, 1.0)


def _apply_static_tape_color(spec: TapeSpec, op_param, leaf_fn, max_dist, like, default_rgb, cull=None):
    """Unrolled combine phase propagating (distance, albedo) (sdf.py:279).
    `leaf_fn(row)` yields (d, (r, g, b)) with r/g/b broadcastable against d.
    Hard ops take the winning operand's colour by the tie rule of
    `oracle.eval_tape_color` (union: a <= b; intersection: a >= b;
    subtraction: a >= -b), smooth ops blend by `_mat_weight_smooth`.
    `cull(row)` gates leaves as in `_apply_static_tape`: a culled leaf reads
    `culling.FAR` with `default_rgb`, which loses every selection that a
    shaded point can see."""
    from .culling import FAR

    def sel(w, ca, cb):
        return tuple(w * x + (1.0 - w) * y for x, y in zip(ca, cb))

    root = _static_tree(spec)
    if root is None:
        return like * 0.0 + max_dist, default_rgb

    def eval_node(node):
        kind, i, payload, _rows = node
        if kind == "leaf":
            d, rgb = leaf_fn(payload)
            if cull is not None:
                on = cull(payload)
                d = torch.where(on, d, FAR)
                rgb = tuple(torch.where(on, c, dc) for c, dc in zip(rgb, default_rgb))
            return d, rgb
        kp = op_param[i]
        if kind in (oc.COP_ROUND, oc.COP_ONION):
            a, ca = eval_node(payload[0])
            return (a - kp if kind == oc.COP_ROUND else torch.abs(a) - kp), ca
        a, ca = eval_node(payload[0])
        b, cb = eval_node(payload[1])
        if kind == oc.COP_UNION:
            w = torch.where(a <= b, 1.0, 0.0)
        elif kind == oc.COP_INTERSECTION:
            w = torch.where(a >= b, 1.0, 0.0)
        elif kind == oc.COP_SUBTRACTION:
            w = torch.where(a >= -b, 1.0, 0.0)
        elif kind == oc.COP_SMOOTH_UNION:
            w = _mat_weight_smooth(a, b, kp)
        elif kind == oc.COP_SMOOTH_INTERSECTION:
            w = _mat_weight_smooth(b, a, kp)
        elif kind == oc.COP_SMOOTH_SUBTRACTION:
            w = _mat_weight_smooth(-b, a, kp)
        else:
            raise ValueError(f"bad static op {kind}")
        return _combine_static(kind, a, b, kp), sel(w, ca, cb)

    return eval_node(root)


def scene_distance(spec: TapeSpec, leaf_params, op_param, points, max_dist):
    """Static-tape scene SDF at points[N,3] -> d[N] (the bank-row form of
    `_apply_static_tape`, as the JAX package evaluates it on jnp arrays)."""
    if spec.static_tape is None:
        raise ValueError(
            "scene_distance reads a static tape; a dynamic tape's instructions "
            "are in its arrays: use make_scene_fn(spec, cfg)(points, arrays) "
            "(ROADMAP §1 item 4 covers the dynamic tape in the prepass kernels)"
        )
    rows = _leaf_row_types(spec)

    def leaf_fn(row):
        t, rot = rows[row]
        return _single_leaf_distance(points, leaf_params[row], t, rot)

    return _apply_static_tape(spec, op_param, leaf_fn, max_dist, points[:, 0])


# --- dynamic tapes and the scene functions (sdf.py:138-155, 349-530) --------


def leaf_distances(points, spec: TapeSpec, leaf_params):
    """points[N,3] -> D[n_leaves, N]: the distance from every point to every
    bank row, type slice by type slice; trailing padding rows read 0."""
    n = points.shape[0]
    blocks = []
    covered = 0
    for t, start, stop in spec.type_slices:
        P = leaf_params[start:stop]
        local = points[None, :, :] - P[:, None, 4:7]
        if spec.rotated_types[t]:
            local = quat_rotate_inv(P[:, None, 0:4], local)
        blocks.append(_LEAF_FNS[t](local, P))
        covered = stop
    if covered < spec.n_leaves:  # trailing padding rows (leafless scenes)
        blocks.append(points.new_zeros((spec.n_leaves - covered, n)))
    return torch.cat(blocks, dim=0) if len(blocks) > 1 else blocks[0]


def host_tape(arrays) -> list:
    """The dynamic tape of `arrays` as host lists [(op, arg, slot), ...]:
    numpy arrays or tensors on any device (one read each)."""
    cols = []
    for v in (arrays.tape_ops, arrays.tape_arg, arrays.out_slot):
        cols.append(v.detach().cpu().tolist() if torch.is_tensor(v) else [int(x) for x in v])
    return list(zip(*cols))


def _apply_dynamic_tape(tape, op_param, leaf_fn, max_dist, like, stack_depth, cull=None):
    """The reference's dynamic combine phase (sdf.py:485-530) over a tape
    read to the host: a stack of `stack_depth + 1` rows started at
    `max_dist`, so that an all-NOP tape is the empty scene; NOP leaves its
    slot as it is (the reference writes it back unchanged), PUSH loads
    `leaf_fn(row)`, the other eight ops combine slots (s, s + 1) into s.
    `cull(row)` gates the pushed leaves as in `_apply_static_tape` (the
    reference's dynamic interpreter takes the same per-row cond,
    pallas_march.py:736-745): the plain version of the kernels' gated DYN
    builds."""
    from .culling import FAR

    stack = [like * 0.0 + max_dist] * (stack_depth + 1)
    for i, (op, arg, s) in enumerate(tape):
        if op == oc.COP_NOP:
            continue
        if op == oc.COP_PUSH:
            stack[s] = leaf_fn(arg) if cull is None else torch.where(cull(arg), leaf_fn(arg), FAR)
            continue
        kp = op_param[i]
        a = stack[s]
        if op == oc.COP_ROUND:
            stack[s] = a - kp
        elif op == oc.COP_ONION:
            stack[s] = torch.abs(a) - kp
        else:
            stack[s] = _combine_static(op, a, stack[s + 1], kp)
    return stack[0]


def _apply_dynamic_tape_color(tape, op_param, leaf_fn, max_dist, like, default_rgb, stack_depth, cull=None):
    """`_apply_dynamic_tape` propagating (distance, albedo) (sdf.py:384-460):
    every slot starts at (max_dist, default_rgb); hard ops take the winner's
    colour by the tie rules of `_apply_static_tape_color`, smooth ops blend
    by `_mat_weight_smooth`, round and onion keep their operand's. A leaf
    that `cull(row)` drops reads `culling.FAR` with `default_rgb`, as in
    `_apply_static_tape_color`."""
    from .culling import FAR

    base = (like * 0.0 + max_dist, tuple(like * 0.0 + c for c in default_rgb))
    stack = [base] * (stack_depth + 1)
    for i, (op, arg, s) in enumerate(tape):
        if op == oc.COP_NOP:
            continue
        if op == oc.COP_PUSH:
            d, rgb = leaf_fn(arg)
            if cull is not None:
                on = cull(arg)
                d = torch.where(on, d, FAR)
                rgb = tuple(torch.where(on, c, dc) for c, dc in zip(rgb, default_rgb))
            stack[s] = (d, rgb)
            continue
        kp = op_param[i]
        a, ca = stack[s]
        if op in (oc.COP_ROUND, oc.COP_ONION):
            stack[s] = ((a if op == oc.COP_ROUND else torch.abs(a)) - kp, ca)
            continue
        b, cb = stack[s + 1]
        if op == oc.COP_UNION:
            w = torch.where(a <= b, 1.0, 0.0)
        elif op == oc.COP_INTERSECTION:
            w = torch.where(a >= b, 1.0, 0.0)
        elif op == oc.COP_SUBTRACTION:
            w = torch.where(a >= -b, 1.0, 0.0)
        elif op == oc.COP_SMOOTH_UNION:
            w = _mat_weight_smooth(a, b, kp)
        elif op == oc.COP_SMOOTH_INTERSECTION:
            w = _mat_weight_smooth(b, a, kp)
        else:
            w = _mat_weight_smooth(-b, a, kp)
        stack[s] = (_combine_static(op, a, b, kp), tuple(w * x + (1.0 - w) * y for x, y in zip(ca, cb)))
    return stack[0]


def _param(x, like: torch.Tensor) -> torch.Tensor:
    """A parameter array as an f32 tensor on the points' device: numpy is
    uploaded; a tensor is used as it is (its autograd graph kept)."""
    if torch.is_tensor(x):
        return x
    return torch.as_tensor(np.asarray(x, np.float32), device=like.device)


def make_scene_fn(spec: TapeSpec, cfg):
    """Build `scene(points[N,3], arrays) -> d[N]` (sdf.py:461-530), on the
    points' device. A static spec unrolls its tape and evaluates only the
    pushed leaves; a dynamic spec evaluates every bank row
    (`leaf_distances`) and runs the tape of `arrays` on the stack machine,
    so one function serves every scene of the spec. Differentiable with
    respect to `arrays.leaf_params`, `arrays.op_param` and the points."""
    if spec.static_tape is not None:
        rows = _leaf_row_types(spec)

        def scene_static(points, arrays):
            lp = _param(arrays.leaf_params, points)

            def leaf_fn(row):
                t, rot = rows[row]
                return _single_leaf_distance(points, lp[row], t, rot)

            return _apply_static_tape(spec, _param(arrays.op_param, points), leaf_fn, cfg.max_dist,
                                      points[:, 0])

        return scene_static

    def scene_dynamic(points, arrays):
        D = leaf_distances(points, spec, _param(arrays.leaf_params, points))
        return _apply_dynamic_tape(host_tape(arrays), _param(arrays.op_param, points), lambda r: D[r],
                                   cfg.max_dist, points[:, 0], spec.stack_depth)

    return scene_dynamic


def _leaf_rgb(lp, default):
    """Per-row albedo f32[n_leaves, 3]: the row's own where its material
    flag is set, else the config default."""
    flag = lp[:, oc.LEAF_MAT_FLAG : oc.LEAF_MAT_FLAG + 1]
    return flag * lp[:, oc.LEAF_ALBEDO : oc.LEAF_ALBEDO + 3] + (1.0 - flag) * default[None, :]


def make_scene_color_fn(spec: TapeSpec, cfg):
    """Build `scene_color(points[N,3], arrays) -> (d[N], albedo[N,3])`
    (sdf.py:349-458): one scene evaluation that also carries the materials.
    Unpainted leaves shade with cfg.albedo."""

    def scene_color(points, arrays):
        lp = _param(arrays.leaf_params, points)
        opp = _param(arrays.op_param, points)
        default = torch.as_tensor(np.asarray(cfg.albedo, np.float32), device=points.device)
        rgb = _leaf_rgb(lp, default)
        dflt = (default[0], default[1], default[2])
        if spec.static_tape is not None:
            rows = _leaf_row_types(spec)

            def leaf_fn(row):
                t, rot = rows[row]
                return _single_leaf_distance(points, lp[row], t, rot), (rgb[row, 0], rgb[row, 1], rgb[row, 2])

            d, (r, g, b) = _apply_static_tape_color(spec, opp, leaf_fn, cfg.max_dist, points[:, 0], dflt)
        else:
            D = leaf_distances(points, spec, lp)
            d, (r, g, b) = _apply_dynamic_tape_color(
                host_tape(arrays), opp, lambda row: (D[row], (rgb[row, 0], rgb[row, 1], rgb[row, 2])),
                cfg.max_dist, points[:, 0], dflt, spec.stack_depth)
        ones = torch.ones_like(d)
        return d, torch.stack([r * ones, g * ones, b * ones], dim=-1)

    return scene_color
