"""NumPy golden oracle: wire-tape interpreter + full CPU renderer.

A copy of `raymarch_tpu.ops.oracle` (numpy only), so that the port is
checked against the oracle where jax is not installed (the machine with
the card); tests/test_torch_oracle.py holds the two copies equal, bit for
bit. `render` takes its rays from the port's `ops.raygen.camera_rays_np`
(the reference's numpy raygen, copied).

This is the validation anchor demanded by BASELINE.json ("forward images and
pixel-gradients allclose against a CPU reference evaluator of the same CSG
tape"). It interprets the **wire tape** directly with a value-stack machine,
mirroring the reference fragment shader's interpreter semantics
(reference src/ray_marching/ray_marching.wgsl:187-227) and SDF math
(wgsl:229-252), deliberately sharing no code with the device path
(raymarch_tpu.ops.tape / ops.sdf) so the two implementations cross-check
each other.

Vectorized over query points (points axis only — the tape walk itself is a
Python loop, which is fine for an oracle).
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT_CONFIG, RenderConfig
from . import opcodes as oc


def _quat_rotate_inv(q: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Rotate points p[N,3] by the inverse of unit quaternion q[4]=(w,x,y,z)."""
    w, x, y, z = (float(v) for v in q)
    # Inverse rotation = conjugate.
    x, y, z = -x, -y, -z
    u = np.array([x, y, z])
    uv = np.cross(u, p)
    uuv = np.cross(u, uv)
    return p + 2.0 * (w * uv + uuv)


def _sd_sphere(p, center, radius):
    return np.linalg.norm(p - center, axis=-1) - radius


def _sd_box(p, center, half_extents):
    q = np.abs(p - center) - half_extents
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    inside = np.minimum(np.maximum(q[..., 0], np.maximum(q[..., 1], q[..., 2])), 0.0)
    return outside + inside


def _sd_torus(p, center, major_r, minor_r):
    q = p - center
    ring = np.hypot(np.hypot(q[..., 0], q[..., 2]) - major_r, q[..., 1])
    return ring - minor_r


def _sd_plane(p, normal, offset):
    return p @ np.asarray(normal) + offset


def _sd_cylinder(p, r, h):
    qx = np.hypot(p[..., 0], p[..., 2]) - r
    qy = np.abs(p[..., 1]) - h
    outside = np.hypot(np.maximum(qx, 0.0), np.maximum(qy, 0.0))
    return outside + np.minimum(np.maximum(qx, qy), 0.0)


def _sd_capsule(p, r, h):
    y = p[..., 1] - np.clip(p[..., 1], -h, h)
    return np.sqrt(p[..., 0] ** 2 + y * y + p[..., 2] ** 2) - r


def _sd_cone(p, h, r1, r2):
    """iq's exact capped cone: radius r1 at y=-h, r2 at y=+h."""
    qx = np.hypot(p[..., 0], p[..., 2])
    qy = p[..., 1]
    k2x, k2y = r2 - r1, 2.0 * h
    cax = qx - np.minimum(qx, np.where(qy < 0.0, r1, r2))
    cay = np.abs(qy) - h
    denom = max(k2x * k2x + k2y * k2y, 1e-20)
    t = np.clip(((r2 - qx) * k2x + (h - qy) * k2y) / denom, 0.0, 1.0)
    cbx = qx - r2 + k2x * t
    cby = qy - h + k2y * t
    s = np.where(np.logical_and(cbx < 0.0, cay < 0.0), -1.0, 1.0)
    return s * np.sqrt(np.minimum(cax * cax + cay * cay, cbx * cbx + cby * cby))


def _smin(a, b, k):
    h = np.maximum(k - np.abs(a - b), 0.0) / k
    return np.minimum(a, b) - h * h * k * 0.25


def _smax(a, b, k):
    return -_smin(-a, -b, k)


def eval_tape(
    tape: np.ndarray, points: np.ndarray, cfg: RenderConfig = DEFAULT_CONFIG
) -> np.ndarray:
    """Evaluate the scene SDF at points[N,3] -> distances[N].

    Empty tape returns max_dist (reference wgsl:188-191).
    """
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = points.shape[0]
    tape = np.asarray(tape, dtype=np.uint32)
    if tape.size == 0:
        return np.full(n, cfg.max_dist, dtype=np.float32)

    f32 = tape.view(np.float32)
    stack: list[np.ndarray] = []
    i = 0
    while i < len(tape):
        op = int(tape[i])
        i += 1
        npar = oc.WIRE_PARAM_COUNT[op]
        par = f32[i : i + npar].astype(np.float64)
        i += npar

        if op == oc.OP_SPHERE:
            stack.append(_sd_sphere(points, par[0:3], par[3]))
        elif op == oc.OP_BOX:
            stack.append(_sd_box(points, par[0:3], par[3:6]))
        elif op == oc.OP_BOX_ROT:
            local = _quat_rotate_inv(par[0:4], points - par[4:7])
            stack.append(_sd_box(local, 0.0, par[7:10]))
        elif op == oc.OP_TORUS:
            stack.append(_sd_torus(points, par[0:3], par[3], par[4]))
        elif op == oc.OP_TORUS_ROT:
            local = _quat_rotate_inv(par[0:4], points - par[4:7])
            stack.append(_sd_torus(local, 0.0, par[7], par[8]))
        elif op == oc.OP_PLANE:
            stack.append(_sd_plane(points, par[0:3], par[3]))
        elif op == oc.OP_CYLINDER:
            stack.append(_sd_cylinder(points - par[0:3], par[3], par[4]))
        elif op == oc.OP_CYLINDER_ROT:
            local = _quat_rotate_inv(par[0:4], points - par[4:7])
            stack.append(_sd_cylinder(local, par[7], par[8]))
        elif op == oc.OP_CAPSULE:
            stack.append(_sd_capsule(points - par[0:3], par[3], par[4]))
        elif op == oc.OP_CAPSULE_ROT:
            local = _quat_rotate_inv(par[0:4], points - par[4:7])
            stack.append(_sd_capsule(local, par[7], par[8]))
        elif op == oc.OP_CONE:
            stack.append(_sd_cone(points - par[0:3], par[3], par[4], par[5]))
        elif op == oc.OP_CONE_ROT:
            local = _quat_rotate_inv(par[0:4], points - par[4:7])
            stack.append(_sd_cone(local, par[7], par[8], par[9]))
        elif op == oc.OP_UNION:
            b, a = stack.pop(), stack.pop()
            stack.append(np.minimum(a, b))
        elif op == oc.OP_SUBTRACTION:
            b, a = stack.pop(), stack.pop()
            stack.append(np.maximum(a, -b))
        elif op == oc.OP_INTERSECTION:
            b, a = stack.pop(), stack.pop()
            stack.append(np.maximum(a, b))
        elif op == oc.OP_SMOOTH_UNION:
            b, a = stack.pop(), stack.pop()
            stack.append(_smin(a, b, par[0]))
        elif op == oc.OP_SMOOTH_SUBTRACTION:
            b, a = stack.pop(), stack.pop()
            stack.append(_smax(a, -b, par[0]))
        elif op == oc.OP_SMOOTH_INTERSECTION:
            b, a = stack.pop(), stack.pop()
            stack.append(_smax(a, b, par[0]))
        elif op == oc.OP_ROUND:
            stack.append(stack.pop() - par[0])
        elif op == oc.OP_ONION:
            stack.append(np.abs(stack.pop()) - par[0])
        elif op == oc.OP_MATERIAL:
            pass  # attribute only; distances unaffected (see eval_tape_color)
        else:
            raise ValueError(f"unknown wire opcode {op}")
        if len(stack) > cfg.stack_depth:
            raise ValueError("tape exceeds stack depth")

    if len(stack) != 1:
        raise ValueError(f"malformed tape: final stack size {len(stack)}")
    return stack[0].astype(np.float32)


def _mat_select(wa, rgb_a, rgb_b):
    """Blend/select materials by the winner weight wa in [0,1]."""
    wa = wa.astype(np.float32)[:, None]
    return wa * rgb_a + (1.0 - wa) * rgb_b


def eval_tape_color(
    tape: np.ndarray, points: np.ndarray, cfg: RenderConfig = DEFAULT_CONFIG
) -> tuple[np.ndarray, np.ndarray]:
    """Evaluate the scene SDF *with material propagation* at points[N,3]
    -> (distances[N], albedo[N,3]).

    Material system (reference roadmap, README.md:10): each primitive may be
    followed by an OP_MATERIAL attribute; unpainted leaves use cfg.albedo
    (the reference's fixed albedo, wgsl:103). Hard ops pass through the
    winning operand's material (union: nearer; intersection: farther;
    subtraction: the cut surface when the negated operand wins); smooth ops
    blend materials with the weight w_a = clamp(0.5 + 0.5*(b'-a')/k, 0, 1)
    of the same operands the distance blend uses, so the material field is
    continuous exactly where the distance field is.
    """
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = points.shape[0]
    tape = np.asarray(tape, dtype=np.uint32)
    default = np.broadcast_to(
        np.asarray(cfg.albedo, dtype=np.float32), (n, 3)
    ).copy()
    if tape.size == 0:
        return np.full(n, cfg.max_dist, dtype=np.float32), default

    f32 = tape.view(np.float32)
    stack: list[tuple[np.ndarray, np.ndarray]] = []  # (dist[N], rgb[N,3])
    i = 0
    while i < len(tape):
        op = int(tape[i])
        i += 1
        npar = oc.WIRE_PARAM_COUNT[op]
        par = f32[i : i + npar].astype(np.float64)
        i += npar

        if op in oc.PRIMITIVE_OPS:
            # Reuse the single-op distance path via a one-command sub-tape.
            sub = tape[i - npar - 1 : i]
            stack.append((eval_tape(sub, points, cfg), default.copy()))
        elif op == oc.OP_MATERIAL:
            if not stack:
                raise ValueError("OP_MATERIAL with no preceding primitive")
            d, _ = stack.pop()
            rgb = np.broadcast_to(par[0:3].astype(np.float32), (n, 3)).copy()
            stack.append((d, rgb))
        elif op == oc.OP_UNION:
            (b, rb), (a, ra) = stack.pop(), stack.pop()
            stack.append((np.minimum(a, b), _mat_select(a <= b, ra, rb)))
        elif op == oc.OP_SUBTRACTION:
            (b, rb), (a, ra) = stack.pop(), stack.pop()
            stack.append((np.maximum(a, -b), _mat_select(a >= -b, ra, rb)))
        elif op == oc.OP_INTERSECTION:
            (b, rb), (a, ra) = stack.pop(), stack.pop()
            stack.append((np.maximum(a, b), _mat_select(a >= b, ra, rb)))
        elif op == oc.OP_SMOOTH_UNION:
            (b, rb), (a, ra) = stack.pop(), stack.pop()
            k = max(par[0], 1e-8)
            wa = np.clip(0.5 + 0.5 * (b - a) / k, 0.0, 1.0)
            stack.append((_smin(a, b, par[0]), _mat_select(wa, ra, rb)))
        elif op == oc.OP_SMOOTH_SUBTRACTION:
            (b, rb), (a, ra) = stack.pop(), stack.pop()
            k = max(par[0], 1e-8)
            wa = np.clip(0.5 + 0.5 * (a + b) / k, 0.0, 1.0)
            stack.append((_smax(a, -b, par[0]), _mat_select(wa, ra, rb)))
        elif op == oc.OP_SMOOTH_INTERSECTION:
            (b, rb), (a, ra) = stack.pop(), stack.pop()
            k = max(par[0], 1e-8)
            wa = np.clip(0.5 + 0.5 * (a - b) / k, 0.0, 1.0)
            stack.append((_smax(a, b, par[0]), _mat_select(wa, ra, rb)))
        elif op == oc.OP_ROUND:
            d, rgb = stack.pop()
            stack.append((d - par[0], rgb))
        elif op == oc.OP_ONION:
            d, rgb = stack.pop()
            stack.append((np.abs(d) - par[0], rgb))
        else:
            raise ValueError(f"unknown wire opcode {op}")
        if len(stack) > cfg.stack_depth:
            raise ValueError("tape exceeds stack depth")

    if len(stack) != 1:
        raise ValueError(f"malformed tape: final stack size {len(stack)}")
    d, rgb = stack[0]
    return d.astype(np.float32), rgb.astype(np.float32)


# ---------------------------------------------------------------------------
# Full CPU renderer (slow, exact spec)
# ---------------------------------------------------------------------------


def calculate_normals(tape, pos, cfg: RenderConfig = DEFAULT_CONFIG):
    """Tetrahedron 4-tap normal (reference wgsl:135-144), pos[N,3] -> [N,3]."""
    e = cfg.normal_eps
    k = np.array(
        [[1, -1, -1], [-1, -1, 1], [-1, 1, -1], [1, 1, 1]], dtype=np.float32
    )
    n = np.zeros_like(pos)
    for tap in k:
        n += tap * eval_tape(tape, pos + tap * e, cfg)[:, None]
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)


def march(tape, origins, dirs, cfg: RenderConfig = DEFAULT_CONFIG):
    """Sphere-trace rays -> (t[N], hit[N]) (reference wgsl:87-115).

    A ray is a hit when scene_dist < min_dist at the current position; it is
    dropped when scene_dist > max_dist or after max_iter steps.
    """
    origins = np.asarray(origins, dtype=np.float32).reshape(-1, 3)
    dirs = np.asarray(dirs, dtype=np.float32).reshape(-1, 3)
    n = origins.shape[0]
    t = np.zeros(n, dtype=np.float32)
    hit = np.zeros(n, dtype=bool)
    active = np.ones(n, dtype=bool)
    for _ in range(cfg.max_iter):
        if not active.any():
            break
        pos = origins + dirs * t[:, None]
        d = eval_tape(tape, pos, cfg)
        newly_hit = active & (d < cfg.min_dist)
        escaped = active & (d > cfg.max_dist)
        hit |= newly_hit
        active &= ~(newly_hit | escaped)
        t = np.where(active, t + d, t)
    return t, hit


def shade(tape, origins, dirs, t, hit, cfg: RenderConfig = DEFAULT_CONFIG):
    """Per-ray color (reference wgsl:96-130): Lambertian on hit, analytic
    checkerboard floor on miss, else black. No gamma (applied by caller)."""
    origins = np.asarray(origins, dtype=np.float32).reshape(-1, 3)
    dirs = np.asarray(dirs, dtype=np.float32).reshape(-1, 3)
    n = origins.shape[0]
    color = np.zeros((n, 3), dtype=np.float32)

    if hit.any():
        pos = origins[hit] + dirs[hit] * t[hit, None]
        normal = calculate_normals(tape, pos, cfg)
        to_light = pos - np.asarray(cfg.light_position, dtype=np.float32)
        to_light /= np.maximum(np.linalg.norm(to_light, axis=-1, keepdims=True), 1e-20)
        diffuse = np.maximum(cfg.ambient, np.sum(normal * to_light, axis=-1))
        # Per-hit albedo from the material system (unpainted -> cfg.albedo,
        # the reference's fixed albedo, wgsl:103).
        _, albedo = eval_tape_color(tape, pos, cfg)
        color[hit] = albedo * diffuse[:, None]

    miss = ~hit
    if miss.any():
        dy = dirs[miss, 1]
        floor_t = np.where(dy != 0.0, (cfg.floor_y - origins[miss, 1]) / dy, -1.0)
        on_floor = floor_t > 0.0
        fpos = origins[miss] + dirs[miss] * floor_t[:, None]
        ip = np.round(fpos[:, [0, 2]] + 0.5).astype(np.int64)
        parity = ((ip[:, 0] ^ ip[:, 1]) & 1).astype(np.float32)
        fcol = np.asarray(cfg.floor_base, dtype=np.float32)[None, :] + (
            cfg.floor_checker * parity[:, None]
        )
        color[miss] = np.where(on_floor[:, None], fcol, 0.0)

    return color


def render(tape, camera, width, height, cfg: RenderConfig = DEFAULT_CONFIG):
    """Render an image[H,W,3]: AA grid of rays per pixel, sqrt gamma per
    sample, averaged (reference wgsl:36-76). `camera` is utils.camera.Camera."""
    from .raygen import camera_rays_np

    origins, dirs = camera_rays_np(camera, width, height, cfg)  # [S,H,W,3] each
    s, h, w, _ = dirs.shape
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    t, hit = march(tape, o, d, cfg)
    color = shade(tape, o, d, t, hit, cfg)
    color = np.sqrt(np.maximum(color, 0.0))
    return color.reshape(s, h, w, 3).mean(axis=0)
