"""Analytic-gradient oracle: exact pixel gradients of the CPU renderer.

A copy of `raymarch_tpu.ops.oracle_grad` (numpy only), so that the port's
gradients are checked against the analytic oracle where jax is not
installed (the machine with the card); tests/test_torch_oracle.py holds the
two copies equal, bit for bit.

BASELINE's gradient bar is "pixel-gradients allclose (rtol 1e-4) vs a CPU
reference evaluator". Finite differences cannot reach that bar (FD noise on
a marched, branchy renderer is percent-level), so this module computes the
oracle gradient ANALYTICALLY, in float64, with hand-derived partials:

- `eval_tape_grads`: walks the wire tape like `oracle.eval_tape` but pushes
  (value, d/dpos[3], d/dword[W]) triples, where W indexes every u32 word of
  the tape — the gradient is taken w.r.t. every f32 parameter word in place
  (opcode words keep zero columns). All partials are closed-form: every
  primitive type (sphere/box/plane/torus/cylinder/capsule/cone), rotated
  or not (raw-quaternion partials), hard and smooth booleans, round/onion.
- `pixel_grads`: the full pixel gradient d(image)/d(param words), mirroring
  the DEVICE differentiable renderer's exact discrete computation graph
  (ops.march: implicit-function theorem at the converged hit with the
  clamped denominator, gradients *through* the 4 tetrahedron tap positions,
  normalization guards, ambient/hit/floor gating, sqrt-gamma epsilon, AA
  mean). Where the device makes a non-smooth choice (hit mask, min/max
  winner, diffuse-vs-ambient), the oracle makes the same choice from its
  own float64 primal — so the comparison is exact wherever both sides agree
  on the discrete structure (everywhere except measure-zero ties).

Deliberately shares no code with the device path (ops/sdf.py, ops/march.py):
the two implementations cross-check each other. Reference for the forward
spec: src/ray_marching/ray_marching.wgsl:87-144 (march + normals) and 96-130
(shading); the gradient layer is new (the reference is non-differentiable,
SURVEY.md §2.3).
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT_CONFIG, RenderConfig
from . import opcodes as oc

_TAPS = np.array(
    [[1, -1, -1], [-1, -1, 1], [-1, 1, -1], [1, 1, 1]], dtype=np.float64
)


def _norm(v, axis=-1, keepdims=False):
    return np.sqrt(np.sum(v * v, axis=axis, keepdims=keepdims))


class _Val:
    """Stack entry: value[N], d/dpos[N,3], d/dwords[N,W]."""

    __slots__ = ("d", "dp", "dw")

    def __init__(self, d, dp, dw):
        self.d = d
        self.dp = dp
        self.dw = dw


def _cross(a, b):
    return np.cross(a, b)


def _rot(q, v):
    """Rotate v[N,3] by quaternion rows q[4] (w,x,y,z) — the device's exact
    formula (sdf.quat_rotate on raw, not re-normalized, components)."""
    w, u = q[0], q[1:4]
    uv = _cross(np.broadcast_to(u, v.shape), v)
    uuv = _cross(np.broadcast_to(u, v.shape), uv)
    return v + 2.0 * (w * uv + uuv)


def _rotinv_with_partials(q, x):
    """l = quat_rotate_inv(q, x) plus dl/dq[j] for the 4 raw components.

    Mirrors sdf.quat_rotate_inv: rotate by (w, -u). Returns
    (l[N,3], dl_dq list of 4 [N,3] arrays)."""
    w = q[0]
    up = -q[1:4]  # u' of the inverse rotation
    upb = np.broadcast_to(up, x.shape)
    uxv = _cross(upb, x)
    l = x + 2.0 * (w * uxv + _cross(upb, uxv))
    dl_dw = 2.0 * uxv
    dl_dq = [dl_dw]
    eye = np.eye(3)
    for m in range(3):
        em = np.broadcast_to(eye[m], x.shape)
        demxv = _cross(em, x)
        term = 2.0 * (
            w * demxv + _cross(em, uxv) + _cross(upb, demxv)
        )
        # u' = -q_vec  =>  d/dq_m = -d/du'_m
        dl_dq.append(-term)
    return l, dl_dq


def _rot_with_partials(q, v):
    """l = quat_rotate(q, v) plus dl/dq[j] for the 4 raw components
    (device raygen rotates view dirs with sdf.quat_rotate on raw q)."""
    w = q[0]
    u = q[1:4]
    ub = np.broadcast_to(u, v.shape)
    uxv = _cross(ub, v)
    l = v + 2.0 * (w * uxv + _cross(ub, uxv))
    dl_dq = [2.0 * uxv]
    eye = np.eye(3)
    for m in range(3):
        em = np.broadcast_to(eye[m], v.shape)
        demxv = _cross(em, v)
        dl_dq.append(
            2.0 * (w * demxv + _cross(em, uxv) + _cross(ub, demxv))
        )
    return l, dl_dq


# --- per-shape local evaluators: l[N,3] -> (d, g_local, [(rel_word, g)]) ---
# rel_word indexes the SHAPE params (after center/quat words). Winner masks
# mirror the device's jnp.minimum/maximum/clip subgradient choices; ties are
# measure-zero and excluded by the comparison tests.


def _shape_sphere(l, par):
    L = np.maximum(_norm(l), 1e-300)
    u = l / L[:, None]
    return L - par[0], u, [(0, -np.ones(l.shape[0]))]


def _shape_box(l, par):
    n = l.shape[0]
    h = par[0:3]
    aq = np.abs(l) - h
    sgn = np.sign(l)
    o = np.maximum(aq, 0.0)
    Lo = _norm(o)
    Lo_safe = np.maximum(Lo, 1e-300)
    go = (o / Lo_safe[:, None]) * (aq > 0.0)
    wmax = np.argmax(aq, axis=1)
    act_in = (np.max(aq, axis=1) < 0.0).astype(np.float64)
    gi = np.zeros((n, 3))
    gi[np.arange(n), wmax] = act_in
    gaq = go + gi
    d = Lo + np.minimum(np.max(aq, axis=1), 0.0)
    gl = gaq * sgn
    return d, gl, [(j, -gaq[:, j]) for j in range(3)]


def _shape_torus(l, par):
    R, r = par[0], par[1]
    hxz = np.maximum(np.hypot(l[:, 0], l[:, 2]), 1e-300)
    ring = hxz - R
    rr = np.maximum(np.hypot(ring, l[:, 1]), 1e-300)
    d = rr - r
    dring = ring / rr
    gl = np.stack(
        [dring * l[:, 0] / hxz, l[:, 1] / rr, dring * l[:, 2] / hxz], axis=1
    )
    return d, gl, [(0, -dring), (1, -np.ones(l.shape[0]))]


def _shape_cylinder(l, par):
    """iq capped cylinder (exact): radius @0, half-height @1; same
    min/max decomposition as the box."""
    n = l.shape[0]
    r, h = par[0], par[1]
    hxz = np.maximum(np.hypot(l[:, 0], l[:, 2]), 1e-300)
    qx = hxz - r
    qy = np.abs(l[:, 1]) - h
    q2 = np.stack([qx, qy], axis=1)
    o = np.maximum(q2, 0.0)
    Lo = _norm(o)
    Lo_safe = np.maximum(Lo, 1e-300)
    go = (o / Lo_safe[:, None]) * (q2 > 0.0)
    wmax = np.argmax(q2, axis=1)
    act_in = (np.max(q2, axis=1) < 0.0).astype(np.float64)
    gi = np.zeros((n, 2))
    gi[np.arange(n), wmax] = act_in
    gq = go + gi  # d(d)/d(qx, qy)
    d = Lo + np.minimum(np.max(q2, axis=1), 0.0)
    gl = np.stack(
        [
            gq[:, 0] * l[:, 0] / hxz,
            gq[:, 1] * np.sign(l[:, 1]),
            gq[:, 0] * l[:, 2] / hxz,
        ],
        axis=1,
    )
    return d, gl, [(0, -gq[:, 0]), (1, -gq[:, 1])]


def _shape_capsule(l, par):
    """Vertical capsule (exact): radius @0, half-height @1."""
    r, h = par[0], par[1]
    cl = np.clip(l[:, 1], -h, h)
    yy = l[:, 1] - cl
    L = np.maximum(
        np.sqrt(l[:, 0] ** 2 + yy * yy + l[:, 2] ** 2), 1e-300
    )
    outside = (np.abs(l[:, 1]) > h).astype(np.float64)
    gl = np.stack(
        [l[:, 0] / L, (yy / L) * outside, l[:, 2] / L], axis=1
    )
    # d(clamp)/dh = sign(y) when clamped; yy = y - clamp
    dh = (yy / L) * (-np.sign(l[:, 1])) * outside
    return L - r, gl, [(0, -np.ones(l.shape[0])), (1, dh)]


def _shape_cone(l, par):
    """iq capped cone (exact): h @0, r_bottom @1, r_top @2. Partials via
    the winner/clamp gates of the device formula (sdf._leaf_cone)."""
    n = l.shape[0]
    h, r1, r2 = par[0], par[1], par[2]
    qx = np.maximum(np.hypot(l[:, 0], l[:, 2]), 1e-300)
    qy = l[:, 1]
    k2x = r2 - r1
    k2y = 2.0 * h
    below = (qy < 0.0).astype(np.float64)
    rsel = below * r1 + (1.0 - below) * r2
    wmin = (qx <= rsel).astype(np.float64)  # min(qx, rsel) winner = qx
    cax = qx - np.minimum(qx, rsel)
    cay = np.abs(qy) - h
    den = max(k2x * k2x + k2y * k2y, 1e-20)
    den_gate = 1.0 if (k2x * k2x + k2y * k2y) > 1e-20 else 0.0
    N_ = (r2 - qx) * k2x + (h - qy) * k2y
    ttraw = N_ / den
    tt = np.clip(ttraw, 0.0, 1.0)
    clip_act = ((ttraw > 0.0) & (ttraw < 1.0)).astype(np.float64)
    cbx = qx - r2 + k2x * tt
    cby = qy - h + k2y * tt
    ca2 = cax * cax + cay * cay
    cb2 = cbx * cbx + cby * cby
    wca = (ca2 <= cb2).astype(np.float64)
    msq = np.minimum(ca2, cb2)
    s = np.where((cbx < 0.0) & (cay < 0.0), -1.0, 1.0)
    rt = np.maximum(np.sqrt(msq), 1e-300)
    d = s * np.sqrt(msq)
    sy = np.sign(qy)

    def dd_of(dqx, dqy, dh_, dr1, dr2):
        """Total derivative for seeds (all [N] or scalars)."""
        dk2x = dr2 - dr1
        dk2y = 2.0 * dh_
        drsel = below * dr1 + (1.0 - below) * dr2
        dcax = (1.0 - wmin) * (dqx - drsel)
        dcay = sy * dqy - dh_
        dN = (
            (dr2 - dqx) * k2x
            + (r2 - qx) * dk2x
            + (dh_ - dqy) * k2y
            + (h - qy) * dk2y
        )
        dden = (2.0 * k2x * dk2x + 2.0 * k2y * dk2y) * den_gate
        dtt = clip_act * (dN * den - N_ * dden) / (den * den)
        dcbx = dqx - dr2 + dk2x * tt + k2x * dtt
        dcby = dqy - dh_ + dk2y * tt + k2y * dtt
        dmsq = wca * 2.0 * (cax * dcax + cay * dcay) + (
            1.0 - wca
        ) * 2.0 * (cbx * dcbx + cby * dcby)
        return s * dmsq / (2.0 * rt)

    z = np.zeros(n)
    one = np.ones(n)
    glx = dd_of(l[:, 0] / qx, z, z, z, z)
    gly = dd_of(z, one, z, z, z)
    glz = dd_of(l[:, 2] / qx, z, z, z, z)
    gl = np.stack([glx, gly, glz], axis=1)
    return d, gl, [
        (0, dd_of(z, z, one, z, z)),
        (1, dd_of(z, z, z, one, z)),
        (2, dd_of(z, z, z, z, one)),
    ]


_SHAPE_FNS = {
    oc.OP_SPHERE: (_shape_sphere, 1),
    oc.OP_BOX: (_shape_box, 3),
    oc.OP_BOX_ROT: (_shape_box, 3),
    oc.OP_TORUS: (_shape_torus, 2),
    oc.OP_TORUS_ROT: (_shape_torus, 2),
    oc.OP_CYLINDER: (_shape_cylinder, 2),
    oc.OP_CYLINDER_ROT: (_shape_cylinder, 2),
    oc.OP_CAPSULE: (_shape_capsule, 2),
    oc.OP_CAPSULE_ROT: (_shape_capsule, 2),
    oc.OP_CONE: (_shape_cone, 3),
    oc.OP_CONE_ROT: (_shape_cone, 3),
}

_ROTATED_OPS = {
    oc.OP_BOX_ROT,
    oc.OP_TORUS_ROT,
    oc.OP_CYLINDER_ROT,
    oc.OP_CAPSULE_ROT,
    oc.OP_CONE_ROT,
}


def eval_tape_grads(
    tape: np.ndarray, points: np.ndarray, cfg: RenderConfig = DEFAULT_CONFIG
):
    """Scene SDF + exact gradients at points[N,3] (float64).

    Returns (d[N], dpos[N,3], dwords[N, len(tape)]): the distance, its
    spatial gradient, and its gradient w.r.t. every tape word (zero for
    opcode words). Covers every primitive opcode (rotated included) and
    every combine; OP_MATERIAL is distance-inert here.
    """
    points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    n = points.shape[0]
    tape = np.asarray(tape, dtype=np.uint32)
    W = len(tape)
    if W == 0:
        return (
            np.full(n, cfg.max_dist),
            np.zeros((n, 3)),
            np.zeros((n, 0)),
        )
    f32 = tape.view(np.float32)

    def leaf(d, dp, dw_pairs):
        dw = np.zeros((n, W))
        for w_idx, g in dw_pairs:
            dw[:, w_idx] = g
        return _Val(d, dp, dw)

    stack: list[_Val] = []
    i = 0
    while i < W:
        op = int(tape[i])
        i += 1
        npar = oc.WIRE_PARAM_COUNT[op]
        par = f32[i : i + npar].astype(np.float64)
        pw = list(range(i, i + npar))  # word index of each param
        i += npar

        if op in _SHAPE_FNS:
            rotated = op in _ROTATED_OPS
            fn, _n_shape = _SHAPE_FNS[op]
            if rotated:
                q = par[0:4]
                c = par[4:7]
                shape_par = par[7:]
                q_words = pw[0:4]
                c_words = pw[4:7]
                shape_words = pw[7:]
            else:
                c = par[0:3]
                shape_par = par[3:]
                c_words = pw[0:3]
                shape_words = pw[3:]
            x = points - c
            if rotated:
                l, dl_dq = _rotinv_with_partials(q, x)
            else:
                l = x
            d, gl, sp = fn(l, shape_par)
            # World spatial gradient: dd/dp = R(q) g_local (l = R^T (p-c)).
            dp = _rot(q, gl) if rotated else gl
            dw_pairs = [(c_words[j], -dp[:, j]) for j in range(3)]
            if rotated:
                # Raw-component quaternion partials, mirroring the device's
                # un-normalized rotation formula (sdf.quat_rotate_inv).
                dw_pairs += [
                    (q_words[j], np.sum(gl * dl_dq[j], axis=1))
                    for j in range(4)
                ]
            dw_pairs += [(shape_words[rel], g) for rel, g in sp]
            stack.append(leaf(d, dp, dw_pairs))
        elif op == oc.OP_PLANE:
            nrm, off = par[0:3], par[3]
            d = points @ nrm + off
            dp = np.broadcast_to(nrm, (n, 3)).copy()
            dw_pairs = [(pw[j], points[:, j]) for j in range(3)]
            dw_pairs.append((pw[3], np.ones(n)))
            stack.append(leaf(d, dp, dw_pairs))
        elif op == oc.OP_TORUS:
            c, R, r = par[0:3], par[3], par[4]
            q = points - c
            hxz = np.maximum(np.hypot(q[:, 0], q[:, 2]), 1e-300)
            ring = hxz - R
            rr = np.maximum(np.hypot(ring, q[:, 1]), 1e-300)
            d = rr - r
            dring = ring / rr
            dp = np.stack(
                [
                    dring * q[:, 0] / hxz,
                    q[:, 1] / rr,
                    dring * q[:, 2] / hxz,
                ],
                axis=1,
            )
            dw_pairs = [(pw[j], -dp[:, j]) for j in range(3)]
            dw_pairs += [(pw[3], -dring), (pw[4], -np.ones(n))]
            stack.append(leaf(d, dp, dw_pairs))
        elif op in (oc.OP_UNION, oc.OP_INTERSECTION):
            b = stack.pop()
            a = stack.pop()
            wa = (
                (a.d <= b.d) if op == oc.OP_UNION else (a.d >= b.d)
            ).astype(np.float64)
            d = np.where(wa > 0.0, a.d, b.d)
            dp = wa[:, None] * a.dp + (1 - wa)[:, None] * b.dp
            dw = wa[:, None] * a.dw + (1 - wa)[:, None] * b.dw
            stack.append(_Val(d, dp, dw))
        elif op == oc.OP_SUBTRACTION:
            b = stack.pop()
            a = stack.pop()
            wa = (a.d >= -b.d).astype(np.float64)
            d = np.where(wa > 0.0, a.d, -b.d)
            dp = wa[:, None] * a.dp - (1 - wa)[:, None] * b.dp
            dw = wa[:, None] * a.dw - (1 - wa)[:, None] * b.dw
            stack.append(_Val(d, dp, dw))
        elif op in (
            oc.OP_SMOOTH_UNION,
            oc.OP_SMOOTH_SUBTRACTION,
            oc.OP_SMOOTH_INTERSECTION,
        ):
            bb = stack.pop()
            aa = stack.pop()
            kw = pw[0]
            k = max(par[0], 1e-8)  # device clamps k the same way (sdf.py)
            k_pass = 1.0 if par[0] > 1e-8 else 0.0
            # Express all three via smin(x, y, k) with sign maps:
            #  union:        smin( a,  b)
            #  subtraction: -smin(-a,  b)
            #  intersection:-smin(-a, -b)
            if op == oc.OP_SMOOTH_UNION:
                sx, sy, so = 1.0, 1.0, 1.0
            elif op == oc.OP_SMOOTH_SUBTRACTION:
                sx, sy, so = -1.0, 1.0, -1.0
            else:
                sx, sy, so = -1.0, -1.0, -1.0
            x, y = sx * aa.d, sy * bb.d
            delta = x - y
            habs = np.abs(delta)
            hact = (habs < k).astype(np.float64)
            h = np.maximum(k - habs, 0.0) / k
            m = np.minimum(x, y)
            wx = (x <= y).astype(np.float64)
            # smin = m - h^2 k / 4
            dsm_dx = wx - 0.5 * h * (-np.sign(delta)) * hact
            dsm_dy = (1 - wx) - 0.5 * h * (np.sign(delta)) * hact
            # d/dk of -(h^2 k)/4: dh/dk = |delta|/k^2 in the h>0 region, so
            # d(h^2 k/4)/dk = (2 h k dh/dk + h^2)/4 = (2 h |delta|/k + h^2)/4.
            dsm_dk = -((2.0 * h * (habs / k) * hact + h * h) / 4.0)
            d = so * (m - h * h * k * 0.25)
            da = so * dsm_dx * sx
            db = so * dsm_dy * sy
            dk = so * dsm_dk * k_pass
            dp = da[:, None] * aa.dp + db[:, None] * bb.dp
            dw = da[:, None] * aa.dw + db[:, None] * bb.dw
            dw[:, kw] += dk
            stack.append(_Val(d, dp, dw))
        elif op == oc.OP_ROUND:
            a = stack.pop()
            dw = a.dw.copy()
            dw[:, pw[0]] += -1.0
            stack.append(_Val(a.d - par[0], a.dp, dw))
        elif op == oc.OP_ONION:
            a = stack.pop()
            s = np.sign(a.d)
            dw = s[:, None] * a.dw
            dw[:, pw[0]] += -1.0
            stack.append(_Val(np.abs(a.d) - par[0], s[:, None] * a.dp, dw))
        elif op == oc.OP_MATERIAL:
            pass  # albedo attribute: distance-inert (color grads live in
            # pixel_grads' material chain)
        else:
            raise NotImplementedError(
                f"analytic oracle gradient: unsupported opcode {op}"
            )
    if len(stack) != 1:
        raise ValueError(f"malformed tape: final stack size {len(stack)}")
    out = stack[0]
    return out.d, out.dp, out.dw


def _march_f64(tape, o, d, cfg):
    """float64 sphere-trace (same discrete loop as oracle.march)."""
    from .oracle import eval_tape  # noqa: F401  (kept independent on purpose)

    n = o.shape[0]
    t = np.zeros(n)
    hit = np.zeros(n, bool)
    active = np.ones(n, bool)
    for _ in range(cfg.max_iter):
        if not active.any():
            break
        dist, _, _ = eval_tape_grads(tape, o + d * t[:, None], cfg)
        # (primal-only walk would do; reuse keeps one code path)
        newly_hit = active & (dist < cfg.min_dist)
        escaped = active & (dist > cfg.max_dist)
        hit |= newly_hit
        active &= ~(newly_hit | escaped)
        t = np.where(active, t + dist, t)
    return t, hit


def pixel_grads(
    tape: np.ndarray,
    origins: np.ndarray,
    dirs: np.ndarray,
    cfg: RenderConfig = DEFAULT_CONFIG,
    cam_rotation=None,
):
    """Exact d(color)/d(tape words) — and, when `cam_rotation` is given,
    d(color)/d(camera pos[3] + raw quaternion[4]) — for explicit rays.

    origins/dirs: [N,3] (pass the device raygen's own rays so both sides
    differentiate the identical primal). Returns (color[N,3],
    dcolor[N,3,W]) BEFORE AA averaging, or (color, dcolor, dcam[N,3,7])
    with `cam_rotation`. Mirrors ops.march.shade + _gamma + the
    implicit-VJP treatment of t: dt/dw = -F_w / clamp(grad_x F . d) at the
    converged hit; the camera chain mirrors ops.raygen.raygen_flat
    (o = campos; d = quat_rotate(q, v) on RAW quaternion components, v the
    camera-independent normalized view dir) and ops.march.march_bwd's
    (go, gd) cotangents. The floor/miss path is piecewise constant in the
    camera a.e. (checker parity through round->int), exactly as on the
    device, so only the hit-shading chain carries camera gradient.
    """
    o = np.asarray(origins, np.float64).reshape(-1, 3)
    d = np.asarray(dirs, np.float64).reshape(-1, 3)
    n = o.shape[0]
    Wt = len(tape)
    n_cam = 7 if cam_rotation is not None else 0
    Wx = Wt + n_cam  # extended gradient axis: words then (pos3, quat4)

    if n_cam:
        q = np.asarray(cam_rotation, np.float64)
        # v = M(q)^{-1} d where M(q) = I + 2w[u]x + 2[u]x^2 is the device's
        # RAW-quaternion rotation (sdf.quat_rotate without re-normalizing).
        # An explicit 3x3 solve: the conjugate trick _rot(conj q)/|q|^4 is
        # exact only at |q| = 1, and fit_camera-style optimization drifts q
        # off the unit sphere between projections (round-4 advisor finding).
        w, u = q[0], q[1:4]
        ux = np.array(
            [[0.0, -u[2], u[1]], [u[2], 0.0, -u[0]], [-u[1], u[0], 0.0]]
        )
        M = np.eye(3) + 2.0 * w * ux + 2.0 * (ux @ ux)
        v = np.linalg.solve(M, d.T).T
        _, dd_dq = _rot_with_partials(q, v)

    t, hit = _march_f64(tape, o, d, cfg)
    hitf = hit.astype(np.float64)

    # Implicit-function derivative of t (ops.march.march_bwd).
    pos_hit = o + d * t[:, None]
    _, gp, gw = eval_tape_grads(tape, pos_hit, cfg)
    fdot = np.sum(gp * d, axis=1)
    c = cfg.grad_denom_clamp
    denom = np.where(np.abs(fdot) > c, fdot, np.where(fdot >= 0, c, -c))
    dt_dx = np.zeros((n, Wx))
    dt_dx[:, :Wt] = -(gw / denom[:, None]) * hitf[:, None]
    if n_cam:
        # dt/d campos_j = -g_j/denom; dt/d q_j = -t (g . dd/dq_j)/denom.
        dt_dx[:, Wt : Wt + 3] = -(gp / denom[:, None]) * hitf[:, None]
        for j in range(4):
            dt_dx[:, Wt + 3 + j] = (
                -t * np.sum(gp * dd_dq[j], axis=1) / denom * hitf
            )

    # Shading position: device replaces miss positions by the origin
    # (ops.march.shade double-where), making miss rays t-independent. All
    # consumers of dpos below are hit-masked, so the miss-ray columns are
    # inert — masking uniformly by hitf mirrors the device cotangent flow.
    pos = np.where(hit[:, None], pos_hit, o)
    dpos_dx = d[:, :, None] * dt_dx[:, None, :] * hitf[:, None, None]
    if n_cam:
        # + do/dtheta + t * dd/dtheta direct terms.
        eye = np.eye(3)
        for j in range(3):
            dpos_dx[:, :, Wt + j] += eye[j][None, :] * hitf[:, None]
        for j in range(4):
            dpos_dx[:, :, Wt + 3 + j] += (
                dd_dq[j] * t[:, None] * hitf[:, None]
            )

    # Tetrahedron normal (pre-normalization acc), gradient THROUGH the tap
    # positions plus the direct parameter dependence.
    acc = np.zeros((n, 3))
    dacc = np.zeros((n, 3, Wx))
    for k in _TAPS:
        fk, gpk, gwk = eval_tape_grads(tape, pos + k * cfg.normal_eps, cfg)
        dfk = np.einsum("nj,njw->nw", gpk, dpos_dx)
        dfk[:, :Wt] += gwk
        acc += k[None, :] * fk[:, None]
        dacc += k[None, :, None] * dfk[:, None, :]
    nn = np.maximum(_norm(acc), 1e-20)
    normal = acc / nn[:, None]
    # d(normal) = (I - n n^T)/|acc| . dacc   (guard exactly like device:
    # max(|acc|,1e-20) — derivative of the max gate: acc path active iff
    # |acc| > 1e-20)
    gate = (_norm(acc) > 1e-20).astype(np.float64)
    proj = np.eye(3)[None, :, :] - normal[:, :, None] * normal[:, None, :]
    dnormal = np.einsum("nij,njw->niw", proj, dacc) / nn[:, None, None]
    dnormal *= gate[:, None, None]

    tl = pos - np.asarray(cfg.light_position, np.float64)
    tln = np.maximum(_norm(tl), 1e-20)
    tlu = tl / tln[:, None]
    dtl = dpos_dx  # [N,3,Wx]
    gate_tl = (_norm(tl) > 1e-20).astype(np.float64)
    proj_tl = np.eye(3)[None, :, :] - tlu[:, :, None] * tlu[:, None, :]
    dtlu = np.einsum("nij,njw->niw", proj_tl, dtl) / tln[:, None, None]
    dtlu *= gate_tl[:, None, None]

    dot = np.sum(normal * tlu, axis=1)
    ddot = np.einsum("nj,njw->nw", tlu, dnormal) + np.einsum(
        "nj,njw->nw", normal, dtlu
    )
    amb_gate = (dot > cfg.ambient).astype(np.float64)
    diffuse = np.maximum(cfg.ambient, dot)
    ddiffuse = amb_gate[:, None] * ddot

    if _tape_has_materials(tape):
        albedo, dalb_dpos, dalb_dw = eval_tape_color_grads(tape, pos, cfg)
        dalb = np.zeros((n, 3, Wx))
        dalb[:, :, :Wt] = dalb_dw
        dalb += np.einsum("ncj,njw->ncw", dalb_dpos, dpos_dx)
        hit_color = albedo * diffuse[:, None]
        dhit_color = (
            dalb * diffuse[:, None, None]
            + albedo[:, :, None] * ddiffuse[:, None, :]
        )
    else:
        albedo = np.asarray(cfg.albedo, np.float64)
        hit_color = albedo[None, :] * diffuse[:, None]
        dhit_color = albedo[None, :, None] * ddiffuse[:, None, :]

    # Floor (parameter-independent and camera-piecewise-constant): primal
    # only.
    dy = d[:, 1]
    dy_safe = np.where(np.abs(dy) > 1e-8, dy, 1e-8)
    ft = (cfg.floor_y - o[:, 1]) / dy_safe
    fpos = o + d * ft[:, None]
    fxz = np.clip(fpos[:, [0, 2]], -1e7, 1e7)
    ip = np.round(fxz + 0.5).astype(np.int64)
    parity = ((ip[:, 0] ^ ip[:, 1]) & 1).astype(np.float64)
    floor_color = (
        np.asarray(cfg.floor_base, np.float64)[None, :]
        + cfg.floor_checker * parity[:, None]
    )
    on_floor = (ft > 0.0) & (np.abs(dy) > 1e-8)
    miss_color = np.where(on_floor[:, None], floor_color, 0.0)

    color_lin = hitf[:, None] * hit_color + (1.0 - hitf[:, None]) * miss_color
    dcolor_lin = hitf[:, None, None] * dhit_color

    # sqrt gamma with the device's epsilon (ops.march._gamma).
    pos_gate = (color_lin > 0.0).astype(np.float64)
    gam = np.sqrt(np.maximum(color_lin, 0.0) + 1e-12)
    dgam = pos_gate[:, :, None] * dcolor_lin / (2.0 * gam[:, :, None])
    if n_cam:
        return gam, dgam[:, :, :Wt], dgam[:, :, Wt:]
    return gam, dgam


def _tape_has_materials(tape) -> bool:
    tape = np.asarray(tape, np.uint32)
    i = 0
    while i < len(tape):
        op = int(tape[i])
        if op == oc.OP_MATERIAL:
            return True
        i += 1 + oc.WIRE_PARAM_COUNT[op]
    return False


class _CVal:
    """Color-stack entry: distance _Val plus rgb[N,3], drgb_dpos[N,3,3],
    drgb_dw[N,3,W]."""

    __slots__ = ("v", "rgb", "drp", "drw")

    def __init__(self, v, rgb, drp, drw):
        self.v = v
        self.rgb = rgb
        self.drp = drp
        self.drw = drw


def eval_tape_color_grads(
    tape: np.ndarray, points: np.ndarray, cfg: RenderConfig = DEFAULT_CONFIG
):
    """Albedo at points[N,3] with exact gradients: returns
    (rgb[N,3], drgb_dpos[N,3,3], drgb_dwords[N,3,W]).

    Mirrors oracle.eval_tape_color / sdf's material propagation: leaves
    carry flag-blended albedo (OP_MATERIAL postfix words); hard combines
    select the winner (piecewise constant — zero weight gradient a.e.);
    smooth combines blend with w = clip(0.5 + 0.5(db-da)/k, 0, 1), whose
    gradient flows through both operand DISTANCES and k. Distance values
    and their gradients come from the same walk (shared with
    eval_tape_grads' closed forms)."""
    points = np.asarray(points, np.float64).reshape(-1, 3)
    n = points.shape[0]
    tape = np.asarray(tape, np.uint32)
    W = len(tape)
    f32 = tape.view(np.float32)
    default = np.asarray(cfg.albedo, np.float64)

    def const_rgb(rgb_row):
        return (
            np.broadcast_to(rgb_row, (n, 3)).copy(),
            np.zeros((n, 3, 3)),
            np.zeros((n, 3, W)),
        )

    # Re-run the distance walk, synchronized with a color stack.
    stack: list[_CVal] = []
    i = 0
    while i < W:
        op = int(tape[i])
        i += 1
        npar = oc.WIRE_PARAM_COUNT[op]
        par = f32[i : i + npar].astype(np.float64)
        pw = list(range(i, i + npar))
        i += npar
        if op in _SHAPE_FNS or op == oc.OP_PLANE:
            sub = np.concatenate(
                [[np.uint32(op)], tape[pw[0] : pw[0] + npar]]
            ) if npar else np.asarray([op], np.uint32)
            dsub, dpsub, dwsub = eval_tape_grads(sub, points, cfg)
            dw = np.zeros((n, W))
            dw[:, pw] = dwsub[:, 1 : 1 + npar]
            rgb, drp, drw = const_rgb(default)
            stack.append(_CVal(_Val(dsub, dpsub, dw), rgb, drp, drw))
        elif op == oc.OP_MATERIAL:
            top = stack[-1]
            rgb = np.broadcast_to(par[0:3], (n, 3)).copy()
            drw = np.zeros((n, 3, W))
            for ch in range(3):
                drw[:, ch, pw[ch]] = 1.0
            stack[-1] = _CVal(top.v, rgb, np.zeros((n, 3, 3)), drw)
        elif op in (oc.OP_UNION, oc.OP_INTERSECTION, oc.OP_SUBTRACTION):
            b = stack.pop()
            a = stack.pop()
            av, bv = a.v, b.v
            if op == oc.OP_UNION:
                wa = (av.d <= bv.d).astype(np.float64)
                d_new = np.where(wa > 0, av.d, bv.d)
                dp = wa[:, None] * av.dp + (1 - wa)[:, None] * bv.dp
                dwv = wa[:, None] * av.dw + (1 - wa)[:, None] * bv.dw
            elif op == oc.OP_INTERSECTION:
                wa = (av.d >= bv.d).astype(np.float64)
                d_new = np.where(wa > 0, av.d, bv.d)
                dp = wa[:, None] * av.dp + (1 - wa)[:, None] * bv.dp
                dwv = wa[:, None] * av.dw + (1 - wa)[:, None] * bv.dw
            else:
                wa = (av.d >= -bv.d).astype(np.float64)
                d_new = np.where(wa > 0, av.d, -bv.d)
                dp = wa[:, None] * av.dp - (1 - wa)[:, None] * bv.dp
                dwv = wa[:, None] * av.dw - (1 - wa)[:, None] * bv.dw
            rgb = wa[:, None] * a.rgb + (1 - wa)[:, None] * b.rgb
            drp = wa[:, None, None] * a.drp + (1 - wa)[:, None, None] * b.drp
            drw = wa[:, None, None] * a.drw + (1 - wa)[:, None, None] * b.drw
            stack.append(_CVal(_Val(d_new, dp, dwv), rgb, drp, drw))
        elif op in (
            oc.OP_SMOOTH_UNION,
            oc.OP_SMOOTH_SUBTRACTION,
            oc.OP_SMOOTH_INTERSECTION,
        ):
            b = stack.pop()
            a = stack.pop()
            av, bv = a.v, b.v
            kw = pw[0]
            k = max(par[0], 1e-8)
            k_pass = 1.0 if par[0] > 1e-8 else 0.0
            if op == oc.OP_SMOOTH_UNION:
                sx, sy, so = 1.0, 1.0, 1.0
            elif op == oc.OP_SMOOTH_SUBTRACTION:
                sx, sy, so = -1.0, 1.0, -1.0
            else:
                sx, sy, so = -1.0, -1.0, -1.0
            x, y = sx * av.d, sy * bv.d
            delta = x - y
            habs = np.abs(delta)
            hact = (habs < k).astype(np.float64)
            h = np.maximum(k - habs, 0.0) / k
            m = np.minimum(x, y)
            wx = (x <= y).astype(np.float64)
            dsm_dx = wx - 0.5 * h * (-np.sign(delta)) * hact
            dsm_dy = (1 - wx) - 0.5 * h * (np.sign(delta)) * hact
            dsm_dk = -((2.0 * h * (habs / k) * hact + h * h) / 4.0)
            d_new = so * (m - h * h * k * 0.25)
            da_ = so * dsm_dx * sx
            db_ = so * dsm_dy * sy
            dk_ = so * dsm_dk * k_pass
            dp = da_[:, None] * av.dp + db_[:, None] * bv.dp
            dwv = da_[:, None] * av.dw + db_[:, None] * bv.dw
            dwv[:, kw] += dk_
            # Material weight (sdf._mat_weight_smooth conventions):
            #  union:        w(da, db)     = clip(.5 + .5(db-da)/k)
            #  intersection: w(db, da)
            #  subtraction:  w(-db, da)
            if op == oc.OP_SMOOTH_UNION:
                u1, u2 = av.d, bv.d
                du1p, du2p = av.dp, bv.dp
                du1w, du2w = av.dw, bv.dw
            elif op == oc.OP_SMOOTH_INTERSECTION:
                u1, u2 = bv.d, av.d
                du1p, du2p = bv.dp, av.dp
                du1w, du2w = bv.dw, av.dw
            else:
                u1, u2 = -bv.d, av.d
                du1p, du2p = -bv.dp, av.dp
                du1w, du2w = -bv.dw, av.dw
            wraw = 0.5 + 0.5 * (u2 - u1) / k
            wcl = np.clip(wraw, 0.0, 1.0)
            wact = ((wraw > 0.0) & (wraw < 1.0)).astype(np.float64)
            dwgt_p = wact[:, None] * 0.5 * (du2p - du1p) / k
            dwgt_w = wact[:, None] * 0.5 * (du2w - du1w) / k
            dwgt_k = -wact * 0.5 * (u2 - u1) / (k * k) * k_pass
            dwgt_w = dwgt_w.copy()
            dwgt_w[:, kw] += dwgt_k
            diff_rgb = a.rgb - b.rgb
            rgb = wcl[:, None] * a.rgb + (1 - wcl)[:, None] * b.rgb
            drp = (
                wcl[:, None, None] * a.drp
                + (1 - wcl)[:, None, None] * b.drp
                + diff_rgb[:, :, None] * dwgt_p[:, None, :]
            )
            drw = (
                wcl[:, None, None] * a.drw
                + (1 - wcl)[:, None, None] * b.drw
                + diff_rgb[:, :, None] * dwgt_w[:, None, :]
            )
            stack.append(_CVal(_Val(d_new, dp, dwv), rgb, drp, drw))
        elif op == oc.OP_ROUND:
            a = stack.pop()
            dwv = a.v.dw.copy()
            dwv[:, pw[0]] += -1.0
            stack.append(
                _CVal(_Val(a.v.d - par[0], a.v.dp, dwv), a.rgb, a.drp, a.drw)
            )
        elif op == oc.OP_ONION:
            a = stack.pop()
            s = np.sign(a.v.d)
            dwv = s[:, None] * a.v.dw
            dwv[:, pw[0]] += -1.0
            stack.append(
                _CVal(
                    _Val(np.abs(a.v.d) - par[0], s[:, None] * a.v.dp, dwv),
                    a.rgb,
                    a.drp,
                    a.drw,
                )
            )
        else:
            raise NotImplementedError(
                f"color-grad oracle: unsupported opcode {op}"
            )
    if len(stack) != 1:
        raise ValueError(f"malformed tape: final stack size {len(stack)}")
    out = stack[0]
    return out.rgb, out.drp, out.drw
