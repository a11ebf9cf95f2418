"""The plain reference: sphere tracing, shading and the fit's gradients of
the benchmark's scene descriptions, in plain PyTorch.

It evaluates the scene from `scene.py`'s description, never from the
program's tape, and imports nothing of the program (nor jax). Its
semantics are the renderer's published ones (`RenderConfig`'s fields, as
each configuration file states them):

- rays: a perspective camera (fovy, the image's aspect), an aa x aa grid
  of samples in each pixel, pixel-major with the sample fastest;
- the march: from t = 0, a hit where the scene distance falls below
  min_dist, an escape where it exceeds max_dist, at most max_iter
  evaluations. A ray that misses the scene's bounding sphere (the union of
  its primitives' spheres, 0.05 wider) takes no step, and one past its exit
  (t > t_exit + min_dist) escapes: no point outside that sphere comes
  within min_dist of the scene, so every hit and its t are those of the
  march without it (bound_accel's promise), and a missed ray's colour does
  not depend on where it stops;
- shading: the tetrahedron normal of 4 taps normal_eps away, Lambert
  against the point light with the ambient floor, the default albedo, and
  for a missed ray the checker floor at y = floor_y; sqrt gamma of each
  sample, then the pixel's mean;
- the fit's gradient: the implicit-function derivative of t at the hit
  point (dt/dtheta = -F_theta / (grad_x F . d), the denominator clamped
  to +-grad_denom_clamp), through the taps and the shading; a missed ray
  carries none. Adam is written out here.

Everything runs in `dtype` (float32 as the configurations state; the
control runs it in bfloat16), in blocks of image rows, so that a 4K
frame of 16 samples a pixel fits beside nothing else.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .scene import Op, SphereUnion, bound_sphere, leaves

TAPS = ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))
BLOCK_RAYS = 1 << 25  # AA rays a block of rows holds
EVAL_POINTS = 1 << 21  # points of one sphere-union evaluation


@dataclasses.dataclass
class WorkCount:
    """What a frame's march needed: AA rays, scene evaluations of the march
    (the bounded march's), rays that hit, rays that missed, AA samples a
    pixel, rays that took a step."""

    rays: int = 0
    steps: int = 0
    hits: int = 0
    misses: int = 0
    samples: int = 1
    marched: int = 0  # rays that took a step (inside the bounding sphere)

    def add(self, other: "WorkCount") -> None:
        self.rays += other.rays
        self.marched += other.marched
        self.steps += other.steps
        self.hits += other.hits
        self.misses += other.misses
        self.samples = other.samples


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1) + 1e-20)


class Scene:
    """The distance function of a description, on `device` in `dtype`.
    `params` maps "<leaf>.<name>" to tensors (a fit's variables); missing
    names take the description's numbers."""

    def __init__(self, desc, dtype, device, params=None):
        self.desc, self.dtype, self.device = desc, dtype, device
        self.params = {}
        for i, leaf in enumerate(leaves(desc)):
            for k, v in leaf.params.items():
                key = f"{i}.{k}"
                self.params[key] = params[key] if params and key in params else torch.as_tensor(
                    v, dtype=dtype, device=device)
        self._union = None
        if isinstance(desc, SphereUnion):
            s = torch.as_tensor(desc.spheres, dtype=dtype, device=device)
            self._union = (s[:, :3].contiguous(), s[:, 3].contiguous())

    def __call__(self, p):
        if self._union is not None:
            return self._sphere_union(p)
        return self._eval(self.desc, p, [0])

    def _eval(self, node, p, counter):
        if isinstance(node, Op):
            a = self._eval(node.a, p, counter)
            b = self._eval(node.b, p, counter)
            if node.kind == "union":
                return torch.minimum(a, b)
            if node.kind == "intersect":
                return torch.maximum(a, b)
            return torch.maximum(a, -b)
        i = counter[0]
        counter[0] += 1
        g = lambda k: self.params[f"{i}.{k}"]  # noqa: E731
        q = p - g("center")
        if node.kind == "sphere":
            return _norm(q) - g("radius")[0]
        if node.kind == "box":
            e = torch.abs(q) - g("half_extents")
            outside = _norm(torch.clamp_min(e, 0.0))
            inside = torch.clamp_max(torch.amax(e, dim=-1), 0.0)
            return outside + inside
        ring = torch.sqrt(q[:, 0] * q[:, 0] + q[:, 2] * q[:, 2] + 1e-20) - g("major_radius")[0]
        return torch.sqrt(ring * ring + q[:, 1] * q[:, 1] + 1e-20) - g("minor_radius")[0]

    def _sphere_union(self, p):
        """min over the spheres of |p - c| - r. In float32 the squared
        distances are |p|^2 + |c|^2 - 2 p.c in float64 (one product of the
        points with the centres; its rounding, ~1e-12 at |p| ~ 100, is far
        below float32's), other dtypes take the differences themselves."""
        c, r = self._union
        out = []
        for k in range(0, p.shape[0], EVAL_POINTS):
            x = p[k:k + EVAL_POINTS]
            if self.dtype == torch.float32:
                x64, c64 = x.to(torch.float64), c.to(torch.float64)
                d2 = torch.addmm(torch.sum(x64 * x64, dim=1, keepdim=True) + torch.sum(c64 * c64, dim=1)[None, :],
                                 x64, c64.T, alpha=-2.0)
                d = torch.sqrt(torch.clamp_min_(d2, 0.0)).sub_(r.to(torch.float64)[None, :])
                out.append(torch.amin(d, dim=1).to(self.dtype))
            else:
                d = _norm(x[:, None, :] - c[None, :, :])
                out.append(torch.amin(d - r[None, :], dim=1))
        return torch.cat(out) if out else p.new_zeros(0)


def eval_ops(desc, leaf_ops: dict, combine_ops: dict) -> float:
    """Operations of one evaluation of the scene, by the yardstick's prices
    of its leaves and combines."""
    if isinstance(desc, SphereUnion):
        n = desc.spheres.shape[0]
        return n * leaf_ops["sphere"] + (n - 1) * combine_ops["union"]
    if isinstance(desc, Op):
        return eval_ops(desc.a, leaf_ops, combine_ops) + eval_ops(desc.b, leaf_ops, combine_ops) + combine_ops[desc.kind]
    return leaf_ops[desc.kind]


def quat_rotate(q, v):
    """v rotated by the unit quaternion q = (w, x, y, z)."""
    w, u = q[0], q[1:4].expand_as(v)
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def rays(r: dict, cam, width: int, height: int, i0: int, i1: int, dtype, device):
    """(origin[3], dirs[N, 3]) of image rows [i0, i1), pixel-major with the
    sample fastest: sample s = a * aa + b takes the a-th x offset and the
    b-th y offset, (k + 0.5) / aa - 0.5 of a pixel."""
    n = int(r["aa_samples"])
    s = torch.arange(n * n, device=device)
    fa = ((s // n).to(dtype) + 0.5) / n - 0.5
    fb = ((s % n).to(dtype) + 0.5) / n - 0.5
    i = torch.arange(i0, i1, device=device).to(dtype)[:, None, None]
    j = torch.arange(width, device=device).to(dtype)[None, :, None]
    x = 2.0 * (j + 0.5) / width - 1.0 + fa[None, None, :] * 2.0 / width
    y = 1.0 - 2.0 * (i + 0.5) / height + fb[None, None, :] * 2.0 / height
    x, y = torch.broadcast_tensors(x, y)
    tf = math.tan(float(r["fovy"]) / 2.0)
    v = torch.stack([x * (tf * width / height), y * tf, -torch.ones_like(x)], dim=-1).reshape(-1, 3)
    v = v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    pos = torch.as_tensor(np.asarray(cam[0], np.float32), dtype=dtype, device=device)
    rot = torch.as_tensor(np.asarray(cam[1], np.float32), dtype=dtype, device=device)
    return pos, quat_rotate(rot, v)


def march(scene: Scene, o, d, r: dict, bound=None):
    """(t, hit, steps) of each ray; `bound` = (centre, radius) applies
    bound_accel's miss test and exit cap."""
    n = d.shape[0]
    t = d.new_zeros(n)
    hit = torch.zeros(n, dtype=torch.bool, device=d.device)
    steps = torch.zeros(n, dtype=torch.int32, device=d.device)
    idx = torch.arange(n, device=d.device)
    cap = None
    if bound is not None:
        oc = o - torch.as_tensor(bound[0], dtype=d.dtype, device=d.device)
        bq = torch.sum(d * oc, dim=-1)
        disc = bq * bq - (torch.sum(oc * oc) - float(bound[1]) ** 2)
        t_exit = -bq + torch.sqrt(torch.clamp_min(disc, 0.0))
        cap = t_exit + float(r["min_dist"])
        idx = idx[(disc > 0.0) & (t_exit > 0.0)]
    min_dist, max_dist = float(r["min_dist"]), float(r["max_dist"])
    for _ in range(int(r["max_iter"])):
        if idx.numel() == 0:
            break
        tk = t[idx]
        dist = scene(o + d[idx] * tk[:, None])
        steps[idx] += 1
        h = dist < min_dist
        esc = dist > max_dist
        if cap is not None:
            esc = esc | (tk > cap[idx])
        go = ~(h | esc)
        hit[idx[h]] = True
        t[idx[go]] = tk[go] + dist[go]
        idx = idx[go]
    return t, hit, steps


def normals(scene: Scene, p, eps: float):
    """The unnormalised tetrahedron normal of 4 taps `eps` away."""
    acc = torch.zeros_like(p)
    for tap in TAPS:
        k = p.new_tensor(tap)
        acc = acc + k * scene(p + k * eps)[:, None]
    return acc


def lambert(scene: Scene, p, r: dict):
    """Albedo times Lambert (with the ambient floor) at hit points p."""
    n = normals(scene, p, float(r["normal_eps"]))
    lt = p - p.new_tensor(r["light_position"])
    dot = torch.sum(n * lt, dim=-1)
    diff = dot * (1.0 / torch.sqrt(torch.sum(n * n, -1) + 1e-20)) * (1.0 / torch.sqrt(torch.sum(lt * lt, -1) + 1e-20))
    diff = torch.clamp_min(diff, float(r["ambient"]))
    return p.new_tensor(r["albedo"])[None, :] * diff[:, None]


def floor(o, d, r: dict):
    """The checker floor's colour of each ray where it meets y = floor_y
    ahead of it, else black."""
    dy = d[:, 1]
    ok = torch.abs(dy) > 1e-8
    ft = (float(r["floor_y"]) - o[1]) / torch.where(ok, dy, torch.full_like(dy, 1e-8))
    fx = torch.clamp(o[0] + d[:, 0] * ft, -1e7, 1e7)
    fz = torch.clamp(o[2] + d[:, 2] * ft, -1e7, 1e7)
    parity = torch.bitwise_and(torch.bitwise_xor(torch.round(fx + 0.5).to(torch.int32),
                                                 torch.round(fz + 0.5).to(torch.int32)), 1).to(d.dtype)
    base = d.new_tensor(r["floor_base"])[None, :]
    col = base + float(r["floor_checker"]) * parity[:, None]
    return torch.where(((ft > 0.0) & ok)[:, None], col, torch.zeros_like(col))


def shade(scene: Scene, o, d, t, hit, r: dict):
    """Linear colour of each ray: Lambert at a hit, the floor on a miss."""
    col = floor(o, d, r)
    hi = torch.nonzero(hit).reshape(-1)
    if hi.numel():
        col[hi] = lambert(scene, o + d[hi] * t[hi, None], r)
    return col


def gamma(col):
    return torch.sqrt(torch.clamp_min(col, 0.0) + 1e-12)


def block_rows(width: int, r: dict) -> int:
    return max(1, BLOCK_RAYS // (width * int(r["aa_samples"]) ** 2))


def render(scene: Scene, cam, r: dict, width: int, height: int):
    """(image f32[H, W, 3], WorkCount) of the frame."""
    dev, dt = scene.device, scene.dtype
    s = int(r["aa_samples"]) ** 2
    bound = bound_sphere(scene.desc)
    img = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    work = WorkCount()
    step = block_rows(width, r)
    for i0 in range(0, height, step):
        i1 = min(height, i0 + step)
        with torch.no_grad():
            o, d = rays(r, cam, width, height, i0, i1, dt, dev)
            t, hit, steps = march(scene, o, d, r, bound)
            col = gamma(shade(scene, o, d, t, hit, r))
            img[i0:i1] = col.reshape(i1 - i0, width, s, 3).to(torch.float32).mean(dim=2)
        nh = int(hit.sum())
        work.add(WorkCount(d.shape[0], int(steps.sum()), nh, d.shape[0] - nh, s, int((steps > 0).sum())))
    return img, work


def _runs(rows):
    """Sorted rows -> [(start, stop)] of their consecutive runs."""
    out = []
    for i in rows:
        if out and out[-1][1] == i:
            out[-1][1] = i + 1
        else:
            out.append([i, i + 1])
    return [tuple(x) for x in out]


# --- the fit ------------------------------------------------------------------


def loss_and_grad(scene: Scene, cam, target, r: dict, width: int, height: int, rows=None, alter=None):
    """(loss, {name: gradient}, image) of mean((image - target)^2) over the
    image rows in `rows` (all by default), the mean taken over those rows.
    `alter(img)` changes the forward image in place (a planted fault)."""
    dev, dt = scene.device, scene.dtype
    aa = int(r["aa_samples"])
    s = aa * aa
    bound = bound_sphere(scene.desc)
    names = list(scene.params)
    grads = {k: torch.zeros_like(v) for k, v in scene.params.items()}
    row_set = list(range(height)) if rows is None else sorted(set(int(i) for i in rows))
    denom = float(len(row_set) * width * 3)
    img = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    hits = {}
    with torch.no_grad():
        for b0 in range(0, len(row_set), block_rows(width, r)):
            for i0, i1 in _runs(row_set[b0:b0 + block_rows(width, r)]):
                o, d = rays(r, cam, width, height, i0, i1, dt, dev)
                t, hit, _ = march(scene, o, d, r, bound)
                col = shade(scene, o, d, t, hit, r)
                img[i0:i1] = gamma(col).reshape(i1 - i0, width, s, 3).to(torch.float32).mean(dim=2)
                hits[(i0, i1)] = (t, hit, col)
        if alter is not None:
            alter(img)
        resid = torch.zeros_like(img)
        resid[row_set] = img[row_set] - target[row_set].to(torch.float32)
        loss = float(torch.sum(resid * resid)) / denom
    live = {k: v.detach().requires_grad_(True) for k, v in scene.params.items()}
    gscene = Scene(scene.desc, dt, dev, live)
    fixed = Scene(scene.desc, dt, dev, {k: v.detach() for k, v in scene.params.items()})
    params = [live[k] for k in names]
    for (i0, i1), (t, hit, col) in hits.items():
        hi = torch.nonzero(hit).reshape(-1)
        if hi.numel() == 0:
            continue
        o, d = rays(r, cam, width, height, i0, i1, dt, dev)
        d = d[hi]
        t = t[hi]
        # d loss / d colour of each hit sample: 2 resid / denom, the AA
        # mean's 1 / s, and the gamma's derivative.
        px = hi // s
        w = 2.0 * resid[i0:i1].reshape(-1, 3)[px].to(dt) / denom / s
        w = w * 0.5 / torch.sqrt(torch.clamp_min(col[hi], 0.0) + 1e-12) * (col[hi] > 0.0)
        with torch.enable_grad():
            p0 = (o + d * t[:, None]).detach().requires_grad_(True)
            (gx,) = torch.autograd.grad(fixed(p0).sum(), p0)
            fd = torch.sum(gx * d, dim=-1)
            c = float(r["grad_denom_clamp"])
            den = torch.where(torch.abs(fd) > c, fd, torch.where(fd >= 0, torch.full_like(fd, c), torch.full_like(fd, -c)))
            f = gscene(p0.detach())
            t_d = t - (f - f.detach()) / den
            surf = torch.sum(w * lambert(gscene, o + d * t_d[:, None], r))
            gs = torch.autograd.grad(surf, params, allow_unused=True)
        for k, g in zip(names, gs):
            if g is not None:
                grads[k] += g
    return loss, grads, img


@dataclasses.dataclass
class Adam:
    """torch.optim.Adam's update, written out: m, v, bias corrections."""

    lr: float
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    t: int = 0
    m: dict = dataclasses.field(default_factory=dict)
    v: dict = dataclasses.field(default_factory=dict)

    def step(self, params: dict, grads: dict) -> dict:
        self.t += 1
        out = {}
        for k, p in params.items():
            g = grads[k]
            m = self.m.get(k, torch.zeros_like(p)) * self.beta1 + (1 - self.beta1) * g
            v = self.v.get(k, torch.zeros_like(p)) * self.beta2 + (1 - self.beta2) * g * g
            self.m[k], self.v[k] = m, v
            bc1 = 1 - self.beta1 ** self.t
            bc2 = 1 - self.beta2 ** self.t
            out[k] = (p - (self.lr / bc1) * m / (torch.sqrt(v) / math.sqrt(bc2) + self.eps)).detach()
        return out


def fit(desc, cam, target, r: dict, width: int, height: int, steps: int, lr: float, dtype, device):
    """The reference's first `steps` fit steps from `desc`: {"losses": [..],
    "grad1": {name: first gradient}, "params": [{name: value} before each
    step and after the last]}."""
    params = {f"{i}.{k}": torch.as_tensor(v, dtype=dtype, device=device)
              for i, leaf in enumerate(leaves(desc)) for k, v in leaf.params.items()}
    adam = Adam(lr)
    out = {"losses": [], "grad1": None, "params": [params]}
    for _ in range(steps):
        scene = Scene(desc, dtype, device, params)
        loss, grads, _ = loss_and_grad(scene, cam, target, r, width, height)
        out["losses"].append(loss)
        if out["grad1"] is None:
            out["grad1"] = grads
        params = adam.step(params, grads)
        out["params"].append(params)
    return out
