"""The system under test behind the calls the harness times, and what stands
in its place for the control and the planted faults.

- `PortView`, `PortFit`: the port's entries as a user calls them:
  `make_renderer` or `make_sharded_renderer` for frames, `make_fit_step` and
  torch's Adam for fit steps. The port compiles the benchmark's scene
  description itself (its DSL, or its native encoder for a sphere union).
- `ReferenceView`, `ReferenceFit`: the reference put in the program's place,
  in a given dtype (the control: bfloat16) and with a planted fault.

A fault (`--fault` of `control.py`, and the tests) breaks the timed path:

- "stale": a frame returns the previous frame's image; a fit step returns
  the parameters it was given (its state unchanged);
- "half": half of the image's rows are left out: a frame renders only its
  top half, a fit step takes the loss's mean over the top half alone;
- "alter": an answer altered where it is produced: a block of 1/4 x 1/4
  of the image (a tile written wrong) is brightened by 0.25 in every frame
  (in a fit step, in the image its loss reads);
- "no_gather": the exchange between ranks left out (a sharded frame keeps
  only this rank's bands);
- "negate": a fit step that climbs the loss (its gradient negated before
  the optimizer gets it).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import reference as ref
from .scene import Op, SphereUnion, leaves

FAULTS = ("stale", "half", "alter", "no_gather", "negate")


def alter_block(img) -> None:
    """Brighten the top-left 1/4 x 1/4 block of an image in place."""
    h, w = img.shape[0], img.shape[1]
    img[: max(1, h // 4), : max(1, w // 4)] += 0.25


def render_config(r: dict):
    import raymarch_tpu_torch as rt

    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in r.items()}
    return rt.RenderConfig(**kw)


def port_scene(desc):
    """(spec, arrays) of the description, compiled by the port."""
    import raymarch_tpu_torch as rt

    if isinstance(desc, SphereUnion):
        return rt.compile_wire(rt.native.build_sphere_union(desc.spheres), static=True)

    def node(n):
        if isinstance(n, Op):
            a, b = node(n.a), node(n.b)
            return {"union": a | b, "subtract": a - b, "intersect": a & b}[n.kind]
        p = {k: tuple(float(x) for x in v) for k, v in n.params.items()}
        if n.kind == "sphere":
            return rt.sphere(center=p["center"], radius=p["radius"][0])
        if n.kind == "box":
            return rt.box(center=p["center"], half_extents=p["half_extents"])
        return rt.torus(center=p["center"], major_radius=p["major_radius"][0], minor_radius=p["minor_radius"][0])

    return rt.compile_scene(node(desc), static=True)


def leaf_slots(desc, leaf_params: np.ndarray) -> dict:
    """{"<leaf>.<name>": (row, columns)} of the description's parameters in
    the port's leaf rows (rows matched by kind and value)."""
    cols = {"center": slice(4, 7), "radius": slice(7, 8), "half_extents": slice(7, 10),
            "major_radius": slice(7, 8), "minor_radius": slice(8, 9)}
    out, used = {}, set()
    lp = np.asarray(leaf_params, np.float32)
    for i, leaf in enumerate(leaves(desc)):
        want = np.concatenate([leaf.params[k] for k in leaf.params])
        row = next(r for r in range(lp.shape[0]) if r not in used and np.array_equal(
            np.concatenate([lp[r, cols[k]] for k in leaf.params]), want))
        used.add(row)
        for k in leaf.params:
            out[f"{i}.{k}"] = (row, cols[k])
    return out


class PortView:
    """Frames of the port's renderer: `make_renderer(..., "forward",
    backend)` with `ranks` 0, or `make_sharded_renderer` over `mesh`."""

    def __init__(self, desc, r: dict, width, height, traffic: dict, device, mesh=None, fault=None):
        import raymarch_tpu_torch as rt
        from raymarch_tpu_torch.parallel import make_sharded_renderer

        self.spec, self.arrays = port_scene(desc)
        cfg = render_config(r)
        if traffic["entry"] == "make_renderer":
            self.render = rt.make_renderer(self.spec, width, height, cfg, mode="forward",
                                           backend=traffic["backend"], device=device)
        else:
            if fault == "no_gather":
                import raymarch_tpu_torch.parallel.render as pr

                pr.all_reduce_sum = lambda x, mesh: x  # the planted fault: no exchange
            self.render = make_sharded_renderer(self.spec, width, height, mesh, cfg, backend=traffic["backend"],
                                                row_interleave=int(traffic.get("row_interleave", 1)))
        self.fault = fault if fault != "no_gather" else None
        self.last = None
        self.Camera = rt.Camera

    def __call__(self, cam):
        img = self.render(self.arrays, self.Camera(position=cam[0], rotation=cam[1]))
        if self.fault is not None:
            img = _fault_frame(self, img)
        return img


def _fault_frame(prog, img):
    if prog.fault == "stale":
        prev, prog.last = prog.last, img
        return img if prev is None else prev
    if prog.fault == "half":
        img = img.clone()
        img[img.shape[0] // 2:] = 0.0
        return img
    if prog.fault == "alter":
        img = img.clone()
        alter_block(img)
        return img
    return img


class ReferenceView:
    """The reference renderer in the program's place."""

    def __init__(self, desc, r, width, height, dtype, device, fault=None):
        self.scene = ref.Scene(desc, dtype, device)
        self.r, self.width, self.height, self.fault, self.last = r, width, height, fault, None

    def __call__(self, cam):
        img = ref.render(self.scene, cam, self.r, self.width, self.height)[0]
        return _fault_frame(self, img) if self.fault else img


class PortFit:
    """Fit steps of the port: `make_fit_step(..., backend, mode)` on a mesh
    of one, torch's Adam at `lr`, the loss read every step (fit_scene's
    loop); `reset(k)` starts a new fit from the k-th of `starts`."""

    def __init__(self, starts: list, r: dict, width, height, traffic: dict, device, target, fault=None):
        from raymarch_tpu_torch.parallel import make_fit_step, make_mesh

        compiled = [port_scene(desc) for desc in starts]
        spec = compiled[0][0]
        if any(s != spec for s, _ in compiled):
            raise ValueError("the fit's starts must share one tape layout")
        self.slots = leaf_slots(starts[0], compiled[0][1].leaf_params)
        cfg = render_config(r)
        self.step_fn = make_fit_step(spec, width, height, make_mesh(device=device),
                                     functools.partial(torch.optim.Adam, lr=float(traffic["lr"])), cfg,
                                     mode=traffic["mode"], backend=traffic["backend"])
        dev = self.step_fn.device
        self.starts = [dataclasses.replace(a, leaf_params=torch.as_tensor(a.leaf_params, device=dev),
                                           op_param=torch.as_tensor(a.op_param, device=dev)) for _, a in compiled]
        self.target = torch.as_tensor(target, device=dev)
        self.reset(0)

    def reset(self, k: int) -> None:
        """Start a new fit from start k: its parameters, a new Adam state."""
        self.arrays = self.starts[k]
        self.opt_state = self.step_fn.init_opt_state(self.arrays)

    def step(self, cam):
        """One step at the camera; returns the loss as a 0-d tensor (not
        read)."""
        import raymarch_tpu_torch as rt

        a, _, self.opt_state, loss = self.step_fn(self.arrays, rt.Camera(position=cam[0], rotation=cam[1]),
                                                 self.opt_state, self.target)
        self.arrays = a
        return loss

    def values(self) -> dict:
        """{"<leaf>.<name>": the parameter's current value (f32 tensor)}."""
        lp = self.arrays.leaf_params.detach()
        return {k: lp[row, c].clone() for k, (row, c) in self.slots.items()}

    def first_grad(self) -> dict:
        """The first step's gradient as Adam got it, from its state after
        one step: exp_avg / (1 - beta1)."""
        opt = self.opt_state.optimizer
        p = self.opt_state.params[0]
        m = opt.state[p]["exp_avg"] / (1.0 - opt.param_groups[0]["betas"][0])
        return {k: m[row, c].detach().clone() for k, (row, c) in self.slots.items()}


class ReferenceFit:
    """The reference's fit steps in the program's place, in `dtype`, with a
    planted fault."""

    def __init__(self, starts: list, r, width, height, traffic, device, target, dtype, fault=None):
        self.starts, self.r, self.width, self.height = starts, r, width, height
        self.dtype, self.device, self.fault = dtype, device, fault
        self.target = torch.as_tensor(target, device=device)
        self.lr = float(traffic["lr"])
        self.grad1 = None
        self.reset(0)

    def reset(self, k: int) -> None:
        self.desc = self.starts[k]
        self.params = {f"{i}.{name}": torch.as_tensor(v, dtype=self.dtype, device=self.device)
                       for i, leaf in enumerate(leaves(self.desc)) for name, v in leaf.params.items()}
        self.adam = ref.Adam(self.lr)

    def step(self, cam):
        scene = ref.Scene(self.desc, self.dtype, self.device, self.params)
        rows = range(self.height // 2) if self.fault == "half" else None
        loss, grads, _ = ref.loss_and_grad(scene, cam, self.target, self.r, self.width, self.height, rows=rows,
                                           alter=alter_block if self.fault == "alter" else None)
        if self.fault == "negate":
            grads = {k: -g for k, g in grads.items()}
        if self.grad1 is None:
            self.grad1 = {k: g.to(torch.float32) for k, g in grads.items()}
        new = self.adam.step(self.params, grads)
        if self.fault != "stale":
            self.params = new
        return torch.tensor(loss)

    def values(self) -> dict:
        return {k: v.to(torch.float32).clone() for k, v in self.params.items()}

    def first_grad(self) -> dict:
        return self.grad1

