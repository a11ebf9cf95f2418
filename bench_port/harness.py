"""One run of one cell on one rank: set-up, the measured window, the traced
window, and the check of what the window produced against the reference.

A traffic mix (`workloads/<traffic>.json`) is read by `run_rank`, the one
generator: its `kind` is "frames" (a viewer: an orbiting camera, frames
dispatched ahead with at most `in_flight` unfinished) or "fit" (inverse
rendering: fit steps toward a target, the loss read every step). Its other
keys are parameters: the entry and backend, the orbit's step, the frames
kept for the check, the fit's perturbation and learning rate.

The draws of a run come from its seed: the orbit's start angle, the fit's
start, the frames kept for the check (a reservoir sample over the window),
and where the configuration says so the scene itself.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import sys
import time

import numpy as np
import torch

from . import reference as ref
from . import scene as sc
from . import tracewin, yardstick
from .program import PortFit, PortView, ReferenceFit, ReferenceView

REF_DTYPES = {"control": torch.bfloat16, "reference": torch.float32}


@dataclasses.dataclass
class Run:
    """What one rank's run measured; the metric readers read it."""

    kind: str  # "frames" or "fit"
    seconds: float
    window_s: float = 0.0  # the measured window, host clock
    units: int = 0  # frames or steps completed in it
    setup_s: float = 0.0
    host_s: list = dataclasses.field(default_factory=list)  # host span of each entry call
    intervals_ms: list = dataclasses.field(default_factory=list)  # frames: completion to completion
    failed: int = 0
    trace: object = None  # tracewin.Trace of the traced window
    bound_ms: float = None  # roofline bound of one frame, from the reference's work
    readings: dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    reference_s: float = 0.0
    ranks: int = 1  # the cards that share each frame


class Clock:
    """Completion marks of the work queued so far: CUDA events on the card,
    the host clock on the CPU (whose ops finish when they return)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def wait(self, m) -> None:
        if self.cuda:
            m.synchronize()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


class Reservoir:
    """A uniform sample of k items from a stream, drawn from `rng`."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.n, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.n + 1))
            if j < self.k:
                self.items[j] = item
        self.n += 1


def _record(name):
    return torch.profiler.record_function(f"bench.{name}")


class StopFlag:
    """Agreement of the ranks on when the window ends: every `every`-th
    frame carries this rank's "time is up" through one all_reduce(MAX)
    queued behind it, and every rank reads the reduced flag of such a frame
    once that frame is complete, so all ranks stop after the same frame.
    The frames between carry no collective but the program's own gather.
    Two sets of buffers alternate from one carrying frame to the next."""

    def __init__(self, mesh, every: int):
        import torch.distributed as dist

        self.dist, self.mesh, self.every = dist, mesh, every
        pin = mesh.device.type == "cuda"
        self.up = [torch.zeros(1, dtype=torch.int32, pin_memory=pin) for _ in range(2)]
        self.down = [torch.zeros(1, dtype=torch.int32, pin_memory=pin) for _ in range(2)]
        self.dev = [torch.zeros(1, dtype=torch.int32, device=mesh.device) for _ in range(2)]

    def carries(self, i: int) -> bool:
        return i % self.every == 0

    def push(self, i: int, done: bool) -> None:
        k = (i // self.every) % 2
        self.up[k][0] = int(done)
        self.dev[k].copy_(self.up[k], non_blocking=True)
        self.dist.all_reduce(self.dev[k], op=self.dist.ReduceOp.MAX, group=self.mesh.group)
        self.down[k].copy_(self.dev[k], non_blocking=True)

    def read(self, i: int) -> bool:
        return bool(self.down[(i // self.every) % 2][0])

    def barrier(self) -> None:
        """All ranks meet: one all_reduce of a zero of its own (never a
        frame's buffers), then this rank's card synchronised."""
        zero = torch.zeros(1, dtype=torch.int32, device=self.mesh.device)
        self.dist.all_reduce(zero, group=self.mesh.group)
        if zero.is_cuda:
            torch.cuda.synchronize(zero.device)


def frames_loop(run: Run, prog, cams, clock: Clock, state: dict, seconds: float, in_flight: int, keep=None,
                flag: StopFlag = None):
    """Frames for `seconds` (with `flag`: until the ranks agree to stop),
    at most `in_flight` unfinished; appends host spans and completion
    marks to `state`."""
    marks = state["marks"]
    t0 = time.perf_counter()
    first = state["i"]
    while True:
        i = state["i"]
        if len(marks) >= in_flight:
            with _record("wait"):
                clock.wait(marks[-in_flight])
            j = i - in_flight
            if flag is not None and j >= first and flag.carries(j) and flag.read(j):
                break
        with _record("camera"):
            cam = cams(i)
        h0 = time.perf_counter()
        with _record("enqueue"):
            img = prog(cam)
        state["host"].append(time.perf_counter() - h0)
        done = time.perf_counter() - t0 >= seconds
        if flag is not None and flag.carries(i):
            flag.push(i, done)
        marks.append(clock.mark())
        if keep is not None:
            keep.offer((i, img, cam))
        state["i"] = i + 1
        if flag is None and done:
            break
    clock.sync()


def fit_loop(run: Run, prog, cam, state: dict, seconds: float, restart_every: int, order: list):
    """Fit steps for `seconds`, the loss read after each; every
    `restart_every` steps a new fit starts, from the next start in `order`."""
    t0 = time.perf_counter()
    while True:
        if state["i"] % restart_every == 0:
            with _record("restart"):
                prog.reset(order[(state["i"] // restart_every) % len(order)])
        h0 = time.perf_counter()
        with _record("enqueue"):
            loss = prog.step(cam)
        state["host"].append(time.perf_counter() - h0)
        with _record("loss_read"):
            value = float(loss)
        if not math.isfinite(value):
            run.failed += 1
        state["i"] += 1
        if time.perf_counter() - t0 >= seconds:
            break


def _frame_readings(img, want) -> dict:
    if not bool(torch.isfinite(img).all()):
        return {"mean_abs": math.inf, "bad_px": 1.0}
    d = (img.to(torch.float32) - want).abs()
    return {"mean_abs": float(d.mean()), "bad_px": float((d.amax(dim=-1) > 0.1).to(torch.float32).mean())}


def _norm(v) -> float:
    return float(torch.linalg.vector_norm(v.to(torch.float32)))


def moved_leaves(grad: dict) -> list:
    """The fit's leaves whose reference gradient is not nought to rounding:
    its norm at least a thousandth of the median leaf's."""
    gn = {k: _norm(v) for k, v in grad.items()}
    med = statistics.median(gn.values())
    return [k for k, g in gn.items() if g >= 1e-3 * med]


def _norm_gaps(prog: dict, refv: dict, keys: list) -> list:
    """Each leaf's gap between the program's norm and the reference's,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger, over the leaves `keys`."""
    rn = {k: _norm(refv[k]) for k in keys}
    med = statistics.median(rn.values())
    return [abs(_norm(prog[k].cpu()) - r) / max(r, med) for k, r in rn.items()]


def _diff_gaps(prog: dict, refv: dict, keys: list) -> list:
    """Each leaf's norm of the program's value less the reference's,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger, over the leaves `keys`."""
    rn = {k: _norm(refv[k]) for k in keys}
    med = statistics.median(rn.values())
    return [_norm(prog[k].cpu() - refv[k].cpu()) / max(r, med) for k, r in rn.items()]


def checks(readings: list, limits: dict) -> dict:
    """{number: {"value", "limit"}} of the cell's compared numbers, each
    the worst over the ranks' readings (a number missing reads inf)."""
    out = {}
    for k, limit in limits.items():
        vals = [r.get(k) for r in readings]
        out[k] = {"value": math.inf if any(v is None for v in vals) else max(vals), "limit": limit}
    return out


def passes(checked: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checked.values())


def run_rank(cell: dict, seed: int, seconds: float, trace: bool, device, *, mesh=None, program="port",
             fault=None, size=None, t0=None, trace_seconds=None, warmup=None) -> Run:
    """One rank's run of the cell. `program` is "port", or "control" /
    "reference" (the reference in the program's place, in bfloat16 or
    float32); `fault` plants one of program.FAULTS; `size` = (W, H)
    overrides the configuration's (tests on the CPU), `warmup` the warm-up
    frames (the control's runs)."""
    config, traffic = cell["config"], cell["traffic"]
    device = torch.device(device)
    t0 = time.perf_counter() if t0 is None else t0
    width, height = size or (config["width"], config["height"])
    r = config["render"]
    rank = 0 if mesh is None else mesh.rank
    rng = np.random.default_rng(seed)
    desc = sc.describe(config["scene"], seed)
    angle0 = float(rng.uniform(0.0, 2.0 * math.pi))
    clock = Clock(device)
    run = Run(kind=traffic["kind"], seconds=seconds, ranks=1 if mesh is None else mesh.size)
    state = {"i": 0, "host": [], "marks": []}
    trace_seconds = min(seconds, float(traffic.get("trace_seconds", 3.0))) if trace_seconds is None else trace_seconds
    cuda = device.type == "cuda"

    if run.kind == "frames":
        deg = float(traffic["orbit_deg_per_frame"])
        period = round(360.0 / deg) if abs(360.0 / deg - round(360.0 / deg)) < 1e-9 else None
        poses = {}

        def cams(i):
            """Frame i's camera; an orbit of whole steps repeats its poses."""
            k = i % period if period else i
            if k not in poses:
                poses[k] = sc.orbit_camera(config["camera"], angle0 + k * math.radians(deg))
            return poses[k]

        if cuda:
            torch.cuda.init()
            torch.cuda.reset_peak_memory_stats(device)
        t_prog = time.perf_counter()
        if program == "port":
            prog = PortView(desc, r, width, height, traffic, device, mesh=mesh, fault=fault)
        else:
            prog = ReferenceView(desc, r, width, height, REF_DTYPES[program], device, fault=fault)
        in_flight = int(traffic["in_flight"])
        flag = None
        if mesh is not None and mesh.size > 1:
            flag = StopFlag(mesh, int(traffic.get("stop_every", 16)))
            if in_flight > 2 * flag.every:  # a flag's buffers are free again after two periods
                raise ValueError("in_flight must stay within two periods of the stop flag")
        # Set-up: every shape of the window, then an empty queue.
        t_warm = time.perf_counter()
        for _ in range(int(traffic.get("warmup_frames", 3)) if warmup is None else warmup):
            prog(cams(state["i"]))
            state["i"] += 1
        clock.sync()
        if flag is not None:  # the ranks start their windows together
            flag.push(0, False)
            clock.sync()
        keep = Reservoir(int(traffic["check_frames"]), np.random.default_rng([seed, rank, 1]))
        state["marks"] = [clock.mark()]
        run.setup_s = time.perf_counter() - t0
        print(f"bench_port: set-up {run.setup_s:.2f} s: the program built at {t_prog - t0:.2f} s, warm from "
              f"{t_warm - t0:.2f} s", file=sys.stderr)
        w0 = time.perf_counter()
        frames_loop(run, prog, cams, clock, state, seconds, in_flight, keep, flag)
        run.window_s = time.perf_counter() - w0
        marks = state["marks"]
        run.units = len(marks) - 1
        run.intervals_ms = [clock.ms(marks[k - 1], marks[k]) for k in range(1, len(marks))]
        run.host_s = list(state["host"])
        if trace:
            # On a mesh the ranks' profilers start at different times: the
            # ranks meet once every profiler records, so no rank's window
            # holds the first gather's wait for the others.
            state["marks"] = [clock.mark()]
            run.trace = tracewin.traced(lambda: frames_loop(run, prog, cams, clock, state, trace_seconds,
                                                            in_flight, None, flag),
                                        lambda: len(state["marks"]), cuda,
                                        align=None if flag is None else flag.barrier)
        if cuda:
            run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
        del prog
        r0 = time.perf_counter()
        scene_ref = ref.Scene(desc, torch.float32, device)
        eval_ops = ref.eval_ops(desc, yardstick.LEAF_OPS, yardstick.COMBINE_OPS)
        readings, bounds = [], []
        for _, img, cam in keep.items:
            want, work = ref.render(scene_ref, cam, r, width, height)
            readings.append(_frame_readings(img, want))
            flops, nbytes = yardstick.frame_work(work, eval_ops, width, height, tape_bytes(desc))
            bounds.append(yardstick.roofline(flops, nbytes)[0])
        run.readings = {k: max(x[k] for x in readings) for k in ("mean_abs", "bad_px")} if readings else {}
        run.bound_ms = statistics.mean(bounds) if bounds else None
        run.reference_s = time.perf_counter() - r0
        return run

    # A fit: the target from the true scene at the configuration's camera,
    # made by the reference (an input both sides get), then the program's
    # fits of `restart_every` steps, each from one of a fixed set of
    # perturbed starts, in an order drawn from the seed: every seed does the
    # same work. The first fit's first steps are checked.
    cam = sc.orbit_camera(config["camera"], 0.0)
    start_rng = np.random.default_rng(int(traffic["start_seed"]))
    starts = [sc.perturb(desc, start_rng, float(traffic["perturb"])) for _ in range(int(traffic["starts"]))]
    order = [int(k) for k in rng.permutation(len(starts))]
    starts = [starts[k] for k in order]
    order = list(range(len(starts)))
    start = starts[0]
    r_target = time.perf_counter()
    with torch.no_grad():
        target, _ = ref.render(ref.Scene(desc, torch.float32, device), cam, r, width, height)
    target_s = time.perf_counter() - r_target  # the reference's: counted in reference_s, not in setup_s
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t_prog = time.perf_counter()
    if program == "port":
        prog = PortFit(starts, r, width, height, traffic, device, target, fault=fault)
    else:
        prog = ReferenceFit(starts, r, width, height, traffic, device, target, REF_DTYPES[program], fault=fault)
    n_check = int(traffic["check_steps"])
    t_steps = time.perf_counter()
    v0 = prog.values()
    losses = []
    for k in range(n_check):
        losses.append(float(prog.step(cam)))
        if k == 0:
            grad1 = prog.first_grad()
    v_end = prog.values()
    state["i"] = n_check
    run.setup_s = time.perf_counter() - t0 - target_s
    print(f"bench_port: set-up {run.setup_s:.2f} s: the program built at {t_prog - t0:.2f} s, its first "
          f"steps from {t_steps - t0:.2f} s", file=sys.stderr)
    w0 = time.perf_counter()
    restart = int(traffic["restart_every"])
    fit_loop(run, prog, cam, state, seconds, restart, order)
    run.window_s = time.perf_counter() - w0
    run.units = state["i"] - n_check
    run.host_s = list(state["host"])
    if trace:
        run.trace = tracewin.traced(lambda: fit_loop(run, prog, cam, state, trace_seconds, restart, order),
                                    lambda: state["i"], cuda)
    if cuda:
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    del prog
    r0 = time.perf_counter()
    want = ref.fit(start, cam, target, r, width, height, n_check, float(traffic["lr"]), torch.float32, device)
    keys = moved_leaves(want["grad1"])
    change = {k: v_end[k].cpu() - v0[k].cpu() for k in v0}
    ref_change = {k: want["params"][-1][k] - want["params"][0][k] for k in v0}
    # Every step's loss, and by the worst leaf the first gradient's norm and
    # the change after the steps: by the gap of its norm, and by the norm of
    # the difference, which keeps its sign (a step that climbs the loss).
    # The cell's limits file names those compared.
    run.readings = {
        "loss_gap": max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf
                        for a, b in zip(losses, want["losses"])),
        "grad_gap": max(_norm_gaps(grad1, want["grad1"], keys)),
        "step_gap": max(_norm_gaps(change, ref_change, keys)),
        "step_diff": max(_diff_gaps(change, ref_change, keys)),
    }
    run.reference_s = time.perf_counter() - r0 + target_s
    return run


def tape_bytes(desc) -> int:
    """Bytes of the scene as read once: each leaf's parameter row of 16
    words (a sphere union: one row a sphere) and one word a combine."""
    if isinstance(desc, sc.SphereUnion):
        n = desc.spheres.shape[0]
        return (16 * n + n - 1) * 4
    n = len(sc.leaves(desc))
    return (16 * n + n - 1) * 4


def forbidden_modules() -> list[str]:
    """Modules of jax, jaxlib, flax or the JAX package in this process, by
    their whole top-level name."""
    bad = {"jax", "jaxlib", "flax", "raymarch_tpu"}
    return sorted({m for m in sys.modules if m.split(".")[0] in bad})
