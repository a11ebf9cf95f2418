"""The work count and the roofline arithmetic on frames counted by hand."""

import math

import pytest
import torch

from bench_port import reference as ref
from bench_port import scene as sc
from bench_port import tracewin, yardstick

R = {"aa_samples": 1, "fovy": math.pi / 2, "min_dist": 0.01, "max_dist": 100.0, "max_iter": 100,
     "normal_eps": 1e-4, "light_position": [2.0, -5.0, 3.0], "ambient": 0.02, "albedo": [0.4, 0.7, 0.1],
     "floor_y": -1.5, "floor_base": [0.1, 0.1, 0.2], "floor_checker": 0.2}


def test_a_one_sphere_frame_counted_by_hand():
    """A 1x1 frame, one ray from the origin down -z, at a unit sphere
    centred at z = -5: hit in 2 steps, priced by hand."""
    desc = sc.describe({"sphere": {"center": [0.0, 0.0, -5.0], "radius": 1.0}}, 0)
    cam = sc.look_at((0.0, 0.0, 0.0), (0.0, 0.0, -1.0))
    assert torch.allclose(torch.tensor(cam[1]), torch.tensor([1.0, 0.0, 0.0, 0.0]))
    scene = ref.Scene(desc, torch.float64, "cpu")
    o, d = ref.rays(R, cam, 1, 1, 0, 1, torch.float64, "cpu")
    t, hit, steps = ref.march(scene, o, d, R, sc.bound_sphere(desc))
    # From t = 0 the distance is 4, then 0 at t = 4: two evaluations, a hit.
    assert hit.tolist() == [True] and steps.tolist() == [2] and float(t[0]) == pytest.approx(4.0)
    _, work = ref.render(scene, cam, R, 1, 1)
    assert (work.rays, work.marched, work.steps, work.hits, work.misses, work.samples) == (1, 1, 2, 1, 0, 1)
    eval_ops = ref.eval_ops(desc, yardstick.LEAF_OPS, yardstick.COMBINE_OPS)
    assert eval_ops == 11
    flops, nbytes = yardstick.frame_work(work, eval_ops, 1, 1, 16 * 4)
    # raygen 60; the ending step 14 + 11; the pixel's march 2 x 25; taps 4 x 11 and shading 60.
    assert flops == 60 + 25 + 2 * 25 + 44 + 60
    assert nbytes == 12 + 64
    ms, by = yardstick.roofline(flops, nbytes)
    assert by == "bytes" and ms == pytest.approx(76 / 3.35e12 * 1e3)


def test_a_missed_ray_costs_its_floor():
    """A ray that misses the bounding sphere takes no step: raygen and the
    floor alone."""
    desc = sc.describe({"sphere": {"center": [0.0, 0.0, -5.0], "radius": 1.0}}, 0)
    cam = sc.look_at((0.0, 0.0, 0.0), (0.0, 0.0, 1.0))  # looking away
    _, work = ref.render(ref.Scene(desc, torch.float64, "cpu"), cam, R, 1, 1)
    assert (work.rays, work.marched, work.steps, work.hits, work.misses) == (1, 0, 0, 0, 1)
    assert yardstick.frame_work(work, 11, 1, 1, 0)[0] == 60 + 40


def test_scene_operation_prices():
    desc = sc.describe(["subtract", ["union", {"sphere": {"center": [0, 0, 0], "radius": 1}},
                                     {"box": {"center": [1, 0, 0], "half_extents": [1, 1, 1]}}],
                        {"torus": {"center": [0, 1, 0], "major_radius": 1, "minor_radius": 0.2}}], 0)
    assert ref.eval_ops(desc, yardstick.LEAF_OPS, yardstick.COMBINE_OPS) == 11 + 25 + 1 + 17 + 2
    union = sc.SphereUnion(torch.zeros(64, 4).numpy())
    assert ref.eval_ops(union, yardstick.LEAF_OPS, yardstick.COMBINE_OPS) == 64 * 11 + 63


def test_busy_idle_and_gaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert yardstick.merge(spans) == [(0.0, 2.0), (3.0, 4.0)]
    assert yardstick.busy(spans) == 3.0
    assert yardstick.gaps(spans, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    tr = tracewin.Trace(6.0, 3, [("void rmt::fine_kernel<0>(int)", 0.0, 1.0), ("k", 0.5, 2.0), ("k", 3.0, 4.0)],
                        [("enqueue", 1.9, 3.5), ("wait", 4.0, 5.0)], -1.0, 5.0)
    assert tr.busy_s == 3.0 and tr.kernel_s(r"\bfine_kernel") == 1.0
    nccl = tracewin.Trace(4.0, 2, [("k", 0.0, 1.0), ("ncclDevKernel_AllReduce_Sum_f32", 0.5, 3.0)], [], 0.0, 4.0)
    assert nccl.busy_s == 3.0 and nccl.compute_busy_s == 1.0
    b = tr.breakdown()
    assert b["device_ops"][0] == ["k", 2.5] and ["rmt::fine_kernel<0>", 1.0] in b["device_ops"]
    assert b["idle_gaps"][0][0] in ("enqueue", "wait", "outside the benchmark's spans")
