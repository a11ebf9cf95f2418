"""The port's spans and counters (`utils/profiling.py`) on the CPU: nothing
is recorded while no profiler records; under a profiler the renderers'
frames give their span tree, both as records and as `rmt.*` events of the
profiler; a frame carries the counters' growth; the spans add no torch
operation to a frame; and the benchmark's readers of the spans.
"""

import collections
import dataclasses
import statistics
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import raymarch_tpu_torch as rt
from raymarch_tpu_torch.ops import cuda_march as cm
from raymarch_tpu_torch.ops import cuda_prepass as cp
from raymarch_tpu_torch.parallel import make_mesh, make_sharded_renderer
from raymarch_tpu_torch.utils import profiling
from raymarch_tpu_torch.utils.profiling import Span

torch.set_num_threads(1)

W, H = 24, 16
CFG = dataclasses.replace(rt.DEFAULT_CONFIG, aa_samples=2, max_iter=40, bound_accel=True, exit_check_every=4)
CAM = rt.Camera.looking_at(position=(0.0, 2.6, 4.2), target=(0.0, 0.0, 0.0))
NEW_METRICS = ("upload_ms.frame", "launch_ms.frame", "renderer_self_ms.frame", "launches.frame",
               "upload_bytes.frame", "band_host_ms.frame4k_x4")


@pytest.fixture(scope="module")
def scene():
    return rt.compile_scene(rt.sphere(radius=1.0) | rt.box(center=(0.8, 0.0, 0.0), half_extents=(0.5, 0.5, 0.5)),
                            static=True)


@pytest.fixture(scope="module")
def renderers(scene):
    """make_renderer's frame and the sharded frame (a world of one, two
    bands), each run once so that every cache is warm."""
    spec, arrays = scene
    single = rt.make_renderer(spec, W, H, CFG, mode="forward", backend="pallas_prepass", device="cpu")
    sharded = make_sharded_renderer(spec, W, H, make_mesh(device="cpu"), CFG, backend="pallas_prepass",
                                    row_interleave=2)
    for r in (single, sharded):
        r(arrays, CAM)
    return {"single": single, "sharded": sharded}


@pytest.fixture(autouse=True)
def empty_store():
    profiling.reset()
    yield
    profiling.reset()


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def _tree(spans):
    """[(name, parent's name or None, frame)] of the records."""
    return [(s.name, None if s.parent is None else spans[s.parent].name, s.frame) for s in spans]


def test_nothing_is_recorded_while_no_profiler_records(renderers, scene, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) while no profiler records")

    monkeypatch.setattr(profiling, "_record_function", refuse)
    for r in renderers.values():
        r(scene[1], CAM)
    assert profiling.spans() == []
    assert profiling.span("upload") is profiling.span("band", row=3) is profiling.frame()


def test_make_renderer_frame_gives_its_span_tree(renderers, scene):
    prof, _ = _profiled(lambda: renderers["single"](scene[1], CAM))
    spans = profiling.spans()
    assert _tree(spans) == [("frame", None, spans[0].frame)] + [
        (name, "frame", spans[0].frame) for name in ("upload", "upload", "launch.coarse", "launch.fine")]
    assert all(s.start_ns <= t.start_ns for s, t in zip(spans, spans[1:]))
    assert all(s.end_ns <= spans[0].end_ns and s.ms >= 0 for s in spans)
    assert spans[0].attrs == {"launches": 0, "h2d_bytes": 0}  # the CPU runs the plain versions, uploads nothing
    events = collections.Counter(e.name for e in prof.events() if e.name.startswith("rmt."))
    assert events == {"rmt.frame": 1, "rmt.upload": 2, "rmt.launch.coarse": 1, "rmt.launch.fine": 1}


def test_sharded_frame_gives_its_span_tree(renderers, scene):
    render = renderers["sharded"]
    prof, _ = _profiled(lambda: render(scene[1], CAM))
    spans = profiling.spans()
    tree = _tree(spans)
    k = spans[0].frame
    band = [("upload", "band", k), ("upload", "band", k), ("launch.coarse", "band", k), ("launch.fine", "band", k)]
    assert tree == ([("frame", None, k), ("upload", "frame", k)]
                    + ([("band", "frame", k)] + band) * len(render.bands) + [("gather", "frame", k)])
    assert [s.attrs["row"] for s in spans if s.name == "band"] == [i0 for i0, _ in render.bands] == [0, 8]
    events = collections.Counter(e.name for e in prof.events() if e.name.startswith("rmt."))
    assert events == {"rmt.frame": 1, "rmt.upload": 5, "rmt.band": 2, "rmt.launch.coarse": 2,
                      "rmt.launch.fine": 2, "rmt.gather": 1}


def test_frames_are_numbered_and_only_the_outermost_is_recorded(renderers, scene):
    def frames():
        renderers["single"](scene[1], CAM)
        with profiling.frame():
            renderers["single"](scene[1], CAM)

    _profiled(frames)
    spans = profiling.spans()
    heads = [s for s in spans if s.name == "frame"]
    assert len(heads) == 2 and heads[1].frame == heads[0].frame + 1
    assert all(s.frame == heads[1].frame for s in spans[spans.index(heads[1]):])
    assert [s.name for s in spans].count("upload") == 4


def test_a_frame_carries_the_counters_growth(renderers, scene, monkeypatch):
    for fn in (cp.fine, cm.image_pixels):
        monkeypatch.setattr(fn, "launches", fn.launches)  # restored after the test
    monkeypatch.setattr(profiling, "_h2d_bytes", profiling._h2d_bytes)
    before = profiling.counters()

    def frame():
        renderers["single"](scene[1], CAM)  # the plain versions: no launch, no upload
        with profiling.frame():
            cp.fine.count(types.SimpleNamespace(dynamic=False), types.SimpleNamespace(soft=False, ni=0))
            cm.image_pixels.launches += 1
            profiling.uploaded(torch.empty(4, dtype=torch.float32, device="meta"))
            profiling.uploaded(torch.empty(4, dtype=torch.float32))  # on the host: not an upload

    _profiled(frame)
    after = profiling.counters()
    grew = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert grew == {"cuda_prepass.fine.launches": 1, "cuda_march.image_pixels.launches": 1, "h2d_bytes": 16}
    heads = [s for s in profiling.spans() if s.name == "frame"]
    assert heads[0].attrs == {"launches": 0, "h2d_bytes": 0}
    assert heads[1].attrs == {"launches": 2, "h2d_bytes": 16}
    assert sum(h.attrs["launches"] for h in heads) == sum(v for k, v in grew.items() if k != "h2d_bytes")


def test_counters_name_every_counted_wrapper():
    c = profiling.counters()
    for name in cp._COUNTS:
        assert f"cuda_prepass.coarse.{name}" in c and f"cuda_prepass.fine_unpacked_res.{name}" in c
    for fn in ("ray_march", "image_march", "image_render", "image_pixels"):
        assert c[f"cuda_march.{fn}.launches"] == getattr(cm, fn).launches
    assert {"cuda_grad.bwd.launches", "cuda_grad.compact_bwd.soft_launches", "h2d_bytes"} <= set(c)
    assert all(isinstance(v, int) for v in c.values())


@pytest.mark.parametrize("which", ["single", "sharded"])
def test_spans_add_no_torch_operation_to_a_frame(renderers, scene, monkeypatch, which):
    """One frame under a CPU profiler records the same torch operations,
    names and counts, with the spans on and with their gate forced off."""
    render = renderers[which]

    def ops():
        prof, _ = _profiled(lambda: render(scene[1], CAM))
        return collections.Counter(e.name for e in prof.events() if not e.name.startswith("rmt."))

    on = ops()
    assert profiling.spans()
    profiling.reset()
    monkeypatch.setattr(profiling, "_recording", lambda: False)
    off = ops()
    assert profiling.spans() == []
    assert on == off and sum(on.values()) > 0


# The benchmark's readers of the spans (bench_port/metrics/).


def _span(name, t0, t1, parent, frame, **attrs):
    return Span(name, t0 * 1_000_000, t1 * 1_000_000, parent, frame, attrs)


# Two frames by hand, times in ms: a 10 ms frame with two uploads (1 + 2),
# two launches (2 + 3) and one 1 ms span of its own; and a sharded 20 ms
# frame with an upload (1), two bands (6 + 8, each with a 2 ms upload and a
# 3 ms launch inside) and a gather (1).
HAND = [
    _span("frame", 0, 10, None, 0, launches=2, h2d_bytes=300),
    _span("upload", 0, 1, 0, 0),
    _span("upload", 1, 3, 0, 0),
    _span("launch.coarse", 3, 5, 0, 0),
    _span("launch.fine", 5, 8, 0, 0),
    _span("cull", 8, 9, 0, 0),
    _span("frame", 20, 40, None, 1, launches=4, h2d_bytes=500),
    _span("upload", 20, 21, 6, 1),
    _span("band", 21, 27, 6, 1, row=0),
    _span("upload", 21, 23, 8, 1),
    _span("launch.fine", 23, 26, 8, 1),
    _span("band", 28, 36, 6, 1, row=8),
    _span("upload", 28, 30, 11, 1),
    _span("launch.fine", 30, 33, 11, 1),
    _span("gather", 37, 38, 6, 1),
    _span("upload", 50, 51, None, None),  # outside any frame: not read
]
WANT = {
    "upload_ms.frame": (3 + 5) / 2,
    "launch_ms.frame": (5 + 6) / 2,
    "renderer_self_ms.frame": ((10 - 9) + (20 - 16)) / 2,
    "launches.frame": 3,
    "upload_bytes.frame": 400,
    "band_host_ms.frame4k_x4": (0 + 14) / 2,
}


def _run(trace=True, kind="frames"):
    from bench_port import harness

    return harness.Run(kind=kind, seconds=1.0, trace=types.SimpleNamespace(units=2) if trace else None)


@pytest.mark.parametrize("metric", NEW_METRICS)
def test_reader_gives_its_number_on_a_run_by_hand(metric, monkeypatch):
    from bench_port import spec

    monkeypatch.setattr(profiling, "spans", lambda: list(HAND))
    assert spec.reader(metric)(_run()) == pytest.approx(WANT[metric], abs=1e-9)


@pytest.mark.parametrize("metric", NEW_METRICS)
def test_reader_gives_nothing_on_an_untraced_run_or_a_fit(metric, monkeypatch):
    from bench_port import spec

    monkeypatch.setattr(profiling, "spans", lambda: list(HAND))
    assert spec.reader(metric)(_run(trace=False)) is None
    assert spec.reader(metric)(_run(kind="fit")) is None


@pytest.mark.parametrize("metric", NEW_METRICS)
def test_reader_gives_nothing_without_the_ports_spans(metric, monkeypatch):
    """A port that records no spans (no `profiling.spans`, or no frame in
    the store) gives the reader nothing to read, and it does not raise."""
    from bench_port import spec

    assert spec.reader(metric)(_run()) is None  # the store is empty
    monkeypatch.delattr(profiling, "spans")
    assert spec.reader(metric)(_run()) is None


def test_traced_cpu_run_of_the_1080p_cell_reads_its_host_path():
    """The harness's traced window on the CPU (config2.view at 32x18): the
    three times add up to the frame's span, which is within 5% of the
    harness's own span around the entry call; the plain versions launch
    nothing and upload nothing."""
    from bench_port import harness, spec
    from bench_port import spans as bench_spans

    cell = spec.cell(spec.load_benchmark(), "config2.view")
    run = harness.run_rank(cell, 2**31 + 11, 0.2, True, "cpu", size=(32, 18), trace_seconds=0.4)
    got = {m: spec.reader(m)(run) for m in NEW_METRICS[:5]}
    assert all(v is not None for v in got.values()), got
    frame_ms = statistics.mean(f.ms for f in bench_spans.frames(run))
    total = got["upload_ms.frame"] + got["launch_ms.frame"] + got["renderer_self_ms.frame"]
    assert total == pytest.approx(frame_ms, rel=1e-9)
    enqueue_ms = statistics.mean(b - a for n, a, b in run.trace.host if n == "enqueue") * 1e3
    assert abs(total - enqueue_ms) <= 0.05 * enqueue_ms
    assert got["launches.frame"] == 0 and got["upload_bytes.frame"] == 0
    assert got["upload_ms.frame"] > 0 and got["launch_ms.frame"] > 0
    assert spec.reader("band_host_ms.frame4k_x4")(run) == 0  # make_renderer's frame has no band
