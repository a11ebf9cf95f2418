"""The port's copied host layer agrees with raymarch_tpu's.

raymarch_tpu_torch carries its own copies of config, math3d, opcodes, the CSG
DSL, the tape compiler and the camera (it cannot import raymarch_tpu, which
imports jax). These tests guard the copies against drift: the same scene,
built with each package's DSL, must give a bit-identical wire tape and an
equal device program.
"""

import dataclasses

import numpy as np
import pytest

import raymarch_tpu as rm
import raymarch_tpu_torch as rt
from raymarch_tpu.ops import opcodes as oc_j
from raymarch_tpu.utils import math3d as m3_j
from raymarch_tpu_torch.ops import opcodes as oc_t
from raymarch_tpu_torch.ops.tape import from_reference
from raymarch_tpu_torch.utils import math3d as m3_t

Q = (0.9, 0.2, -0.3, 0.25)  # a non-identity rotation (normalized by the DSL)


def _config2(m):
    return (
        m.sphere(center=(-0.6, 0.0, 0.0), radius=0.9)
        | m.box(center=(0.8, 0.0, 0.0), half_extents=(0.5, 0.5, 0.5))
    ) - m.torus(center=(0.0, 0.8, 0.0), major_radius=0.7, minor_radius=0.25)


def _all_prims(m):
    return (
        m.sphere(center=(0.1, 0.2, 0.3), radius=0.7)
        | m.box(center=(1.0, 0.0, 0.0), half_extents=(0.3, 0.4, 0.5))
        | m.torus(center=(0.0, 1.0, 0.0), major_radius=0.6, minor_radius=0.2)
        | m.cylinder(center=(-1.0, 0.0, 0.5), radius=0.3, half_height=0.6)
        | m.capsule(center=(0.5, -0.5, 1.0), radius=0.25, half_height=0.4)
        | m.cone(center=(-0.5, 0.5, -1.0), half_height=0.5, r_bottom=0.4, r_top=0.1)
        | m.plane(normal=(0.0, 1.0, 0.2), offset=1.5)
    )


def _rotated(m):
    return (
        m.box(center=(1.0, 0.0, 0.0), half_extents=(0.3, 0.4, 0.5), rotation=Q)
        | m.torus(major_radius=0.6, minor_radius=0.2, rotation=Q)
        | m.cylinder(center=(-1.0, 0.0, 0.5), radius=0.3, half_height=0.6, rotation=Q)
        | m.capsule(center=(0.5, -0.5, 1.0), radius=0.25, half_height=0.4, rotation=Q)
        | m.cone(center=(-0.5, 0.5, -1.0), half_height=0.5, r_bottom=0.4, rotation=Q)
        | m.box(center=(0.0, -1.0, 0.0))  # unrotated leaf of a rotated type
    )


def _ops(m):
    a = m.sphere(center=(-0.3, 0.0, 0.0), radius=0.8)
    b = m.box(center=(0.4, 0.1, 0.0), half_extents=(0.5, 0.5, 0.5))
    c = m.torus(center=(0.0, 0.5, 0.0), major_radius=0.6, minor_radius=0.2)
    d = m.cylinder(center=(0.0, -0.4, 0.2), radius=0.3, half_height=0.9)
    return (
        a.union(b, k=0.2).subtract(c, k=0.15).intersect(d.round(0.05), k=0.1)
        | (a & b) - c.onion(0.03)
        | (c | d).round(0.1)
    )


def _painted_transformed(m):
    body = (
        m.sphere(radius=0.6).paint((0.9, 0.1, 0.1))
        | m.box(half_extents=(0.2, 0.7, 0.2)).translate((0.5, 0.0, 0.0))
    )
    return (
        body.rotate_axis_angle((0.0, 1.0, 0.0), 0.7).scale(1.3).translate((0.2, -0.1, 0.4))
        | m.cone(half_height=0.4).rotate_euler(0.3, -0.2, 0.5).paint((0.1, 0.2, 0.9))
    )


SCENES = {
    "config2": _config2,
    "all_prims": _all_prims,
    "rotated": _rotated,
    "ops": _ops,
    "painted_transformed": _painted_transformed,
    "empty": lambda m: None,
}


def _assert_programs_equal(a, b):
    (spec_a, arr_a), (spec_b, arr_b) = a, b
    assert dataclasses.astuple(spec_a) == dataclasses.astuple(spec_b)
    for f in dataclasses.fields(arr_a):
        va, vb = getattr(arr_a, f.name), getattr(arr_b, f.name)
        assert np.asarray(va).dtype == np.asarray(vb).dtype, f.name
        np.testing.assert_array_equal(va, vb, err_msg=f.name)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_encode_wire_bit_identical(name):
    wj = rm.encode_wire(SCENES[name](rm))
    wt = rt.encode_wire(SCENES[name](rt))
    assert wj.dtype == wt.dtype == np.uint32
    np.testing.assert_array_equal(wj, wt)


@pytest.mark.parametrize("static", [True, False])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_compile_scene_equal(name, static):
    _assert_programs_equal(
        rm.compile_scene(SCENES[name](rm), static=static),
        rt.compile_scene(SCENES[name](rt), static=static),
    )


@pytest.mark.parametrize("name", sorted(SCENES))
def test_from_reference_equals_own_compile(name):
    spec, arrays = from_reference(*rm.compile_scene(SCENES[name](rm), static=True))
    own = rt.compile_scene(SCENES[name](rt), static=True)
    assert isinstance(spec, rt.TapeSpec) and isinstance(arrays, rt.TapeArrays)
    assert spec == own[0]
    assert hash(spec) == hash(own[0])
    _assert_programs_equal((spec, arrays), own)


def test_render_config_equal():
    fj = [(f.name, f.default) for f in dataclasses.fields(rm.RenderConfig)]
    ft = [(f.name, f.default) for f in dataclasses.fields(rt.RenderConfig)]
    assert fj == ft
    cfg = dataclasses.replace(rt.DEFAULT_CONFIG, bound_accel=True, exit_check_every=4)
    assert hash(cfg) == hash(dataclasses.replace(cfg))
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.max_iter = 3


def test_opcodes_equal():
    names = [n for n in dir(oc_j) if n.isupper()]
    assert names == [n for n in dir(oc_t) if n.isupper()]
    for n in names:
        assert getattr(oc_j, n) == getattr(oc_t, n), n


def test_math3d_equal():
    q = m3_j.quat_normalize(Q)
    for fn, args in [
        ("quat_normalize", (Q,)),
        ("quat_multiply", (q, (0.1, 0.9, 0.3, -0.2))),
        ("quat_to_matrix", (q,)),
        ("quat_rotate", (q, (0.3, -1.0, 2.0))),
        ("quat_from_axis_angle", ((1.0, 2.0, 3.0), 0.7)),
        ("quat_from_euler", (0.3, -0.2, 1.1)),
        ("perspective_matrix", (16 / 9, np.pi / 4, 1.0, 10000.0)),
        ("view_matrix", ((0.0, 1.6, 4.2), q)),
    ]:
        np.testing.assert_array_equal(
            getattr(m3_j, fn)(*args), getattr(m3_t, fn)(*args), err_msg=fn
        )
    assert m3_t.is_identity_quat((1, 0, 0, 0)) and not m3_t.is_identity_quat(Q)


@pytest.mark.parametrize(
    "position,target",
    [((0.0, 1.6, 4.2), (0.0, 0.0, 0.0)), ((0.0, 2.6, 4.2), (0, 0, 0)),
     ((3.0, -1.0, -2.0), (0.5, 0.2, 0.1)), ((0.0, 0.0, -5.0), (0.0, 0.0, 0.0))],
)
def test_camera_looking_at_equal(position, target):
    cj = rm.Camera.looking_at(position=position, target=target)
    ct = rt.Camera.looking_at(position=position, target=target)
    np.testing.assert_array_equal(cj.position, ct.position)
    np.testing.assert_array_equal(cj.rotation, ct.rotation)
    assert ct.position.dtype == ct.rotation.dtype == np.float32
    np.testing.assert_array_equal(cj.view(), ct.view())


def test_orbit_controller_equal():
    cams = []
    for m in (rm, rt):
        ctl = m.OrbitCameraController(target=(0.1, 0.2, 0.3), radius=4.0)
        ctl.orbit(30.0, -12.0)
        ctl.pan(5.0, 3.0)
        ctl.dolly(-20.0)
        cams.append(ctl.camera())
    np.testing.assert_array_equal(cams[0].position, cams[1].position)
    np.testing.assert_array_equal(cams[0].rotation, cams[1].rotation)


def test_cam_vec_layout():
    cam = rt.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0.0, 0.0, 0.0))
    v = rt.cam_vec(cam, 48.0, device="cpu")
    assert v.dtype.is_floating_point and v.dtype.itemsize == 4 and v.shape == (8,)
    np.testing.assert_array_equal(
        v.numpy(), np.concatenate([cam.position, cam.rotation, [48.0]]).astype(np.float32)
    )


def test_march_stats_equal():
    """utils/stats.py is a copy of the reference's (numpy), fed by K6's
    steps: equal statistics, with and without the divergence factor, from
    numpy arrays and from tensors."""
    import torch

    from raymarch_tpu.utils import stats as stats_j
    from raymarch_tpu_torch.utils import stats as stats_t

    rng = np.random.default_rng(5)
    steps = rng.integers(0, 100, 4096).astype(np.int32)
    hit = (rng.uniform(size=4096) > 0.6).astype(np.float32)
    for tile in (None, 128, 5000):
        ref = stats_j.march_stats(steps, hit, tile)
        assert stats_t.march_stats(steps, hit, tile) == stats_t.MarchStats(**dataclasses.asdict(ref))
        assert stats_t.march_stats(torch.as_tensor(steps), torch.as_tensor(hit), tile) == stats_t.march_stats(
            steps, hit, tile)
        assert str(stats_t.march_stats(steps, hit, tile)) == str(ref)


def _graph_edits(graph_mod):
    """The same edit session on each package's node graph: the viewer's
    default scene, a sphere added and wired under a new union, a smooth
    blend, a material node, a rotation, a value edit, a disconnect, a
    removal; the snapshots and evaluated trees after each step."""
    from raymarch_tpu_torch.viewer import default_graph as dg_t

    if graph_mod.__name__.startswith("raymarch_tpu_torch"):
        g = dg_t()
    else:
        from raymarch_tpu.viewer import default_graph as dg_j

        g = dg_j()
    out = []

    def snap():
        out.append((g.to_dict(), g.evaluate_root()))

    snap()
    root = next(n.id for n in g.nodes.values() if n.template == "Root")
    top = g.nodes[root].inputs["SDF"][1]
    s = g.add_node("Sphere", center=(0.0, 1.6, 0.0), radius=0.4)
    u = g.add_node("SmoothUnion", k=0.3)
    g.connect(top, u, "A")
    g.connect(s, u, "B")
    g.connect(u, root, "SDF")
    snap()
    m = g.add_node("Material", albedo=(0.9, 0.1, 0.1))
    r = g.add_node("Rotate", axis=(0.0, 1.0, 0.0), angle=0.7)
    g.connect(u, r, "A")
    g.connect(r, m, "A")
    g.connect(m, root, "SDF")
    snap()
    g.set_input(s, "radius", 0.55)
    g.disconnect(u, "B")
    snap()
    g.remove_node(s)
    snap()
    g2 = graph_mod.CSGNodeGraph.from_dict(g.to_dict())
    out.append((g2.to_dict(), g2.evaluate_root()))
    return out


def test_node_graph_equal():
    """models/graph.py is a copy of the reference's: its templates, and for
    the same edits equal to_dict snapshots and equal compiled tapes (static
    and dynamic) of the evaluated scenes."""
    from raymarch_tpu.models import graph as graph_j
    from raymarch_tpu_torch.models import graph as graph_t

    assert graph_t.all_templates() == graph_j.all_templates()
    for name, tpl in graph_j.TEMPLATES.items():
        assert [(s.name, s.kind, s.default) for s in graph_t.TEMPLATES[name].inputs] == [
            (s.name, s.kind, s.default) for s in tpl.inputs]
    steps_j, steps_t = _graph_edits(graph_j), _graph_edits(graph_t)
    assert len(steps_j) == len(steps_t) == 6
    for (dj, tree_j), (dt, tree_t) in zip(steps_j, steps_t):
        assert dt == dj
        assert (tree_j is None) == (tree_t is None)
        for static in (True, False):
            _assert_programs_equal(rm.compile_scene(tree_j, static=static), rt.compile_scene(tree_t, static=static))


def test_png_bytes_identical():
    """utils/image.py is a copy of the reference's: byte-identical PNGs and
    previews from float and uint8 images, numpy or tensors."""
    import torch

    from raymarch_tpu.utils import image as image_j
    from raymarch_tpu_torch.utils import image as image_t

    rng = np.random.default_rng(9)
    img = rng.uniform(-0.2, 1.2, (17, 23, 3)).astype(np.float32)
    for a in (img, image_j.to_uint8(img)):
        assert image_t.png_bytes(a) == image_j.png_bytes(a)
    assert image_t.png_bytes(torch.as_tensor(img)) == image_j.png_bytes(img)
    np.testing.assert_array_equal(image_t.to_uint8(img), image_j.to_uint8(img))
    assert image_t.ascii_preview(img, 8) == image_j.ascii_preview(img, 8)
    with pytest.raises(ValueError):
        image_t.png_bytes(img[..., :2])
