"""A mesh of part of the world: `make_mesh(2)` and `make_mesh(1)` in a gloo
world of 4 ranks (CPU), against the JAX package's `make_mesh(2)` (2 of the
8 virtual devices) and the port's single device.

Every rank of the world calls `make_mesh(2)` (collective over the world:
`dist.new_group`) and `make_mesh(1)`. Then

- ranks 0 and 1, the mesh's: the sharded frames of "jnp" and
  "pallas_prepass" at row_interleave k = 1 and 2 against the JAX frame on a
  mesh of 2 (in tests/test_torch_parallel.py's classes: max|d| < 1e-3 for
  the march, the prepass class for the cone prepass) and against the
  port's single-device frame (the reference's band bound); the
  "pallas_fused" fit step's loss and reduced gradients against the JAX
  step on a mesh of 2 (loss rel 1e-4, gradients 0.01 / 0.02 max|g|); a
  `fit_scene` with checkpoints over the mesh that stops, then resumes from
  the mesh's rank 0's checkpoint and ends where an uninterrupted run ends
  (rtol 1e-6, tests/test_torch_elastic.py's class);
- ranks 2 and 3, outside it: a ValueError from `make_sharded_renderer`,
  `make_fit_step`, `fit_scene`, `FitCheckpointer` and `all_reduce_sum`,
  raised before any collective, after which they go on and finish while
  the mesh still works;
- every rank: a mesh of one renders alone, bit-equal to the single-device
  frame, and checkpoints into a directory of its own.

The world is joined under a timeout: a rank that enters a collective the
others never reach fails the test instead of hanging the suite.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import raymarch_tpu as rm
import raymarch_tpu_torch as rt
from raymarch_tpu.parallel import make_fit_step as make_fit_step_j
from raymarch_tpu.parallel import make_mesh as make_mesh_j
from raymarch_tpu.parallel import make_sharded_renderer as make_sharded_renderer_j
from raymarch_tpu_torch.parallel import make_fit_step

from test_torch_multiprocess import join_world, launch_world, load_world
from test_torch_parallel import JaxRecorder, Recorder, _compile, _grad_class, _setup
from test_torch_prepass import _assert_images_close

torch.set_num_threads(1)

WORLD = 4
MESH = 2
WORLD_TIMEOUT = 180  # seconds for each rank
FIT_STEPS = 6  # fit_scene's steps; the first run stops at STOP_AT and the second resumes there
STOP_AT = 4
# name: (scene key of _setup, backend, H, row_interleave)
FRAMES = {
    "jnp-k1": ("p", "jnp", 36, 1), "jnp-k2": ("p", "jnp", 36, 2),
    "prepass-k1": ("f", "pallas_prepass", 36, 1), "prepass-k2": ("f", "pallas_prepass", 36, 2),
}


def _fit_case(rt):
    """tests/test_torch_elastic.py's fit: a sphere and a box, 24x24."""
    import numpy as np

    cfg = rt.RenderConfig(aa_samples=1, max_iter=40)
    scene = rt.sphere(center=(-0.4, 0.0, 0.0), radius=0.8) | rt.box(center=(0.6, 0.0, 0.0),
                                                                     half_extents=(0.4, 0.4, 0.4))
    spec, arrays = rt.compile_scene(scene, static=True)
    cam = rt.Camera.looking_at(position=(0.0, 1.0, 3.2), target=(0.0, 0.0, 0.0))
    return spec, arrays, cam, cfg, np.zeros((24, 24, 3), np.float32)


def _member(rt, mesh, ckdir):
    """The mesh's ranks: frames, the fused step's reduced gradients, and a
    fit that stops and resumes from the mesh's checkpoints."""
    import os

    from raymarch_tpu_torch.parallel import FitCheckpointer, make_fit_step, make_sharded_renderer

    S = _setup(rt)
    out = {}
    for name, (key, backend, h, k) in FRAMES.items():
        c = S[key]
        spec, arrays = _compile(rt, c)
        render = make_sharded_renderer(spec, c["w"], h, mesh, c["cfg"], backend=backend, row_interleave=k)
        out[f"img/{name}"] = render(arrays, c["cam"])
        out[f"bands/{name}"] = np.array(render.bands).reshape(-1)
    c = S["fit"]
    spec, arrays = _compile(rt, c)
    fit = make_fit_step(spec, c["w"], c["h"], mesh, Recorder, c["cfg"], backend="pallas_fused", fit_camera=True,
                        camera_optimizer=Recorder)
    st = fit.init_opt_state(arrays, c["cam"])
    _, _, st, loss = fit(arrays, c["cam"], st, np.full((c["h"], c["w"], 3), 0.2, np.float32))
    for i, g in enumerate([*st.optimizer.grads, *st.cam_optimizer.grads, loss]):
        out[f"grad/{i}"] = g

    spec, arrays, cam, cfg, target = _fit_case(rt)
    logs = []
    kw = dict(width=24, height=24, cfg=cfg, learning_rate=5e-2, mesh=mesh, log_fn=logs.append)
    first = rt.fit_scene(spec, arrays, cam, target, steps=STOP_AT, checkpoint_dir=ckdir, checkpoint_every=2, **kw)
    out["files"] = np.array(sorted(f for f in os.listdir(ckdir) if f.endswith(".npz")))
    resumed = rt.fit_scene(spec, arrays, cam, target, steps=FIT_STEPS, checkpoint_dir=ckdir, checkpoint_every=2,
                           **kw)
    whole = rt.fit_scene(spec, arrays, cam, target, steps=FIT_STEPS, **kw)
    out["resumed_log"] = np.array([m for m in logs if "resumed" in m])
    out["first_losses"] = np.asarray(first.losses)
    for name, res in (("resumed", resumed), ("whole", whole)):
        out[f"{name}/lp"] = res.arrays.leaf_params
        out[f"{name}/losses"] = np.asarray(res.losses)
    st = make_fit_step(spec, 24, 24, mesh, torch.optim.Adam, cfg).init_opt_state(arrays)
    saved = FitCheckpointer(ckdir, mesh=mesh).save(99, spec, resumed.arrays, resumed.camera, st, resumed.losses)
    out["wrote"] = np.array(saved is not None)
    return out


def _outside(rt, mesh, ckdir):
    """A rank outside the mesh: everything built on it raises ValueError,
    and nothing waits on the mesh's ranks."""
    import os
    import time

    from raymarch_tpu_torch.parallel import FitCheckpointer, all_reduce_sum, make_fit_step, make_sharded_renderer

    t0 = time.monotonic()
    spec, arrays, cam, cfg, target = _fit_case(rt)
    attempts = {
        "make_sharded_renderer": lambda: make_sharded_renderer(spec, 24, 24, mesh, cfg),
        "make_fit_step": lambda: make_fit_step(spec, 24, 24, mesh, torch.optim.Adam, cfg),
        "fit_scene": lambda: rt.fit_scene(spec, arrays, cam, target, width=24, height=24, cfg=cfg, steps=2,
                                          mesh=mesh, checkpoint_dir=os.path.join(ckdir, "outside")),
        "FitCheckpointer": lambda: FitCheckpointer(os.path.join(ckdir, "outside"), mesh=mesh),
        "all_reduce_sum": lambda: all_reduce_sum(torch.zeros(3), mesh),
    }
    refused = []
    for name, attempt in attempts.items():
        try:
            attempt()
        except ValueError as e:
            if "outside this mesh" in str(e):
                refused.append(name)
    return {"refused": np.array(refused), "outside_s": np.float64(time.monotonic() - t0),
            "outside_dir": np.array(os.path.exists(os.path.join(ckdir, "outside")))}


_BODY = """
import os
import raymarch_tpu_torch as rt
from raymarch_tpu_torch.parallel import FitCheckpointer, make_sharded_renderer
{sources}
ckdir = sys.argv[5]
mesh2 = make_mesh({mesh}, device="cpu")
again = make_mesh({mesh}, device="cpu")
mesh1 = make_mesh(1, device="cpu")
res = dict(mesh2=np.array([-1 if mesh2.rank is None else mesh2.rank, mesh2.size, mesh2.member,
                           again.group is mesh2.group, again.rank == mesh2.rank]),
           mesh1=np.array([mesh1.rank, mesh1.size, mesh1.group is None, mesh1.member]))
res.update(_member(rt, mesh2, ckdir) if mesh2.member else _outside(rt, mesh2, ckdir))
# Every rank: a mesh of this rank alone.
c = _setup(rt)["p"]
spec, arrays = _compile(rt, c)
res["alone"] = make_sharded_renderer(spec, c["w"], 36, mesh1, c["cfg"], row_interleave=2)(arrays, c["cam"])
own = os.path.join(ckdir, f"alone{{rank}}")
sp, ar, cam, cfg, target = _fit_case(rt)
st = rt.make_fit_step(sp, 24, 24, mesh1, torch.optim.Adam, cfg).init_opt_state(ar)
res["alone_wrote"] = np.array(FitCheckpointer(own, mesh=mesh1).save(1, sp, ar, cam, st, [0.0]) is not None)
save(**{{k: v.detach() if torch.is_tensor(v) else v for k, v in res.items()}})
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh2of4")
    ckdir = tmp / "ckpt"
    ckdir.mkdir()
    sources = "\n".join(inspect.getsource(f) for f in (_setup, _compile, Recorder, _fit_case, _member, _outside))
    sources = f"FRAMES = {FRAMES!r}\nFIT_STEPS, STOP_AT = {FIT_STEPS}, {STOP_AT}\n" + sources
    procs = launch_world(_BODY.format(sources=sources, mesh=MESH), WORLD, tmp, args=(ckdir,))
    try:
        # The JAX package's mesh of 2 and the port's single device, while
        # the world runs.
        S_j, S_t = _setup(rm), _setup(rt)
        mesh_j = make_mesh_j(MESH)
        ref = {}
        for name, (key, backend, h, _) in FRAMES.items():
            if (key, backend) in ref:
                continue
            c = S_j[key]
            spec, arrays = _compile(rm, c)
            r = make_sharded_renderer_j(spec, c["w"], h, mesh_j, c["cfg"], backend=backend, interpret=True)
            ct = S_t[key]
            spec_t, arrays_t = _compile(rt, ct)
            one = rt.make_renderer(spec_t, ct["w"], h, ct["cfg"], mode="forward", backend=backend, device="cpu")
            ref[key, backend] = (np.asarray(jax.jit(r)(arrays, c["cam"])), one(arrays_t, ct["cam"]).numpy())
        c = S_j["fit"]
        spec, arrays = _compile(rm, c)
        fit = make_fit_step_j(spec, c["w"], c["h"], mesh_j, JaxRecorder.make(), c["cfg"], backend="pallas_fused",
                              fit_camera=True, camera_optimizer=JaxRecorder.make(), interpret=True)
        st = fit.init_opt_state(arrays, c["cam"])
        _, _, (g_params, g_cam), loss = jax.jit(fit)(arrays, c["cam"], st,
                                                     jnp.full((c["h"], c["w"], 3), 0.2, jnp.float32))
        jgrads = [np.asarray(g) for g in (*g_params, g_cam.position, g_cam.rotation)] + [float(loss)]
        ct = S_t["fit"]
        spec_t, arrays_t = _compile(rt, ct)
        one = make_fit_step(spec_t, ct["w"], ct["h"], None, Recorder, ct["cfg"], backend="pallas_fused",
                            fit_camera=True, camera_optimizer=Recorder, device="cpu")
        st = one.init_opt_state(arrays_t, ct["cam"])
        _, _, st, loss_1 = one(arrays_t, ct["cam"], st, np.full((ct["h"], ct["w"], 3), 0.2, np.float32))
        single = [g.numpy() for g in (*st.optimizer.grads, *st.cam_optimizer.grads)] + [float(loss_1)]
        c = S_t["p"]
        spec_t, arrays_t = _compile(rt, c)
        alone = rt.make_renderer(spec_t, c["w"], 36, c["cfg"], mode="forward", device="cpu")(arrays_t, c["cam"])
    finally:
        join_world(procs, timeout=WORLD_TIMEOUT)
    return load_world(tmp, WORLD), ref, jgrads, single, alone.numpy(), ckdir


def test_meshes_of_part_of_the_world(world):
    """Ranks 0 and 1 hold ranks 0 and 1 of the mesh of 2, ranks 2 and 3 are
    outside it; a second make_mesh(2) reuses the group; make_mesh(1) is a
    mesh of each rank alone."""
    ranks = world[0]
    for r, res in enumerate(ranks):
        member = r < MESH
        assert res["mesh2"].tolist() == [r if member else -1, MESH, member, True, True]
        assert res["mesh1"].tolist() == [0, 1, True, True]


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_mesh_frame_matches_jax_and_single(world, name):
    ranks, ref = world[0], world[1]
    key, backend, h, k = FRAMES[name]
    np.testing.assert_array_equal(ranks[1][f"img/{name}"], ranks[0][f"img/{name}"])
    img = ranks[0][f"img/{name}"]
    jax_img, one = ref[key, backend]
    assert img.shape == jax_img.shape == one.shape
    if backend == "jnp":
        assert np.abs(img - jax_img).max() < 1e-3  # the exact-semantics class (tests/test_torch_march.py)
    else:
        _assert_images_close(img, jax_img)  # the prepass class (tests/test_torch_prepass.py)
    # Band against single: the reference's own bound (test_parallel_fused.py:59-62).
    d = np.abs(img - one)
    assert d.mean() < 1e-5 and (d.max(-1) > 1e-3).mean() < 0.01 and d.max() < 0.3, (d.mean(), d.max())
    # The bands are the mesh's: 2 k of ceil(36 / 2 k) rows, rank d holding d, d + 2, ...
    rows = -(-h // (MESH * k))
    for r in range(MESH):
        want = [(i0, min(rows, h - i0)) for i0 in ((r + j * MESH) * rows for j in range(k)) if i0 < h]
        assert ranks[r][f"bands/{name}"].tolist() == [v for band in want for v in band]


def test_mesh_fused_step_matches_jax_and_single(world):
    """The "pallas_fused" step (fit_camera) over the mesh of 2: its loss and
    reduced gradients against the JAX step on a mesh of 2, and against the
    port's single-device step."""
    ranks, _, jgrads, single = world[0], world[1], world[2], world[3]
    got = [ranks[0][f"grad/{i}"] for i in range(5)]
    for i in range(5):
        np.testing.assert_array_equal(ranks[1][f"grad/{i}"], got[i])
    _grad_class(got, jgrads)
    assert float(got[4]) == pytest.approx(jgrads[4], rel=1e-4)
    _grad_class(got, single)
    assert float(got[4]) == pytest.approx(single[4], rel=1e-5)


def test_fit_scene_resumes_on_the_mesh(world):
    """fit_scene over the mesh of 2: the mesh's rank 0 writes every 2 steps
    (a run of 4 steps leaves steps 2 and 4), a run of 6 resumes at step 4,
    and ends where an uninterrupted run of 6 ends."""
    ranks, ckdir = world[0], world[5]
    # Listed by the writer after its run (the other rank may list before
    # the last write lands).
    assert ranks[0]["files"].tolist() == ["fitckpt_00000002.npz", "fitckpt_00000004.npz"]
    for r in range(MESH):
        res = ranks[r]
        assert res["resumed_log"].tolist() == [f"fit: resumed from checkpoint at step {STOP_AT}"]
        assert len(res["first_losses"]) == STOP_AT and len(res["resumed/losses"]) == FIT_STEPS
        np.testing.assert_allclose(res["resumed/losses"][:STOP_AT], res["first_losses"], rtol=1e-6)
        np.testing.assert_allclose(res["resumed/losses"], res["whole/losses"], rtol=1e-6)
        np.testing.assert_allclose(res["resumed/lp"], res["whole/lp"], rtol=1e-6)
    # Only the mesh's rank 0 writes.
    assert [bool(ranks[r]["wrote"]) for r in range(MESH)] == [True, False]
    assert (ckdir / "fitckpt_00000099.npz").exists()


def test_ranks_outside_the_mesh_are_refused(world):
    """Ranks 2 and 3 get ValueError from every factory built on the mesh,
    before any collective, and touch no checkpoint directory."""
    ranks = world[0]
    for r in range(MESH, WORLD):
        res = ranks[r]
        assert res["refused"].tolist() == ["make_sharded_renderer", "make_fit_step", "fit_scene",
                                           "FitCheckpointer", "all_reduce_sum"]
        assert not bool(res["outside_dir"])
        assert float(res["outside_s"]) < 30.0  # nothing waited on the mesh's ranks


def test_mesh_of_one_on_every_rank(world):
    """make_mesh(1) on every rank of the world: each renders the whole
    frame alone (bit-equal to the single device) and is its own
    checkpoint writer."""
    ranks, alone = world[0], world[4]
    for res in ranks:
        np.testing.assert_array_equal(res["alone"], alone)
        assert bool(res["alone_wrote"])
