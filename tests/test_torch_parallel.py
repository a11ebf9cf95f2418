"""The port's row-sharded renderer and fit step over a world of 4 gloo
ranks (CPU), against the JAX package's over 4 of the 8 virtual devices.

One world runs every case of this file (tests/test_parallel.py and
tests/test_parallel_fused.py mirrored):

- frames of the backends "jnp", "pallas", "pallas_prepass" and
  "pallas_fused", at H = 32 and H = 36 (uneven: the last band reaches past
  the image) and row_interleave k = 1, 2, 4, against the JAX sharded frame
  in the class the port's single-device test of that backend uses, and
  against the port's single-device frame within the reference's band bound
  (test_parallel_fused.py:59-62);
- the fit step: "pallas_fused" with Adam, a grad mask and fit_camera
  against the JAX step (updated parameters and pose at atol 1e-5, the loss
  at rel 1e-4, tests/test_torch_fit.py's class), the reduced gradients of
  "pallas_fused" and "jnp" against the JAX step's at 0.01 max|g| (words)
  and 0.02 max|g| (camera), and against the port's single-device step at
  rtol 1e-5;
- the 64-sphere leaf_cull compact fit step over bands of 32 and 16 rows
  (culled bands start on the 16-row culling tiles; K9's route per band,
  ROADMAP §3 fault 4): its gradients against the port's single-device
  step and against the port's f64 analytic oracle (`ops/oracle_grad.py`,
  tests/test_torch_compact.py's recipe, in the gradient class).

The world of one (no process group) is held here too: its sharded frames
at k = 2 equal the single-device frames.
"""

import dataclasses
import functools
import inspect
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import raymarch_tpu as rm
import raymarch_tpu_torch as rt
from raymarch_tpu.parallel import make_fit_step as make_fit_step_j
from raymarch_tpu.parallel import make_mesh as make_mesh_j
from raymarch_tpu.parallel import make_sharded_renderer as make_sharded_renderer_j
from raymarch_tpu_torch.ops.oracle_grad import pixel_grads
from raymarch_tpu_torch.parallel import make_mesh, make_sharded_renderer

from test_grad_oracle import _word_map
from test_torch_multiprocess import join_world, launch_world, load_world
from test_torch_prepass import _assert_images_close

torch.set_num_threads(1)

WORLD = 4
ORACLE_PIXELS = 40  # pixels of the 64-sphere frame held against the f64 oracle (18 ms a ray)


def _setup(m):
    """Scenes, configurations and cases, built from `m` (raymarch_tpu or
    raymarch_tpu_torch) alike."""
    import dataclasses
    import numpy as np

    def spheres(n=64):
        # bench.py:357-368: n random spheres (seed 7) in one hard union.
        rng = np.random.default_rng(7)
        parts = []
        for _ in range(n):
            c = rng.uniform(-3, 3, 3)
            c[1] = rng.uniform(-1.0, 1.5)
            parts.append(m.sphere(center=tuple(c), radius=float(rng.uniform(0.15, 0.5))))
        scene = parts[0]
        for p in parts[1:]:
            scene = scene | p
        return scene

    def fused(painted):
        # tests/test_parallel_fused.py:22-24.
        kw = dict(material=(0.8, 0.2, 0.1)) if painted else {}
        return m.sphere(center=(-0.3, 0, 0), radius=0.9, **kw) | m.box(center=(0.8, 0, 0),
                                                                      half_extents=(0.4, 0.4, 0.4))

    return dict(
        # tests/test_parallel.py:15-20: a dynamic tape, the jnp and pallas backends.
        p=dict(scene=m.sphere(center=(0.0, 0.0, 0.0), radius=1.0) | m.plane(normal=(0, 1, 0), offset=1.5),
               static=False, cfg=dataclasses.replace(m.DEFAULT_CONFIG, aa_samples=2, max_iter=48),
               cam=m.Camera.looking_at(position=(0.0, 1.0, 4.0), target=(0, 0, 0)), w=32),
        f=dict(scene=fused(True), static=True,
               cfg=dataclasses.replace(m.DEFAULT_CONFIG, aa_samples=2, max_iter=120, min_dist=1e-3,
                                       bound_accel=True),
               cam=m.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0, 0, 0)), w=48),
        fit=dict(scene=fused(False), static=True,
                 cfg=dataclasses.replace(m.DEFAULT_CONFIG, aa_samples=2, max_iter=120, min_dist=1e-3,
                                         bound_accel=True),
                 cam=m.Camera.looking_at(position=(0.0, 1.6, 4.2), target=(0, 0, 0)), w=48, h=36),
        jfit=dict(scene=m.sphere(center=(0.0, 0.0, 0.0), radius=1.0) | m.plane(normal=(0, 1, 0), offset=1.5),
                  static=False, cfg=dataclasses.replace(m.DEFAULT_CONFIG, aa_samples=2, max_iter=48),
                  cam=m.Camera.looking_at(position=(0.0, 1.0, 4.0), target=(0, 0, 0)), w=16, h=16),
        # The compact backward's oracle recipe (tests/test_torch_compact.py):
        # relax 1 and max_iter 80; the unrebalanced tape, whose words map to
        # the wire tape's.
        c64=dict(scene=spheres(), static=True,
                 cfg=dataclasses.replace(m.DEFAULT_CONFIG, aa_samples=2, max_iter=80, leaf_cull=True),
                 cam=m.Camera.looking_at(position=(0.0, 2.5, 9.0), target=(0, 0, 0)), w=40, h=72),
        # name: (scene key, backend, H, row_interleave)
        renders={
            "jnp-h32-k1": ("p", "jnp", 32, 1), "jnp-h36-k1": ("p", "jnp", 36, 1),
            "jnp-h36-k2": ("p", "jnp", 36, 2), "jnp-h36-k4": ("p", "jnp", 36, 4),
            "pallas-h36-k1": ("p", "pallas", 36, 1), "pallas-h36-k2": ("p", "pallas", 36, 2),
            "prepass-h32-k1": ("f", "pallas_prepass", 32, 1), "prepass-h36-k1": ("f", "pallas_prepass", 36, 1),
            "prepass-h36-k2": ("f", "pallas_prepass", 36, 2), "prepass-h36-k4": ("f", "pallas_prepass", 36, 4),
            "fused-h36-k1": ("f", "pallas_fused", 36, 1), "fused-h36-k2": ("f", "pallas_fused", 36, 2),
        },
    )


def _compile(m, case):
    kw = dict(rebalance=False) if case["cfg"].leaf_cull else {}
    return m.compile_scene(case["scene"], static=case["static"], **kw)


class Recorder(torch.optim.Optimizer):
    """An optimizer that moves nothing and keeps the gradients it is given:
    the fit step's reduced gradients."""

    def __init__(self, params):
        super().__init__(params, {})
        self.grads = None

    def step(self, closure=None):
        self.grads = [p.grad.detach().clone() for g in self.param_groups for p in g["params"]]


def _port_cases(rt, mesh, single, target_path):
    """Every case of this file on `mesh` (a rank of the world); on rank 0
    also the single-device results (`single`, a mesh of this rank alone).
    Returns a dict of arrays."""
    import functools
    import os
    import time

    from raymarch_tpu_torch.ops import cuda_grad as cg
    from raymarch_tpu_torch.parallel import make_fit_step, make_sharded_renderer

    S = _setup(rt)
    out = {}
    compiled = {key: _compile(rt, S[key]) for key in ("p", "f", "fit", "jfit", "c64")}
    for name, (key, backend, h, k) in S["renders"].items():
        c, (spec, arrays) = S[key], compiled[key]
        mode = "implicit" if backend == "pallas_fused" else "forward"
        img = make_sharded_renderer(spec, c["w"], h, mesh, c["cfg"], mode=mode, backend=backend, row_interleave=k)
        out[f"img/{name}"] = img(arrays, c["cam"])
        if mesh.rank == 0 and k == 1:
            one = rt.make_renderer(spec, c["w"], h, c["cfg"], mode=mode, backend=backend, device="cpu")
            out[f"one/{key}-{backend}-{h}"] = one(arrays, c["cam"]).detach()

    def step(key, k, mesh_, optimizer, camera_optimizer, backend, grad_mask=None, target=None):
        c, (spec, arrays) = S[key], compiled[key]
        fit = make_fit_step(spec, c["w"], c["h"], mesh_, optimizer, c["cfg"], backend=backend, fit_camera=True,
                            camera_optimizer=camera_optimizer, grad_mask=grad_mask, row_interleave=k)
        st = fit.init_opt_state(arrays, c["cam"])
        if target is None:
            target = np.full((c["h"], c["w"], 3), 0.2, np.float32)
        a, cam, st, loss = fit(arrays, c["cam"], st, target)
        return fit, st, (a.leaf_params, a.op_param, cam.position, cam.rotation, loss)

    def grads(st):
        return [*st.optimizer.grads, *st.cam_optimizer.grads]

    spec_fit, arrays_fit = compiled["fit"]
    m_leaf = np.zeros_like(arrays_fit.leaf_params)
    m_leaf[:, 4:8] = 1.0
    mask = (m_leaf, np.ones_like(arrays_fit.op_param))
    for k in (1, 2):
        _, _, res = step("fit", k, mesh, functools.partial(torch.optim.Adam, lr=1e-2),
                         functools.partial(torch.optim.SGD, lr=1e-2), "pallas_fused", mask)
        out.update({f"adam/k{k}/{i}": v for i, v in enumerate(res)})
        for key, backend in (("fit", "pallas_fused"), ("jfit", "jnp")):
            _, st, res = step(key, k, mesh, Recorder, Recorder, backend)
            out.update({f"grad/{backend}/k{k}/{i}": v for i, v in enumerate(grads(st) + [res[-1]])})
    if mesh.rank == 0:
        for key, backend in (("fit", "pallas_fused"), ("jfit", "jnp")):
            _, st, res = step(key, 1, single, Recorder, Recorder, backend)
            out.update({f"grad/{backend}/one/{i}": v for i, v in enumerate(grads(st) + [res[-1]])})

    # The 64-sphere compact step: its target arrives from the test process
    # (the single-device frame minus the oracle pixels' weights).
    while not os.path.exists(target_path):
        time.sleep(0.05)
    target = np.load(target_path)
    calls = [0]
    plain_compact_bwd = cg.compact_bwd

    def counted(*args, **kw):
        calls[0] += 1
        return plain_compact_bwd(*args, **kw)

    cg.compact_bwd = counted
    meshes = [(f"k{k}", mesh, k) for k in (1, 2)] + ([("one", single, 1)] if mesh.rank == 0 else [])
    for name, mesh_, k in meshes:
        calls[0] = 0
        fit, st, res = step("c64", k, mesh_, Recorder, Recorder, "pallas_fused", target=target)
        out.update({f"c64/{name}/{i}": v for i, v in enumerate(grads(st) + [res[-1]])})
        out[f"c64/{name}/calls"] = np.array([calls[0], len(fit.bands)])
        out[f"c64/{name}/kind"] = np.array(fit.backward_info["kind"])
    return {key: v.detach() if torch.is_tensor(v) else v for key, v in out.items()}


_BODY = """
import dataclasses
import raymarch_tpu_torch as rt
{sources}
res = _port_cases(rt, mesh, make_mesh(1, device="cpu"), sys.argv[5])
save(**res)
"""


class JaxRecorder:
    """optax's counterpart of Recorder: no update, the gradients as its state."""

    @staticmethod
    def make():
        def init(params):
            return jax.tree_util.tree_map(jnp.zeros_like, params)

        def update(g, state, params=None):
            return jax.tree_util.tree_map(jnp.zeros_like, g), g

        return optax.GradientTransformation(init, update)


def _jax_backend(backend):
    """The JAX backend a port frame is held against: the reference's sharded
    "pallas" band builds its K5 without `interpret` (render.py:99-102), so
    it cannot run on the CPU; the port's K5 frame is held against the JAX
    jnp frame, the same march (tests/test_torch_surfaces.py holds K5 itself
    against the JAX kernel in interpret mode)."""
    return "jnp" if backend == "pallas" else backend


def _jax_step(S, key, k, optimizer, camera_optimizer, backend, grad_mask=None):
    c = S[key]
    spec, arrays = _compile(rm, c)
    fit = make_fit_step_j(spec, c["w"], c["h"], make_mesh_j(WORLD), optimizer, c["cfg"], backend=backend,
                          fit_camera=True, camera_optimizer=camera_optimizer, grad_mask=grad_mask,
                          interpret=True, row_interleave=k)
    st = fit.init_opt_state(arrays, c["cam"])
    a, cam, st, loss = jax.jit(fit)(arrays, c["cam"], st, jnp.full((c["h"], c["w"], 3), 0.2, jnp.float32))
    return a, cam, st, float(loss)


def _oracle_target(S, tmp):
    """The 64-sphere case's target: the port's single-device frame minus
    weights G on ORACLE_PIXELS seeded pixels that see a sphere, where the
    port's frame agrees
    with the f64 oracle's. The step's image cotangent is then 2 G / (H W
    3) on those pixels and zero elsewhere. Returns (the oracle's word and
    camera gradients of sum(img * 2G/(H W 3)), the tape's word map)."""
    c = S["c64"]
    w, h, cfg = c["w"], c["h"], c["cfg"]
    spec, arrays = _compile(rt, c)
    fr = rt.make_renderer(spec, w, h, cfg, mode="implicit", backend="pallas_fused", device="cpu").renderer
    rp = fr.prepass
    sc, cam, bound = rp.scene_args(arrays, rt.cam_vec(c["cam"], device="cpu"))
    cull = rp.cull_args(sc, cam)
    img, _, hit = rp.fine_pass(residuals=True)(sc, cam, bound, fr.params, *rp.prepass(sc, cam, bound, cull[0]),
                                               cull=cull[1])
    img = img.numpy()
    rng = np.random.default_rng(3)
    # Pixels with a sphere in them: the words' gradients live there.
    px = rng.choice(np.flatnonzero(hit.numpy().max(-1).ravel() > 0), ORACLE_PIXELS, replace=False)
    s = cfg.aa_samples ** 2
    idx = torch.as_tensor((px[:, None] * s + np.arange(s)[None, :]).reshape(-1))
    o, d = rt.raygen_flat(idx, torch.tensor(c["cam"].position), torch.tensor(c["cam"].rotation), w, h, cfg)
    tape = rt.encode_wire(c["scene"])
    col, dcol, dcam = pixel_grads(tape, o.numpy(), d.numpy(), cfg, cam_rotation=np.asarray(c["cam"].rotation))
    img_o = col.reshape(-1, s, 3).mean(1)
    agree = np.abs(img.reshape(-1, 3)[px] - img_o).max(-1) < 1e-4
    G = np.zeros((w * h, 3))
    G[px] = rng.uniform(0.5, 1.5, (ORACLE_PIXELS, 3)) * agree[:, None]
    target = (img - G.reshape(h, w, 3)).astype(np.float32)
    np.save(str(tmp / "t64.npy"), target)
    os.replace(str(tmp / "t64.npy"), str(tmp / "target64.npy"))
    Gray = np.repeat(G[px][:, None, :], s, axis=1).reshape(-1, 3) * 2.0 / (h * w * 3) / s
    spec_j, _ = rm.compile_scene(_setup(rm)["c64"]["scene"], static=True, rebalance=False)
    return np.einsum("nc,ncw->w", Gray, dcol), np.einsum("nc,ncw->w", Gray, dcam), _word_map(tape, spec_j), agree


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world4")
    sources = "\n".join(inspect.getsource(f) for f in (_setup, _compile, Recorder, _port_cases))
    procs = launch_world(_BODY.format(sources=sources), WORLD, tmp, args=(tmp / "target64.npy",))
    try:
        S = _setup(rm)
        oracle = _oracle_target(_setup(rt), tmp)
        jax_img = {}
        mesh = make_mesh_j(WORLD)
        for key, backend, h, _ in S["renders"].values():
            backend = _jax_backend(backend)
            if (key, backend, h) in jax_img:
                continue
            c = S[key]
            spec, arrays = _compile(rm, c)
            mode = "implicit" if backend == "pallas_fused" else "forward"
            r = make_sharded_renderer_j(spec, c["w"], h, mesh, c["cfg"], mode=mode, backend=backend, interpret=True)
            jax_img[key, backend, h] = np.asarray(jax.jit(r)(arrays, c["cam"]))
        spec_fit, arrays_fit = _compile(rm, S["fit"])
        m_leaf = np.zeros_like(arrays_fit.leaf_params)
        m_leaf[:, 4:8] = 1.0
        adam = _jax_step(S, "fit", 2, optax.adam(1e-2), optax.sgd(1e-2), "pallas_fused",
                         (m_leaf, np.ones_like(arrays_fit.op_param)))
        jgrads = {}
        for key, backend, k in (("fit", "pallas_fused", 2), ("jfit", "jnp", 1)):
            _, _, (g_params, g_cam), loss = _jax_step(S, key, k, JaxRecorder.make(), JaxRecorder.make(), backend)
            jgrads[backend] = [np.asarray(g) for g in (*g_params, g_cam.position, g_cam.rotation)] + [loss]
    finally:
        join_world(procs)
    return load_world(tmp, WORLD), jax_img, adam, jgrads, oracle


def test_ranks_agree(world):
    """Every rank holds the same gathered frames and reduced results: the
    replicas stay equal."""
    ranks = world[0]
    for r in ranks[1:]:
        for key, v in r.items():
            if not key.endswith("/calls"):  # each rank's own band count
                np.testing.assert_array_equal(v, ranks[0][key], err_msg=key)


RENDERS = _setup(rm)["renders"]


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_sharded_frame_matches_jax_and_single(world, name):
    ranks, jax_img = world[0], world[1]
    key, backend, h, _ = RENDERS[name]
    img = ranks[0][f"img/{name}"]
    ref = jax_img[key, _jax_backend(backend), h]
    assert img.shape == ref.shape == (h, _setup(rm)[key]["w"], 3)
    if backend in ("jnp", "pallas"):
        assert np.abs(img - ref).max() < 1e-3  # the exact-semantics class (tests/test_torch_march.py)
    else:
        _assert_images_close(img, ref)  # the prepass class (tests/test_torch_prepass.py)
    # Band against single: the reference's own bound (test_parallel_fused.py:59-62).
    d = np.abs(img - ranks[0][f"one/{key}-{backend}-{h}"])
    assert d.mean() < 1e-5 and (d.max(-1) > 1e-3).mean() < 0.01 and d.max() < 0.3, (d.mean(), d.max())


@pytest.mark.parametrize("k", [1, 2])
def test_fused_adam_step_matches_jax(world, k):
    """pallas_fused, Adam on the masked words, SGD on the pose (fit_camera),
    4 ranks x k bands, against the JAX step over 4 devices x 2 bands."""
    ranks, adam = world[0], world[2]
    a_j, cam_j, _, loss_j = adam
    got = [ranks[0][f"adam/k{k}/{i}"] for i in range(5)]
    for g, ref in zip(got[:4], (a_j.leaf_params, a_j.op_param, cam_j.position, cam_j.rotation)):
        np.testing.assert_allclose(g, np.asarray(ref), atol=1e-5)
    assert float(got[4]) == pytest.approx(loss_j, rel=1e-4)
    assert float(np.linalg.norm(got[3])) == pytest.approx(1.0, abs=1e-6)


def _grad_class(got, ref):
    """Words at 0.01 max|g|, the camera (position, rotation) at 0.02 max|g|."""
    words_g = np.concatenate([got[0].ravel(), got[1].ravel()])
    words_r = np.concatenate([ref[0].ravel(), ref[1].ravel()])
    np.testing.assert_allclose(words_g, words_r, rtol=0, atol=0.01 * np.abs(words_r).max())
    cam_g, cam_r = np.concatenate(got[2:4]), np.concatenate([np.ravel(x) for x in ref[2:4]])
    np.testing.assert_allclose(cam_g, cam_r, rtol=0, atol=0.02 * np.abs(cam_r).max())


def _against_one(got, one):
    """Multi-process against one process: the loss at the reference's rtol
    1e-5 (test_multiprocess.py:130-133), the gradients in the gradient class.
    The bands' sums reach the reduction in another order, and a word's
    gradient is a sum of per-ray terms that cancel (silhouette rays' implicit
    terms), so one f32 reordering moves it by up to ~0.6% of max|g|."""
    assert float(got[4]) == pytest.approx(float(one[4]), rel=1e-5)
    _grad_class(got, one)


@pytest.mark.parametrize("backend", ["pallas_fused", "jnp"])
@pytest.mark.parametrize("k", [1, 2])
def test_reduced_gradients_match_jax_and_single(world, backend, k):
    ranks, jgrads = world[0], world[3]
    got = [ranks[0][f"grad/{backend}/k{k}/{i}"] for i in range(5)]
    ref = jgrads[backend]
    _grad_class(got, ref)
    assert float(got[4]) == pytest.approx(ref[4], rel=1e-4)
    _against_one(got, [ranks[0][f"grad/{backend}/one/{i}"] for i in range(5)])


@pytest.mark.parametrize("k", [1, 2])
def test_compact_fit_step_over_bands(world, k):
    """ROADMAP §3 fault 4 on the sharded path: the 64-sphere leaf_cull
    step runs K9's route (its plain version on the CPU) once per band, and
    its reduced gradients equal the single-device step's and the f64
    oracle's. Its bands start on the culling tiles' rows: 72 rows in 3
    bands of 32 (k = 1) or 5 of 16 (k = 2, two on rank 0)."""
    ranks = world[0]
    r0 = ranks[0]
    for r in ranks:
        calls, bands = r[f"c64/k{k}/calls"]
        assert calls == bands
        assert str(r[f"c64/k{k}/kind"]) == "pallas_compact"
    assert [r[f"c64/k{k}/calls"][1] for r in ranks] == ([1, 1, 1, 0] if k == 1 else [2, 1, 1, 1])
    got = [r0[f"c64/k{k}/{i}"] for i in range(5)]
    _against_one(got, [r0[f"c64/one/{i}"] for i in range(5)])
    oracle_words, oracle_cam, wmap, agree = world[4]
    assert agree.sum() >= 8
    dev_words = np.zeros(len(oracle_words))
    for wd, mp in wmap.items():
        dev_words[wd] = got[0][mp[1], mp[2]] if mp[0] == "leaf" else got[1][mp[1]]
    assert np.abs(oracle_words).max() > 0
    # The gradient class: an f32 march against the f64 one moves a pixel's
    # words by up to ~1.3% of that pixel's largest (seen on this frame).
    _grad_class([dev_words, np.zeros(0), got[2], got[3]],
                [oracle_words, np.zeros(0), oracle_cam[:3], oracle_cam[3:]])


@pytest.mark.parametrize("backend", ["jnp", "pallas", "pallas_prepass", "pallas_fused"])
def test_world_of_one_interleaved_equals_single(backend):
    S = _setup(rt)
    c = S["f"] if backend.startswith("pallas_") else S["p"]
    spec, arrays = _compile(rt, c)
    mode = "implicit" if backend == "pallas_fused" else "forward"
    mesh = make_mesh(device="cpu")
    assert mesh.group is None and mesh.shape == {"rays": 1}
    img = make_sharded_renderer(spec, c["w"], 36, mesh, c["cfg"], mode=mode, backend=backend, row_interleave=2)(
        arrays, c["cam"])
    one = rt.make_renderer(spec, c["w"], 36, c["cfg"], mode=mode, backend=backend, device="cpu")(arrays, c["cam"])
    torch.testing.assert_close(img, one.detach(), rtol=0, atol=0)
