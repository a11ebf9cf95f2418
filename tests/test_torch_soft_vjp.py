"""The port's soft backward against the JAX fused soft VJP and the jnp
soft path.

On the CPU the port's fused renderer with `mode="soft"` runs the soft fine
pass's plain version and then `bwd_plain` (K8's soft branch: config 2 and
a painted pool, which soft mode routes to K8 with the reference's reason)
or `compact_bwd_plain` (K9's: a pool and a seg1 chain). Gradients of
mean(img^2) are held against the JAX fused soft VJP (Pallas in interpret
mode) and, for config 2, the jnp soft path, in the class of two f32
implementations of one backward (tests/test_pallas_grad.py:78-105:
0.01·max|g| for scene words, 0.02·max|g| for the camera); images at atol
5e-4, the reference's class for its soft kernel against the jnp soft path
(tests/test_soft_coverage.py:140-147). The two-group stream plan is held in
tests/test_torch_soft.py. Each JAX fused VJP costs ~16 s in interpret mode,
so this file holds the four cases that need one.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import raymarch_tpu as rm
from raymarch_tpu.ops.pallas_grad import make_fused_render_vjp as fused_vjp_j
from raymarch_tpu_torch.ops.tape import from_reference

from test_torch_blend import _painted_pool, _seg1_mixed
from test_torch_compact import _six_spheres
from test_torch_soft import CFG_J, POS, W, H, _assert_grad_class, _cv, _look, _port_soft
from test_torch_tape import SCENES

# One torch thread per process: the suite runs in several worker processes
# at once, and a thread pool per process oversubscribes the cores.
torch.set_num_threads(1)


def _jax_soft(spec_j, arrays_j, cfg_j, cam_vec, w=W, h=H):
    """Image, gradients of mean(img^2) and backward_info of the JAX fused
    soft VJP (interpret mode)."""
    rv = fused_vjp_j(spec_j, cfg_j, w, h, interpret=True, soft=True)

    def loss(lp, opp, c):
        return jnp.mean(rv(dataclasses.replace(arrays_j, leaf_params=lp, op_param=opp), c) ** 2)

    args = (jnp.asarray(arrays_j.leaf_params), jnp.asarray(arrays_j.op_param), jnp.asarray(cam_vec))
    g = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return np.asarray(rv(arrays_j, args[2])), tuple(np.asarray(x) for x in g), rv.backward_info


def _jnp_soft(spec_j, arrays_j, cfg_j, cam, w=W, h=H):
    """Image and gradients of mean(img^2) of the jnp soft renderer (the
    camera's as one f32[8] vector, position then rotation)."""
    render = rm.make_renderer(spec_j, w, h, cfg_j, mode="soft")

    def loss(lp, opp, camera):
        return jnp.mean(render(dataclasses.replace(arrays_j, leaf_params=lp, op_param=opp), camera) ** 2)

    gl, go, gc = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(arrays_j.leaf_params), jnp.asarray(arrays_j.op_param), cam)
    img = np.asarray(jax.jit(render)(arrays_j, cam))
    gcam = np.concatenate([np.asarray(gc.position), np.asarray(gc.rotation), [0.0]]).astype(np.float32)
    return img, (np.asarray(gl), np.asarray(go), gcam)


# name -> (scene, leaf_cull, camera position, held against, the reference's
# backward_info (kind, reason)).
SOFT_CASES = {
    "config2": (lambda m: SCENES["config2"](m), False, (0.0, 1.6, 4.2), ("jax", "jnp"),
                ("pallas_legacy_unrolled", "leaf_cull disabled")),
    "pool": (_six_spheres, True, POS, ("jax",), ("pallas_compact", None)),
    "seg1": (_seg1_mixed, True, POS, ("jax",), ("pallas_compact", None)),
    "painted": (_painted_pool, True, POS, ("jax",), ("pallas_legacy_unrolled", "painted materials in soft mode")),
}


@pytest.fixture(scope="module", params=sorted(SOFT_CASES))
def soft_case(request):
    build, cull, pos, refs, info = SOFT_CASES[request.param]
    cfg_j = dataclasses.replace(CFG_J, leaf_cull=cull)
    spec_j, arrays_j = rm.compile_scene(build(rm), static=True)
    spec, arrays = from_reference(spec_j, arrays_j)
    cam = _look(pos)
    port = _port_soft(spec, arrays, cfg_j, _cv(cam))
    out = {"port": port, "info": info, "name": request.param}
    if "jax" in refs:
        out["jax"] = _jax_soft(spec_j, arrays_j, cfg_j, _cv(cam))
    if "jnp" in refs:
        out["jnp"] = _jnp_soft(spec_j, arrays_j, cfg_j, cam)
    return out


def test_soft_backward_routes_like_the_reference(soft_case):
    _, _, info = soft_case["port"]
    assert info["soft"] and (info["kind"], info["reason"]) == soft_case["info"]
    assert info["compact"] == (info["kind"] == "pallas_compact")
    if "jax" in soft_case:
        info_j = soft_case["jax"][2]
        for key in ("kind", "compact", "reason", "soft"):
            assert info[key] == info_j[key], key


def test_soft_image_matches_jax(soft_case):
    img, _, _ = soft_case["port"]
    for ref in ("jax", "jnp"):
        if ref in soft_case:
            np.testing.assert_allclose(img, soft_case[ref][0], atol=5e-4)


def test_soft_grads_match_jax(soft_case):
    _, g, _ = soft_case["port"]
    for ref in ("jax", "jnp"):
        if ref in soft_case:
            _assert_grad_class(g, soft_case[ref][1])
    if soft_case["name"] == "painted":
        assert np.abs(g[0][:, 12:16]).max() > 0  # the albedo words
