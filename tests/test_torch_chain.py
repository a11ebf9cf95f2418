"""The chained pixel pass K3 (prepass_chain, B = 4) on tapes deep enough
for the shared-memory stack route, against the JAX Pallas renderer.

Tapes of stack depth 4 and 8 (`cuda_march.stack_route` gives STK_SMEM:
the slots below the top in shared memory), static and dynamic. The JAX
renderer runs in interpret mode on the CPU, as tests/test_prepass.py runs
it; the port's wrappers run their plain versions on CPU tensors
(`coarse_px_plain`; tests/test_torch_cuda.py and chip_smoke.py hold the
kernel equal to it on the card, pixel for pixel). The dynamic frames are
held to the JAX static frame, as tests/test_torch_dynamic.py holds its
larger scenes: the JAX dynamic interpreter takes 1-3 minutes a frame on
these tapes in interpret mode.

Tolerances: the static chained planes as tests/test_torch_interval.py
holds the interval planes (status equal on >= 99% of pixels; t0 within
rtol 1e-4 where both live, the same f32 steps from the same start, but on
at most 1% of them, where a slack that lands within rounding of min_dist
takes one step more or less); the frames in tests/test_prepass.py's image
class.
"""

import numpy as np
import pytest
import torch

import raymarch_tpu as rm
import raymarch_tpu_torch as rt
from raymarch_tpu.ops.pallas_prepass import make_pallas_image_render_aa as render_aa_j
from raymarch_tpu_torch.ops import cuda_march as cm
from raymarch_tpu_torch.ops import cuda_prepass as cp

from test_torch_cuda import deep4, deep8
from test_torch_prepass import CAM, CFG, H, W, _assert_images_close, _cfg_t, _cv_j, _cv_t, _unflat

# One torch thread per process: the suite runs in several worker processes.
torch.set_num_threads(1)

DEEP = {"deep4": (deep4, 4), "deep8": (deep8, 8)}


@pytest.fixture(scope="module")
def jax_static():
    """{name: (JAX chained planes [t0, status] f32[H, W], JAX frame)} of the
    static tapes."""
    out = {}
    for name, (fn, _) in DEEP.items():
        spec_j, arrays_j = rm.compile_scene(fn(rm), static=True)
        rnd = render_aa_j(spec_j, CFG, W, H, interpret=True, bm_coarse=8, bm_fine=8, aa_packed=True,
                          prepass_block=4, prepass_chain=True)
        planes = [_unflat(v) for v in rnd.coarse(arrays_j, _cv_j(CAM))]
        out[name] = planes, np.asarray(rnd(arrays_j, _cv_j(CAM)))
    return out


@pytest.mark.parametrize("static", [True, False], ids=["static", "dyn"])
@pytest.mark.parametrize("name", ["deep4", "deep8"])
def test_chained_frame_on_deep_tapes_matches_jax(jax_static, name, static):
    fn, depth = DEEP[name]
    spec, arrays = rt.compile_scene(fn(rt), static=static)
    assert spec.stack_depth == depth and (spec.static_tape is None) != static
    assert cm.stack_route(spec) == cm.STK_SMEM
    ref_planes, ref = jax_static[name]
    rp = cp.make_pallas_image_render_aa(spec, _cfg_t(CFG), W, H, device="cpu", prepass_block=4,
                                        prepass_chain=True)
    t0, status = (v.numpy() for v in rp.coarse(arrays, _cv_t(CAM)))
    assert t0.shape == status.shape == (H, W)
    assert (status == 1).any() and (status == 0).any()
    if static:
        assert (status == ref_planes[1]).mean() >= 0.99
        both = (status == 1) & (ref_planes[1] == 1)
        rel = np.abs(t0[both] - ref_planes[0][both]) / np.abs(ref_planes[0][both])
        assert int(both.sum()) > 0 and (rel > 1e-4).mean() <= 0.01
    img = rp(arrays, _cv_t(CAM))
    assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
    _assert_images_close(img.numpy(), ref)
