"""Kill and resume of a two-process fit (gloo, CPU), as tests/test_elastic.py
:211-264 holds the JAX package's.

Two ranks run `fit_scene` over one process group with checkpoints every 3
steps (rank 0 writes them; every rank restores, from the step rank 0
finds). Both are SIGKILLed after a checkpoint, relaunched on a fresh port,
and must resume to the state of an uninterrupted run at rtol 1e-6
(test_elastic.py:262-264). (tests/test_torch_multiprocess.py holds the
two-process step against the JAX package's.)
"""

import signal
import time

import numpy as np

from raymarch_tpu_torch.parallel import FitCheckpointer

from test_torch_multiprocess import join_world, launch_world

STEPS = 30

# tests/test_elastic.py:162-201, on the port.
_BODY = r"""
import time as _t
import raymarch_tpu_torch as rt
from raymarch_tpu_torch.parallel import FitCheckpointer

ckdir, steps = sys.argv[5], int(sys.argv[6])
cfg = rt.RenderConfig(aa_samples=1, max_iter=40)
scene = rt.sphere(center=(-0.4, 0.0, 0.0), radius=0.8) | rt.box(center=(0.6, 0.0, 0.0), half_extents=(0.4, 0.4, 0.4))
spec, arrays = rt.compile_scene(scene, static=True)
cam = rt.Camera.looking_at(position=(0.0, 1.0, 3.2), target=(0.0, 0.0, 0.0))
W = H = 24
target = np.zeros((H, W, 3), np.float32)


def log(msg):
    # Throttle the steps so that the harness can kill the job mid-run (the
    # step's all_reduce makes rank 1 wait on rank 0, so one sleeper throttles
    # both).
    _t.sleep(0.15)
    if rank == 0:
        print(msg, flush=True)


res = rt.fit_scene(spec, arrays, cam, target, width=W, height=H, cfg=cfg, steps=steps, learning_rate=5e-2,
                   mesh=mesh, checkpoint_dir=ckdir, checkpoint_every=3, log_every=1, log_fn=log)
if rank == 1:  # only rank 0 writes
    assert FitCheckpointer(ckdir).save(steps, spec, res.arrays, res.camera, None, res.losses) is None
if rank == 0:
    print(f"FINAL {float(res.arrays.leaf_params.sum()):.9f} {res.losses[-1]:.9f} {len(res.losses)}", flush=True)
save(lp=res.arrays.leaf_params, losses=np.asarray(res.losses))
"""


def _final(outs):
    return [line for line in outs[0][0].splitlines() if line.startswith("FINAL")][0].split()[1:]


def test_two_process_kill_and_resume(tmp_path):
    ref_dir, ck_dir = tmp_path / "ref", tmp_path / "ck"
    for d in (ref_dir, ck_dir):
        d.mkdir()
    # The uninterrupted run, and the run to be killed, side by side.
    ref_procs = launch_world(_BODY, 2, ref_dir, args=(ref_dir / "ckpt", STEPS))
    procs = launch_world(_BODY, 2, ck_dir, args=(ck_dir / "ckpt", STEPS))
    try:
        ck = None
        deadline = time.time() + 240
        while time.time() < deadline:
            if (ck_dir / "ckpt").exists():
                ck = ck or FitCheckpointer(str(ck_dir / "ckpt"))
                latest = ck.latest_step()
                if latest is not None and 3 <= latest <= STEPS - 9:
                    break
            if any(p.poll() is not None for p in procs):
                raise AssertionError(f"a rank ended before a checkpoint: {[p.communicate() for p in procs]}")
            time.sleep(0.05)
        else:
            raise AssertionError("no checkpoint appeared within the deadline")
        for p in procs:
            p.send_signal(signal.SIGKILL)  # a preemption: no clean-up
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate(timeout=60)
    killed_at = ck.latest_step()
    assert killed_at is not None and killed_at < STEPS
    ref = _final(join_world(ref_procs))
    ref_lp = np.load(ref_dir / "rank0.npz")["lp"]
    # Only rank 0 writes: one file a step, `keep` of them.
    assert len([f for f in (ref_dir / "ckpt").iterdir() if f.suffix == ".npz"]) == 3

    # Relaunch on a fresh port with the same directory: it resumes and ends
    # where the uninterrupted run did.
    outs = join_world(launch_world(_BODY, 2, ck_dir, args=(ck_dir / "ckpt", STEPS)))
    assert "resumed from checkpoint" in outs[0][0], outs[0][0]
    got = _final(outs)
    assert int(got[2]) == int(ref[2]) == STEPS
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-6)
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-6)
    for r in range(2):
        np.testing.assert_allclose(np.load(ck_dir / f"rank{r}.npz")["lp"], ref_lp, rtol=1e-6)

