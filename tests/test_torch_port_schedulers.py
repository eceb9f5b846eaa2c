"""The port's schedulers against the JAX package's, on the CPU.

For DDIM, PNDM, k-LMS and DPM-Solver++(2M): the timestep plan must be
JAX's exactly; the coefficient tables JAX keeps (DPM's ``c_*``, LMS's
``_coeffs`` and sigmas, ``init_noise_sigma``) must agree to 1e-6
relative; and a whole loop fed the same synthetic epsilon sequence
(made with numpy from a seed, independent of the sample, so nothing but
the schedulers' arithmetic can diverge) must agree at every step.  Both
sides compute the steps in fp32 with the same operations: DDIM, LMS and
DPM come out bitwise equal here; PNDM's four-term blend compiles to
fused multiply-adds under XLA, and drifts by up to 3e-7 of the largest
|x| over 50 steps.  The tolerance at every step is 1e-6 relative plus an
absolute 1e-6 times that step's largest |x| (the latents of a synthetic
loop reach |x| ~ 40-50; an element near zero carries the rounding of the
larger terms it was computed from).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladi_vton_tpu.diffusion import schedulers as jsched
from ladi_vton_tpu_torch.diffusion import schedulers as sched

NAMES = ("ddim", "pndm", "lms", "dpm")
STEPS = {"ddim": 50, "pndm": 50, "lms": 50, "dpm": 20}
SHAPE = (2, 4, 8, 6)


def _pair(name: str):
    return jsched.make_scheduler(name), sched.make_scheduler(name)


def test_make_scheduler_takes_exactly_the_jax_names():
    assert set(sched.SCHEDULERS) == set(NAMES)
    for name in NAMES:
        j, ours = _pair(name)
        assert type(ours).__name__ == type(j).__name__
    for bad in ("euler", "DDIM", ""):
        with pytest.raises(ValueError, match="unknown scheduler"):
            sched.make_scheduler(bad)
        with pytest.raises(ValueError, match="unknown scheduler"):
            jsched.make_scheduler(bad)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("steps", [2, 20, 50])
def test_plan_matches_jax_exactly(name, steps):
    j, ours = _pair(name)
    ref = np.asarray(j.set_timesteps(steps))
    plan = ours.set_timesteps(steps)
    assert plan.dtype == torch.int64
    np.testing.assert_array_equal(plan.numpy(), ref)
    assert len(plan) == steps + (name == "pndm")
    assert ours.init_noise_sigma == pytest.approx(j.init_noise_sigma,
                                                  rel=1e-6)


@pytest.mark.parametrize("steps", [20, 50])
def test_dpm_coefficients_match_jax(steps):
    j, ours = _pair("dpm")
    j.set_timesteps(steps)
    ours.set_timesteps(steps)
    for mine, ref in ((ours.c_skip, j._c_skip), (ours.c_d0, j._c_d0),
                      (ours.c_d1, j._c_d1), (ours.alpha, j._alpha_j),
                      (ours.sigma, j._sigma_j)):
        np.testing.assert_allclose(mine, np.asarray(ref), rtol=1e-6,
                                   atol=0)
    # first order at step 0 and at the final zero-sigma step
    assert ours.c_d1[0] == 0 and ours.c_d1[-1] == 0
    assert ours.c_skip[-1] == 0


def test_lms_coefficients_and_noise_sigma_match_jax():
    j, ours = _pair("lms")
    before = ours.init_noise_sigma
    j.set_timesteps(50)
    ours.set_timesteps(50)
    np.testing.assert_allclose(ours.coeffs, np.asarray(j._coeffs),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(ours.sigmas, j.sigmas, rtol=1e-6, atol=0)
    assert ours.init_noise_sigma == pytest.approx(j.init_noise_sigma,
                                                  rel=1e-6)
    assert ours.init_noise_sigma == pytest.approx(before, rel=1e-12)
    assert ours.init_noise_sigma > 14  # sigma_max of SD-2's schedule


@pytest.mark.parametrize("name", NAMES)
def test_whole_loop_matches_jax_at_every_step(name):
    j, ours = _pair(name)
    n = STEPS[name]
    jplan = j.set_timesteps(n)
    plan = ours.set_timesteps(n)
    rng = np.random.default_rng(70)
    x0 = rng.standard_normal(SHAPE).astype(np.float32)
    eps_seq = rng.standard_normal((len(plan),) + SHAPE).astype(np.float32)
    jx = jnp.asarray(x0) * j.init_noise_sigma
    x = torch.from_numpy(x0) * ours.init_noise_sigma
    jstate = j.init_loop_state(jx)
    state = ours.init_loop_state(x)
    steps = torch.arange(len(plan))
    for i in range(len(plan)):
        jscaled = j.scale_input(jx, jnp.asarray(i), jplan[i])
        scaled = ours.scale_input(x, steps[i], plan[i])
        np.testing.assert_allclose(
            scaled.numpy(), np.asarray(jscaled), rtol=1e-6,
            atol=1e-6 * float(np.abs(np.asarray(jscaled)).max()))
        eps = eps_seq[i]
        jstate, jx = j.loop_step(jstate, jnp.asarray(eps), jnp.asarray(i),
                                 jplan[i], jx)
        state, x = ours.loop_step(state, torch.from_numpy(eps), steps[i],
                                  plan[i], x)
        assert x.dtype == torch.float32
        scale = float(np.abs(np.asarray(jx)).max())
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-6,
                                   atol=1e-6 * scale, err_msg=f"step {i}")
    assert np.isfinite(x.numpy()).all()


def test_pndm_state_counts_like_jax():
    """The duplicated second step leaves the history alone and restarts
    from the first step's sample."""
    ours = sched.make_scheduler("pndm")
    plan = ours.set_timesteps(10)
    x = torch.ones(SHAPE)
    state = ours.init_loop_state(x)
    counts = []
    for i in range(4):
        state, x = ours.loop_step(state, torch.full(SHAPE, 0.1 * (i + 1)),
                                  torch.tensor(i), plan[i], x)
        counts.append((int(state["counter"]), int(state["ets_count"])))
    assert counts == [(1, 1), (2, 1), (3, 2), (4, 3)]
    assert state["ets"].dtype == torch.float32


@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction"])
def test_ddim_prediction_types_match_jax(prediction):
    cfg = dict(prediction_type=prediction, clip_sample=True)
    j = jsched.DDIMScheduler(jsched.SchedulerConfig(**cfg))
    ours = sched.DDIMScheduler(sched.SchedulerConfig(**cfg))
    jplan, plan = j.set_timesteps(10), ours.set_timesteps(10)
    rng = np.random.default_rng(71)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    for i in (0, 5, 9):
        out = rng.standard_normal(SHAPE).astype(np.float32)
        _, ref = j.loop_step((), jnp.asarray(out), i, jplan[i],
                             jnp.asarray(x))
        _, got = ours.loop_step((), torch.from_numpy(out), i, plan[i],
                                torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("method", ["add_noise", "get_velocity"])
def test_ddpm_matches_jax(method):
    j, ours = jsched.DDPMScheduler(), sched.DDPMScheduler()
    rng = np.random.default_rng(72)
    sample = rng.standard_normal(SHAPE).astype(np.float32)
    noise = rng.standard_normal(SHAPE).astype(np.float32)
    t = np.asarray([0, 999], np.int64)
    ref = getattr(j, method)(jnp.asarray(sample), jnp.asarray(noise),
                             jnp.asarray(t))
    got = getattr(ours, method)(torch.from_numpy(sample),
                                torch.from_numpy(noise), torch.from_numpy(t))
    # one fp32 sqrt and multiply-add per element
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
