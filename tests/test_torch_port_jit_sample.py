"""The port's ``denoise_one_step`` and ``jit_sample`` against the JAX
package's, on the CPU.

The tiny towers, 64x64 request and shared JAX draws of
``test_torch_port_pipeline.py``.  ``denoise_one_step`` runs the first
four steps of a 4-step plan under each scheduler at ``cloth_cond_rate``
0.5, so the warped-cloth gate is open at steps 0 and 1 and closed at 2
and 3, from the same prepared inputs on both sides; the JAX step is
jitted with its static keys, as its ``jit_sample(denoise_mode="host")``
jits it, once per scheduler for the module (``jax_steps``).  The port's
``jit_sample`` runs in its three modes (``split=False``; ``split=True``
with ``"scan"`` and with ``"host"``), each held to one sample of the JAX
``jit_sample(split=True, denoise_mode="host")``, made once for the
module: the JAX package's own tests hold its three modes to each other.
On the CPU the port's sampler runs its stages eagerly, so each mode must
also equal the port's own ``sample`` bit for bit.  Last, the rule that a service over any
mesh, and the mains, take ``jit_sample`` with ``split=True`` and
``"host"``, which on the CPU runs eagerly (at a model axis above 1 the
card captures its step in pieces: ``test_torch_port_tp_sample.py``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladi_vton_tpu.diffusion import schedulers as jax_schedulers
from ladi_vton_tpu_torch.core.mesh import Mesh
from ladi_vton_tpu_torch.diffusion.schedulers import make_scheduler
from ladi_vton_tpu_torch.ops import resize
from ladi_vton_tpu_torch.parallel.sharding import make_sampler
from ladi_vton_tpu_torch.pipelines.graphs import Sampler
from ladi_vton_tpu_torch.pipelines.serving import TryOnService
from ladi_vton_tpu_torch.pipelines.tryon import cloth_gate_start
from test_torch_port_pipeline import (  # noqa: F401 - the fixture
    ATOL,
    CTX,
    H,
    W,
    _jax_noise,
    _request,
    pipelines,
)

STEPS = 4
RATE = 0.5  # the gate closes at step 2 of 4
GEN = dict(num_inference_steps=STEPS, guidance_scale=7.5,
           cloth_cond_rate=RATE)
# the latents after each step, JAX against the port, relative to their
# largest magnitude.  The tolerance the pipeline states for images,
# ATOL, is for the end of the loop; a step's latents carry the fp32 UNet
# outputs' ~1e-6 difference scaled by CFG's 7.5, by LMS's sigma (up to
# 14.6 at the first step) and by PNDM's multistep blend (coefficients up
# to 59/24): 2.8e-5 seen under DDIM, 7.3e-5 under DPM-Solver++, 1.5e-4
# under LMS and 2.3e-4 under PNDM after the gate closes
STEP_RTOL = 5e-4


def _torch(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _nchw(x):
    return _torch(x).permute(0, 3, 1, 2)


class JittedUNet:
    """A JAX UNet whose ``apply`` is one jitted function: each
    scheduler's step, traced apart, finds the UNet's trace in that
    function's cache instead of tracing it again."""

    def __init__(self, unet):
        self.apply = jax.jit(unet.apply)


@pytest.fixture(scope="module")
def jax_steps(pipelines):
    """``steps(name)`` -> (the JAX pipeline under scheduler ``name``, its
    ``denoise_one_step`` jitted with GEN's static keys), made once."""
    stages, _, _ = pipelines
    unet = JittedUNet(stages.jpipe.unet)
    made = {}

    def steps(name: str):
        if name not in made:
            jpipe = dataclasses.replace(
                stages.jpipe, unet=unet,
                scheduler=jax_schedulers.make_scheduler(name))
            # jitted as JAX ``jit_sample(denoise_mode="host")`` jits it
            made[name] = jpipe, jax.jit(functools.partial(
                jpipe.denoise_one_step, guidance_scale=7.5,
                cloth_gate_from=cloth_gate_start(STEPS, RATE)))
        return made[name]

    return steps


@pytest.mark.parametrize("scheduler", ["ddim", "pndm", "lms", "dpm"])
def test_denoise_one_step_matches_jax(pipelines, jax_steps, scheduler):
    stages, params, pipe = pipelines
    jpipe, jstep = jax_steps(scheduler)
    pipe = dataclasses.replace(pipe, scheduler=make_scheduler(scheduler))
    req = _request(70)
    a = {k: jnp.asarray(v) for k, v in req.items()}
    prepared = stages.jit("prepare")(
        params, image=a["image"], mask_image=a["mask_image"],
        pose_map=a["pose_map"], warped_cloth=a["warped_cloth"],
        rng=jax.random.key(71))
    prepared.pop("intermediate")
    gate = cloth_gate_start(STEPS, RATE)

    jax_ts = jpipe.scheduler.set_timesteps(STEPS)
    jlat = prepared["latents"] * jpipe.scheduler.init_noise_sigma
    jstate = jpipe.scheduler.init_loop_state(jlat)
    cfg = dict(zip(("mask_in", "masked_in", "pose_in", "cloth_in",
                    "context"), jpipe._cfg_inputs(
        prepared, a["prompt_embeds"], a["negative_prompt_embeds"], True)))

    timesteps = pipe.scheduler.set_timesteps(STEPS)
    ours = {k: _nchw(prepared[k]) for k in (
        "latents", "mask_lat", "masked_latents", "pose_lat",
        "cloth_latents")}
    latents, state, inputs = pipe.loop_inputs(
        ours, prompt_embeds=_torch(a["prompt_embeds"]),
        negative_prompt_embeds=_torch(a["negative_prompt_embeds"]),
        guidance_scale=7.5)
    steps = torch.arange(len(timesteps))
    assert [int(t) for t in timesteps] == [int(t) for t in jax_ts]
    for i in range(STEPS):  # gate open at 0 and 1, closed at 2 and 3
        jlat, jstate = jstep(params, jlat, jstate, jnp.asarray(i),
                             jnp.asarray(jax_ts[i]), **cfg)
        latents, state = pipe.denoise_one_step(
            latents, state, steps[i], timesteps[i], guidance_scale=7.5,
            cloth_gate_from=gate, **inputs)
        ref = np.asarray(jlat)
        np.testing.assert_allclose(
            latents.permute(0, 2, 3, 1).numpy(), ref, rtol=0,
            atol=STEP_RTOL * np.abs(ref).max(), err_msg=f"step {i}")


@pytest.fixture(scope="module")
def jax_sample(pipelines):
    """(request, draw key, image) of the JAX ``jit_sample(split=True,
    denoise_mode="host")`` under GEN, made once for the three modes."""
    stages, params, _ = pipelines
    req = _request(72)
    rng = jax.random.key(73)
    pos = [jnp.asarray(req[k]) for k in (
        "image", "mask_image", "pose_map", "warped_cloth", "prompt_embeds",
        "negative_prompt_embeds")] + [rng]
    return req, rng, np.asarray(stages.jpipe.jit_sample(
        split=True, denoise_mode="host", **GEN)(params, *pos))


@pytest.mark.parametrize("split,mode", [(False, "scan"), (True, "scan"),
                                        (True, "host")],
                         ids=["whole", "scan", "host"])
def test_jit_sample_matches_jax(pipelines, jax_sample, split, mode):
    _, _, pipe = pipelines
    req, rng, ref = jax_sample
    sampler = pipe.jit_sample(split=split, denoise_mode=mode, **GEN)
    assert isinstance(sampler, Sampler) and not sampler.graphed
    args = [_torch(req[k]) for k in (
        "image", "mask_image", "pose_map", "warped_cloth", "prompt_embeds",
        "negative_prompt_embeds")]
    ours = sampler(*args, noise=_jax_noise(rng, 1)).numpy()
    assert ours.shape == (1, H, W, 3) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)
    eager = pipe.sample(**dict(zip(
        ("image", "mask_image", "pose_map", "warped_cloth", "prompt_embeds",
         "negative_prompt_embeds"), args)), noise=_jax_noise(rng, 1),
        **GEN).numpy()
    np.testing.assert_array_equal(ours, eager)


def _mesh(data: int, model: int) -> Mesh:
    return Mesh(data=data, model=model, data_index=0, model_index=0,
                data_ranks=tuple(range(0, data * model, model)),
                model_ranks=tuple(range(model)))


@pytest.mark.parametrize("data,model", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_model_axis_service_keeps_the_eager_sampler(pipelines, data,
                                                    model):
    """At every mesh the service (and the mains, through
    ``make_sampler``) take ``jit_sample(split=True, denoise_mode="host")``:
    on the card a model axis above 1 captures its denoise step in pieces
    between the tensor-parallel ``all_reduce``s; on the CPU, at every
    mesh, it runs eagerly, as the start line says, and is
    ``pipe.sample`` bit for bit."""
    _, _, pipe = pipelines
    mesh = _mesh(data, model)
    service = TryOnService(pipe, batch_size=2 * data, height=H, width=W,
                           num_inference_steps=2, context_dim=CTX,
                           mesh=mesh)
    try:
        # the callers' sampler: prepare, one step graph, decode
        assert isinstance(service.sampler, Sampler)
        assert service.sampler.mode == "host"
        assert not service.sampler.graphed
        assert service.sampler_kind == "eager sampler (CPU)"
    finally:
        service.close()
    sampler = make_sampler(pipe, mesh, **GEN)
    assert isinstance(sampler, Sampler) and sampler.mode == "host"
    # on the CPU the sampler runs eagerly: pipe.sample's image
    req = _request(74)
    args = [_torch(req[k]) for k in (
        "image", "mask_image", "pose_map", "warped_cloth", "prompt_embeds",
        "negative_prompt_embeds")]
    noise = _jax_noise(jax.random.key(75), 1)
    np.testing.assert_array_equal(
        sampler(*args, noise=noise).numpy(),
        pipe.sample(**dict(zip(
            ("image", "mask_image", "pose_map", "warped_cloth",
             "prompt_embeds", "negative_prompt_embeds"), args)),
            noise=noise, **GEN).numpy())


@pytest.mark.parametrize("kind", ["bilinear", "nearest"])
def test_resize_tables_are_cached(kind, monkeypatch):
    """A second call at the same sizes reads the tables the first put on
    the device (no copy from the host, which a graph cannot capture) and
    gives the first call's result bit for bit."""
    x = torch.from_numpy(np.random.default_rng(76).standard_normal(
        (2, 18, 40, 24)).astype(np.float32))
    if kind == "bilinear":
        def fn():
            return resize.resize_bilinear(x, (13, 7))
        keys = [("bilinear", 40, 13, False, x.device),
                ("bilinear", 24, 7, False, x.device)]
    else:
        def fn():
            return resize.resize_nearest(x, (13, 7))
        keys = [("nearest", 40, 13, x.device), ("nearest", 24, 7, x.device)]
    for k in keys:
        resize._tables.pop(k, None)
    first = fn()
    tables = [resize._tables[k] for k in keys]
    # the tables are made with numpy: without it, only the cache can serve
    monkeypatch.setattr(resize, "np", None)
    second = fn()
    assert all(resize._tables[k] is t for k, t in zip(keys, tables))
    assert torch.equal(first, second)
