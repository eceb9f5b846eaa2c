"""The port's conditioning and drivers' programs against the JAX package's
jitted ones, on the CPU.

``pipelines.graphs.Program`` is the port's ``jax.jit``: on the card a
CUDA graph per input signature, on the CPU the eager call.  Here:

* the static-shape PTE splice (``diffusion.text.splice_word_embeddings``,
  which a graph can capture) against the JAX splice and against the
  boolean-mask index write it replaced (kept below as a local oracle),
  over hypothesis draws of the ``$`` runs, with its gradients;
* ``Conditioner.jit()`` against the JAX ``build_condition_fn`` on the
  tiny towers of ``test_torch_port_condition.py`` (built once here), and
  bit for bit against the eager ``Conditioner``; ``ConditionService``
  through it;
* a program's per-signature bookkeeping (static inputs, copy-in, one
  entry a signature, cloned outputs, the training-mode refusal), with
  the capture replaced by an eager run over the static inputs, since
  nothing is captured on the CPU;
* the drivers' ``prompt_program`` against the JAX drivers' ``encode_text``
  (which jits the same calls), and ``generate_images_inversion_adapter``
  and ``InpaintPipeline.sample`` bit for bit against the eager validation
  loop the program replaced (kept below).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ladi_vton_tpu.diffusion.text import (
    encode_text_word_embedding as jax_encode,
)
from ladi_vton_tpu.diffusion.text import splice_word_embeddings as jax_splice
from ladi_vton_tpu_torch.core.rng import batch_generator
from ladi_vton_tpu_torch.diffusion.schedulers import DDIMScheduler
from ladi_vton_tpu_torch.diffusion.text import (
    VSTAR_TOKEN_ID,
    encode_text_word_embedding,
    splice_word_embeddings,
)
from ladi_vton_tpu_torch.models.unet_condition import (
    UNet2DCondition,
    UNetConfig,
)
from ladi_vton_tpu_torch.models.vae import (
    AutoencoderKL,
    DiagonalGaussian,
    VAEConfig,
)
from ladi_vton_tpu_torch.ops.resize import resize_nearest
from ladi_vton_tpu_torch.pipelines import graphs, inpaint
from ladi_vton_tpu_torch.pipelines.condition import clip_pixels
from ladi_vton_tpu_torch.pipelines.drivers import prompt_program
from ladi_vton_tpu_torch.pipelines.serving import (
    ConditionService,
    category_prompts,
)
from ladi_vton_tpu_torch.pipelines.tryon import (
    VAE_SCALE,
    _nchw,
    _nhwc,
    prepare_mask_and_masked_image,
)
from test_torch_port_condition import (  # noqa: F401 - the fixture
    ATOL,
    NUM_VSTAR,
    RTOL,
    FakeTokenizer,
    H,
    T,
    W,
    _request,
    adapter_pair,
    stage,
    text_pair,
    vision_pair,
)

# --------------------------------------------------------------- splice


def index_write_splice(input_embeds, input_ids, word_embeddings,
                       num_vstar):
    """The splice as the port wrote it before: a boolean-mask index write
    (a ``nonzero``, which waits for the device)."""
    B, S, D = input_embeds.shape
    ptes = word_embeddings.reshape(B, num_vstar, D).to(input_embeds.dtype)
    is_vstar = input_ids == VSTAR_TOKEN_ID
    has_vstar = is_vstar.any(dim=1)
    first = is_vstar.int().argmax(dim=1)
    targets = first[:, None] + torch.arange(num_vstar)
    keep = has_vstar[:, None] & (targets < S)
    rows = torch.arange(B)[:, None].expand_as(targets)
    out = input_embeds.clone()
    out[rows[keep], targets[keep]] = ptes[keep]
    return out


# (S, num_vstar): the $ runs of 1 and of 16 pseudo-words, each in a
# sequence short enough that runs are cut at S
SPLICE_SHAPES = ((8, 1), (24, 16))
B_SPLICE, D_SPLICE = 3, 4


@settings(max_examples=60, deadline=None)
@given(shape=st.sampled_from(SPLICE_SHAPES),
       starts=st.lists(st.one_of(st.none(), st.integers(0, 23)),
                       min_size=B_SPLICE, max_size=B_SPLICE),
       stray=st.booleans(), seed=st.integers(0, 2 ** 31))
def test_static_splice_matches_jax_and_the_index_write(shape, starts, stray,
                                                       seed):
    """Rows without ``$`` (None), runs from position 0, runs cut at S,
    and (``stray``) a second ``$`` after the first run, which only the
    first run's position decides."""
    S, V = shape
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 259, (B_SPLICE, S))
    for b, start in enumerate(starts):
        if start is not None:
            start %= S
            ids[b, start:start + V] = VSTAR_TOKEN_ID
            if stray and start + V + 1 < S:
                ids[b, start + V + 1] = VSTAR_TOKEN_ID
    embeds = rng.standard_normal((B_SPLICE, S, D_SPLICE)).astype(np.float32)
    words = rng.standard_normal((B_SPLICE, V * D_SPLICE)).astype(np.float32)
    e = T(embeds).requires_grad_(True)
    w = T(words).requires_grad_(True)
    ours = splice_word_embeddings(e, T(ids), w, V)
    old = index_write_splice(e, T(ids), w, V)
    ref = np.array(jax_splice(jnp.asarray(embeds), jnp.asarray(ids),
                              jnp.asarray(words), V))
    # a select copies values: the old write's, and the one-hot blend's,
    # which adds exact zeros to finite values
    assert torch.equal(ours, old)
    assert torch.equal(ours.detach(), T(ref))
    # the inversion-adapter trainer backpropagates through the splice
    g = T(rng.standard_normal(ours.shape).astype(np.float32))
    grads = torch.autograd.grad(ours, (e, w), g)
    old_grads = torch.autograd.grad(old, (e, w), g)
    for a, b in zip(grads, old_grads):
        assert torch.equal(a, b)


# --------------------------------------------------- conditioning program


def mixed_ids() -> np.ndarray:
    """A row with the ``$`` run, a row without, and a row whose run S=16
    cuts after its first pseudo-word."""
    ids = FakeTokenizer()(["a $ prompt", "no vstar", "a $ prompt"])
    ids = ids.astype(np.int64)
    ids[2, 4:4 + NUM_VSTAR] = 3
    ids[2, 15] = VSTAR_TOKEN_ID
    return ids


def test_jit_conditioner_matches_build_condition_fn(stage):
    condition, cond_params, conditioner = stage
    req = _request(110, 3)
    ids = mixed_ids()
    program = conditioner.jit()
    assert isinstance(program, graphs.Program) and not program.graphed
    args = (T(req["pose_map"]), T(req["cloth"]), T(req["im_mask"]), T(ids))
    ours = program(*args)
    ref = condition(cond_params, *(jnp.asarray(req[k]) for k in (
        "pose_map", "cloth", "im_mask")), jnp.asarray(ids))
    # the tolerance of test_conditioner_matches_build_condition_fn
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)
    for o, e in zip(ours, conditioner(*args)):
        assert torch.equal(o, e)


class EagerCapture:
    """A capture stand-in for the CPU: ``body`` run over the static
    inputs at each replay, its results written into the same output
    tensors every time, as a graph reads and writes fixed memory."""

    def __init__(self, body, inputs):
        self.body, self.inputs = body, inputs
        self.outputs = None

    def run(self):
        out = self.body(*self.inputs)
        if self.outputs is None:
            self.outputs = out
        for dst, src in zip(self.outputs, out):
            dst.copy_(src)
        return self.outputs


class CPUProgram(graphs.Program):
    """A program whose per-signature path runs on the CPU."""

    def __init__(self, body, **kw):
        super().__init__(body, device="cpu", **kw)
        self.graphed = True

    def capture(self, inputs):
        return EagerCapture(self.body, inputs)


def test_program_copies_in_per_signature_and_clones(stage, monkeypatch):
    _, _, conditioner = stage
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    program = CPUProgram(conditioner, modules=(
        conditioner.tps, conditioner.refinement, conditioner.adapter))
    ids = mixed_ids()
    calls = []
    for seed, n in ((111, 3), (112, 3), (113, 2)):
        req = _request(seed, n)
        args = (T(req["pose_map"]), T(req["cloth"]), T(req["im_mask"]),
                T(ids[:n]))
        out = program(*args)
        # the static inputs hold this call's values: the eager result
        for o, e in zip(out, conditioner(*args)):
            assert torch.equal(o, e)
        calls.append(out)
    # batches of 3 share one signature, a batch of 2 gets its own entry
    assert len(program.sets) == 2 and len(program.capture_seconds) == 2
    # clones: the next replay did not overwrite what the first returned
    assert not torch.equal(calls[0][0], calls[1][0])
    # clone=False: the signature's own outputs, which its next replay
    # overwrites in place
    req = _request(112, 3)
    own = program(T(req["pose_map"]), T(req["cloth"]), T(req["im_mask"]),
                  T(ids[:3]), clone=False)
    assert torch.equal(own[0], calls[1][0])
    req = _request(111, 3)
    again = program(T(req["pose_map"]), T(req["cloth"]), T(req["im_mask"]),
                    T(ids[:3]), clone=False)
    assert all(a is o for a, o in zip(again, own))
    assert torch.equal(own[0], calls[0][0])
    # the refinement's BatchNorm in training mode is refused at capture
    conditioner.refinement.train()
    try:
        with pytest.raises(RuntimeError, match="training mode"):
            req = _request(114, 1)
            program(T(req["pose_map"]), T(req["cloth"]), T(req["im_mask"]),
                    T(ids[:1]))
    finally:
        conditioner.refinement.eval()


def test_condition_service_runs_the_program(stage):
    _, _, conditioner = stage
    svc = ConditionService(conditioner, FakeTokenizer(), batch_size=3,
                           num_vstar=NUM_VSTAR, device="cpu")
    assert isinstance(svc.program, graphs.Program)
    svc.warmup()
    req = _request(115, 2)
    cats = ["upper_body", "dresses"]
    warped, ehs, neg = svc.run(categories=cats, **req)
    assert warped.shape == (2, H, W, 3) and ehs.shape == neg.shape == (
        2, 16, 32)
    # padded to the batch by repeating the last request, then stripped
    ids = FakeTokenizer()(svc.prompts(cats + cats[-1:])).astype(np.int64)
    pad = {k: np.concatenate([v, v[-1:]]) for k, v in req.items()}
    direct = conditioner.jit()(T(pad["pose_map"]), T(pad["cloth"]),
                               T(pad["im_mask"]), T(ids))
    for o, r in zip((warped, ehs, neg), direct):
        np.testing.assert_array_equal(o, r[:2].float().numpy())


# -------------------------------------------------------- drivers' programs


@pytest.fixture(scope="module")
def towers():
    """(JAX text tower and its variables, the port's text tower, vision
    tower and adapter, JAX adapter and its variables) of the conditioning
    tests, with their seeds."""
    jtext, text_vars, text = text_pair(seed=94)
    _, _, vision = vision_pair(seed=92)
    jadapter, adapter_vars, adapter = adapter_pair(seed=93)
    return jtext, text_vars, text, vision, jadapter, adapter_vars, adapter


@pytest.mark.parametrize("with_adapter", [True, False],
                         ids=["inversion_adapter", "noun_chunks"])
def test_prompt_program_matches_jax_encode_text(towers, with_adapter):
    jtext, text_vars, text, _, jadapter, adapter_vars, adapter = towers
    ids = mixed_ids()
    empty = FakeTokenizer()([""])[0].astype(np.int64)
    feats = np.random.default_rng(116).standard_normal(
        (3, 257, 16)).astype(np.float32)

    # the JAX drivers' ``encode_text``, a jitted program of these calls
    @jax.jit
    def encode_text(input_ids, clip_feats):
        if with_adapter:
            ptes = jadapter.apply(adapter_vars, clip_feats)
            ehs, _ = jax_encode(jtext, text_vars, input_ids, ptes, NUM_VSTAR)
        else:
            ehs, _ = jtext.apply(text_vars, input_ids)
        neg, _ = jtext.apply(text_vars, jnp.broadcast_to(
            jnp.asarray(empty), input_ids.shape))
        return ehs, neg

    ref = encode_text(jnp.asarray(ids), jnp.asarray(feats))
    program = prompt_program(text, T(empty),
                             adapter=adapter if with_adapter else None,
                             num_vstar=NUM_VSTAR)
    ours = (program(T(ids), T(feats)) if with_adapter
            else program(T(ids)))
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)


def eager_inpaint_loop(pipe, image, mask_image, ehs, neg, generator,
                       steps):
    """The inpainting sample as the port wrote it before its program:
    the draws, the 9-channel loop under CFG 7.5 and the decode, in one
    function."""
    B, Hi, Wi, _ = image.shape
    lh, lw = Hi // VAE_SCALE, Wi // VAE_SCALE
    sf = pipe.vae.config.scaling_factor
    noise = {k: torch.randn((B, 4, lh, lw), generator=generator)
             for k in ("latents", "masked")}
    mask, masked_image = prepare_mask_and_masked_image(image, mask_image)
    moments, _ = pipe.vae.encode(_nchw(masked_image))
    masked = DiagonalGaussian(moments).sample(noise["masked"]) * sf
    mask_lat = resize_nearest(_nchw(mask), (lh, lw))
    timesteps = pipe.scheduler.set_timesteps(steps)
    latents = noise["latents"] * pipe.scheduler.init_noise_sigma
    mask_lat = torch.cat([mask_lat] * 2)
    masked = torch.cat([masked] * 2)
    context = torch.cat([neg, ehs])
    state = pipe.scheduler.init_loop_state(latents)
    for i in range(len(timesteps)):
        step_i, t = torch.arange(len(timesteps))[i], timesteps[i]
        scaled = pipe.scheduler.scale_input(latents, step_i, t)
        lmi = torch.cat([scaled] * 2)
        model_in = torch.cat([lmi, mask_lat, masked], dim=1)
        pred = pipe.unet(model_in, t.expand(model_in.shape[0]), context)
        uncond, text = pred.chunk(2)
        pred = uncond + 7.5 * (text - uncond)
        state, latents = pipe.scheduler.loop_step(state, pred, step_i, t,
                                                  latents)
    decoded = pipe.vae.decode(latents / sf)
    return _nhwc((decoded.float() / 2 + 0.5).clamp(0.0, 1.0))


def eager_validation_images(pipe, text_model, tokenizer, adapter, vision,
                            loader, *, num_vstar, seed, steps):
    """The adapter's validation images as the port made them before its
    program: per batch, the towers, then the inpainting loop eagerly."""
    device = pipe.device
    towers = text_model.text_model.final_layer_norm.weight.dtype
    empty_ids = T(np.asarray(tokenizer([""]))[0].astype(np.int64))
    out = []
    for step, batch in enumerate(loader):
        input_ids = T(np.asarray(tokenizer(category_prompts(
            batch["category"], num_vstar))).astype(np.int64))
        if "clip_cloth_features" in batch:
            feats = T(batch["clip_cloth_features"]).to(towers)
        else:
            feats = vision(clip_pixels(T(batch["cloth"]), towers))
        ptes = adapter(feats.to(towers))
        ehs, _ = encode_text_word_embedding(text_model, input_ids, ptes,
                                            num_vstar)
        neg, _ = text_model(empty_ids.expand_as(input_ids))
        out.append(eager_inpaint_loop(
            pipe, T(batch["image"]), T(batch["inpaint_mask"]), ehs, neg,
            batch_generator(seed, step, device), steps))
    return out


@pytest.fixture(scope="module")
def inpaint_pipe():
    """A tiny 9-channel inpainting pipeline under DDIM."""
    torch.manual_seed(117)
    unet = UNet2DCondition(UNetConfig(
        in_channels=9, block_out_channels=(32, 64, 64, 64), head_dim=8,
        cross_attention_dim=32)).eval()
    vae = AutoencoderKL(VAEConfig(block_out_channels=(32, 32, 64, 64))).eval()
    return inpaint.InpaintPipeline(unet=unet, vae=vae,
                                   scheduler=DDIMScheduler())


def _inpaint_mask(n: int) -> np.ndarray:
    mask = np.zeros((n, 64, 64, 1), np.float32)
    mask[:, 16:48, 12:52] = 1.0
    return mask


@torch.no_grad()
def test_inpaint_sample_matches_the_eager_loop(inpaint_pipe):
    """``InpaintPipeline.sample``, the pipeline's own loop over the
    stages the adapter's validation program captures, bit for bit."""
    rng = np.random.default_rng(119)
    image = T(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32))
    mask_image = T(_inpaint_mask(2))
    ehs, neg = (T(rng.standard_normal((2, 16, 32)).astype(np.float32))
                for _ in range(2))
    ours = inpaint_pipe.sample(
        image=image, mask_image=mask_image, prompt_embeds=ehs,
        negative_prompt_embeds=neg, generator=batch_generator(9, 0, "cpu"),
        num_inference_steps=2)
    ref = eager_inpaint_loop(
        dataclasses.replace(inpaint_pipe, scheduler=DDIMScheduler()), image,
        mask_image, ehs, neg, batch_generator(9, 0, "cpu"), 2)
    assert ours.shape == (2, 64, 64, 3) and torch.isfinite(ours).all()
    assert torch.equal(ours, ref)


@pytest.mark.parametrize("cached", [False, True],
                         ids=["vision_tower", "cached_features"])
def test_adapter_validation_program_matches_the_eager_loop(
        towers, inpaint_pipe, cached, monkeypatch):
    _, _, text, vision, _, _, adapter = towers
    pipe = inpaint_pipe
    rng = np.random.default_rng(118)
    loader = []
    for n in (2, 1):  # a last batch of another size: a second signature
        batch = {"image": rng.uniform(-1, 1, (n, 64, 64, 3)).astype(
                     np.float32),
                 "inpaint_mask": _inpaint_mask(n),
                 "category": ["upper_body", "dresses"][:n],
                 "im_name": [f"{len(loader)}_{i}.jpg" for i in range(n)]}
        if cached:
            batch["clip_cloth_features"] = rng.standard_normal(
                (n, 257, 16)).astype(np.float32)
        else:
            batch["cloth"] = rng.uniform(-1, 1, (n, 64, 64, 3)).astype(
                np.float32)
        loader.append(batch)
    # the images each batch's step returns, before quantisation
    monkeypatch.setattr(inpaint, "run_batches", lambda loader, step_fn, *a,
                        **k: [step_fn(i, b) for i, b in enumerate(loader)])
    ours = inpaint.generate_images_inversion_adapter(
        pipe, text, FakeTokenizer(), adapter, None if cached else vision,
        loader, "unused", num_vstar=NUM_VSTAR, seed=7,
        num_inference_steps=2)
    with torch.no_grad():
        ref = eager_validation_images(
            dataclasses.replace(pipe, scheduler=DDIMScheduler()), text,
            FakeTokenizer(), adapter, vision, loader, num_vstar=NUM_VSTAR,
            seed=7, steps=2)
    assert [o.shape for o in ours] == [(2, 64, 64, 3), (1, 64, 64, 3)]
    for o, r in zip(ours, ref):
        assert torch.isfinite(o).all()
        assert torch.equal(o, r)
