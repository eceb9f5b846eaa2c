"""The try-on sampler over a model axis, captured in pieces
(``pipelines.graphs.Graph``, ``core.mesh.model_all_reduce``), against
``TryOnPipeline.sample`` and the JAX ``tensor_parallel_sampler``, on the
CPU.

Two gloo ranks at data 1 x model 2 run ``torch_port_dist_workers.
tp_sample_runs`` over the tiny towers of ``test_torch_port_pipeline.py``
(every attention divides into two ranks' heads), DDIM-2, CFG 7.5, two
requests of one image with their own inputs and draws:

* ``parallel.sharding.make_sampler`` returns the graphed sampler
  (``jit_sample(split=True, denoise_mode="host")``) at a model axis of 2;
  on the CPU it runs eagerly.
* The same sampler capturing on the CPU: each graph is a
  ``RecordedGraph``, which records the ATen calls between its
  ``capture_begin`` and ``capture_end`` and replays them over the same
  tensors.  Its first call captures (the warm-up eager, then the pieces)
  and replays; its second replays.  Each image is ``pipe.sample``'s bit
  for bit on its rank, and within rtol 2e-3, atol 2e-4 of the JAX
  ``tensor_parallel_sampler``'s on a (1, 2) CPU mesh with the same
  weights and draws (``tests/test_tp.py``'s tolerance).
* The cuts against ``torch.distributed.all_reduce`` recorded: the step
  graph cuts once at each ``all_reduce`` of one eager UNet call, on a
  buffer of its shape, in its order (three a transformer block: two
  attentions and the feed-forward); prepare and decode are one graph
  each; no collective inside a piece; a replay runs each cut's
  ``all_reduce`` once, outside any stage.
* Planted faults: a replay that skips one cut's ``all_reduce`` gives
  another image; an ``all_reduce_mean`` planted in the step raises at
  the capture (``core.mesh.outside_stage``).
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladi_vton_tpu.core.mesh import MeshSpec as JaxMeshSpec
from ladi_vton_tpu.core.mesh import make_mesh as jax_make_mesh
from ladi_vton_tpu.parallel.tp import tensor_parallel_sampler
from ladi_vton_tpu_torch.models.layers import BasicTransformerBlock
from ladi_vton_tpu_torch.parallel.launch import spawn
from test_torch_port_pipeline import (  # noqa: F401 - the fixture
    EMASC_IN,
    EMASC_OUT,
    UNET,
    VAE,
    _jax_noise,
    _request,
    pipelines,
)

ROOT = Path(__file__).resolve().parents[1]
ENV = {"PYTHONPATH": os.pathsep.join([str(ROOT), str(ROOT / "tests")]),
       "OMP_NUM_THREADS": "1"}
TIMEOUT_S = 240
STATIC = dict(num_inference_steps=2, guidance_scale=7.5)
UNET_CALLS = 2  # DDIM-2, CFG batched into one call a step
REQUESTS = (80, 81)  # seeds of the two requests and their draws
SAMPLE_ARGS = ("image", "mask_image", "pose_map", "warped_cloth",
               "prompt_embeds", "negative_prompt_embeds")
SKIP = 3  # the replayed all_reduce the planted fault skips


def _args(seed: int) -> tuple:
    req = _request(seed)
    return tuple(torch.from_numpy(req[k]) for k in SAMPLE_ARGS)


@pytest.fixture(scope="module")
def runs(pipelines):
    _, _, pipe = pipelines
    payload = {
        "unet_cfg": dict(in_channels=31, **UNET), "vae_cfg": VAE,
        "emasc_cfg": (EMASC_IN, EMASC_OUT),
        "state": {"unet": pipe.unet.state_dict(),
                  "vae": pipe.vae.state_dict(),
                  "emasc": pipe.emasc.state_dict()},
        "static": STATIC, "skip": SKIP,
        "requests": [(_args(seed), _jax_noise(jax.random.key(seed), 1))
                     for seed in REQUESTS]}
    return spawn("torch_port_dist_workers:tp_sample_runs", 2, (payload,),
                 timeout=TIMEOUT_S, env=ENV)


@pytest.fixture(scope="module")
def jax_images(pipelines):
    """Each request through the JAX ``tensor_parallel_sampler`` on a
    (1, 2) CPU mesh, the UNet's weights split over ``model``."""
    stages, params, _ = pipelines
    jpipe = stages.jpipe
    mesh = jax_make_mesh(JaxMeshSpec(data=1, model=2),
                         devices=jax.devices()[:2])

    def sample_fn(p, image, mask_image, pose_map, warped_cloth,
                  prompt_embeds, negative_prompt_embeds, rng):
        return jpipe.sample(
            p, image=image, mask_image=mask_image, pose_map=pose_map,
            warped_cloth=warped_cloth, prompt_embeds=prompt_embeds,
            negative_prompt_embeds=negative_prompt_embeds, rng=rng,
            **STATIC)

    jitted, placed = tensor_parallel_sampler(sample_fn, mesh, params)
    out = []
    for seed in REQUESTS:
        req = _request(seed)
        out.append(np.asarray(jitted(
            placed, *(jnp.asarray(req[k]) for k in SAMPLE_ARGS),
            jax.random.key(seed))))
    return out


def test_make_sampler_is_the_graphed_sampler_at_model_2(runs):
    for r in runs:
        assert (r["kind"], r["mode"]) == ("Sampler", "host")
        assert not r["graphed"]  # on the CPU it runs eagerly


@pytest.mark.parametrize("request_i", [0, 1], ids=["captures", "replays"])
def test_pieces_are_bitwise_pipe_sample(runs, request_i):
    for r in runs:
        sampled = r["sampled"][request_i]
        assert sampled.shape == (1, 64, 64, 3)
        assert torch.isfinite(sampled).all()
        assert torch.equal(r["pieces"][request_i], sampled)
        assert torch.equal(r["made"][request_i], sampled)
    # the requests differ, and the ranks agree
    assert not torch.equal(runs[0]["sampled"][0], runs[0]["sampled"][1])
    assert torch.equal(runs[0]["pieces"][request_i],
                       runs[1]["pieces"][request_i])


@pytest.mark.parametrize("request_i", [0, 1], ids=["captures", "replays"])
def test_pieces_match_the_jax_tensor_parallel_sampler(runs, jax_images,
                                                      request_i):
    for r in runs:
        np.testing.assert_allclose(r["pieces"][request_i].numpy(),
                                   jax_images[request_i], rtol=2e-3,
                                   atol=2e-4)


def test_one_cut_for_each_model_axis_all_reduce(runs, pipelines):
    _, _, pipe = pipelines
    blocks = sum(isinstance(m, BasicTransformerBlock)
                 for m in pipe.unet.modules())
    for r in runs:
        eager = r["eager"][0]
        cuts = len(eager) // UNET_CALLS
        # two attentions and the feed-forward of every transformer block
        assert cuts == 3 * blocks and len(eager) == UNET_CALLS * cuts
        assert all(stage is None for stage, _ in eager)
        prep, step, dec = r["graphs"]
        assert prep["pieces"] == dec["pieces"] == 1
        assert step["pieces"] == cuts + 1
        assert step["cut_shapes"] == [shape for _, shape in eager[:cuts]]
        # nothing collective inside a piece
        assert not any(g["collectives"] for g in r["graphs"])
        # the first call: the step's eager warm-up, then two replays; the
        # second: two replays, each cut's all_reduce once, in order,
        # outside any stage
        assert r["piece_calls"][0] == eager + eager[:cuts]
        assert r["piece_calls"][1] == r["eager"][1]


def test_a_skipped_cut_breaks_the_equality(runs):
    for r in runs:
        assert torch.isfinite(r["skipped"]).all()
        assert not torch.equal(r["skipped"], r["sampled"][1])


def test_a_collective_planted_in_a_piece_raises(runs):
    for r in runs:
        assert r["planted_error"] is not None
        assert "inside the capture stage" in r["planted_error"]
