"""The port's distribution over two gloo ranks on the CPU, against the
JAX package's mesh.

Each test starts its ranks as processes (``parallel.launch``: torchrun's
variables on a free port, a timeout that kills every rank, so a hung
rendezvous fails one test); the ranks run ``torch_port_dist_workers``.

* ``core.distributed.initialize`` from torchrun's names and from the JAX
  package's (``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID``),
  ``is_main_process``, ``gather_to_host`` in rank order (``[0, 0, 1, 1]``
  as ``tests/test_distributed.py``), a file written by rank 0 only.
* The data-parallel VTO step (tiny fp32 towers carrying the JAX towers'
  weights, the UNet trained, the adapter frozen) on a global batch of 4,
  two rows a rank, with the JAX draws of the global batch: the loss
  within 1e-5 relative and every gradient within 1e-4 relative L2
  (``test_torch_port_train_steps``' limits) of the JAX ``shard_step``
  over a 2-device CPU mesh, whose mean-loss gradient is a ``psum``.
* ZeRO-1 (AdamW at the reference's lr 1e-5, clip 1.0): the updated UNet
  bitwise equal to the unsharded data-parallel step's, each rank holding
  part of the AdamW state, and within 0.2 lr (2e-6) of the JAX
  ``shard_step(zero1=True)``'s: Adam scales each element's first update
  to about lr whatever its gradient, so an element whose gradient is
  near zero (a few ulps of rounding between the two frameworks' sums)
  moves by a fraction of lr differently; the gradients themselves are
  held to 1e-4 relative L2 above; two
  ZeRO-1 steps with a save, a restore into fresh modules and optimizer
  and the second step bitwise equal to two uninterrupted steps.
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from ladi_vton_tpu.core.mesh import MeshSpec as JaxMeshSpec
from ladi_vton_tpu.core.mesh import make_mesh as jax_make_mesh
from ladi_vton_tpu.diffusion.schedulers import DDPMScheduler as JaxDDPM
from ladi_vton_tpu.train import steps as jsteps
from ladi_vton_tpu_torch.core import checkpoint as ckpt
from ladi_vton_tpu_torch.parallel.launch import spawn
from test_torch_port_train_steps import (
    ADAPTER,
    EMPTY,
    GRAD_RTOL,
    LOSS_RTOL,
    T,
    TEXT,
    UNET,
    VAE,
    VISION,
    adapter_pair,
    compare_grads,
    make_batch,
    recorder,
    text_pair,
    to_torch,
    unet_pair,
    vae_pair,
    vto_jax_draws,
)

ROOT = Path(__file__).resolve().parents[1]
# the ranks import the port and the workers (no JAX), one thread each
ENV = {"PYTHONPATH": os.pathsep.join([str(ROOT), str(ROOT / "tests")]),
       "OMP_NUM_THREADS": "1"}
TIMEOUT_S = 120
B = 4
STEP_CFG = dict(uncond_fraction=0.5, num_vstar=2,
                text_usage="inversion_adapter", cloth_input_type="warped",
                train_inversion_adapter=False)
LR = 1e-5
ZERO_ATOL = 0.2 * LR


def ranks(target: str, *args, **kw) -> list:
    return spawn(f"torch_port_dist_workers:{target}", 2, args,
                 timeout=TIMEOUT_S, env=ENV, **kw)


@pytest.mark.parametrize("names", ["torchrun", "jax"])
def test_initialize_gather_and_rank0_writes(names, tmp_path):
    results = ranks("probe", str(tmp_path), names=names)
    assert [r["rank"] for r in results] == [0, 1]
    assert [r["local_rank"] for r in results] == [0, 1]
    assert all(r["world"] == 2 for r in results)
    assert [r["main"] for r in results] == [True, False]
    # every rank's array, in rank order, on every rank
    for r in results:
        assert r["gathered"] == [0.0, 0.0, 1.0, 1.0]
    assert (tmp_path / "marker.txt").read_text() == "rank0"


@pytest.fixture(scope="module")
def setup():
    """The JAX towers and the port's payload: configs, state dicts, the
    global batch and the JAX draws of two steps."""
    jvae, vv, vae = vae_pair()
    jtext, tv, text = text_pair()
    jad, av, adapter = adapter_pair()
    jun, uv, unet = unet_pair(31, 14)
    batch = make_batch(40, n=B)
    rng, rng2 = jax.random.key(41), jax.random.key(42)
    payload = {
        "unet_cfg": dict(in_channels=31, **UNET), "vae_cfg": VAE,
        "text_cfg": TEXT, "vision_cfg": VISION, "adapter_cfg": ADAPTER,
        "state": {"unet": unet.state_dict(), "vae": vae.state_dict(),
                  "text_model": text.state_dict(),
                  "inversion_adapter": adapter.state_dict()},
        "step_cfg": STEP_CFG, "empty": T(EMPTY).long(),
        "batch": to_torch(batch), "draws": vto_jax_draws(rng, B),
        "draws2": vto_jax_draws(rng2, B)}
    jstep = jsteps.make_vto_train_step(
        unet=jun, vae=jvae, text_model=jtext, noise_scheduler=JaxDDPM(),
        config=jsteps.VTOStepConfig(**STEP_CFG), inversion_adapter=jad,
        empty_prompt_ids=jnp.asarray(EMPTY))
    mesh = jax_make_mesh(JaxMeshSpec(data=2), devices=jax.devices()[:2])
    return {"payload": payload, "jstep": jstep, "mesh": mesh, "rng": rng,
            "frozen": {"vae": vv, "text": tv, "adapter": av},
            "unet_vars": uv, "batch": batch, "unet": unet}


def jax_shard_step(setup, tx, zero1: bool):
    state = jsteps.TrainState.create(
        jax.tree_util.tree_map(jnp.array, {"unet": setup["unet_vars"]}), tx)
    jitted, shard = jsteps.shard_step(setup["jstep"], setup["mesh"],
                                      state=state, zero1=zero1)
    return jitted(state, setup["frozen"], shard(jax.tree_util.tree_map(
        jnp.asarray, setup["batch"])), setup["rng"])


def test_dp_step_matches_jax_shard_step(setup):
    new_state, metrics = jax_shard_step(setup, recorder(), zero1=False)
    results = ranks("dp_grads", setup["payload"])
    ref = float(metrics["loss"])
    unet = setup["unet"]
    for r in results:
        assert abs(r["loss"] - ref) <= LOSS_RTOL * abs(ref)
        # the ranks hold the same reduced gradients
        for k, g in r["grads"].items():
            assert torch.equal(g, results[0]["grads"][k]), k
    for k, p in unet.named_parameters():
        p.grad = results[0]["grads"][k]
    compare_grads({"unet": unet}, new_state.opt_state,
                  {"unet": ckpt.unet_key_map}, rtol=GRAD_RTOL)


@pytest.fixture(scope="module")
def zero(setup, tmp_path_factory):
    return ranks("zero_runs", setup["payload"],
                 str(tmp_path_factory.mktemp("zero_ckpt")))


def test_zero1_step_is_bitwise_the_dp_step_and_matches_jax(setup, zero):
    for r in zero:
        assert sorted(r[True]) == sorted(r[False])
        assert all(torch.equal(r[True][k], r[False][k]) for k in r[False])
        # the AdamW state is split between the ranks
        assert 0 < r["numel_True"] < r["numel_False"]
    assert zero[0]["numel_True"] + zero[1]["numel_True"] == \
        zero[0]["numel_False"]
    new_state, _ = jax_shard_step(setup, jsteps.make_optimizer(
        LR, weight_decay=1e-2, max_grad_norm=1.0), zero1=True)
    ref = ckpt.state_dict_from_jax(
        flatten_dict(jax.device_get(new_state.params["unet"])),
        ckpt.unet_key_map)
    worst = max(float((zero[0][True][k] - ref[k]).abs().max()) for k in ref)
    assert worst <= ZERO_ATOL, worst


def test_zero1_checkpoint_is_whole_on_rank0_and_restores_shards(zero):
    # the consolidated state reaches rank 0 alone; a restore leaves each
    # rank its shard of the moments and no second copy of them
    assert [r["saved_on_rank"] for r in zero] == [True, False]
    for r in zero:
        assert r["restored_numel"] == r["numel_True"]
        assert r["wrapper_state"] == 0


def test_zero1_resume_is_bitwise(zero):
    for r in zero:
        assert all(torch.equal(r["resumed"][k], r["uninterrupted"][k])
                   for k in r["uninterrupted"])
    assert all(torch.equal(zero[0]["resumed"][k], zero[1]["resumed"][k])
               for k in zero[0]["resumed"])
