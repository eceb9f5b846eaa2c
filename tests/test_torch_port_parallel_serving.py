"""Serving try-on over the data x model mesh of ranks, on the CPU.

Two gloo ranks (``parallel.launch``) share this host:

* ``TryOnService(mesh=data 2)`` at batch 2 around
  ``test_torch_port_pipeline``'s tiny pipeline (the JAX weights carried
  to the port), serving the 128x64 images of the serving tests: rank 0's
  ``sample_batch`` of a 2-image request with the JAX draws for the
  global batch against the JAX
  ``TryOnService(mesh=make_mesh(MeshSpec(data=2)))`` on the same request
  and key, within the port's pipeline limit of 1e-4 plus the JAX mesh
  service's own re-association of 5e-5; then, after rank 0 has idled
  past the process group's timeout (a few seconds, on the group these
  ranks are spawned with), its ``generate`` of request 0 against the
  one-process port service (same batch size, seed and request count),
  within 1e-4, and the follower alive to answer it.
* The same at data 1 x model 2 (the tensor-parallel UNet).
* ``python -m ladi_vton_tpu_torch.cli.serve`` as two rank processes over
  ``test_torch_port_cli.write_tiny_tree``'s tree (``--device cpu
  --dist_backend gloo --port 0``), at data 2 and at ``--tensor_parallel
  2``: a raw request through ``/condition`` and ``/tryon`` with the port's
  client within 1e-4 of ``test_torch_port_serving.direct_answer``, then
  SIGINT to rank 0, after which every rank exits 0.  With its follower
  killed, rank 0 fails the next request and exits non-zero.
* A batch size the data axis does not divide is refused.

At 64x64 the tiny UNet's lowest level is 1x1, where GroupNorm(32) over
64 channels normalises two values a group and so amplifies the CPU
convolutions' batch-size numerics (a row sampled at batch 1 against the
same row at batch 2) to 1.3e-4; from 128x64 up they stay near 1e-6.

Every wait has its own timeout.
"""

import signal
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ladi_vton_tpu.core.mesh import MeshSpec as JaxMeshSpec
from ladi_vton_tpu.core.mesh import make_mesh as jax_make_mesh
from ladi_vton_tpu.pipelines.serving import TryOnService as JaxTryOnService
from ladi_vton_tpu_torch.client import TryOnClient
from ladi_vton_tpu_torch.core.mesh import Mesh
from ladi_vton_tpu_torch.parallel.launch import spawn, start
from ladi_vton_tpu_torch.pipelines.serving import TryOnService
from test_torch_port_distributed import ENV
from test_torch_port_cli import H, W
from test_torch_port_pipeline import (  # noqa: F401 - fixture
    CTX,
    EMASC_IN,
    EMASC_OUT,
    UNET,
    VAE,
    pipelines,
)
from test_torch_port_serving import (  # noqa: F401 - fixture
    client_answer,
    direct_answer,
    raw_request,
    serve_argv,
    tree,
)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
# the spawned data-2 ranks' process group times out after GROUP_TIMEOUT_S;
# rank 0 idles IDLE_S between its two batches
GROUP_TIMEOUT_S = 10.0
IDLE_S = 12.0
# the port's pipeline limit (test_torch_port_pipeline.ATOL) plus the JAX
# mesh service's own re-association (tests/test_pipeline.py)
JAX_ATOL = 1e-4 + 5e-5
ATOL = 1e-4
SEED = 7
SERVICE = dict(batch_size=2, height=H, width=W, num_inference_steps=2,
               guidance_scale=7.5, context_dim=CTX, seed=SEED)


def service_request(seed: int, n: int = 2) -> dict:
    """An n-image request at H x W, as ``test_torch_port_pipeline``
    makes one at its size."""
    rng = np.random.default_rng(seed)
    f = np.float32
    mask = np.zeros((n, H, W, 1), f)
    mask[:, H // 4:H * 7 // 8, W // 5:W * 4 // 5] = 1.0
    return dict(
        image=rng.uniform(-1, 1, (n, H, W, 3)).astype(f),
        inpaint_mask=mask,
        pose_map=rng.uniform(0, 1, (n, H, W, 18)).astype(f),
        warped_cloth=rng.uniform(-1, 1, (n, H, W, 3)).astype(f),
        prompt_embeds=rng.standard_normal((n, 77, CTX)).astype(f),
        negative_prompt_embeds=rng.standard_normal((n, 77, CTX)).astype(f))


def jax_draws(rng, n: int) -> dict:
    """The JAX sampler's three normal draws for a global batch of n, as
    ``tryon.prepare`` makes them (``test_torch_port_pipeline._jax_noise``
    at H x W)."""
    keys = dict(zip(("latents", "masked", "cloth"), jax.random.split(rng, 3)))
    return {name: torch.from_numpy(np.array(jax.random.normal(
        k, (n, H // 8, W // 8, 4)))) for name, k in keys.items()}


@pytest.fixture(scope="module")
def mesh_runs(pipelines):
    """Each mesh's ranks: rank 0's results and the follower's."""
    _, _, pipe = pipelines
    base = {"unet_cfg": dict(in_channels=31, **UNET), "vae_cfg": VAE,
            "emasc_cfg": (EMASC_IN, EMASC_OUT), "service": SERVICE,
            "state": {"unet": pipe.unet.state_dict(),
                      "vae": pipe.vae.state_dict(),
                      "emasc": pipe.emasc.state_dict()},
            "request": service_request(61)}
    data2 = {**base, "mesh": dict(data=2), "idle_s": IDLE_S,
             "padded": service_request(62),
             "noise": jax_draws(jax.random.key(63), 2)}
    model2 = {**base, "mesh": dict(data=1, model=2), "idle_s": 0.0}
    target = "torch_port_dist_workers:serve_rank"
    with ThreadPoolExecutor(2) as pool:  # the two pairs at once
        runs = {"data2": pool.submit(spawn, target, 2, (data2,),
                                     timeout=TIMEOUT_S, env=ENV,
                                     group_timeout=GROUP_TIMEOUT_S),
                "model2": pool.submit(spawn, target, 2, (model2,),
                                      timeout=TIMEOUT_S, env=ENV)}
        return {k: v.result(timeout=TIMEOUT_S) for k, v in runs.items()}


def test_data2_service_matches_the_jax_mesh_service(pipelines, mesh_runs):
    stages, params, _ = pipelines
    jax_service = JaxTryOnService(
        stages.jpipe, params,
        mesh=jax_make_mesh(JaxMeshSpec(data=2), devices=jax.devices()[:2]),
        **SERVICE)
    ref = jax_service.generate(**service_request(62),
                               rng=jax.random.key(63))
    ours = mesh_runs["data2"][0]["sample_batch"]
    assert ours.shape == ref.shape == (2, H, W, 3)
    err = float(np.abs(ours - ref).max())
    print(f"data 2 against the JAX mesh service: max abs {err:.3e}")
    assert err <= JAX_ATOL


@pytest.mark.parametrize("mesh", ["data2", "model2"])
def test_two_ranks_match_one_process(pipelines, mesh_runs, mesh):
    _, _, pipe = pipelines
    ref = TryOnService(pipe, **SERVICE).generate(**service_request(61))
    ours = mesh_runs[mesh][0]["generate"]
    assert ours.shape == ref.shape == (2, H, W, 3)
    err = float(np.abs(ours - ref).max())
    print(f"{mesh} against one process: max abs {err:.3e}")
    assert err <= ATOL


def test_an_idle_follower_outlives_the_group_timeout(mesh_runs):
    # the follower waited through rank 0's idle time, then sampled its
    # rows of the request (held above) and returned at rank 0's stop
    assert mesh_runs["data2"][1]["followed_s"] > IDLE_S > GROUP_TIMEOUT_S


def test_indivisible_batch_size_is_refused(pipelines):
    _, _, pipe = pipelines
    data2 = Mesh(data=2, model=1, data_index=0, model_index=0,
                 data_ranks=(0, 1), model_ranks=(0,))
    with pytest.raises(ValueError, match="multiple"):
        TryOnService(pipe, **{**SERVICE, "batch_size": 3}, mesh=data2)


# ------------------------------------------------- cli.serve as two ranks

def serve_ranks(tree, log_dir, *flags):
    return start([sys.executable, "-m", "ladi_vton_tpu_torch.cli.serve",
                  *serve_argv(tree), "--dist_backend", "gloo", *flags], 2,
                 timeout=TIMEOUT_S, env=ENV, cwd=ROOT, log_dir=log_dir)


def wait_url(ranks) -> str:
    """Rank 0's address, once it serves."""
    deadline = time.monotonic() + TIMEOUT_S
    while time.monotonic() < deadline and ranks.failure() is None:
        for line in ranks.output(0).splitlines():
            if line.startswith("serving try-on on "):
                return line.split()[3]
        time.sleep(0.05)
    raise AssertionError(f"rank 0 did not serve ({ranks.failure()}): "
                         f"{(ranks.logs / 'rank0.err').read_text()[-4000:]}")


@pytest.mark.parametrize("flags", [[], ["--tensor_parallel", "2"]],
                         ids=["data2", "model2"])
def test_serve_over_two_ranks_answers_and_stops_on_sigint(tree, flags,
                                                          tmp_path):
    raw = raw_request(2)
    ref = direct_answer(tree, raw)
    with serve_ranks(tree, tmp_path, *flags) as ranks:
        client = TryOnClient(wait_url(ranks), timeout_s=TIMEOUT_S)
        ours = client_answer(client, raw)
        health = client.healthz()
        ranks.procs[0].send_signal(signal.SIGINT)
        outputs = ranks.wait()  # raises unless every rank exits 0
    assert "rank 1 follows rank 0" in outputs[1][0]
    assert (health["batch_size"], health["requests_done"],
            health["errors"]) == (2, 1, 0)
    for a, b in zip(ours[0] + (ours[1],), ref[0] + (ref[1],)):
        assert a.shape == b.shape
        err = float(np.abs(a - b).max())
        assert err <= ATOL, err
    print(f"{flags}: the served image within "
          f"{float(np.abs(ours[1] - ref[1]).max()):.3e} of one process")


def test_a_killed_follower_ends_rank0(tree, tmp_path):
    raw = raw_request(2)
    with serve_ranks(tree, tmp_path) as ranks:
        client = TryOnClient(wait_url(ranks), timeout_s=TIMEOUT_S)
        ranks.procs[1].kill()
        ranks.procs[1].wait(timeout=TIMEOUT_S)
        with pytest.raises(Exception):  # an error answer or a cut reply
            client_answer(client, raw)
        code = ranks.procs[0].wait(timeout=TIMEOUT_S)
    assert code != 0
    assert "process group failed" in (tmp_path / "rank0.err").read_text()
