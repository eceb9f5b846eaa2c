"""The train step over the data axis of ranks as two stages with its
collectives between them (``train.steps.build_train_step``,
``pipelines.graphs.TrainProgram`` with ``Seams``), over two gloo ranks on
the CPU.

On the card each stage is a CUDA graph (``chip_smoke.py`` phase 11a
holds the replays to the eager run bit for bit); on the CPU the stages
run eagerly, in order.  The ranks run
``torch_port_dist_workers.staged_runs``: tiny seeded towers (the UNet
trained, AdamW at the reference's lr after the clip), a global batch of
4, two rows a rank, three steps a form, each with its own batch and
draws.

* Data parallelism and ZeRO-1, at accumulation 1 and 2: the staged
  program's loss and UNet after each step bitwise those of the
  single-body step it replaces (``single_body_step``: the gradients'
  mean, the clip, ``ZeroRedundancyOptimizer``'s whole step or AdamW's,
  the metrics' mean), on both ranks; the same for the program's
  per-signature path (the first call the real step, then
  ``StagedTrainStep`` over stand-ins of the graphs whose gradients stay
  in fixed tensors, ``FixedGrads``, replayed), which keeps one
  signature.  ``test_torch_port_distributed.py`` holds
  the same staged steps against the JAX ``shard_step``.
* ``torch.distributed.all_reduce`` and ``broadcast`` recorded with the
  stage they run in: none inside a stage; each step the gradients' mean
  (one bucket) and the metrics' mean, and ZeRO-1's broadcasts.  Planted
  faults: ``reduce_gradients`` moved into the gradient stage raises
  (``core.mesh.outside_stage``), and a bare ``all_reduce`` planted there
  is recorded inside it; the check fails on both.
* Two batch shapes, A, B, A (two rows a rank, then one), through the
  per-signature path over ``FixedGrads``, whose gradients stay in the
  tensors their capture made, as a CUDA graph's stay in its pool: each step bitwise ``single_body_step``'s under data
  parallelism and ZeRO-1, on both ranks, so a replay of the first shape
  averages its own gradients, not those the second capture left behind.
  A planted revert (``StaleReduce``: the reduce reads whatever ``.grad``
  points at) fails the check.
"""

import os
from pathlib import Path

import pytest
import torch

from ladi_vton_tpu_torch.models import clip
from ladi_vton_tpu_torch.models.inversion_adapter import InversionAdapter
from ladi_vton_tpu_torch.models.unet_condition import (
    UNet2DCondition,
    UNetConfig,
)
from ladi_vton_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ladi_vton_tpu_torch.parallel.launch import spawn
from ladi_vton_tpu_torch.train.steps import vto_draws
from test_torch_port_train_steps import (
    ADAPTER,
    EMPTY,
    TEXT,
    UNET,
    VAE,
    VISION,
    T,
    make_batch,
    to_torch,
)

ROOT = Path(__file__).resolve().parents[1]
ENV = {"PYTHONPATH": os.pathsep.join([str(ROOT), str(ROOT / "tests")]),
       "OMP_NUM_THREADS": "1"}
TIMEOUT_S = 120
B = 4
STEPS = 3
STEP_CFG = dict(uncond_fraction=0.5, num_vstar=2,
                text_usage="inversion_adapter", cloth_input_type="warped",
                train_inversion_adapter=False)
# (ZeRO-1, gradient accumulation)
FORMS = [(False, 1), (False, 2), (True, 1), (True, 2)]
PER_SIGNATURE = [(False, 1), (True, 2)]


def form_id(form) -> str:
    return f"{'zero1' if form[0] else 'dp'}-A{form[1]}"


def seeded(factory, seed: int) -> dict:
    torch.manual_seed(seed)
    return factory().state_dict()


@pytest.fixture(scope="module")
def runs():
    batches = [to_torch(make_batch(60 + i, n=B)) for i in range(STEPS)]
    # batch shapes A, B, A: two rows a rank, then one, then two
    signature_batches = [to_torch(make_batch(75 + i, n=n))
                         for i, n in enumerate((B, B // 2, B))]
    payload = {
        "unet_cfg": dict(in_channels=31, **UNET), "vae_cfg": VAE,
        "text_cfg": TEXT, "vision_cfg": VISION, "adapter_cfg": ADAPTER,
        "state": {
            "unet": seeded(lambda: UNet2DCondition(
                UNetConfig(in_channels=31, **UNET)), 61),
            "vae": seeded(lambda: AutoencoderKL(VAEConfig(**VAE)), 62),
            "text_model": seeded(lambda: clip.CLIPTextModel(
                clip.CLIPTextConfig(**TEXT)), 63),
            "inversion_adapter": seeded(lambda: InversionAdapter(
                vision_config=clip.CLIPVisionConfig(**VISION), **ADAPTER),
                64)},
        "step_cfg": STEP_CFG, "empty": T(EMPTY).long(), "batches": batches,
        "step_draws": [vto_draws(b, torch.Generator().manual_seed(70 + i))
                       for i, b in enumerate(batches)],
        "forms": FORMS, "per_signature": PER_SIGNATURE,
        "signature_batches": signature_batches,
        "signature_draws": [vto_draws(b, torch.Generator().manual_seed(
            80 + i)) for i, b in enumerate(signature_batches)]}
    return spawn("torch_port_dist_workers:staged_runs", 2, (payload,),
                 timeout=TIMEOUT_S, env=ENV)


def check_outside_stages(r: dict) -> None:
    """No error, and every collective recorded outside the stages."""
    assert r["error"] is None, r["error"]
    inside = [call for call in r["calls"] if call[1] is not None]
    assert not inside, inside


def same_steps(a: dict, b: dict) -> bool:
    return (len(a["losses"]) == len(b["losses"]) == STEPS
            and all(torch.equal(x, y) for x, y in zip(a["losses"],
                                                      b["losses"]))
            and all(x.keys() == y.keys()
                    and all(torch.equal(x[k], y[k]) for k in x)
                    for x, y in zip(a["unets"], b["unets"])))


@pytest.mark.parametrize("form", FORMS, ids=form_id)
def test_staged_step_is_bitwise_the_single_body_step(runs, form):
    for r in runs:
        staged, single = (r[(*form, kind)] for kind in ("staged", "single"))
        assert staged["seams"] and staged["eager_reason"] is None
        assert same_steps(staged, single)
        assert staged["count"] == single["count"] == STEPS
        # the UNet moved between the first step and the last
        start = runs[0][(*form, "staged")]["unets"][0]
        assert any(not torch.equal(start[k], staged["unets"][-1][k])
                   for k in start)
    # the ranks hold one replicated UNet and one loss
    assert same_steps(runs[0][(*form, "staged")], runs[1][(*form, "staged")])


@pytest.mark.parametrize("form", PER_SIGNATURE, ids=form_id)
def test_per_signature_path_is_bitwise_the_staged_step(runs, form):
    for r in runs:
        path = r[(*form, "per_signature")]
        assert path["signatures"] == 1 and path["count"] == STEPS
        assert same_steps(path, r[(*form, "staged")])
        check_outside_stages(dict(path, error=None))


@pytest.mark.parametrize("form", FORMS, ids=form_id)
def test_no_collective_runs_inside_a_stage(runs, form):
    zero = form[0]
    for r in runs:
        run = r[(*form, "staged")]
        check_outside_stages(dict(run, error=None))
        names = [name for name, _ in run["calls"]]
        # each step: one bucket of the gradients' mean, the loss's mean
        assert names.count("all_reduce") == 2 * STEPS
        assert ("broadcast" in names) == zero


@pytest.mark.parametrize("what", ["reduce_gradients", "all_reduce"])
def test_a_collective_planted_in_a_stage_fails_the_check(runs, what):
    for r in runs:
        planted = r[("planted", what)]
        with pytest.raises(AssertionError):
            check_outside_stages(planted)
        if what == "reduce_gradients":
            assert "inside the gradients stage" in planted["error"]
        else:
            assert planted["error"] is None
            assert ("all_reduce", "gradients") in planted["calls"]


@pytest.mark.parametrize("zero", [False, True], ids=["dp", "zero1"])
def test_each_signature_reduces_its_own_gradients(runs, zero):
    for r in runs:
        fixed, single = (r[("signatures", zero, kind)]
                         for kind in ("fixed", "single"))
        assert fixed["signatures"] == 2
        assert same_steps(fixed, single)
    assert same_steps(runs[0][("signatures", zero, "fixed")],
                      runs[1][("signatures", zero, "fixed")])


@pytest.mark.parametrize("zero", [False, True], ids=["dp", "zero1"])
def test_a_stale_reduce_fails_the_signature_check(runs, zero):
    """The planted revert applies each rank's own gradients at the third
    step (the first shape's replay): the check above fails on it."""
    for r in runs:
        stale = r[("signatures", zero, "stale")]
        assert stale["signatures"] == 2
        assert not same_steps(stale, r[("signatures", zero, "single")])
