"""The port's train steps as programs (``pipelines.graphs.TrainProgram``)
and the TPS evaluation, the extraction and the metric towers as programs
(``pipelines.graphs.Program``), against the JAX package's jitted
programs, on the CPU.

On the CPU a program runs its body (the card captures the same body, and
``chip_smoke.py`` phase 14 holds the graphs to it bit for bit), so these
tests hold the bodies and the programs' host part: the learning rate
written before each update, the count advanced after it.

* The optimizer: a program whose body hands the split ``Optimizer`` a
  gradient sequence and updates, three steps under every schedule of
  ``LR_SCHEDULERS``, against optax's clip + AdamW fed the same
  parameters and gradients: the learning rate written at each step
  equals the JAX schedule's at that count, the parameters within 1e-6.
* The train steps, three each, against the JAX steps on the tiny towers
  of ``test_torch_port_train_steps.py`` (same weights through the
  bridge, the JAX draws handed to the port): the VTO step against the
  JAX ``shard_step``'s jitted step over a one-device mesh, and EMASC the
  same way, with AdamW after the clip under a warm-up whose learning
  rate changes at every step; TPS and the refinement against their
  jitted JAX steps under Adam(0.5, 0.99).  Held after every step: the
  losses (VTO and EMASC within 1e-5 relative, TPS and the refinement
  within ``TPS_METRIC_RTOL``), every trained parameter's update
  (``UPDATE_RTOL``), BatchNorm's running statistics (``STATS_RTOL``)
  and the counts.
* The refusal rules: ``train.steps.eager_reason`` (graphed with no mesh
  and over a data axis alone, eager at a model axis above 1), and a training
  program's refusal of a dropout with p > 0 in training mode (BatchNorm
  in training mode allowed).
* The checkpoint round trip: ``Optimizer.state_dict`` loads into a fresh
  optimizer, a trajectory resumed from it equals the unbroken one bit
  for bit, and a captured optimizer refuses a load.
* The inference programs: the TPS evaluation (warped and refined) and
  the extraction against the JAX ``warp_and_refine`` and the JAX main's
  ``_eval_batch_*`` formulas, jitted, at the tolerance of
  ``test_torch_port_condition.py`` (1e-4); ``MetricModels``' LPIPS and
  SSIM programs against the JAX towers at the tolerances of
  ``test_torch_port_metrics.py``, and its Inception program equal to the
  tower called directly (``test_torch_port_metrics.py`` holds the same
  program against the JAX Inception).
* Loading either AdamW form into either: the groups follow the loading
  optimizer, the step counters are fp32 on the parameters' device, and
  a resumed trajectory continues the unbroken one.
"""

import copy
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from ladi_vton_tpu.diffusion.schedulers import DDPMScheduler as JaxDDPM
from ladi_vton_tpu.metrics.compute import MetricModels as JaxModels
from ladi_vton_tpu.metrics.ssim import ssim as jax_ssim
from ladi_vton_tpu.models import tps as jtps
from ladi_vton_tpu.models.emasc import EMASC as JaxEMASC
from ladi_vton_tpu.models.refinement import UNetVanilla as JaxUNetVanilla
from ladi_vton_tpu.models.vgg import vgg_loss as jax_vgg_loss
from ladi_vton_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from ladi_vton_tpu.ops.resize import resize_bilinear as jax_resize
from ladi_vton_tpu.train import steps as jsteps
from ladi_vton_tpu.train import tps_steps as jtps_steps
from ladi_vton_tpu_torch.core import checkpoint as ckpt
from ladi_vton_tpu_torch.core.mesh import Mesh, single
from ladi_vton_tpu_torch.metrics.compute import MetricModels
from ladi_vton_tpu_torch.models import layers
from ladi_vton_tpu_torch.models import tps
from ladi_vton_tpu_torch.models.emasc import EMASC, emasc_channels
from ladi_vton_tpu_torch.models.inversion_adapter import InversionAdapter
from ladi_vton_tpu_torch.models.refinement import UNetVanilla
from ladi_vton_tpu_torch.pipelines import graphs
from ladi_vton_tpu_torch.train import steps, tps_steps
from test_torch_port_train_emasc import vgg_pair
from test_torch_port_train_steps import (
    EMPTY,
    LOSS_RTOL,
    B,
    H,
    W,
    adapter_pair,
    make_batch,
    nchw,
    pair,
    rel_l2,
    text_pair,
    to_torch,
    unet_pair,
    vae_pair,
    vto_jax_draws,
)
from test_torch_port_train_tps import (
    bias_before_batch_norm,
    bn_pair,
    warp_batch,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from make_metric_weights import make_metric_weights  # noqa: E402

torch.set_num_threads(2)
T = torch.from_numpy
STEPS = 3
# AdamW after the clip, under a warm-up of two updates: the learning
# rate is 0, 5e-4 and 1e-3 at the three steps
OPT = dict(warmup_steps=2, lr_scheduler="constant_with_warmup",
           weight_decay=1e-2, max_grad_norm=1.0)
LR = 1e-3
TPS_LR = 1e-4
# every trained parameter's update since the first step, relative L2 to
# the JAX update, after each step.  VTO and EMASC: the gradients agree to
# 1e-4 and the updates to 1.7e-4 and 5.4e-5 (measured).  TPS and the
# refinement: their gradients agree only to 2e-3 and 3e-2
# (``test_torch_port_train_tps.py`` says why), and Adam, which moves each
# element by about lr whatever its gradient's size, turns that into
# updates 1.4e-2 to 1.0e-1 (TPS) and 0.16 to 0.19 (refinement) apart over
# the three steps (measured); a step left out or a learning rate not
# written is an error of 1
UPDATE_RTOL = {"vto": 1e-3, "emasc": 1e-3, "tps": 0.3, "refinement": 0.5}
# the losses and metrics after each step, relative: the VTO and EMASC
# ones to LOSS_RTOL; TPS's and the refinement's drift with their
# parameters, up to 2.3e-3 (TPS's regularisers) and 1.5e-4 (measured)
TPS_METRIC_RTOL = 1e-2
# BatchNorm's running statistics, relative L2: up to 6.3e-4 (TPS, where
# not ``after_zero_bias``) and 3.8e-3 (the refinement) at the third step
STATS_RTOL = {"tps": 5e-3, "refinement": 2e-2}
# the inference programs against the JAX formulas (fp32, the tolerance of
# ``test_torch_port_condition.py`` for the conditioning towers); the
# extraction's uint8 pixels within one level (a rounding at .5 may flip)
WARP_TOL = 1e-4
TOWER_RTOL = 1e-4
SSIM_ATOL = 1e-6


def jax_state(tree: dict, key_map) -> dict:
    """A flax parameter or statistics tree as the port's state dict."""
    return ckpt.state_dict_from_jax(flatten_dict(tree), key_map)


def initial(module: torch.nn.Module) -> dict:
    return {k: p.detach().numpy().copy()
            for k, p in module.named_parameters()}


def check_params(module: torch.nn.Module, ref: dict, start: dict,
                 rtol: float, step: int, lr: float = 0.0,
                 zero=lambda key: False) -> None:
    """Every parameter's update since ``start`` within ``rtol`` relative
    L2 of the JAX one (none where the JAX one is none: a learning rate
    of 0); one whose gradient is 0 in exact arithmetic (``zero(key)``:
    Adam then follows each side's rounding noise, of either sign) within
    the ``lr`` a step that Adam moves an element at most."""
    got = dict(module.named_parameters())
    assert sorted(got) == sorted(ref)
    for key, p in got.items():
        ours = p.detach().numpy() - start[key]
        want = ref[key].numpy() - start[key]
        if zero(key):
            diff = np.abs(ours - want).max()
            assert diff <= 2 * lr * (step + 1), (step, key, diff)
        elif not want.any():
            assert not ours.any(), (step, key)
        else:
            err = rel_l2(ours, want)
            assert err <= rtol, (step, key, err)


def check_metrics(ours: dict, ref: dict, rtols: dict, step: int) -> None:
    for key, rtol in rtols.items():
        r = float(ref[key])
        assert abs(float(ours[key]) - r) <= rtol * abs(r), (step, key)


def after_zero_bias(key: str) -> bool:
    """The running means of the BatchNorms that follow TPS's regression
    convs, whose biases have a zero gradient (``bias_before_batch_norm``):
    a mean moves with its conv's bias."""
    parts = key.split(".")
    return (key.startswith("loc_net.regression.conv.")
            and key.endswith("running_mean")
            and bias_before_batch_norm(".".join(
                parts[:3] + [str(int(parts[3]) - 1), "bias"])))


def check_stats(module: torch.nn.Module, batch_stats, key_map,
                count: int, rtol: float, lr: float = 0.0) -> None:
    """BatchNorm's running statistics within ``rtol`` relative L2; a mean
    that follows a bias of zero gradient (``after_zero_bias``) within the
    ``lr`` a step its bias may drift by."""
    ref = jax_state({"batch_stats": batch_stats}, key_map)
    ours = module.state_dict()
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert stats
    for key in stats:
        if after_zero_bias(key):
            diff = np.abs(ours[key].numpy() - ref[key].numpy()).max()
            assert diff <= 2 * lr * count, (key, diff)
            continue
        err = rel_l2(ours[key].numpy(), ref[key].numpy())
        assert err <= rtol, (key, err)
    for key in [k for k in ours if k.endswith("num_batches_tracked")]:
        assert int(ours[key]) == count, key


def shard_step(step_fn, state):
    """The JAX ``shard_step`` over a one-device ``data`` mesh, and the
    state placed as its outputs are (so the second call reuses the first
    call's program)."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jitted, shard = jsteps.shard_step(step_fn, mesh)
    repl = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    return jitted, shard, jax.device_put(state, repl)


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("schedule", steps.LR_SCHEDULERS)
def test_optimizer_program_writes_the_schedule(schedule):
    rng = np.random.default_rng(70)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    # global norms above the clip at the second step, below it elsewhere
    grads = [[(rng.standard_normal(s) * scale).astype(np.float32)
              for s in shapes] for scale in (0.05, 2.0, 0.1)]
    kw = dict(warmup_steps=2, lr_scheduler=schedule, total_steps=4)
    tx = jsteps.make_optimizer(1e-2, weight_decay=1e-2, max_grad_norm=1.0,
                               **kw)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(T(p.copy())) for p in params]
    opt = steps.make_optimizer(tp, 1e-2, weight_decay=1e-2,
                               max_grad_norm=1.0, **kw)
    assert not opt.capturable and opt.lr is None  # the CPU's form
    written = []

    def body(gs):
        opt.zero_grad()
        for p, g in zip(tp, gs):
            p.grad = g.clone()
        written.append(opt.adamw.param_groups[0]["lr"])
        opt.update()
        return {"count": torch.tensor(opt.count)}

    program = graphs.TrainProgram(body, optimizer=opt, device="cpu")
    jax_lr = jsteps.make_lr_schedule(schedule, 1e-2, 2, 4)
    for i, g in enumerate(grads):
        out = program([T(x) for x in g])
        # the count the update read, advanced after it
        assert int(out["count"]) == i and opt.count == i + 1
        ref = float(jax_lr(i)) if callable(jax_lr) else jax_lr
        assert written[i] == pytest.approx(ref, rel=1e-6, abs=1e-12), i
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax_apply(jp, updates)
        for ours, r in zip(tp, jp):
            np.testing.assert_allclose(ours.detach().numpy(), np.asarray(r),
                                       rtol=1e-6, atol=1e-6)


def optax_apply(params, updates):
    import optax

    return optax.apply_updates(params, updates)


# ------------------------------------------------------------ train steps


def test_vto_program_matches_jax_shard_step():
    jvae, vv, vae = vae_pair()
    jtext, tv, text = text_pair()
    jad, av, adapter = adapter_pair()
    jun, uv, unet = unet_pair(31, 14)
    for m in (vae, text, adapter):
        m.requires_grad_(False)
    cfg = dict(uncond_fraction=0.5, num_vstar=2)
    jitted, shard, state = shard_step(jsteps.make_vto_train_step(
        unet=jun, vae=jvae, text_model=jtext, noise_scheduler=JaxDDPM(),
        config=jsteps.VTOStepConfig(**cfg), inversion_adapter=jad,
        empty_prompt_ids=jnp.asarray(EMPTY)), jsteps.TrainState.create(
            {"unet": uv}, jsteps.make_optimizer(LR, **OPT)))
    start = initial(unet)
    frozen = {"vae": vv, "text": tv, "adapter": av}
    opt = steps.make_optimizer(list(unet.parameters()), LR, **OPT)
    program = steps.make_vto_train_step(
        optimizer=opt, config=steps.VTOStepConfig(**cfg), unet=unet,
        vae=vae, text_model=text, inversion_adapter=adapter,
        empty_prompt_ids=T(EMPTY).long())
    assert isinstance(program, graphs.TrainProgram) and not program.graphed
    assert set(program.modules) == {unet, vae, text, adapter}
    for i in range(STEPS):
        batch = make_batch(80 + i)
        rng = jax.random.key(90 + i)
        state, metrics = jitted(state, frozen, shard(jax.tree_util.tree_map(
            jnp.asarray, batch)), rng)
        ours = program(to_torch(batch), vto_jax_draws(rng, B))
        check_metrics(ours, metrics, {"loss": LOSS_RTOL}, i)
        check_params(unet, jax_state(state.params["unet"],
                                     ckpt.unet_key_map), start,
                     UPDATE_RTOL["vto"], i)
    assert opt.count == int(state.step) == STEPS


def test_emasc_program_matches_jax_shard_step():
    jvgg, vggv, vgg = vgg_pair()
    jvae, vv, vae = vae_pair()
    vae.requires_grad_(False)
    in_ch, out_ch = emasc_channels(vae.config)
    jm = JaxEMASC(in_channels=in_ch, out_channels=out_ch, kind="nonlinear")
    ev, emasc = pair(jm, EMASC(in_ch, out_ch, kind="nonlinear"),
                     ckpt.emasc_key_map("nonlinear"),
                     [jnp.zeros((1, 8, 8, c)) for c in in_ch], seed=42)
    jitted, shard, state = shard_step(jsteps.make_emasc_train_step(
        vae=jvae, emasc=jm, vgg=jvgg, vgg_weight=0.5),
        jsteps.TrainState.create({"emasc": ev},
                                 jsteps.make_optimizer(LR, **OPT)))
    start = initial(emasc)
    opt = steps.make_optimizer(list(emasc.parameters()), LR, **OPT)
    program = steps.make_emasc_train_step(optimizer=opt, vae=vae,
                                          emasc=emasc, vgg=vgg,
                                          vgg_weight=0.5)
    for i in range(STEPS):
        full = make_batch(100 + i)
        batch = {k: full[k] for k in ("image", "im_mask", "inpaint_mask")}
        rng = jax.random.key(110 + i)
        state, metrics = jitted(state, {"vae": vv, "vgg": vggv},
                                shard(jax.tree_util.tree_map(jnp.asarray,
                                                             batch)), rng)
        draws = {"latents": nchw(jax.random.normal(rng, (B, H // 8, W // 8,
                                                         4)))}
        ours = program(to_torch(batch), draws)
        check_metrics(ours, metrics, dict.fromkeys(("loss", "l1", "vgg"),
                                                   LOSS_RTOL), i)
        check_params(emasc, jax_state(state.params["emasc"],
                                      ckpt.emasc_key_map("nonlinear")),
                     start, UPDATE_RTOL["emasc"], i)


def test_tps_program_matches_jax_step():
    TH, TW = 128, 96
    jm = jtps.ConvNetTPS(height=TH, width=TW, input_nc_b=21)
    variables, module = bn_pair(jm, tps.ConvNetTPS(TH, TW, 21),
                                ckpt.tps_key_map, jnp.zeros((1, TH, TW, 3)),
                                jnp.zeros((1, TH, TW, 21)), seed=120)
    jstep = jax.jit(jtps_steps.make_tps_train_step(tps=jm))
    state = jtps_steps.MutableTrainState.create(
        variables, jtps_steps.tps_optimizer(TPS_LR))
    opt = tps_steps.tps_optimizer(module.parameters(), TPS_LR)
    program = tps_steps.make_tps_train_step(tps=module, optimizer=opt)
    assert program.modules == (module,)
    start = initial(module)
    for i in range(STEPS):
        # the target off the L1 loss's kink, as test_torch_port_train_tps
        batch = warp_batch(121 + i, TH, TW, target=(1.5, 2.5))
        state, metrics = jstep(state, jax.tree_util.tree_map(jnp.asarray,
                                                             batch))
        ours = program(to_torch(batch))
        check_metrics(ours, metrics, dict.fromkeys(
            ("loss", "l1", "const"), TPS_METRIC_RTOL), i)
        check_params(module, jax_state(state.params, ckpt.tps_key_map),
                     start, UPDATE_RTOL["tps"], i, TPS_LR,
                     bias_before_batch_norm)
        check_stats(module, state.extra["batch_stats"], ckpt.tps_key_map,
                    i + 1, STATS_RTOL["tps"], TPS_LR)


def test_refinement_program_matches_jax_step():
    RH, RW = 64, 48
    jt = jtps.ConvNetTPS(height=256, width=192, input_nc_b=21)
    tv, tmodule = bn_pair(jt, tps.ConvNetTPS(256, 192, 21), ckpt.tps_key_map,
                          jnp.zeros((1, 256, 192, 3)),
                          jnp.zeros((1, 256, 192, 21)), seed=130)
    jr = JaxUNetVanilla()
    rv, rmodule = bn_pair(jr, UNetVanilla(), ckpt.refinement_key_map,
                          jnp.zeros((1, RH, RW, 24)), seed=131)
    jvgg, vggv, vgg = vgg_pair()
    tmodule.requires_grad_(False)
    jstep = jax.jit(jtps_steps.make_refinement_train_step(
        tps=jt, refinement=jr, vgg=jvgg, height=RH, width=RW))
    state = jtps_steps.MutableTrainState.create(
        rv, jtps_steps.tps_optimizer(TPS_LR))
    opt = tps_steps.tps_optimizer(rmodule.parameters(), TPS_LR)
    program = tps_steps.make_refinement_train_step(
        optimizer=opt, tps=tmodule, refinement=rmodule, vgg=vgg, height=RH,
        width=RW)
    start = initial(rmodule)
    for i in range(STEPS):
        batch = warp_batch(132 + i, RH, RW)
        state, metrics = jstep(state, {"tps": tv, "vgg": vggv},
                               jax.tree_util.tree_map(jnp.asarray, batch))
        ours = program(to_torch(batch))
        check_metrics(ours, metrics, dict.fromkeys(
            ("loss", "l1", "vgg"), TPS_METRIC_RTOL), i)
        check_params(rmodule, jax_state(state.params,
                                        ckpt.refinement_key_map), start,
                     UPDATE_RTOL["refinement"], i)
        check_stats(rmodule, state.extra["batch_stats"],
                    ckpt.refinement_key_map, i + 1, STATS_RTOL["refinement"])


# ---------------------------------------------------------- refusal rules


def test_eager_reason_rules():
    assert steps.eager_reason(None) is None
    assert steps.eager_reason(single()) is None
    group = object()  # any process group: its collectives run
    # over the data axis alone the step is captured in two stages, with
    # its collectives between them, whatever the data axis
    for mesh in (Mesh(2, 1, 0, 0, (0, 1), (0,), data_group=group),
                 Mesh(1, 1, 0, 0, (0,), (0,), data_group=group)):
        assert steps.eager_reason(mesh) is None
    # a model axis puts collectives inside the forward and the backward
    for mesh in (Mesh(1, 2, 0, 0, (0,), (0, 1), model_group=group),
                 Mesh(2, 2, 0, 0, (0, 2), (0, 1), data_group=group,
                      model_group=group)):
        reason = steps.eager_reason(mesh)
        assert reason and "not captured" in reason
    # a program given a reason runs eagerly wherever it is; on the CPU
    # nothing is captured and no reason is kept
    opt = steps.Optimizer([torch.nn.Parameter(torch.ones(2))],
                          lambda count: 0.0)
    program = graphs.TrainProgram(lambda: {}, optimizer=opt, device="cpu",
                                  eager_reason="over ranks")
    assert not program.graphed and program.eager_reason is None


def test_training_program_refuses_dropout_not_batch_norm():
    adapter = InversionAdapter(input_dim=16, hidden_dim=32, output_dim=64,
                               num_encoder_layers=1, dropout=0.5)
    norm = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 1),
                               layers.BatchNorm2d(4)).train()
    graphs._refuse_draws([norm, adapter.eval()])  # allowed
    with pytest.raises(RuntimeError, match="draws from the device"):
        graphs._refuse_draws([adapter.train()])
    # p = 0 draws nothing
    graphs._refuse_draws([torch.nn.Dropout(0.0).train()])
    # the capture path checks before anything runs on a device
    opt = steps.Optimizer(list(adapter.parameters()), lambda count: 0.0)
    ran = []
    program = graphs.TrainProgram(lambda x: ran.append(x) or {},
                                  optimizer=opt, device="cpu",
                                  modules=(adapter,))
    program.graphed = True
    with pytest.raises(RuntimeError, match="draws from the device"):
        program(torch.zeros(1))
    assert not ran and not program.sets
    # inference programs keep their rule: no training mode at all
    with pytest.raises(RuntimeError, match="training mode"):
        graphs._refuse_training([norm])


# -------------------------------------------------------- round trip


def small_step(seed: int):
    torch.manual_seed(seed)
    module = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3, padding=1),
                                 layers.BatchNorm2d(8), torch.nn.SiLU(),
                                 torch.nn.Conv2d(8, 3, 1))
    opt = steps.make_optimizer(list(module.parameters()), 1e-2,
                               warmup_steps=3, weight_decay=1e-2,
                               max_grad_norm=1.0)

    def loss_fn(batch, draws):
        module.train()
        out = module(nchw(batch["x"]) + draws["noise"])
        return torch.mean(torch.abs(out - nchw(batch["y"]))), {}

    return module, opt, steps.build_train_step(loss_fn, opt,
                                               modules=(module,))


def small_inputs(i: int) -> tuple:
    rng = np.random.default_rng(150 + i)
    f = np.float32
    return ({"x": T(rng.standard_normal((2, 8, 8, 3)).astype(f)),
             "y": T(rng.standard_normal((2, 8, 8, 3)).astype(f))},
            {"noise": T(rng.standard_normal((2, 3, 8, 8)).astype(f))})


def test_resumed_trajectory_equals_the_unbroken_one(tmp_path):
    module, opt, step = small_step(160)
    unbroken = [float(step(*small_inputs(i))["loss"]) for i in range(4)]

    module, opt, step = small_step(160)
    first = [float(step(*small_inputs(i))["loss"]) for i in range(2)]
    torch.save({"module": module.state_dict(), "opt": opt.state_dict()},
               tmp_path / "state.pt")
    state = torch.load(tmp_path / "state.pt", weights_only=True)
    assert all(isinstance(g["lr"], float)
               for g in state["opt"]["adamw"]["param_groups"])
    again, opt2, step2 = small_step(161)  # other weights, then loaded
    again.load_state_dict(state["module"])
    opt2.load_state_dict(state["opt"])
    assert opt2.count == 2
    rest = [float(step2(*small_inputs(i))["loss"]) for i in (2, 3)]
    assert first + rest == unbroken
    for a, b in zip(again.state_dict().values(), module.state_dict().values()):
        assert not torch.equal(a, b) or a.dtype == torch.long
    module_end = small_step(160)
    for i in range(4):
        module_end[2](*small_inputs(i))
    for (k, a), b in zip(again.state_dict().items(),
                         module_end[0].state_dict().values()):
        assert torch.equal(a, b), k
    for pa, pb in zip(opt2.params, module_end[1].params):
        sa, sb = opt2.adamw.state[pa], module_end[1].adamw.state[pb]
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    # a captured program reads the state in place: no load into it
    opt2.captured = True
    with pytest.raises(RuntimeError, match="before the program's first"):
        opt2.load_state_dict(state["opt"])


# ---------------------------------------------------- inference programs


@pytest.fixture(scope="module")
def warping():
    RH, RW = 64, 48
    jt = jtps.ConvNetTPS(height=256, width=192, input_nc_b=21)
    tv, tmodule = bn_pair(jt, tps.ConvNetTPS(256, 192, 21), ckpt.tps_key_map,
                          jnp.zeros((1, 256, 192, 3)),
                          jnp.zeros((1, 256, 192, 21)), seed=170)
    jr = JaxUNetVanilla()
    rv, rmodule = bn_pair(jr, UNetVanilla(), ckpt.refinement_key_map,
                          jnp.zeros((1, RH, RW, 24)), seed=171)
    jvgg, vggv, vgg = vgg_pair()
    batch = warp_batch(172, RH, RW)
    return (jt, tv, jr, rv, jvgg, vggv), (tmodule.eval(), rmodule.eval(),
                                          vgg), batch, (RH, RW)



def jax_eval(jt, tv, jr, rv, jvgg, vggv, batch, size, refined: bool):
    """The JAX main's ``_eval_batch_refined`` or ``_eval_batch_tps``,
    jitted: (warped, L1, VGG)."""

    def run(arrays):
        if refined:
            warped = jtps_steps.warp_and_refine(
                jt, tv, jr, rv, cloth=arrays["cloth"],
                im_mask=arrays["im_mask"], pose=arrays["pose"],
                height=size[0], width=size[1])
        else:
            low = [jax_resize(arrays[k], (256, 192))
                   for k in ("cloth", "im_mask", "pose")]
            grid, *_ = jt.apply(tv, low[0],
                                jnp.concatenate(low[1:], axis=-1))
            warped = jax_grid_sample(arrays["cloth"],
                                     jax_resize(grid, size),
                                     padding_mode="border")
        l1 = jnp.mean(jnp.abs(warped - arrays["im_cloth"]))
        return warped, l1, jax_vgg_loss(jvgg, vggv, warped,
                                        arrays["im_cloth"])

    return jax.jit(run)({k: jnp.asarray(v) for k, v in batch.items()})


@pytest.mark.parametrize("refined", [False, True])
def test_tps_eval_program_matches_jax(warping, refined):
    jax_towers, (tmod, rmod, vgg), batch, size = warping
    warped, ref_l1, ref_vgg = jax_eval(*jax_towers, batch, size, refined)
    program = graphs.Program(functools.partial(
        tps_steps.eval_batch, tmod, rmod, vgg, refined=refined,
        height=size[0], width=size[1]), device="cpu",
        modules=(tmod, rmod, vgg))
    ours, l1, perc = program(to_torch(batch))
    np.testing.assert_allclose(ours.numpy(), np.clip(np.asarray(warped),
                                                     -1, 1),
                               rtol=WARP_TOL, atol=WARP_TOL)
    assert abs(float(l1) - float(ref_l1)) <= WARP_TOL * abs(float(ref_l1))
    assert abs(float(perc) - float(ref_vgg)) <= WARP_TOL * abs(
        float(ref_vgg))


def test_extraction_program_matches_jax(warping):
    jax_towers, (tmod, rmod, _), batch, size = warping
    warped, _, _ = jax_eval(*jax_towers, batch, size, refined=True)
    ref = np.asarray(warped)
    program = graphs.Program(functools.partial(
        tps_steps.extraction_pixels, tmod, rmod, height=size[0],
        width=size[1]), device="cpu", modules=(tmod, rmod))
    pixels = program(*[T(batch[k]) for k in ("cloth", "im_mask",
                                             "pose")]).numpy()
    want = np.round(np.clip((ref + 1) / 2, 0, 1) * 255)
    assert pixels.dtype == np.uint8 and pixels.shape == ref.shape
    assert np.abs(pixels.astype(np.int64) - want).max() <= 1


@pytest.fixture(scope="module")
def metric_weights(tmp_path_factory):
    return make_metric_weights(tmp_path_factory.mktemp("metric_weights"))


def test_metric_tower_programs_match_jax(metric_weights):
    rng = np.random.default_rng(180)
    models = MetricModels(str(metric_weights), "cpu")
    jmodels = JaxModels(str(metric_weights))
    a = rng.uniform(0, 1, (2, 64, 48, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    model, variables = jmodels.lpips()
    ref = float(jax.jit(functools.partial(model.apply, normalize=True))(
        variables, jnp.asarray(a), jnp.asarray(b)))
    assert abs(models.lpips_distance(a, b) - ref) <= TOWER_RTOL * abs(ref)
    ref = float(jax_ssim(jnp.asarray(a), jnp.asarray(b)))
    assert abs(models.ssim(a, b) - ref) <= SSIM_ATOL
    x = rng.uniform(-1, 1, (1, 299, 299, 3)).astype(np.float32)
    feats, logits = models.inception_features(x)
    with torch.no_grad():
        direct = models.inception()(torch.from_numpy(x))
    for ours, want in zip((feats, logits), direct):
        np.testing.assert_array_equal(ours, want.numpy())
    # each tower went through its program
    assert sorted(models._programs) == ["inception", "lpips", "ssim"]
    assert all(isinstance(p, graphs.Program)
               for p in models._programs.values())


# ------------------------------------------------- loading either form


@pytest.mark.parametrize("saved,loader", [(False, False), (False, True),
                                          (True, False), (True, True)])
def test_loaded_state_follows_the_loading_optimizer(saved, loader):
    """A state saved by either AdamW form (``capturable`` as the saved
    groups say: False for one on the CPU or from the trainers before
    AdamW was capturable) loads into either: every group takes the
    loader's ``capturable`` and learning rate, the step counters are fp32
    on the parameters' device (the card's form reads them there; on the
    CPU that form's update cannot run, so only its state is held), and a
    non-capturable loader continues the unbroken trajectory bit for
    bit."""
    module, opt, step = small_step(160)
    unbroken = [float(step(*small_inputs(i))["loss"]) for i in range(4)]
    module, opt, step = small_step(160)
    for i in range(2):
        step(*small_inputs(i))
    state = copy.deepcopy(opt.state_dict())
    for group in state["adamw"]["param_groups"]:
        group["capturable"] = saved
    again, opt2, step2 = small_step(161)
    again.load_state_dict(module.state_dict())
    if loader:
        opt2.capturable, opt2.lr = True, torch.zeros(())
    opt2.load_state_dict(state)
    for group in opt2.adamw.param_groups:
        assert group["capturable"] == loader
        assert (group["lr"] is opt2.lr if loader
                else isinstance(group["lr"], float))
    for p in opt2.params:
        counter = opt2.adamw.state[p]["step"]
        assert counter.dtype == torch.float32 and counter.device == p.device
        assert float(counter) == 2
    assert opt2.count == 2
    if not loader:
        rest = [float(step2(*small_inputs(i))["loss"]) for i in (2, 3)]
        assert unbroken[2:] == rest
