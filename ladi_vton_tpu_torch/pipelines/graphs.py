"""CUDA graphs: the port's counterpart of the JAX package's ``jax.jit``.

The JAX package compiles every program it runs (the sampler, the
conditioning, the drivers' text and vision towers, the VAE
reconstruction, the inpainting validation, the metric towers, the train
steps) into device programs that run without the host.  PyTorch's
counterpart of a compiled program is a captured ``torch.cuda.CUDAGraph``:
the launches of one eager run, recorded once and replayed by one call.

``Program(body, device=...)`` is that counterpart for any ``body(*args)``
over tensor trees (tensors, None, and tuples, lists and dicts of them).
On the card, each input signature (the trees' structure, shapes and
dtypes) gets its own static input buffers and graphs, captured at its
first call; a call copies its inputs into the buffers, replays, and
returns clones of the outputs, so a caller may keep them while the next
call replays.  On the CPU, where nothing is captured, a program calls
``body`` itself.  A program runs under ``torch.no_grad()``.  The graphs
read the modules' parameters in place: modules moved or reloaded need a
new program.  ``modules`` holding a BatchNorm or dropout in training
mode are refused at capture, since the graph would record the training
forward (running-statistics updates, one dropout mask for good).

``TrainProgram`` is a train step as a program (the JAX ``shard_step``):
grad mode on, the optimizer's learning rate written before each call and
its count advanced after, the first call of a signature the real step
(eager) before the capture, and dropout in training mode refused where
BatchNorm in training mode is captured with its statistics' update.  A
step over the data axis of ranks is two graphs of one pool, the
gradients' and the update's, with its collectives run eagerly between
and after them (``Seams``, ``StagedTrainStep``).

``LoopProgram`` captures a sampling loop as three graphs of one memory
pool, replayed in the order they were captured: a prepare graph (which
also makes the scheduler's first state), one step graph replayed once a
step after the step index and the timestep are written into its inputs
and its results copied back over the latents and the state, and a decode
graph.  ``Sampler`` is the JAX ``sampler`` of
``TryOnPipeline.jit_sample``:

* ``split=False``: one graph of the whole sample;
* ``split=True``, ``denoise_mode="scan"``: three graphs, prepare, the
  unrolled denoise loop, decode;
* ``split=True``, ``denoise_mode="host"``: the ``LoopProgram`` graphs,
  with ``denoise_one_step`` as the step.

The draws are made eagerly, in ``TryOnPipeline._draw``'s order, and
copied in like the inputs: the generators advance as under
``TryOnPipeline.sample``, and the graphed image is ``sample``'s, bit for
bit.  The sampler has its own copy of the scheduler, whose plan it sets
once: the graphs read its coefficient tables, which a later
``set_timesteps`` on the pipeline's scheduler would otherwise replace.

Each graph is captured on the program's own stream after one eager run
there, which makes what the first call makes lazily outside the graph:
the kernel library's build and load, ``sm_count``, GroupNorm's
``_check_placeable``, K1's shared-memory attribute, cuBLAS's workspace
for the stream, K2's split-form counters for (device, stream), the
resize tables and CLIP's normalisation constants.  Under autocast (the
trainers' validation) the capture runs without autocast's cache of cast
weights, so the casts are in the graph.  A capture or replay that fails
raises; nothing runs eagerly in its place on the card.

Over a model axis of ranks the UNet sums each sharded attention's and
feed-forward's partial outputs with an ``all_reduce`` (the JAX
``tensor_parallel_sampler`` compiles these into its one program): a
capture ends its graph at each (``core.mesh.model_all_reduce``) and
begins the next in the same pool, so the denoise step is a chain of
graphs, replayed in order with each ``all_reduce`` run eagerly on its
buffer between two of them (``Graph``).  Prepare and decode hold no
collective and stay one graph each.

The kernel wrappers count their launches in Python, which a replay does
not run: a graph keeps what each counter rose by during its capture
(and takes it back, since a capture launches nothing) and adds it at
every replay.  A replay runs no Python, so the modules' forward hooks
fire during a capture (its warm-up run and the capture itself) and not
at a replay.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import logging
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ladi_vton_tpu_torch.core.mesh import current_stage, stage
from ladi_vton_tpu_torch.ops.flash_attention import flash_attention
from ladi_vton_tpu_torch.ops.geglu import geglu
from ladi_vton_tpu_torch.ops.group_norm import group_norm
from ladi_vton_tpu_torch.ops.layer_norm import layer_norm
from ladi_vton_tpu_torch.pipelines.tryon import cloth_gate_start

DENOISE_MODES = ("scan", "host")
WRAPPERS = (flash_attention, geglu, group_norm, layer_norm)
# modules whose training-mode forward a capture would record for good
TRAINING_MODULES = (torch.nn.modules.batchnorm._BatchNorm,
                    torch.nn.modules.dropout._DropoutNd)


def counts() -> dict:
    """The kernel wrappers' launch counters, and GroupNorm's by form."""
    out = {f.__name__: f.launches for f in WRAPPERS}
    out.update({f"group_norm.{form}": n
                for form, n in group_norm.forms.items()})
    return out


def _add_counts(delta: dict) -> None:
    for f in WRAPPERS:
        f.launches += delta[f.__name__]
    for form in group_norm.forms:
        group_norm.forms[form] += delta[f"group_norm.{form}"]


def _uncached_autocast():
    """The caller's autocast without its cache of cast weights: a graph
    captured under the cache would read casts that the caller's autocast
    frees when it exits; without it, the casts are in the graph."""
    if not torch.is_autocast_enabled("cuda"):
        return contextlib.nullcontext()
    return torch.autocast("cuda", dtype=torch.get_autocast_dtype("cuda"),
                          cache_enabled=False)


class Graph:
    """``body(*args)`` captured as CUDA graphs of one pool on ``stream``,
    after one eager run there (the warm-up, whose outputs go to
    ``warmed``); ``args`` are the static tensors it reads (any nesting of
    tuples, lists and dicts), ``outputs`` what it returned.  ``pool``:
    another graph's memory pool to share.  ``warm=False``: no warm-up,
    where the caller ran the body's work already.  ``make``: the graph
    class (``torch.cuda.CUDAGraph``).

    Outside a caller's stage the capture is a stage of its own,
    ``"capture"``, whose cut is ``model_all_reduce``'s
    (``core.mesh``): where the body sums over the model axis, the
    capture ends its graph, keeps the buffer and its group in ``cuts``
    and begins the next graph in the same pool, and the body goes on over
    the buffer.  So ``pieces`` holds one graph more than ``cuts``; a body
    with no collective is one graph.  ``replay()`` replays them in the
    order they were captured on the caller's stream, with each cut's
    ``all_reduce`` run eagerly on its buffer between its two graphs.  No
    collective runs during the capture, on any rank: the warm-up ran
    them all, so the ranks' sequences stay aligned.  Any other collective
    of the port inside the capture raises (``outside_stage``).  Inside a
    caller's stage (a train program's) the stage stays, and a
    ``model_all_reduce`` raises too."""

    def __init__(self, body: Callable, *args, stream: torch.cuda.Stream,
                 pool=None, warm: bool = True,
                 make: Callable = torch.cuda.CUDAGraph):
        if warm:
            stream.wait_stream(torch.cuda.current_stream(stream.device))
            with torch.cuda.stream(stream), _uncached_autocast():
                self.warmed(body(*args))
        self.pieces, self.cuts, self.piece_deltas = [], [], []
        self._make, self._pool = make, pool
        cutting = (stage("capture", cut=self._cut)
                   if current_stage() is None else contextlib.nullcontext())
        # no collection during the capture: one that freed another graph
        # (a sampler dropped in a reference cycle) would free device
        # memory, which the capture forbids.  ``torch.cuda.graph`` would
        # also collect and empty the allocator's cache first, which only
        # costs time here
        collecting = gc.isenabled()
        gc.disable()
        try:
            with _uncached_autocast(), torch.cuda.stream(stream), cutting:
                self._begin()
                try:
                    self.outputs = body(*args)
                finally:
                    self._end()
        finally:
            if collecting:
                gc.enable()
            # a capture launches nothing: take back what the counters rose
            self.deltas = {k: sum(d[k] for d in self.piece_deltas)
                           for k in counts()}
            _add_counts({k: -d for k, d in self.deltas.items()})
        self.captured()

    def _begin(self) -> None:
        graph = self._make()
        graph.capture_begin(pool=self._pool,
                            capture_error_mode="thread_local")
        self.pieces.append(graph)
        self._before = counts()

    def _end(self) -> None:
        self.pieces[-1].capture_end()
        after = counts()
        self.piece_deltas.append({k: after[k] - self._before[k]
                                  for k in after})
        if self._pool is None:
            self._pool = self.pieces[0].pool()

    def _cut(self, t: torch.Tensor, group) -> torch.Tensor:
        self._end()
        self.cuts.append((t, group))
        self._begin()
        return t

    def warmed(self, outputs) -> None:
        """The warm-up run's outputs (dropped here), before the capture."""

    def captured(self) -> None:
        """Called once the capture has ended."""

    @property
    def pool(self):
        return self.pieces[0].pool()

    def replay(self):
        for i, graph in enumerate(self.pieces):
            if i:
                t, group = self.cuts[i - 1]
                dist.all_reduce(t, group=group)
            graph.replay()
            _add_counts(self.piece_deltas[i])
        return self.outputs


def _leaves(tree) -> list:
    """The tensors of a tensor tree, in a fixed order."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def _map(fn, tree):
    """``tree`` with ``fn`` applied to each tensor."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def _signature(tree):
    """A tensor tree's structure, shapes and dtypes."""
    if tree is None or isinstance(tree, torch.Tensor):
        return tree if tree is None else (tuple(tree.shape), tree.dtype)
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, _signature(tree[k]))
                                 for k in sorted(tree))
    if isinstance(tree, (tuple, list)):
        return ("seq",) + tuple(_signature(v) for v in tree)
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def _load(static, tree) -> None:
    for dst, src in zip(_leaves(static), _leaves(tree)):
        dst.copy_(src)


def _refuse_training(modules: Sequence[torch.nn.Module]) -> None:
    for module in modules:
        for name, m in module.named_modules():
            if m.training and isinstance(m, TRAINING_MODULES):
                raise RuntimeError(
                    f"{type(module).__name__}.{name} ({type(m).__name__}) "
                    f"is in training mode, and a CUDA graph would record "
                    f"its training forward; call .eval() before capturing")


def _refuse_draws(modules: Sequence[torch.nn.Module]) -> None:
    """A training program's rule: a BatchNorm in training mode is allowed
    (its running statistics' update is the step's own effect, and is
    captured with it), a dropout with p > 0 in training mode is not: it
    draws from the device generator, and a replay would repeat the
    capture's mask.  A step takes its draws as inputs."""
    for module in modules:
        for name, m in module.named_modules():
            if (m.training and isinstance(m, torch.nn.modules.dropout.
                                          _DropoutNd) and m.p > 0):
                raise RuntimeError(
                    f"{type(module).__name__}.{name} ({type(m).__name__}, "
                    f"p={m.p}) draws from the device generator in training "
                    f"mode, which a CUDA graph would replay unchanged; pass "
                    f"the step's draws as inputs, or call .eval()")


class Captured:
    """One signature's static ``inputs`` and ``body``'s graph over them."""

    def __init__(self, body: Callable, inputs: tuple,
                 stream: torch.cuda.Stream):
        self.inputs = inputs
        self.graph = Graph(body, *inputs, stream=stream)

    def run(self):
        return self.graph.replay()


class Program:
    """``body(*args)`` as a compiled program (see the module docstring).

    ``sets`` holds what each input signature seen captured, and
    ``capture_seconds`` the seconds each took (host clock, synchronised;
    warm-up runs and instantiation included)."""

    def __init__(self, body: Callable, *, device,
                 modules: Sequence[torch.nn.Module] = ()):
        self.body = body
        self.device = torch.device(device)
        self.modules = tuple(m for m in modules if m is not None)
        self.graphed = self.device.type == "cuda"
        self.stream = (torch.cuda.Stream(self.device) if self.graphed
                       else None)
        self.sets: dict = {}
        self.capture_seconds: dict = {}

    def capture(self, inputs: tuple):
        """What one signature replays, captured over its static
        ``inputs`` (which hold its first call's values): an object with
        ``inputs`` and ``run()``."""
        return Captured(self.body, inputs, self.stream)

    def refuse(self) -> None:
        """Raises where ``modules`` may not be captured (an inference
        program's rule: nothing in training mode)."""
        _refuse_training(self.modules)

    def replay(self, args: tuple):
        """Copy ``args`` into their signature's static inputs (capturing
        at the signature's first call) and replay: the outputs, in the
        graphs' memory until the next replay of the signature."""
        key = _signature(args)
        graphs = self.sets.get(key)
        if graphs is not None:
            _load(graphs.inputs, args)
            return graphs.run()
        self.refuse()
        t0 = time.perf_counter()
        inputs = _map(lambda x: torch.empty_like(x, device=self.device),
                      args)
        _load(inputs, args)
        graphs = self.capture(inputs)
        torch.cuda.synchronize(self.device)
        self.capture_seconds[key] = time.perf_counter() - t0
        self.sets[key] = graphs
        return self.first_run(graphs)

    def first_run(self, graphs):
        """The outputs of a signature's first call, once captured."""
        return graphs.run()

    @torch.no_grad()
    def __call__(self, *args, clone: bool = True):
        """``body(*args)``.  ``clone=False`` returns the graphs' own
        outputs, which the signature's next replay overwrites: for a
        caller that copies them out at once, under its own lock."""
        if not self.graphed:
            return self.body(*args)
        out = self.replay(args)
        return _map(torch.clone, out) if clone else out


class TrainStep(Graph):
    """One signature's static ``inputs`` and the train step's graph over
    them.  The warm-up is the real step, run once eagerly on ``stream``
    (it also makes the AdamW state, the kernel library, the cuBLAS
    workspace of the stream), and its outputs are ``first``; the cache
    that run left is released before the capture, which runs nothing, so
    the call that captures applies one update.  The capture gives
    ``params`` new gradients in the graph's pool, into which the real
    step's are copied: after the call, as after every replay, each
    ``.grad`` is this signature's gradient in the pool (another
    signature's capture points it elsewhere; a replay points it back).
    ``warmup_seconds`` and
    ``capture_seconds``: the real step's and the capture's (host clock,
    synchronised)."""

    def __init__(self, body: Callable, inputs: tuple,
                 stream: torch.cuda.Stream, params: Sequence[torch.Tensor]):
        self.inputs, self.params, self.device = inputs, params, stream.device
        self.t0 = time.perf_counter()
        super().__init__(body, *inputs, stream=stream)
        torch.cuda.synchronize(self.device)
        self.capture_seconds = time.perf_counter() - self.t0 - \
            self.warmup_seconds

    def warmed(self, outputs) -> None:
        self.first = outputs
        torch.cuda.synchronize(self.device)
        # the eager run's activations stay cached for the program's
        # stream, where nothing else allocates: hand them back before the
        # graph's pool takes the same room
        torch.cuda.empty_cache()
        self.grads = [p.grad for p in self.params]
        self.warmup_seconds = time.perf_counter() - self.t0

    def captured(self) -> None:
        _copy_grads(self.params, self.grads)
        self.grads = [p.grad for p in self.params]

    def run(self):
        out = self.replay()
        _point_grads(self.params, self.grads)
        return out


def _offload_grads(params: Sequence[torch.Tensor]) -> list:
    """The real step's gradients copied to host memory, each ``.grad``
    released from the card: ranks that share a card capture beside one
    another, and the pool need not sit beside a second copy of the
    gradients (a second or two of copying for the UNet's 3.46 GB)."""
    grads = [None if p.grad is None else p.grad.to("cpu") for p in params]
    for p in params:
        p.grad = None
    return grads


def _point_grads(params: Sequence[torch.Tensor], grads: list) -> None:
    """Each ``.grad`` back at a signature's gradients in its pool."""
    for p, g in zip(params, grads):
        p.grad = g


def _copy_grads(params: Sequence[torch.Tensor], grads: list) -> None:
    """The real step's gradients into the ones a capture gave ``params``."""
    for p, g in zip(params, grads):
        if p.grad is not None and g is not None:
            p.grad.copy_(g)


@dataclasses.dataclass(frozen=True)
class Seams:
    """The eager part of a train step over the data axis of ranks, around
    its two captured stages (the gradients', then the optimizer's
    ``update``): ``reduce()`` runs between them (the gradients' mean over
    the data group), ``finish(metrics) -> metrics`` after them (ZeRO-1's
    broadcasts, the metrics' mean over the group) on the gradient stage's
    outputs; ``what`` says what they run, for the program's log line."""

    reduce: Callable[[], None]
    finish: Callable[[dict], dict]
    what: str = ""


class StagedTrainStep:
    """One signature's static ``inputs`` and a staged train step's two
    graphs over them (``program.seams`` is set).  The warm-up is the real
    step, run once eagerly on ``stream`` with its collectives
    (``TrainProgram.run_stages``), and its outputs are ``first``; its
    cache is released, then the gradient stage (``program.body``) and the
    update stage (``optimizer.update``) are captured in that order as two
    graphs of one pool, which runs nothing: the call that captures applies
    one update.  The update graph reads the gradients the first graph
    leaves in the pool, into which the real step's are copied (held in
    host memory meanwhile, ``_offload_grads``).

    ``grads`` are the gradients the gradient graph's capture gave the
    parameters: the graph writes them at every replay, and the update
    graph reads them.  ``run()`` replays the gradient graph, points each
    ``.grad`` back at ``grads`` (another signature's capture pointed them
    at its own), runs ``seams.reduce()``, which averages the ``.grad`` it
    finds, replays the update graph and returns ``seams.finish`` of the
    first graph's outputs, all on the caller's current stream: a
    collective orders its work after that stream's (gloo copies a CUDA
    tensor out after an event recorded on it, NCCL's stream waits on it)
    and, when it returns, that stream after its own, so each sits between
    the two replays.  ``graph`` makes each graph (``Graph``'s arguments, with
    ``warm=False``).  ``warmup_seconds`` and ``capture_seconds`` as
    ``TrainStep``'s; ``pool`` the graphs' pool."""

    def __init__(self, program: "TrainProgram", inputs: tuple,
                 stream: torch.cuda.Stream, graph: Callable = Graph):
        self.inputs, self.seams = inputs, program.seams
        params, device = program.optimizer.params, stream.device
        t0 = time.perf_counter()
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream), _uncached_autocast():
            self.first = program.run_stages(*inputs)
        torch.cuda.synchronize(device)
        grads = _offload_grads(params)
        torch.cuda.empty_cache()
        self.warmup_seconds = time.perf_counter() - t0
        with stage("gradients"):
            self.gradients = graph(program.body, *inputs, stream=stream,
                                   warm=False)
        self.params = params
        self.grads = [p.grad for p in params]
        with stage("update"):
            self.update = graph(program.optimizer.update, stream=stream,
                                pool=self.gradients.pool, warm=False)
        _copy_grads(params, grads)
        torch.cuda.synchronize(device)
        self.capture_seconds = time.perf_counter() - t0 - \
            self.warmup_seconds

    @property
    def pool(self):
        return self.gradients.pool

    def run(self):
        out = self.gradients.replay()
        _point_grads(self.params, self.grads)
        self.seams.reduce()
        self.update.replay()
        return self.seams.finish(out)


class TrainProgram(Program):
    """A train step as a compiled program: the counterpart of the JAX
    ``shard_step``'s ``jax.jit(step, donate_argnums=(0,))``, whose state
    is updated in place.

    ``body(*args) -> metrics`` is the step's device work (``zero_grad``,
    the forwards and backwards, ``optimizer.update()``), with grad mode
    on; with ``seams``, the gradient stage alone (``zero_grad``, the
    forwards and backwards, this rank's metrics), which the update stage
    (``optimizer.update()``) follows, with the collectives of ``seams``
    between and after them (``run_stages``).  A call writes the learning
    rate (``optimizer.write_lr()``), runs the step, advances
    ``optimizer.count`` and returns the metrics: on the card each input
    signature's first call is the real step, after which it is captured
    (``TrainStep``, or ``StagedTrainStep`` with ``seams``), and later
    calls copy their inputs into the signature's static ones and replay.
    The gradients live in the graphs' pool.  Each captured stage runs
    inside ``core.mesh.stage``, so that a collective of the port's in it
    raises.  Before a capture, ``modules`` holding a dropout with p > 0
    in training mode are refused (``_refuse_draws``); BatchNorm in
    training mode is captured with its statistics' update.
    ``eager_reason`` (a str) runs the step eagerly on the card instead.
    On the card the program logs once how it runs."""

    def __init__(self, body: Callable, *, optimizer, device,
                 modules: Sequence[torch.nn.Module] = (),
                 eager_reason: Optional[str] = None,
                 seams: Optional[Seams] = None):
        super().__init__(body, device=device, modules=modules)
        self.optimizer = optimizer
        self.seams = seams
        self.eager_reason = eager_reason if self.graphed else None
        log = logging.getLogger(__name__)
        if self.eager_reason is not None:
            self.graphed = False
            log.info("the train step runs eagerly on %s: %s", self.device,
                     self.eager_reason)
        elif self.graphed:
            log.info("the train step is graphed on %s: %s", self.device,
                     "one graph a batch shape" if seams is None else
                     f"two graphs a batch shape, the gradients' and the "
                     f"update's; {seams.what}, eagerly")

    def refuse(self) -> None:
        _refuse_draws(self.modules)

    def capture(self, inputs: tuple):
        if self.seams is not None:
            step = StagedTrainStep(self, inputs, self.stream)
        else:
            with stage("step"):
                step = TrainStep(self.body, inputs, self.stream,
                                 self.optimizer.params)
        self.optimizer.captured = True
        return step

    def first_run(self, step):
        first, step.first = step.first, None
        return first

    def run_stages(self, *args):
        """The step's work in order, eagerly: ``body``; with ``seams``,
        the gradient stage, ``seams.reduce()``, the update stage and
        ``seams.finish``, each stage inside ``core.mesh.stage``."""
        if self.seams is None:
            return self.body(*args)
        with stage("gradients"):
            out = self.body(*args)
        self.seams.reduce()
        with stage("update"):
            self.optimizer.update()
        return self.seams.finish(out)

    def run_eager(self, *args):
        """The step as the CPU runs it (``run_stages``), between the
        learning rate's write and the count's advance."""
        self.optimizer.write_lr()
        with torch.enable_grad():
            out = self.run_stages(*args)
        self.optimizer.advance()
        return out

    def __call__(self, *args):
        if not self.graphed:
            return self.run_eager(*args)
        self.optimizer.write_lr()
        with torch.enable_grad():
            out = _map(torch.clone, self.replay(args))
        self.optimizer.advance()
        return out


class HostLoop:
    """A sampling loop's graphs over one signature's static ``inputs``
    (``(x,)``): ``plan.prepare_loop(x)`` -> (carry, latents, state, step
    inputs), ``plan.step(latents, state, step_i, t, step inputs)`` ->
    (latents, state), replayed once per step of ``plan.timesteps``, and
    ``plan.decode_loop(latents, carry)``.  ``graph`` makes each
    (``Graph``'s arguments); the step is in pieces where the UNet sums
    over the model axis."""

    def __init__(self, plan, inputs: tuple, stream: torch.cuda.Stream,
                 graph: Callable = Graph):
        # the plan's steps, not the plan: no reference to the program
        self.inputs = inputs
        self.steps, self.timesteps = plan.steps, plan.timesteps
        prep = graph(plan.prepare_loop, *inputs, stream=stream)
        pool = prep.pool
        carry, latents, state, step_inputs = prep.outputs
        self.step_i = torch.zeros((), dtype=plan.steps.dtype,
                                  device=plan.steps.device)
        self.t = torch.zeros((), dtype=plan.timesteps.dtype,
                             device=plan.timesteps.device)
        # the step reads the latents and state the prepare graph wrote,
        # and each replay's results are copied back over them
        step = graph(plan.step, latents, state, self.step_i, self.t,
                     step_inputs, stream=stream, pool=pool)
        dec = graph(plan.decode_loop, latents, carry, stream=stream,
                    pool=pool)
        self.graphs = [prep, step, dec]

    def run(self):
        prep, step, dec = self.graphs
        _, latents, state, _ = prep.replay()
        for i in range(len(self.timesteps)):
            self.step_i.copy_(self.steps[i])
            self.t.copy_(self.timesteps[i])
            new_latents, new_state = step.replay()
            latents.copy_(new_latents)
            for dst, src in zip(_leaves(state), _leaves(new_state)):
                dst.copy_(src)
        return dec.replay()


def run_loop(plan, x):
    """``plan``'s loop run eagerly, the stages ``HostLoop`` captures:
    ``prepare_loop``, ``step`` once a step, ``decode_loop``."""
    carry, latents, state, inputs = plan.prepare_loop(x)
    for i in range(len(plan.timesteps)):
        latents, state = plan.step(latents, state, plan.steps[i],
                                   plan.timesteps[i], inputs)
    return plan.decode_loop(latents, carry)


class LoopProgram(Program):
    """A sampling loop as a program: ``run_loop(plan, x)`` on the CPU,
    the ``HostLoop`` graphs of each signature on the card.  ``plan`` has
    ``device``, ``steps``, ``timesteps``, ``prepare_loop``, ``step`` and
    ``decode_loop``.  ``graph`` makes each graph (``Graph``)."""

    graph: Callable = Graph

    def __init__(self, plan, *, modules: Sequence[torch.nn.Module] = ()):
        super().__init__(functools.partial(run_loop, plan),
                         device=plan.device, modules=modules)
        self.plan = plan

    def capture(self, inputs: tuple):
        return HostLoop(self.plan, inputs, self.stream, graph=self.graph)


class SamplerPlan:
    """The try-on sampler's static keys and stages, on the inputs ``x``
    (static buffers when captured)."""

    def __init__(self, pipe, *, split: bool = False,
                 num_inference_steps: int = 50, guidance_scale: float = 7.5,
                 cloth_cond_rate: float = 1.0, no_pose: bool = False,
                 denoise_mode: str = "scan"):
        if denoise_mode not in DENOISE_MODES:
            raise ValueError(f"unknown denoise_mode {denoise_mode!r}; "
                             f"choose from {DENOISE_MODES}")
        # the sampler's own scheduler: its tables stay the graphs'
        self.pipe = dataclasses.replace(pipe,
                                        scheduler=copy.copy(pipe.scheduler))
        self.mode = denoise_mode if split else "whole"
        self.guidance_scale = guidance_scale
        self.no_pose = no_pose
        self.gate_from = cloth_gate_start(num_inference_steps,
                                          cloth_cond_rate)
        self.device = self.pipe.device
        self.timesteps = self.pipe.scheduler.set_timesteps(
            num_inference_steps, device=self.device)
        self.steps = torch.arange(len(self.timesteps), device=self.device)

    def prepare(self, x: dict) -> dict:
        return self.pipe.prepare_drawn(
            image=x["image"], mask_image=x["mask_image"],
            pose_map=x["pose_map"], warped_cloth=x["warped_cloth"],
            draws=x["draws"], no_pose=self.no_pose)

    def loop_inputs(self, prepared: dict, x: dict) -> tuple:
        return self.pipe.loop_inputs(
            prepared, prompt_embeds=x["prompt_embeds"],
            negative_prompt_embeds=x["negative_prompt_embeds"],
            guidance_scale=self.guidance_scale)

    def prepare_loop(self, x: dict) -> tuple:
        prepared = self.prepare(x)
        return (prepared, *self.loop_inputs(prepared, x))

    def denoise(self, prepared: dict, x: dict) -> torch.Tensor:
        return self.pipe.denoise_planned(
            prepared, self.timesteps, prompt_embeds=x["prompt_embeds"],
            negative_prompt_embeds=x["negative_prompt_embeds"],
            guidance_scale=self.guidance_scale,
            cloth_gate_from=self.gate_from)

    def step(self, latents, state, step_i, t, inputs: dict) -> tuple:
        return self.pipe.denoise_one_step(
            latents, state, step_i, t, guidance_scale=self.guidance_scale,
            cloth_gate_from=self.gate_from, **inputs)

    def decode_loop(self, latents: torch.Tensor,
                    prepared: dict) -> torch.Tensor:
        return self.pipe.decode(latents, prepared["intermediate"])

    def whole(self, x: dict) -> torch.Tensor:
        prepared = self.prepare(x)
        return self.decode_loop(self.denoise(prepared, x), prepared)


class Staged:
    """The whole sample as one graph, or prepare, the unrolled denoise
    loop and decode as three of one pool, over static ``inputs``; each in
    pieces where the UNet sums over the model axis (``graph``'s)."""

    def __init__(self, plan: SamplerPlan, inputs: tuple,
                 stream: torch.cuda.Stream, graph: Callable = Graph):
        self.inputs = inputs
        if plan.mode == "whole":
            self.graphs = [graph(plan.whole, *inputs, stream=stream)]
            return
        (x,) = inputs
        prep = graph(plan.prepare, x, stream=stream)
        pool = prep.pool
        den = graph(plan.denoise, prep.outputs, x, stream=stream, pool=pool)
        dec = graph(plan.decode_loop, den.outputs, prep.outputs,
                    stream=stream, pool=pool)
        self.graphs = [prep, den, dec]

    def run(self):
        for g in self.graphs:
            out = g.replay()
        return out


class Sampler(LoopProgram):
    """``TryOnPipeline.jit_sample``'s sampler (see the module docstring).
    On the CPU every mode runs ``run_loop``, the operations of
    ``TryOnPipeline.sample`` in its order."""

    def __init__(self, pipe, **static):
        plan = SamplerPlan(pipe, **static)
        super().__init__(plan, modules=(plan.pipe.unet, plan.pipe.vae,
                                        plan.pipe.emasc))
        self.mode = plan.mode

    def capture(self, inputs: tuple):
        loop = (super().capture(inputs) if self.mode == "host" else
                Staged(self.plan, inputs, self.stream, graph=self.graph))
        names = {"host": ("prepare", "step", "decode"),
                 "scan": ("prepare", "denoise", "decode"),
                 "whole": ("sample",)}[self.mode]
        cut = [f"the {name} as {len(g.pieces)} graphs with {len(g.cuts)} "
               f"all_reduces over the model axis between them"
               for name, g in zip(names, loop.graphs) if g.cuts]
        if cut:
            logging.getLogger(__name__).info(
                "the sampler (%s) at batch %d on %s: %s, run eagerly",
                self.mode, len(inputs[0]["image"]), self.device,
                "; ".join(cut))
        return loop

    def __call__(self, image: torch.Tensor, mask_image: torch.Tensor,
                 pose_map: torch.Tensor,
                 warped_cloth: Optional[torch.Tensor],
                 prompt_embeds: torch.Tensor,
                 negative_prompt_embeds: torch.Tensor, *,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[dict] = None,
                 latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Float32 NHWC images in [0, 1], as ``TryOnPipeline.sample``
        with this sampler's static keys makes them."""
        return super().__call__({
            "image": image, "mask_image": mask_image, "pose_map": pose_map,
            "warped_cloth": warped_cloth, "prompt_embeds": prompt_embeds,
            "negative_prompt_embeds": negative_prompt_embeds,
            "draws": self.plan.pipe.draws(image, generator=generator,
                                          noise=noise, latents=latents)})
