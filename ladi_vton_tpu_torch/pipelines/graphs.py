"""CUDA graphs of the try-on sampler: what ``TryOnPipeline.jit_sample``
builds.

The JAX package compiles its sampler (``jit_sample``) into device
programs that run without the host.  PyTorch's counterpart of a compiled
program is a captured ``torch.cuda.CUDAGraph``: the launches of one
eager run, recorded once and replayed by one call.  ``Sampler`` is the
JAX ``sampler``:

* ``split=False``: one graph of the whole sample;
* ``split=True``, ``denoise_mode="scan"``: three graphs, prepare, the
  unrolled denoise loop, decode;
* ``split=True``, ``denoise_mode="host"``: a prepare graph (which also
  scales the latents and makes the scheduler's first state), one graph
  of ``denoise_one_step`` replayed once a step after the step index, the
  timestep and the scheduler state are written into its inputs, and a
  decode graph.

A graph reads and writes fixed addresses, so each input signature (the
shapes and dtypes of the inputs, and which of them are given) gets its
own static input buffers and graphs, captured at its first call; the
sampler's static keys are fixed when it is built.  The three graphs of a
signature share one memory pool, since they always replay in the order
they were captured; signatures have pools of their own.  A request
copies its inputs into the buffers, replays, and gets a clone of the
image, so it may keep it while the next request replays.

The draws are made eagerly, in ``TryOnPipeline._draw``'s order, and
copied in like the inputs: the generators advance as under
``TryOnPipeline.sample``, and the graphed image is ``sample``'s, bit for
bit.  The sampler has its own copy of the scheduler, whose plan it sets
once: the graphs read its coefficient tables, which a later
``set_timesteps`` on the pipeline's scheduler would otherwise replace.

Each graph is captured on the sampler's own stream after one eager run
there, which makes what the first call makes lazily outside the graph:
the kernel library's build and load, ``sm_count``, GroupNorm's
``_check_placeable``, K1's shared-memory attribute, cuBLAS's workspace
for the stream, K2's split-form counters for (device, stream) and the
resize tables.  Under autocast (the trainers' validation) the capture
runs without autocast's cache of cast weights, so the casts are in the
graph.  A capture or replay that fails raises; nothing runs eagerly in
its place on the card.  On the CPU, where nothing is
captured, the sampler runs the same stages eagerly.

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
import gc
import time
from typing import Callable, Optional

import torch

from ladi_vton_tpu_torch.ops.flash_attention import flash_attention
from ladi_vton_tpu_torch.ops.geglu import geglu
from ladi_vton_tpu_torch.ops.group_norm import group_norm
from ladi_vton_tpu_torch.ops.layer_norm import layer_norm
from ladi_vton_tpu_torch.pipelines.tryon import cloth_gate_start

DENOISE_MODES = ("scan", "host")
WRAPPERS = (flash_attention, geglu, group_norm, layer_norm)


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
    """``body(*args)`` captured as one CUDA graph on ``stream``, after one
    eager run there; ``args`` are the static tensors it reads (any nesting
    of tuples, lists and dicts), ``outputs`` what it returned.  ``pool``:
    another graph's memory pool to share."""

    def __init__(self, body: Callable, *args, stream: torch.cuda.Stream,
                 pool=None):
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream), _uncached_autocast():
            body(*args)
        before = counts()
        self.graph = torch.cuda.CUDAGraph()
        # no collection during the capture: one that freed another graph
        # (a sampler dropped in a reference cycle) would free device
        # memory, which the capture forbids.  ``torch.cuda.graph`` would
        # also collect and empty the allocator's cache first, which only
        # costs time here
        collecting = gc.isenabled()
        gc.disable()
        try:
            with _uncached_autocast(), torch.cuda.stream(stream):
                self.graph.capture_begin(pool=pool,
                                         capture_error_mode="thread_local")
                try:
                    self.outputs = body(*args)
                finally:
                    self.graph.capture_end()
        finally:
            if collecting:
                gc.enable()
            after = counts()
            self.deltas = {k: after[k] - before[k] for k in after}
            _add_counts({k: -d for k, d in self.deltas.items()})

    @property
    def pool(self):
        return self.graph.pool()

    def replay(self):
        self.graph.replay()
        _add_counts(self.deltas)
        return self.outputs


def _leaves(tree) -> list:
    """The tensors of a scheduler state or input tree, in a fixed order."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def _signature(x: dict) -> tuple:
    return tuple((k, None if v is None else (tuple(v.shape), v.dtype))
                 for k, v in sorted(_flat(x).items()))


def _flat(x: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in x.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _static_like(x, device):
    if isinstance(x, dict):
        return {k: _static_like(v, device) for k, v in x.items()}
    if x is None:
        return None
    return torch.empty(x.shape, dtype=x.dtype, device=device)


def _load(static: dict, x: dict) -> None:
    for dst, src in zip(_leaves(static), _leaves(x)):
        dst.copy_(src)


class Sampler:
    """``TryOnPipeline.jit_sample``'s sampler (see the module docstring).

    ``sets`` holds one ``GraphSet`` per input signature seen, and
    ``capture_seconds`` the seconds each took to capture (host clock,
    synchronised; warm-up runs and instantiation included)."""

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
        device = self.pipe.device
        self.timesteps = self.pipe.scheduler.set_timesteps(
            num_inference_steps, device=device)
        self.steps = torch.arange(len(self.timesteps), device=device)
        self.graphed = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.graphed else None
        self.sets: dict = {}
        self.capture_seconds: dict = {}

    # the stages, on the inputs ``x`` (static buffers when captured)

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

    def decode(self, latents: torch.Tensor, prepared: dict) -> torch.Tensor:
        return self.pipe.decode(latents, prepared["intermediate"])

    def whole(self, x: dict) -> torch.Tensor:
        prepared = self.prepare(x)
        return self.decode(self.denoise(prepared, x), prepared)

    def eager(self, x: dict) -> torch.Tensor:
        """The stages of this sampler's mode, run eagerly."""
        if self.mode == "whole":
            return self.whole(x)
        prepared = self.prepare(x)
        if self.mode == "scan":
            latents = self.denoise(prepared, x)
        else:
            latents, state, inputs = self.loop_inputs(prepared, x)
            for i in range(len(self.timesteps)):
                latents, state = self.step(latents, state, self.steps[i],
                                           self.timesteps[i], inputs)
        return self.decode(latents, prepared)

    @torch.no_grad()
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
        x = {"image": image, "mask_image": mask_image, "pose_map": pose_map,
             "warped_cloth": warped_cloth, "prompt_embeds": prompt_embeds,
             "negative_prompt_embeds": negative_prompt_embeds,
             "draws": self.pipe.draws(image, generator=generator,
                                      noise=noise, latents=latents)}
        if not self.graphed:
            return self.eager(x)
        key = _signature(x)
        graphs = self.sets.get(key)
        if graphs is None:
            t0 = time.perf_counter()
            graphs = GraphSet(self, x)
            torch.cuda.synchronize(self.pipe.device)
            self.capture_seconds[key] = time.perf_counter() - t0
            self.sets[key] = graphs
        else:
            graphs.load(x)
        return graphs.run().clone()


class GraphSet:
    """One input signature's static inputs (``inputs``) and graphs, made
    from the first inputs ``x`` (copied in before the warm-up runs)."""

    def __init__(self, s: Sampler, x: dict):
        # the sampler's plan, not the sampler: no reference cycle, so a
        # dropped sampler frees its graphs at once
        self.mode, self.steps, self.timesteps = s.mode, s.steps, s.timesteps
        self.inputs = _static_like(x, s.pipe.device)
        self.load(x)
        stream = s.stream
        if s.mode == "whole":
            self.graphs = [Graph(s.whole, self.inputs, stream=stream)]
            return
        if s.mode == "scan":
            prep = Graph(s.prepare, self.inputs, stream=stream)
            pool = prep.pool
            den = Graph(s.denoise, prep.outputs, self.inputs, stream=stream,
                        pool=pool)
            dec = Graph(s.decode, den.outputs, prep.outputs, stream=stream,
                        pool=pool)
            self.graphs = [prep, den, dec]
            return
        # "host": the step reads the latents and state the prepare graph
        # wrote, and each replay's results are copied back over them
        def prepare(x: dict) -> tuple:
            prepared = s.prepare(x)
            return (prepared, *s.loop_inputs(prepared, x))

        prep = Graph(prepare, self.inputs, stream=stream)
        pool = prep.pool
        prepared, latents, state, inputs = prep.outputs
        device = s.pipe.device
        self.step_i = torch.zeros((), dtype=s.steps.dtype, device=device)
        self.t = torch.zeros((), dtype=s.timesteps.dtype, device=device)
        step = Graph(s.step, latents, state, self.step_i, self.t, inputs,
                     stream=stream, pool=pool)
        dec = Graph(s.decode, latents, prepared, stream=stream, pool=pool)
        self.graphs = [prep, step, dec]

    def load(self, x: dict) -> None:
        """Copy a request's inputs and draws into the static inputs."""
        _load(self.inputs, x)

    def run(self) -> torch.Tensor:
        """Replay on the static inputs as they stand; the image, in the
        graphs' memory until the next replay."""
        if self.mode != "host":
            for g in self.graphs:
                out = g.replay()
            return out
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
