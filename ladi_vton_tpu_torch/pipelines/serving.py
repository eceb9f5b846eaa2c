"""Serving wrappers around the conditioning stage and the try-on pipeline.

Counterparts of ``ladi_vton_tpu/pipelines/serving.py`` ``TryOnService``,
``ConditionService``, ``MicroBatcher`` and ``make_http_server``.
Requests of up to ``batch_size`` images are padded to the fixed batch
(repeating the last sample), run, and returned unpadded as float32 numpy
arrays.  A raw try-on request goes through both:
``ConditionService.run`` turns cloth, pose, masked person and category
into warped cloth and prompt embeddings, which ``TryOnService.generate``
takes with the person image and inpainting mask.  The try-on runs under
whichever scheduler its pipeline holds
(``diffusion.schedulers.make_scheduler``); the prompts are tokenized by
the caller's tokenizer, the port's ``utils.tokenizer.CLIPTokenizer`` for
the SD-2 vocabulary.  Each try-on request without an explicit generator
gets its own, seeded from (seed, request count) in place of the JAX
``fold_in``.  Over the data x model mesh of ranks, where the JAX service
shards each batch over ``data``, rank 0 serves and sends each batch to
follower ranks, which sample their rows (``TryOnService``); the batch's
draws are made for the whole padded batch, so data 2 makes the
one-process images up to the numerics of a smaller batch.

The HTTP front end is the JAX package's, path for path and byte for
byte (``.npz`` bodies, the same status codes and ``/healthz`` keys), so
either package's client talks to either package's server.  Its handler
threads run ``ConditionService.run`` while the batcher's dispatcher
thread runs ``TryOnService.generate``: both hold ``torch.no_grad()``
themselves (grad mode is per thread) and launch on the current stream.
Both replay CUDA graphs on the card: the conditioning is one
``Conditioner.jit()`` program, the try-on the sampler of
``parallel.sharding.make_sampler``; each service's ``warmup`` captures
its graphs, which a server does before it takes requests, so that no
capture runs while another thread replays.
"""

from __future__ import annotations

import io
import json
import math
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ladi_vton_tpu_torch.core import distributed
from ladi_vton_tpu_torch.core.mesh import Mesh
from ladi_vton_tpu_torch.core.rng import request_seed
from ladi_vton_tpu_torch.data.labels import CATEGORY_PROMPT_TEXT
from ladi_vton_tpu_torch.parallel.sharding import (
    make_sampler,
    sample_noise,
)
from ladi_vton_tpu_torch.pipelines.condition import Conditioner
from ladi_vton_tpu_torch.pipelines.tryon import (
    NOISE_KEYS,
    VAE_SCALE,
    TryOnPipeline,
)


def category_prompts(categories, num_vstar: int) -> list[str]:
    """The try-on prompt of each garment category, with ``num_vstar``
    ``$`` placeholders for the inversion adapter's pseudo-words
    (reference src/inference.py:281-283)."""
    return [f"a photo of a model wearing {CATEGORY_PROMPT_TEXT[str(c)]} "
            f"{' $ ' * num_vstar}" for c in categories]


def pad_batch(x: np.ndarray, batch_size: int) -> np.ndarray:
    """Pad a request to ``batch_size`` by repeating its last sample."""
    n = x.shape[0]
    if n > batch_size:
        raise ValueError(f"request batch {n} exceeds the service batch "
                         f"{batch_size}; split the request")
    if n < batch_size:
        x = np.concatenate([x] + [x[-1:]] * (batch_size - n))
    return x


# the header rank 0 of a service over ranks sends its followers: a batch
# follows it, or it only keeps them from timing out while idle, or it
# stops them
BATCH, HEARTBEAT, STOP = 0, 1, 2
POSE_CHANNELS = 18


class TryOnService:
    """Pads requests to ``batch_size``, samples them and unpads.

    Over the data x model mesh of ranks (``mesh``, ``core.mesh``), every
    rank builds the same service around its pipeline (its UNet swapped
    for the tensor-parallel one where ``mesh.model`` > 1).  Rank 0 serves:
    under its lock it sends each padded batch, and the batch's global
    draws, to the followers over the host group; every rank samples its
    rows (``mesh.rows``), and rank 0 gathers one copy of each data
    index's rows.  The followers wait in ``follow`` until rank 0's
    ``close``.  While idle, rank 0 sends a heartbeat well inside the
    group's timeout, so no follower's receive times out.  Where a
    collective fails (a follower died), the service is broken for good:
    ``broken`` holds the error, ``broken_event`` is set, and every later
    request raises.  One rank (``mesh`` None or 1 x 1) samples as
    before, with the request's generator.

    The batches go through ``parallel.sharding.make_sampler``'s
    ``TryOnPipeline.jit_sample(split=True, denoise_mode="host")``: on
    the card its CUDA graphs are captured by ``warmup`` (or the first
    request) and replayed by every request; at a model axis above 1 the
    denoise step is in pieces, with the model axis's ``all_reduce``s run
    eagerly between them.  ``sampler_kind`` says which, for the start
    line."""

    def __init__(self, pipe: TryOnPipeline, *, batch_size: int = 8,
                 height: int = 512, width: int = 384,
                 num_inference_steps: int = 50, guidance_scale: float = 7.5,
                 context_dim: int = 1024, seed: int = 0,
                 mesh: Optional[Mesh] = None):
        self.pipe = pipe
        self.batch_size = batch_size
        self.height = height
        self.width = width
        self.num_inference_steps = num_inference_steps
        self.guidance_scale = guidance_scale
        self.context_dim = context_dim
        self.seed = seed
        self._count = 0
        self._lock = threading.RLock()
        self.mesh = (mesh if mesh is not None and mesh.data * mesh.model > 1
                     else None)
        if self.mesh is not None and batch_size % self.mesh.data:
            raise ValueError(
                f"serving batch_size {batch_size} must be a multiple of "
                f"the data-axis size {self.mesh.data}")
        self.sampler = make_sampler(pipe, self.mesh,
                                    num_inference_steps=num_inference_steps,
                                    guidance_scale=guidance_scale)
        model = self.mesh.model if self.mesh is not None else 1
        self.sampler_kind = (
            "eager sampler (CPU)" if pipe.device.type != "cuda"
            else "CUDA-graphed sampler" if model == 1
            else f"CUDA-graphed sampler, its denoise step in pieces between "
                 f"the all_reduces over the model axis of {model}")
        self.broken: Optional[BaseException] = None
        self.broken_event = threading.Event()
        self._closed = False
        self._heartbeat = None
        if self.mesh is not None and distributed.is_main_process():
            self._last_sent = time.monotonic()
            self._stop_beat = threading.Event()
            self._heartbeat = threading.Thread(target=self._beat,
                                               daemon=True)
            self._heartbeat.start()

    def warmup(self) -> None:
        """Run one full-batch request ahead of the first real one: on the
        card it captures the sampler's graphs, so call it before other
        threads launch work (the batcher's, the HTTP handlers')."""
        b, h, w = self.batch_size, self.height, self.width
        z = np.zeros((b, h, w, 3), np.float32)
        self.generate(
            image=z, inpaint_mask=np.ones((b, h, w, 1), np.float32),
            pose_map=np.zeros((b, h, w, POSE_CHANNELS), np.float32),
            warped_cloth=z,
            prompt_embeds=np.zeros((b, 77, self.context_dim), np.float32),
            negative_prompt_embeds=np.zeros((b, 77, self.context_dim),
                                            np.float32))

    def _pad(self, x: np.ndarray) -> torch.Tensor:
        x = pad_batch(np.asarray(x, np.float32), self.batch_size)
        return torch.from_numpy(np.ascontiguousarray(x))

    @torch.no_grad()
    def generate(self, *, image, inpaint_mask, pose_map, warped_cloth,
                 prompt_embeds, negative_prompt_embeds,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Run one request (<= batch_size). Returns float32 NHWC images in
        [0, 1], unpadded.  Over ranks, rank 0 calls it."""
        n = image.shape[0]
        arrays = dict(zip(_REQUEST_KEYS, map(self._pad, (
            image, inpaint_mask, pose_map, warped_cloth, prompt_embeds,
            negative_prompt_embeds))))
        with self._lock:
            if generator is None:
                generator = torch.Generator(self.pipe.device).manual_seed(
                    request_seed(self.seed, self._count))
                self._count += 1
            if self.mesh is None:
                return self._sample(arrays, slice(None),
                                    generator=generator)[:n]
            noise = sample_noise(generator, self.batch_size, self.height,
                                 self.width)
            return self._lead(arrays, noise, n)[:n]

    @torch.no_grad()
    def sample_batch(self, padded: dict, noise: dict) -> np.ndarray:
        """A padded batch (the six request arrays at ``batch_size``)
        sampled with the batch's global draws ``noise`` (NHWC, as
        ``parallel.sharding.sample_noise`` draws them): float32 NHWC
        images in [0, 1].  Over ranks, rank 0 calls it and each rank
        samples its rows of both."""
        arrays = {k: self._pad(padded[k]) for k in _REQUEST_KEYS}
        if self.mesh is None:
            return self._sample(arrays, slice(None), noise=noise)
        return self._lead(arrays, noise, self.batch_size)

    def _shapes(self, tokens: int) -> dict:
        """Every array of a batch, by name, at this service's geometry and
        ``tokens`` prompt tokens."""
        b, h, w, d = (self.batch_size, self.height, self.width,
                      self.context_dim)
        lat = (b, h // VAE_SCALE, w // VAE_SCALE, 4)
        return {"image": (b, h, w, 3), "inpaint_mask": (b, h, w, 1),
                "pose_map": (b, h, w, POSE_CHANNELS),
                "warped_cloth": (b, h, w, 3), "prompt_embeds": (b, tokens, d),
                "negative_prompt_embeds": (b, tokens, d),
                **{k: lat for k in NOISE_KEYS}}

    def _send(self, kind: int, count: int = 0, n: int = 0,
              tokens: int = 0) -> None:
        distributed.broadcast_from_main(
            torch.tensor([kind, count, n, tokens], dtype=torch.int64))
        self._last_sent = time.monotonic()

    def _lead(self, arrays: dict, noise: dict, n: int) -> np.ndarray:
        """Rank 0: the header and the batch to every follower, then this
        rank's rows, then the images of every data index."""
        if not distributed.is_main_process():
            raise RuntimeError("a follower samples in follow(), not here")
        # the draws travel with the batch, through host memory
        noise = {k: noise[k].detach().to("cpu", torch.float32).contiguous()
                 for k in NOISE_KEYS}
        tensors = {**arrays, **noise}
        shapes = self._shapes(arrays["prompt_embeds"].shape[1])
        bad = {k: tuple(t.shape) for k, t in tensors.items()
               if tuple(t.shape) != shapes[k]}
        if bad:  # refused before any collective: the service stays whole
            raise ValueError(f"arrays {bad} do not fit the service's "
                             f"batch {shapes}")
        with self._lock:
            if self.broken is not None:
                raise RuntimeError(f"the service's process group failed: "
                                   f"{self.broken!r}")
            if self._closed:
                raise RuntimeError("the service is closed")
            try:
                self._send(BATCH, self._count, n,
                           shapes["prompt_embeds"][1])
                distributed.broadcast_from_main(torch.cat(
                    [tensors[k].reshape(-1) for k in shapes]))
                out = self._rows(arrays, noise)
                self._last_sent = time.monotonic()  # the followers wait
                return out
            except Exception as e:
                self._fail(e)
                raise

    def _rows(self, arrays: dict, noise: dict) -> np.ndarray:
        """Every rank: its rows sampled, then one copy of each data
        index's rows (the model ranks of one data index hold the same)."""
        out = self._sample(arrays, self.mesh.rows(self.batch_size),
                           noise=noise)
        parts = distributed.gather_to_host(out)
        return np.concatenate(list(parts[::self.mesh.model]))

    def _sample(self, arrays: dict, rows: slice, *,
                generator: Optional[torch.Generator] = None,
                noise: Optional[dict] = None) -> np.ndarray:
        """``rows`` of the padded batch through the pipeline, drawing
        from ``generator`` or taking those rows of the global ``noise``."""
        a = {k: v[rows].to(self.pipe.device) for k, v in arrays.items()}
        out = self.sampler(
            *(a[k] for k in _REQUEST_KEYS), generator=generator,
            noise=None if noise is None else {k: v[rows]
                                              for k, v in noise.items()})
        return out.cpu().numpy()

    @torch.no_grad()
    def follow(self) -> None:
        """A follower's loop: wait for rank 0's header; for a batch,
        receive it and sample this rank's rows; return on stop."""
        while True:
            header = torch.zeros(4, dtype=torch.int64)
            distributed.broadcast_from_main(header)
            kind, _, _, tokens = header.tolist()  # (kind, count, n, tokens)
            if kind == STOP:
                return
            if kind == HEARTBEAT:
                continue
            shapes = self._shapes(tokens)
            flat = torch.empty(sum(math.prod(s) for s in shapes.values()))
            distributed.broadcast_from_main(flat)
            parts = dict(zip(shapes, flat.split(
                [math.prod(s) for s in shapes.values()])))
            tensors = {k: parts[k].view(s) for k, s in shapes.items()}
            self._rows({k: tensors[k] for k in _REQUEST_KEYS},
                       {k: tensors[k] for k in NOISE_KEYS})

    def _beat(self) -> None:
        """Rank 0's heartbeat: a header whenever none went out for a
        quarter of the group's timeout (checked twice as often)."""
        interval = distributed.group_timeout().total_seconds() / 4
        while not self._stop_beat.wait(interval / 2):
            with self._lock:
                if self._closed or self.broken is not None:
                    return
                if time.monotonic() - self._last_sent < interval:
                    continue
                try:
                    self._send(HEARTBEAT)
                except Exception as e:
                    self._fail(e)
                    return

    def _fail(self, error: BaseException) -> None:
        self.broken = error
        self.broken_event.set()

    def close(self) -> None:
        """Rank 0 over ranks: stop the followers (``follow`` returns) and
        the heartbeat.  Nothing to do on one rank or a follower, nor once
        the group has failed."""
        if self._heartbeat is None:
            return
        self._stop_beat.set()
        with self._lock:
            if not self._closed and self.broken is None:
                try:
                    self._send(STOP)
                except Exception as e:
                    self._fail(e)
            self._closed = True
        self._heartbeat.join()


class ConditionService:
    """In-shop cloth + pose + masked person + category strings ->
    warped cloth and prompt embeddings, ready for ``TryOnService``.

    ``tokenizer`` maps a list of prompts to (n, S) token ids, as the CLIP
    tokenizer does (S = 77 for SD-2).  The conditioner's towers are
    placed on ``device``, and every request goes through one
    ``Conditioner.jit()`` program: requests are padded to ``batch_size``,
    so on the card ``warmup`` (or the first request) captures its one
    graph and every request replays it."""

    def __init__(self, conditioner: Conditioner, tokenizer, *,
                 batch_size: int = 8, num_vstar: int = 16,
                 device: str = "cuda"):
        self.conditioner = conditioner.to(device)
        self.program = self.conditioner.jit()
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.num_vstar = num_vstar
        self._lock = threading.Lock()

    def prompts(self, categories) -> list[str]:
        return category_prompts(categories, self.num_vstar)

    def _pad(self, x, dtype) -> torch.Tensor:
        x = pad_batch(np.asarray(x, dtype), self.batch_size)
        return torch.from_numpy(np.ascontiguousarray(x))

    def warmup(self) -> None:
        """Run one full-batch request ahead of the first real one: on the
        card it captures the program's graph, so call it before other
        threads launch work (the batcher's, the HTTP handlers')."""
        b = self.batch_size
        h, w = self.conditioner.image_size
        z = np.zeros((b, h, w, 3), np.float32)
        self.run(cloth=z, pose_map=np.zeros((b, h, w, POSE_CHANNELS),
                                            np.float32),
                 im_mask=z, categories=["upper_body"] * b)

    @torch.no_grad()
    def run(self, *, cloth, pose_map, im_mask, categories):
        """Returns float32 (warped_cloth, prompt_embeds,
        negative_prompt_embeds), unpadded to the request's n samples."""
        n = cloth.shape[0]
        input_ids = np.asarray(self.tokenizer(self.prompts(categories)))
        # the inputs' copy, the replay and the fetch, before another
        # handler thread's request overwrites the graph's buffers: the
        # fetch reads those buffers, with no clone on the device first
        with self._lock:
            out = self.program(
                self._pad(pose_map, np.float32), self._pad(cloth, np.float32),
                self._pad(im_mask, np.float32),
                self._pad(input_ids, np.int64), clone=False)
            return tuple(t[:n].float().cpu().numpy() for t in out)


_REQUEST_KEYS = ("image", "inpaint_mask", "pose_map", "warped_cloth",
                 "prompt_embeds", "negative_prompt_embeds")


class MicroBatcher:
    """Dynamic micro-batching front end for :class:`TryOnService`.

    Requests (dicts of the six sampler arrays with a leading sample axis)
    are submitted from any number of threads; one dispatcher thread
    coalesces queued requests up to the service's ``batch_size``, waiting
    at most ``max_delay_ms`` after the first, and runs ONE ``generate``
    for the group.  Each request's images come back through its future.
    A request is never split: one that would overflow the group is put
    back to start the next.  An exception in ``generate`` (a CUDA error
    raised at a kernel's launch included) resolves every future of its
    group with it and counts in ``errors``; the dispatcher carries on,
    unless the service is broken (a ``TryOnService`` over ranks whose
    process group failed): then every queued request fails too and the
    batcher closes.
    """

    def __init__(self, service, *, max_delay_ms: float = 25.0):
        self.service = service
        self.max_delay = max_delay_ms / 1e3
        self._queue: queue.Queue = queue.Queue()
        self._closed = False
        # batch fill rate = samples_done / (batches_done * batch_size),
        # surfaced by /healthz
        self.requests_done = 0
        self.samples_done = 0
        self.batches_done = 0
        self.errors = 0
        self._dispatcher = threading.Thread(target=self._loop, daemon=True)
        self._dispatcher.start()

    def submit(self, request: dict) -> Future:
        """Queue one request; the future resolves to its float32 [0, 1]
        NHWC images."""
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        missing = [k for k in _REQUEST_KEYS if k not in request]
        if missing:
            raise ValueError(f"request missing arrays: {missing}")
        n = request["image"].shape[0]
        if not 1 <= n <= self.service.batch_size:
            raise ValueError(
                f"request size {n} outside [1, {self.service.batch_size}]")
        fut: Future = Future()
        self._queue.put((request, n, fut))
        return fut

    def close(self) -> None:
        """Drain outstanding requests and stop the dispatcher."""
        if not self._closed:
            self._closed = True
            self._queue.put(None)
            self._dispatcher.join()

    def _fail_queued(self, error: BaseException) -> None:
        """Close, and fail every request still queued with ``error``."""
        self._closed = True
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                item[2].set_exception(error)

    def _collect_group(self):
        """Block for the first request, then coalesce until the batch is
        full, the delay lapses, or the next request would overflow (it is
        put back for the next group)."""
        first = self._queue.get()
        if first is None:
            return None
        group, total = [first], first[1]
        deadline = time.monotonic() + self.max_delay
        while total < self.service.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                self._queue.put(None)  # keep the stop sentinel
                break
            if total + item[1] > self.service.batch_size:
                self._queue.put(item)  # it starts the next group
                break
            group.append(item)
            total += item[1]
        return group

    def _loop(self) -> None:
        while True:
            group = self._collect_group()
            if group is None:
                return
            arrays = {
                k: np.concatenate([np.asarray(req[k]) for req, _, _ in group])
                for k in _REQUEST_KEYS
            }
            try:
                out = self.service.generate(**arrays)
            except Exception as e:  # resolve every waiter, stay alive
                self.errors += 1
                for _, _, fut in group:
                    fut.set_exception(e)
                if getattr(self.service, "broken", None) is not None:
                    self._fail_queued(e)
                    return
                continue
            off = 0
            for _, n, fut in group:
                fut.set_result(out[off:off + n])
                off += n
            self.batches_done += 1
            self.requests_done += len(group)
            self.samples_done += off


# HTTP front end (stdlib only): POST /tryon with an .npz of the six
# sampler arrays -> .npz {"images": float32 [0, 1] NHWC}; POST /condition
# (with a ConditionService mounted) with an .npz of cloth, pose_map,
# im_mask, category -> .npz of warped_cloth and the prompt embeddings;
# GET /healthz.  Concurrent /tryon requests coalesce in the MicroBatcher.

def make_http_server(batcher: MicroBatcher, host: str = "127.0.0.1",
                     port: int = 8080, *, request_timeout_s: float = 600.0,
                     condition_service: Optional[ConditionService] = None
                     ) -> ThreadingHTTPServer:
    """Build (don't start) a ``ThreadingHTTPServer`` over ``batcher``.

    Call ``.serve_forever()`` or drive it from a thread;
    ``.server_address`` carries the bound (host, port): ``port=0`` picks
    a free one.
    """

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # no line per request
            pass

        def _reply(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj):
            self._reply(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path != "/healthz":
                return self._json(404, {"error": "unknown path"})
            svc = batcher.service
            self._json(200, {
                "status": "ok",
                "batch_size": getattr(svc, "batch_size", None),
                "height": getattr(svc, "height", None),
                "width": getattr(svc, "width", None),
                "queue_depth": batcher._queue.qsize(),
                "condition": condition_service is not None,
                "requests_done": batcher.requests_done,
                "samples_done": batcher.samples_done,
                "batches_done": batcher.batches_done,
                "errors": batcher.errors,
            })

        def _read_npz(self) -> dict:
            n = int(self.headers.get("Content-Length", "0"))
            payload = np.load(io.BytesIO(self.rfile.read(n)),
                              allow_pickle=False)
            return {k: payload[k] for k in payload.files}

        def _npz_reply(self, **arrays):
            buf = io.BytesIO()
            np.savez_compressed(buf, **arrays)
            self._reply(200, buf.getvalue(), "application/octet-stream")

        def do_POST(self):
            if self.path == "/tryon":
                return self._tryon()
            if self.path == "/condition" and condition_service is not None:
                return self._condition()
            return self._json(404, {"error": "unknown path"})

        def _tryon(self):
            try:
                request = self._read_npz()
            except Exception as e:
                return self._json(400, {"error": f"bad npz payload: {e}"})
            try:
                fut = batcher.submit(request)
            except (ValueError, RuntimeError) as e:
                return self._json(400, {"error": str(e)})
            try:
                images = fut.result(timeout=request_timeout_s)
            except Exception as e:
                return self._json(500, {"error": str(e)})
            self._npz_reply(images=images)

        def _condition(self):
            try:
                request = self._read_npz()
                cloth = request["cloth"]
                pose_map = request["pose_map"]
                im_mask = request["im_mask"]
                categories = [str(c) for c in request["category"]]
            except Exception as e:
                return self._json(400, {"error": f"bad npz payload: {e}"})
            try:
                warped, ehs, neg = condition_service.run(
                    cloth=cloth, pose_map=pose_map, im_mask=im_mask,
                    categories=categories)
            except (KeyError, ValueError) as e:
                return self._json(400, {"error": str(e)})
            except Exception as e:
                return self._json(500, {"error": str(e)})
            self._npz_reply(warped_cloth=warped, prompt_embeds=ehs,
                            negative_prompt_embeds=neg)

    return ThreadingHTTPServer((host, port), Handler)
