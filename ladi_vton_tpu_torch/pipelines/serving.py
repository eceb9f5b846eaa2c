"""Serving wrappers around the conditioning stage and the try-on pipeline.

Counterparts of ``ladi_vton_tpu/pipelines/serving.py`` ``TryOnService``
(without a mesh), ``ConditionService``, ``MicroBatcher`` and
``make_http_server``.  Requests of up to
``batch_size`` images are padded to the fixed batch (repeating the last
sample), run, and returned unpadded as float32 numpy arrays.  A raw
try-on request goes through both: ``ConditionService.run`` turns cloth,
pose, masked person and category into warped cloth and prompt
embeddings, which ``TryOnService.generate`` takes with the person image
and inpainting mask.  The try-on runs under whichever scheduler its
pipeline holds (``diffusion.schedulers.make_scheduler``); the prompts
are tokenized by the caller's tokenizer, the port's
``utils.tokenizer.CLIPTokenizer`` for the SD-2 vocabulary.  Each try-on
request without an explicit generator gets its own, seeded from (seed,
request count) in place of the JAX ``fold_in``.

The HTTP front end is the JAX package's, path for path and byte for
byte (``.npz`` bodies, the same status codes and ``/healthz`` keys), so
either package's client talks to either package's server.  Its handler
threads run ``ConditionService.run`` while the batcher's dispatcher
thread runs ``TryOnService.generate``: both hold ``torch.no_grad()``
themselves (grad mode is per thread) and launch on the current stream.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ladi_vton_tpu_torch.core.rng import request_seed
from ladi_vton_tpu_torch.data.labels import CATEGORY_PROMPT_TEXT
from ladi_vton_tpu_torch.pipelines.condition import Conditioner
from ladi_vton_tpu_torch.pipelines.tryon import TryOnPipeline


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


class TryOnService:
    def __init__(self, pipe: TryOnPipeline, *, batch_size: int = 8,
                 height: int = 512, width: int = 384,
                 num_inference_steps: int = 50, guidance_scale: float = 7.5,
                 context_dim: int = 1024, seed: int = 0):
        self.pipe = pipe
        self.batch_size = batch_size
        self.height = height
        self.width = width
        self.num_inference_steps = num_inference_steps
        self.guidance_scale = guidance_scale
        self.context_dim = context_dim
        self.seed = seed
        self._count = 0
        self._lock = threading.Lock()

    def warmup(self) -> None:
        """Run one full-batch request ahead of the first real one."""
        b, h, w = self.batch_size, self.height, self.width
        z = np.zeros((b, h, w, 3), np.float32)
        self.generate(
            image=z, inpaint_mask=np.ones((b, h, w, 1), np.float32),
            pose_map=np.zeros((b, h, w, 18), np.float32), warped_cloth=z,
            prompt_embeds=np.zeros((b, 77, self.context_dim), np.float32),
            negative_prompt_embeds=np.zeros((b, 77, self.context_dim),
                                            np.float32))

    def _pad(self, x: np.ndarray) -> torch.Tensor:
        x = pad_batch(np.asarray(x, np.float32), self.batch_size)
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.pipe.device)

    @torch.no_grad()
    def generate(self, *, image, inpaint_mask, pose_map, warped_cloth,
                 prompt_embeds, negative_prompt_embeds,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Run one request (<= batch_size). Returns float32 NHWC images in
        [0, 1], unpadded."""
        n = image.shape[0]
        with self._lock:
            if generator is None:
                generator = torch.Generator(self.pipe.device).manual_seed(
                    request_seed(self.seed, self._count))
                self._count += 1
            out = self.pipe.sample(
                image=self._pad(image), mask_image=self._pad(inpaint_mask),
                pose_map=self._pad(pose_map),
                warped_cloth=self._pad(warped_cloth),
                prompt_embeds=self._pad(prompt_embeds),
                negative_prompt_embeds=self._pad(negative_prompt_embeds),
                generator=generator,
                num_inference_steps=self.num_inference_steps,
                guidance_scale=self.guidance_scale)
        return out[:n].cpu().numpy()


class ConditionService:
    """In-shop cloth + pose + masked person + category strings ->
    warped cloth and prompt embeddings, ready for ``TryOnService``.

    ``tokenizer`` maps a list of prompts to (n, S) token ids, as the CLIP
    tokenizer does (S = 77 for SD-2).  The conditioner's towers are
    placed on ``device``."""

    def __init__(self, conditioner: Conditioner, tokenizer, *,
                 batch_size: int = 8, num_vstar: int = 16,
                 device: str = "cuda"):
        self.conditioner = conditioner.to(device)
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.num_vstar = num_vstar
        self._lock = threading.Lock()

    def prompts(self, categories) -> list[str]:
        return category_prompts(categories, self.num_vstar)

    def _pad(self, x, dtype) -> torch.Tensor:
        x = pad_batch(np.asarray(x, dtype), self.batch_size)
        return torch.from_numpy(np.ascontiguousarray(x))

    @torch.no_grad()
    def run(self, *, cloth, pose_map, im_mask, categories):
        """Returns float32 (warped_cloth, prompt_embeds,
        negative_prompt_embeds), unpadded to the request's n samples."""
        n = cloth.shape[0]
        input_ids = np.asarray(self.tokenizer(self.prompts(categories)))
        with self._lock:
            out = self.conditioner(
                self._pad(pose_map, np.float32), self._pad(cloth, np.float32),
                self._pad(im_mask, np.float32),
                self._pad(input_ids, np.int64))
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
    group with it and counts in ``errors``; the dispatcher carries on.
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
