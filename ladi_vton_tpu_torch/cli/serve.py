"""Serve the port's try-on sampler over HTTP.

    python -m ladi_vton_tpu_torch.cli.serve --dataset vitonhd \\
        --checkpoint_dir <dir of the .pth releases> --sd2_model_dir <dir> \\
        --enable_condition --clip_vision_dir <dir> --port 8080

Counterpart of ``ladi_vton_tpu/cli/serve.py``, with every flag of it and
``--device``.  Endpoints (``pipelines.serving.make_http_server``):

* ``POST /tryon``: an ``.npz`` body with ``image``, ``inpaint_mask``,
  ``pose_map``, ``warped_cloth``, ``prompt_embeds``,
  ``negative_prompt_embeds`` (each with a leading sample axis,
  ``1 <= n <= --batch_size``) -> an ``.npz`` ``{"images"}``, float32
  [0, 1] NHWC.  Concurrent requests coalesce in the ``MicroBatcher``
  (deadline ``--max_delay_ms``) into one ``TryOnService.generate``.
* ``POST /condition`` with ``--enable_condition``: ``cloth``,
  ``pose_map``, ``im_mask`` and ``category`` -> ``warped_cloth``,
  ``prompt_embeds`` and ``negative_prompt_embeds``, ready for /tryon
  (the ``Conditioner`` of the mains, the port's CLIP tokenizer).
* ``GET /healthz``: JSON status, geometry, queue depth and counters.

Weights load through the port's zoo onto ``--device`` (``cuda`` by
default; asking for it where there is no card raises before any work, as
does ``--tensor_parallel`` above 1: serving stays one process until rank
0's server broadcasts each batch to follower ranks, ROADMAP.md's first
"Next PRs" item).  The bound address is printed on one
line (``--port 0`` picks a free port); SIGINT shuts the server and the
batcher down and the process exits 0.  ``--no_warmup`` skips the
full-batch request made before serving.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ladi_vton_tpu_torch.cli.inference import SCHEDULERS
from ladi_vton_tpu_torch.core.dtypes import default_policy, resolve_device
from ladi_vton_tpu_torch.diffusion.schedulers import make_scheduler
from ladi_vton_tpu_torch.hub import zoo
from ladi_vton_tpu_torch.pipelines.condition import Conditioner
from ladi_vton_tpu_torch.pipelines.serving import (
    ConditionService,
    MicroBatcher,
    TryOnService,
    make_http_server,
)
from ladi_vton_tpu_torch.pipelines.tryon import TryOnPipeline
from ladi_vton_tpu_torch.utils.tokenizer import CLIPTokenizer


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", choices=["dresscode", "vitonhd"],
                    required=True, help="which released checkpoint family")
    ap.add_argument("--checkpoint_dir", type=str, default=None,
                    help="dir with the LaDI-VTON .pth releases")
    ap.add_argument("--sd2_model_dir", type=str, required=True,
                    help="stable-diffusion-2-inpainting weights dir")
    ap.add_argument("--host", type=str, default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--batch_size", type=int, default=8,
                    help="the service's fixed batch: requests are padded "
                         "to it")
    ap.add_argument("--max_delay_ms", type=float, default=25.0,
                    help="micro-batching deadline after the first "
                         "queued request")
    ap.add_argument("--num_inference_steps", type=int, default=50)
    ap.add_argument("--scheduler", type=str, default="ddim",
                    choices=SCHEDULERS,
                    help="Sampler; 'dpm' (DPM-Solver++ 2M) pairs with "
                         "--num_inference_steps 20.")
    ap.add_argument("--guidance_scale", type=float, default=7.5)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=384)
    ap.add_argument("--mixed_precision", type=str, default="bf16",
                    choices=["no", "fp16", "bf16"])
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--no_warmup", action="store_true",
                    help="skip the full-batch request made before serving")
    ap.add_argument("--enable_condition", action="store_true",
                    help="also mount POST /condition (TPS warp + "
                         "refinement + CLIP/PTE text encoding); needs "
                         "--clip_vision_dir")
    ap.add_argument("--clip_vision_dir", type=str, default=None,
                    help="Local CLIP-ViT-H-14 model directory "
                         "(for --enable_condition)")
    ap.add_argument("--tokenizer_dir", type=str, default=None,
                    help="vocab.json+merges.txt dir (defaults to "
                         "<sd2_model_dir>/tokenizer)")
    ap.add_argument("--num_vstar", type=int, default=16)
    ap.add_argument("--tensor_parallel", type=int, default=1,
                    help="Only 1: serving under the mesh is not ported "
                         "yet.")
    ap.add_argument("--device", type=str, default="cuda",
                    help="Where the models run: cuda (default) or cpu.")
    return ap.parse_args(argv)


def check_args(args) -> torch.device:
    """Refuse what the port cannot do, before any work; the device."""
    if args.tensor_parallel != 1:
        raise NotImplementedError(
            f"--tensor_parallel {args.tensor_parallel}: serving under the "
            f"mesh (rank 0's server broadcasting each batch to its "
            f"followers) is not ported yet: ROADMAP.md P12, Next PRs "
            f"item 1")
    if args.enable_condition and not args.clip_vision_dir:
        raise ValueError("--enable_condition needs --clip_vision_dir")
    return resolve_device(args.device)


def build_services(args, device: torch.device):
    """(TryOnService, ConditionService or None) from the zoo."""
    dtype = default_policy(args.mixed_precision)
    on = dict(dtype=dtype, device=device)
    ckpt = dict(checkpoint_dir=args.checkpoint_dir)
    pipe = TryOnPipeline(
        unet=zoo.extended_unet(args.dataset, **ckpt, **on),
        vae=zoo.sd2_vae(args.sd2_model_dir, **on),
        emasc=zoo.emasc(args.dataset, **ckpt, **on),
        scheduler=make_scheduler(args.scheduler))
    service = TryOnService(
        pipe, batch_size=args.batch_size, height=args.height,
        width=args.width, num_inference_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale,
        context_dim=pipe.unet.config.cross_attention_dim, seed=args.seed)
    if not args.enable_condition:
        return service, None
    tokenizer = CLIPTokenizer.from_dir(
        Path(args.tokenizer_dir or Path(args.sd2_model_dir) / "tokenizer"))
    empty_ids = torch.from_numpy(
        np.asarray(tokenizer([""]))[0].astype(np.int64))
    tps, refinement = zoo.warping_module(args.dataset, device=device, **ckpt)
    cond = Conditioner(
        tps=tps, refinement=refinement,
        vision=zoo.clip_vit_h_vision(args.clip_vision_dir, **on),
        adapter=zoo.inversion_adapter(args.dataset, **ckpt, **on),
        text_model=zoo.sd2_text_encoder(args.sd2_model_dir, **on),
        num_vstar=args.num_vstar, empty_ids=empty_ids.to(device),
        image_size=(args.height, args.width))
    return service, ConditionService(
        cond, tokenizer, batch_size=args.batch_size,
        num_vstar=args.num_vstar, device=device)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = check_args(args)
    service, condition_service = build_services(args, device)
    if not args.no_warmup:
        print("warming up (one full-batch request)...", flush=True)
        service.warmup()
    batcher = MicroBatcher(service, max_delay_ms=args.max_delay_ms)
    server = make_http_server(batcher, host=args.host, port=args.port,
                              condition_service=condition_service)
    host, port = server.server_address[:2]
    print(f"serving try-on on http://{host}:{port} "
          f"(batch {args.batch_size}, {args.num_inference_steps} steps, "
          f"{device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        batcher.close()


if __name__ == "__main__":
    main()
