"""Minimal stdlib client for the ``cli.serve`` HTTP endpoints.

The port's copy of ``ladi_vton_tpu/client.py``: the wire format is the
same, so it talks to either package's server.  It round-trips numpy
arrays through the ``.npz`` bodies of
``pipelines.serving.make_http_server``:

    client = TryOnClient("http://host:8080")
    cond = client.condition(cloth=..., pose_map=..., im_mask=...,
                            categories=["upper_body", ...])
    images = client.tryon(image=..., inpaint_mask=..., pose_map=...,
                          warped_cloth=cond["warped_cloth"],
                          prompt_embeds=cond["prompt_embeds"],
                          negative_prompt_embeds=cond[
                              "negative_prompt_embeds"])
"""

from __future__ import annotations

import io
import json
import urllib.error
import urllib.request

import numpy as np


class ServingError(RuntimeError):
    """Server answered with an error status; carries the JSON detail."""

    def __init__(self, code: int, detail: str):
        super().__init__(f"HTTP {code}: {detail}")
        self.code = code
        self.detail = detail


class TryOnClient:
    def __init__(self, base_url: str, *, timeout_s: float = 600.0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s

    def _post_npz(self, path: str, arrays: dict) -> dict:
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        req = urllib.request.Request(self.base_url + path,
                                     data=buf.getvalue(), method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                payload = np.load(io.BytesIO(r.read()), allow_pickle=False)
                return {k: payload[k] for k in payload.files}
        except urllib.error.HTTPError as e:
            try:
                detail = json.loads(e.read()).get("error", "")
            except Exception:
                detail = ""
            raise ServingError(e.code, detail) from None

    def healthz(self) -> dict:
        with urllib.request.urlopen(self.base_url + "/healthz",
                                    timeout=self.timeout_s) as r:
            return json.loads(r.read())

    def tryon(self, *, image, inpaint_mask, pose_map, warped_cloth,
              prompt_embeds, negative_prompt_embeds) -> np.ndarray:
        """Run the sampler; returns float32 [0,1] NHWC images."""
        out = self._post_npz("/tryon", {
            "image": image, "inpaint_mask": inpaint_mask,
            "pose_map": pose_map, "warped_cloth": warped_cloth,
            "prompt_embeds": prompt_embeds,
            "negative_prompt_embeds": negative_prompt_embeds,
        })
        return out["images"]

    def condition(self, *, cloth, pose_map, im_mask, categories) -> dict:
        """Run the conditioning stage (server must mount it with
        ``--enable_condition``); returns warped_cloth + prompt
        embeddings keyed like the /tryon inputs."""
        return self._post_npz("/condition", {
            "cloth": cloth, "pose_map": pose_map, "im_mask": im_mask,
            "category": np.asarray(categories),
        })
