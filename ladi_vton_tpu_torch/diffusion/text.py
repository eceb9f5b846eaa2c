"""CLIP text encoding with pseudo-token-embedding (PTE) injection.

Counterpart of ``ladi_vton_tpu/diffusion/text.py``: the prompt holds
``num_vstar`` consecutive ``$`` tokens (CLIP vocabulary id 259); the
token embeddings of the first ``$`` run are replaced by the inversion
adapter's embeddings before the causal encoder runs.  The JAX package
blends with a one-hot product to stay free of dynamic shapes; here each
position gathers its pseudo-word (the index clamped into the run) and a
``torch.where`` selects it inside the run.  The shapes depend on none of
the ids' values and nothing waits for the device, so a CUDA graph
captures it (a boolean-mask index write is a ``nonzero``, which
synchronises with the host); a select copies values, so the result is
the JAX splice's for finite inputs, and gradients reach both the prompt
embeddings and the pseudo-words.
"""

from __future__ import annotations

import torch

VSTAR_TOKEN_ID = 259  # '$' in the CLIP BPE vocabulary


def splice_word_embeddings(input_embeds: torch.Tensor,
                           input_ids: torch.Tensor,
                           word_embeddings: torch.Tensor,
                           num_vstar: int) -> torch.Tensor:
    """Replace the first run of ``$`` embeddings with ``word_embeddings``.

    input_embeds: (B, S, D); input_ids: (B, S); word_embeddings:
    (B, num_vstar, D) or (B, num_vstar * D).  A sequence without ``$``
    passes untouched; positions of the run past S are dropped.
    """
    B, S, D = input_embeds.shape
    ptes = word_embeddings.reshape(B, num_vstar, D).to(input_embeds.dtype)
    is_vstar = input_ids == VSTAR_TOKEN_ID
    has_vstar = is_vstar.any(dim=1)                                # (B,)
    first = is_vstar.int().argmax(dim=1)                           # (B,)
    # position s holds pseudo-word s - first where that is in [0, V)
    src = (torch.arange(S, device=input_ids.device)[None, :]
           - first[:, None])                                       # (B, S)
    inside = has_vstar[:, None] & (src >= 0) & (src < num_vstar)
    index = src.clamp(0, num_vstar - 1)[:, :, None].expand(B, S, D)
    return torch.where(inside[:, :, None], torch.gather(ptes, 1, index),
                       input_embeds)


def encode_text_word_embedding(text_model, input_ids: torch.Tensor,
                               word_embeddings: torch.Tensor,
                               num_vstar: int = 16):
    """Full PTE-injected CLIP text forward through a ``CLIPTextModel``.

    Returns (last_hidden_state, pooled_output)."""
    embeds = splice_word_embeddings(text_model.embed(input_ids), input_ids,
                                    word_embeddings, num_vstar)
    return text_model.forward_embeds(embeds, input_ids)
