"""CLIP text encoding with pseudo-token-embedding (PTE) injection.

Counterpart of ``ladi_vton_tpu/diffusion/text.py``: the prompt holds
``num_vstar`` consecutive ``$`` tokens (CLIP vocabulary id 259); the
token embeddings of the first ``$`` run are replaced by the inversion
adapter's embeddings before the causal encoder runs.  The JAX package
blends with a one-hot product to stay free of dynamic shapes; here the
same replacement is an index-based write.
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
    targets = first[:, None] + torch.arange(num_vstar,
                                            device=input_ids.device)
    keep = has_vstar[:, None] & (targets < S)                      # (B, V)
    rows = torch.arange(B, device=input_ids.device)[:, None].expand_as(
        targets)
    out = input_embeds.clone()
    out[rows[keep], targets[keep]] = ptes[keep]
    return out


def encode_text_word_embedding(text_model, input_ids: torch.Tensor,
                               word_embeddings: torch.Tensor,
                               num_vstar: int = 16):
    """Full PTE-injected CLIP text forward through a ``CLIPTextModel``.

    Returns (last_hidden_state, pooled_output)."""
    embeds = splice_word_embeddings(text_model.embed(input_ids), input_ids,
                                    word_embeddings, num_vstar)
    return text_model.forward_embeds(embeds, input_ids)
