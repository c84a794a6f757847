"""Token sampling: greedy / temperature / top-k / top-p over a batch.

Sampling parameters are per-row tensors, so mixed strategies share one
call. Greedy and the top-k/top-p masks are exact ports of the JAX
package's; the categorical draw is a Gumbel-max over the filtered logits
with noise from an explicit ``torch.Generator`` — the same distribution as
``jax.random.categorical``, never the same bits.
"""

from __future__ import annotations

import torch


def _filtered_logits(
    logits: torch.Tensor,  # [rows, vocab] f32
    temperature: torch.Tensor,  # [rows] f32; 0 = greedy (filter inert)
    top_k: torch.Tensor,  # [rows] int32; 0 = disabled
    top_p: torch.Tensor,  # [rows] f32; 1 = disabled
) -> torch.Tensor:
    """Temperature-scaled logits with top-k/top-p masking (-inf off-support)."""
    vocab = logits.shape[-1]
    neg_inf = torch.tensor(float("-inf"), dtype=logits.dtype, device=logits.device)

    # Temperature scaling (guard 0 for the greedy lanes).
    safe_t = torch.where(temperature > 0, temperature, torch.ones_like(temperature))[:, None]
    scaled = logits / safe_t

    # Top-k mask: keep the k highest logits per row.
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k, torch.full_like(top_k, vocab)).long()
    kth_val = torch.gather(sorted_desc, 1, (k - 1).clamp(0, vocab - 1)[:, None])
    masked = torch.where(scaled >= kth_val, scaled, neg_inf)

    # Top-p (nucleus) on the surviving distribution.
    sorted_masked = torch.sort(masked, dim=-1, descending=True).values
    probs_sorted = torch.softmax(sorted_masked, dim=-1)
    cumprobs = torch.cumsum(probs_sorted, dim=-1)
    # keep tokens while cumulative prob (exclusive) < top_p
    cutoff_mask = (cumprobs - probs_sorted) < top_p[:, None]
    threshold = torch.where(
        cutoff_mask, sorted_masked, torch.full_like(sorted_masked, float("inf"))
    ).amin(dim=-1, keepdim=True)
    return torch.where(masked >= threshold, masked, neg_inf)


def sample_tokens(
    logits: torch.Tensor,  # [batch, vocab] f32
    temperature: torch.Tensor,  # [batch] f32; 0 = greedy
    top_k: torch.Tensor,  # [batch] int32; 0 = disabled
    top_p: torch.Tensor,  # [batch] f32; 1 = disabled
    generator: torch.Generator,
) -> torch.Tensor:
    """Returns sampled token ids [batch] int32."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    masked = _filtered_logits(logits, temperature, top_k, top_p)
    u = torch.rand(
        masked.shape, generator=generator, device=masked.device, dtype=torch.float32
    )
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    sampled = torch.argmax(masked + gumbel, dim=-1).to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy)
