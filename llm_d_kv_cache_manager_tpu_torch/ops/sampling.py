"""Token sampling: greedy / temperature / top-k / top-p over a batch.

Sampling parameters are per-row tensors, so mixed strategies share one
call. Greedy and the top-k/top-p masks are exact ports of the JAX
package's; the categorical draw is a Gumbel-max over the filtered logits
with noise from an explicit ``torch.Generator`` — the same distribution as
``jax.random.categorical``, never the same bits. ``spec_sample`` extends
the same filtered distributions to speculative-decode verification with
deterministic drafts: accept draft ``d`` with probability ``P(d)``; on
rejection sample ``P`` with ``d`` removed.
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
    # A fill, not torch.tensor(...): no host-to-device copy, so the decode
    # burst that samples can be captured in a CUDA graph.
    neg_inf = torch.full((), float("-inf"), dtype=logits.dtype, device=logits.device)

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
    return torch.where(temperature > 0, _gumbel_argmax(masked, generator), greedy)


def _gumbel_argmax(masked: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of ``masked`` (Gumbel-max)."""
    u = torch.rand(
        masked.shape, generator=generator, device=masked.device, dtype=torch.float32
    )
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(masked + gumbel, dim=-1).to(torch.int32)


def spec_sample(
    logits: torch.Tensor,  # [batch, s, vocab] f32 — verify logits per position
    drafts: torch.Tensor,  # [batch, s] int32 — proposed token per position
    temperature: torch.Tensor,  # [batch] f32; 0 = greedy
    top_k: torch.Tensor,  # [batch] int32
    top_p: torch.Tensor,  # [batch] f32
    generator: torch.Generator,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Speculative verification for deterministic drafts (prompt-lookup
    proposals). Per position ``j`` with filtered target distribution
    ``P_j``:

    - ``accept[b, j]``: sampled lanes accept with probability
      ``P_j(draft)``, greedy lanes iff ``draft == argmax``;
    - ``replacement[b, j]``: the token emitted at the first rejection, a
      sample of ``P_j`` with the draft removed and renormalized (the
      ``(p - q)_+`` residual of a delta proposal); greedy lanes the argmax;
    - ``free[b, j]``: an unconditioned sample of ``P_j`` (the bonus token
      after every draft accepted); greedy lanes the argmax.

    Each lane's emitted stream is an exact sample of its filtered
    distribution. The draws are the JAX function's in distribution, never
    in bits."""
    b, s, vocab = logits.shape
    flat = logits.reshape(b * s, vocab)
    sampled = (temperature > 0).repeat_interleave(s)
    masked = _filtered_logits(
        flat,
        temperature.repeat_interleave(s),
        top_k.repeat_interleave(s),
        top_p.repeat_interleave(s),
    )
    greedy = torch.argmax(flat, dim=-1).to(torch.int32)
    d = drafts.reshape(-1).long()

    p_draft = torch.softmax(masked, dim=-1).gather(1, d[:, None])[:, 0]
    u = torch.rand(
        (b * s,), generator=generator, device=logits.device, dtype=torch.float32
    )
    accept = torch.where(sampled, u < p_draft, d == greedy)

    neg_inf = torch.full((), float("-inf"), dtype=masked.dtype, device=masked.device)
    masked_no_draft = masked.scatter(1, d[:, None], neg_inf.expand(b * s, 1))
    replacement = torch.where(sampled, _gumbel_argmax(masked_no_draft, generator), greedy)
    free = torch.where(sampled, _gumbel_argmax(masked, generator), greedy)
    return accept.reshape(b, s), replacement.reshape(b, s), free.reshape(b, s)
