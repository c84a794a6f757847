"""Prefill attention over [paged context ++ fresh causal chunk], plain
PyTorch.

This is the plain version of the flash-prefill kernel (``csrc/
flash_prefill.cu``) and the CPU path: it gathers the context pages the
block tables name, appends the chunk, and runs one masked float32 softmax
over that virtual key sequence. It is the oracle the kernel is held to on
the card; it makes no attempt to be fast.
"""

from __future__ import annotations

from typing import Optional

import torch

# Finite: a fully-masked score row gives exp(-1e30 - -1e30) = 1, zeroed by
# the mask multiply — float('-inf') would give inf - inf = NaN.
_NEG_INF = -1e30


def prefill_with_paged_context(
    q: torch.Tensor,  # [batch, seq, n_heads, head_dim] — the fresh chunk
    k: torch.Tensor,  # [batch, seq, n_kv_heads, head_dim]
    v: torch.Tensor,  # [batch, seq, n_kv_heads, head_dim]
    k_pages: torch.Tensor,  # [total_pages, page_size, n_kv_heads, head_dim]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [batch, max_ctx_pages] int32 (pad with 0)
    ctx_lens: torch.Tensor,  # [batch] int32 — tokens of cached context
    *,
    positions: torch.Tensor,  # [batch, seq] absolute positions of the chunk
    valid: Optional[torch.Tensor] = None,  # [batch, seq] padding mask
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Chunked prefill attending to prefix-cached pages *and* causally
    within the fresh chunk. Context tokens all precede the chunk, so they
    need only the ``ctx_lens`` mask. Returns [batch, seq, n_heads, head_dim]
    in ``q``'s dtype; fully masked query rows give zeros."""
    b, s, n_q, d = q.shape
    n_kv = k.shape[2]
    group = n_q // n_kv
    if scale is None:
        scale = d**-0.5
    max_ctx = block_tables.shape[1] * k_pages.shape[1]

    qf = q.float().reshape(b, s, n_kv, group, d)
    # Context K/V gathered per sequence: [b, max_ctx, n_kv, d].
    ctx_k = k_pages[block_tables.long()].reshape(b, max_ctx, n_kv, d)
    ctx_v = v_pages[block_tables.long()].reshape(b, max_ctx, n_kv, d)
    k_all = torch.cat([ctx_k, k], dim=1).float()  # [b, T, n_kv, d]
    v_all = torch.cat([ctx_v, v], dim=1).float()

    # Context keys sit at position -1 (visible to every query); chunk keys
    # follow causal position order.
    ar = torch.arange(max_ctx, device=q.device)
    ctx_valid = ar[None, :] < ctx_lens[:, None]
    chunk_valid = (
        valid if valid is not None
        else torch.ones((b, s), dtype=torch.bool, device=q.device)
    )
    k_valid = torch.cat([ctx_valid, chunk_valid], dim=1)  # [b, T]
    k_pos = torch.cat(
        [
            torch.full((b, max_ctx), -1, dtype=torch.int64, device=q.device),
            positions.long(),
        ],
        dim=1,
    )
    mask = k_valid[:, None, :] & (k_pos[:, None, :] <= positions.long()[:, :, None])
    mask = mask[:, :, None, None, :]  # [b, s, 1, 1, T]

    scores = torch.einsum("bqhgd,bthd->bqhgt", qf, k_all) * scale
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m) * mask
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bqhgt,bthd->bqhgd", p, v_all)
    out = out / torch.where(denom > 0, denom, torch.ones_like(denom))
    return out.reshape(b, s, n_q, d).to(q.dtype)
