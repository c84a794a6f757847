"""The work a step's inputs need, counted from shapes, and the card's peaks.

Peaks are NVIDIA's published figures for one H100 SXM (dense bf16, HBM3);
``bound_s`` is the least time the card could take, the larger of the
operations over the compute peak and the bytes over the memory peak (the
arithmetic of ``chip_smoke.bound_ms``). Work is what the inputs need:
each lane's context, each prefill row's chunk and context, the model's
active parameters. It does not count what a kernel happens to do (padding,
re-reads), so a kernel that replaces another is counted the same.
"""

from __future__ import annotations

from .model import Dims

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12


def bound_s(n_bytes: float, flops: float) -> float:
    return max(n_bytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS)


def attn_params(m: Dims) -> int:
    """q, k, v and output projections of one layer."""
    return m.d * (m.heads + 2 * m.kv_heads) * m.hd + m.heads * m.hd * m.d


def ffn_active_params(m: Dims) -> int:
    """FFN parameters one token multiplies by in one layer: the router and
    ``top_k`` experts of an MoE, or the whole dense FFN."""
    if m.experts:
        return m.d * m.experts + m.top_k * 3 * m.d * m.moe_inter
    return 3 * m.d * m.inter


def body_params(m: Dims) -> int:
    """Active parameters a token passes through below the head."""
    return m.layers * (attn_params(m) + ffn_active_params(m))


def attn_flops(m: Dims, queries: int, ctx_before: int) -> float:
    """QK^T and PV of ``queries`` consecutive tokens over ``ctx_before``
    earlier tokens plus themselves (causal), one layer, all heads."""
    keys = queries * ctx_before + queries * (queries + 1) / 2
    return 4.0 * m.heads * m.hd * keys


def decode_flops(m: Dims, ctx: int) -> float:
    """One lane's model step at context ``ctx`` (the current token
    included): the body, attention over the context and the head."""
    return 2.0 * (body_params(m) + m.d * m.vocab) + m.layers * attn_flops(m, 1, ctx - 1)


def prefill_flops(m: Dims, chunk: int, ctx: int) -> float:
    """One prefill row: ``chunk`` new tokens over ``ctx`` cached ones; the
    head runs for the sampled (last) position only."""
    return (2.0 * body_params(m) * chunk + 2.0 * m.d * m.vocab
            + m.layers * attn_flops(m, chunk, ctx))
