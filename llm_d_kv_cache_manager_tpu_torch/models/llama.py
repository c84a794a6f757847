"""Llama-family dense decoder in PyTorch with a paged KV cache — the port of
the JAX package's ``models/llama.py`` (dense subset).

- Parameters are a plain dict with the JAX pytree's keys (``embed``,
  ``final_norm``, ``layers[i].{attn_norm, wq, wk, wv, wo, mlp_norm,
  w_gate, w_up, w_down}``, ``lm_head``) and its ``[in, out]`` layout, so
  a JAX tree converts leaf by leaf (``models/convert.py``).
- KV pools are ``[n_layers, total_pages, page_size, n_kv_heads, head_dim]``.
  JAX donates them to each call and gets new arrays back; here they are
  updated in place (``index_put_``) and returned for the same call shape.
- Attention runs through ``ops.flash_prefill_paged`` (prefill) and
  ``ops.paged_attention`` (decode): the Hopper kernels for CUDA tensors,
  their plain versions for CPU tensors. Matrix products go to
  ``torch.matmul``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..ops import (
    apply_rope,
    flash_prefill_paged,
    paged_attention,
    rms_norm,
    rope_frequencies,
    sample_tokens,
)
from ..ops.rope import RopeScalingConfig

Params = dict[str, Any]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    hidden_size: int = 4096
    intermediate_size: int = 14_336
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: Optional[int] = None  # defaults to hidden_size // n_heads
    rope_theta: float = 500_000.0
    rope_scaling: Optional[RopeScalingConfig] = None
    rms_norm_eps: float = 1e-5
    qkv_bias: bool = False  # Qwen2-style
    qk_norm: bool = False  # Qwen3-style per-head RMSNorm on q/k before RoPE
    tie_word_embeddings: bool = False
    # Gemma-style variations: gated-GELU FFN ("gelu_tanh"), (1+w) RMSNorm
    # scaling (norm_offset=1.0), embeddings scaled by sqrt(hidden_size).
    hidden_act: str = "silu"
    norm_offset: float = 0.0
    scale_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.n_heads

    def act_fn(self, x: torch.Tensor) -> torch.Tensor:
        if self.hidden_act == "silu":
            return F.silu(x)
        if self.hidden_act in ("gelu_tanh", "gelu_pytorch_tanh"):
            return F.gelu(x, approximate="tanh")
        if self.hidden_act == "gelu":
            return F.gelu(x)
        raise ValueError(f"unsupported hidden_act {self.hidden_act!r}")


#: Flagship config (meta-llama/Llama-3.1-8B, incl. its llama3 rope scaling).
LLAMA_3_8B = LlamaConfig(rope_scaling=RopeScalingConfig())

#: Tiny config for tests / CPU dry-runs.
TINY_LLAMA = LlamaConfig(
    vocab_size=256,
    hidden_size=64,
    intermediate_size=128,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    rope_theta=10_000.0,
    dtype=torch.float32,
)

#: Tiny Gemma-shaped config for tests / CPU dry-runs.
TINY_GEMMA = LlamaConfig(
    vocab_size=256,
    hidden_size=64,
    intermediate_size=128,
    n_layers=2,
    n_heads=4,
    n_kv_heads=4,
    head_dim=24,
    rope_theta=10_000.0,
    rms_norm_eps=1e-6,
    tie_word_embeddings=True,
    hidden_act="gelu_tanh",
    norm_offset=1.0,
    scale_embeddings=True,
    dtype=torch.float32,
)


def init_params(
    cfg: LlamaConfig, generator: torch.Generator, device: torch.device | str
) -> Params:
    """Random-init parameters on ``device``: every matrix is
    ``normal * fan_in**-0.5`` in float32, cast to ``cfg.dtype`` (the JAX
    package's init), drawn from ``generator`` (which must live on
    ``device``) in a fixed order."""
    d, hd = cfg.hidden_size, cfg.hd
    n_q, n_kv, inter = cfg.n_heads, cfg.n_kv_heads, cfg.intermediate_size

    def dense(shape, scale_dim):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * scale_dim**-0.5).to(cfg.dtype)

    # Gemma's (1+w) convention stores w≈0 for an identity norm.
    def norm_init(shape):
        fill = torch.zeros if cfg.norm_offset else torch.ones
        return fill(shape, dtype=cfg.dtype, device=device)

    layers = []
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": norm_init((d,)),
            "wq": dense((d, n_q * hd), d),
            "wk": dense((d, n_kv * hd), d),
            "wv": dense((d, n_kv * hd), d),
            "wo": dense((n_q * hd, d), n_q * hd),
            "mlp_norm": norm_init((d,)),
            "w_gate": dense((d, inter), d),
            "w_up": dense((d, inter), d),
            "w_down": dense((inter, d), inter),
        }
        if cfg.qkv_bias:
            layer["bq"] = torch.zeros((n_q * hd,), dtype=cfg.dtype, device=device)
            layer["bk"] = torch.zeros((n_kv * hd,), dtype=cfg.dtype, device=device)
            layer["bv"] = torch.zeros((n_kv * hd,), dtype=cfg.dtype, device=device)
        if cfg.qk_norm:
            layer["q_norm"] = norm_init((hd,))
            layer["k_norm"] = norm_init((hd,))
        layers.append(layer)

    params: Params = {
        "embed": dense((cfg.vocab_size, d), d),
        "final_norm": norm_init((d,)),
        "layers": layers,
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense((d, cfg.vocab_size), d)
    return params


def init_kv_pages(
    cfg: LlamaConfig, total_pages: int, page_size: int, device: torch.device | str
) -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroed K and V page pools:
    ``[n_layers, total_pages, page_size, n_kv_heads, head_dim]``."""
    shape = (cfg.n_layers, total_pages, page_size, cfg.n_kv_heads, cfg.hd)
    return (
        torch.zeros(shape, dtype=cfg.dtype, device=device),
        torch.zeros(shape, dtype=cfg.dtype, device=device),
    )


def _inv_freq(cfg: LlamaConfig, device) -> torch.Tensor:
    return torch.from_numpy(
        rope_frequencies(cfg.hd, cfg.rope_theta, cfg.rope_scaling)
    ).to(device)


def _qkv(layer: Params, cfg: LlamaConfig, x: torch.Tensor):
    b, s, d = x.shape
    q = x @ layer["wq"]
    k = x @ layer["wk"]
    v = x @ layer["wv"]
    if cfg.qkv_bias:
        q = q + layer["bq"]
        k = k + layer["bk"]
        v = v + layer["bv"]
    q = q.reshape(b, s, cfg.n_heads, cfg.hd)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = rms_norm(q, layer["q_norm"], cfg.rms_norm_eps, cfg.norm_offset)
        k = rms_norm(k, layer["k_norm"], cfg.rms_norm_eps, cfg.norm_offset)
    return q, k, v


def _mlp(layer: Params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    # Activation in float32, as the JAX package computes it.
    gate = cfg.act_fn((x @ layer["w_gate"]).float())
    up = (x @ layer["w_up"]).float()
    return (gate * up).to(x.dtype) @ layer["w_down"]


def _embed(params: Params, cfg: LlamaConfig, tokens: torch.Tensor) -> torch.Tensor:
    h = params["embed"][tokens.long()]
    if cfg.scale_embeddings:  # Gemma: normalizer folded out of the table
        h = h * torch.tensor(cfg.hidden_size**0.5, dtype=h.dtype, device=h.device)
    return h


def _logits(params: Params, cfg: LlamaConfig, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps, cfg.norm_offset)
    head = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    return (h @ head).float()


def _scatter_kv_pages_all_layers(
    pages: torch.Tensor,  # [n_layers, total_pages, page_size, n_kv, hd]
    fresh: torch.Tensor,  # [n_layers, b, s, n_kv, hd]
    page_ids: torch.Tensor,  # [b, s]
    slot_ids: torch.Tensor,  # [b, s]
    valid: Optional[torch.Tensor],  # [b, s] bool; None = every row
) -> torch.Tensor:
    """Write every layer's fresh K or V into the pool with one in-place
    update. The JAX version redirects invalid rows out of range and drops
    them; torch has no drop mode, so only the valid rows are indexed."""
    L, _, _, n_kv, hd = pages.shape
    pidx = page_ids.reshape(-1).long()
    sidx = slot_ids.reshape(-1).long()
    updates = fresh.reshape(L, -1, n_kv, hd).to(pages.dtype)
    if valid is not None:
        keep = valid.reshape(-1).nonzero().squeeze(1)
        pidx, sidx, updates = pidx[keep], sidx[keep], updates[:, keep]
    pages[:, pidx, sidx] = updates
    return pages


def prefill(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [b, s] int32, right-padded
    positions: torch.Tensor,  # [b, s] int32 absolute positions
    valid: torch.Tensor,  # [b, s] bool, right-padded prefix mask
    k_pages: torch.Tensor,  # [n_layers, pages, page_size, n_kv, hd]
    v_pages: torch.Tensor,
    page_ids: torch.Tensor,  # [b, s] destination page per token
    slot_ids: torch.Tensor,  # [b, s] destination slot per token
    block_tables: torch.Tensor,  # [b, max_ctx_pages] int32 — cached-context pages
    ctx_lens: torch.Tensor,  # [b] int32 — prefix-cached context length
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Process a prompt chunk: returns (logits at the last valid position
    per sequence [b, vocab] f32, k_pages, v_pages), the pools written in
    place. The chunk attends causally within itself and to ``ctx_lens``
    tokens of context already in the pool.

    Contract (the engine's): chunk positions are consecutive from
    ``ctx_lens`` and ``valid`` is a right-padded prefix mask; attention
    sees only the per-row count of valid tokens."""
    inv_freq = _inv_freq(cfg, tokens.device)
    h = _embed(params, cfg, tokens)  # [b, s, d]
    n_valid = valid.sum(dim=1, dtype=torch.int32)
    b, s = tokens.shape
    fresh_k, fresh_v = [], []
    for li, layer in enumerate(params["layers"]):
        x = rms_norm(h, layer["attn_norm"], cfg.rms_norm_eps, cfg.norm_offset)
        q, k, v = _qkv(layer, cfg, x)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
        attn = flash_prefill_paged(
            q, k, v, k_pages[li], v_pages[li], block_tables, ctx_lens, n_valid
        )
        h = h + attn.reshape(b, s, -1) @ layer["wo"]
        x = rms_norm(h, layer["mlp_norm"], cfg.rms_norm_eps, cfg.norm_offset)
        h = h + _mlp(layer, cfg, x)
        fresh_k.append(k)
        fresh_v.append(v)
    # In-chunk attention never reads the chunk's own pages (its K/V ride
    # the arguments), so every layer's write is deferred to one update.
    _scatter_kv_pages_all_layers(k_pages, torch.stack(fresh_k), page_ids, slot_ids, valid)
    _scatter_kv_pages_all_layers(v_pages, torch.stack(fresh_v), page_ids, slot_ids, valid)
    last_idx = (n_valid.long() - 1).clamp(min=0)
    h_last = h[torch.arange(b, device=h.device), last_idx]  # [b, d]
    return _logits(params, cfg, h_last[:, None, :])[:, 0], k_pages, v_pages


def _decode_body(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [b] int32 — last sampled token per sequence
    positions: torch.Tensor,  # [b] int32 — position of this token
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [b, max_pages] int32
    seq_lens: torch.Tensor,  # [b] int32 — context length INCLUDING this token
    page_size: int,
) -> torch.Tensor:
    """One decode step: attention over the pages plus the current token,
    then this token's K/V written into its page slot (in place). Returns
    logits [b, vocab] f32."""
    inv_freq = _inv_freq(cfg, tokens.device)
    b = tokens.shape[0]
    h = _embed(params, cfg, tokens)[:, None, :]  # [b, 1, d]
    pos = positions.long()
    my_page = torch.gather(block_tables.long(), 1, (pos // page_size)[:, None])
    my_slot = (pos % page_size)[:, None]
    fresh_k, fresh_v = [], []
    for li, layer in enumerate(params["layers"]):
        x = rms_norm(h, layer["attn_norm"], cfg.rms_norm_eps, cfg.norm_offset)
        q, k, v = _qkv(layer, cfg, x)
        q = apply_rope(q, positions[:, None], inv_freq)
        k = apply_rope(k, positions[:, None], inv_freq)
        # The pages hold only history; this token's K/V ride the call, so
        # the pool write happens once for all layers after the loop.
        attn = paged_attention(
            q[:, 0], k_pages, v_pages, block_tables, seq_lens, k[:, 0], v[:, 0],
            layer=li,
        )  # [b, n_heads, hd]
        h = h + (attn.reshape(b, -1) @ layer["wo"])[:, None, :]
        x = rms_norm(h, layer["mlp_norm"], cfg.rms_norm_eps, cfg.norm_offset)
        h = h + _mlp(layer, cfg, x)
        fresh_k.append(k)
        fresh_v.append(v)
    _scatter_kv_pages_all_layers(k_pages, torch.stack(fresh_k), my_page, my_slot, None)
    _scatter_kv_pages_all_layers(v_pages, torch.stack(fresh_v), my_page, my_slot, None)
    return _logits(params, cfg, h)[:, 0]


def decode_step(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    *,
    page_size: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step; returns (logits [b, vocab] f32, k_pages, v_pages),
    the pools written in place. Sampling stays with the caller."""
    logits = _decode_body(
        params, cfg, tokens, positions, k_pages, v_pages, block_tables,
        seq_lens, page_size,
    )
    return logits, k_pages, v_pages


def decode_steps(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [b] int32 — last sampled token per sequence
    positions: torch.Tensor,  # [b] int32 — position of `tokens`
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [b, max_pages] int32 (covers num_steps growth)
    seq_lens: torch.Tensor,  # [b] int32 — context length INCLUDING `tokens`
    temperature: torch.Tensor,  # [b] f32; 0 = greedy
    top_k: torch.Tensor,  # [b] int32; 0 = disabled
    top_p: torch.Tensor,  # [b] f32; 1 = disabled
    generator: torch.Generator,
    *,
    page_size: int,
    num_steps: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``num_steps`` decode iterations with on-device sampling; returns
    (sampled tokens [b, num_steps] int32, k_pages, v_pages). The caller
    pre-extends ``block_tables`` to cover the growth."""
    toks = []
    for _ in range(num_steps):
        logits = _decode_body(
            params, cfg, tokens, positions, k_pages, v_pages, block_tables,
            seq_lens, page_size,
        )
        tokens = sample_tokens(logits, temperature, top_k, top_p, generator)
        toks.append(tokens)
        positions = positions + 1
        seq_lens = seq_lens + 1
    return torch.stack(toks, dim=1), k_pages, v_pages
