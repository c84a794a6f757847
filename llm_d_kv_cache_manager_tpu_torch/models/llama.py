"""Llama-family decoder in PyTorch with a paged KV cache — the port of the
JAX package's ``models/llama.py``: dense and sparse-MoE FFNs (single
device; expert parallelism is not ported).

- Parameters are a plain dict with the JAX pytree's keys (``embed``,
  ``final_norm``, ``layers[i].{attn_norm, wq, wk, wv, wo, mlp_norm,
  w_gate, w_up, w_down}`` plus ``router`` and ``[E, in, out]`` expert
  stacks for MoE, ``lm_head``) and its ``[in, out]`` layout, so a JAX tree
  converts leaf by leaf (``models/convert.py``). Any matmul weight may be
  an int8 ``QuantizedTensor`` (``models/quant.py``); every use goes
  through ``materialize``, as in the JAX model.
- KV pools are ``[n_layers, total_pages, page_size, n_kv_heads, head_dim]``.
  JAX donates them to each call and gets new arrays back; here they are
  updated in place (``index_put_``) and returned for the same call shape.
- With ``KV_QUANT_HBM=int8`` the pools hold int8 codes and per-page f32
  scale pools ``[n_layers, total_pages, n_kv_heads]`` ride beside them
  (``k_scales``/``v_scales``): tokens are quantized as they are written
  (``_quantized_scatter_kv_all_layers``), decode attention dequantizes in
  its kernel, and prefill widens its context pages to the chunk's dtype
  before the flash-prefill kernel. The forward passes then return the
  scale pools after the page pools, as the JAX functions do.
- Attention runs through ``ops.flash_prefill_paged`` (prefill) and
  ``ops.paged_attention`` (decode), and routed MoE expert products through
  ``ops.grouped_matmul``: the Hopper kernels for CUDA tensors, their plain
  versions for CPU tensors. Dense matrix products go to ``torch.matmul``.
"""

from __future__ import annotations

import functools
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
from ..ops.attention import widen_paged_context
from ..ops.rope import RopeScalingConfig
from .quant import QuantizedTensor, quantize_tensor
from .quant import materialize as _w

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
    n_experts: int = 0  # sparse-MoE FFN when > 0 (Mixtral/Qwen3-MoE style)
    n_experts_per_tok: int = 2
    # Expert FFN width when decoupled from the dense intermediate size
    # (Qwen3-MoE); None = same as intermediate_size (Mixtral).
    moe_intermediate_size: Optional[int] = None
    # Renormalize the top-k gate weights (Mixtral always; Qwen3-MoE's
    # norm_topk_prob flag).
    norm_topk_prob: bool = True
    # Expert dispatch: "routed" (sort by expert + grouped matmuls, expert
    # FLOPs scale with top-k) or "dense" (masked einsum over ALL experts —
    # the numerics oracle).
    moe_dispatch: str = "routed"
    # Grouped-matmul backend of the routed dispatch: "auto" (the Hopper
    # kernels for CUDA tensors, the plain version for CPU tensors),
    # "kernel" (the kernels; raises for CPU tensors) or "xla" (the plain
    # version on any device — the JAX package's oracle setting).
    moe_gmm: str = "auto"
    # Gemma-style variations: gated-GELU FFN ("gelu_tanh"), (1+w) RMSNorm
    # scaling (norm_offset=1.0), embeddings scaled by sqrt(hidden_size).
    hidden_act: str = "silu"
    norm_offset: float = 0.0
    scale_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.n_heads

    @property
    def moe_inter(self) -> int:
        return self.moe_intermediate_size or self.intermediate_size

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

#: Qwen3-30B-A3B: 128-expert top-8 MoE with qk-norm, decoupled 768-wide
#: experts, renormalized gates (its checkpoint config).
QWEN3_30B_A3B = LlamaConfig(
    vocab_size=151_936,
    hidden_size=2_048,
    intermediate_size=6_144,
    n_layers=48,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    rope_theta=1_000_000.0,
    rms_norm_eps=1e-6,
    qk_norm=True,
    n_experts=128,
    n_experts_per_tok=8,
    moe_intermediate_size=768,
    norm_topk_prob=True,
)

#: Tiny Qwen3-MoE-shaped config (qk-norm + MoE) for tests / CPU dry-runs.
TINY_QWEN3_MOE = LlamaConfig(
    vocab_size=256,
    hidden_size=64,
    intermediate_size=128,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    head_dim=24,
    rope_theta=10_000.0,
    rms_norm_eps=1e-6,
    qk_norm=True,
    n_experts=4,
    n_experts_per_tok=2,
    moe_intermediate_size=48,
    norm_topk_prob=True,
    dtype=torch.float32,
)

#: Tiny MoE config (Mixtral-shaped) for tests / CPU dry-runs.
TINY_MOE = LlamaConfig(
    vocab_size=256,
    hidden_size=64,
    intermediate_size=96,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    rope_theta=10_000.0,
    n_experts=4,
    n_experts_per_tok=2,
    dtype=torch.float32,
)


def init_params(
    cfg: LlamaConfig,
    generator: torch.Generator,
    device: torch.device | str,
    quantize: Optional[str] = None,
    quantize_experts: bool = False,
) -> Params:
    """Random-init parameters on ``device``: every matrix is
    ``normal * fan_in**-0.5`` in float32, cast to ``cfg.dtype`` (the JAX
    package's init), drawn from ``generator`` (which must live on
    ``device``) in a fixed order.

    ``quantize="int8"`` quantizes each matmul weight the moment it is
    created, so the full-precision tree is never resident. MoE expert
    stacks stay in ``cfg.dtype`` unless ``quantize_experts``; the router
    and the embedding are never quantized here."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    d, hd = cfg.hidden_size, cfg.hd
    n_q, n_kv, inter = cfg.n_heads, cfg.n_kv_heads, cfg.intermediate_size

    def dense(shape, scale_dim, quantizable=True):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        w = (w * scale_dim**-0.5).to(cfg.dtype)
        return quantize_tensor(w) if quantize and quantizable else w

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
        }
        if cfg.n_experts:
            e, f = cfg.n_experts, cfg.moe_inter
            # The router stays full precision: routing decisions are the
            # most quantization-sensitive computation of an MoE.
            layer["router"] = dense((d, e), d, quantizable=False)
            layer["w_gate"] = dense((e, d, f), d, quantizable=quantize_experts)
            layer["w_up"] = dense((e, d, f), d, quantizable=quantize_experts)
            layer["w_down"] = dense((e, f, d), f, quantizable=quantize_experts)
        else:
            layer["w_gate"] = dense((d, inter), d)
            layer["w_up"] = dense((d, inter), d)
            layer["w_down"] = dense((inter, d), inter)
        if cfg.qkv_bias:
            layer["bq"] = torch.zeros((n_q * hd,), dtype=cfg.dtype, device=device)
            layer["bk"] = torch.zeros((n_kv * hd,), dtype=cfg.dtype, device=device)
            layer["bv"] = torch.zeros((n_kv * hd,), dtype=cfg.dtype, device=device)
        if cfg.qk_norm:
            layer["q_norm"] = norm_init((hd,))
            layer["k_norm"] = norm_init((hd,))
        layers.append(layer)

    params: Params = {
        "embed": dense((cfg.vocab_size, d), d, quantizable=False),
        "final_norm": norm_init((d,)),
        "layers": layers,
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense((d, cfg.vocab_size), d)
    return params


def init_kv_pages(
    cfg: LlamaConfig,
    total_pages: int,
    page_size: int,
    device: torch.device | str,
    kv_quant_hbm: Optional[str] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroed K and V page pools:
    ``[n_layers, total_pages, page_size, n_kv_heads, head_dim]``. With
    ``kv_quant_hbm="int8"`` they hold int8 codes (half the bytes of a bf16
    page); the scale pools come from :func:`init_kv_scales`."""
    shape = (cfg.n_layers, total_pages, page_size, cfg.n_kv_heads, cfg.hd)
    dtype = torch.int8 if kv_quant_hbm == "int8" else cfg.dtype
    return (
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )


def init_kv_scales(
    cfg: LlamaConfig, total_pages: int, device: torch.device | str
) -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroed f32 scale pools ``[n_layers, total_pages, n_kv_heads]`` for
    int8 page pools: one scale per page per (layer, kv head). Zero scales
    dequantize to zeros, so a fresh int8 pool reads as a zeroed one."""
    shape = (cfg.n_layers, total_pages, cfg.n_kv_heads)
    return (
        torch.zeros(shape, dtype=torch.float32, device=device),
        torch.zeros(shape, dtype=torch.float32, device=device),
    )


@functools.lru_cache(maxsize=None)
def _inv_freq(cfg: LlamaConfig, device: torch.device) -> torch.Tensor:
    # Cached: the host-to-device copy synchronises, and a decode step must
    # not.
    return torch.from_numpy(
        rope_frequencies(cfg.hd, cfg.rope_theta, cfg.rope_scaling)
    ).to(device)


def _qkv(layer: Params, cfg: LlamaConfig, x: torch.Tensor):
    b, s, d = x.shape
    q = x @ _w(layer["wq"], x.dtype)
    k = x @ _w(layer["wk"], x.dtype)
    v = x @ _w(layer["wv"], x.dtype)
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


def _moe_gates(layer: Params, cfg: LlamaConfig, x: torch.Tensor):
    """Top-k routing shared by both dispatch strategies: softmax over ALL
    expert logits in float32, top-k, renormalize the survivors (HF
    Mixtral / Qwen3-MoE). Returns (values [..., k] f32, indices [..., k])."""
    router_logits = (x @ layer["router"]).float()  # [..., E]
    weights = torch.softmax(router_logits, dim=-1)
    topv, topi = torch.topk(weights, cfg.n_experts_per_tok, dim=-1)
    if cfg.norm_topk_prob:
        topv = topv / topv.sum(dim=-1, keepdim=True)
    return topv, topi


def _moe_mlp_dense(layer: Params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    """Masked-dense sparse-MoE SwiGLU FFN (the numerics oracle): every
    expert sees every token, non-selected contributions zeroed by the
    gate."""
    topv, topi = _moe_gates(layer, cfg, x)  # [b, s, k]
    gates = (F.one_hot(topi, cfg.n_experts).float() * topv[..., None]).sum(dim=-2)
    gate = cfg.act_fn(
        torch.einsum("bsd,edf->ebsf", x, _w(layer["w_gate"], x.dtype)).float()
    )
    up = torch.einsum("bsd,edf->ebsf", x, _w(layer["w_up"], x.dtype)).float()
    act = (gate * up).to(x.dtype)
    return torch.einsum(
        "ebsf,efd,bse->bsd", act, _w(layer["w_down"], x.dtype), gates.to(x.dtype)
    )


def _grouped_dot(cfg: LlamaConfig, row_group_ids: torch.Tensor):
    """Grouped-matmul dispatcher for the routed MoE path, per
    ``cfg.moe_gmm``. ``row_group_ids`` is the sorted expert id per row."""
    from ..ops.gmm import grouped_matmul, grouped_matmul_plain

    if cfg.moe_gmm not in ("auto", "kernel", "xla"):
        raise ValueError(f"unknown moe_gmm {cfg.moe_gmm!r}")

    def gdot(lhs, w, group_sizes):
        if not isinstance(w, QuantizedTensor):
            w = _w(w, lhs.dtype)
        if cfg.moe_gmm == "xla":
            return grouped_matmul_plain(lhs, w, group_sizes, row_group_ids=row_group_ids)
        if cfg.moe_gmm == "kernel" and lhs.device.type != "cuda":
            raise ValueError(f"moe_gmm='kernel' needs CUDA tensors, got {lhs.device}")
        return grouped_matmul(lhs, w, group_sizes, row_group_ids=row_group_ids)

    return gdot


def _moe_mlp_routed(layer: Params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    """Routed sparse-MoE SwiGLU FFN: flatten the (token, slot) assignments,
    sort them by expert (stable) so each expert's rows form one segment,
    run the three FFN products as grouped matmuls over those segments, then
    weight by the gate values and sum each token's k rows in float32.
    Every shape is static in ``n*k`` (padded rows are routed too, as in
    JAX), and nothing here reads a device value on the host."""
    b, s, d = x.shape
    n = b * s
    k = cfg.n_experts_per_tok
    xf = x.reshape(n, d)
    topv, topi = _moe_gates(layer, cfg, xf)  # [n, k]

    expert_ids = topi.reshape(-1)  # [n*k], (token, slot) order
    order = torch.argsort(expert_ids, stable=True)
    xs = xf[order // k]  # [n*k, d] gathered inputs, expert-contiguous
    # Not bincount: on CUDA it reads its input's max on the host.
    group_sizes = torch.zeros(cfg.n_experts, dtype=torch.int32, device=x.device)
    group_sizes.scatter_add_(0, expert_ids, torch.ones_like(expert_ids, dtype=torch.int32))
    gdot = _grouped_dot(cfg, expert_ids[order])

    gate = cfg.act_fn(gdot(xs, layer["w_gate"], group_sizes).float())
    up = gdot(xs, layer["w_up"], group_sizes).float()
    act = (gate * up).to(x.dtype)
    out = gdot(act, layer["w_down"], group_sizes)  # [n*k, d]

    # Back to (token, slot) order, weight by the gates and sum the k slots
    # in float32: JAX's scatter-add, in a fixed order (no atomics, so a
    # pass gives the same bits every time).
    out = out.float()[torch.argsort(order)].reshape(n, k, d)
    combined = (out * topv[..., None]).sum(dim=1)
    return combined.reshape(b, s, d).to(x.dtype)


def _moe_mlp(layer: Params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.moe_dispatch not in ("routed", "dense"):
        raise ValueError(f"unknown moe_dispatch {cfg.moe_dispatch!r}")
    if cfg.moe_dispatch == "routed":
        return _moe_mlp_routed(layer, cfg, x)
    return _moe_mlp_dense(layer, cfg, x)


def _mlp(layer: Params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.n_experts:
        return _moe_mlp(layer, cfg, x)
    # Activation in float32, as the JAX package computes it.
    gate = cfg.act_fn((x @ _w(layer["w_gate"], x.dtype)).float())
    up = (x @ _w(layer["w_up"], x.dtype)).float()
    return (gate * up).to(x.dtype) @ _w(layer["w_down"], x.dtype)


def _embed(params: Params, cfg: LlamaConfig, tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    if isinstance(emb, QuantizedTensor):
        # Gather int8 rows, then scale: the full table is never dequantized.
        h = emb.q[tokens.long()].to(cfg.dtype) * emb.scale[0].to(cfg.dtype)
    else:
        h = emb[tokens.long()]
    if cfg.scale_embeddings:  # Gemma: normalizer folded out of the table
        # A fill (no host-to-device copy: capturable in a CUDA graph).
        h = h * torch.full((), cfg.hidden_size**0.5, dtype=h.dtype, device=h.device)
    return h


#: bf16 bytes of an int8 head dequantized at once: the head is the largest
#: weight (Qwen3-30B-A3B's is 622 MB in bf16), and a decode graph keeps its
#: largest temporary in the graph pool for good, so it is dequantized and
#: applied a slice of the vocabulary at a time.
_HEAD_CHUNK_BYTES = 64 * 2**20


def _logits(params: Params, cfg: LlamaConfig, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps, cfg.norm_offset)
    if cfg.tie_word_embeddings:
        return (h @ _w(params["embed"], h.dtype).T).float()
    head = params["lm_head"]
    if not isinstance(head, QuantizedTensor):
        return (h @ head).float()
    d, vocab = head.shape
    cols = max(128, _HEAD_CHUNK_BYTES // (2 * d) // 128 * 128)
    out = torch.empty(h.shape[:-1] + (vocab,), dtype=torch.float32, device=h.device)
    for c0 in range(0, vocab, cols):
        part = QuantizedTensor(head.q[:, c0 : c0 + cols], head.scale[:, c0 : c0 + cols])
        out[..., c0 : c0 + cols] = h @ _w(part, h.dtype)
    return out


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


#: float32 bytes of fresh K or V quantized at once: the layers are
#: independent, so a long prefill (8,192 tokens at Llama-3.1-8B widths is
#: 1 GiB over its 32 layers) is quantized a few layers at a time.
_QUANT_CHUNK_BYTES = 256 * 2**20


def _quantized_scatter_kv_all_layers(
    pages_q: torch.Tensor,  # [n_layers, total_pages, page_size, n_kv, hd] int8
    scales: torch.Tensor,  # [n_layers, total_pages, n_kv] f32
    fresh: torch.Tensor,  # [n_layers, b, s, n_kv, hd]
    page_ids: torch.Tensor,  # [b, s]
    slot_ids: torch.Tensor,  # [b, s]
    valid: Optional[torch.Tensor],  # [b, s] bool; None = every row
    positions: torch.Tensor,  # [b, s] absolute positions of the written tokens
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write-time quantization (``KV_QUANT_HBM=int8``), in place: the int8
    counterpart of :func:`_scatter_kv_pages_all_layers`, keeping the
    per-page-per-(layer, kv_head) symmetric scales as it writes, with the
    JAX function's arithmetic exactly (so codes and scales are equal).

    Engine contracts it leans on: chunk positions are consecutive, ``valid``
    is a right-padded prefix mask, and no page is shared between rows
    (padded decode lanes all write reserved page 0 with the same token at
    position 0, so those writers agree). Only a row's first page can hold
    live codes, when its first position is not page-aligned (the "carry"
    page: the decode write at slot != 0). Every other written page is
    fresh: its scale restarts from 0 before the scatter-max, so a previous
    tenant's scale cannot coarsen it. The carry page's codes are
    requantized under its grown scale with the ratio ``s_old / s_new``
    (unchanged bit for bit when the scale does not move).

    No host synchronisation when ``valid`` is None (decode): JAX's dropped
    writes become writes of unchanged values (a factor 1 on the scales of
    pages that are not fresh, a ratio 1 on first pages that are not carry
    pages). With a mask (prefill) the valid rows are selected first."""
    L, P, ps, n_kv, hd = pages_q.shape
    b, s = page_ids.shape
    pid = page_ids.long()
    first_page = pid[:, 0]  # [b]
    carry = positions[:, 0].long() % ps != 0
    if valid is not None:
        carry = carry & valid[:, 0]
    carry_page = torch.where(carry, first_page, torch.full_like(first_page, -1))
    pidx = pid.reshape(-1)
    sidx = slot_ids.reshape(-1).long()
    # 0 zeroes a fresh page's scale; 1 leaves a carry page's.
    keep_scale = (pid == carry_page[:, None]).reshape(-1).float()
    keep = None
    if valid is not None:
        keep = valid.reshape(-1).nonzero().squeeze(1)
        pidx, sidx, keep_scale = pidx[keep], sidx[keep], keep_scale[keep]
    n = pidx.numel()
    step = max(1, _QUANT_CHUNK_BYTES // max(1, n * n_kv * hd * 4))
    for l0 in range(0, L, step):
        pq, sc = pages_q[l0 : l0 + step], scales[l0 : l0 + step]  # views
        nl = pq.shape[0]
        x = fresh[l0 : l0 + step].reshape(nl, b * s, n_kv, hd)
        x = (x if keep is None else x[:, keep]).float()  # [nl, n, n_kv, hd]
        s_old = sc[:, first_page]  # [nl, b, n_kv], before this write

        to_pages = pidx[None, :, None].expand(nl, n, n_kv)
        sc.scatter_reduce_(1, to_pages, keep_scale[None, :, None].expand(nl, n, n_kv), "prod")
        # Per-token symmetric scale candidates, scatter-maxed into the pages.
        cand = x.abs().amax(dim=-1).clamp(min=1e-8) / 127.0  # [nl, n, n_kv]
        sc.scatter_reduce_(1, to_pages, cand, "amax")

        # Requantize each carry page's resident codes under its grown scale.
        s_new = sc[:, first_page]
        grown = carry[None, :, None] & (s_new > 0)
        ratio = torch.where(grown, s_old / s_new.clamp(min=1e-30), torch.ones_like(s_new))
        old = pq[:, first_page].float()  # [nl, b, ps, n_kv, hd]
        pq[:, first_page] = (
            torch.round(old * ratio[:, :, None, :, None]).clamp_(-127, 127).to(torch.int8)
        )

        # Quantize the fresh tokens with their page's final scale; scatter.
        s_tok = sc[:, pidx].clamp(min=1e-30)  # [nl, n, n_kv]
        pq[:, pidx, sidx] = torch.round(x / s_tok[..., None]).clamp_(-127, 127).to(torch.int8)
    return pages_q, scales


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
    k_scales: Optional[torch.Tensor] = None,  # [n_layers, pages, n_kv] f32 (int8 pools)
    v_scales: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, ...]:
    """Process a prompt chunk: returns (logits at the last valid position
    per sequence [b, vocab] f32, k_pages, v_pages), the pools written in
    place, with (k_scales, v_scales) appended for int8 pools. The chunk
    attends causally within itself and to ``ctx_lens`` tokens of context
    already in the pool. On int8 pools each layer's context pages are
    widened to the chunk's dtype into a chunk-sized buffer, which the
    flash-prefill kernel reads through an identity block table.

    Contract (the engine's): chunk positions are consecutive from
    ``ctx_lens`` and ``valid`` is a right-padded prefix mask; attention
    sees only the per-row count of valid tokens."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be passed together")
    quantized = k_scales is not None
    inv_freq = _inv_freq(cfg, tokens.device)
    h = _embed(params, cfg, tokens)  # [b, s, d]
    n_valid = valid.sum(dim=1, dtype=torch.int32)
    b, s = tokens.shape
    if quantized:
        ctx_pages = block_tables.shape[1]
        wide_tables = torch.arange(
            b * ctx_pages, dtype=torch.int32, device=tokens.device
        ).view(b, ctx_pages)
        wide_shape = (b * ctx_pages,) + tuple(k_pages.shape[2:])
    fresh_k, fresh_v = [], []
    for li, layer in enumerate(params["layers"]):
        x = rms_norm(h, layer["attn_norm"], cfg.rms_norm_eps, cfg.norm_offset)
        q, k, v = _qkv(layer, cfg, x)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
        if quantized:
            ctx_k = widen_paged_context(k_pages[li], k_scales[li], block_tables, k.dtype)
            ctx_v = widen_paged_context(v_pages[li], v_scales[li], block_tables, v.dtype)
            attn = flash_prefill_paged(
                q, k, v, ctx_k.reshape(wide_shape), ctx_v.reshape(wide_shape),
                wide_tables, ctx_lens, n_valid,
            )
        else:
            attn = flash_prefill_paged(
                q, k, v, k_pages[li], v_pages[li], block_tables, ctx_lens, n_valid
            )
        h = h + attn.reshape(b, s, -1) @ _w(layer["wo"], h.dtype)
        x = rms_norm(h, layer["mlp_norm"], cfg.rms_norm_eps, cfg.norm_offset)
        h = h + _mlp(layer, cfg, x)
        fresh_k.append(k)
        fresh_v.append(v)
    # In-chunk attention never reads the chunk's own pages (its K/V ride
    # the arguments), so every layer's write is deferred to one update.
    if quantized:
        _quantized_scatter_kv_all_layers(
            k_pages, k_scales, torch.stack(fresh_k), page_ids, slot_ids, valid, positions
        )
        _quantized_scatter_kv_all_layers(
            v_pages, v_scales, torch.stack(fresh_v), page_ids, slot_ids, valid, positions
        )
    else:
        _scatter_kv_pages_all_layers(k_pages, torch.stack(fresh_k), page_ids, slot_ids, valid)
        _scatter_kv_pages_all_layers(v_pages, torch.stack(fresh_v), page_ids, slot_ids, valid)
    last_idx = (n_valid.long() - 1).clamp(min=0)
    h_last = h[torch.arange(b, device=h.device), last_idx]  # [b, d]
    logits = _logits(params, cfg, h_last[:, None, :])[:, 0]
    return (logits, k_pages, v_pages) + ((k_scales, v_scales) if quantized else ())


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
    k_scales: Optional[torch.Tensor] = None,  # [n_layers, pages, n_kv] f32 (int8 pools)
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One decode step: attention over the pages plus the current token,
    then this token's K/V written into its page slot (in place, quantized
    on int8 pools). Returns logits [b, vocab] f32."""
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
        # the pool write happens once for all layers after the loop. The
        # full 5-D pool (and 3-D scale pool) is read in place at `li`.
        attn = paged_attention(
            q[:, 0], k_pages, v_pages, block_tables, seq_lens, k[:, 0], v[:, 0],
            k_scale=k_scales, v_scale=v_scales, layer=li,
        )  # [b, n_heads, hd]
        h = h + (attn.reshape(b, -1) @ _w(layer["wo"], h.dtype))[:, None, :]
        x = rms_norm(h, layer["mlp_norm"], cfg.rms_norm_eps, cfg.norm_offset)
        h = h + _mlp(layer, cfg, x)
        fresh_k.append(k)
        fresh_v.append(v)
    if k_scales is not None:
        _quantized_scatter_kv_all_layers(
            k_pages, k_scales, torch.stack(fresh_k), my_page, my_slot, None, positions[:, None]
        )
        _quantized_scatter_kv_all_layers(
            v_pages, v_scales, torch.stack(fresh_v), my_page, my_slot, None, positions[:, None]
        )
    else:
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
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, ...]:
    """One decode step; returns (logits [b, vocab] f32, k_pages, v_pages),
    the pools written in place, with (k_scales, v_scales) appended for
    int8 pools. Sampling stays with the caller."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be passed together")
    logits = _decode_body(
        params, cfg, tokens, positions, k_pages, v_pages, block_tables,
        seq_lens, page_size, k_scales, v_scales,
    )
    extra = (k_scales, v_scales) if k_scales is not None else ()
    return (logits, k_pages, v_pages) + extra


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
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, ...]:
    """``num_steps`` decode iterations with on-device sampling; returns
    (sampled tokens [b, num_steps] int32, k_pages, v_pages), with
    (k_scales, v_scales) appended for int8 pools. The caller pre-extends
    ``block_tables`` to cover the growth."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be passed together")
    toks = []
    for _ in range(num_steps):
        logits = _decode_body(
            params, cfg, tokens, positions, k_pages, v_pages, block_tables,
            seq_lens, page_size, k_scales, v_scales,
        )
        tokens = sample_tokens(logits, temperature, top_k, top_p, generator)
        toks.append(tokens)
        positions = positions + 1
        seq_lens = seq_lens + 1
    extra = (k_scales, v_scales) if k_scales is not None else ()
    return (torch.stack(toks, dim=1), k_pages, v_pages) + extra
