"""Llama-family decoder in PyTorch with a paged KV cache — the port of the
JAX package's ``models/llama.py``: dense and sparse-MoE FFNs, on one
device or sharded over a mesh (``mesh=``, see "Meshes" below).

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
- Prefill attention takes JAX's ``attn_impl``: ``"xla"`` is the plain
  attention of ``ops.prefill_with_paged_context``, masked by ``valid``
  token by token (any mask); ``"pallas"`` is the flash-prefill kernel,
  which sees only each row's count of valid tokens (a right-padded mask;
  ``LLMD_CHECK_PREFILL_MASK=1`` checks it); ``"auto"`` picks the kernel for
  CUDA tensors and ``"xla"`` for CPU tensors.

Meshes (``parallel/``). Every forward runs over a mesh of shards; a
plain parameter tree with ``mesh=None`` is the one shard of a 1x1 mesh on
its inputs' device, where the collectives below reduce to nothing. With
``mesh=`` the parameters are ``parallel.shard_params``' per-shard trees
and the KV pools are per-tp-shard lists (``parallel.sharding.
init_kv_pools``; a single tensor when tp is 1). One process drives every
shard: each tp shard projects its heads, runs K1/K1q/K2 on its heads and
its slice of the pools, and its expert slice through K4/K5; the
row-parallel ``wo``/``w_down`` partial sums, the expert-parallel combine
and the vocabulary-parallel embedding are summed over the tp shards in
float32 in shard order, and the logits are gathered on the first shard's
device. With ``sp > 1`` a prefill chunk is split into contiguous slices
over the sp rows and attention runs as a ring (``parallel/
ring_attention.py``) over [context slice ++ chunk slice]; the pools stay
on the first row's devices and each row reads its slice of the context
from them. Decode runs on the first row.
"""

from __future__ import annotations

import dataclasses
import functools
import os
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
    spec_sample,
)
from ..ops.attention import prefill_with_paged_context, widen_paged_context
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


def _moe_mlp_dense(
    layer: Params, cfg: LlamaConfig, x: torch.Tensor,
    experts: Optional[tuple[int, int]] = None,
) -> torch.Tensor:
    """Masked-dense sparse-MoE SwiGLU FFN (the numerics oracle): every
    expert sees every token, non-selected contributions zeroed by the
    gate. ``experts=(lo, hi)``: the layer holds experts ``lo .. hi - 1``
    only (one expert-parallel shard), and the result is their share."""
    topv, topi = _moe_gates(layer, cfg, x)  # [b, s, k]
    gates = (F.one_hot(topi, cfg.n_experts).float() * topv[..., None]).sum(dim=-2)
    if experts is not None:
        gates = gates[..., experts[0] : experts[1]]
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
    ``cfg.moe_gmm``. ``row_group_ids`` is the sorted expert id per row.
    Under autograd (training: grad enabled and ``lhs`` or the expert stack
    requires grad) the kernels' path goes through ``GroupedMatmul``, whose
    backward launches K4^T and K6; every other call takes the direct path.
    ``"xla"``'s plain version is differentiated by autograd itself."""
    from ..ops.gmm import GroupedMatmul, grouped_matmul, grouped_matmul_plain

    if cfg.moe_gmm not in ("auto", "kernel", "xla"):
        raise ValueError(f"unknown moe_gmm {cfg.moe_gmm!r}")

    def gdot(lhs, w, group_sizes):
        if not isinstance(w, QuantizedTensor):
            w = _w(w, lhs.dtype)
        if cfg.moe_gmm == "xla":
            return grouped_matmul_plain(lhs, w, group_sizes, row_group_ids=row_group_ids)
        if cfg.moe_gmm == "kernel" and lhs.device.type != "cuda":
            raise ValueError(f"moe_gmm='kernel' needs CUDA tensors, got {lhs.device}")
        if torch.is_grad_enabled() and (
            lhs.requires_grad or (isinstance(w, torch.Tensor) and w.requires_grad)
        ):
            return GroupedMatmul.apply(lhs, w, group_sizes, row_group_ids)
        return grouped_matmul(lhs, w, group_sizes, row_group_ids=row_group_ids)

    return gdot


def _moe_mlp_routed(layers, cfg: LlamaConfig, x: torch.Tensor, mesh=None, row: int = 0,
                    tap: Optional[list] = None) -> torch.Tensor:
    """Routed sparse-MoE SwiGLU FFN, expert-parallel over the tp shards of
    mesh row ``row`` (``mesh=None``: ``layers`` is one layer holding every
    expert, on ``x``'s device). Routing runs once (the router is
    replicated) and goes to every shard. Shard ``t`` holds experts
    ``t * E/tp .. (t + 1) * E/tp - 1`` (``layers[t]``): it flattens the
    (token, slot) assignments, sorts them by expert (stable) so each of its
    experts' rows form one segment, runs the three FFN products as grouped
    matmuls (K4; K5 on int8 experts) over those segments, then weights by
    the gate values and sums each token's k rows in float32. A row routed
    to another shard's experts gets a zero gate and sorts after the
    shard's last group, where the grouped matmul writes zeros without
    computing them: JAX clamps such rows into range, but here a shard
    computes its own rows only and the remote rows do not pile into its
    edge experts (the decode kernel's time is set by its largest group).
    Every shape is static in ``n*k`` (padded rows are routed too, as in
    JAX; no capacity factor, no dropped token), and nothing here reads a
    device value on the host. The shards' float32 combines are summed in
    shard order and cast once, as JAX's psum of its float32 combine is.
    ``tap``: a list each shard's group sizes are appended to (the step
    record's expert-group counter)."""
    layers, mesh = _shards(layers, mesh, x.device)
    tp = len(layers)
    e_local = cfg.n_experts // tp
    k = cfg.n_experts_per_tok
    b, s, d = x.shape
    n = b * s
    coll = mesh.collective
    xf0 = x.reshape(n, d)
    topv0, topi0 = _moe_gates(layers[0], cfg, xf0)  # [n, k]
    parts = []
    for t, (layer, dev) in enumerate(zip(layers, mesh.grid[row])):
        xf, topv, topi = (coll.move(a, dev) for a in (xf0, topv0, topi0))
        if tp > 1:
            lo = t * e_local
            local = (topi >= lo) & (topi < lo + e_local)
            topv = torch.where(local, topv, torch.zeros_like(topv))
            # Remote rows take id e_local: past the last group once sorted.
            topi = torch.where(local, topi - lo, torch.full_like(topi, e_local))
        expert_ids = topi.reshape(-1)  # [n*k], (token, slot) order
        order = torch.argsort(expert_ids, stable=True)
        xs = xf[order // k]  # [n*k, d] gathered inputs, expert-contiguous
        # Not bincount: on CUDA it reads its input's max on the host.
        counts = torch.zeros(e_local + 1, dtype=torch.int32, device=dev)
        counts.scatter_add_(0, expert_ids, torch.ones_like(expert_ids, dtype=torch.int32))
        group_sizes = counts[:e_local]
        if tap is not None:
            tap.append(group_sizes)
        ids = expert_ids[order]
        gdot = _grouped_dot(cfg, ids if tp == 1 else ids.clamp(max=e_local - 1))
        gate = cfg.act_fn(gdot(xs, layer["w_gate"], group_sizes).float())
        up = gdot(xs, layer["w_up"], group_sizes).float()
        act = (gate * up).to(x.dtype)
        out = gdot(act, layer["w_down"], group_sizes)  # [n*k, d]
        # Back to (token, slot) order, weight by the gates and sum the k
        # slots in float32: JAX's scatter-add, in a fixed order (no
        # atomics, so a pass gives the same bits every time).
        out = out.float()[torch.argsort(order)].reshape(n, k, d)
        parts.append((out * topv[..., None]).sum(dim=1))
    return coll.sum(parts, x.dtype).reshape(b, s, d)


def _moe_mlp(layers, cfg: LlamaConfig, x: torch.Tensor, mesh=None, row: int = 0,
             tap: Optional[list] = None) -> torch.Tensor:
    """The MoE FFN over the tp shards of mesh row ``row`` (``mesh=None``:
    one layer on ``x``'s device). JAX's selection: routed, expert-parallel,
    when tp divides the expert count and ``k * tp < E`` (less work a shard
    than the dense einsum's ``E/tp`` experts for every token) or tp is 1;
    otherwise the dense einsum over each shard's experts, or over each
    shard's slice of the expert width when tp does not divide the expert
    count."""
    if cfg.moe_dispatch not in ("routed", "dense"):
        raise ValueError(f"unknown moe_dispatch {cfg.moe_dispatch!r}")
    layers, mesh = _shards(layers, mesh, x.device)
    tp, e = len(layers), cfg.n_experts
    if cfg.moe_dispatch == "routed" and e % tp == 0 and (tp == 1 or cfg.n_experts_per_tok * tp < e):
        return _moe_mlp_routed(layers, cfg, x, mesh, row, tap)
    parts = []
    for t, (lay, dev) in enumerate(zip(layers, mesh.grid[row])):
        experts = (t * e // tp, (t + 1) * e // tp) if e % tp == 0 else None
        parts.append(_moe_mlp_dense(lay, cfg, mesh.collective.move(x, dev), experts))
    return mesh.collective.sum(parts, x.dtype)


def _mlp(layers, cfg: LlamaConfig, x: torch.Tensor, mesh=None, row: int = 0,
         tap: Optional[list] = None) -> torch.Tensor:
    """The FFN over the tp shards of mesh row ``row`` (``mesh=None``: one
    layer on ``x``'s device): each shard's column-parallel gate/up and
    row-parallel down give a partial sum, summed over the shards. ``tap``:
    the routed MoE's group sizes (``_moe_mlp_routed``)."""
    if cfg.n_experts:
        return _moe_mlp(layers, cfg, x, mesh, row, tap)
    layers, mesh = _shards(layers, mesh, x.device)
    parts = []
    for lay, dev in zip(layers, mesh.grid[row]):
        xt = mesh.collective.move(x, dev)
        # Activation in float32, as the JAX package computes it.
        gate = cfg.act_fn((xt @ _w(lay["w_gate"], xt.dtype)).float())
        up = (xt @ _w(lay["w_up"], xt.dtype)).float()
        parts.append((gate * up).to(xt.dtype) @ _w(lay["w_down"], xt.dtype))
    return mesh.collective.sum(parts, x.dtype)


@functools.lru_cache(maxsize=None)
def _one_device_mesh(device: torch.device):
    from ..parallel.mesh import make_mesh

    return make_mesh(devices=[device])


def _shards(layers, mesh, device: torch.device):
    """A per-shard function's (layers, mesh): with no mesh, ``layers`` is
    one layer, the one shard of a 1x1 mesh on ``device``."""
    if mesh is None:
        return [layers], _one_device_mesh(device)
    return layers, mesh


def _placed(params, mesh, device: torch.device):
    """The per-shard trees a forward runs on. A plain tree is the one
    shard of a 1x1 mesh on ``device``, and then ``mesh`` must be None;
    ``parallel.shard_params``' trees run on their own mesh, which
    ``mesh``, when given, must be."""
    from ..parallel.mesh import ShardedParams

    if isinstance(params, ShardedParams):
        if mesh is not None and params.mesh.grid != mesh.grid:
            raise ValueError("params are sharded over another mesh")
        return params
    if mesh is not None:
        raise ValueError("with mesh= the params are parallel.shard_params(params, mesh, cfg)")
    return ShardedParams(_one_device_mesh(device), [[params]])


def _embed(params, cfg: LlamaConfig, tokens: torch.Tensor, row: int = 0) -> torch.Tensor:
    """The vocabulary-parallel embedding over mesh row ``row`` of
    ``params`` (a plain tree or ``parallel.shard_params``' trees): shard
    ``t`` looks up the tokens in its slice of the vocabulary and gives
    zeros for the others; the sum over the shards is exact (one nonzero a
    token)."""
    sharded = _placed(params, None, tokens.device)
    coll = sharded.mesh.collective
    parts, v0 = [], 0
    for p, dev in zip(sharded.row(row), sharded.mesh.grid[row]):
        emb = p["embed"]
        n = emb.shape[0]
        tok = coll.move(tokens, dev).long() - v0
        hit = ((tok >= 0) & (tok < n))[..., None]
        idx = tok.clamp(0, n - 1)
        if isinstance(emb, QuantizedTensor):
            # Gather int8 rows, then scale: the table is never dequantized.
            rows = emb.q[idx].to(cfg.dtype) * emb.scale[0].to(cfg.dtype)
        else:
            rows = emb[idx]
        parts.append(torch.where(hit, rows, rows.new_zeros(())))
        v0 += n
    h = coll.sum(parts, parts[0].dtype)
    if cfg.scale_embeddings:  # Gemma: normalizer folded out of the table
        # A fill (no host-to-device copy: capturable in a CUDA graph).
        h = h * torch.full((), cfg.hidden_size**0.5, dtype=h.dtype, device=h.device)
    return h


#: bf16 bytes of an int8 head dequantized at once: the head is the largest
#: weight (Qwen3-30B-A3B's is 622 MB in bf16), and a decode graph keeps its
#: largest temporary in the graph pool for good, so it is dequantized and
#: applied a slice of the vocabulary at a time.
_HEAD_CHUNK_BYTES = 64 * 2**20


def _logits(params, cfg: LlamaConfig, h: torch.Tensor) -> torch.Tensor:
    """Final norm and head, float32, of ``params`` (a plain tree or
    ``parallel.shard_params``' trees). The head is vocabulary-parallel:
    each tp shard of the first mesh row computes its slice of the
    vocabulary, and the slices are gathered in shard order on the first
    shard's device."""
    sharded = _placed(params, None, h.device)
    row, coll = sharded.row(0), sharded.mesh.collective
    h = rms_norm(h, row[0]["final_norm"], cfg.rms_norm_eps, cfg.norm_offset)
    return coll.cat([_head(p, cfg, coll.move(h, dev)) for p, dev in zip(row, sharded.mesh.grid[0])],
                    dim=-1)


def _head(params: Params, cfg: LlamaConfig, h: torch.Tensor) -> torch.Tensor:
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
    valid: Optional[torch.Tensor],  # [b, s] bool, right-padded; None = every row
) -> torch.Tensor:
    """Write every layer's fresh K or V into the pool with one in-place
    update and no host synchronisation. The JAX version redirects invalid
    rows out of range and drops them; torch has no drop mode, so an invalid
    row is written to its row's first slot with what that slot ends up
    holding: the row's first fresh token when the row has one, else the
    value already in the pool. Duplicate indices then carry equal values,
    so the update is deterministic. Contract: no page slot is shared
    between rows (padded rows all point at reserved page 0, slot 0, which
    no valid row writes)."""
    L, _, _, n_kv, hd = pages.shape
    b, s = page_ids.shape
    fresh = fresh.to(pages.dtype)
    if valid is not None:
        page_ids = torch.where(valid, page_ids, page_ids[:, :1])
        slot_ids = torch.where(valid, slot_ids, slot_ids[:, :1])
        held = pages[:, page_ids[:, 0].long(), slot_ids[:, 0].long()]  # [L, b, n_kv, hd]
        first = torch.where(valid[None, :, :1, None, None], fresh[:, :, :1], held[:, :, None])
        fresh = torch.where(valid[None, :, :, None, None], fresh, first)
    pages[:, page_ids.reshape(-1).long(), slot_ids.reshape(-1).long()] = fresh.reshape(
        L, b * s, n_kv, hd
    )
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
        # 127 is a tensor divisor: CUDA divides by a Python scalar as a
        # product with its float32 reciprocal (see quant.quantize_kv_page).
        cand = x.abs().amax(dim=-1).clamp(min=1e-8) / x.new_full((), 127.0)  # [nl, n, n_kv]
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


ATTN_IMPLS = ("auto", "xla", "pallas")


def _attn_impl(attn_impl: str, device: torch.device) -> str:
    """``"auto"`` resolved: the kernel for CUDA tensors, ``"xla"`` else."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    if attn_impl == "auto":
        return "pallas" if device.type == "cuda" else "xla"
    return attn_impl


def _check_right_padded_mask(valid: torch.Tensor) -> None:
    """The kernel path's mask contract, checked on the host (opt-in through
    ``LLMD_CHECK_PREFILL_MASK``: it synchronises)."""
    n_valid = valid.sum(dim=1)
    contract = torch.arange(valid.shape[1], device=valid.device)[None, :] < n_valid[:, None]
    if not bool((contract == valid).all()):
        raise ValueError(
            "prefill(attn_impl='pallas') requires a right-padded prefix "
            "mask: valid[i] == (arange(s) < n_valid[i]); got a mask with "
            "interior holes — use attn_impl='xla' for arbitrary masks"
        )


def _prefill_attention(
    q, k, v, k_pages_l, v_pages_l, k_scales_l, v_scales_l, block_tables, ctx_lens,
    n_valid, positions, valid, attn_impl: str,
) -> torch.Tensor:
    """One layer's chunk attention on one device (or one tp shard's heads):
    ``"xla"`` the plain attention masked token by token; ``"pallas"`` the
    flash-prefill kernel (K2). On int8 pools the kernel reads the context
    pages widened to the chunk's dtype into a chunk-sized buffer, through
    an identity block table."""
    if attn_impl == "xla":
        return prefill_with_paged_context(
            q, k, v, k_pages_l, v_pages_l, block_tables, ctx_lens,
            positions=positions, valid=valid, k_scales=k_scales_l, v_scales=v_scales_l,
        )
    if k_scales_l is None:
        return flash_prefill_paged(q, k, v, k_pages_l, v_pages_l, block_tables, ctx_lens, n_valid)
    b, ctx_pages = block_tables.shape
    wide_tables = torch.arange(b * ctx_pages, dtype=torch.int32, device=q.device).view(b, ctx_pages)
    wide_shape = (b * ctx_pages,) + tuple(k_pages_l.shape[1:])
    ctx_k = widen_paged_context(k_pages_l, k_scales_l, block_tables, k.dtype)
    ctx_v = widen_paged_context(v_pages_l, v_scales_l, block_tables, v.dtype)
    return flash_prefill_paged(
        q, k, v, ctx_k.reshape(wide_shape), ctx_v.reshape(wide_shape), wide_tables, ctx_lens, n_valid,
    )


def _prefill_body(
    sharded,  # parallel.ShardedParams (a plain tree is placed by _placed)
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [b, s] int32, right-padded
    positions: torch.Tensor,  # [b, s] int32 absolute positions
    valid: torch.Tensor,  # [b, s] bool
    k_pages,
    v_pages,
    page_ids: torch.Tensor,  # [b, s]
    slot_ids: torch.Tensor,  # [b, s]
    block_tables: torch.Tensor,  # [b, max_ctx_pages] int32
    ctx_lens: torch.Tensor,  # [b] int32
    k_scales=None,
    v_scales=None,
    *,
    attn_impl: str = "pallas",
) -> torch.Tensor:
    """The prefill layer loop shared by ``prefill`` and the speculative
    verify rounds of ``spec_decode_steps``: the chunk's forward over
    ``sharded``'s mesh, then one KV write for every layer. Row ``r`` of
    the mesh computes chunk columns ``r * s/sp .. (r + 1) * s/sp - 1`` (all
    of them when sp is 1), tp shard ``t`` of it the projections of its
    heads and its FFN slice; the residual stream of a row lives on its
    first device. Attention is the ring when sp > 1, else ``attn_impl``
    (resolved: ``"xla"`` or ``"pallas"``) on each tp shard. Returns the
    hidden states [b, s, d] on the first shard's device; the logits head
    stays with the caller. The int8 pools' write selects the valid rows on
    the host; speculative decoding, which must not synchronise, is refused
    on them."""
    mesh = sharded.mesh
    coll = mesh.collective
    sp, tp = mesh.shape["sp"], mesh.shape["tp"]
    k_pages, v_pages = _pool_shards(k_pages, tp, "k_pages"), _pool_shards(v_pages, tp, "v_pages")
    k_scales, v_scales = _pool_shards(k_scales, tp, "k_scales"), _pool_shards(v_scales, tp, "v_scales")
    quantized = k_scales is not None
    scfg = _shard_cfg(cfg, tp)
    b, s = tokens.shape
    w = s // sp
    grid = mesh.grid

    def rows(x):
        return [coll.move(x[:, r * w : (r + 1) * w], grid[r][0]) for r in range(sp)]

    def per_shard(x):  # one copy per tp shard of the first row
        return [coll.move(x, dev) for dev in grid[0]]

    row_pos, row_valid = rows(positions), rows(valid)
    inv = [[_inv_freq(cfg, dev) for dev in row] for row in grid]
    h = [_embed(sharded, cfg, tok, r) for r, tok in enumerate(rows(tokens))]
    if sp == 1:
        n_valid, tables, lens = (per_shard(valid.sum(dim=1, dtype=torch.int32)),
                                 per_shard(block_tables), per_shard(ctx_lens))
        shard_pos, shard_valid = per_shard(positions), per_shard(valid)
    fresh_k = [[[] for _ in range(tp)] for _ in range(sp)]
    fresh_v = [[[] for _ in range(tp)] for _ in range(sp)]
    for li in range(cfg.n_layers):
        qs = [[None] * tp for _ in range(sp)]
        ks = [[None] * tp for _ in range(sp)]
        vs = [[None] * tp for _ in range(sp)]
        for r in range(sp):
            x = rms_norm(h[r], sharded.shards[r][0]["layers"][li]["attn_norm"],
                         cfg.rms_norm_eps, cfg.norm_offset)
            for t in range(tp):
                dev = grid[r][t]
                q, k, v = _qkv(sharded.shards[r][t]["layers"][li], scfg, coll.move(x, dev))
                pos = coll.move(row_pos[r], dev)
                qs[r][t] = apply_rope(q, pos, inv[r][t])
                ks[r][t] = apply_rope(k, pos, inv[r][t])
                vs[r][t] = v
                fresh_k[r][t].append(ks[r][t])
                fresh_v[r][t].append(v)
        pools_k = [p[li] for p in k_pages]
        pools_v = [p[li] for p in v_pages]
        if sp > 1:
            attn = _sp_prefill_attention(qs, ks, vs, pools_k, pools_v, block_tables, ctx_lens,
                                         row_pos, row_valid, mesh)
        else:  # K2 (or the plain attention) once a tp shard, no collective
            attn = [[
                _prefill_attention(
                    qs[0][t], ks[0][t], vs[0][t], pools_k[t], pools_v[t],
                    k_scales[t][li] if quantized else None, v_scales[t][li] if quantized else None,
                    tables[t], lens[t], n_valid[t], shard_pos[t], shard_valid[t], attn_impl,
                )
                for t in range(tp)
            ]]
        for r in range(sp):
            layers = [sharded.shards[r][t]["layers"][li] for t in range(tp)]
            parts = [attn[r][t].reshape(b, w, -1) @ _w(layers[t]["wo"], h[r].dtype)
                     for t in range(tp)]
            h[r] = h[r] + coll.sum(parts, h[r].dtype)
            x = rms_norm(h[r], layers[0]["mlp_norm"], cfg.rms_norm_eps, cfg.norm_offset)
            h[r] = h[r] + _mlp(layers, cfg, x, mesh, r)
    # In-chunk attention never reads the chunk's own pages (its K/V ride
    # the arguments), so every layer's write is deferred to one update:
    # every row's fresh K/V, in chunk order, into tp shard t's pools.
    for t in range(tp):
        owner = grid[0][t]
        fk, fv = fresh_k[0][t], fresh_v[0][t]
        if sp > 1:
            fk = [coll.cat([fresh_k[r][t][li] for r in range(sp)], dim=1) for li in range(cfg.n_layers)]
            fv = [coll.cat([fresh_v[r][t][li] for r in range(sp)], dim=1) for li in range(cfg.n_layers)]
        _write_kv(
            k_pages[t], v_pages[t], k_scales[t] if quantized else None,
            v_scales[t] if quantized else None, fk, fv,
            *(coll.move(x, owner) for x in (page_ids, slot_ids, valid, positions)),
        )
    return coll.cat(h, dim=1)


def _write_kv(k_pages, v_pages, k_scales, v_scales, fresh_k, fresh_v, page_ids, slot_ids, valid,
              positions) -> None:
    """Every layer's fresh K and V ([b, s, n_kv, hd] a layer) into the pools
    in place, quantized on int8 pools."""
    if k_scales is not None:
        _quantized_scatter_kv_all_layers(
            k_pages, k_scales, torch.stack(fresh_k), page_ids, slot_ids, valid, positions
        )
        _quantized_scatter_kv_all_layers(
            v_pages, v_scales, torch.stack(fresh_v), page_ids, slot_ids, valid, positions
        )
    else:
        _scatter_kv_pages_all_layers(k_pages, torch.stack(fresh_k), page_ids, slot_ids, valid)
        _scatter_kv_pages_all_layers(v_pages, torch.stack(fresh_v), page_ids, slot_ids, valid)


def _pool_shards(pools, tp: int, what: str):
    """A mesh call's pools as a per-tp-shard list: a list is checked, a
    single tensor is one shard's when tp is 1."""
    if pools is None:
        return None
    if isinstance(pools, (list, tuple)):
        if len(pools) != tp:
            raise ValueError(f"{what}: {len(pools)} shards for tp={tp}")
        return list(pools)
    if tp == 1:
        return [pools]
    raise ValueError(
        f"{what}: with tp={tp} the pools are per-shard lists "
        "(parallel.sharding.init_kv_pools or shard_kv_pools)"
    )


def _shard_cfg(cfg: LlamaConfig, tp: int) -> LlamaConfig:
    """The config one tp shard's attention projections see: its heads."""
    if tp == 1:
        return cfg
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp, head_dim=cfg.hd)


def _paged_attention_tp(
    qs, k_pages, v_pages, block_tables, seq_lens, fresh_k, fresh_v, *,
    layer: int = 0, k_scale=None, v_scale=None,
) -> list:
    """Decode attention, head-parallel over the tp shards of the first mesh
    row: K1 (K1q on int8 pages) once a shard, on its query heads and its
    head slice of the pools (``n_kv/tp`` heads, the same GQA group). No
    collective: the row-parallel ``wo`` after it sums the shards. Every
    argument but ``layer`` is a per-shard list; the full 5-D pools are
    read in place at ``layer``."""
    return [
        paged_attention(
            qs[t], k_pages[t], v_pages[t], block_tables[t], seq_lens[t], fresh_k[t], fresh_v[t],
            k_scale=None if k_scale is None else k_scale[t],
            v_scale=None if v_scale is None else v_scale[t],
            layer=layer,
        )
        for t in range(len(qs))
    ]


def _sp_prefill_attention(
    qs, ks, vs, k_pages_l, v_pages_l, block_tables, ctx_lens, positions, valid, mesh,
) -> list:
    """Sequence-parallel prefill attention: a ring over the chunk, merged
    exactly with the paged context. ``qs[r][t]`` (and ``ks``, ``vs``) are
    row ``r``'s slice of the chunk in tp shard ``t``'s heads,
    ``positions[r]``/``valid[r]`` the slice's; ``k_pages_l[t]`` the layer's
    pool of tp shard ``t``. Row ``r`` takes a contiguous slice of the
    context block table (padded to a multiple of sp with page 0, beyond
    every context length), gathers those pages from the pool and puts its
    payload [context slice ++ chunk slice] on the ring, context keys at
    position -1 (visible to every chunk query) and invalid ones masked.
    Heads stay split over tp inside every row. Returns ``out[r][t]``."""
    from ..parallel.ring_attention import ring_attention_shards

    sp, tp = mesh.shape["sp"], mesh.shape["tp"]
    coll = mesh.collective
    pad = (-block_tables.shape[1]) % sp
    if pad:
        block_tables = F.pad(block_tables, (0, pad))
    per = block_tables.shape[1] // sp
    out = [[None] * tp for _ in range(sp)]
    for t in range(tp):
        pool_k, pool_v = k_pages_l[t], v_pages_l[t]
        tables = coll.move(block_tables, pool_k.device).long()
        n_local = per * pool_k.shape[1]
        devs = [mesh.grid[r][t] for r in range(sp)]
        payload, q_pos = [], []
        for r, dev in enumerate(devs):
            k, v = ks[r][t], vs[r][t]
            b, _, n_kv, d = k.shape
            pos = coll.move(positions[r], dev).long()
            q_pos.append(pos)
            val = coll.move(valid[r], dev)
            if n_local:
                pages = tables[:, r * per : (r + 1) * per]
                ctx_k = coll.move(pool_k[pages].reshape(b, n_local, n_kv, d), dev)
                ctx_v = coll.move(pool_v[pages].reshape(b, n_local, n_kv, d), dev)
                ctx_idx = r * n_local + torch.arange(n_local, device=dev)
                ctx_valid = ctx_idx[None, :] < coll.move(ctx_lens, dev)[:, None].long()
                ctx_pos = torch.full((b, n_local), -1, dtype=torch.long, device=dev)
                payload.append((torch.cat([ctx_k, k], dim=1), torch.cat([ctx_v, v], dim=1),
                                torch.cat([ctx_pos, pos], dim=1), torch.cat([ctx_valid, val], dim=1)))
            else:
                payload.append((k, v, pos, val))
        outs = ring_attention_shards(
            [qs[r][t] for r in range(sp)], [p[0] for p in payload], [p[1] for p in payload],
            q_pos=q_pos, k_pos=[p[2] for p in payload], k_valid=[p[3] for p in payload],
            mesh=mesh, devices=devs,
        )
        for r in range(sp):
            out[r][t] = outs[r]
    return out


def prefill(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [b, s] int32, right-padded
    positions: torch.Tensor,  # [b, s] int32 absolute positions
    valid: torch.Tensor,  # [b, s] bool
    k_pages,  # [n_layers, pages, page_size, n_kv, hd] (per-shard list under a mesh)
    v_pages,
    page_ids: torch.Tensor,  # [b, s] destination page per token
    slot_ids: torch.Tensor,  # [b, s] destination slot per token
    block_tables: torch.Tensor,  # [b, max_ctx_pages] int32 — cached-context pages
    ctx_lens: torch.Tensor,  # [b] int32 — prefix-cached context length
    k_scales=None,  # [n_layers, pages, n_kv] f32 (int8 pools)
    v_scales=None,
    *,
    return_all_logits: bool = False,  # [b, s, vocab] for spec-decode verify
    attn_impl: str = "auto",
    mesh=None,
) -> tuple:
    """Process a prompt chunk: returns (logits at the last valid position
    per sequence [b, vocab] f32, k_pages, v_pages), the pools written in
    place, with (k_scales, v_scales) appended for int8 pools. With
    ``return_all_logits`` the logits are every chunk position's [b, s,
    vocab] (the speculative verify round's). The chunk attends causally
    within itself and to ``ctx_lens`` tokens of context already in the
    pool.

    ``attn_impl``: ``"xla"`` masks by ``valid`` token by token (any mask);
    ``"pallas"`` runs the flash-prefill kernel (plain on CPU tensors),
    which sees only the per-row count of valid tokens, so ``valid`` must be
    a right-padded prefix mask (the engine's contract; set
    ``LLMD_CHECK_PREFILL_MASK=1`` to check it, at a host sync); ``"auto"``
    (the default here; JAX's default is ``"xla"``) is the kernel for CUDA
    tensors and ``"xla"`` for CPU tensors, so a call on the card runs K2.
    Chunk positions are consecutive from ``ctx_lens`` on the kernel path.
    On int8 pools the kernel path widens each layer's context pages to the
    chunk's dtype into a chunk-sized buffer, which K2 reads through an
    identity block table.

    ``mesh``: a ``parallel.make_mesh`` mesh that ``params`` (then
    ``parallel.shard_params``' trees) are sharded over (the module
    docstring); the chunk length must divide by its sp size, and int8 pools
    do not run over sp > 1 (as in JAX). The logits come back on the first
    shard's device."""
    impl = _attn_impl(attn_impl, tokens.device)
    sharded = _placed(params, mesh, tokens.device)
    sp = sharded.mesh.shape["sp"]
    if sp > 1 and tokens.shape[1] % sp != 0:
        raise ValueError(f"chunk length {tokens.shape[1]} not divisible by sp={sp}")
    if impl == "pallas" and os.environ.get("LLMD_CHECK_PREFILL_MASK"):
        _check_right_padded_mask(valid)
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be passed together")
    quantized = k_scales is not None
    if quantized and sp > 1:
        raise ValueError("KV_QUANT_HBM prefill does not run over sp > 1")
    h = _prefill_body(
        sharded, cfg, tokens, positions, valid, k_pages, v_pages, page_ids,
        slot_ids, block_tables, ctx_lens, k_scales, v_scales, attn_impl=impl,
    )
    extra = (k_scales, v_scales) if quantized else ()
    if return_all_logits:
        return (_logits(sharded, cfg, h), k_pages, v_pages) + extra
    b = tokens.shape[0]
    last_idx = (valid.sum(dim=1).long() - 1).clamp(min=0).to(h.device)
    h_last = h[torch.arange(b, device=h.device), last_idx]  # [b, d]
    logits = _logits(sharded, cfg, h_last[:, None, :])[:, 0]
    return (logits, k_pages, v_pages) + extra


def _decode_body(
    sharded,  # parallel.ShardedParams (a plain tree is placed by _placed)
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [b] int32 — last sampled token per sequence
    positions: torch.Tensor,  # [b] int32 — position of this token
    k_pages,
    v_pages,
    block_tables: torch.Tensor,  # [b, max_pages] int32
    seq_lens: torch.Tensor,  # [b] int32 — context length INCLUDING this token
    page_size: int,
    k_scales=None,  # [n_layers, pages, n_kv] f32 (int8 pools)
    v_scales=None,
    tap: Optional[list] = None,
) -> torch.Tensor:
    """One decode step over the tp shards of the first mesh row (one token
    a lane has nothing to split over sp): each shard projects its heads
    and runs K1/K1q on its slice of the pools (``_paged_attention_tp``)
    over the pages plus the current token; the ``wo`` and FFN partial sums
    are summed over the shards; then this token's K/V are written into its
    page slot (in place, quantized on int8 pools). Returns logits [b,
    vocab] f32 on the first shard's device."""
    mesh = sharded.mesh
    coll = mesh.collective
    devs = mesh.grid[0]
    tp = len(devs)
    k_pages, v_pages = _pool_shards(k_pages, tp, "k_pages"), _pool_shards(v_pages, tp, "v_pages")
    k_scales, v_scales = _pool_shards(k_scales, tp, "k_scales"), _pool_shards(v_scales, tp, "v_scales")
    row = sharded.row(0)
    scfg = _shard_cfg(cfg, tp)
    b = tokens.shape[0]
    h = _embed(sharded, cfg, tokens)[:, None, :]  # [b, 1, d]
    pos = positions.long()
    my_page = torch.gather(block_tables.long(), 1, (pos // page_size)[:, None])
    my_slot = (pos % page_size)[:, None]
    shard_pos = [coll.move(positions, d)[:, None] for d in devs]
    tables = [coll.move(block_tables, d) for d in devs]
    lens = [coll.move(seq_lens, d) for d in devs]
    inv = [_inv_freq(cfg, d) for d in devs]
    fresh_k = [[] for _ in devs]
    fresh_v = [[] for _ in devs]
    for li in range(cfg.n_layers):
        layers = [p["layers"][li] for p in row]
        x = rms_norm(h, layers[0]["attn_norm"], cfg.rms_norm_eps, cfg.norm_offset)
        qs, ks, vs = [], [], []
        for t, dev in enumerate(devs):
            q, k, v = _qkv(layers[t], scfg, coll.move(x, dev))
            k = apply_rope(k, shard_pos[t], inv[t])
            qs.append(apply_rope(q, shard_pos[t], inv[t])[:, 0])
            ks.append(k[:, 0])
            vs.append(v[:, 0])
            fresh_k[t].append(k)
            fresh_v[t].append(v)
        # The pages hold only history; this token's K/V ride the call, so
        # the pool write happens once for all layers after the loop.
        attn = _paged_attention_tp(qs, k_pages, v_pages, tables, lens, ks, vs,
                                   layer=li, k_scale=k_scales, v_scale=v_scales)
        parts = [a.reshape(b, -1) @ _w(lay["wo"], h.dtype) for a, lay in zip(attn, layers)]
        h = h + coll.sum(parts, h.dtype)[:, None, :]
        x = rms_norm(h, layers[0]["mlp_norm"], cfg.rms_norm_eps, cfg.norm_offset)
        h = h + _mlp(layers, cfg, x, mesh, tap=tap)
    for t, dev in enumerate(devs):
        _write_kv(
            k_pages[t], v_pages[t], None if k_scales is None else k_scales[t],
            None if v_scales is None else v_scales[t], fresh_k[t], fresh_v[t],
            coll.move(my_page, dev), coll.move(my_slot, dev), None, shard_pos[t],
        )
    return _logits(sharded, cfg, h)[:, 0]


def decode_step(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    k_pages,
    v_pages,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    *,
    page_size: int,
    k_scales=None,
    v_scales=None,
    mesh=None,
) -> tuple:
    """One decode step; returns (logits [b, vocab] f32, k_pages, v_pages),
    the pools written in place, with (k_scales, v_scales) appended for
    int8 pools. Sampling stays with the caller. ``mesh``: head-parallel
    over its tp shards (the module docstring)."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be passed together")
    logits = _decode_body(
        _placed(params, mesh, tokens.device), cfg, tokens, positions, k_pages, v_pages,
        block_tables, seq_lens, page_size, k_scales, v_scales,
    )
    extra = (k_scales, v_scales) if k_scales is not None else ()
    return (logits, k_pages, v_pages) + extra


def decode_steps(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [b] int32 — last sampled token per sequence
    positions: torch.Tensor,  # [b] int32 — position of `tokens`
    k_pages,
    v_pages,
    block_tables: torch.Tensor,  # [b, max_pages] int32 (covers num_steps growth)
    seq_lens: torch.Tensor,  # [b] int32 — context length INCLUDING `tokens`
    temperature: torch.Tensor,  # [b] f32; 0 = greedy
    top_k: torch.Tensor,  # [b] int32; 0 = disabled
    top_p: torch.Tensor,  # [b] f32; 1 = disabled
    generator: torch.Generator,
    *,
    page_size: int,
    num_steps: int,
    k_scales=None,
    v_scales=None,
    mesh=None,
    expert_groups: Optional[torch.Tensor] = None,
) -> tuple:
    """``num_steps`` decode iterations with on-device sampling; returns
    (sampled tokens [b, num_steps] int32, k_pages, v_pages), with
    (k_scales, v_scales) appended for int8 pools. The caller pre-extends
    ``block_tables`` to cover the growth. Under ``mesh`` every input and
    the sampled tokens live on the first shard's device.
    ``expert_groups`` ([num_steps] int32 on the first shard's device, MoE
    models): step ``i`` writes into it the sum over layers and shards of
    the expert groups that hold a row, as the grouped matmuls receive them
    (padded lanes route too), with four kernels a step."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be passed together")
    sharded = _placed(params, mesh, tokens.device)
    toks = []
    for i in range(num_steps):
        tap = [] if expert_groups is not None else None
        logits = _decode_body(
            sharded, cfg, tokens, positions, k_pages, v_pages, block_tables,
            seq_lens, page_size, k_scales, v_scales, tap,
        )
        if tap:
            sizes = torch.stack([sharded.mesh.collective.move(g, expert_groups.device) for g in tap])
            expert_groups[i] = (sizes > 0).sum()
        tokens = sample_tokens(logits, temperature, top_k, top_p, generator)
        toks.append(tokens)
        positions = positions + 1
        seq_lens = seq_lens + 1
    extra = (k_scales, v_scales) if k_scales is not None else ()
    return (torch.stack(toks, dim=1), k_pages, v_pages) + extra


def spec_decode_steps(
    params: Params,
    cfg: LlamaConfig,
    packed_i32: torch.Tensor,  # [b, W + table_w + 5] int32 — see below
    fparams: torch.Tensor,  # [b, 2] f32 — (temperature, top_p) per lane
    k_pages,
    v_pages,
    generator: torch.Generator,
    *,
    page_size: int,
    num_rounds: int,
    s_chunk: int,  # verify chunk width (>= spec_k + 1, a multiple of sp)
    ngram: int,
    spec_k: int,
    max_scan: int,
    table_w: int,  # block-table width inside packed_i32
    sampled: bool,  # any lane has temperature > 0 (the caller's host data)
    attn_impl: str = "auto",
    mesh=None,
) -> tuple[torch.Tensor, ...]:
    """``num_rounds`` speculative-decode rounds with on-device
    prompt-lookup proposals, chained through device state: the caller's
    one fetch of the returned array is the burst's only host sync.

    Each round, per lane: (1) propose — the latest earlier occurrence of
    the window's final ``ngram`` tokens, and up to ``spec_k`` of its
    followers, clamped by the remaining budget and the adaptive gate (the
    engine's ``_propose_prompt_lookup``); (2) verify — one prefill-shaped
    forward over ``[last committed token ++ drafts]`` against the paged
    context (``_prefill_body``, every position's logits); (3) accept —
    greedy lanes take the longest draft prefix equal to the argmax plus
    the correction, sampled lanes run deterministic-draft speculative
    sampling (``ops.spec_sample``); (4) commit on the device — the emitted
    tokens join the window and ``seq_lens``/budgets advance. Rejected
    drafts leave stale K/V beyond ``seq_lens`` in pages the lane owns.

    ``packed_i32 = [window | block_tables | wlen, seq_lens, budget,
    gate_open, top_k]``; ``window[j]`` holds the token at global position
    ``seq_lens - wlen + j``, and the caller sizes it so that it cannot
    overflow (``W >= wlen + num_rounds * (spec_k + 1)``) and reserves pages
    for the worst-case growth. A lane whose budget reaches 0 keeps
    verifying its last position and emits nothing. ``sampled`` is the
    host's decision (the JAX function's ``lax.cond``): all-greedy bursts
    skip the filtered distributions and draw nothing from ``generator``.

    Returns ``(packed [rounds, b, spec_k + 4] int32, k_pages, v_pages)``:
    ``packed[..., :k+1]`` the emitted tokens, then (emit_len, prop_len,
    accepted). The pools are written in place. ``attn_impl`` and ``mesh``
    are ``prefill``'s; under a mesh the inputs live on the first shard's
    device."""
    dev = packed_i32.device
    impl = _attn_impl(attn_impl, dev)
    sharded = _placed(params, mesh, dev)
    W = packed_i32.shape[1] - table_w - 5
    window = packed_i32[:, :W].clone()
    block_tables = packed_i32[:, W : W + table_w].contiguous()
    wlen = packed_i32[:, W + table_w]
    seq_lens = packed_i32[:, W + table_w + 1]
    budget = packed_i32[:, W + table_w + 2]
    gate_open = packed_i32[:, W + table_w + 3] != 0
    top_k = packed_i32[:, W + table_w + 4].contiguous()
    temperature = fparams[:, 0].contiguous()
    top_p = fparams[:, 1].contiguous()
    b = window.shape[0]
    n, k = ngram, spec_k
    i32 = torch.int32
    # window[j] is global position base + j; wlen and seq_lens advance
    # together, so base is fixed for the burst.
    base = seq_lens - wlen
    j = torch.arange(W, device=dev)[None, :].expand(b, W)
    ar_n = torch.arange(n, device=dev)[None, :]
    ar_k = torch.arange(k, device=dev)[None, :]
    kk = torch.arange(k + 1, device=dev)[None, :]
    jj = torch.arange(s_chunk, device=dev, dtype=i32)[None, :]
    zero_col = torch.zeros((b, 1), dtype=i32, device=dev)
    pad = torch.zeros((b, s_chunk - 1 - k), dtype=i32, device=dev)

    def take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return torch.gather(a, 1, idx.clamp(0, a.shape[1] - 1).long())

    rounds = []
    for _ in range(num_rounds):
        active = seq_lens > 0

        # ---- propose (prompt lookup over the window) -------------------
        pattern = take(window, wlen[:, None] - n + ar_n)  # [b, n]
        m = torch.ones((b, W), dtype=torch.bool, device=dev)
        for o in range(n):
            m = m & (take(window, j + o) == pattern[:, o : o + 1]) & (j + o < W)
        # Host parity: start <= len - n - 1 (the terminal occurrence is
        # excluded) and start >= len - 1 - max_scan in global positions.
        m = m & (j + n <= wlen[:, None] - 1)
        m = m & (j + base[:, None] >= seq_lens[:, None] - 1 - max_scan)
        latest = torch.where(m, j, torch.full_like(j, -1)).amax(dim=1)  # [b]
        avail = wlen - (latest + n)  # followers available (>= 1 when found)
        # Drafts past budget - 1 can never be emitted (a round emits
        # accepted + 1).
        prop_len = torch.where(
            (latest >= 0) & gate_open & active,
            torch.minimum(avail.clamp(max=k), (budget - 1).clamp(min=0)),
            torch.zeros_like(avail),
        ).to(i32)
        drafts = take(window, latest[:, None] + n + ar_k)  # [b, k], garbage past prop_len

        # ---- the verify chunk ------------------------------------------
        last_tok = take(window, (wlen - 1)[:, None])  # [b, 1]
        chunk = torch.cat([last_tok, drafts, pad], dim=1)  # [b, s_chunk]
        valid = (jj < (1 + prop_len)[:, None]) & active[:, None]
        start = (seq_lens - 1).clamp(min=0).to(i32)
        positions = start[:, None] + jj
        page_ids = take(block_tables, positions // page_size)
        slot_ids = positions % page_size
        h = _prefill_body(
            sharded, cfg, chunk, positions, valid, k_pages, v_pages, page_ids,
            slot_ids, block_tables, start, attn_impl=impl,
        )
        logits = _logits(sharded, cfg, h)  # [b, s_chunk, vocab] f32

        # ---- accept ----------------------------------------------------
        # logits[:, j] predict the token after chunk[:, j]: the draft
        # under test there is chunk[:, j + 1].
        drafts_shift = torch.cat([chunk[:, 1:], zero_col], dim=1)
        if sampled:
            accept, replacement, free = spec_sample(
                logits, drafts_shift, temperature, top_k, top_p, generator
            )
        else:
            greedy = torch.argmax(logits, dim=-1).to(i32)
            accept, replacement, free = greedy == drafts_shift, greedy, greedy
        lead = torch.cumprod(accept[:, :k].to(i32), dim=1)
        acc = (lead * (ar_k < prop_len[:, None])).sum(dim=1).to(i32)
        corrected = torch.where(
            acc < prop_len, take(replacement, acc[:, None])[:, 0], take(free, acc[:, None])[:, 0]
        )
        drafts_pad = torch.cat([drafts, zero_col], dim=1)
        emit = torch.where(
            kk < acc[:, None],
            drafts_pad,
            torch.where(kk == acc[:, None], corrected[:, None], torch.zeros_like(drafts_pad)),
        )  # [b, k + 1]
        emit_len = torch.where(
            active & (budget > 0), torch.minimum(acc + 1, budget), torch.zeros_like(acc)
        ).to(i32)

        # ---- commit on the device --------------------------------------
        widx = (wlen[:, None] + kk).clamp(0, W - 1).long()
        cur = torch.gather(window, 1, widx)
        window = window.scatter(1, widx, torch.where(kk < emit_len[:, None], emit, cur))
        wlen = wlen + emit_len
        seq_lens = seq_lens + emit_len
        budget = budget - emit_len
        rounds.append(torch.cat(
            [emit, emit_len[:, None], prop_len[:, None], acc[:, None]], dim=1
        ))
    return torch.stack(rounds), k_pages, v_pages
