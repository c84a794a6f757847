"""Qwen3 and Qwen3-MoE (Hugging Face ``Qwen3ForCausalLM`` /
``Qwen3MoeForCausalLM``): every layer full causal attention with qk-norm
and grouped KV heads, and one FFN kind in every layer, dense SwiGLU or
``num_experts`` routed experts, top ``num_experts_per_tok``, from a
softmax router. A config with sliding windows, dense-only layers or a
sparse step other than 1 is refused: nothing here counts or serves them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from perfbench.model import Dims, Ffn, Layer
from perfbench.reference.qwen3 import forward

__all__ = ["block_specs", "dims", "engine_model", "forward"]


@dataclass(frozen=True)
class Qwen3Dims(Dims):
    inter: int
    experts: int
    top_k: int
    moe_inter: int
    norm_topk: bool
    #: always True: Qwen3 normalises each head's q and k (the reference
    #: reads it)
    qk_norm: bool


def dims(hf: dict) -> Qwen3Dims:
    """``hf``: the ``config`` object of a configuration file."""
    if (hf.get("use_sliding_window") or hf.get("mlp_only_layers")
            or hf.get("decoder_sparse_step", 1) != 1):
        raise ValueError("a Qwen3 config with sliding windows or dense-only layers is not counted here")
    d, heads = hf["hidden_size"], hf["num_attention_heads"]
    kv_heads = hf.get("num_key_value_heads", heads)
    hd = hf.get("head_dim") or d // heads
    experts = hf.get("num_experts", 0) or 0
    top_k = hf.get("num_experts_per_tok", 0) if experts else 0
    moe_inter = hf.get("moe_intermediate_size") or hf["intermediate_size"]
    ffn = Ffn(moe_inter, experts, top_k) if experts else Ffn(hf["intermediate_size"])
    layer = Layer(span=None, attn_params=d * (heads + 2 * kv_heads) * hd + heads * hd * d, ffn=ffn)
    return Qwen3Dims(
        vocab=hf["vocab_size"],
        d=d,
        heads=heads,
        kv_heads=kv_heads,
        hd=hd,
        eps=float(hf["rms_norm_eps"]),
        theta=float(hf["rope_theta"]),
        tie=bool(hf.get("tie_word_embeddings", False)),
        dtype=hf.get("torch_dtype", "bfloat16"),
        stack=(layer,) * hf["num_hidden_layers"],
        inter=hf["intermediate_size"],
        experts=experts,
        top_k=top_k,
        moe_inter=moe_inter,
        norm_topk=bool(hf.get("norm_topk_prob", True)),
        qk_norm=True,
    )


def block_specs(m: Qwen3Dims, block: int) -> list[tuple[str, tuple[int, ...], Optional[int]]]:
    if block == 0:
        specs = [("embed", (m.vocab, m.d), m.d), ("final_norm", (m.d,), None)]
        if not m.tie:
            specs.append(("lm_head", (m.d, m.vocab), m.d))
        return specs
    d, hd, nq, nkv = m.d, m.hd, m.heads, m.kv_heads
    specs = [
        ("attn_norm", (d,), None),
        ("wq", (d, nq * hd), d),
        ("wk", (d, nkv * hd), d),
        ("wv", (d, nkv * hd), d),
        ("wo", (nq * hd, d), nq * hd),
        ("mlp_norm", (d,), None),
        ("q_norm", (hd,), None),
        ("k_norm", (hd,), None),
    ]
    if m.experts:
        e, f = m.experts, m.moe_inter
        specs += [("router", (d, e), d), ("w_gate", (e, d, f), d),
                  ("w_up", (e, d, f), d), ("w_down", (e, f, d), f)]
    else:
        specs += [("w_gate", (d, m.inter), d), ("w_up", (d, m.inter), d),
                  ("w_down", (m.inter, d), m.inter)]
    return specs


def engine_model(m: Qwen3Dims):
    import torch

    from llm_d_kv_cache_manager_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(
        vocab_size=m.vocab, hidden_size=m.d, intermediate_size=m.inter, n_layers=m.layers,
        n_heads=m.heads, n_kv_heads=m.kv_heads, head_dim=m.hd, rope_theta=m.theta,
        rms_norm_eps=m.eps, qk_norm=True, tie_word_embeddings=m.tie,
        n_experts=m.experts, n_experts_per_tok=m.top_k or 2,
        moe_intermediate_size=m.moe_inter if m.experts else None,
        norm_topk_prob=m.norm_topk, dtype=getattr(torch, m.dtype),
    )
