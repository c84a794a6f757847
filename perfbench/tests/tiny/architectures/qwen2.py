"""Qwen2 (Hugging Face ``Qwen2ForCausalLM``), dense: full causal attention
with biases on the q, k and v projections and no qk-norm, and a dense
SwiGLU FFN in every layer. Its plain reference is ``reference/qwen2.py``
beside this file's folder."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from perfbench.model import Dims, Ffn, Layer
from perfbench.spec import load_module


@dataclass(frozen=True)
class Qwen2Dims(Dims):
    inter: int


def dims(hf: dict) -> Qwen2Dims:
    d, heads = hf["hidden_size"], hf["num_attention_heads"]
    kv_heads = hf.get("num_key_value_heads", heads)
    hd = d // heads
    layer = Layer(span=None, attn_params=d * (heads + 2 * kv_heads) * hd + heads * hd * d,
                  ffn=Ffn(hf["intermediate_size"]))
    return Qwen2Dims(vocab=hf["vocab_size"], d=d, heads=heads, kv_heads=kv_heads, hd=hd,
                     eps=float(hf["rms_norm_eps"]), theta=float(hf["rope_theta"]),
                     tie=bool(hf.get("tie_word_embeddings", False)),
                     dtype=hf.get("torch_dtype", "bfloat16"),
                     stack=(layer,) * hf["num_hidden_layers"], inter=hf["intermediate_size"])


def block_specs(m: Qwen2Dims, block: int) -> list[tuple[str, tuple[int, ...], Optional[int]]]:
    if block == 0:
        specs = [("embed", (m.vocab, m.d), m.d), ("final_norm", (m.d,), None)]
        return specs if m.tie else specs + [("lm_head", (m.d, m.vocab), m.d)]
    d, q, kv = m.d, m.heads * m.hd, m.kv_heads * m.hd
    return [("attn_norm", (d,), None), ("wq", (d, q), d), ("bq", (q,), d), ("wk", (d, kv), d),
            ("bk", (kv,), d), ("wv", (d, kv), d), ("bv", (kv,), d), ("wo", (q, d), q),
            ("mlp_norm", (d,), None), ("w_gate", (d, m.inter), d), ("w_up", (d, m.inter), d),
            ("w_down", (m.inter, d), m.inter)]


def engine_model(m: Qwen2Dims):
    import torch

    from llm_d_kv_cache_manager_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(
        vocab_size=m.vocab, hidden_size=m.d, intermediate_size=m.inter, n_layers=m.layers,
        n_heads=m.heads, n_kv_heads=m.kv_heads, head_dim=m.hd, rope_theta=m.theta,
        rms_norm_eps=m.eps, qkv_bias=True, tie_word_embeddings=m.tie, dtype=getattr(torch, m.dtype))


def forward(m, block, seqs, want, device, precision="fp32"):
    ref = load_module(Path(__file__).resolve().parent.parent / "reference" / "qwen2.py")
    return ref.forward(m, block, seqs, want, device, precision)
