"""A configuration file's model, as the sizes the harness counts with.

The file holds the model's public ``config.json`` under ``config``; this
reads the keys of the Qwen3 / Qwen3-MoE family (and any Llama-shaped
config that uses the same names) into one flat record.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Dims:
    vocab: int
    d: int
    inter: int
    layers: int
    heads: int
    kv_heads: int
    hd: int
    eps: float
    theta: float
    qk_norm: bool
    experts: int
    top_k: int
    moe_inter: int
    norm_topk: bool
    tie: bool
    dtype: str

    @property
    def dtype_bytes(self) -> int:
        return {"bfloat16": 2, "float16": 2, "float32": 4}[self.dtype]


#: model types whose attention normalises each head's q and k (Qwen3)
QK_NORM_TYPES = ("qwen3", "qwen3_moe")


def dims(hf: dict) -> Dims:
    """``hf``: the ``config`` object of a configuration file."""
    heads = hf["num_attention_heads"]
    experts = hf.get("num_experts", 0) or 0
    return Dims(
        vocab=hf["vocab_size"],
        d=hf["hidden_size"],
        inter=hf["intermediate_size"],
        layers=hf["num_hidden_layers"],
        heads=heads,
        kv_heads=hf.get("num_key_value_heads", heads),
        hd=hf.get("head_dim") or hf["hidden_size"] // heads,
        eps=float(hf["rms_norm_eps"]),
        theta=float(hf["rope_theta"]),
        qk_norm=hf["model_type"] in QK_NORM_TYPES,
        experts=experts,
        top_k=hf.get("num_experts_per_tok", 0) if experts else 0,
        moe_inter=hf.get("moe_intermediate_size") or hf["intermediate_size"],
        norm_topk=bool(hf.get("norm_topk_prob", True)),
        tie=bool(hf.get("tie_word_embeddings", False)),
        dtype=hf.get("torch_dtype", "bfloat16"),
    )
