"""HuggingFace → native parameter conversion for Llama-family checkpoints:
the port of the JAX package's ``models/hf_loader.py``.

Maps a transformers Llama/Qwen2/Qwen3/Qwen3-MoE/Mixtral/Gemma state dict
onto the parameter layout of ``models/llama.py``. torch ``Linear`` stores
``[out, in]`` and computes ``x @ W.T``; the params store ``[in, out]``, so
every projection transposes. The RoPE convention (half-split rotate)
matches HF Llama, so no permutation of head channels is needed. Each
tensor goes to float32 on the target device and then to ``cfg.dtype``
(round to nearest even), as the JAX loader's numpy float32 round trip
does, so both give the same bits. Only local or in-memory state dicts.
"""

from __future__ import annotations

from typing import Any, Mapping, Union

import torch

from ..ops.rope import RopeScalingConfig
from .llama import LlamaConfig, Params


def load_hf_state_dict(
    state_dict: Mapping[str, Any],
    cfg: LlamaConfig,
    device: Union[torch.device, str] = "cuda",
) -> Params:
    sd = state_dict

    def get(name: str) -> torch.Tensor:
        return torch.as_tensor(sd[name]).detach().to(device=device, dtype=torch.float32)

    def vector(name: str) -> torch.Tensor:
        return get(name).to(cfg.dtype)

    def linear(name: str) -> torch.Tensor:
        return get(name).T.contiguous().to(cfg.dtype)  # [out,in] -> [in,out]

    layers = []
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        layer = {
            "attn_norm": vector(p + "input_layernorm.weight"),
            "wq": linear(p + "self_attn.q_proj.weight"),
            "wk": linear(p + "self_attn.k_proj.weight"),
            "wv": linear(p + "self_attn.v_proj.weight"),
            "wo": linear(p + "self_attn.o_proj.weight"),
            "mlp_norm": vector(p + "post_attention_layernorm.weight"),
        }
        if cfg.n_experts:
            # Expert weights stacked to [E, d, f] / [E, f, d]. Two
            # checkpoint namings:
            # - Mixtral: block_sparse_moe.gate + experts.j.{w1,w3,w2}
            # - Qwen3-MoE: mlp.gate + mlp.experts.j.{gate,up,down}_proj
            if f"{p}block_sparse_moe.gate.weight" in sd:
                moe = p + "block_sparse_moe."
                names = ("w1.weight", "w3.weight", "w2.weight")
            else:
                moe = p + "mlp."
                names = ("gate_proj.weight", "up_proj.weight", "down_proj.weight")
            layer["router"] = linear(moe + "gate.weight")
            for key, name in zip(("w_gate", "w_up", "w_down"), names):
                layer[key] = torch.stack(
                    [linear(f"{moe}experts.{j}.{name}") for j in range(cfg.n_experts)]
                )
        else:
            layer["w_gate"] = linear(p + "mlp.gate_proj.weight")
            layer["w_up"] = linear(p + "mlp.up_proj.weight")
            layer["w_down"] = linear(p + "mlp.down_proj.weight")
        if cfg.qkv_bias:
            layer["bq"] = vector(p + "self_attn.q_proj.bias")
            layer["bk"] = vector(p + "self_attn.k_proj.bias")
            layer["bv"] = vector(p + "self_attn.v_proj.bias")
        if cfg.qk_norm:
            layer["q_norm"] = vector(p + "self_attn.q_norm.weight")
            layer["k_norm"] = vector(p + "self_attn.k_norm.weight")
        layers.append(layer)

    params: Params = {
        "embed": vector("model.embed_tokens.weight"),
        "final_norm": vector("model.norm.weight"),
        "layers": layers,
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = linear("lm_head.weight")
    return params


def config_from_hf(hf_config) -> LlamaConfig:
    """transformers LlamaConfig/Qwen2Config/Qwen3(Moe)Config/MixtralConfig/
    GemmaConfig → native config (``cfg.dtype`` stays bfloat16)."""
    rope_scaling = None
    rs = getattr(hf_config, "rope_scaling", None)
    if rs:
        rope_type = rs.get("rope_type", rs.get("type"))
        if rope_type == "llama3":
            rope_scaling = RopeScalingConfig(
                factor=rs["factor"],
                low_freq_factor=rs["low_freq_factor"],
                high_freq_factor=rs["high_freq_factor"],
                original_max_position=rs["original_max_position_embeddings"],
            )
        elif rope_type in (None, "default"):
            pass
        else:
            # Silently loading e.g. linear/dynamic/yarn scaling with base
            # frequencies would degrade long-context generation undetectably.
            raise NotImplementedError(
                f"rope_scaling type {rope_type!r} is not supported yet"
            )
    cls_name = hf_config.__class__.__name__
    is_gemma = cls_name == "GemmaConfig"
    if cls_name.startswith("Gemma") and not is_gemma:
        # Gemma2/3 change the layer schema (sandwich norms, softcapping,
        # sliding windows) — loading them as Gemma-1 would silently produce
        # wrong logits, same policy as the rope_scaling check above.
        raise NotImplementedError(
            f"{cls_name} is not supported yet (Gemma-1 only)"
        )
    hidden_act = getattr(hf_config, "hidden_activation", None) or getattr(
        hf_config, "hidden_act", "silu"
    )
    if hidden_act == "gelu_pytorch_tanh":
        hidden_act = "gelu_tanh"
    cfg = LlamaConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.intermediate_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads", hf_config.num_attention_heads),
        head_dim=getattr(hf_config, "head_dim", None),
        rope_theta=getattr(hf_config, "rope_theta", 10_000.0),
        rope_scaling=rope_scaling,
        rms_norm_eps=hf_config.rms_norm_eps,
        qkv_bias=getattr(hf_config, "attention_bias", False) or cls_name.startswith("Qwen2"),
        qk_norm=cls_name.startswith("Qwen3"),
        tie_word_embeddings=getattr(hf_config, "tie_word_embeddings", False),
        n_experts=getattr(hf_config, "num_local_experts", 0)
        or getattr(hf_config, "num_experts", 0),
        n_experts_per_tok=getattr(hf_config, "num_experts_per_tok", 2),
        moe_intermediate_size=getattr(hf_config, "moe_intermediate_size", None),
        norm_topk_prob=getattr(hf_config, "norm_topk_prob", True),
        hidden_act=hidden_act,
        norm_offset=1.0 if is_gemma else 0.0,
        scale_embeddings=is_gemma,
    )
    # Fails now, not on the first request, for an activation the model
    # cannot compute. JAX reads its ``act_fn`` property, which raises; the
    # port's ``act_fn`` is a method, so it is called.
    cfg.act_fn(torch.zeros(()))
    # Qwen3-MoE variants with partially-dense layers change the layer
    # schema; loading them as uniform-MoE would silently produce wrong
    # logits (same policy as the Gemma2/rope guards above).
    if cfg.n_experts:
        sparse_step = getattr(hf_config, "decoder_sparse_step", 1)
        dense_layers = getattr(hf_config, "mlp_only_layers", None) or []
        if sparse_step != 1 or dense_layers:
            raise NotImplementedError(
                "mixed dense/sparse decoder layers are not supported "
                f"(decoder_sparse_step={sparse_step}, "
                f"mlp_only_layers={list(dense_layers)})"
            )
        if getattr(hf_config, "shared_expert_intermediate_size", 0):
            # Qwen2-MoE adds an always-on shared expert; loading it as
            # routed-only would silently drop those weights.
            raise NotImplementedError(
                "shared-expert MoE (Qwen2-MoE style) is not supported"
            )
    return cfg
