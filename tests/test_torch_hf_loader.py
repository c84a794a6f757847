"""The port's HF loader (``models/hf_loader.py``) against the JAX package's
and against transformers, on the CPU, with random-init transformers models
(no network), as the JAX package's ``tests/test_llama_model.py`` builds
them.

- ``load_hf_state_dict``: both packages' params are equal bit for bit, in
  float32 and in bfloat16 (each tensor goes through float32 to the model
  dtype with one round to nearest even on both sides).
- The port's prefill logits match transformers' at the JAX tests'
  tolerances: rtol/atol 2e-4, and 3e-4 for Qwen3-MoE (float32 throughout;
  the two frameworks order their sums differently).
- ``config_from_hf`` gives equal fields and raises the same errors.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers as hf

from llm_d_kv_cache_manager_tpu.models import hf_loader as jh
from llm_d_kv_cache_manager_tpu_torch.models import config_from_hf, init_kv_pages, load_hf_state_dict, prefill

PAGE_SIZE = 4
SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, rope_theta=10000.0,
             tie_word_embeddings=False)
#: name: (config class, model class, extra config fields, logits tolerance)
FAMILIES = {
    "llama": ("LlamaConfig", "LlamaForCausalLM",
              dict(rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                                 "high_freq_factor": 4.0,
                                 "original_max_position_embeddings": 64}), 2e-4),
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM", dict(rms_norm_eps=1e-6), 2e-4),
    "qwen3": ("Qwen3Config", "Qwen3ForCausalLM", dict(head_dim=32, rms_norm_eps=1e-6), 2e-4),
    "qwen3_moe": ("Qwen3MoeConfig", "Qwen3MoeForCausalLM",
                  dict(moe_intermediate_size=48, head_dim=24, num_experts=4,
                       num_experts_per_tok=2, norm_topk_prob=True, rms_norm_eps=1e-6), 3e-4),
    "mixtral": ("MixtralConfig", "MixtralForCausalLM",
                dict(num_local_experts=4, num_experts_per_tok=2), 2e-4),
    "gemma": ("GemmaConfig", "GemmaForCausalLM",
              dict(head_dim=16, num_key_value_heads=4, hidden_activation="gelu_pytorch_tanh",
                   rms_norm_eps=1e-6, tie_word_embeddings=True), 2e-4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _hf(name, **over):
    cfg_cls, model_cls, extra, _ = FAMILIES[name]
    hf_cfg = getattr(hf, cfg_cls)(**{**SMALL, **extra, **over})
    torch.manual_seed(7)
    return hf_cfg, getattr(hf, model_cls)(hf_cfg).eval()


def _fields(cfg):
    """A config's fields, comparable across the packages (dtype aside; the
    rope scaling as its fields)."""
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"}
    if out["rope_scaling"] is not None:
        out["rope_scaling"] = dataclasses.asdict(out["rope_scaling"])
    return out


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


def _leaves(params):
    yield "embed", params["embed"]
    yield "final_norm", params["final_norm"]
    for i, layer in enumerate(params["layers"]):
        for k in sorted(layer):
            yield f"layers.{i}.{k}", layer[k]
    if "lm_head" in params:
        yield "lm_head", params["lm_head"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_params_equal_the_jax_loaders(name, dtype):
    hf_cfg, model = _hf(name)
    jcfg = dataclasses.replace(jh.config_from_hf(hf_cfg), dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(config_from_hf(hf_cfg), dtype=getattr(torch, dtype))
    sd = model.state_dict()
    jp, tp = jh.load_hf_state_dict(sd, jcfg), load_hf_state_dict(sd, tcfg, device="cpu")
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert list(jl) == list(tl)
    for key, t in tl.items():
        assert t.dtype == getattr(torch, dtype) and t.shape == jl[key].shape, key
        np.testing.assert_array_equal(_np(t), _np(jl[key]), err_msg=key)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_prefill_logits_match_transformers(name):
    hf_cfg, model = _hf(name)
    cfg = dataclasses.replace(config_from_hf(hf_cfg), dtype=torch.float32)
    params = load_hf_state_dict(model.state_dict(), cfg, device="cpu")
    batch, seq = 2, 12
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (batch, seq))
    with torch.no_grad():
        hf_logits = model(torch.tensor(tokens)).logits.numpy()
    pages = seq // PAGE_SIZE
    k_pages, v_pages = init_kv_pages(cfg, batch * pages + 1, PAGE_SIZE, "cpu")
    tables = torch.arange(batch * pages, dtype=torch.int32).view(batch, pages) + 1
    pos = torch.arange(seq, dtype=torch.int32).expand(batch, seq)
    page_ids = torch.gather(tables, 1, (pos // PAGE_SIZE).long())
    logits, _, _ = prefill(
        params, cfg, torch.from_numpy(tokens).int(), pos, torch.ones((batch, seq), dtype=torch.bool),
        k_pages, v_pages, page_ids, pos % PAGE_SIZE,
        torch.zeros((batch, 1), dtype=torch.int32), torch.zeros((batch,), dtype=torch.int32),
    )
    tol = FAMILIES[name][3]
    np.testing.assert_allclose(logits.numpy(), hf_logits[:, -1], rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_config_fields_equal_the_jax_loaders(name):
    hf_cfg, _ = _hf(name)
    jcfg, tcfg = jh.config_from_hf(hf_cfg), config_from_hf(hf_cfg)
    assert _fields(tcfg) == _fields(jcfg)
    assert tcfg.dtype == torch.bfloat16


REFUSED = {
    "gemma2": (lambda: hf.Gemma2Config(vocab_size=64, hidden_size=32, intermediate_size=64,
                                       num_hidden_layers=1, num_attention_heads=2,
                                       num_key_value_heads=2), NotImplementedError, "Gemma2"),
    "yarn_rope": (lambda: hf.LlamaConfig(**SMALL, rope_scaling={
        "rope_type": "yarn", "factor": 2.0, "original_max_position_embeddings": 64}),
        NotImplementedError, "yarn"),
    "mixed_dense_sparse": (lambda: hf.Qwen3MoeConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=2, num_experts=2, mlp_only_layers=[0]),
        NotImplementedError, "dense/sparse"),
    "shared_experts": (lambda: hf.Qwen2MoeConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=2, num_experts=2,
        shared_expert_intermediate_size=32), NotImplementedError, "shared-expert"),
    "hidden_act": (lambda: hf.LlamaConfig(**SMALL, hidden_act="relu"), ValueError,
                   "unsupported hidden_act 'relu'"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_config_from_hf_refuses_what_jax_refuses(case):
    make, exc, match = REFUSED[case]
    with pytest.raises(exc, match=match):
        jh.config_from_hf(make())
    with pytest.raises(exc, match=match):
        config_from_hf(make())
