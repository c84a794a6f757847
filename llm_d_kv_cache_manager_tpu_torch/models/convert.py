"""Carry the JAX package's parameters into the port.

``params_from_jax`` takes the JAX parameter tree with every leaf already
converted to a numpy array (``jax.tree.map(np.asarray, params)``) and
returns the port's dict of tensors on ``device`` — same keys, same
``[in, out]`` layout. JAX's bfloat16 arrays arrive as the ``ml_dtypes``
bfloat16 numpy type, which ``torch.from_numpy`` refuses; they are
reinterpreted through a ``uint16`` view, detected by dtype name so this
module needs no ``ml_dtypes`` import.

``kv_pools_from_jax`` carries a JAX engine's KV pools (numpy), int8 codes
and scales included, so both packages can decode from one pool state.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .llama import LlamaConfig, Params
from .quant import QuantizedTensor


def _to_tensor(a: Any, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_jax(tree: dict, cfg: LlamaConfig, device) -> Params:
    """Convert a JAX Llama parameter tree (numpy leaves) for ``cfg``: dense
    or MoE (3-D expert stacks, ``router``, ``q_norm``/``k_norm``), full
    precision or int8. A JAX ``QuantizedTensor`` leaf — recognised by its
    ``q`` and ``scale`` attributes, since this package imports nothing of
    the JAX one — becomes the port's, with int8 codes and f32 scales."""
    def leaf(a):
        if hasattr(a, "q") and hasattr(a, "scale"):
            q, scale = _to_tensor(a.q, device), _to_tensor(a.scale, device)
            if q.dtype != torch.int8 or scale.dtype != torch.float32:
                raise ValueError(f"quantized leaf must be int8 codes and float32 scales, got {q.dtype}, {scale.dtype}")
            return QuantizedTensor(q=q, scale=scale)
        t = _to_tensor(a, device)
        if t.dtype != cfg.dtype:
            raise ValueError(f"parameter dtype {t.dtype} does not match cfg.dtype {cfg.dtype}")
        return t

    params: Params = {
        "embed": leaf(tree["embed"]),
        "final_norm": leaf(tree["final_norm"]),
        "layers": [{k: leaf(v) for k, v in layer.items()} for layer in tree["layers"]],
    }
    if len(params["layers"]) != cfg.n_layers:
        raise ValueError(f"tree has {len(params['layers'])} layers, cfg.n_layers={cfg.n_layers}")
    if not cfg.tie_word_embeddings:
        params["lm_head"] = leaf(tree["lm_head"])
    return params


def kv_pools_from_jax(
    k_pages: Any,
    v_pages: Any,
    k_scales: Optional[Any] = None,
    v_scales: Optional[Any] = None,
    *,
    device,
) -> tuple[torch.Tensor, ...]:
    """A JAX engine's page pools ``[L, P, ps, n_kv, hd]`` (numpy: bf16,
    f32 or int8 codes) as tensors on ``device``: ``(k_pages, v_pages)``, or
    with the f32 scale pools ``[L, P, n_kv]`` of an int8 pool,
    ``(k_pages, v_pages, k_scales, v_scales)``."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be passed together")
    pools = [_to_tensor(a, device) for a in (k_pages, v_pages)]
    if k_scales is None:
        return tuple(pools)
    if pools[0].dtype != torch.int8:
        raise ValueError(f"scales come with int8 pools, got {pools[0].dtype}")
    scales = [_to_tensor(a, device) for a in (k_scales, v_scales)]
    if scales[0].dtype != torch.float32 or scales[0].shape != pools[0].shape[:2] + pools[0].shape[3:4]:
        raise ValueError(f"scales must be float32 [L, P, n_kv], got {scales[0].dtype} {tuple(scales[0].shape)}")
    return tuple(pools + scales)
