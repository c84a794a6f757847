"""Carry the JAX package's parameters into the port.

``params_from_jax`` takes the JAX parameter tree with every leaf already
converted to a numpy array (``jax.tree.map(np.asarray, params)``) and
returns the port's dict of tensors on ``device`` — same keys, same
``[in, out]`` layout. JAX's bfloat16 arrays arrive as the ``ml_dtypes``
bfloat16 numpy type, which ``torch.from_numpy`` refuses; they are
reinterpreted through a ``uint16`` view, detected by dtype name so this
module needs no ``ml_dtypes`` import.

``train_state_from_jax`` carries a JAX training state (parameters, optax's Adam
moments and count) into AdamW, so a JAX run resumes in the port.

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


def train_state_from_jax(state: Any, cfg: LlamaConfig, device, lr: float = 1e-4):
    """Carry a JAX ``TrainState`` (numpy leaves: ``jax.tree.map(np.asarray,
    state)``) into the port's ``parallel.TrainState``: parameters through
    ``params_from_jax``, trainable, and optax's ``ScaleByAdamState`` —
    found in the optimizer state by its ``count``, ``mu`` and ``nu`` — as
    AdamW's ``step``, ``exp_avg`` and ``exp_avg_sq`` of each parameter, so
    a run started in the JAX package resumes in the port. A state taken
    from a JAX (dp, tp) mesh converts the same way (its numpy leaves are
    whole arrays); ``parallel.shard_train_state`` then places it on the
    port's mesh."""
    from ..parallel.train import TrainState, make_optimizer, param_leaves, trainable

    adam = [s for s in state.opt_state if all(hasattr(s, a) for a in ("count", "mu", "nu"))]
    if len(adam) != 1:
        raise ValueError("the optimizer state holds no single ScaleByAdamState (count, mu, nu)")
    adam = adam[0]
    params = trainable(params_from_jax(state.params, cfg, device))
    optimizer = make_optimizer(params, lr)
    count = float(np.asarray(adam.count))
    moments = zip(param_leaves(params), param_leaves(params_from_jax(adam.mu, cfg, device)),
                  param_leaves(params_from_jax(adam.nu, cfg, device)))
    for p, mu, nu in moments:
        # AdamW's own form of a step count: a float32 scalar on the host.
        optimizer.state[p] = {"step": torch.tensor(count, dtype=torch.float32),
                              "exp_avg": mu, "exp_avg_sq": nu}
    return TrainState(params=params, optimizer=optimizer, step=int(np.asarray(state.step)))
