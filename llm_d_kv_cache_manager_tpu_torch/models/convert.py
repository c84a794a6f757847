"""Carry the JAX package's parameters into the port.

``params_from_jax`` takes the JAX parameter tree with every leaf already
converted to a numpy array (``jax.tree.map(np.asarray, params)``) and
returns the port's dict of tensors on ``device`` — same keys, same
``[in, out]`` layout. JAX's bfloat16 arrays arrive as the ``ml_dtypes``
bfloat16 numpy type, which ``torch.from_numpy`` refuses; they are
reinterpreted through a ``uint16`` view, detected by dtype name so this
module needs no ``ml_dtypes`` import.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .llama import LlamaConfig, Params


def _to_tensor(a: Any, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_jax(tree: dict, cfg: LlamaConfig, device) -> Params:
    """Convert a dense JAX Llama parameter tree (numpy leaves) for ``cfg``."""
    def leaf(a):
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
