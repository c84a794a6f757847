"""Checkpoint save/restore for model weights and train state — the port of
the JAX package's ``parallel/checkpoint.py``, with ``torch.save`` in place
of orbax (no orbax counterpart exists, and the card's machine has no
``safetensors``).

A checkpoint is one file. Tensors are saved detached, on the device they
were on, and restored onto ``device``; loads use
``torch.load(weights_only=True)``, so a checkpoint holds tensors, numbers,
strings, lists and dicts only. An int8 ``QuantizedTensor`` is saved as a
plain ``{"q", "scale"}`` dict and rebuilt from ``cfg`` and ``quantize``:
pass the ``quantize`` the params were made with, as in JAX. The train state
holds the parameters, AdamW's state dict (its moments in each parameter's
dtype) and the step.

Meshes. A save from sharded params or a sharded train state gathers them
first (``sharding.gather_params``, ``train.gather_train_state``) into the
same one-file format: the same keys, the same ``param_leaves`` order and
the same optimizer state-dict layout, so a file does not record how it was
sharded (as orbax's does not). ``load_params(..., mesh=)`` and
``load_train_state(..., mesh=)`` read the file memory-mapped on the host
and put each shard's slice straight on its device
(``sharding.shard_train_params``): int8 codes follow their weight's spec
and their scales too, with the size-1 contraction axis replicated; AdamW's
moments follow their parameters and the step count is replicated. No whole
tensor is materialised on one device (JAX's "each host reads only its
shard").
"""

from __future__ import annotations

import os
from typing import Any, Optional, Union

import torch

from ..models.llama import LlamaConfig, Params
from ..models.quant import QuantizedTensor
from .mesh import ShardedParams
from .sharding import gather_params, shard_train_params
from .train import TrainState, gather_train_state, make_optimizer, sharded_train_state, trainable

Device = Union[torch.device, str]


def _to_saved(tree: Any) -> Any:
    if isinstance(tree, QuantizedTensor):
        return {"q": tree.q.detach(), "scale": tree.scale.detach()}
    if isinstance(tree, dict):
        return {k: _to_saved(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_saved(v) for v in tree]
    return tree.detach()


def _write(path: str, obj: Any) -> None:
    """``torch.save`` to a temporary name, then rename: a checkpoint is
    never seen half written."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _read(path: str, device: Device, mesh=None) -> Any:
    """The file's tree on ``device``, or, for a restore onto ``mesh``,
    memory-mapped on the host (sliced by the caller, a shard at a time)."""
    if mesh is not None:
        return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True, mmap=True)
    return torch.load(os.path.abspath(path), map_location=device, weights_only=True)


def _rebuild(tree: Params, cfg: Optional[LlamaConfig], quantize: Optional[str]) -> Params:
    """With ``cfg``: check the tree against it and turn ``{"q", "scale"}``
    dicts back into ``QuantizedTensor``s, which only ``quantize="int8"``
    allows. Without ``cfg`` the tree is returned as saved (a JAX restore
    with no target likewise flattens its containers into dicts)."""
    if cfg is None:
        return tree
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"checkpoint has {len(tree['layers'])} layers, cfg.n_layers={cfg.n_layers}")
    if ("lm_head" in tree) == cfg.tie_word_embeddings:
        raise ValueError("checkpoint's lm_head does not match cfg.tie_word_embeddings")

    def leaf(name: str, v):
        if isinstance(v, dict):
            if quantize != "int8":
                raise ValueError(f"{name} is int8 in the checkpoint: pass quantize='int8'")
            return QuantizedTensor(q=v["q"], scale=v["scale"])
        return v

    out = {k: leaf(k, v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [{k: leaf(k, v) for k, v in layer.items()} for layer in tree["layers"]]
    return {k: out[k] for k in tree}


def save_params(path: str, params: Params) -> None:
    """Save a parameter tree (full precision or int8) to ``path``; sharded
    params are gathered first."""
    if isinstance(params, ShardedParams):
        params = gather_params(params)
    _write(path, _to_saved(params))


def load_params(
    path: str,
    cfg: Optional[LlamaConfig] = None,
    quantize: Optional[str] = None,
    device: Device = "cuda",
    *,
    mesh=None,
) -> Params:
    """Restore a parameter tree onto ``device``. The tensors require no
    grad, so the result can be served directly. With ``cfg`` the tree is
    checked against it and int8 weights come back as ``QuantizedTensor``s
    (``quantize="int8"``, as they were saved). With ``mesh`` (and ``cfg``)
    each shard's slices go straight onto its device
    (``sharding.shard_train_params``' trees, every replica's; ``device`` is
    then unused)."""
    if mesh is None:
        return _rebuild(_read(path, device), cfg, quantize)
    if cfg is None:
        raise ValueError("a restore onto a mesh needs cfg (the sharding specs come from it)")
    return shard_train_params(_rebuild(_read(path, device, mesh), cfg, quantize), mesh, cfg)


def save_train_state(path: str, state: TrainState) -> None:
    """Save a train state; a sharded one is gathered first
    (``train.gather_train_state``), so the file equals a mesh-free save of
    the gathered state."""
    if isinstance(state.params, ShardedParams):
        state = gather_train_state(state)
    _write(path, {
        "params": _to_saved(state.params),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
    })


def load_train_state(
    path: str,
    cfg: LlamaConfig,
    lr: float = 1e-4,
    device: Device = "cuda",
    mesh=None,
) -> TrainState:
    """Restore a train state onto ``device``: trainable parameters, an
    AdamW at ``lr`` holding the saved moments and step counts, and the
    step. With ``mesh`` every shard's slice of the parameters and of their
    moments goes straight onto its device (``device`` is then unused)."""
    if mesh is not None:
        saved = _read(path, device, mesh)
        params = _rebuild(saved["params"], cfg, None)
        opt = saved["optimizer"]
        n = len(opt["param_groups"][0]["params"])
        moments = [opt["state"].get(i) for i in range(n)]
        group = {k: v for k, v in opt["param_groups"][0].items() if k != "params"}
        return sharded_train_state(params, moments, dict(group, lr=lr), saved["step"], mesh, cfg)
    saved = _read(path, device)
    params = trainable(_rebuild(saved["params"], cfg, None))
    optimizer = make_optimizer(params, lr)
    optimizer.load_state_dict(saved["optimizer"])
    for state in optimizer.state.values():
        # AdamW keeps a step count on the host unless capturable or fused;
        # the restore put it on ``device``.
        state["step"] = state["step"].cpu()
    for group in optimizer.param_groups:
        group["lr"] = lr
    return TrainState(params=params, optimizer=optimizer, step=saved["step"])
