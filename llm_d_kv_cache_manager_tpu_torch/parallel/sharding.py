"""Sharding rules: the Megatron tensor-parallel layout, as specs and as
per-shard tensors.

The port of the JAX package's ``parallel/sharding.py``. A spec is a tuple
with one entry per axis, ``"tp"`` on the axis split over the mesh's tp
columns and None elsewhere (JAX's ``PartitionSpec``); ``()`` replicates.
Layout per transformer block:

- ``wq/wk/wv``           column-parallel: output dim split
- ``wo``                 row-parallel: input dim split (the partial sums
  are reduced after the contraction)
- ``w_gate/w_up``        column-parallel
- ``w_down``             row-parallel
- norms, ``q_norm``/``k_norm`` and the router replicated; biases of
  column-parallel layers split with their outputs
- MoE expert stacks: whole experts per shard (``[E/tp, d, f]``) when tp
  divides the expert count, else the intermediate dim split
- ``embed``/``lm_head``  the vocabulary split
- KV pools               ``n_kv_heads`` split (and the int8 scale pools'
  last axis)

An int8 ``QuantizedTensor``'s scale follows its codes, with the size-1
contraction axis replicated. A split must be even, as in JAX.

``shard_params`` gives each shard its tensors on its own device. Where the
shard's device is the one the tree already lives on, a shard is a view of
the tree, not a copy: a mesh whose shards share one device holds the
weights once. ``shard_train_params`` gives every (dp, sp, tp) shard its
own contiguous leaves instead (a view cannot hold its own ``.grad``, and
shards on distinct devices are leaves anyway), so one training path serves
one device and many; ``gather_params`` is its inverse. Token batches split
evenly over the dp replicas (``batch_sharding``, ``shard_batch``).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..models.llama import LlamaConfig, Params
from ..models.quant import QuantizedTensor
from .mesh import Mesh, ShardedParams

Spec = tuple


def _layer_specs(cfg: LlamaConfig, tp: int = 1) -> dict[str, Spec]:
    specs = {
        "attn_norm": (),
        "wq": (None, "tp"),
        "wk": (None, "tp"),
        "wv": (None, "tp"),
        "wo": ("tp", None),
        "mlp_norm": (),
        "w_gate": (None, "tp"),
        "w_up": (None, "tp"),
        "w_down": ("tp", None),
    }
    if cfg.n_experts:
        # Expert-parallel when tp divides the expert count, else the
        # expert-intermediate dim split (the dense dispatch's layout).
        specs["router"] = ()
        if cfg.n_experts % tp == 0:
            specs["w_gate"] = ("tp", None, None)
            specs["w_up"] = ("tp", None, None)
            specs["w_down"] = ("tp", None, None)
        else:
            specs["w_gate"] = (None, None, "tp")
            specs["w_up"] = (None, None, "tp")
            specs["w_down"] = (None, "tp", None)
    if cfg.qkv_bias:
        specs["bq"] = ("tp",)
        specs["bk"] = ("tp",)
        specs["bv"] = ("tp",)
    if cfg.qk_norm:
        specs["q_norm"] = ()
        specs["k_norm"] = ()
    return specs


def param_specs(cfg: LlamaConfig, tp: int = 1) -> dict[str, Any]:
    """The spec tree matching ``init_params``' structure."""
    specs: dict[str, Any] = {
        "embed": ("tp", None),
        "final_norm": (),
        "layers": [_layer_specs(cfg, tp) for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = (None, "tp")
    return specs


def batch_sharding() -> Spec:
    """Token batches ``[b, s]``: the batch split over the dp replicas,
    every tp shard of a replica holding its whole slice."""
    return ("dp",)


def shard_batch(tokens: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """Replica ``d``'s even slice of the batch, on its first device. An
    uneven split raises, as JAX's ``device_put`` does."""
    dp = mesh.shape["dp"]
    b = tokens.shape[0]
    if b % dp:
        raise ValueError(f"batch of {b} does not split evenly over dp={dp}")
    n = b // dp
    return [tokens[d * n : (d + 1) * n].to(mesh.replicas[d][0][0]) for d in range(dp)]


def kv_pages_sharding() -> Spec:
    """KV pools ``[n_layers, pages, page_size, n_kv_heads, hd]``: head-parallel."""
    return (None, None, None, "tp")


def kv_scales_sharding() -> Spec:
    """int8 scale pools ``[n_layers, pages, n_kv_heads]``: with their pages."""
    return (None, None, "tp")


def _split(x: torch.Tensor, spec: Spec, t: int, tp: int, name: str) -> torch.Tensor:
    if "tp" not in spec:
        return x
    axis = spec.index("tp")
    n = x.shape[axis]
    if n % tp:
        raise ValueError(
            f"{name}: dimension {axis} of shape {tuple(x.shape)} is not divisible by tp={tp}"
        )
    return x.narrow(axis, t * (n // tp), n // tp)


def shard_leaf(x: Any, spec: Spec, t: int, tp: int, name: str = "tensor") -> Any:
    """Shard ``t`` of ``tp`` of one parameter under ``spec`` (a view)."""
    if isinstance(x, QuantizedTensor):
        entries = list(spec) + [None] * (x.ndim - len(spec))
        scale_entries = list(entries)
        scale_entries[-2] = None  # the size-1 contraction axis
        return QuantizedTensor(
            q=_split(x.q, tuple(entries), t, tp, name),
            scale=_split(x.scale, tuple(scale_entries), t, tp, name),
        )
    return _split(x, spec, t, tp, name)


def _to(x: Any, device: torch.device) -> Any:
    if isinstance(x, QuantizedTensor):
        return QuantizedTensor(q=x.q.to(device), scale=x.scale.to(device))
    return x.to(device)


def _own(x: Any, device: torch.device) -> Any:
    """A fresh contiguous copy of ``x`` on ``device`` that requires no
    grad (read through once: a slice of a memory-mapped tensor is paged
    in, nothing more)."""
    if isinstance(x, QuantizedTensor):
        return QuantizedTensor(q=_own(x.q, device), scale=_own(x.scale, device))
    return torch.empty(x.shape, dtype=x.dtype, device=device).copy_(x.detach())


def _map_tree(node: Any, spec: Any, fn, name: str = "params") -> Any:
    """``fn(leaf, spec, name)`` over a tree and the spec tree beside it
    (dicts by key, lists by position)."""
    if isinstance(node, dict):
        missing = set(node) - set(spec)
        if missing:
            raise ValueError(f"no sharding spec for {sorted(missing)}")
        return {k: _map_tree(v, spec[k], fn, k) for k, v in node.items()}
    if isinstance(node, list):
        return [_map_tree(v, s, fn, name) for v, s in zip(node, spec)]
    return fn(node, spec, name)


def leaf_specs(params: Any, specs: Any) -> list[Spec]:
    """The spec of every leaf of ``params``, in ``param_leaves`` order."""
    out: list = []
    _map_tree(params, specs, lambda x, s, n: out.append(s))
    return out


def shard_params(params: Params, mesh: Mesh, cfg: LlamaConfig) -> ShardedParams:
    """Place a parameter tree onto the mesh: each shard's slices on its
    device (views where that is the tree's own device)."""
    if isinstance(params, ShardedParams):
        if params.mesh is not mesh and params.mesh.grid != mesh.grid:
            raise ValueError("params are sharded over another mesh")
        return params
    tp = mesh.shape["tp"]
    specs = param_specs(cfg, tp)

    def tree(node, spec, t, device):
        return _map_tree(node, spec, lambda x, s, n: _to(shard_leaf(x, s, t, tp, n), device))

    if len(params["layers"]) != cfg.n_layers:
        raise ValueError(f"params have {len(params['layers'])} layers, cfg {cfg.n_layers}")
    first = [tree(params, specs, t, mesh.grid[0][t]) for t in range(tp)]
    shards = [first]
    for r in range(1, mesh.shape["sp"]):
        shards.append([tree(first[t], _replicated(specs), 0, mesh.grid[r][t]) for t in range(tp)])
    return ShardedParams(mesh, shards, specs)


def shard_train_params(params: Params, mesh: Mesh, cfg: LlamaConfig) -> ShardedParams:
    """Place a parameter tree onto every replica of the mesh, each (dp, sp,
    tp) shard with its own contiguous leaves on its device (replicated
    leaves copied to every shard): the form training and the checkpoint
    restores use. Serves as well as ``shard_params``' trees."""
    if isinstance(params, ShardedParams):
        raise ValueError("params are already sharded: gather_params them first")
    if len(params["layers"]) != cfg.n_layers:
        raise ValueError(f"params have {len(params['layers'])} layers, cfg {cfg.n_layers}")
    tp = mesh.shape["tp"]
    specs = param_specs(cfg, tp)
    replicas = [
        [
            [_map_tree(params, specs, lambda x, s, n, t=t, dev=dev: _own(shard_leaf(x, s, t, tp, n), dev))
             for t, dev in enumerate(row)]
            for row in grid
        ]
        for grid in mesh.replicas
    ]
    return ShardedParams(mesh, replicas[0], specs, replicas)


def gather_leaf(parts: list, spec: Spec, device: torch.device) -> Any:
    """One leaf whole on ``device``, a fresh tensor, from its tp shards'
    slices (a copy of the first shard's for a replicated leaf)."""
    if isinstance(parts[0], QuantizedTensor):
        entries = list(spec) + [None] * (parts[0].ndim - len(spec))
        scale_entries = list(entries)
        scale_entries[-2] = None
        return QuantizedTensor(q=gather_leaf([p.q for p in parts], tuple(entries), device),
                               scale=gather_leaf([p.scale for p in parts], tuple(scale_entries), device))
    if "tp" not in spec:
        return parts[0].to(device, copy=True)
    return torch.cat([p.to(device) for p in parts], dim=spec.index("tp"))


def gather_params(sharded: ShardedParams, device: Optional[torch.device] = None) -> Params:
    """The inverse of ``shard_params`` / ``shard_train_params``: the whole
    tree on ``device`` (default: the first shard's), from the first
    replica's first row, in fresh tensors that require no grad."""
    device = device or sharded.mesh.root
    row = sharded.shards[0]
    leaves = [
        gather_leaf([_detached(x) for x in parts], spec, device)
        for parts, spec in zip(zip(*(_leaves(tree) for tree in row)),
                               leaf_specs(row[0], sharded.specs))
    ]
    return _unflatten(row[0], iter(leaves))


def _detached(x: Any) -> Any:
    if isinstance(x, QuantizedTensor):
        return QuantizedTensor(q=x.q.detach(), scale=x.scale.detach())
    return x.detach()


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _unflatten(like: Any, leaves) -> Any:
    """A tree shaped like ``like`` whose leaves are taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves) for k, v in like.items()}
    if isinstance(like, list):
        return [_unflatten(v, leaves) for v in like]
    return next(leaves)


def _replicated(spec: Any) -> Any:
    if isinstance(spec, dict):
        return {k: _replicated(v) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_replicated(v) for v in spec]
    return ()


def shard_kv_pools(pools: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """A page pool (5-D) or scale pool (3-D) split into one contiguous
    tensor per tp shard, on the devices of the mesh's first sp row (the
    pools' owners)."""
    tp = mesh.shape["tp"]
    spec = kv_pages_sharding() if pools.dim() == 5 else kv_scales_sharding()
    return [_split(pools, spec, t, tp, "kv pool").to(mesh.grid[0][t]).contiguous()
            for t in range(tp)]


def gather_kv_pools(pools: list[torch.Tensor]) -> torch.Tensor:
    """The inverse of ``shard_kv_pools``: the whole pool on the first
    shard's device."""
    axis = 3 if pools[0].dim() == 5 else 2
    return torch.cat([p.to(pools[0].device) for p in pools], dim=axis)


def init_kv_pools(
    cfg: LlamaConfig, total_pages: int, page_size: int, mesh: Mesh,
    kv_quant_hbm: Optional[str] = None,
) -> tuple[list, list, Optional[list], Optional[list]]:
    """Zeroed per-shard K and V page pools ``[L, P, ps, n_kv/tp, hd]`` (and
    for int8 pages scale pools ``[L, P, n_kv/tp]``, else None), shard ``t``
    on ``mesh.grid[0][t]``."""
    tp = mesh.shape["tp"]
    if cfg.n_kv_heads % tp:
        raise ValueError(f"tp={tp} must divide n_kv_heads={cfg.n_kv_heads}")
    n_kv = cfg.n_kv_heads // tp
    dtype = torch.int8 if kv_quant_hbm == "int8" else cfg.dtype
    shape = (cfg.n_layers, total_pages, page_size, n_kv, cfg.hd)
    devs = mesh.grid[0]
    k = [torch.zeros(shape, dtype=dtype, device=d) for d in devs]
    v = [torch.zeros(shape, dtype=dtype, device=d) for d in devs]
    if kv_quant_hbm != "int8":
        return k, v, None, None
    sshape = (cfg.n_layers, total_pages, n_kv)
    ks = [torch.zeros(sshape, dtype=torch.float32, device=d) for d in devs]
    vs = [torch.zeros(sshape, dtype=torch.float32, device=d) for d in devs]
    return k, v, ks, vs
