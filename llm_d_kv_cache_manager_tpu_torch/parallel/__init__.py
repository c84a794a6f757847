from .checkpoint import (
    load_params,
    load_train_state,
    save_params,
    save_train_state,
)
from .mesh import Mesh, MeshConfig, ShardedParams, make_mesh
from .ring_attention import ring_attention, ring_attention_shards
from .sharding import (
    init_kv_pools,
    kv_pages_sharding,
    param_specs,
    shard_kv_pools,
    shard_params,
)
from .train import TrainState, loss_fn, make_optimizer, make_train_state, train_step

__all__ = [
    "load_params",
    "load_train_state",
    "save_params",
    "save_train_state",
    "Mesh",
    "MeshConfig",
    "make_mesh",
    "ring_attention",
    "ring_attention_shards",
    "ShardedParams",
    "init_kv_pools",
    "kv_pages_sharding",
    "param_specs",
    "shard_kv_pools",
    "shard_params",
    "TrainState",
    "loss_fn",
    "make_optimizer",
    "make_train_state",
    "train_step",
]
