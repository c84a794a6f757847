"""Device meshes for sharded serving and training, driven from one process.

The port of the JAX package's ``parallel/mesh.py``. JAX builds a
``jax.sharding.Mesh`` and runs one program on every device of it (GSPMD,
``shard_map``). Here one process, and one ``Engine``, drives every shard
of a mesh in Python loops: each shard's parameters and KV pools live on
that shard's ``torch.device``, and what crosses shards goes through the
mesh's ``Collective``:

- ``sp`` rows hold contiguous slices of a prefill chunk (ring attention,
  ``parallel/ring_attention.py``);
- ``tp`` columns hold slices of the heads, the experts and the vocabulary
  (``parallel/sharding.py``);
- ``dp`` replicas each hold a whole copy of the parameters and take an
  even slice of a training batch (``parallel/train.py``); serving runs one
  replica (an engine refuses a mesh with ``dp > 1``, as JAX's builds
  ``dp=1`` meshes only).

The devices fill a ``dp × sp × tp`` grid in JAX's axis order: replica ``d``
holds the ``sp × tp`` block ``devices[d*sp*tp : (d+1)*sp*tp]``, row-major.

The collective is chosen from the devices when the mesh is built and never
changes after:

- ``"same_device"``: every shard on one device (the CPU, or one GPU running
  every shard of the mesh). A sum is a float32 sum in shard order on that
  device, a gather a concatenation, a move a no-op.
- ``"nccl"``: every shard on its own CUDA device. Sums go through
  ``torch.cuda.nccl.reduce`` (single-process, multi-GPU NCCL) in float32
  onto the first shard's device, and training's gradient sums through
  ``torch.cuda.nccl.all_reduce``; gathers and the ring's moves are
  device-to-device copies. Not yet run on a machine with more than one GPU
  (the port's card has one), so this branch is untested on hardware.

Every collective is differentiable: ``sum``'s backward hands each part the
float32 gradient cast to the part's dtype, ``cat`` and ``move`` are plain
autograd ops. ``reduce_grads`` is training's gradient reduction: same-shaped
tensors that each receive their float32 sum, in a fixed order.

Any other layout (some devices shared, some not; a CPU beside a GPU) is
refused.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch


@dataclass
class MeshConfig:
    dp: int = 1
    tp: int = 1
    #: sequence-parallel degree (ring attention over the ``sp`` rows for
    #: long-context prefill; ``parallel/ring_attention.py``)
    sp: int = 1

    @property
    def n_devices(self) -> int:
        return self.dp * self.sp * self.tp


class Collective:
    """What crosses the shards of a mesh. ``sum`` and ``cat`` leave their
    result on the first part's device; ``move`` puts a tensor on a shard's
    device; ``reduce_grads`` sums same-shaped tensors into each of them."""

    name = ""

    def sum(self, parts: Sequence[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
        raise NotImplementedError

    def reduce_grads(self, parts: Sequence[torch.Tensor]) -> None:
        raise NotImplementedError

    def cat(self, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        if len(parts) == 1:
            return parts[0]
        return torch.cat([self.move(p, parts[0].device) for p in parts], dim=dim)

    def move(self, x: torch.Tensor, device: torch.device) -> torch.Tensor:
        return x.to(device, non_blocking=True)


class SameDevice(Collective):
    """Every shard on one device: the reductions are plain tensor ops."""

    name = "same_device"

    def sum(self, parts, dtype):
        # float32, in shard order: the same bits on every run (a bf16 part
        # is widened exactly by the promotion of the add). One part (a 1x1
        # mesh) is its own sum, with no float32 round trip.
        if len(parts) == 1:
            return parts[0].to(dtype)
        acc = parts[0].float()
        for p in parts[1:]:
            acc = acc + p
        return acc.to(dtype)

    def reduce_grads(self, parts):
        # The float32 sum in shard order, copied back into every part.
        if len(parts) < 2:
            return
        acc = parts[0].float()
        for p in parts[1:]:
            acc += p
        for p in parts:
            p.copy_(acc)

    def move(self, x, device):
        return x


class Nccl(Collective):
    """Every shard on its own CUDA device: sums by NCCL in float32 onto the
    first part's device. With two shards that is shard 0 + shard 1; with
    more, NCCL's own order."""

    name = "nccl"

    def sum(self, parts, dtype):
        return _NcclSum.apply(dtype, *parts)

    def reduce_grads(self, parts):
        if len(parts) < 2:
            return
        bufs = [p.float().contiguous() for p in parts]
        torch.cuda.nccl.all_reduce(bufs)
        for p, b in zip(parts, bufs):
            p.copy_(b)


class _NcclSum(torch.autograd.Function):
    """``torch.cuda.nccl.reduce`` of the parts in float32 onto the first
    part's device, cast to ``dtype``. Backward: the float32 gradient sent to
    every part's device, cast to that part's dtype."""

    @staticmethod
    def forward(ctx, dtype, *parts):
        ctx.meta = [(p.device, p.dtype) for p in parts]
        bufs = [p.detach().float().contiguous() for p in parts]
        torch.cuda.nccl.reduce(bufs, root=0)
        return bufs[0].to(dtype)

    @staticmethod
    def backward(ctx, grad):
        g = grad.float()
        return (None,) + tuple(g.to(device=d, dtype=t) for d, t in ctx.meta)


@dataclass
class Mesh:
    """A ``dp × sp × tp`` grid of devices (``replicas[d][r][t]``) and the
    collective chosen for them. ``grid`` is the first replica's ``sp × tp``
    grid (``grid[r][t]``), the one serving runs on."""

    config: MeshConfig
    grid: list[list[torch.device]]
    collective: Collective
    #: every replica's sp × tp grid; None means ``[grid]`` (one replica)
    replicas: Optional[list] = None

    def __post_init__(self):
        if self.replicas is None:
            self.replicas = [self.grid]

    def replica(self, d: int) -> "Mesh":
        """Replica ``d``'s ``sp × tp`` sub-mesh, sharing this mesh's
        collective."""
        if self.config.dp == 1:
            return self
        cfg = MeshConfig(dp=1, sp=self.config.sp, tp=self.config.tp)
        return Mesh(cfg, self.replicas[d], self.collective)

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": self.config.dp, "sp": self.config.sp, "tp": self.config.tp}

    @property
    def devices(self) -> list[torch.device]:
        """Every device of the mesh, replica by replica, row-major."""
        return [d for grid in self.replicas for row in grid for d in row]

    @property
    def root(self) -> torch.device:
        """The first shard's device: where a sharded call's inputs and
        outputs (the logits) live."""
        return self.grid[0][0]

    def describe(self) -> dict:
        """The mesh as ``/stats`` reports it."""
        return {"dp": self.config.dp, "tp": self.config.tp, "sp": self.config.sp,
                "devices": [str(d) for d in self.devices],
                "collective": self.collective.name}


@dataclass
class ShardedParams:
    """Per-shard parameter trees: ``shards[r][t]`` lives on
    ``mesh.grid[r][t]`` and holds tp shard ``t``'s slices (every sp row
    holds the same tp shards). ``parallel.shard_params`` makes them (views
    where a shard shares the tree's device); ``parallel.sharding.
    shard_train_params`` makes them for every replica, each shard with its
    own leaves (``replicas[d][r][t]``, on ``mesh.replicas[d][r][t]``;
    ``shards`` is ``replicas[0]``). ``specs`` is the spec tree they were
    split by (``param_specs``). The model treats a plain tree as the one
    shard of a 1x1 mesh."""

    mesh: Mesh
    shards: list
    specs: Any = None
    replicas: Optional[list] = None

    def __post_init__(self):
        if self.replicas is None:
            self.replicas = [self.shards]

    def row(self, r: int = 0) -> list:
        return self.shards[r]

    def replica(self, d: int) -> "ShardedParams":
        """Replica ``d``'s shards over its sub-mesh (``Mesh.replica``)."""
        if len(self.replicas) == 1:
            return self
        return ShardedParams(self.mesh.replica(d), self.replicas[d], self.specs)


def _collective_for(devices: list[torch.device]) -> Collective:
    if len(set(devices)) == 1:
        return SameDevice()
    if len(set(devices)) == len(devices) and all(d.type == "cuda" for d in devices):
        return Nccl()
    raise ValueError(
        f"a mesh's shards must all share one device or each sit on its own CUDA "
        f"device, got {[str(d) for d in devices]}"
    )


def _indexed(d: torch.device) -> torch.device:
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(config: Optional[MeshConfig] = None, devices=None) -> Mesh:
    """Build a (dp, sp, tp) mesh over ``devices`` (default: the first
    ``dp * sp * tp`` CUDA devices, never one of them twice). An explicit
    list may repeat a device: every shard then runs on it."""
    cfg = config or MeshConfig()
    if min(cfg.dp, cfg.sp, cfg.tp) < 1:
        raise ValueError(f"mesh axes must be >= 1, got dp={cfg.dp}, sp={cfg.sp}, tp={cfg.tp}")
    if devices is None:
        n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n_cuda)]
    devices = [_indexed(torch.device(d)) for d in devices]
    if len(devices) < cfg.n_devices:
        raise ValueError(
            f"mesh needs {cfg.n_devices} devices (dp={cfg.dp} × sp={cfg.sp} "
            f"× tp={cfg.tp}), have {len(devices)}"
        )
    devices = devices[: cfg.n_devices]
    block = cfg.sp * cfg.tp
    replicas = [
        [devices[d * block + r * cfg.tp : d * block + (r + 1) * cfg.tp] for r in range(cfg.sp)]
        for d in range(cfg.dp)
    ]
    return Mesh(cfg, replicas[0], _collective_for(devices), replicas)
