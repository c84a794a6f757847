"""Device meshes for sharded serving, driven from one process.

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
- ``dp`` (replicas of a training batch) belongs to mesh training and is
  not ported.

The collective is chosen from the devices when the mesh is built and never
changes after:

- ``"same_device"``: every shard on one device (the CPU, or one GPU running
  every shard of the mesh). A sum is a float32 sum in shard order on that
  device, a gather a concatenation, a move a no-op.
- ``"nccl"``: every shard on its own CUDA device. Sums go through
  ``torch.cuda.nccl.reduce`` (single-process, multi-GPU NCCL) in float32
  onto the first shard's device; gathers and the ring's moves are
  device-to-device copies. Not yet run on a card with more than one GPU.

Any other layout (some devices shared, some not; a CPU beside a GPU) is
refused.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

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
    device."""

    name = ""

    def sum(self, parts: Sequence[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
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

    def move(self, x, device):
        return x


class Nccl(Collective):
    """Every shard on its own CUDA device: sums by NCCL in float32 onto the
    first part's device. With two shards that is shard 0 + shard 1; with
    more, NCCL's own order."""

    name = "nccl"

    def sum(self, parts, dtype):
        bufs = [p.float().contiguous() for p in parts]
        torch.cuda.nccl.reduce(bufs, root=0)
        return bufs[0].to(dtype)


@dataclass
class Mesh:
    """An ``sp`` × ``tp`` grid of devices (``grid[r][t]``) and the
    collective chosen for them."""

    config: MeshConfig
    grid: list[list[torch.device]]
    collective: Collective

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": self.config.dp, "sp": self.config.sp, "tp": self.config.tp}

    @property
    def devices(self) -> list[torch.device]:
        return [d for row in self.grid for d in row]

    @property
    def root(self) -> torch.device:
        """The first shard's device: where a sharded call's inputs and
        outputs (the logits) live."""
        return self.grid[0][0]

    def describe(self) -> dict:
        """The mesh as ``/stats`` reports it."""
        return {"tp": self.config.tp, "sp": self.config.sp,
                "devices": [str(d) for d in self.devices],
                "collective": self.collective.name}


@dataclass
class ShardedParams:
    """Per-shard parameter trees: ``shards[r][t]`` lives on
    ``mesh.grid[r][t]`` and holds tp shard ``t``'s slices (every sp row
    holds the same tp shards). ``parallel.shard_params`` makes them; the
    model treats a plain tree as the one shard of a 1x1 mesh."""

    mesh: Mesh
    shards: list

    def row(self, r: int = 0) -> list:
        return self.shards[r]


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
    """Build an (sp, tp) mesh over ``devices`` (default: the first
    ``sp * tp`` CUDA devices, never one of them twice). An explicit list
    may repeat a device: every shard then runs on it."""
    cfg = config or MeshConfig()
    if cfg.dp != 1:
        raise NotImplementedError("dp > 1 is mesh training, which is not ported")
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
    grid = [devices[r * cfg.tp : (r + 1) * cfg.tp] for r in range(cfg.sp)]
    return Mesh(cfg, grid, _collective_for(devices))
