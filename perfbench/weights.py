"""Random weights from the run's seed, in the port's parameter layout.

The tree is the port's: ``embed``, ``final_norm`` and the head at the top,
and a dict a layer under ``layers``; the architecture's ``block_specs``
names each block's tensors with their shapes and fan-ins
(``architectures/``). Each block (block 0 the embedding, head and final
norm; block i + 1 layer i) is one buffer in the served dtype, filled by
one ``normal_`` call from a generator on the device seeded from (seed,
block); every tensor with a fan-in is then scaled by fan_in^-0.5 and every
norm set to 1. A block can be drawn again alone, which is how the
reference gets its weights after the program's are freed.
"""

from __future__ import annotations

import hashlib
from types import ModuleType
from typing import Optional

import torch

from .model import Dims

#: every tensor starts at a multiple of this many elements of its block
#: (512 bytes in bf16: the TMA descriptors of the grouped matmul want 16)
ALIGN = 256


def _layout(specs) -> tuple[list[tuple[str, tuple, Optional[int], int]], int]:
    out, off = [], 0
    for name, shape, fan in specs:
        n = 1
        for s in shape:
            n *= s
        out.append((name, shape, fan, off))
        off += -(-n // ALIGN) * ALIGN
    return out, off


def block_seed(seed: int, block: int) -> int:
    digest = hashlib.sha256(f"{seed}/{block}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def fill_block(arch: ModuleType, m: Dims, seed: int, block: int,
               buf: torch.Tensor) -> dict[str, torch.Tensor]:
    """Draw block ``block`` of architecture ``arch`` into ``buf`` (its
    flat buffer) and return its tensors, views of ``buf``."""
    layout, _ = _layout(arch.block_specs(m, block))
    gen = torch.Generator(device=buf.device).manual_seed(block_seed(seed, block))
    buf.normal_(0.0, 1.0, generator=gen)
    out = {}
    for name, shape, fan, off in layout:
        n = 1
        for s in shape:
            n *= s
        t = buf[off : off + n].view(shape)
        if fan is None:
            t.fill_(1.0)
        else:
            t.mul_(fan**-0.5)
        out[name] = t
    return out


def dtype_of(m: Dims) -> torch.dtype:
    return getattr(torch, m.dtype)


def draw_block(arch: ModuleType, m: Dims, seed: int, block: int, device) -> dict[str, torch.Tensor]:
    """Block ``block`` alone, in a buffer of its own."""
    _, n = _layout(arch.block_specs(m, block))
    buf = torch.empty(n, dtype=dtype_of(m), device=device)
    return fill_block(arch, m, seed, block, buf)


class Weights:
    """Every block of a model, and the port's tree of views into them."""

    def __init__(self, arch: ModuleType, m: Dims, seed: int, device):
        self.arch, self.m = arch, m
        self.buffers = [
            torch.empty(_layout(arch.block_specs(m, b))[1], dtype=dtype_of(m), device=device)
            for b in range(m.layers + 1)
        ]
        self.params = self._fill(seed)

    def _fill(self, seed: int) -> dict:
        blocks = [fill_block(self.arch, self.m, seed, b, buf) for b, buf in enumerate(self.buffers)]
        params = dict(blocks[0])
        params["layers"] = blocks[1:]
        return params

    def refill(self, seed: int) -> None:
        """Draw another seed's weights into the same buffers: whatever
        holds views of them (the engine, its captured graphs) now sees the
        new weights."""
        self._fill(seed)

    @property
    def bytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.buffers)
