"""Random weights from the run's seed, in the port's parameter layout.

The tree is the port's (``embed`` [V, d], ``lm_head`` [d, V],
``final_norm``, and per layer ``attn_norm``, ``wq`` / ``wk`` / ``wv`` /
``wo`` as [in, out], ``q_norm`` / ``k_norm``, ``mlp_norm``, then either
``router`` [d, E] with ``w_gate`` / ``w_up`` [E, d, f] and ``w_down``
[E, f, d], or dense ``w_gate`` / ``w_up`` [d, f] and ``w_down`` [f, d]).
Each block (block 0 the embedding, head and final norm; block i + 1
layer i) is one buffer in the served dtype, filled by one ``normal_`` call
from a generator on the device seeded from (seed, block); every matrix is
then scaled by fan_in^-0.5 and every norm set to 1. A block can be drawn
again alone, which is how the reference gets its weights after the
program's are freed.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import torch

from .model import Dims

#: every tensor starts at a multiple of this many elements of its block
#: (512 bytes in bf16: the TMA descriptors of the grouped matmul want 16)
ALIGN = 256


def block_specs(m: Dims, block: int) -> list[tuple[str, tuple[int, ...], Optional[int]]]:
    """(name, shape, fan_in) of each tensor of a block; fan_in None = a norm."""
    if block == 0:
        specs = [("embed", (m.vocab, m.d), m.d), ("final_norm", (m.d,), None)]
        if not m.tie:
            specs.append(("lm_head", (m.d, m.vocab), m.d))
        return specs
    d, hd, nq, nkv = m.d, m.hd, m.heads, m.kv_heads
    specs = [
        ("attn_norm", (d,), None),
        ("wq", (d, nq * hd), d),
        ("wk", (d, nkv * hd), d),
        ("wv", (d, nkv * hd), d),
        ("wo", (nq * hd, d), nq * hd),
        ("mlp_norm", (d,), None),
    ]
    if m.qk_norm:
        specs += [("q_norm", (hd,), None), ("k_norm", (hd,), None)]
    if m.experts:
        e, f = m.experts, m.moe_inter
        specs += [("router", (d, e), d), ("w_gate", (e, d, f), d),
                  ("w_up", (e, d, f), d), ("w_down", (e, f, d), f)]
    else:
        specs += [("w_gate", (d, m.inter), d), ("w_up", (d, m.inter), d),
                  ("w_down", (m.inter, d), m.inter)]
    return specs


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


def fill_block(m: Dims, seed: int, block: int, buf: torch.Tensor) -> dict[str, torch.Tensor]:
    """Draw block ``block`` into ``buf`` (its flat buffer) and return its
    tensors, views of ``buf``."""
    layout, _ = _layout(block_specs(m, block))
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


def draw_block(m: Dims, seed: int, block: int, device) -> dict[str, torch.Tensor]:
    """Block ``block`` alone, in a buffer of its own."""
    _, n = _layout(block_specs(m, block))
    buf = torch.empty(n, dtype=dtype_of(m), device=device)
    return fill_block(m, seed, block, buf)


class Weights:
    """Every block of a model, and the port's tree of views into them."""

    def __init__(self, m: Dims, seed: int, device):
        self.m = m
        self.buffers = [
            torch.empty(_layout(block_specs(m, b))[1], dtype=dtype_of(m), device=device)
            for b in range(m.layers + 1)
        ]
        self.params = self._fill(seed)

    def _fill(self, seed: int) -> dict:
        blocks = [fill_block(self.m, seed, b, buf) for b, buf in enumerate(self.buffers)]
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
