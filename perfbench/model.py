"""The record of a model that the harness counts with.

A configuration file holds the model's public ``config.json`` under
``config``; its ``model_type`` names the architecture
(``architectures/<model_type>.py``), whose ``dims`` reads that config into
a ``Dims``: the global sizes, and the model's layers in order, each with
its attention span, the attention parameters a token multiplies by and its
FFN. ``work.py`` and the readers count from these alone. An architecture
may extend the record with what its own weights, engine model and
reference need.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from functools import cached_property
from typing import Optional


@dataclass(frozen=True)
class Ffn:
    """One layer's FFN: dense of ``width``, or ``experts`` routed experts of
    ``width`` each, ``top_k`` of them a token, beside a shared expert of
    ``shared`` (0: none)."""

    width: int
    experts: int = 0
    top_k: int = 0
    shared: int = 0


@dataclass(frozen=True)
class Layer:
    #: the keys one query sees, itself included; None: the whole context
    span: Optional[int]
    #: attention parameters a token multiplies by (q, k, v and output)
    attn_params: int
    ffn: Ffn


@dataclass(frozen=True)
class Dims:
    vocab: int
    d: int
    heads: int
    kv_heads: int
    hd: int
    eps: float
    theta: float
    tie: bool
    dtype: str
    stack: tuple[Layer, ...]

    @property
    def layers(self) -> int:
        return len(self.stack)

    @property
    def dtype_bytes(self) -> int:
        return {"bfloat16": 2, "float16": 2, "float32": 4}[self.dtype]

    @cached_property
    def kinds(self) -> dict[Layer, int]:
        """Each distinct layer, and how many of the model's layers it is."""
        return dict(Counter(self.stack))

    @cached_property
    def spans(self) -> dict[Optional[int], int]:
        """Each distinct attention span, and how many layers have it."""
        return dict(Counter(layer.span for layer in self.stack))
