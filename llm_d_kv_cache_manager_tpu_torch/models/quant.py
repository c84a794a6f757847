"""Weight-only int8 quantization for serving — the port's copy of the
weight half of the JAX package's ``models/quant.py``.

Scheme: for every matmul weight laid out ``[..., in, out]``, the scale is
the per-output-channel symmetric max over the contraction axis::

    scale = max(max(|w|, axis=-2, keepdims=True), 1e-8) / 127   # f32 [..., 1, out]
    q     = clip(round(w / scale), -127, 127)  in int8          # half to even

The numerics are the JAX module's exactly (``torch.round`` rounds half to
even, as ``jnp.round`` does), so the codes of one weight are equal in both
packages. Norms, biases, the embedding and the MoE router stay in the
model dtype (an int8 embedding carried over from the JAX package is
served: ``models/llama.py`` gathers its int8 rows).

Of the KV-page half, the device-pool helpers of ``KV_QUANT_HBM=int8`` are
ported (the mode names, the scale-pool shape, and the full-width view of
an int8 pool); the host-tier page quantizer waits for the host tier.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

#: Parameter names eligible for quantization (matmul weights only).
QUANTIZABLE = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"}
)


@dataclass
class QuantizedTensor:
    """An int8 weight and its per-output-channel f32 scale."""

    q: torch.Tensor  # int8, original weight shape [..., in, out]
    scale: torch.Tensor  # f32, [..., 1, out]

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self):
        return self.q.ndim

    @property
    def device(self):
        return self.q.device


def quantize_tensor(w: torch.Tensor) -> QuantizedTensor:
    """Symmetric per-output-channel int8 quantization over axis -2."""
    w32 = w.float()
    amax = w32.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q=q, scale=scale)


def materialize(p: Any, dtype: torch.dtype) -> torch.Tensor:
    """Dequantize (or pass through) a weight for use in a matmul. The scale
    is rounded to ``dtype`` before the multiply, as in the JAX package."""
    if isinstance(p, QuantizedTensor):
        return p.q.to(dtype) * p.scale.to(dtype)
    return p


def quantize_params(params: Any, *, quantize_experts: bool = False) -> Any:
    """Return the param dict with every eligible matmul weight replaced by
    a :class:`QuantizedTensor`; everything else is left as it is. MoE
    expert stacks (3-D ``[E, in, out]`` weights) are skipped unless
    ``quantize_experts``; the router is never quantized."""

    def convert(d: dict) -> dict:
        out = {}
        for name, v in d.items():
            if name == "layers":
                out[name] = [convert(layer) for layer in v]
            elif name in QUANTIZABLE and (
                getattr(v, "ndim", 2) == 2 or quantize_experts
            ):
                out[name] = quantize_tensor(v)
            else:
                out[name] = v
        return out

    return convert(params)


def quantize_mismatch(params: Any, *, quantize_experts: bool) -> str | None:
    """Name of the first eligible weight that is not in the form
    ``quantize_params(..., quantize_experts=)`` gives it (int8 for 2-D
    weights, and for expert stacks exactly when ``quantize_experts``), or
    None when the whole tree matches."""
    for d in [params, *params["layers"]]:
        for name, v in d.items():
            if name in QUANTIZABLE:
                want = v.ndim == 2 or quantize_experts
                if isinstance(v, QuantizedTensor) != want:
                    return name
    return None


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def is_quantized(params: Any) -> bool:
    return any(isinstance(leaf, QuantizedTensor) for leaf in _leaves(params))


def param_bytes(params: Any) -> int:
    """Total bytes of a param tree (counts int8 weights at 1 byte)."""
    total = 0
    for leaf in _leaves(params):
        parts = (leaf.q, leaf.scale) if isinstance(leaf, QuantizedTensor) else (leaf,)
        total += sum(t.numel() * t.element_size() for t in parts)
    return total


# -- int8 KV pages in device memory (KV_QUANT_HBM) ---------------------------

#: modes accepted by the ``KV_QUANT_HBM`` knob. ``float8_e4m3`` is declared
#: but rejected at engine init, as in the JAX package.
KV_QUANT_HBM_MODES = ("int8", "float8_e4m3")


def kv_hbm_scale_shape(pool_shape: tuple[int, ...]) -> tuple[int, ...]:
    """Scale pool shape for an int8 KV pool ``[n_layers, total_pages,
    page_size, n_kv_heads, head_dim]``: one f32 scale per page per
    (layer, kv_head), ``[n_layers, total_pages, n_kv_heads]``."""
    n_layers, total_pages, _, n_kv_heads, _ = pool_shape
    return (n_layers, total_pages, n_kv_heads)


def dequantize_kv_pool(
    q: torch.Tensor, scales: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """Full-width view of an int8 pool ``[..., P, ps, n_kv, hd]`` with
    per-page scales ``[..., P, n_kv]``: ``code * scale`` in float32, cast
    to ``dtype``. The tests' and the card check's oracle view; the serving
    path never builds it (the decode kernel dequantizes in registers)."""
    return (q.float() * scales.float()[..., None, :, None]).to(dtype)
