"""RMSNorm (plain PyTorch; the JAX package leaves it to XLA fusion too)."""

from __future__ import annotations

import torch


def rms_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    eps: float = 1e-5,
    offset: float = 0.0,
) -> torch.Tensor:
    """Root-mean-square layer norm (Llama-style, no mean subtraction).

    Statistics are computed in float32 regardless of input dtype, output
    cast back to the input dtype. ``offset`` implements Gemma's ``(1 + w)``
    scaling convention.
    """
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    scale = weight.float() + offset
    return (normed * scale).to(dtype)
