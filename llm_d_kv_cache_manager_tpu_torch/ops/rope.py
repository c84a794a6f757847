"""Rotary position embeddings (Llama-style, half-split layout), including
Llama-3.1 frequency scaling. Frequencies are computed once on the host in
float64 numpy, exactly as the JAX package computes them."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class RopeScalingConfig:
    """Llama-3.1-style rope scaling parameters."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position: int = 8192


def rope_frequencies(
    head_dim: int,
    theta: float = 500_000.0,
    scaling: Optional[RopeScalingConfig] = None,
) -> np.ndarray:
    """Inverse frequencies [head_dim // 2], optionally llama-3.1-scaled."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    if scaling is not None:
        low_wavelen = scaling.original_max_position / scaling.low_freq_factor
        high_wavelen = scaling.original_max_position / scaling.high_freq_factor
        wavelen = 2 * np.pi / inv_freq
        scaled = np.where(wavelen > low_wavelen, inv_freq / scaling.factor, inv_freq)
        smooth = (scaling.original_max_position / wavelen - scaling.low_freq_factor) / (
            scaling.high_freq_factor - scaling.low_freq_factor
        )
        mid = (1 - smooth) * inv_freq / scaling.factor + smooth * inv_freq
        is_mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
        scaled = np.where(is_mid, mid, scaled)
        inv_freq = scaled
    return inv_freq.astype(np.float32)


def apply_rope(
    x: torch.Tensor,  # [..., seq, n_heads, head_dim]
    positions: torch.Tensor,  # [..., seq]
    inv_freq: torch.Tensor,  # [head_dim // 2] f32
) -> torch.Tensor:
    """Rotate q or k by position: the head dim is split as [d/2 | d/2] and
    rotated pairwise across halves (HF Llama). Float32 math, cast back."""
    dtype = x.dtype
    angles = positions[..., :, None].float() * inv_freq[None, :]  # [..., seq, d/2]
    cos = torch.cos(angles)[..., :, None, :]  # [..., seq, 1, d/2]
    sin = torch.sin(angles)[..., :, None, :]
    xf = x.float()
    half = x.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(dtype)
