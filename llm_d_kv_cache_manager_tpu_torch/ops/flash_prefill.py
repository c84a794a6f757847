"""Flash prefill over [paged context ++ fresh causal chunk]: the wrapper
around the Hopper kernel ``csrc/flash_prefill.cu``.

The kernel reads context K/V straight from the page pool through the block
tables (no gathered context buffer) and runs one online softmax over the
context and then the chunk's causal key blocks.

Contract (what the serving engine guarantees): chunk queries occupy
consecutive positions ``ctx_len + i``, so in-chunk causality is index
order, and the chunk is right-padded, so validity is a per-sequence count
``n_valid``. Fully padded query rows give zeros.

CPU tensors go to ``flash_prefill_plain`` (``attention.
prefill_with_paged_context`` under that contract); CUDA tensors go to the
kernel, or the call raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from ._counting import count_launch
from .attention import prefill_with_paged_context

#: score rows per kernel block (query tokens x GQA group), fixed in the kernel
_ROWS = 64


def flash_prefill_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    ctx_lens: torch.Tensor,
    n_valid: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``prefill_with_paged_context``
    with the engine contract's positions and right-padding mask, padded
    query rows zeroed."""
    b, s = q.shape[:2]
    ar = torch.arange(s, device=q.device)
    positions = ctx_lens.long()[:, None] + ar[None, :]
    valid = ar[None, :] < n_valid.long()[:, None]
    out = prefill_with_paged_context(
        q, k, v, k_pages, v_pages, block_tables, ctx_lens,
        positions=positions, valid=valid, scale=scale,
    )
    return out * valid[:, :, None, None].to(out.dtype)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_prefill_paged (CUDA): {msg}")


def _launch(q, k, v, k_pages, v_pages, block_tables, ctx_lens, n_valid, scale):
    dev = q.device
    b, s, n_q, hd = q.shape
    n_kv = k.shape[2]
    _check(k.shape == (b, s, n_kv, hd) and v.shape == k.shape, "k/v must be [b, s, n_kv, hd]")
    _check(k_pages.dim() == 4 and v_pages.shape == k_pages.shape, "pools must be [P, ps, n_kv, hd]")
    total_pages, page_size, pool_kv, pool_hd = k_pages.shape
    _check(pool_kv == n_kv and pool_hd == hd, "pool heads / head_dim do not match k")
    _check(n_q % n_kv == 0 and _ROWS % (n_q // n_kv) == 0, f"GQA group must divide {_ROWS}")
    _check(hd == 128, f"head_dim {hd} not compiled (128 only)")
    _check(block_tables.dim() == 2 and block_tables.shape[0] == b, "block_tables must be [b, ctx_pages]")
    _check(ctx_lens.shape == (b,) and n_valid.shape == (b,), "ctx_lens / n_valid must be [b]")
    for t in (q, k, v, k_pages, v_pages, block_tables, ctx_lens, n_valid):
        _check(t.device == dev, "all tensors must be on one CUDA device")
        _check(t.is_contiguous(), "tensors must be contiguous")
        _check(t.data_ptr() % 16 == 0 or t.numel() == 0, "tensors must be 16-byte aligned")
    for t in (q, k, v, k_pages, v_pages):
        _check(t.dtype == torch.bfloat16, "q, k, v and pools must be bfloat16")
    for t in (block_tables, ctx_lens, n_valid):
        _check(t.dtype == torch.int32, "block_tables / ctx_lens / n_valid must be int32")

    lib = _build.load("flash_prefill")
    fn = lib.flash_prefill_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    out = torch.empty_like(q)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), ctx_lens.data_ptr(), n_valid.data_ptr(),
        out.data_ptr(),
        b, s, n_q, n_kv, hd, page_size, block_tables.shape[1],
        float(scale), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check_launch("flash_prefill", err)
    count_launch(flash_prefill_paged)
    return out


def flash_prefill_paged(
    q: torch.Tensor,  # [batch, seq, n_heads, head_dim] — fresh chunk
    k: torch.Tensor,  # [batch, seq, n_kv_heads, head_dim]
    v: torch.Tensor,  # [batch, seq, n_kv_heads, head_dim]
    k_pages: torch.Tensor,  # [total_pages, page_size, n_kv_heads, head_dim]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [batch, max_ctx_pages] int32 (pad with 0)
    ctx_lens: torch.Tensor,  # [batch] int32
    n_valid: torch.Tensor,  # [batch] int32 — valid chunk tokens (right-pad)
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash prefill over [paged context ++ fresh chunk] under the engine
    contract; returns [batch, seq, n_heads, head_dim]. CUDA tensors launch
    ``csrc/flash_prefill.cu`` (bfloat16); CPU tensors take
    ``flash_prefill_plain``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_prefill_plain(
            q, k, v, k_pages, v_pages, block_tables, ctx_lens, n_valid, scale=scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill_paged: unsupported device {q.device}")
    return _launch(q, k, v, k_pages, v_pages, block_tables, ctx_lens, n_valid, scale)


#: kernel launches since the last reset (the CPU path never counts)
flash_prefill_paged.launches = 0
