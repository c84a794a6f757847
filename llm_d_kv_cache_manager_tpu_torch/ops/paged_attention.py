"""Paged decode attention: the wrapper around the Hopper kernel
``csrc/paged_decode.cu`` plus its plain PyTorch version.

The KV pool layout is the JAX package's, ``[(n_layers,) total_pages,
page_size, n_kv_heads, head_dim]``: page-major, so one token's
``[n_kv, head_dim]`` write slice stays contiguous for the scatter.

``paged_attention`` dispatches on where its tensors live: CPU tensors go
to ``paged_attention_reference``; CUDA tensors go to the kernel, or the call
raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

_NEG_INF = float("-inf")
#: the kernel's padded shared-memory rows must fit the default 48 KiB
_MAX_SMEM = 48 * 1024


def paged_attention_reference(
    q: torch.Tensor,  # [batch, n_heads, head_dim]
    k_pages: torch.Tensor,  # [(n_layers,) total_pages, page_size, n_kv, head_dim]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [batch, max_pages] int32
    seq_lens: torch.Tensor,  # [batch] int32
    fresh_k: Optional[torch.Tensor] = None,  # [batch, n_kv_heads, head_dim]
    fresh_v: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    layer: int = 0,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, float32 throughout: the
    pages named by ``block_tables`` hold ``seq_len`` tokens, or
    ``seq_len - 1`` with the current token's K/V passed as ``fresh_k`` /
    ``fresh_v``. A ``seq_len == 0`` row gives zeros. The result is cast to
    ``q``'s dtype."""
    if k_pages.dim() == 5:  # full multi-layer pool: a view, no copy
        k_pages, v_pages = k_pages[layer], v_pages[layer]
    batch, n_heads, head_dim = q.shape
    _, page_size, n_kv_heads, _ = k_pages.shape
    group = n_heads // n_kv_heads
    if scale is None:
        scale = head_dim**-0.5
    T = block_tables.shape[1] * page_size
    keys = k_pages[block_tables.long()].reshape(batch, T, n_kv_heads, head_dim)
    vals = v_pages[block_tables.long()].reshape(batch, T, n_kv_heads, head_dim)
    hist = seq_lens.long()
    key_ok = torch.arange(T, device=q.device)[None, :] < (
        hist[:, None] - (1 if fresh_k is not None else 0)
    )
    if fresh_k is not None:
        # The current token: one extra key, visible to itself when the row
        # is live.
        keys = torch.cat([keys, fresh_k[:, None]], dim=1)
        vals = torch.cat([vals, fresh_v[:, None]], dim=1)
        key_ok = torch.cat([key_ok, (hist > 0)[:, None]], dim=1)
    qf = q.float().reshape(batch, n_kv_heads, group, head_dim)
    scores = torch.einsum("bhgd,bthd->bhgt", qf, keys.float()) * scale
    scores = scores.masked_fill(~key_ok[:, None, None, :], _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgt,bthd->bhgd", p, vals.float())
    out = out / torch.where(denom > 0, denom, torch.ones_like(denom))
    return out.reshape(batch, n_heads, head_dim).to(q.dtype)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention (CUDA): {msg}")


def _launch(q, k_pages, v_pages, block_tables, seq_lens, fresh_k, fresh_v, scale, layer):
    dev = q.device
    if k_pages.dim() == 4:  # single-layer pool: layer 0 of a one-layer view
        k_pages, v_pages, layer = k_pages[None], v_pages[None], 0
    _check(k_pages.dim() == 5 and v_pages.shape == k_pages.shape, "pools must be [L, P, ps, n_kv, hd]")
    n_layers, total_pages, page_size, n_kv, hd = k_pages.shape
    batch, n_q, qd = q.shape
    _check(qd == hd, "q head_dim does not match the pool")
    _check(n_q % n_kv == 0 and n_q // n_kv <= 32, "n_heads must be a multiple of n_kv_heads, group <= 32")
    _check(hd == 128, f"head_dim {hd} not compiled (128 only)")
    _check(0 <= layer < n_layers, f"layer {layer} out of range")
    _check(block_tables.dim() == 2 and block_tables.shape[0] == batch, "block_tables must be [batch, max_pages]")
    _check(seq_lens.shape == (batch,), "seq_lens must be [batch]")
    smem = 2 * page_size * (hd + 8) * 2 + (n_q // n_kv) * page_size * 4
    _check(smem <= _MAX_SMEM, f"page_size {page_size} too large for the kernel's shared memory")
    tensors = [q, k_pages, v_pages, block_tables, seq_lens]
    if fresh_k is not None:
        _check(fresh_k.shape == (batch, n_kv, hd) and fresh_v.shape == fresh_k.shape, "fresh_k/v must be [batch, n_kv, hd]")
        tensors += [fresh_k, fresh_v]
    for t in tensors:
        _check(t.device == dev, "all tensors must be on one CUDA device")
        _check(t.is_contiguous(), "tensors must be contiguous")
        _check(t.data_ptr() % 16 == 0, "tensors must be 16-byte aligned")
    for t in (q, k_pages, v_pages) + ((fresh_k, fresh_v) if fresh_k is not None else ()):
        _check(t.dtype == torch.bfloat16, "q, pools and fresh K/V must be bfloat16")
    _check(block_tables.dtype == torch.int32 and seq_lens.dtype == torch.int32, "block_tables / seq_lens must be int32")

    lib = _build.load("paged_decode")
    fn = lib.paged_decode_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    out = torch.empty_like(q)
    err = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(),
        fresh_k.data_ptr() if fresh_k is not None else None,
        fresh_v.data_ptr() if fresh_v is not None else None,
        out.data_ptr(),
        batch, n_q, n_kv, hd, page_size, block_tables.shape[1], layer, total_pages,
        float(scale), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check_launch("paged_decode", err)
    paged_attention.launches += 1
    return out


def paged_attention(
    q: torch.Tensor,  # [batch, n_heads, head_dim]
    k_pages: torch.Tensor,  # [(n_layers,) total_pages, page_size, n_kv, head_dim]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [batch, max_pages] int32; pad slots with 0
    seq_lens: torch.Tensor,  # [batch] int32
    fresh_k: Optional[torch.Tensor] = None,  # [batch, n_kv_heads, head_dim]
    fresh_v: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    layer: int = 0,
) -> torch.Tensor:
    """Batched single-token (decode) paged attention; returns
    [batch, n_heads, head_dim].

    ``block_tables`` entries beyond a sequence's page count must be valid
    page indices (e.g. 0); they are never read into the result. With
    ``fresh_k``/``fresh_v`` the current token's K/V come from these
    arguments and the pages hold the ``seq_len - 1`` earlier tokens, so
    the caller writes the pool after attention. A 5-D pool is read in
    place at ``layer``. CUDA tensors launch ``csrc/paged_decode.cu``
    (bfloat16); CPU tensors take ``paged_attention_reference``."""
    if (fresh_k is None) != (fresh_v is None):
        raise ValueError("fresh_k and fresh_v must be passed together")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pages, v_pages, block_tables, seq_lens, fresh_k, fresh_v,
            scale=scale, layer=layer,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return _launch(q, k_pages, v_pages, block_tables, seq_lens, fresh_k, fresh_v, scale, layer)


#: kernel launches since the last reset (the CPU path never counts)
paged_attention.launches = 0
