"""Paged decode attention: the wrappers around the Hopper kernels of
``csrc/paged_decode.cu`` plus their plain PyTorch version.

The KV pool layout is the JAX package's, ``[(n_layers,) total_pages,
page_size, n_kv_heads, head_dim]``: page-major, so one token's
``[n_kv, head_dim]`` write slice stays contiguous for the scatter. With
``KV_QUANT_HBM=int8`` the pools hold int8 codes and per-page f32 scales
``[(n_layers,) total_pages, n_kv_heads]`` ride beside them.

``paged_attention`` dispatches on where its tensors live: CPU tensors go
to ``paged_attention_reference``; CUDA tensors go to the kernel (K1 for
bf16 pools, ``paged_decode_int8`` for int8 pools with scales), or the call
raises. There is no fallback from one to the other.

The kernel splits each row's history over ``splits`` blocks of
``pages_per_split`` pages (``plan_decode_splits``, from shapes alone) and
merges their partial softmax states in a second pass;
``paged_attention_split_plain`` is that two-pass algorithm in plain
PyTorch, for the tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from ._counting import count_launch

_NEG_INF = float("-inf")
#: query rows a block: the 8 columns of one mma tile (csrc/paged_decode.cu);
#: a larger GQA group takes ceil(group / 8) blocks a kv head. The kernel's
#: shared memory is fixed at compile time (68 KiB bf16, 74 KiB int8, opted
#: in by its launcher, whose error the wrapper raises), whatever the page
#: size
_TILE_ROWS = 8


#: keys a full split holds: two 16-key bf16 tiles (one 32-key int8 tile)
#: for each of the kernel's 4 warps
_SPLIT_KEYS = 128


def plan_decode_splits(batch: int, n_kv: int, max_pages: int, page_size: int,
                       sm_count: int) -> tuple[int, int]:
    """``(splits, pages_per_split)`` for the split-KV kernel, from shapes
    alone: each split a contiguous run of ``pages_per_split`` pages of the
    ``max_pages``-wide table, about ``_SPLIT_KEYS`` keys, so that rows of
    any length spread over many blocks and the longest row does not hold
    the card; longer runs where that would make more than 8 blocks an SM;
    shorter ones where it would make fewer than one block an SM. No split
    lies past the table's end, and every page lies in exactly one split. It
    never reads a tensor value, so the launch never synchronises with the
    host. ``n_kv`` is the grid's second extent: the kv heads, times
    ``ceil(group / 8)`` where the GQA group is above 8."""
    if max_pages <= 1:
        return 1, 1
    rows = max(1, batch * n_kv)
    pages_per_split = max(1, _SPLIT_KEYS // page_size)
    pages_per_split = max(pages_per_split, -(-max_pages * rows // (8 * sm_count)))
    pages_per_split = min(pages_per_split, max(1, max_pages // -(-sm_count // rows)))
    return -(-max_pages // pages_per_split), pages_per_split


def paged_attention_reference(
    q: torch.Tensor,  # [batch, n_heads, head_dim]
    k_pages: torch.Tensor,  # [(n_layers,) total_pages, page_size, n_kv, head_dim]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [batch, max_pages] int32
    seq_lens: torch.Tensor,  # [batch] int32
    fresh_k: Optional[torch.Tensor] = None,  # [batch, n_kv_heads, head_dim]
    fresh_v: Optional[torch.Tensor] = None,
    *,
    k_scale: Optional[torch.Tensor] = None,  # [(n_layers,) total_pages, n_kv] f32
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    layer: int = 0,
) -> torch.Tensor:
    """The kernels' function in plain PyTorch, float32 throughout: the
    pages named by ``block_tables`` hold ``seq_len`` tokens, or
    ``seq_len - 1`` with the current token's K/V passed as ``fresh_k`` /
    ``fresh_v``. With ``k_scale``/``v_scale`` the pools hold int8 codes and
    the gathered pages are dequantized in float32 (``code * scale``). A
    ``seq_len == 0`` row gives zeros. The result is cast to ``q``'s
    dtype."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    if k_pages.dim() == 5:  # full multi-layer pool: a view, no copy
        k_pages, v_pages = k_pages[layer], v_pages[layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer], v_scale[layer]
    batch, n_heads, head_dim = q.shape
    _, page_size, n_kv_heads, _ = k_pages.shape
    group = n_heads // n_kv_heads
    if scale is None:
        scale = head_dim**-0.5
    T = block_tables.shape[1] * page_size
    bt = block_tables.long()
    keys, vals = k_pages[bt], v_pages[bt]  # [batch, max_pages, ps, n_kv, hd]
    if k_scale is not None:
        keys = keys.float() * k_scale[bt][:, :, None, :, None]
        vals = vals.float() * v_scale[bt][:, :, None, :, None]
    keys = keys.reshape(batch, T, n_kv_heads, head_dim)
    vals = vals.reshape(batch, T, n_kv_heads, head_dim)
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


def paged_attention_split_plain(
    q: torch.Tensor,  # [batch, n_heads, head_dim]
    k_pages: torch.Tensor,  # [(n_layers,) total_pages, page_size, n_kv, head_dim]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [batch, max_pages] int32
    seq_lens: torch.Tensor,  # [batch] int32
    fresh_k: Optional[torch.Tensor] = None,  # [batch, n_kv_heads, head_dim]
    fresh_v: Optional[torch.Tensor] = None,
    *,
    splits: int,
    pages_per_split: int,
    k_scale: Optional[torch.Tensor] = None,  # [(n_layers,) total_pages, n_kv] f32
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    layer: int = 0,
) -> torch.Tensor:
    """The kernel's two passes in plain PyTorch, float32 throughout: split
    ``z`` holds the history keys of pages ``[z * pages_per_split, (z + 1) *
    pages_per_split)`` and yields its partial ``(m, l, acc)`` (``m = -inf,
    l = 0, acc = 0`` when it holds no key); the combine pass merges the
    splits by log-sum-exp, then the fresh token as one more one-key split,
    and normalises (a row with no key gives zeros). Used by the tests."""
    if splits * pages_per_split < block_tables.shape[1]:
        raise ValueError("the splits do not cover the block table")
    if k_pages.dim() == 5:
        k_pages, v_pages = k_pages[layer], v_pages[layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer], v_scale[layer]
    batch, n_heads, head_dim = q.shape
    _, page_size, n_kv_heads, _ = k_pages.shape
    group = n_heads // n_kv_heads
    if scale is None:
        scale = head_dim**-0.5
    bt = block_tables.long()
    keys, vals = k_pages[bt].float(), v_pages[bt].float()  # [batch, max_pages, ps, n_kv, hd]
    if k_scale is not None:
        keys = keys * k_scale[bt][:, :, None, :, None]
        vals = vals * v_scale[bt][:, :, None, :, None]
    T = block_tables.shape[1] * page_size
    keys = keys.reshape(batch, T, n_kv_heads, head_dim)
    vals = vals.reshape(batch, T, n_kv_heads, head_dim)
    hist = (seq_lens.long() - (1 if fresh_k is not None else 0)).clamp(min=0)
    qf = q.float().reshape(batch, n_kv_heads, group, head_dim)
    scores = torch.einsum("bhgd,bthd->bhgt", qf, keys) * scale
    t = torch.arange(T, device=q.device)
    shape = (batch, n_kv_heads, group, 1)
    m = torch.full(shape, _NEG_INF, device=q.device)
    l = torch.zeros(shape, device=q.device)  # noqa: E741
    acc = torch.zeros((batch, n_kv_heads, group, head_dim), device=q.device)

    def merge(m, l, acc, ms, ls, accs):  # noqa: E741
        mnew = torch.maximum(m, ms)
        finite = torch.isfinite(mnew)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - torch.where(finite, mnew, 0.0)), 0.0)
        w = torch.where(torch.isfinite(ms), torch.exp(ms - torch.where(finite, mnew, 0.0)), 0.0)
        return mnew, l * alpha + ls * w, acc * alpha + accs * w

    for z in range(splits):
        lo, hi = z * pages_per_split * page_size, (z + 1) * pages_per_split * page_size
        in_split = (t[None, :] >= lo) & (t[None, :] < torch.clamp(hist[:, None], max=hi))
        s = scores.masked_fill(~in_split[:, None, None, :], _NEG_INF)
        ms = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - torch.where(torch.isfinite(ms), ms, torch.zeros_like(ms)))
        m, l, acc = merge(m, l, acc, ms, p.sum(-1, keepdim=True), torch.einsum("bhgt,bthd->bhgd", p, vals))
    if fresh_k is not None:
        live = (seq_lens.long() > 0)[:, None, None, None]
        sf = torch.einsum("bhgd,bhd->bhg", qf, fresh_k.float())[..., None] * scale
        sf = torch.where(live, sf, _NEG_INF)
        m, l, acc = merge(m, l, acc, sf, live.float(), fresh_v.float()[:, :, None, :].expand_as(acc))
    out = acc / torch.where(l > 0, l, torch.ones_like(l))
    return out.reshape(batch, n_heads, head_dim).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _entry(quantized: bool):
    """The C entry point of K1q (``quantized``) or K1, typed once."""
    lib = _build.load("paged_decode")
    fn = lib.paged_decode_int8 if quantized else lib.paged_decode_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * (12 if quantized else 10) + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_void_p]
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention (CUDA): {msg}")


def _launch(q, k_pages, v_pages, k_scale, v_scale, block_tables, seq_lens, fresh_k, fresh_v,
            scale, layer):
    """Check the operands and launch K1 (``k_scale`` None: bf16 pools) or
    K1q (int8 pools with f32 scales). Returns the output and the launch's
    plan: its split pass's grid and pages a split."""
    dev = q.device
    _check(dev.type == "cuda", f"the kernel needs CUDA tensors, got {dev}")
    quantized = k_scale is not None
    if k_pages.dim() == 4:  # single-layer pool: layer 0 of a one-layer view
        k_pages, v_pages, layer = k_pages[None], v_pages[None], 0
        if quantized:
            k_scale, v_scale = k_scale[None], v_scale[None]
    _check(k_pages.dim() == 5 and v_pages.shape == k_pages.shape, "pools must be [L, P, ps, n_kv, hd]")
    n_layers, total_pages, page_size, n_kv, hd = k_pages.shape
    batch, n_q, qd = q.shape
    _check(qd == hd, "q head_dim does not match the pool")
    _check(n_q % n_kv == 0, "n_heads must be a multiple of n_kv_heads")
    _check(hd == 128, f"head_dim {hd} not compiled (128 only)")
    _check(0 <= layer < n_layers, f"layer {layer} out of range")
    _check(block_tables.dim() == 2 and block_tables.shape[0] == batch, "block_tables must be [batch, max_pages]")
    _check(seq_lens.shape == (batch,), "seq_lens must be [batch]")
    tensors = [q, k_pages, v_pages, block_tables, seq_lens]
    if quantized:
        _check(k_scale.shape == (n_layers, total_pages, n_kv) and v_scale.shape == k_scale.shape,
               "k_scale/v_scale must be [L, P, n_kv] beside [L, P, ps, n_kv, hd] pools")
        _check(k_scale.dtype == torch.float32 and v_scale.dtype == torch.float32,
               "k_scale/v_scale must be float32")
        _check(k_pages.dtype == torch.int8 and v_pages.dtype == torch.int8, "pools with scales must be int8")
        tensors += [k_scale, v_scale]
    else:
        _check(k_pages.dtype == torch.bfloat16 and v_pages.dtype == torch.bfloat16,
               "pools without scales must be bfloat16")
    if fresh_k is not None:
        _check(fresh_k.shape == (batch, n_kv, hd) and fresh_v.shape == fresh_k.shape, "fresh_k/v must be [batch, n_kv, hd]")
        tensors += [fresh_k, fresh_v]
    for t in tensors:
        _check(t.device == dev, "all tensors must be on one CUDA device")
        _check(t.is_contiguous(), "tensors must be contiguous")
        _check(t.data_ptr() % 16 == 0, "tensors must be 16-byte aligned")
    for t in (q,) + ((fresh_k, fresh_v) if fresh_k is not None else ()):
        _check(t.dtype == torch.bfloat16, "q and fresh K/V must be bfloat16")
    _check(block_tables.dtype == torch.int32 and seq_lens.dtype == torch.int32, "block_tables / seq_lens must be int32")

    max_pages = block_tables.shape[1]
    blocks_y = n_kv * -(-(n_q // n_kv) // _TILE_ROWS)
    splits, pages_per_split = plan_decode_splits(batch, blocks_y, max_pages, page_size,
                                                 _sm_count(dev.index))
    out = torch.empty_like(q)
    # Float32 scratch of the splits' partial acc [batch, n_kv, splits,
    # group, hd], then their (m, l) [.., 2], in one allocation.
    part_rows = batch * n_q * splits
    scratch = torch.empty(part_rows * (hd + 2), dtype=torch.float32, device=dev)
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if quantized else ()
    err = _entry(quantized)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), *scales,
        block_tables.data_ptr(), seq_lens.data_ptr(),
        fresh_k.data_ptr() if fresh_k is not None else None,
        fresh_v.data_ptr() if fresh_v is not None else None,
        out.data_ptr(), scratch.data_ptr(), scratch.data_ptr() + part_rows * hd * 4,
        batch, n_q, n_kv, hd, page_size, max_pages, layer, total_pages,
        splits, pages_per_split,
        float(scale), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check_launch("paged_decode_int8" if quantized else "paged_decode", err)
    return out, {"grid": (batch, blocks_y, splits), "pages_per_split": pages_per_split}


def paged_decode_int8(
    q: torch.Tensor,  # [batch, n_heads, 128] bf16
    k_pages: torch.Tensor,  # [(n_layers,) total_pages, page_size, n_kv, 128] int8
    v_pages: torch.Tensor,
    k_scale: torch.Tensor,  # [(n_layers,) total_pages, n_kv] f32
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    fresh_k: Optional[torch.Tensor] = None,  # [batch, n_kv, 128] bf16
    fresh_v: Optional[torch.Tensor] = None,
    *,
    scale: float,
    layer: int = 0,
) -> torch.Tensor:
    """K1q on the card: ``paged_attention`` over int8 pages, each page's
    codes dequantized in registers with its (layer, kv head) scale."""
    out, paged_decode_int8.last_plan = _launch(q, k_pages, v_pages, k_scale, v_scale,
                                               block_tables, seq_lens, fresh_k, fresh_v,
                                               scale, layer)
    count_launch(paged_decode_int8)
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
    k_scale: Optional[torch.Tensor] = None,  # [(n_layers,) total_pages, n_kv] f32
    v_scale: Optional[torch.Tensor] = None,
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
    place at ``layer``, with ``[L, P, n_kv]`` scales; a 4-D pool takes 2-D
    ``[P, n_kv]`` scales. With ``k_scale``/``v_scale`` the pools hold int8
    codes (``KV_QUANT_HBM=int8``). CUDA tensors launch
    ``csrc/paged_decode.cu`` (K1 for bfloat16 pools, ``paged_decode_int8``
    for int8 pools); CPU tensors take ``paged_attention_reference``."""
    if (fresh_k is None) != (fresh_v is None):
        raise ValueError("fresh_k and fresh_v must be passed together")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pages, v_pages, block_tables, seq_lens, fresh_k, fresh_v,
            k_scale=k_scale, v_scale=v_scale, scale=scale, layer=layer,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    if k_scale is not None:
        return paged_decode_int8(
            q, k_pages, v_pages, k_scale, v_scale, block_tables, seq_lens,
            fresh_k, fresh_v, scale=scale, layer=layer,
        )
    out, paged_attention.last_plan = _launch(q, k_pages, v_pages, None, None, block_tables,
                                             seq_lens, fresh_k, fresh_v, scale, layer)
    count_launch(paged_attention)
    return out


#: kernel launches since the last reset (the CPU path never counts; the
#: split and combine passes of one call count once): K1's on
#: ``paged_attention``, K1q's on ``paged_decode_int8``; ``last_plan`` is the
#: last launch's split-pass grid and pages a split
paged_attention.launches = 0
paged_decode_int8.launches = 0
paged_attention.last_plan = None
paged_decode_int8.last_plan = None
