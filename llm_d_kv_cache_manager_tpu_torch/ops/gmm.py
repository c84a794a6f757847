"""Grouped (ragged) matmul for the routed MoE dispatch: the wrappers around
the Hopper kernels in ``csrc/grouped_matmul.cu`` plus their plain PyTorch
version.

The routed pipeline (``models/llama._moe_mlp_routed``) sorts the ``n*k``
(token, slot) rows by expert, so each expert's rows form one contiguous
segment, and needs ``out[r] = lhs[r] @ rhs[g(r)]`` where ``g(r)`` is the
expert owning row ``r``; rows past the last group are zero.

``grouped_matmul`` dispatches on where ``lhs`` lives: CPU tensors go to
``grouped_matmul_plain``; CUDA tensors launch ``grouped_matmul_bf16`` (a
bf16 expert stack) or ``grouped_matmul_int8`` (a ``QuantizedTensor``), or
the call raises. There is no fallback from one to the other.

Each launch takes one of the kernels' two paths, chosen on the host from
integers alone by ``plan_grouped_matmul``: the persistent ``wgmma``/TMA
GEMM for prefill-shaped calls, or the weight-streaming ``mma.sync`` GEMV
for decode-shaped ones. The wrapper records the plan it launched on
``last_plan``.

Training differentiates through ``GroupedMatmul``, megablox's
``custom_vjp`` (``jax/experimental/pallas/ops/tpu/megablox/ops.py:22``):
its backward takes the input gradient ``dlhs[r] = dout[r] @ rhs[g(r)]^T``
through K4^T (``grouped_matmul_bf16_t``: K4's prefill path reading the
expert stack transposed in place) and the expert-weight gradient
``drhs[g] = lhs[rows_g]^T @ dout[rows_g]`` through K6
(``grouped_matmul_tgmm``, ``csrc/grouped_matmul_tgmm.cu``) for CUDA
tensors, through their plain versions for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Union

import torch

from ..models.quant import QuantizedTensor
from . import _build
from ._counting import count_launch

#: the kernels' shared-memory group table (``kMaxGroups``)
_MAX_GROUPS = 1024
#: prefill path (``csrc/grouped_matmul.cu``): output tile, k tile, threads
#: (two consumer warpgroups + one producer)
_TM, _TN, _TK, _THREADS = 128, 256, 64, 384


def _prefill_smem(quantized: bool) -> tuple[int, int]:
    """Ring stages and dynamic shared memory of the prefill kernel: 1 KiB of
    alignment slack, the ring (a stage: the lhs tile, the bf16 B tile and,
    for int8, the codes it is widened from), two mbarriers a stage, each
    consumer warp's epilogue buffer (16 rows of 144 bytes), the group
    tables."""
    stages = 3 if quantized else 4
    stage = _TM * _TK * 2 + _TK * _TN * 2 + (_TK * _TN if quantized else 0)
    return stages, (1024 + stages * stage + 2 * stages * 8 + 8 * 16 * 144
                    + 2 * (_MAX_GROUPS + 2) * 4)


#: decode path: 8 warps a block, 16 bytes of f a thread, 8 rows a pass
_DEC_THREADS, _DEC_ROWS = 256, 8


def plan_grouped_matmul(rows: int, n_groups: int, d: int, f: int, quantized: bool,
                        sm_count: int, transpose_rhs: bool = False) -> dict:
    """The launch of one grouped matmul, from integers alone (never a tensor
    value, so the launch never synchronises with the host).

    ``rows < 16 * n_groups`` (under 16 rows an expert on average) takes the
    decode path: one block per (64 bf16 / 128 int8 columns of f, group),
    plus one row of blocks for the zero tail. Otherwise the prefill path:
    persistent blocks, one an SM, never more than the group-aligned tiles
    there can be (``ceil(rows / 128) + n_groups + 1`` row tiles, each
    non-empty group adding at most one partial tile and the tail one, times
    ``ceil(f / 256)``). Raises for widths TMA cannot tile: ``d * 2`` and
    ``f`` times the element size must be multiples of 16 bytes.
    ``transpose_rhs`` (K4^T: ``d`` the contraction, ``f`` the output width)
    always takes the prefill path, whose kernel alone reads the stack
    transposed."""
    elem = 1 if quantized else 2
    if d < 1 or f < 1 or (d * 2) % 16 or (f * elem) % 16:
        raise ValueError(f"grouped_matmul: d * 2 = {d * 2} and f * {elem} = {f * elem} "
                         "must be positive multiples of 16 bytes")
    if rows < 16 * n_groups and not transpose_rhs:
        width = 16 // elem * 8
        return {"path": "decode", "tile": (_DEC_ROWS, width, 16), "stages": 0,
                "grid": (-(-f // width), n_groups + 1, 1), "threads": _DEC_THREADS,
                "smem": 8 * _DEC_ROWS * width * 4}
    upper = (-(-rows // _TM) + n_groups + 1) * -(-f // _TN)
    stages, smem = _prefill_smem(quantized)
    return {"path": "prefill", "tile": (_TM, _TN, _TK), "stages": stages,
            "grid": (max(1, min(upper, sm_count)), 1, 1), "threads": _THREADS, "smem": smem}


def grouped_matmul_plain(
    lhs: torch.Tensor,  # [rows, d] group-sorted (expert-contiguous) rows
    rhs: Union[torch.Tensor, QuantizedTensor],  # [E, d, f] expert stack
    group_sizes: torch.Tensor,  # [E] int32 rows per expert
    *,
    row_group_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernels' function in plain PyTorch: one float32 product per
    non-empty group, ``(lhs @ q) * scale[g]`` for a quantized stack, cast
    to ``lhs.dtype``. Reads ``group_sizes`` on the host (a device sync on
    CUDA), so the serving path never calls it there."""
    quantized = isinstance(rhs, QuantizedTensor)
    if quantized and row_group_ids is None:
        raise ValueError("row_group_ids required for quantized rhs")
    rows = lhs.shape[0]
    acc = _acc_dtype(lhs)
    out = torch.zeros((rows, rhs.shape[2]), dtype=acc, device=lhs.device)
    for g, start, n in _group_spans(group_sizes, rows):
        w = (rhs.q if quantized else rhs)[g].to(acc)
        o = lhs[start : start + n].to(acc) @ w
        out[start : start + n] = o * rhs.scale[g].to(acc) if quantized else o
    return out.to(lhs.dtype)


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The plain versions' accumulation type: float32, or float64 for
    float64 inputs (``torch.autograd.gradcheck``)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _group_spans(group_sizes: torch.Tensor, rows: int):
    """(group, first row, rows) of each non-empty group, as the kernels
    bound them: negative sizes count as 0 and the sums are clamped to
    ``rows``. Reads ``group_sizes`` on the host."""
    start = 0
    for g, n in enumerate(group_sizes.tolist()):
        n = min(max(int(n), 0), rows - start)
        if n > 0:
            yield g, start, n
        start += n


def grouped_matmul_tgmm_plain(
    lhs: torch.Tensor,  # [rows, d] group-sorted rows
    dout: torch.Tensor,  # [rows, f]
    group_sizes: torch.Tensor,  # [E] int32
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """K6's function in plain PyTorch: ``drhs[g] = lhs[rows_g]^T @
    dout[rows_g]``, one float32 product per non-empty group, zeros for an
    empty group, cast to ``out_dtype`` (default ``lhs.dtype``); rows past
    the last group add nothing. Reads ``group_sizes`` on the host."""
    rows, d = lhs.shape
    acc = _acc_dtype(lhs)
    out = torch.zeros((group_sizes.shape[0], d, dout.shape[1]), dtype=acc, device=lhs.device)
    for g, start, n in _group_spans(group_sizes, rows):
        out[g] = lhs[start : start + n].to(acc).T @ dout[start : start + n].to(acc)
    return out.to(out_dtype or lhs.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _entry(quantized: bool):
    """The C entry point of K5 (``quantized``) or K4, typed once."""
    lib = _build.load("grouped_matmul")
    fn = lib.grouped_matmul_int8 if quantized else lib.grouped_matmul_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * (5 if quantized else 4) + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=None)
def _entry_t():
    """The C entry point of K4^T, typed once."""
    fn = _build.load("grouped_matmul").grouped_matmul_bf16_t
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn


def _check(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name} (CUDA): {msg}")


def _launch(name: str, lhs, b, scale, group_sizes,
            transpose_rhs: bool = False) -> tuple[torch.Tensor, Optional[dict]]:
    """Check the operands and launch K4 (``scale`` None), K5, or K4^T
    (``transpose_rhs``: ``b`` is ``[E, f, d]``, read as ``b[g]^T``) as
    ``plan_grouped_matmul`` plans it; returns the output and the plan (None
    when there are no rows and nothing is launched)."""
    dev = lhs.device
    _check(dev.type == "cuda", name, f"tensors must be on a CUDA device, got {dev}")
    _check(lhs.dim() == 2 and b.dim() == 3, name, "lhs must be [rows, d] and rhs [E, d, f]")
    rows, d = lhs.shape
    if transpose_rhs:
        n_groups, f, bd = b.shape
    else:
        n_groups, bd, f = b.shape
    _check(bd == d, name, f"rhs contraction width {bd} != lhs width {d}")
    _check(group_sizes.shape == (n_groups,), name, "group_sizes must be [E]")
    _check(1 <= n_groups <= _MAX_GROUPS, name, f"1..{_MAX_GROUPS} groups only")
    per_chunk = 16 if scale is not None else 8
    _check(d % 8 == 0 and f % per_chunk == 0, name, f"d % 8 and f % {per_chunk} must be 0")
    _check(lhs.dtype == torch.bfloat16, name, "lhs must be bfloat16")
    _check(group_sizes.dtype == torch.int32, name, "group_sizes must be int32")
    tensors = [lhs, b, group_sizes]
    if scale is not None:
        _check(b.dtype == torch.int8, name, "q must be int8")
        _check(scale.shape == (n_groups, 1, f) and scale.dtype == torch.float32, name,
               "scale must be float32 [E, 1, f]")
        tensors.append(scale)
    else:
        _check(b.dtype == torch.bfloat16, name, "rhs must be bfloat16")
    for t in tensors:
        _check(t.device == dev, name, "all tensors must be on one CUDA device")
        _check(t.is_contiguous(), name, "tensors must be contiguous")
        _check(t.data_ptr() % 16 == 0 or t.numel() == 0, name, "tensors must be 16-byte aligned")
    out = torch.empty((rows, f), dtype=torch.bfloat16, device=dev)
    if rows == 0:
        return out, None
    plan = plan_grouped_matmul(rows, n_groups, d, f, scale is not None, _sm_count(dev.index),
                               transpose_rhs=transpose_rhs)
    ptrs = (lhs.data_ptr(), b.data_ptr()) + ((scale.data_ptr(),) if scale is not None else ())
    grid = plan["grid"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if transpose_rhs:
        err = _entry_t()(*ptrs, group_sizes.data_ptr(), out.data_ptr(), rows, d, f, n_groups,
                         grid[0], stream)
    else:
        err = _entry(scale is not None)(
            *ptrs, group_sizes.data_ptr(), out.data_ptr(), rows, d, f, n_groups,
            0 if plan["path"] == "prefill" else 1, grid[0], grid[1], stream,
        )
    _build.check_launch(name, err)
    return out, plan


def grouped_matmul_bf16(
    lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor
) -> torch.Tensor:
    """K4 on the card: bf16 ``lhs [rows, d]`` by the bf16 expert stack
    ``rhs [E, d, f]`` over ``group_sizes`` (int32, on the device, never
    read by the host); returns bf16 ``[rows, f]``."""
    out, plan = _launch("grouped_matmul_bf16", lhs, rhs, None, group_sizes)
    if plan is not None:
        grouped_matmul_bf16.last_plan = plan
        count_launch(grouped_matmul_bf16)
    return out


def grouped_matmul_int8(
    lhs: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, group_sizes: torch.Tensor
) -> torch.Tensor:
    """K5 on the card: bf16 ``lhs`` by the int8 codes ``q [E, d, f]``, f32
    accumulation, times ``scale [E, 1, f]`` of each row's group, rounded
    once to bf16."""
    out, plan = _launch("grouped_matmul_int8", lhs, q, scale, group_sizes)
    if plan is not None:
        grouped_matmul_int8.last_plan = plan
        count_launch(grouped_matmul_int8)
    return out


def grouped_matmul(
    lhs: torch.Tensor,  # [rows, d] group-sorted (expert-contiguous) rows
    rhs: Union[torch.Tensor, QuantizedTensor],  # [E, d, f] expert stack
    group_sizes: torch.Tensor,  # [E] int32 rows per expert
    *,
    row_group_ids: Optional[torch.Tensor] = None,  # [rows] expert of row
) -> torch.Tensor:
    """``out[r] = lhs[r] @ rhs[g(r)]`` over expert-contiguous rows.

    With a ``QuantizedTensor`` rhs, ``row_group_ids`` (the sorted expert id
    per row) is required, as in the JAX package. CPU tensors take
    ``grouped_matmul_plain``; CUDA tensors launch K4 or K5."""
    quantized = isinstance(rhs, QuantizedTensor)
    if quantized and row_group_ids is None:
        raise ValueError("row_group_ids required for quantized rhs")
    if lhs.device.type == "cpu":
        return grouped_matmul_plain(lhs, rhs, group_sizes, row_group_ids=row_group_ids)
    if lhs.device.type != "cuda":
        raise ValueError(f"grouped_matmul: unsupported device {lhs.device}")
    if quantized:
        return grouped_matmul_int8(lhs, rhs.q, rhs.scale, group_sizes)
    return grouped_matmul_bf16(lhs, rhs, group_sizes)


def grouped_matmul_bf16_t(
    dout: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor
) -> torch.Tensor:
    """K4^T on the card, the input gradient of K4: ``out[r] = dout[r] @
    rhs[g(r)]^T``, bf16 ``dout [rows, f]`` by the bf16 expert stack ``rhs
    [E, d, f]``; returns bf16 ``[rows, d]``, rows past the last group zero.
    K4's prefill kernel reading ``rhs`` transposed in place, as megablox's
    ``transpose_rhs=True``, whatever the rows; counts on this wrapper, not
    on K4's."""
    name = "grouped_matmul_bf16_t"
    out, plan = _launch(name, dout, rhs, None, group_sizes, transpose_rhs=True)
    if plan is not None:
        grouped_matmul_bf16_t.last_plan = plan
        count_launch(grouped_matmul_bf16_t)
    return out


#: K6 (``csrc/grouped_matmul_tgmm.cu``): output tile (d rows, f columns),
#: k tile (group rows), ring stages, threads (two consumer warpgroups + one
#: producer), groups it takes
_TG_TM, _TG_TN, _TG_TK, _TG_STAGES, _TG_THREADS, _TG_MAX_GROUPS = 128, 256, 64, 3, 384, 65535


def plan_grouped_matmul_tgmm(n_groups: int, d: int, f: int, sm_count: int) -> dict:
    """K6's launch from integers alone (never a tensor value, so the launch
    never synchronises with the host): persistent blocks, one an SM and
    never more than the tiles, walking ``tiles = n_groups * ceil(d / 128) *
    ceil(f / 256)`` output tiles, group outermost. Shared memory: 1 KiB of
    alignment slack, the ring (a stage: 64 rows of two 64-wide lhs boxes
    and four 64-wide dout boxes, 8 KiB each), two 32 KiB staging tiles for
    the epilogue's stores, two mbarriers a stage. Raises for the shapes the
    kernel does not take: ``d`` and ``f`` positive multiples of 8 (16-byte
    TMA strides), 1..65535 groups."""
    if not 1 <= n_groups <= _TG_MAX_GROUPS:
        raise ValueError(f"grouped_matmul_tgmm: {n_groups} groups, 1..{_TG_MAX_GROUPS} only")
    if d < 8 or f < 8 or d % 8 or f % 8:
        raise ValueError(f"grouped_matmul_tgmm: d = {d} and f = {f} must be positive "
                         "multiples of 8")
    tiles = n_groups * -(-d // _TG_TM) * -(-f // _TG_TN)
    box = 64 * 128
    stage = (_TG_TM // 64 + _TG_TN // 64) * box
    smem = 1024 + _TG_STAGES * stage + 2 * (_TG_TN // 64) * box + 2 * _TG_STAGES * 8
    return {"grid": (max(1, min(tiles, sm_count)), 1, 1), "threads": _TG_THREADS,
            "tile": (_TG_TM, _TG_TN, _TG_TK), "stages": _TG_STAGES, "smem": smem,
            "tiles": tiles}


@functools.lru_cache(maxsize=None)
def _tgmm_entry():
    fn = _build.load("grouped_matmul_tgmm").grouped_matmul_tgmm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn


def grouped_matmul_tgmm(
    lhs: torch.Tensor, dout: torch.Tensor, group_sizes: torch.Tensor
) -> torch.Tensor:
    """K6 on the card, the expert-weight gradient of K4: ``drhs[g] =
    lhs[rows_g]^T @ dout[rows_g]`` for bf16 ``lhs [rows, d]`` and ``dout
    [rows, f]`` over ``group_sizes`` (int32, on the device, never read by
    the host); returns bf16 ``[E, d, f]``, zeros for an empty group."""
    name = "grouped_matmul_tgmm"
    dev = lhs.device
    _check(dev.type == "cuda", name, f"tensors must be on a CUDA device, got {dev}")
    _check(lhs.dim() == 2 and dout.dim() == 2 and dout.shape[0] == lhs.shape[0], name,
           "lhs must be [rows, d] and dout [rows, f]")
    rows, d = lhs.shape
    f = dout.shape[1]
    n_groups = group_sizes.shape[0] if group_sizes.dim() == 1 else 0
    _check(1 <= n_groups <= _TG_MAX_GROUPS, name,
           f"group_sizes must be [E], 1 <= E <= {_TG_MAX_GROUPS}")
    _check(d % 8 == 0 and f % 8 == 0 and d > 0 and f > 0, name, "d % 8 and f % 8 must be 0")
    _check(lhs.dtype == torch.bfloat16 and dout.dtype == torch.bfloat16, name,
           "lhs and dout must be bfloat16")
    _check(group_sizes.dtype == torch.int32, name, "group_sizes must be int32")
    for t in (lhs, dout, group_sizes):
        _check(t.device == dev, name, "all tensors must be on one CUDA device")
        _check(t.is_contiguous(), name, "tensors must be contiguous")
        _check(t.data_ptr() % 16 == 0 or t.numel() == 0, name, "tensors must be 16-byte aligned")
    if rows == 0:
        return torch.zeros((n_groups, d, f), dtype=torch.bfloat16, device=dev)
    out = torch.empty((n_groups, d, f), dtype=torch.bfloat16, device=dev)
    plan = plan_grouped_matmul_tgmm(n_groups, d, f, _sm_count(dev.index))
    err = _tgmm_entry()(
        lhs.data_ptr(), dout.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
        rows, d, f, n_groups, plan["grid"][0], torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check_launch(name, err)
    grouped_matmul_tgmm.last_plan = plan
    count_launch(grouped_matmul_tgmm)
    return out


class GroupedMatmul(torch.autograd.Function):
    """``grouped_matmul`` with a backward, the counterpart of megablox
    ``gmm``'s ``custom_vjp``. Forward: K4 for CUDA tensors,
    ``grouped_matmul_plain`` for CPU tensors. Backward: ``dlhs`` through
    K4^T and ``drhs`` (in ``rhs``'s dtype) through K6 for CUDA tensors,
    through ``grouped_matmul_plain`` over ``rhs^T`` and
    ``grouped_matmul_tgmm_plain`` for CPU tensors; no other path.
    ``group_sizes`` takes no gradient. A ``QuantizedTensor`` rhs has no
    backward (JAX's int8 kernel has no VJP): asking for a gradient
    through it raises."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, row_group_ids=None):
        ctx.quantized = isinstance(rhs, QuantizedTensor)
        if ctx.quantized:
            ctx.save_for_backward(lhs, group_sizes)
        else:
            ctx.save_for_backward(lhs, rhs, group_sizes)
        return grouped_matmul(lhs, rhs, group_sizes, row_group_ids=row_group_ids)

    @staticmethod
    def backward(ctx, dout):
        if ctx.quantized:
            raise NotImplementedError(
                "grouped_matmul has no backward through a quantized (int8) rhs")
        lhs, rhs, group_sizes = ctx.saved_tensors
        dout = dout.contiguous()
        cpu = dout.device.type == "cpu"
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = (grouped_matmul_plain(dout, rhs.transpose(1, 2), group_sizes) if cpu
                    else grouped_matmul_bf16_t(dout, rhs, group_sizes))
        if ctx.needs_input_grad[1]:
            drhs = (grouped_matmul_tgmm_plain(lhs, dout, group_sizes, rhs.dtype) if cpu
                    else grouped_matmul_tgmm(lhs, dout, group_sizes).to(rhs.dtype))
        return dlhs, drhs, None, None


#: kernel launches since the last reset (the CPU path never counts);
#: ``last_plan`` is the last launch's plan
grouped_matmul_bf16.launches = 0
grouped_matmul_int8.launches = 0
grouped_matmul_bf16_t.launches = 0
grouped_matmul_tgmm.launches = 0
grouped_matmul_bf16.last_plan = None
grouped_matmul_int8.last_plan = None
grouped_matmul_bf16_t.last_plan = None
grouped_matmul_tgmm.last_plan = None
