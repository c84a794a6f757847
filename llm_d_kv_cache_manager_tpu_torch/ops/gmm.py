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
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Union

import torch

from ..models.quant import QuantizedTensor
from . import _build

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
                        sm_count: int) -> dict:
    """The launch of one grouped matmul, from integers alone (never a tensor
    value, so the launch never synchronises with the host).

    ``rows < 16 * n_groups`` (under 16 rows an expert on average) takes the
    decode path: one block per (64 bf16 / 128 int8 columns of f, group),
    plus one row of blocks for the zero tail. Otherwise the prefill path:
    persistent blocks, one an SM, never more than the group-aligned tiles
    there can be (``ceil(rows / 128) + n_groups + 1`` row tiles, each
    non-empty group adding at most one partial tile and the tail one, times
    ``ceil(f / 256)``). Raises for widths TMA cannot tile: ``d * 2`` and
    ``f`` times the element size must be multiples of 16 bytes."""
    elem = 1 if quantized else 2
    if d < 1 or f < 1 or (d * 2) % 16 or (f * elem) % 16:
        raise ValueError(f"grouped_matmul: d * 2 = {d * 2} and f * {elem} = {f * elem} "
                         "must be positive multiples of 16 bytes")
    if rows < 16 * n_groups:
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
    out = torch.zeros((rows, rhs.shape[2]), dtype=torch.float32, device=lhs.device)
    start = 0
    for g, n in enumerate(group_sizes.tolist()):
        n = min(max(int(n), 0), rows - start)
        if n > 0:
            w = (rhs.q if quantized else rhs)[g].float()
            o = lhs[start : start + n].float() @ w
            out[start : start + n] = o * rhs.scale[g].float() if quantized else o
        start += n
    return out.to(lhs.dtype)


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


def _check(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name} (CUDA): {msg}")


def _launch(name: str, lhs, b, scale, group_sizes) -> tuple[torch.Tensor, Optional[dict]]:
    """Check the operands and launch K4 (``scale`` None) or K5 as
    ``plan_grouped_matmul`` plans it; returns the output and the plan (None
    when there are no rows and nothing is launched)."""
    dev = lhs.device
    _check(dev.type == "cuda", name, f"tensors must be on a CUDA device, got {dev}")
    _check(lhs.dim() == 2 and b.dim() == 3, name, "lhs must be [rows, d] and rhs [E, d, f]")
    rows, d = lhs.shape
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
    plan = plan_grouped_matmul(rows, n_groups, d, f, scale is not None, _sm_count(dev.index))
    ptrs = (lhs.data_ptr(), b.data_ptr()) + ((scale.data_ptr(),) if scale is not None else ())
    grid = plan["grid"]
    err = _entry(scale is not None)(
        *ptrs, group_sizes.data_ptr(), out.data_ptr(), rows, d, f, n_groups,
        0 if plan["path"] == "prefill" else 1, grid[0], grid[1],
        torch.cuda.current_stream(dev).cuda_stream,
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
        grouped_matmul_bf16.launches += 1
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
        grouped_matmul_int8.launches += 1
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


#: kernel launches since the last reset (the CPU path never counts);
#: ``last_plan`` is the last launch's ``plan_grouped_matmul``
grouped_matmul_bf16.launches = 0
grouped_matmul_int8.launches = 0
grouped_matmul_bf16.last_plan = None
grouped_matmul_int8.last_plan = None
