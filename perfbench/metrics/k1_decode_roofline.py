"""Kernels, K1 (``csrc/paged_decode.cu``): the least time the profiled
slice's decode attention calls need, over the device time of K1's kernels
in the slice, in percent. A call is one layer of one model step; its work
is the K and V of each lane's last ``span`` positions of its context (the
current token included; the whole context where the layer's span is
None), each token read once however many lanes share it (a shared system
prompt), plus the lanes' queries and outputs, read and written once; its
FLOPs are every lane's QK^T and PV over those positions. Summed over the
model's layers, each with its own span."""

from typing import Optional

from perfbench.readers import roofline_pct
from perfbench.work import bound_s

LAYER = "kernels"
UNIT = "%"
MOVES = "tpot_p95_ms"
#: profiler names of K1's kernels: the split-KV pass and its combine
KERNELS = ("split_decode_kernel<__nv_bfloat16", "::combine_kernel")


def work(m, ctx_lens: list[int], kv_tokens: int, span: Optional[int] = None) -> tuple[float, float]:
    """(bytes, FLOPs) of one call with attention span ``span`` over lanes
    at contexts ``ctx_lens`` whose last ``span`` positions hold
    ``kv_tokens`` distinct tokens."""
    b = m.dtype_bytes
    kv = kv_tokens * 2 * m.kv_heads * m.hd * b
    q_out = len(ctx_lens) * 2 * m.heads * m.hd * b
    keys = sum(ctx_lens) if span is None else sum(min(c, span) for c in ctx_lens)
    return kv + q_out, 4.0 * m.heads * m.hd * keys


def read(run):
    bound = 0.0
    for s in run.slice_steps:
        for j in range(s.decode_steps if s.lanes else 0):
            # step j of a burst adds one token to each lane's own last page
            ctx = [c + j for c in s.lanes]
            for span, n in run.m.spans.items():
                bound += n * bound_s(*work(run.m, ctx, s.lane_kv_tokens[span][j], span))
    return roofline_pct(run, KERNELS, bound)
