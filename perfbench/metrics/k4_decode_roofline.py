"""Kernels, K4 (``csrc/grouped_matmul.cu``, its decode kernel): the least
time the profiled slice's decode grouped matmuls need, over the device
time of K4's decode kernel in the slice, in percent. A model step's work,
from the program's ``k4_touched`` count (the expert groups its rows
touched, summed over layers, padded lanes included as K4 receives them):
each touched expert's gate, up and down weights read once, and each
layer's rows (lanes × top-k) read as inputs, written as intermediates and
written as outputs once; its FLOPs are 2 × rows × d × inter × 3 a layer."""

from perfbench.program import slice_entries
from perfbench.readers import roofline_pct
from perfbench.work import bound_s

LAYER = "kernels"
UNIT = "%"
MOVES = "tpot_p95_ms"
#: profiler name of K4's decode kernel; K1's ``split_decode_kernel`` does
#: not hold it
KERNELS = ("::decode_kernel<",)


def work(m, lanes: int, touched: int) -> tuple[float, float]:
    """(bytes, FLOPs) of one model step's three grouped matmuls in every
    layer, ``touched`` expert groups in all."""
    b, rows = m.dtype_bytes, lanes * m.top_k
    weights = touched * 3 * m.d * m.moe_inter * b
    acts = m.layers * rows * (2 * m.d + m.moe_inter) * b
    return weights + acts, m.layers * 2.0 * rows * m.d * m.moe_inter * 3


def read(run):
    entries = slice_entries(run)
    if entries is None or not run.m.experts:
        return None
    lanes = run.cell.pod["decode_batch_size"]
    counts = [n for e in entries for n in e["counters"].get("k4_touched", [])]
    bound = sum(bound_s(*work(run.m, lanes, n)) for n in counts)
    return roofline_pct(run, KERNELS, bound)
