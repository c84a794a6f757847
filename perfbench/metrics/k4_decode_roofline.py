"""Kernels, K4 (``csrc/grouped_matmul.cu``, its decode kernel): the least
time the profiled slice's decode grouped matmuls need, over the device
time of K4's decode kernel in the slice, in percent. A model step's work,
from the program's ``k4_touched`` count (the expert groups its rows
touched, summed over the routed layers, padded lanes included as K4
receives them): each touched expert's gate, up and down weights read once,
and each routed layer's rows (lanes × its top-k) read as inputs, written
as intermediates and written as outputs once; its FLOPs are
2 × rows × d × width × 3 a routed layer. Dense layers, and a shared expert
beside the routed ones, are not K4's."""

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
    routed layer, ``touched`` expert groups in all."""
    routed = {}
    for layer, n in m.kinds.items():
        if layer.ffn.experts:
            key = (layer.ffn.top_k, layer.ffn.width)
            routed[key] = routed.get(key, 0) + n
    widths = {w for _, w in routed}
    if len(widths) != 1:
        raise ValueError("K4's touched count sums over routed layers of one expert width")
    b, (width,) = m.dtype_bytes, widths
    weights = touched * 3 * m.d * width * b
    acts = sum(n * lanes * top_k * (2 * m.d + w) * b for (top_k, w), n in routed.items())
    flops = sum(n * 2.0 * lanes * top_k * m.d * w * 3 for (top_k, w), n in routed.items())
    return weights + acts, flops


def read(run):
    entries = slice_entries(run)
    if entries is None or not any(layer.ffn.experts for layer in run.m.kinds):
        return None
    lanes = run.cell.pod["decode_batch_size"]
    counts = [n for e in entries for n in e["counters"].get("k4_touched", [])]
    bound = sum(bound_s(*work(run.m, lanes, n)) for n in counts)
    return roofline_pct(run, KERNELS, bound)
