"""One cell on one pod: set-up, traffic runs, readings and the check.

``Bench`` builds the cell's pod once (kernels, weights, ``PodServer``,
warm-up) and runs traffic against it; ``run.py`` runs it once per
process, the sweep and readings scripts several times.
"""

from __future__ import annotations

import gc
import math
import os
import sys
import time
from dataclasses import dataclass
from typing import Optional

import torch

from . import check, pod, spec
from .load import LoadGenerator, Plan
from .model import Dims
from .probe import Slice, Step, StepProbe
from .weights import Weights

#: top-level module names that must not be loaded in a run's process:
#: JAX and the JAX package (the port's own name begins with the JAX
#: package's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "llm_d_kv_cache_manager_tpu")


def set_environment() -> None:
    """Before the first CUDA call: caches inside the checkout at fixed
    paths, no JAX pulled in by a library that would load it by itself, few
    host threads, and an allocator whose segments grow in place (prefill
    shapes vary from step to step; this keeps the caching allocator's
    reserve close to what is in use)."""
    root = spec.HERE.parent
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Run:
    """One traffic run: what the metrics' readers read."""

    cell: spec.Cell
    m: Dims
    w0: float  # the measured window, monotonic seconds
    w1: float
    requests: list  # every request the load generator submitted
    steps: list[Step]
    slice: Optional[Slice]
    setup_s: float = math.nan
    max_lag_s: float = 0.0
    captures_in_window: int = 0

    @property
    def sample(self) -> list:
        """The requests due inside the window."""
        return [r for r in self.requests if self.w0 <= r.due < self.w1]

    @property
    def layer_sample(self) -> list:
        """The requests the request-level per-layer metrics read: those due
        in the window before the profiled slice (stopping the profiler
        holds the engine loop for a while after it)."""
        if self.slice is None:
            return self.sample
        return [r for r in self.sample if r.due < self.slice.t0]

    @staticmethod
    def failed(r) -> bool:
        return r.error is not None or r.seq is None or not r.finished

    @property
    def window_steps(self) -> list[Step]:
        """Steps wholly inside the window and outside the profiled slice."""
        return [s for s in self.steps if self.w0 <= s.t0 and s.t1 <= self.w1 and not s.in_slice]

    @property
    def slice_steps(self) -> list[Step]:
        sl = self.slice
        return self.steps[sl.i0 : sl.i1] if sl is not None else []


class Bench:
    def __init__(self, cell: spec.Cell, seed: int, device, t_start: float):
        self.cell, self.seed, self.t_start = cell, seed, t_start
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.arch = spec.architecture(cell.hf["model_type"], cell.root)
        self.m = self.arch.dims(cell.hf)
        self.kind = spec.traffic_kind(cell.mix["kind"], cell.root)
        self.split: dict = {}

    def plan(self, seed: int, rate: Optional[float] = None) -> Plan:
        return self.kind.build(self.cell.mix, seed, rate or self.cell.rate, self.m.vocab)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self, plan: Plan) -> dict:
        """Kernels, weights, the pod and its warm-up for ``plan``'s shapes.
        Returns the seconds of each part."""
        t = time.monotonic()
        if self.device.type == "cuda":
            from llm_d_kv_cache_manager_tpu_torch.ops import _build

            _build.build()
        self.split["kernel_load_s"] = time.monotonic() - t
        t = time.monotonic()
        self.weights = Weights(self.arch, self.m, self.seed, self.device)
        self._sync()
        self.split["weights_s"] = time.monotonic() - t
        t = time.monotonic()
        self.sink = pod.EventSink()
        self.server, self.engine = pod.build_pod(
            self.arch.engine_model(self.m), self.cell.pod, self.weights.params, self.seed,
            self.device, self.sink.endpoint)
        self.probe = StepProbe(self.engine, tuple(self.m.spans))
        self._sync()
        self.split["pod_s"] = time.monotonic() - t
        warm = pod.warm_up(self.server, self.engine, plan, self.seed, self.m.vocab)
        self.split["warmup_s"] = warm["seconds"]
        self.split["warmup_captures"] = warm["captures"]
        self.split["warmup_widths_missing"] = warm["widths_missing"]
        self.split["weights_bytes"] = self.weights.bytes
        self.split["kv_pool_bytes"] = 2 * self.engine.k_pages.numel() * self.engine.k_pages.element_size()
        self.split["peak_after_warmup_bytes"] = self.memory_peak()
        return self.split

    def reseed(self, seed: int) -> None:
        """Serve another seed's weights from the same buffers (the pod and
        its captured graphs are kept)."""
        self.seed = seed
        self.weights.refill(seed)
        self._sync()

    def traffic(self, plan: Plan, seconds: float, trace: bool) -> Run:
        mix = self.cell.mix
        ramp = mix["ramp_s"]
        self.probe.reset()
        keys = len(self.engine.decode_graphs.keys)
        t0 = time.monotonic() + 0.05
        w0, w1 = t0 + ramp, t0 + ramp + seconds
        gen = LoadGenerator(plan, lambda p, n: self.server.submit(p, pod.greedy(n)), t0, stop_at=w1)
        if trace and self.device.type == "cuda":
            prof_s = min(self.cell.profile_s, seconds)
            self.probe.arm(at=w1 - prof_s, min_s=prof_s, max_s=3 * prof_s)
        gen.start()
        time.sleep(max(0.0, w0 - time.monotonic()))
        setup_s = time.monotonic() - self.t_start
        time.sleep(max(0.0, w1 - time.monotonic()))
        captures = len(self.engine.decode_graphs.keys) - keys
        if not gen.wait_idle(w1 + mix["drain_s"]):
            self.server.abort(None).result(timeout=60)
            gen.wait_idle(time.monotonic() + 30)
        gen.stop()
        return Run(self.cell, self.m, w0, w1, list(gen.requests), list(self.probe.steps),
                   self.probe.read_slice(), setup_s=setup_s, max_lag_s=gen.max_lag_s(),
                   captures_in_window=captures)

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def close(self) -> None:
        """Stop the pod and free everything the program holds."""
        self.server.shutdown()
        self.sink.close()
        self.probe.uninstall()
        del self.server, self.engine, self.probe, self.weights
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, run: Run, seed: int) -> dict:
        """The served tokens of a sample of the window's requests against
        the reference (the program must be closed first)."""
        picked = check.pick(run.sample, seed, self.cell.check_tokens)
        if not picked:
            return dict.fromkeys(check.NUMBERS, None) | {"tokens": 0, "requests": 0}
        return check.served_gap(self.arch, self.m, seed, picked, self.device)
