"""Each decode burst dispatched as one CUDA graph replay.

The JAX engine's ``decode_steps`` (``num_steps`` model steps with on-device
sampling, one ``lax.scan``) is compiled once per shape by ``jit``; its
counterpart here is a CUDA graph. ``DecodeGraphs`` captures
``llama.decode_steps(..., num_steps=k)`` once per (k, block-table width)
at first use and replays it, so a burst costs the host one graph launch
instead of some twenty kernel launches a layer a step.

- Static device inputs (tokens, positions, seq_lens, block tables,
  temperature, top_k, top_p) live outside the graph pool. Each burst fills
  them from a pinned staging buffer with ``non_blocking`` copies enqueued
  before its replay. A chained (pipelined) burst takes its tokens from the
  previous burst's last sampled column instead, copied device to device
  right after that burst's replay.
- Right after each replay the sampled ids ``[lanes, k]`` are copied to a
  pinned host tensor and an event is recorded after the copy:
  ``Burst.tokens()`` waits on that event alone (the port of JAX's
  ``copy_to_host_async``).
- Before the first capture one eager burst over inactive lanes runs on the
  capture stream, so lazy state (cuBLAS handles and workspaces, the cached
  rope frequencies, the kernels' libraries, ctypes entries, shared-memory
  attributes and libcuda entry points) is made outside capture. Its KV
  writes land in reserved page 0, as every padded lane's do.
- The engine's sampling generator is registered with every graph, so
  replays advance it as eager calls do.
- The kernel wrappers count launches in Python, which a replay does not
  run: each graph keeps the counts its capture added (and takes them back,
  since a capture launches nothing), and every replay adds them again.
  A capture holds ``ops.LAUNCH_LOCK`` throughout: pods in one process run
  engine loops on threads of their own, and another thread's launches must
  not land in this capture's count, nor another capture — or the
  device-wide synchronization ``torch.cuda.graph`` starts with, which
  invalidates a capture in flight on another thread — overlap it.
- All graphs share one memory pool; they never run concurrently (one
  stream), and each graph's output stays referenced, so no capture reuses
  another graph's output buffer.
- On CPU tensors the same code runs without capture: each replay runs the
  burst eagerly through the kernels' plain versions.
- A sharded engine's bursts (``mesh``) are captured as today when every
  shard shares one device. Shards on distinct devices cannot share one
  graph: their bursts run eagerly, and ``capture`` is False.

A capture or replay failure raises; there is no eager fallback on CUDA.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from .. import ops
from ..models import llama

#: static inputs a burst uploads, [lanes] each, by dtype
_INT_INPUTS = ("tokens", "positions", "seq_lens", "top_k")
_FLOAT_INPUTS = ("temperature", "top_p")


def launch_counts() -> dict[str, int]:
    return {name: w.launches for name, w in ops.COUNTED.items()}


def add_launches(delta: dict[str, int]) -> None:
    with ops.LAUNCH_LOCK:
        for name, n in delta.items():
            ops.COUNTED[name].launches += n


def count_launches(fn: Callable):
    """Run ``fn`` (a capture) and return its result and the launches the
    wrappers counted during it, taking those counts back: a capture records
    kernel launches but runs none. ``fn`` runs under ``ops.LAUNCH_LOCK``, so
    another thread's launches wait rather than land in the capture's count,
    and no other capture overlaps it."""
    with ops.LAUNCH_LOCK:
        before = launch_counts()
        out = fn()
        delta = {name: n - before[name] for name, n in launch_counts().items()
                 if n != before[name]}
        add_launches({name: -n for name, n in delta.items()})
    return out, delta


@dataclass
class CapturedBurst:
    """One (k, width) key: its graph (None on the CPU), the eager burst it
    captured, the static output, the launches one replay stands for, and
    the plan (``last_plan``) each kernel wrapper recorded at capture."""

    graph: Optional[object]
    fn: Callable[[], torch.Tensor]
    out: Optional[torch.Tensor] = None
    launches: dict = field(default_factory=dict)
    plans: dict = field(default_factory=dict)

    def replay(self) -> torch.Tensor:
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        add_launches(self.launches)
        return self.out


class Burst:
    """The sampled ids of one dispatched burst on their way to the host;
    ``key`` is the (k, block-table width) of the graph that sampled them."""

    def __init__(self, host: torch.Tensor, event: Optional[torch.cuda.Event],
                 key: tuple[int, int]):
        self._host = host
        self._event = event
        self.key = key

    def tokens(self) -> np.ndarray:
        """``[lanes, k]`` int32; waits for this burst's copy only."""
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy().copy()


class DecodeGraphs:
    """Captures and replays the decode bursts of one engine: its params,
    pools, lane count and sampling generator are fixed for its life."""

    def __init__(self, params, cfg, k_pages, v_pages, k_scales, v_scales, *,
                 lanes: int, max_pages: int, page_size: int,
                 generator: torch.Generator, device: torch.device, chain: bool,
                 mesh=None):
        """``max_pages``: the widest block table a burst may pass.
        ``chain``: after each replay, copy the last sampled column into the
        token input (the pipelined engine's next burst reads it there).
        ``mesh``: the engine's mesh (``device`` is its first device)."""
        self.params, self.cfg, self.mesh = params, cfg, mesh
        self._pools = dict(k_pages=k_pages, v_pages=v_pages, k_scales=k_scales, v_scales=v_scales)
        self.lanes, self.page_size = lanes, page_size
        self.device = device
        self._generator = generator
        self._chain = chain
        self._cuda = device.type == "cuda"
        #: bursts are CUDA graph replays (else each runs eagerly)
        self.capture = self._cuda and (mesh is None or len(set(mesh.devices)) == 1)
        self._inputs = {name: torch.zeros(lanes, dtype=torch.int32, device=device)
                        for name in _INT_INPUTS}
        self._inputs.update({name: torch.zeros(lanes, dtype=torch.float32, device=device)
                             for name in _FLOAT_INPUTS})
        self._inputs["top_p"].fill_(1.0)
        self._tables: dict[int, torch.Tensor] = {}
        self._graphs: dict[tuple[int, int], CapturedBurst] = {}
        # Two staging slots and two host outputs a k, used in turn: a
        # pipelined engine reads burst N's ids while burst N+1 is in flight.
        self._stage = [self._staging(max_pages) for _ in range(2)]
        self._uploaded: list[Optional[torch.cuda.Event]] = [None, None]
        self._host: dict[int, list[torch.Tensor]] = {}
        self._turn = 0
        self._pool = torch.cuda.graph_pool_handle() if self._cuda else None
        self._stream = torch.cuda.Stream(device) if self._cuda else None
        #: model steps run eagerly by the warm-up (their kernel launches are
        #: real and counted)
        self.warmup_steps = 0

    @property
    def keys(self) -> list[tuple[int, int]]:
        """(k, block-table width) of every graph captured so far."""
        return sorted(self._graphs)

    def pool_bytes(self) -> int:
        """Device bytes held by the graphs' shared memory pool."""
        if not self._cuda:
            return 0
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def _staging(self, max_pages: int) -> dict[str, torch.Tensor]:
        pin = self._cuda
        stage = {name: torch.zeros(self.lanes, dtype=torch.int32, pin_memory=pin)
                 for name in _INT_INPUTS}
        stage.update({name: torch.zeros(self.lanes, dtype=torch.float32, pin_memory=pin)
                      for name in _FLOAT_INPUTS})
        stage["table"] = torch.zeros(self.lanes * max_pages, dtype=torch.int32, pin_memory=pin)
        return stage

    def _burst(self, k: int, inputs: dict, table: torch.Tensor) -> torch.Tensor:
        pools = self._pools
        return llama.decode_steps(
            self.params, self.cfg, inputs["tokens"], inputs["positions"],
            pools["k_pages"], pools["v_pages"], table, inputs["seq_lens"],
            inputs["temperature"], inputs["top_k"], inputs["top_p"], self._generator,
            page_size=self.page_size, num_steps=k,
            k_scales=pools["k_scales"], v_scales=pools["v_scales"], mesh=self.mesh,
        )[0]

    def _warmup(self, k: int, width: int) -> None:
        """One eager burst over inactive lanes (seq_lens 0, all-zero
        tables: every write goes to reserved page 0) on the capture stream.
        The generator's state is put back afterwards."""
        state = self._generator.get_state()
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            idle = {name: torch.zeros_like(t) for name, t in self._inputs.items()}
            idle["top_p"].fill_(1.0)
            self._burst(k, idle, torch.zeros((self.lanes, width), dtype=torch.int32,
                                              device=self.device))
        current.wait_stream(self._stream)
        self._generator.set_state(state)
        self.warmup_steps += k

    def _capture(self, k: int, width: int) -> CapturedBurst:
        table = self._tables.get(width)
        if table is None:
            table = self._tables[width] = torch.zeros(
                (self.lanes, width), dtype=torch.int32, device=self.device)

        def fn():
            return self._burst(k, self._inputs, table)

        if not self.capture:
            return CapturedBurst(None, fn)
        if not self.warmup_steps:
            self._warmup(k, width)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._generator)

        def capture():
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                  capture_error_mode="thread_local"):
                return fn()

        out, launches = count_launches(capture)
        plans = {name: getattr(ops.COUNTED[name], "last_plan", None) for name in launches}
        return CapturedBurst(graph, fn, out, launches, plans)

    def dispatch(self, k: int, tokens: Optional[np.ndarray], positions: np.ndarray,
                 seq_lens: np.ndarray, block_tables: np.ndarray, temperature: np.ndarray,
                 top_k: np.ndarray, top_p: np.ndarray) -> Burst:
        """Enqueue one burst of ``k`` steps: upload its inputs, replay (or,
        first, capture) its graph, start the copy of its sampled ids to the
        host. ``tokens`` None chains: the token input already holds the
        previous burst's last sampled column."""
        lanes, width = block_tables.shape
        if lanes != self.lanes:
            raise ValueError(f"a burst has {lanes} lanes, the graphs {self.lanes}")
        burst = self._graphs.get((k, width))
        if burst is None:
            burst = self._graphs[(k, width)] = self._capture(k, width)
        slot, self._turn = self._turn, self._turn ^ 1
        if self._uploaded[slot] is not None:
            self._uploaded[slot].synchronize()  # the staging slot's last upload
        stage = self._stage[slot]
        host = dict(positions=positions, seq_lens=seq_lens, temperature=temperature,
                    top_k=top_k, top_p=top_p)
        if tokens is not None:
            host["tokens"] = tokens
        for name, a in host.items():
            stage[name].numpy()[:] = a
            self._inputs[name].copy_(stage[name], non_blocking=True)
        n = lanes * width
        stage["table"].numpy()[:n] = block_tables.reshape(-1)
        self._tables[width].copy_(stage["table"][:n].view(lanes, width), non_blocking=True)
        if self._cuda:
            self._uploaded[slot] = torch.cuda.Event()
            self._uploaded[slot].record()

        out = burst.replay()
        outs = self._host.get(k)
        if outs is None:
            outs = self._host[k] = [torch.zeros((lanes, k), dtype=torch.int32,
                                                pin_memory=self._cuda) for _ in range(2)]
        outs[slot].copy_(out, non_blocking=True)
        event = None
        if self._cuda:
            event = torch.cuda.Event()
            event.record()
        if self._chain:
            self._inputs["tokens"].copy_(out[:, -1])
        return Burst(outs[slot], event, (k, width))
