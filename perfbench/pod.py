"""The system under test: the port's ``Engine`` behind a started
``PodServer``, publishing KV events to a loopback ZMQ socket that the
harness drains, and its warm-up.

With the kernel build in ``bench.py`` and each architecture's
``engine_model``, the only code of the harness that imports the port
(``llm_d_kv_cache_manager_tpu_torch``).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .load import Plan


class EventSink:
    """A SUB socket bound on loopback that reads and counts the pod's
    KV-event messages until closed, as an indexer would."""

    def __init__(self):
        import zmq

        self._ctx = zmq.Context()
        self._sock = self._ctx.socket(zmq.SUB)
        self._sock.setsockopt(zmq.SUBSCRIBE, b"")
        self._sock.setsockopt(zmq.LINGER, 0)
        self._sock.bind("tcp://127.0.0.1:*")
        self.endpoint = self._sock.getsockopt(zmq.LAST_ENDPOINT).decode()
        self.messages = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="perfbench-events", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        import zmq

        poller = zmq.Poller()
        poller.register(self._sock, zmq.POLLIN)
        while not self._stop.is_set():
            if poller.poll(100):
                self._sock.recv_multipart()
                self.messages += 1

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        self._sock.close()
        self._ctx.term()


def build_pod(model, pod: dict, params: dict, seed: int, device, events_endpoint: str):
    """A started ``PodServer`` over an ``Engine`` of the port's model
    configuration ``model`` (the architecture's ``engine_model``) on
    ``params``, with the configuration's deployment settings (``pod``)."""
    from llm_d_kv_cache_manager_tpu_torch.server import (
        BlockManagerConfig,
        Engine,
        EngineConfig,
        SchedulerConfig,
    )
    from llm_d_kv_cache_manager_tpu_torch.server.serve import PodServer, PodServerConfig

    ecfg = EngineConfig(
        model=model,
        block_manager=BlockManagerConfig(
            total_pages=pod["total_pages"], page_size=pod["page_size"],
            host_pages=pod["host_pages"],
        ),
        scheduler=SchedulerConfig(max_prefill_batch=pod["max_prefill_batch"],
                                  chunked_prefill_tokens=pod["chunked_prefill_tokens"]),
        max_model_len=pod["max_model_len"],
        decode_batch_size=pod["decode_batch_size"],
        decode_steps_per_iter=pod["decode_steps_per_iter"],
        decode_pipeline=pod["decode_pipeline"],
        decode_fused_sampling=pod["decode_fused_sampling"],
        seed=seed,
    )
    engine = Engine(ecfg, params=params, device=device)
    server = PodServer(
        PodServerConfig(
            model_name="perfbench", pod_identifier="perfbench-pod",
            zmq_endpoint=events_endpoint, publish_events=pod["publish_events"], engine=ecfg,
        ),
        engine=engine,
    )
    server.start()
    return server, engine


def greedy(answer_len: int):
    from llm_d_kv_cache_manager_tpu_torch.server.sequence import SamplingParams

    return SamplingParams(max_new_tokens=answer_len, temperature=0.0)


def widths_needed(engine, longest: int) -> list[int]:
    """Block-table widths (pages) of every decode graph a context of up to
    ``longest`` tokens reaches: the engine buckets the longest lane's pages
    (with a pipelined burst's reservation) up to ``decode_pages_bucket``."""
    cfg = engine.config
    ps, k, bucket = engine.page_size, cfg.decode_steps_per_iter, cfg.decode_pages_bucket
    reserve = 2 * k if (cfg.decode_pipeline or cfg.decode_fused_sampling) else k
    top = min(engine.max_pages_per_seq, -(-(longest + reserve - 1) // ps))
    return sorted({min(engine.max_pages_per_seq, -(-p // bucket) * bucket) for p in range(1, top + 1)})


def warm_up(server, engine, plan: Plan, seed: int, vocab: int, timeout_s: float = 600.0) -> dict:
    """Serve, one at a time, the requests that take every shape the plan's
    traffic reaches through its first use: first the plan's longest prompt,
    cold (the widest prefill, which also sizes the allocator's pools), then
    prefixes of it that decode one burst or two at each block-table width
    the plan's contexts reach (each captures its decode graph). Returns the
    seconds and the graphs captured."""
    cfg = engine.config
    lengths = plan.turn_lengths()
    longest_prompt = max(p for p, _ in lengths)
    longest = max(p + a for p, a in lengths)
    rng = np.random.default_rng([seed, 9])
    base = rng.integers(0, vocab, cfg.max_model_len, dtype=np.int64).tolist()
    k = cfg.decode_steps_per_iter
    keys0 = len(engine.decode_graphs.keys)
    t0 = time.monotonic()
    server.generate(base[:longest_prompt], greedy(2 * k + 1), timeout=timeout_s)
    ps, bucket = engine.page_size, cfg.decode_pages_bucket
    widths = widths_needed(engine, longest)
    for w in widths:
        if w == engine.max_pages_per_seq and w % bucket:
            n, new = cfg.max_model_len - 2, 2
        else:
            n, new = ps * (w - bucket // 2), 2 * k + 1
        server.generate(base[:n], greedy(new), timeout=timeout_s)
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    missing = sorted(set(widths) - {w for _, w in engine.decode_graphs.keys})
    return {
        "seconds": time.monotonic() - t0,
        "captures": len(engine.decode_graphs.keys) - keys0,
        "widths": len(widths),
        "widths_missing": missing,
    }
