"""Shared harness of the fleet-contract tests that hold the port's pod
(admission, drain, heartbeats and resync, ``/stats``, ``/metrics``,
tracing) against the JAX package's (``test_torch_overload.py``,
``test_torch_fleet_chaos.py``, ``test_torch_pod_surfaces.py``).

- ``pod`` builds either package's ``PodServer`` on TINY_LLAMA's shared
  parameters (pages of 4, the JAX engine in interpret mode), events
  unpublished unless a publisher is passed.
- ``RecordingPublisher`` duck-types ``ZMQPublisher`` for either package and
  keeps the batches it was handed, and their msgpack payloads.
- ``gate_engine`` blocks a pod's engine steps while a gate is cleared, so
  requests pile up in staging and the scheduler deterministically.
"""

from __future__ import annotations

import functools
import threading
import time

from llm_d_kv_cache_manager_tpu.kvcache.kvevents import EventBatch as JEventBatch
from llm_d_kv_cache_manager_tpu.server import Engine as JEngine
from llm_d_kv_cache_manager_tpu.server import SamplingParams as JSP
from llm_d_kv_cache_manager_tpu.server.serve import PodServer as JPod
from llm_d_kv_cache_manager_tpu.server.serve import PodServerConfig as JPodConfig
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvevents import EventBatch as TEventBatch
from llm_d_kv_cache_manager_tpu_torch.server import Engine as TEngine
from llm_d_kv_cache_manager_tpu_torch.server import SamplingParams as TSP
from llm_d_kv_cache_manager_tpu_torch.server.serve import PodServer as TPod
from llm_d_kv_cache_manager_tpu_torch.server.serve import PodServerConfig as TPodConfig
from test_torch_engine import _params
from test_torch_engine import _prompt as prompt  # noqa: F401
from test_torch_engine import JBM, JEC, JSC, TBM, TEC, TSC, jl, tl

PS = 4
MODEL = "tiny-llama"
SIDES = (True, False)  # torch, JAX


@functools.lru_cache(maxsize=1)
def shared_params():
    """TINY_LLAMA's parameters from one seed: (JAX's, the port's)."""
    return _params("TINY_LLAMA")


def sampling(torch_side: bool, **kw):
    return (TSP if torch_side else JSP)(**kw)


class RecordingPublisher:
    """Duck-types ZMQPublisher; records batches (and their wire bytes) for
    assertions. ``torch_side`` picks the package whose ``EventBatch``
    encodes them."""

    def __init__(self, torch_side: bool):
        self._batch = TEventBatch if torch_side else JEventBatch
        self.config = type("C", (), {"data_parallel_rank": None})()
        self.batches: list = []
        self.dropped_batches = 0
        self._mu = threading.Lock()

    def publish(self, events, ts=None):
        with self._mu:
            self.batches.append(self._batch(ts=ts or 0.0, events=list(events)))
            return len(self.batches) - 1

    def events(self, kind_name: str) -> list:
        with self._mu:
            return [e for b in self.batches for e in b.events
                    if type(e).__name__ == kind_name]

    def payloads(self, kind_name: str) -> list[bytes]:
        """Wire bytes of each batch that holds only ``kind_name`` events,
        re-encoded at ts 1.0 (the publish time is not compared)."""
        with self._mu:
            return [self._batch(ts=1.0, events=b.events).to_payload() for b in self.batches
                    if b.events and all(type(e).__name__ == kind_name for e in b.events)]

    def close(self):
        pass


def engine_config(torch_side: bool, total_pages: int = 64, max_model_len: int = 64,
                  scheduler_kw=None, host_pages: int = 0, **knobs):
    """test_overload's engine: TINY_LLAMA, pages of 4, prefill batch 4, 4
    decode lanes; ``knobs``: further ``EngineConfig`` fields."""
    sched = dict(max_prefill_batch=4, **(scheduler_kw or {}))
    if torch_side:
        bm = TBM(total_pages=total_pages, page_size=PS, host_pages=host_pages)
        return TEC(model=tl.TINY_LLAMA, block_manager=bm, scheduler=TSC(**sched),
                   max_model_len=max_model_len, decode_batch_size=4, prefill_bucket=8, **knobs)
    bm = JBM(total_pages=total_pages, page_size=PS, host_pages=host_pages)
    return JEC(model=jl.TINY_LLAMA, block_manager=bm, scheduler=JSC(**sched),
               max_model_len=max_model_len, decode_batch_size=4, prefill_bucket=8,
               interpret=True, **knobs)


def pod(torch_side: bool, pod_id: str, *, publisher=None, total_pages: int = 64,
        engine_kw=None, start: bool = True, **cfg):
    """A pod on TINY_LLAMA's shared parameters (pages of 4); ``cfg``:
    further ``PodServerConfig`` fields; ``engine_kw``: ``engine_config``
    arguments. The pod's ``remote_tier``/``remote_store_pages`` and
    ``kv_integrity`` reach the engine's config, as a pod that builds its own
    engine threads them."""
    jp, tp = shared_params()
    knobs = {}
    if cfg.get("remote_tier"):
        knobs.update(remote_tier=True, remote_store_pages=cfg.get("remote_store_pages", 0))
    if cfg.get("kv_integrity"):
        knobs["kv_integrity"] = True
    econf = engine_config(torch_side, total_pages=total_pages, **{**knobs, **(engine_kw or {})})
    if torch_side:
        config = TPodConfig(model_name=MODEL, pod_identifier=pod_id, publish_events=False,
                            engine=econf, **cfg)
        server = TPod(config, engine=TEngine(econf, params=tp, device="cpu"), publisher=publisher)
    else:
        config = JPodConfig(model_name=MODEL, pod_identifier=pod_id, publish_events=False,
                            engine=econf, **cfg)
        server = JPod(config, engine=JEngine(econf, params=jp), publisher=publisher)
    if start:
        server.start()
    return server


def gate_engine(server, gate: threading.Event) -> None:
    """Block engine steps while ``gate`` is cleared (requests then pile up
    in staging/waiting deterministically; admissions still run)."""
    orig = server.engine.step

    def gated_step():
        if not gate.is_set():
            gate.wait(10)
        return orig()

    server.engine.step = gated_step


def wait_until(predicate, timeout: float = 30.0, interval: float = 0.01) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return bool(predicate())
