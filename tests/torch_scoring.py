"""Shared harness of the scoring-plane tests that hold the port's scoring
service against the JAX package's (``test_torch_scoring_*.py``).

- Each package gets a char-level tokenizer of its own (token id =
  ``ord(char)``, as ``conftest.CharTokenizer``), so a prompt string and the
  token ids a pod served are one and the same.
- The port's metrics collector registers into a registry of its own: the
  JAX package's collector owns the process-wide default registry under the
  same metric names, and JAX tests that run later in the same process must
  still be able to register there.
- ``join`` waits until a publisher's PUB socket reaches a scorer's SUB
  socket by publishing empty batches, which change no index or counter.
"""

from __future__ import annotations

import socket
import time

import prometheus_client

from llm_d_kv_cache_manager_tpu.tokenization.tokenizer import Tokenizer as JaxTokenizer
from llm_d_kv_cache_manager_tpu_torch.kvcache.metrics import collector as port_collector
from llm_d_kv_cache_manager_tpu_torch.tokenization.tokenizer import Tokenizer as PortTokenizer

port_collector.register(prometheus_client.CollectorRegistry())


def _encode(prompt):
    return [ord(c) for c in prompt], [(i, i + 1) for i in range(len(prompt))]


class JaxCharTokenizer(JaxTokenizer):
    def encode(self, prompt, model_name):
        return _encode(prompt)


class PortCharTokenizer(PortTokenizer):
    def encode(self, prompt, model_name):
        return _encode(prompt)


def text(tokens) -> str:
    """The prompt string whose char tokens are ``tokens``."""
    return "".join(map(chr, tokens))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def join(pairs, pod: str, timeout: float = 10.0) -> None:
    """Publish empty batches from every ``(publisher, service)`` pair
    (topic of ``pod``), all in lock step, until each service's fleet
    health has seen one. The publishers then stand at the same sequence
    number, so what follows reaches every service with the same ``seq``."""
    deadline = time.monotonic() + timeout
    while not all(pod in svc.fleet_health.snapshot()["pods"] for _, svc in pairs):
        assert time.monotonic() < deadline, f"{pod} never reached the scorer"
        for pub, _ in pairs:
            pub.publish([])
        time.sleep(0.02)
    for _, svc in pairs:
        assert svc.events_pool.drain(timeout)


def wait_for(predicate, timeout: float = 10.0, what: str = "condition") -> None:
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)
