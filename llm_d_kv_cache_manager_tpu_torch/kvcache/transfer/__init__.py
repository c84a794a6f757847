"""Cross-pod KV-block transfer: pull a peer's warm prefix instead of
recomputing it.

Framework-free copies of the JAX package's modules of the same names:

- ``protocol``: the msgpack wire format of block-chain fetches (msgpack is
  imported where it is used, so the port imports without it);
- ``service`` / ``client``: the ZMQ ROUTER export service a pod binds and
  the DEALER client (with its circuit breaker) peers fetch through;
- ``cost_model``: the measured bytes/s-vs-tokens/s accounting behind the
  router's route-to-warm / pull-then-compute / cold-recompute decision.

The engine's export and import endpoints live in ``server/engine.py``;
``server/serve.py`` binds the service (``TRANSFER_ENDPOINT``) and pulls
(``pull_prefix``, ``ASYNC_PULL``). The remote tier's holder side
(``remote_store``) is not ported.
"""

from .client import (
    CircuitBreaker,
    KVTransferClient,
    TransferClientConfig,
    TransferClientPool,
    TransferError,
)
from .cost_model import TransferCostModel, TransferCostModelConfig
from .protocol import (
    BlockPayload,
    MigrationPayload,
    decode_migrate,
    decode_migrate_ack,
    decode_push,
    decode_push_ack,
    decode_request,
    decode_response,
    encode_migrate,
    encode_migrate_ack,
    encode_push,
    encode_push_ack,
    encode_request,
    encode_response,
)
from .service import KVTransferService, TransferServiceConfig

__all__ = [
    "BlockPayload",
    "CircuitBreaker",
    "KVTransferClient",
    "KVTransferService",
    "MigrationPayload",
    "TransferClientConfig",
    "TransferClientPool",
    "TransferCostModel",
    "TransferCostModelConfig",
    "TransferError",
    "TransferServiceConfig",
    "decode_migrate",
    "decode_migrate_ack",
    "encode_migrate",
    "encode_migrate_ack",
    "decode_push",
    "decode_push_ack",
    "decode_request",
    "decode_response",
    "encode_push",
    "encode_push_ack",
    "encode_request",
    "encode_response",
]
