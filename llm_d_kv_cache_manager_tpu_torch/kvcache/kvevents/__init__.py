from .events import (
    AllBlocksCleared,
    BadBlock,
    BlockRemoved,
    BlockStored,
    Event,
    EventBatch,
    Heartbeat,
    IndexSnapshot,
    PodDrained,
    PrefillComplete,
    RequestAudit,
    decode_event_batch,
)
from .publisher import ZMQPublisher, ZMQPublisherConfig

__all__ = [
    "AllBlocksCleared",
    "BadBlock",
    "BlockRemoved",
    "BlockStored",
    "Event",
    "EventBatch",
    "Heartbeat",
    "IndexSnapshot",
    "PodDrained",
    "PrefillComplete",
    "RequestAudit",
    "decode_event_batch",
    "ZMQPublisher",
    "ZMQPublisherConfig",
]
