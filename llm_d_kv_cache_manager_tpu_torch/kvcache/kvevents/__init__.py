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
from .health import FleetHealth, FleetHealthConfig
from .pool import KVEventsPool, KVEventsPoolConfig, Message, fnv1a_32
from .zmq_subscriber import ZMQSubscriber, ZMQSubscriberConfig, parse_topic
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
    "FleetHealth",
    "FleetHealthConfig",
    "KVEventsPool",
    "KVEventsPoolConfig",
    "Message",
    "fnv1a_32",
    "ZMQSubscriber",
    "ZMQSubscriberConfig",
    "parse_topic",
    "ZMQPublisher",
    "ZMQPublisherConfig",
]
