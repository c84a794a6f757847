from .block_manager import BlockManager, BlockManagerConfig, AllocationError
from .sequence import Sequence, SequenceStatus, SamplingParams
from .engine import Engine, EngineConfig
from .scheduler import Scheduler, SchedulerConfig

__all__ = [
    "BlockManager",
    "BlockManagerConfig",
    "AllocationError",
    "Sequence",
    "SequenceStatus",
    "SamplingParams",
    "Engine",
    "EngineConfig",
    "Scheduler",
    "SchedulerConfig",
]
