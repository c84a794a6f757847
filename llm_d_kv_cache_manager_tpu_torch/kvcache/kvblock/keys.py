"""Core KV-block identity types.

Parity with reference ``pkg/kvcache/kvblock/index.go:128-144`` (``Key``,
``PodEntry``), retargeted to a TPU fleet: device tiers are
``{tpu_hbm, host_dram}`` instead of the reference's hardcoded ``"gpu"``
(``pkg/kvcache/kvevents/pool.go:247``).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum


class DeviceTier(str, Enum):
    """Where a KV block physically lives on a TPU host."""

    TPU_HBM = "tpu_hbm"
    HOST_DRAM = "host_dram"
    # Remote/offloaded tier reserved for cross-host block migration.
    REMOTE = "remote"

    def __str__(self) -> str:  # noqa: D105
        return self.value


#: Default tier recorded for events that carry no ``Medium`` field.
DEFAULT_TIER = DeviceTier.TPU_HBM

#: Mapping from event ``Medium`` strings to tiers. The serving engine tags
#: events with these strings; unknown mediums fall back to DEFAULT_TIER.
MEDIUM_TO_TIER = {
    "": DEFAULT_TIER,
    "tpu_hbm": DeviceTier.TPU_HBM,
    "hbm": DeviceTier.TPU_HBM,
    "gpu": DeviceTier.TPU_HBM,  # reference engines tag accelerator memory "gpu"
    "host_dram": DeviceTier.HOST_DRAM,
    "cpu": DeviceTier.HOST_DRAM,
    "remote": DeviceTier.REMOTE,
}


def tier_for_medium(medium: str | None) -> DeviceTier:
    """Absent medium → default tier; *unknown* medium fails safe to the
    slowest local tier so the scorer never overstates locality."""
    if medium is None:
        return DEFAULT_TIER
    return MEDIUM_TO_TIER.get(medium.lower(), DeviceTier.HOST_DRAM)


@dataclass(frozen=True, slots=True)
class Key:
    """Identity of one KV block: (model, chunk hash).

    ``chunk_hash`` is the uint64 chained sha256-CBOR prefix hash of the block
    (see ``token_processor.py``).
    """

    model_name: str
    chunk_hash: int  # uint64

    def __str__(self) -> str:
        return f"{self.model_name}@{self.chunk_hash}"


@dataclass(frozen=True, slots=True)
class PodEntry:
    """One locality record: which pod (TPU server replica) holds the block,
    and on which memory tier."""

    pod_identifier: str
    device_tier: DeviceTier = DEFAULT_TIER

    def __str__(self) -> str:
        return f"{self.pod_identifier}@{self.device_tier}"
