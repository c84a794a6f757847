"""Qwen3-MoE: the Qwen3 module reads both (``architectures/qwen3.py``)."""

from perfbench.architectures.qwen3 import block_specs, dims, engine_model, forward

__all__ = ["block_specs", "dims", "engine_model", "forward"]
