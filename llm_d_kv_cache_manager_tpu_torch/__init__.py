"""PyTorch / CUDA port of ``llm_d_kv_cache_manager_tpu`` for one NVIDIA
Hopper GPU.

The serving pod's main path — paged-KV Llama prefill and decode, the
prefix-caching block manager and scheduler, KV-event publishing — with
hand-written CUDA kernels for paged decode attention and flash prefill
(``csrc/``). Entry points run on CUDA unless the caller passes
``device="cpu"``, which takes the kernels' plain PyTorch versions.
"""
