"""The benchmark of ``llm_d_kv_cache_manager_tpu_torch`` on one NVIDIA H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line. Everything a
cell needs is found by name under this directory (``spec.py``); the
program under test is the PyTorch/CUDA port, driven through
``PodServer.submit``.
"""
