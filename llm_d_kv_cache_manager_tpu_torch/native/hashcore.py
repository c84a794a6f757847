"""ctypes binding for the C++ chained block-hash kernel.

Build: ``python -m llm_d_kv_cache_manager_tpu_torch.native.build`` (or the repo
Makefile). If the shared library is absent or fails to load, callers fall
back to the pure-Python implementation in
``kvcache/kvblock/token_processor.py`` — behavior is identical; the native
kernel only changes speed.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

from . import build

_LIB_NAME = "libhashcore.so"
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _lib_path() -> str:
    return build.built_library(_LIB_NAME)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    path = _lib_path()
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        # uint64 hashcore_root_hash(const uint8_t* seed, size_t len)
        lib.hashcore_root_hash.restype = ctypes.c_uint64
        lib.hashcore_root_hash.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        # void hashcore_chain(uint64 parent, const uint32_t* tokens, size_t n,
        #                     size_t block_size, uint64_t* out, size_t* out_n)
        lib.hashcore_chain.restype = None
        lib.hashcore_chain.argtypes = [
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_size_t,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def root_hash(seed: str) -> int:
    lib = _load()
    assert lib is not None
    raw = seed.encode("utf-8")
    return int(lib.hashcore_root_hash(raw, len(raw)))


def chain_hashes(parent: int, tokens: Sequence[int], block_size: int) -> list[int]:
    lib = _load()
    assert lib is not None
    n = len(tokens)
    n_blocks = n // block_size
    if n_blocks == 0:
        return []
    tok_arr = (ctypes.c_uint32 * n)(*[int(t) & 0xFFFFFFFF for t in tokens])
    out = (ctypes.c_uint64 * n_blocks)()
    out_n = ctypes.c_size_t(0)
    lib.hashcore_chain(
        ctypes.c_uint64(parent), tok_arr, n, block_size, out, ctypes.byref(out_n)
    )
    return [int(out[i]) for i in range(out_n.value)]
