"""Minimal canonical CBOR encoder (RFC 8949 core deterministic encoding).

The KV-block hash chain requires bit-exact parity with the serving engine's
``sha256_cbor_64bit`` prefix-hash algorithm: each block hash is the low 8
bytes (big-endian) of SHA-256 over the canonical-CBOR encoding of
``[parent_hash, token_chunk, extra]`` (reference
``pkg/kvcache/kvblock/token_processor.go:105-122``, which uses
``cbor.CanonicalEncOptions()``). Canonical encoding for the payload types we
use (unsigned/negative integers, byte/text strings, arrays, null, bool,
floats) means shortest-form argument encoding and definite lengths.

We implement it directly rather than depending on an external cbor library so
the Python indexer, the C++ native kernel (``native/hashcore.cpp``) and the
JAX server's block manager all share one audited definition.
"""

from __future__ import annotations

from typing import Any

try:  # numpy integers show up naturally around JAX; accept them.
    import numpy as _np

    _INT_TYPES: tuple = (int, _np.integer)
except Exception:  # pragma: no cover
    _np = None
    _INT_TYPES = (int,)

_MAJOR_UNSIGNED = 0
_MAJOR_NEGATIVE = 1
_MAJOR_BYTES = 2
_MAJOR_TEXT = 3
_MAJOR_ARRAY = 4
_MAJOR_MAP = 5

_BREAK = 0xFF


def _encode_head(out: bytearray, major: int, arg: int) -> None:
    """Shortest-form head encoding: RFC 8949 §4.2.1."""
    mt = major << 5
    if arg < 24:
        out.append(mt | arg)
    elif arg < 0x100:
        out.append(mt | 24)
        out.append(arg)
    elif arg < 0x10000:
        out.append(mt | 25)
        out += arg.to_bytes(2, "big")
    elif arg < 0x100000000:
        out.append(mt | 26)
        out += arg.to_bytes(4, "big")
    elif arg < 0x10000000000000000:
        out.append(mt | 27)
        out += arg.to_bytes(8, "big")
    else:
        raise OverflowError(f"CBOR argument out of uint64 range: {arg}")


def _encode_item(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xF6)
    elif obj is True:
        out.append(0xF5)
    elif obj is False:
        out.append(0xF4)
    elif isinstance(obj, _INT_TYPES) and not isinstance(obj, bool):
        v = int(obj)
        if v >= 0:
            _encode_head(out, _MAJOR_UNSIGNED, v)
        else:
            _encode_head(out, _MAJOR_NEGATIVE, -1 - v)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _encode_head(out, _MAJOR_BYTES, len(b))
        out += b
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _encode_head(out, _MAJOR_TEXT, len(b))
        out += b
    elif isinstance(obj, float):
        # Hash payloads are integers/strings/arrays/null only. Canonical float
        # encoding (shortest of float16/32/64, canonical NaN) is subtle enough
        # that a partially-canonical encoding would silently break cross-engine
        # hash parity — reject rather than risk it.
        raise TypeError("floats are not supported in hash payloads (parity risk)")
    elif isinstance(obj, (list, tuple)):
        _encode_head(out, _MAJOR_ARRAY, len(obj))
        for item in obj:
            _encode_item(out, item)
    elif _np is not None and isinstance(obj, _np.ndarray):
        if obj.ndim == 0:
            _encode_item(out, obj.item())
        else:
            _encode_head(out, _MAJOR_ARRAY, obj.shape[0])
            for item in obj.tolist():
                _encode_item(out, item)
    elif isinstance(obj, dict):
        # Map ordering: RFC 7049 canonical (length-first, then bytewise) to
        # match fxamacker/cbor's CanonicalEncOptions used by the reference
        # (token_processor.go:85) — NOT RFC 8949 pure-bytewise ordering.
        # Not used by the hash chain today; kept parity-exact in case a
        # future schema hashes a map.
        encoded = []
        for k, v in obj.items():
            kb = bytearray()
            _encode_item(kb, k)
            vb = bytearray()
            _encode_item(vb, v)
            encoded.append((bytes(kb), bytes(vb)))
        encoded.sort(key=lambda kv: (len(kv[0]), kv[0]))
        _encode_head(out, _MAJOR_MAP, len(encoded))
        for kb, vb in encoded:
            out += kb
            out += vb
    else:
        raise TypeError(f"unsupported CBOR type: {type(obj)!r}")


def dumps_canonical(obj: Any) -> bytes:
    """Encode ``obj`` as canonical (core deterministic) CBOR."""
    out = bytearray()
    _encode_item(out, obj)
    return bytes(out)
