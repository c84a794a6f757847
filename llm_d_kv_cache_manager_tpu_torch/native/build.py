"""Build the native libraries: ``python -m llm_d_kv_cache_manager_tpu_torch.native.build``.

``hashcore.cpp`` (chained sha256-CBOR block hashing) and ``lruindex.cpp``
(two-level LRU block index) are compiled with ``g++`` and the flags of the
JAX package's build into ``build/native/`` at the repository root. A
library's name carries a digest of its source and the flags, so an edited
source rebuilds and a stale library is never loaded. Nothing is built at
import time: the loaders call ``built_library`` the first time they are
asked for their library.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

from ..utils import get_logger

log = get_logger("native.build")

HERE = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
LIBS = {
    "libhashcore.so": "hashcore.cpp",
    "liblruindex.so": "lruindex.cpp",
}
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()


def library_path(lib_name: str) -> Path:
    """Where ``lib_name`` (a key of ``LIBS``) is built from this package's
    source."""
    src = (HERE / LIBS[lib_name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(lib_name).stem}-{digest}.so"


def _compile(lib_name: str, out: Path) -> None:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(HERE / LIBS[lib_name]), "-o", str(tmp)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    os.replace(tmp, out)


def built_library(lib_name: str) -> str:
    """The path of ``lib_name``, compiled first if it is missing. One build
    at a time across threads and processes (a lock file in the build
    directory). A failed build is logged and the path returned all the
    same: the loader then finds no library and its callers fall back to
    the pure-Python paths."""
    out = library_path(lib_name)
    if out.exists():
        return str(out)
    with _lock:
        try:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(BUILD_DIR / ".lock", "w") as lock_file:
                fcntl.flock(lock_file, fcntl.LOCK_EX)
                if not out.exists():
                    _compile(lib_name, out)
        except (OSError, subprocess.CalledProcessError) as exc:
            log.warning(
                "native library build failed",
                lib=lib_name,
                error=getattr(exc, "stderr", None) or str(exc),
            )
    return str(out)


def build() -> list[str]:
    """Build every native library that is missing; the paths of all."""
    return [built_library(name) for name in LIBS]


if __name__ == "__main__":
    for path in build():
        print(path, "" if os.path.exists(path) else "(build failed)", file=sys.stdout)
