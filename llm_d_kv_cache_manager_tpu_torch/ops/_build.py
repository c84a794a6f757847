"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``build/kernels/`` at the repository root, then loaded with ``ctypes`` —
no PyTorch headers, so a build takes seconds. The library name carries a
digest of the source, the ``csrc`` headers it includes and the flags, so
an edited source or header rebuilds what includes it and a stale library
is never loaded. Nothing here runs at import time: the
first CUDA launch of a kernel builds it (``chip_smoke.py`` builds all of
them up front, one ``nvcc`` process per source, concurrently).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNEL_SOURCES = ("paged_decode", "flash_prefill", "grouped_matmul", "grouped_matmul_tgmm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    # Register / shared-memory / spill report, kept in the build log.
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels are compiled on the machine that runs them"
        )
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: dict[Path, bytes]) -> dict[Path, bytes]:
    """``path`` and the ``csrc`` headers it includes with ``#include "..."``,
    transitively, each with its bytes."""
    if path not in seen:
        seen[path] = text = path.read_bytes()
        for inc in _INCLUDE.findall(text):
            _sources(CSRC / inc.decode(), seen)
    return seen


def library_path(name: str) -> Path:
    files = _sources(CSRC / f"{name}.cu", {})
    digest = hashlib.sha256(
        b"".join(files[p] for p in sorted(files)) + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=KERNEL_SOURCES) -> dict[str, float]:
    """Compile every named source whose library is missing, one ``nvcc``
    process per source, all started together. Returns the wall seconds
    each build took (0.0 for a library that was already built). Raises
    with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            out,
        )
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check_launch(name: str, err: int) -> None:
    """Raise for a non-zero ``cudaError_t`` returned by a C launcher."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
