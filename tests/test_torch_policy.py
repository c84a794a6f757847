"""Rules of the PyTorch port that no parity test shows.

- The port imports without ``jax``, without ``msgpack``/``zmq``/``aiohttp``
  (only the publisher, the event encoder and the HTTP surface use them, and
  they import them where they are used), and loads no module of the JAX
  package — whose name the port's own name starts with.
- Entry points run on CUDA unless the caller asks for the CPU: on a machine
  without CUDA, ``Engine(cfg)`` raises instead of silently running on the
  CPU.
- A kernel wrapper takes its plain version only for CPU tensors, and never
  counts that as a launch; any other device goes to the kernel or raises
  (paged decode, flash prefill, and the bf16 and int8 grouped matmuls).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu_torch import ops
from llm_d_kv_cache_manager_tpu_torch.models import TINY_LLAMA
from llm_d_kv_cache_manager_tpu_torch.server import BlockManagerConfig, Engine, EngineConfig

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, re, sys
for name in ("jax", "jaxlib", "msgpack", "zmq", "aiohttp"):
    sys.modules[name] = None
import llm_d_kv_cache_manager_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
jax_pkg = re.compile(r"^llm_d_kv_cache_manager_tpu(\.|$)")
leaked = sorted(m for m in sys.modules if jax_pkg.match(m))
print(len(names), leaked)
assert not leaked, leaked
"""


def test_port_imports_without_jax_or_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    n_modules, leaked = out.stdout.split(" ", 1)
    assert int(n_modules) >= 20 and leaked.strip() == "[]"


def test_engine_without_device_raises_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: Engine(cfg) runs on it")
    cfg = EngineConfig(model=TINY_LLAMA, block_manager=BlockManagerConfig(total_pages=8, page_size=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg)


def test_engine_rejects_unported_knobs():
    from llm_d_kv_cache_manager_tpu_torch.server import SchedulerConfig

    with pytest.raises(ValueError, match="host"):
        Engine(EngineConfig(model=TINY_LLAMA, block_manager=BlockManagerConfig(host_pages=4)), device="cpu")
    # Chunked prefill is ported: a budget is taken, a budget below 1 is not.
    eng = Engine(EngineConfig(model=TINY_LLAMA, scheduler=SchedulerConfig(chunked_prefill_tokens=16)),
                 device="cpu")
    assert eng.scheduler.config.chunk_align == 64
    with pytest.raises(ValueError, match="chunked_prefill_tokens must be >= 1"):
        Engine(EngineConfig(model=TINY_LLAMA, scheduler=SchedulerConfig(chunked_prefill_tokens=0)), device="cpu")


def _decode_args(device):
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    q = t(rng.standard_normal((2, 4, 64)).astype(np.float32))
    kp = t(rng.standard_normal((2, 5, 4, 2, 64)).astype(np.float32))
    bt = t(np.asarray([[1, 2], [3, 4]], np.int32))
    sl = t(np.asarray([5, 0], np.int32))
    fk = t(rng.standard_normal((2, 2, 64)).astype(np.float32))
    return (q, kp, kp.clone(), bt, sl, fk, fk.clone())


def _prefill_args(device):
    rng = np.random.default_rng(1)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    q = t(rng.standard_normal((2, 8, 4, 64)).astype(np.float32))
    k = t(rng.standard_normal((2, 8, 2, 64)).astype(np.float32))
    kp = t(rng.standard_normal((6, 4, 2, 64)).astype(np.float32))
    bt = t(np.asarray([[1, 2], [3, 4]], np.int32))
    return (q, k, k.clone(), kp, kp.clone(), bt, t(np.asarray([8, 3], np.int32)),
            t(np.asarray([8, 5], np.int32)))


@pytest.mark.parametrize(
    "wrapper,make_args,kw",
    [(ops.paged_attention, _decode_args, {"layer": 1}), (ops.flash_prefill_paged, _prefill_args, {})],
    ids=["paged_decode", "flash_prefill"],
)
def test_cpu_call_uses_plain_version_and_never_counts(wrapper, make_args, kw):
    before = wrapper.launches
    out = wrapper(*make_args("cpu"), **kw)
    assert torch.isfinite(out).all() and wrapper.launches == before == 0
    # Not CPU and not CUDA: no plain fallback, the wrapper raises.
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(*make_args("meta"), **kw)
    assert wrapper.launches == 0


def test_int8_pages_cpu_call_uses_plain_version_and_never_counts():
    """``paged_attention`` over int8 pages with scales: the plain version on
    the CPU, a raise off CUDA, and K1q's own wrapper refuses CPU tensors."""
    def args(device):
        q, kp, _, bt, sl, fk, fv = _decode_args(device)
        codes = (kp * 40).round().clamp(-127, 127).to(torch.int8)
        scales = torch.full(kp.shape[:2] + kp.shape[3:4], 0.02, device=device)
        return (q, codes, codes.clone(), bt, sl, fk, fv), dict(k_scale=scales, v_scale=scales.clone(), layer=1)

    a, kw = args("cpu")
    out = ops.paged_attention(*a, **kw)
    assert torch.isfinite(out).all() and out[1].abs().max() == 0
    with pytest.raises(ValueError, match="unsupported device"):
        a, kw = args("meta")
        ops.paged_attention(*a, **kw)
    a, kw = args("cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.paged_decode_int8(*a[:3], kw["k_scale"], kw["v_scale"], *a[3:], scale=0.125, layer=1)
    assert ops.paged_decode_int8.launches == 0 and ops.paged_attention.launches == 0


@pytest.mark.parametrize("quantized", [False, True], ids=["grouped_matmul_bf16", "grouped_matmul_int8"])
def test_grouped_matmul_cpu_uses_plain_version_and_never_counts(quantized):
    from llm_d_kv_cache_manager_tpu_torch.models import quantize_tensor

    def args(device):
        rng = np.random.default_rng(2)
        lhs = torch.from_numpy(rng.standard_normal((10, 32)).astype(np.float32)).to(device)
        w = torch.from_numpy(rng.standard_normal((3, 32, 16)).astype(np.float32)).to(device)
        gs = torch.tensor([4, 0, 6], dtype=torch.int32, device=device)
        rgi = torch.tensor([0] * 4 + [2] * 6, dtype=torch.int32, device=device)
        return lhs, (quantize_tensor(w) if quantized else w), gs, rgi

    lhs, rhs, gs, rgi = args("cpu")
    out = ops.grouped_matmul(lhs, rhs, gs, row_group_ids=rgi)
    assert torch.isfinite(out).all() and out.shape == (10, 16)
    lhs, rhs, gs, rgi = args("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.grouped_matmul(lhs, rhs, gs, row_group_ids=rgi)
    assert ops.grouped_matmul_bf16.launches == 0 and ops.grouped_matmul_int8.launches == 0


def test_kernel_build_is_lazy_and_keyed_by_source():
    """Importing the port compiles nothing; the library name carries a
    digest of the source and flags, so an edited source rebuilds."""
    from llm_d_kv_cache_manager_tpu_torch.ops import _build

    assert _build._libs == {}
    paths = {n: _build.library_path(n) for n in _build.KERNEL_SOURCES}
    assert all((_build.CSRC / f"{n}.cu").exists() for n in paths)
    assert len({p.name for p in paths.values()}) == len(paths)
    assert all(p.parent == _build.BUILD_DIR for p in paths.values())


def test_kernel_digest_covers_the_headers_a_source_includes():
    """A library's digest covers the ``csrc`` headers its source includes,
    and no other: an edit to the wgmma header rebuilds the grouped matmul
    and not the attention kernels."""
    from llm_d_kv_cache_manager_tpu_torch.ops import _build

    def headers(name):
        return {p.name for p in _build._sources(_build.CSRC / f"{name}.cu", {}) if p.suffix == ".cuh"}

    assert headers("paged_decode") == headers("flash_prefill") == {"mma_sm90.cuh"}
    assert headers("grouped_matmul") == {"mma_sm90.cuh", "wgmma_sm90.cuh"}
