"""The paged-KV inference engine with continuous batching, in PyTorch.

Port of the JAX package's ``server/engine.py`` main path: per step the
engine either prefills a batch of admitted prompts (suffix-only on
prefix-cache hits) or decodes one token for every running sequence, samples
on the device, and publishes ``BlockStored``/``BlockRemoved`` so the routing
indexer tracks this replica's cache. The block manager and scheduler are
the JAX package's own (copied verbatim). Ported knobs: weight int8
quantization (``quantize``, ``quantize_experts``), int8 KV pages in device
memory (``kv_quant_hbm="int8"``: int8 page pools with per-page f32 scale
pools ``k_scales``/``v_scales``) and chunked prefill
(``SchedulerConfig.chunked_prefill_tokens``: a step then prefills up to
that many prompt tokens and decodes the running lanes in the same
iteration), and the decode fast path (``decode_steps_per_iter``,
``decode_pipeline``, ``decode_fused_sampling``: multi-step bursts, burst
N+1 dispatched before burst N commits, with the JAX engine's drain rules),
and the host-DRAM tier (``BlockManagerConfig.host_pages``,
``host_tier_policy``, ``kv_quant``, ``host_prefetch``: evicted pages spill
to a pinned host slot pool, prefix hits restore them, gated by the
recompute-vs-restore cost model; see "Host-DRAM tier" below), and
cross-pod KV transfer (``kv_block_bytes``, ``export_kv_blocks``,
``import_kv_blocks``; see "KV transfer" below). The other knob-gated
features of the JAX engine — the remote tier and integrity digests,
speculative decoding, TP/SP — are not ported yet, and their config fields
do not exist here.

Shapes stay bucketed as in the JAX engine (prefill batch padded to
``max_prefill_batch``, chunk length to ``prefill_bucket``, decode lanes to
``decode_batch_size``), so the page-pool bytes the port writes match the
JAX package's, padded decode lanes included (they write reserved page 0,
slot 0).

The engine runs on CUDA (prefill through the flash-prefill kernel, decode
through the paged-decode kernel) unless it is built with ``device="cpu"``,
which runs the kernels' plain PyTorch versions. Every decode burst goes
through ``DecodeGraphs`` (``server/decode_graphs.py``): on CUDA one graph
replay a burst, captured per (k, block-table width); on the CPU the same
code without capture.

Host-DRAM tier. The block manager (the JAX package's own) decides which
page moves between the tiers and calls ``_offload_page`` / ``_restore_page``
while it schedules; they only queue the move. ``_flush_page_moves`` runs
the queue before the next dispatch, the only point where pool contents are
read or overwritten:

- one gather of every device page a queued move reads, on the compute
  stream (the current stream, where prefill and the decode replays run);
- offloads: the gathered pages, quantized on the device when the tier is
  int8, copied into the pinned slots on a copy stream of their own after an
  event, so the copies overlap what the compute stream does next;
- restores: each slot a restore reads is copied host to device on the copy
  stream (a prefetch starts these copies as soon as it queues them), the
  compute stream waits on that copy's event, and one ``index_copy_`` per
  pool writes the pages in place (the decode graphs hold the pools by
  address), deduplicated by destination page, last queued wins.

Every copy that reads or writes a slot runs on the one copy stream, and a
flush enqueues its reads of slots before its writes, so a restore reads a
slot as it was when the restore was queued (the JAX engine's snapshot at
queue time) without copying it then. A host read of a slot waits on the
last flush's event (``_wait_host_copies``). The JAX engine's demotion and
integrity branches of the flush (``_pending_demotions``, ``integrity``) are
the remote tier's and are not ported.

KV transfer. ``export_kv_blocks`` serves a peer's prefix fetch: it flushes
the queued moves, walks the chain, gathers its device pages once on the
compute stream (quantized there when the wire is int8 and the pools are
full-width), copies them into pinned staging on the copy stream and waits
once; host-tier blocks are read from the slots after
``_wait_host_copies``. ``import_kv_blocks`` checks each block as the JAX
engine does and queues a restore whose source is the block's bytes in
memory: ``("data", k, v)`` full-width or ``("qdata", k codes, v codes,
k scales, v scales)``. The flush packs every such source into one pinned
buffer per pool, copies it to the device on the copy stream, and the
compute stream waits on that copy before the in-place ``index_copy_``;
int8 pools quantize full-width pages on the device, full-width pools
dequantize codes there (``code * scale`` in float32, the JAX engine's
host arithmetic). Page bytes cross the wire in the JAX package's layout
and dtype names (bf16 through its ``int16`` view: numpy has no bfloat16
here). The remote-store and integrity branches of both (``remote_store``,
``integrity``) belong to the remote tier and are not ported.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..kvcache.kvevents.events import Event
from ..models import llama, quant
from ..models.llama import LlamaConfig
from ..utils import get_logger
from .block_manager import AllocationError, BlockManager, BlockManagerConfig
from .decode_graphs import DecodeGraphs
from ..ops.sampling import sample_tokens
from .scheduler import Scheduler, SchedulerConfig
from .sequence import SamplingParams, Sequence, SequenceStatus

log = get_logger("server.engine")


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _runs(keys: list[int]) -> list[tuple[int, int, int]]:
    """``(first key, first row, length)`` of each run of consecutive keys in
    a sorted list (row ``i`` holds ``keys[i]``): one copy moves a run."""
    out: list[tuple[int, int, int]] = []
    for i, key in enumerate(keys):
        if out and out[-1][0] + out[-1][2] == key:
            out[-1] = (out[-1][0], out[-1][1], out[-1][2] + 1)
        else:
            out.append((key, i, 1))
    return out


#: the page dtypes' names on the transfer wire: numpy's, as the JAX engine
#: writes them (``str(np.dtype(jnp.bfloat16))`` is ``"bfloat16"``)
_WIRE_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16"}


def _wire_dtype_matches(name, dtype: torch.dtype) -> bool:
    """Whether a payload's ``dtype`` names ``dtype``, as the JAX engine's
    ``np.dtype(name) == np_dtype`` decides, with bfloat16 matched by its
    name (numpy knows it only through ml_dtypes, which this process may
    lack)."""
    want = _WIRE_DTYPES.get(dtype)
    if want is None or "bfloat16" in (want, name):
        return name == want
    try:
        return np.dtype(name) == np.dtype(want)
    except (TypeError, ValueError):
        return False


def _tensor_bytes(t: torch.Tensor) -> bytes:
    """C-order bytes of a host tensor (bf16 through its ``int16`` view)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _tensor_from_bytes(data: bytes, dtype: torch.dtype, shape: tuple) -> torch.Tensor:
    """A host tensor holding a copy of ``data`` (the payload's ``bytes``
    are read-only)."""
    return torch.frombuffer(bytearray(data), dtype=dtype).reshape(shape)


class _Span:
    """An interval on the device's clock: timing events recorded on a CUDA
    stream, read only once the end has passed (so a span covers the work,
    not its enqueue); the host clock where there is no stream (the CPU,
    where every copy is synchronous)."""

    def __init__(self, stream: Optional[torch.cuda.Stream]):
        self.start = self._mark(stream)
        self.stop = None

    @staticmethod
    def _mark(stream):
        if stream is None:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def end(self, stream: Optional[torch.cuda.Stream]) -> "_Span":
        self.stop = self._mark(stream)
        return self

    def since(self, first: "_Span") -> "_Span":
        """This span's end measured from ``first``'s start."""
        out = _Span.__new__(_Span)
        out.start, out.stop = first.start, self.stop
        return out

    def wait(self) -> None:
        """Block the host until the span has ended."""
        if not isinstance(self.stop, float):
            self.stop.synchronize()

    def seconds(self) -> Optional[float]:
        """Its length; None while its end has not passed."""
        if isinstance(self.stop, float):
            return self.stop - self.start
        if not self.stop.query():
            return None
        return self.start.elapsed_time(self.stop) / 1e3


def resolve_device(device) -> torch.device:
    """``None`` means the GPU: raise when there is none rather than run
    silently on the CPU. Callers that want the CPU path pass ``"cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: the engine runs on the GPU; pass "
                "device='cpu' to run the plain PyTorch path on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


@dataclass
class EngineConfig:
    model: LlamaConfig = field(default_factory=lambda: llama.TINY_LLAMA)
    block_manager: BlockManagerConfig = field(default_factory=BlockManagerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    max_model_len: int = 2048
    #: decode batch lanes (padded); also the max concurrent running seqs
    decode_batch_size: int = 8
    #: fused decode steps per engine iteration (one graph replay runs k
    #: model steps with on-device sampling — one host sync per k tokens).
    #: 1 = one token per dispatch; sampling is on the device at every
    #: setting.
    decode_steps_per_iter: int = 1
    #: prefill length bucket granularity (shape bucketing)
    prefill_bucket: int = 64
    #: decode block-table width bucket (pages): the table is sized to the
    #: longest ACTIVE context rounded up to this, not to max_model_len
    decode_pages_bucket: int = 16
    #: context block-table width bucket granularity for warm prefills
    prefill_ctx_bucket: int = 4
    #: weight quantization: None (serve in model dtype) or "int8"
    #: (symmetric per-output-channel weight-only int8, models/quant.py).
    #: Applied to full-precision params; params that are already quantized
    #: must be in the form these two fields ask for, or the engine raises.
    quantize: Optional[str] = None
    #: also quantize MoE expert stacks (they then run through the int8
    #: grouped-matmul kernel)
    quantize_experts: bool = False
    #: KV pool storage in device memory: None (the model dtype) or "int8"
    #: (codes plus one f32 scale per page per (layer, kv head): half the
    #: bytes of a bf16 page). "float8_e4m3" is declared but not implemented.
    kv_quant_hbm: Optional[str] = None
    #: pipeline fused decode bursts: dispatch burst N+1 (its input tokens
    #: chained on the device from burst N's last sampled token) BEFORE
    #: fetching/committing burst N, hiding the host's commit bookkeeping
    #: under device execution. Needs decode_steps_per_iter > 1. Commit
    #: bookkeeping lags one burst; any lane-set change (prefill scheduled,
    #: preemption, finish) drains first, so greedy results are identical to
    #: the unpipelined engine. (temperature>0 streams are identically
    #: distributed but not identical across the two modes: discarded
    #: surplus bursts draw extra noise from the generator.)
    decode_pipeline: bool = False
    #: device-resident decode fast path (``DECODE_FUSED_SAMPLING``): the
    #: pipelined chaining above extended down to k=1 — every steady-state
    #: decode step takes its input tokens from the previous dispatch's
    #: on-device sample instead of a host round trip. Greedy outputs are
    #: identical to the unfused engine (same drain rules as
    #: decode_pipeline, same temperature>0 caveat). The sampled ids' copy
    #: to pinned host memory starts right after every dispatch at every
    #: setting. Off by default = the JAX default.
    decode_fused_sampling: bool = False
    #: host-DRAM tier admission: "auto" (the recompute-vs-restore cost model,
    #: from rates measured online, gates spills and restores) or "always"
    #: (unconditional spill and restore).
    host_tier_policy: str = "auto"
    #: host-DRAM tier page storage: None (the model dtype) or "int8" (codes
    #: plus one f32 scale per (layer, kv head), ``models/quant.py``: half the
    #: host bytes a page). Pages are quantized on the device before they
    #: cross to the host and dequantized on the device when they come back.
    kv_quant: Optional[str] = None
    #: host-tier prefetch: bring the host-cached prefixes of waiting
    #: sequences back ahead of the scheduler (their host-to-device copies
    #: start then, on the copy stream) instead of inside ``allocate``. Off
    #: by default, as in the JAX package.
    host_prefetch: bool = False
    seed: int = 0


class Engine:
    def __init__(
        self,
        config: EngineConfig,
        params=None,
        on_events: Optional[Callable[[list[Event]], None]] = None,
        device=None,
    ):
        """``params``: a parameter dict on ``device`` (``models.init_params``
        / ``models.params_from_jax``); None random-initialises from
        ``config.seed``. ``device``: None = the current CUDA device (raises
        when there is none), ``"cpu"`` = plain PyTorch on the CPU."""
        self.config = config
        self.device = resolve_device(device)
        cfg = config.model
        self.model_cfg = cfg
        ps = config.block_manager.page_size
        self.page_size = ps
        cpt = config.scheduler.chunked_prefill_tokens
        if cpt is not None and cpt < 1:
            raise ValueError("chunked_prefill_tokens must be >= 1 (None disables chunking)")
        if config.decode_steps_per_iter < 1:
            raise ValueError("decode_steps_per_iter must be >= 1")
        # decode_fused_sampling keeps the burst machinery live at any k
        # (k=1 pipelining is exactly the device-resident step-per-token
        # loop); decode_pipeline alone still needs k > 1 to pay off.
        self._pipeline = (
            config.decode_pipeline and config.decode_steps_per_iter > 1
        ) or config.decode_fused_sampling
        # Width includes fused-burst headroom: a sequence finishing at
        # max_model_len mid-burst keeps writing its surplus KV into reserved
        # pages of its own row, never into another sequence's pages.
        # Pipelining keeps up to TWO bursts in flight.
        bursts_in_flight = 2 if self._pipeline else 1
        self.max_pages_per_seq = -(
            -(
                config.max_model_len
                + max(config.decode_steps_per_iter * bursts_in_flight - 1, 0)
            )
            // ps
        )

        self.block_manager = BlockManager(config.block_manager, on_events=on_events)
        sched_cfg = dataclasses.replace(
            config.scheduler,
            max_running=min(config.scheduler.max_running, config.decode_batch_size),
            # Non-final chunks end page-aligned (the next chunk's paged
            # context is whole pages) and land on the prefill buckets.
            chunk_align=math.lcm(config.prefill_bucket, ps),
        )
        self.scheduler = Scheduler(self.block_manager, sched_cfg)

        if config.quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {config.quantize!r}")
        if config.kv_quant_hbm is not None:
            if config.kv_quant_hbm not in quant.KV_QUANT_HBM_MODES:
                raise ValueError(f"unknown kv_quant_hbm mode {config.kv_quant_hbm!r}")
            if config.kv_quant_hbm == "float8_e4m3":
                raise NotImplementedError(
                    "kv_quant_hbm='float8_e4m3' is the declared follow-on "
                    "storage mode; the paged-attention kernel has no fp8 "
                    "dequant path yet — use 'int8'"
                )
        if config.kv_quant is not None and config.kv_quant not in quant.KV_QUANT_MODES:
            raise ValueError(f"unknown kv_quant mode {config.kv_quant!r}")
        hp = config.block_manager.host_pages
        if hp > 0 and config.host_tier_policy not in ("auto", "always"):
            raise ValueError(f"unknown host_tier_policy {config.host_tier_policy!r}")
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(config.seed)
            params = llama.init_params(
                cfg, gen, self.device,
                quantize=config.quantize, quantize_experts=config.quantize_experts,
            )
        elif params["embed"].device != self.device:
            raise ValueError(
                f"params live on {params['embed'].device}, engine device is {self.device}"
            )
        elif config.quantize is not None and not quant.is_quantized(params):
            # The caller's full-precision tree stays alive during this; for
            # a model near device capacity use init_params(quantize=...).
            params = quant.quantize_params(params, quantize_experts=config.quantize_experts)
        elif config.quantize is not None:
            bad = quant.quantize_mismatch(params, quantize_experts=config.quantize_experts)
            if bad is not None:
                raise ValueError(
                    f"params are already quantized, but {bad!r} is not in the form "
                    f"quantize={config.quantize!r}, quantize_experts="
                    f"{config.quantize_experts} asks for"
                )
        self.params = params
        # Updated in place by every prefill / decode dispatch.
        self.k_pages, self.v_pages = llama.init_kv_pages(
            cfg, config.block_manager.total_pages, ps, self.device,
            kv_quant_hbm=config.kv_quant_hbm,
        )
        # Scale pools of the int8 pages (None when the knob is off).
        self.k_scales: Optional[torch.Tensor] = None
        self.v_scales: Optional[torch.Tensor] = None
        if config.kv_quant_hbm == "int8":
            self.k_scales, self.v_scales = llama.init_kv_scales(
                cfg, config.block_manager.total_pages, self.device
            )
        self._init_host_tier()
        #: prefill observability: tokens actually pushed through prefill
        #: dispatches (prefix-cache hits reduce it) and dispatch count.
        self.prefill_stats = {"tokens_computed": 0, "dispatches": 0}
        #: cross-pod KV transfer: the JAX engine's counters
        self.transfer_stats = {
            "exported_blocks": 0,
            "imported_blocks": 0,
            "import_rejected": 0,
        }
        #: transfer copies: exports and the pages they read from the device,
        #: the device seconds of their gather (compute stream) and of their
        #: copy to pinned memory (copy stream), the host seconds of encoding
        #: payloads; imported pages the flushes moved, their bytes, the host
        #: seconds of packing them into pinned staging and the device
        #: seconds of their copy to the device
        self.transfer_copy_stats = {
            "exports": 0, "export_pages": 0, "export_bytes": 0,
            "export_gather_s": 0.0, "export_d2h_s": 0.0, "export_encode_s": 0.0,
            "import_pages": 0, "import_bytes": 0, "import_pack_s": 0.0, "import_h2d_s": 0.0,
        }
        #: decode dispatches (a mixed step makes one prefill and one decode
        #: dispatch, so engine steps do not count them) and the model steps
        #: they ran (``decode_steps_per_iter`` a dispatch)
        self.decode_stats = {"dispatches": 0, "steps": 0}
        self._generator = torch.Generator(device=self.device).manual_seed(
            config.seed ^ 0x5EED
        )
        #: every decode burst's dispatch: one CUDA graph replay on the card
        self.decode_graphs = DecodeGraphs(
            self.params, cfg, self.k_pages, self.v_pages, self.k_scales, self.v_scales,
            lanes=config.decode_batch_size, max_pages=self.max_pages_per_seq,
            page_size=ps, generator=self._generator, device=self.device,
            chain=self._pipeline,
        )
        #: in-flight decode burst (pipelined): its sampled ids on their way
        #: to the host, the lane-ordered active list, and the np
        #: position/len arrays the NEXT burst derives from.
        self._inflight: Optional[dict] = None
        self.finished: list[Sequence] = []
        self._step_count = 0
        #: set once any request carries a deadline — gates the per-step
        #: expiry scan.
        self._deadlines_used = False
        #: request-lifecycle observability (deadline sheds/expiries, aborts)
        self.lifecycle_stats = {
            "deadline_shed": 0,
            "deadline_expired": 0,
            "aborted": 0,
        }

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- host-DRAM tier -----------------------------------------------------
    def _init_host_tier(self) -> None:
        """The cost model's rates, the tier's queues and counters and, when
        ``host_pages`` > 0, the host slot pools (pinned on the card), the
        copy stream and the block manager's movers."""
        config, cfg, ps = self.config, self.model_cfg, self.page_size
        # Online rate estimates of the recompute-vs-restore cost model: EMAs
        # of this process's own prefills and copies.
        self._prefill_rate: Optional[float] = None  # prefill tokens / s
        self._restore_rate: Optional[float] = None  # restored pages / s
        self._offload_rate: Optional[float] = None  # gathered and copied-out pages / s
        # With int8 device pages the host tier is int8 too: the pages are
        # already codes and scales, and move between the tiers as they are.
        self._host_int8 = config.kv_quant == "int8" or config.kv_quant_hbm == "int8"
        self._pending_offloads: list = []  # (slot, source)
        self._pending_restores: list = []  # (page, source)
        self._off_by_slot: dict = {}
        self._restore_by_page: dict = {}
        #: slots whose host-to-device copy a queued restore has started:
        #: slot -> (batch, row) in ``_stage_batches`` (rows, span) entries
        self._staged: dict[int, tuple[int, int]] = {}
        self._stage_batches: list = []
        #: (kind, pages, span) of the tier's copies, folded into
        #: ``host_copy_stats`` and the rates, in order, once each has passed
        self._spans: collections.deque = collections.deque()
        #: the last flush's copies into the host slots
        self._host_ready: Optional[_Span] = None
        #: host-tier prefetch: rounds = steps where the stage ran and found
        #: work, pages = host blocks brought back ahead of allocate, seqs =
        #: waiting sequences whose chains were warmed
        self.host_prefetch_stats = {"rounds": 0, "pages": 0, "seqs": 0}
        #: (pages, start_mono, end_mono) of the latest prefetch round that
        #: moved pages
        self.last_prefetch: Optional[tuple[int, float, float]] = None
        #: per-step prefetch page cap: one prefill batch's worth of pages
        self._prefetch_page_cap = max(1, config.scheduler.max_prefill_tokens // ps)
        #: host-tier copies: flushes and the host seconds they took to
        #: enqueue; pages restored (deduplicated); pages and bytes copied
        #: each way; device seconds of the copies to the host (d2h_s) and
        #: from it (h2d_s), and of the compute stream's waits on the copy
        #: stream (wait_s), each span read once it has passed (on the CPU,
        #: where copies are synchronous, host seconds)
        self.host_copy_stats = {
            "flushes": 0, "flush_host_s": 0.0, "restored": 0,
            "d2h_pages": 0, "d2h_bytes": 0, "d2h_s": 0.0,
            "h2d_pages": 0, "h2d_bytes": 0, "h2d_s": 0.0, "wait_s": 0.0,
        }
        #: pinned staging of imported pages with the span of their copy to
        #: the device: kept referenced until that copy has passed
        self._import_staging: list = []
        cuda = self.device.type == "cuda"
        #: the tier's and the transfer's page copies run here, off the
        #: compute stream
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        hp = config.block_manager.host_pages
        if hp == 0:
            return
        slot_shape = (hp, cfg.n_layers, ps, cfg.n_kv_heads, cfg.hd)
        dtype = torch.int8 if self._host_int8 else cfg.dtype
        self._host_k = torch.zeros(slot_shape, dtype=dtype, pin_memory=cuda)
        self._host_v = torch.zeros(slot_shape, dtype=dtype, pin_memory=cuda)
        if self._host_int8:
            sc_shape = (hp,) + quant.kv_scale_shape(slot_shape[1:])
            self._host_k_scale = torch.zeros(sc_shape, dtype=torch.float32, pin_memory=cuda)
            self._host_v_scale = torch.zeros(sc_shape, dtype=torch.float32, pin_memory=cuda)
        auto = config.host_tier_policy == "auto"
        self.block_manager.attach_host_pool(
            self._offload_page,
            self._restore_page,
            self._restore_beats_recompute if auto else None,
        )
        if auto:
            self._probe_link()

    def _probe_link(self) -> None:
        """Measure the device-to-host rate once at start-up, so that the
        cost model gates the very first spills: 16 pages, K and V, gathered
        and copied into pinned host memory as a flush copies them, timed
        after a warm-up and only once the copies have finished (a timing of
        their enqueue would read as a far faster link)."""
        n = min(16, self.config.block_manager.total_pages)
        cuda = self.device.type == "cuda"
        idx = torch.zeros(n, dtype=torch.long, device=self.device)
        pools = (self.k_pages, self.v_pages)
        dest = [torch.empty((n,) + p.shape[:1] + p.shape[2:], dtype=p.dtype, pin_memory=cuda)
                for p in pools]

        def copy():
            for d, pool in zip(dest, pools):
                d.copy_(pool.index_select(1, idx).transpose(0, 1).contiguous(), non_blocking=True)
            if cuda:
                torch.cuda.synchronize(self.device)

        copy()
        t0 = time.perf_counter()
        copy()
        self._offload_rate = n / max(time.perf_counter() - t0, 1e-6)

    def _compute_stream(self) -> Optional[torch.cuda.Stream]:
        """The stream prefill and the decode replays run on (None on the CPU)."""
        return torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None

    def _on_copy_stream(self):
        if self._copy_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._copy_stream)

    def _index(self, values: list[int]) -> torch.Tensor:
        """An int64 index on the device, uploaded through pinned memory
        without a host sync."""
        t = torch.tensor(values, dtype=torch.long)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _host_pools(self) -> list[torch.Tensor]:
        """The slot pools ``[host_pages, L, ps, n_kv, hd]``, and on an int8
        tier their scales ``[host_pages, L, 1, n_kv, 1]``."""
        pools = [self._host_k, self._host_v]
        if self._host_int8:
            pools += [self._host_k_scale, self._host_v_scale]
        return pools

    def _device_pools(self) -> list[torch.Tensor]:
        """The page pools ``[L, total_pages, ps, n_kv, hd]``, and when they
        are int8 their scale pools ``[L, total_pages, n_kv]``."""
        return [t for t in (self.k_pages, self.v_pages, self.k_scales, self.v_scales)
                if t is not None]

    def _to_pool_form(self, rows: list[torch.Tensor]) -> list[torch.Tensor]:
        """Pages ``[n, ...]`` as the slots hold them, as the device pools
        hold them: dequantized from an int8 tier into full-width pools;
        codes as they are, scales as ``[n, L, n_kv]``, into int8 pools."""
        if not self._host_int8:
            return rows
        k, v, ks, vs = rows
        if self.k_scales is not None:
            n, n_layers = k.shape[:2]
            return [k, v, ks.reshape(n, n_layers, -1), vs.reshape(n, n_layers, -1)]
        dtype = self.model_cfg.dtype
        return [quant.dequantize_kv_page(k, ks, dtype), quant.dequantize_kv_page(v, vs, dtype)]

    def _to_host_form(self, rows: list[torch.Tensor]) -> list[torch.Tensor]:
        """The inverse of ``_to_pool_form``: full-width pages are quantized
        (on the device) for an int8 tier; int8 pages keep their codes."""
        if not self._host_int8:
            return rows
        if self.k_scales is not None:
            k, v, ks, vs = rows
            n, n_layers, n_kv = ks.shape
            shape = (n, n_layers, 1, n_kv, 1)
            return [k, v, ks.reshape(shape), vs.reshape(shape)]
        kq, ks = quant.quantize_kv_page(rows[0])
        vq, vs = quant.quantize_kv_page(rows[1])
        return [kq, vq, ks, vs]

    def _offload_page(self, page: int, slot: int) -> None:
        src = self._restore_by_page.get(page, ("page", page))
        self._pending_offloads.append((slot, src))
        self._off_by_slot[slot] = src

    def _restore_page(self, slot: int, page: int) -> None:
        # A slot whose offload is still queued is read from the offloading
        # device page; any other slot is read by the flush, which sees it
        # as it is now (the module docstring says why).
        src = self._off_by_slot.get(slot, ("slot", slot))
        self._pending_restores.append((page, src))
        self._restore_by_page[page] = src

    def _read_host_slot(self, slot: int) -> tuple[torch.Tensor, torch.Tensor]:
        """One host slot's K and V, full-width in the model dtype
        (dequantized from an int8 tier), on the host, once every copy into
        the slots has landed."""
        self._wait_host_copies()
        if self._host_int8:
            dtype = self.model_cfg.dtype
            return (
                quant.dequantize_kv_page(self._host_k[slot], self._host_k_scale[slot], dtype),
                quant.dequantize_kv_page(self._host_v[slot], self._host_v_scale[slot], dtype),
            )
        return self._host_k[slot].clone(), self._host_v[slot].clone()

    def _wait_host_copies(self) -> None:
        """Block the host until the copies into the host slots have landed:
        every host read of a slot comes after this."""
        if self._host_ready is not None:
            self._host_ready.wait()
        self._harvest_copy_spans()

    def _harvest_copy_spans(self) -> None:
        """Fold the copy spans that have passed into ``host_copy_stats`` and
        the rates, in the order they were recorded (no host wait)."""
        while self._spans:
            kind, n, span = self._spans[0]
            seconds = span.seconds()
            if seconds is None:
                return
            self._spans.popleft()
            if kind == "offload":
                self._offload_rate = self._ema(self._offload_rate, n / max(seconds, 1e-6))
            elif kind == "restore":
                self._restore_rate = self._ema(self._restore_rate, n / max(seconds, 1e-6))
            elif kind == "import_h2d":
                self.transfer_copy_stats["import_h2d_s"] += seconds
            else:
                self.host_copy_stats[f"{kind}_s"] += seconds

    @staticmethod
    def _ema(prev: Optional[float], sample: float, alpha: float = 0.3) -> float:
        return sample if prev is None else (1 - alpha) * prev + alpha * sample

    def _restore_beats_recompute(self, n_pages: int) -> bool:
        """Recompute-vs-restore cost model (the block manager's callback):
        is bringing ``n_pages`` host-cached pages back cheaper than
        recomputing their ``n_pages * page_size`` tokens, at the measured
        rates? Until a restore has been measured, the offload rate (from
        the start-up probe on) stands in for the link. Optimistic only while
        no tier copy has been measured."""
        self._harvest_copy_spans()
        tier_rate = self._restore_rate if self._restore_rate is not None else self._offload_rate
        if tier_rate is None or self._prefill_rate is None:
            return True
        restore_s = n_pages / tier_rate
        recompute_s = n_pages * self.page_size / self._prefill_rate
        return restore_s <= recompute_s

    def _prefetch_host_pages(self) -> None:
        """Prefetch stage: walk the first prefill batch's worth of WAITING
        sequences in FCFS order and bring their host-cached prefix chains
        back into HBM (ref-0 evictable pages) so that the scheduler's
        ``allocate`` finds warm pages, and start those pages' host-to-device
        copies now, on the copy stream, while the host schedules. Bounded
        per step by ``_prefetch_page_cap``; the cost model gates it as it
        gates the blocking path, so outputs equal those with the knob off."""
        bm = self.block_manager
        if bm.num_host_cached_pages == 0 or not self.scheduler.waiting:
            return
        budget = self._prefetch_page_cap
        head = list(itertools.islice(self.scheduler.waiting, self.config.scheduler.max_prefill_batch))
        pages = 0
        seqs = 0
        t0 = time.monotonic()
        for seq in head:
            if budget <= 0:
                break
            if seq.prefetch_hashes is None:
                seq.prefetch_hashes = bm.token_db.prefix_hashes(seq.prompt_tokens)
            n = bm.prefetch_chain(seq.prefetch_hashes, budget)
            if n:
                pages += n
                seqs += 1
                budget -= n
        if pages:
            self._stage_host_reads()
            self.host_prefetch_stats["rounds"] += 1
            self.host_prefetch_stats["pages"] += pages
            self.host_prefetch_stats["seqs"] += seqs
            self.last_prefetch = (pages, t0, time.monotonic())

    def _stage_host_reads(self) -> None:
        """Start the host-to-device copies of every slot that a queued
        restore reads and no copy has started for, on the copy stream, into
        device rows (consecutive slots in one copy)."""
        slots = sorted(
            {src[1] for _, src in self._pending_restores if src[0] == "slot"} - self._staged.keys()
        )
        if not slots:
            return
        stream = self._copy_stream
        host = self._host_pools()
        with self._on_copy_stream():
            rows = [torch.empty((len(slots),) + h.shape[1:], dtype=h.dtype, device=self.device)
                    for h in host]
            span = _Span(stream)  # after the allocation, which may block the host
            for s0, i0, m in _runs(slots):
                for row, h in zip(rows, host):
                    row[i0 : i0 + m].copy_(h[s0 : s0 + m], non_blocking=True)
            span.end(stream)
        if stream is not None:
            # Made on the copy stream, read on the compute stream.
            for row in rows:
                row.record_stream(self._compute_stream())
        batch = len(self._stage_batches)
        self._stage_batches.append((rows, span))
        self._staged.update({s: (batch, i) for i, s in enumerate(slots)})
        self.host_copy_stats["h2d_pages"] += len(slots)
        self.host_copy_stats["h2d_bytes"] += sum(r.numel() * r.element_size() for r in rows)
        self._spans.append(("h2d", len(slots), span))

    def _copy_to_host(self, slots: list[int], rows: list[torch.Tensor], gather: _Span) -> None:
        """Copy ``rows`` (slot form, row ``i`` for ``slots[i]``, sorted) into
        the pinned slots on the copy stream, once the compute stream has
        made them; ``gather`` marks when the flush's gather started."""
        stream = self._copy_stream
        host = self._host_pools()
        if stream is not None:
            stream.wait_stream(self._compute_stream())
        with self._on_copy_stream():
            span = _Span(stream)
            for s0, i0, m in _runs(slots):
                for h, row in zip(host, rows):
                    h[s0 : s0 + m].copy_(row[i0 : i0 + m], non_blocking=True)
            span.end(stream)
        if stream is not None:
            # Made on the compute stream, read on the copy stream.
            for row in rows:
                row.record_stream(stream)
        self._host_ready = span
        self.host_copy_stats["d2h_pages"] += len(slots)
        self.host_copy_stats["d2h_bytes"] += sum(r.numel() * r.element_size() for r in rows)
        self._spans.append(("d2h", len(slots), span))
        self._spans.append(("offload", len(slots), span.since(gather)))

    @staticmethod
    def _source_key(src: tuple):
        """A queued move's source as a dict key: a page or a slot by its
        number, an imported block's bytes by the identity of its tuple (one
        object, shared by the restore and any offload that reads it)."""
        return ("memory", id(src)) if src[0] in ("data", "qdata") else src

    def _stage_imports(self, sources: list[tuple]) -> list[tuple]:
        """Start the host-to-device copy of imported blocks' bytes: each
        kind's pages packed into one pinned staging buffer per pool and
        copied on the copy stream. Returns ``(kind, sources, device rows,
        span)`` per kind; the staging stays referenced until the span has
        passed (a pinned buffer reused under its copy would corrupt pages)."""
        stream = self._copy_stream
        cuda = stream is not None
        self._import_staging = [(s, b) for s, b in self._import_staging if s.seconds() is None]
        out = []
        for kind in ("data", "qdata"):
            srcs = [src for src in sources if src[0] == kind]
            if not srcs:
                continue
            t0 = time.perf_counter()
            staging = []
            for j in range(1, len(srcs[0])):
                first = srcs[0][j]
                buf = torch.empty((len(srcs),) + tuple(first.shape), dtype=first.dtype,
                                  pin_memory=cuda)
                torch.stack([src[j] for src in srcs], out=buf)
                staging.append(buf)
            self.transfer_copy_stats["import_pack_s"] += time.perf_counter() - t0
            with self._on_copy_stream():
                rows = [torch.empty(b.shape, dtype=b.dtype, device=self.device) for b in staging]
                span = _Span(stream)
                for row, buf in zip(rows, staging):
                    row.copy_(buf, non_blocking=True)
                span.end(stream)
            if cuda:
                # Made on the copy stream, read on the compute stream.
                for row in rows:
                    row.record_stream(self._compute_stream())
            self._import_staging.append((span, staging))
            n_bytes = sum(b.numel() * b.element_size() for b in staging)
            self.transfer_copy_stats["import_pages"] += len(srcs)
            self.transfer_copy_stats["import_bytes"] += n_bytes
            self._spans.append(("import_h2d", len(srcs), span))
            out.append((kind, srcs, rows, span))
        return out

    def _import_to_pool_form(self, kind: str, rows: list[torch.Tensor]) -> list[torch.Tensor]:
        """Imported pages ``[n, ...]`` (``"data"``: K and V full-width;
        ``"qdata"``: int8 codes and their ``[n, L, 1, n_kv, 1]`` scales) as
        the device pools hold them: an int8 pool quantizes full-width pages
        and takes codes as they are; a full-width pool dequantizes codes, as
        the JAX engine does on the host."""
        if self.k_scales is not None:
            if kind == "data":
                (kq, ks), (vq, vs) = (quant.quantize_kv_page(r) for r in rows)
                rows = [kq, vq, ks, vs]
            k, v, ks, vs = rows
            n, n_layers = k.shape[:2]
            return [k, v, ks.reshape(n, n_layers, -1), vs.reshape(n, n_layers, -1)]
        if kind == "qdata":
            dtype = self.model_cfg.dtype
            return [quant.dequantize_kv_page(rows[0], rows[2], dtype),
                    quant.dequantize_kv_page(rows[1], rows[3], dtype)]
        return rows

    def _flush_page_moves(self) -> None:
        """Run the queued page moves before the next dispatch (the module
        docstring has the plan). Restores are deduplicated by destination
        page and offloads by slot, the last queued winning in both: an
        ``index_copy_`` with repeated indices has no defined order on CUDA,
        and the last offload into a slot is the content the JAX engine's
        in-order writes leave there."""
        if not self._pending_offloads and not self._pending_restores:
            return
        t_host = time.perf_counter()
        self._harvest_copy_spans()
        compute = self._compute_stream()
        key = self._source_key
        offloads = dict(self._pending_offloads)  # slot -> source
        restores = dict(self._pending_restores)  # page -> source
        sources = list(offloads.values()) + list(restores.values())
        pages = list(dict.fromkeys(src[1] for src in sources if src[0] == "page"))
        imported = list({key(src): src for src in sources if src[0] in ("data", "qdata")}.values())
        gather = _Span(compute) if offloads else None
        restore_span = _Span(compute) if restores else None
        self._stage_host_reads()
        staged_imports = self._stage_imports(imported)
        # Every source's pages in the pools' form: the gathered device pages
        # (read before any restore below writes a page), the slots, then
        # the imported blocks.
        parts, row_of = [], {}
        if pages:
            parts.append(self._gather_pages(pages))
            row_of.update({("page", p): i for i, p in enumerate(pages)})
        copies = [span for _, span in self._stage_batches] + [s[3] for s in staged_imports]
        if copies:
            wait = _Span(compute)
            if compute is not None:
                for span in copies:
                    compute.wait_event(span.stop)
            self._spans.append(("wait", None, wait.end(compute)))
        if self._stage_batches:
            batches = [rows for rows, _ in self._stage_batches]
            starts = list(itertools.accumulate([len(pages)] + [len(b[0]) for b in batches]))
            row_of.update({("slot", s): starts[b] + i for s, (b, i) in self._staged.items()})
            host_rows = batches[0] if len(batches) == 1 else [torch.cat(c) for c in zip(*batches)]
            parts.append(self._to_pool_form(host_rows))
        for kind, srcs, rows, _ in staged_imports:
            start = sum(len(part[0]) for part in parts)
            row_of.update({key(src): start + i for i, src in enumerate(srcs)})
            parts.append(self._import_to_pool_form(kind, rows))
        pool_rows = parts[0] if len(parts) == 1 else [torch.cat(c) for c in zip(*parts)]

        def select(srcs) -> list[torch.Tensor]:
            idx = self._index([row_of[key(src)] for src in srcs])
            return [t.index_select(0, idx) for t in pool_rows]

        if restores:
            # In place: the decode graphs hold the pools by address.
            idx = self._index(list(restores))
            for pool, rows in zip(self._device_pools(), select(restores.values())):
                pool.index_copy_(1, idx, rows.transpose(0, 1))
            self._spans.append(("restore", len(restores), restore_span.end(compute)))
        if offloads:
            slots = sorted(offloads)
            rows = self._to_host_form(select([offloads[s] for s in slots]))
            self._copy_to_host(slots, rows, gather)
        self._pending_offloads.clear()
        self._pending_restores.clear()
        self._off_by_slot.clear()
        self._restore_by_page.clear()
        self._staged.clear()
        self._stage_batches.clear()
        stats = self.host_copy_stats
        stats["flushes"] += 1
        stats["restored"] += len(restores)
        stats["flush_host_s"] += time.perf_counter() - t_host

    def _gather_pages(self, pages: list[int]) -> list[torch.Tensor]:
        """Device pages ``pages`` of every pool, slot-major ``[n, L, ...]``."""
        idx = self._index(pages)
        return [pool.index_select(1, idx).transpose(0, 1).contiguous()
                for pool in self._device_pools()]

    # -- cross-pod KV transfer (kvcache/transfer) ---------------------------
    @property
    def kv_block_bytes(self) -> int:
        """Wire bytes of one transferred block (K and V page slices): the
        ``block_bytes`` of the router's transfer cost model. An int8 wire
        (``kv_quant`` or ``kv_quant_hbm``) ships codes plus f32 scales."""
        cfg = self.model_cfg
        elems = cfg.n_layers * self.page_size * cfg.n_kv_heads * cfg.hd
        if self._host_int8:
            return 2 * (elems + cfg.n_layers * cfg.n_kv_heads * 4)
        return 2 * elems * cfg.dtype.itemsize

    def _export_device_pages(self, pages: list[int]) -> list[torch.Tensor]:
        """Device pages in the wire's form on the host, ``[n, ...]`` each:
        one gather on the compute stream (quantized there for an int8 wire
        from full-width pools; int8 pools' scales as ``[n, L, 1, n_kv, 1]``),
        one copy into pinned staging on the copy stream, one wait."""
        compute, stream = self._compute_stream(), self._copy_stream
        stats = self.transfer_copy_stats
        gather = _Span(compute)
        rows = self._to_host_form(self._gather_pages(pages))
        gather.end(compute)
        staging = [torch.empty(r.shape, dtype=r.dtype, pin_memory=stream is not None)
                   for r in rows]
        if stream is not None:
            stream.wait_stream(compute)
        with self._on_copy_stream():
            d2h = _Span(stream)
            for buf, row in zip(staging, rows):
                buf.copy_(row, non_blocking=True)
            d2h.end(stream)
        if stream is not None:
            # Made on the compute stream, read on the copy stream.
            for row in rows:
                row.record_stream(stream)
        d2h.wait()
        stats["export_gather_s"] += gather.seconds()
        stats["export_d2h_s"] += d2h.seconds()
        stats["export_pages"] += len(pages)
        stats["export_bytes"] += sum(b.numel() * b.element_size() for b in staging)
        return staging

    def export_kv_blocks(self, hashes: list, max_blocks: Optional[int] = None):
        """Serve a peer's prefix fetch: the longest consecutive resident run
        of ``hashes`` as ``BlockPayload``s, from device pages (one gather)
        and host slots. Engine thread only: it flushes the queued page moves
        first, so the bytes are committed state."""
        from ..kvcache.transfer.protocol import BlockPayload

        self._flush_page_moves()
        chain = self.block_manager.lookup_chain(hashes, max_blocks)
        if not chain:
            return []
        cfg = self.model_cfg
        shape = (cfg.n_layers, self.page_size, cfg.n_kv_heads, cfg.hd)
        device = [(i, idx) for i, (_, _, tier, idx) in enumerate(chain) if tier == "tpu_hbm"]
        row_of = {i: j for j, (i, _) in enumerate(device)}
        rows = self._export_device_pages([p for _, p in device]) if device else []
        if len(device) < len(chain):
            self._wait_host_copies()  # a copy into a slot may still be landing
        t_encode = time.perf_counter()
        blocks = []
        for i, (h, info, tier, idx) in enumerate(chain):
            if tier == "tpu_hbm":
                data = [r[row_of[i]] for r in rows]
            else:
                data = [pool[idx] for pool in self._host_pools()]
            extra = {}
            if self._host_int8:
                # An int8 wire: codes, with the scales in the slots' layout;
                # dtype and shape stay the logical page's.
                extra = {"quant": "int8", "k_scale": _tensor_bytes(data[2]),
                         "v_scale": _tensor_bytes(data[3])}
            blocks.append(BlockPayload(
                block_hash=h,
                parent_block_hash=info.parent_hash,
                token_ids=list(info.token_ids),
                block_size=self.page_size,
                dtype=_WIRE_DTYPES[cfg.dtype],
                shape=shape,
                k_data=_tensor_bytes(data[0]),
                v_data=_tensor_bytes(data[1]),
                **extra,
            ))
        self.transfer_copy_stats["export_encode_s"] += time.perf_counter() - t_encode
        self.transfer_copy_stats["exports"] += 1
        self.transfer_stats["exported_blocks"] += len(blocks)
        return blocks

    def import_kv_blocks(self, blocks, allow_evict: bool = False, source_pod: str = "") -> int:
        """Install fetched prefix blocks as committed prefix-cache pages,
        with the JAX engine's checks in its order: geometry and payload
        length, already resident (skipped), parent gap, the chain hash of
        the carried tokens, a free page. The first failure stops the import
        (a block behind it can never prefix-hit). Each installed block
        queues a restore from its bytes, which lands before the next
        dispatch; ``BlockStored`` events flush at the end. Returns the
        blocks installed. Engine thread only.

        ``allow_evict``: recycle evictable pages to make room (the remote
        tier's import rule; by default only free pages are used).
        ``source_pod``: where the bytes came from, named in the log of a
        rejection."""
        from ..kvcache.kvblock.token_processor import hash_block

        cfg = self.model_cfg
        ps = self.page_size
        shape = (cfg.n_layers, ps, cfg.n_kv_heads, cfg.hd)
        sc_shape = quant.kv_scale_shape(shape)
        elems = math.prod(shape)
        page_bytes = elems * cfg.dtype.itemsize
        scale_bytes = math.prod(sc_shape) * 4
        bm = self.block_manager
        installed = 0
        for blk in blocks:
            quantized = blk.quant is not None
            if quantized:
                payload_ok = (
                    blk.quant == "int8"
                    and len(blk.k_data) == elems
                    and len(blk.v_data) == elems
                    and len(blk.k_scale) == scale_bytes
                    and len(blk.v_scale) == scale_bytes
                )
            else:
                payload_ok = len(blk.k_data) == page_bytes and len(blk.v_data) == page_bytes
            if (
                blk.block_size != ps
                or tuple(blk.shape) != shape
                or not _wire_dtype_matches(blk.dtype, cfg.dtype)
                or len(blk.token_ids) != ps
                or not payload_ok
            ):
                self.transfer_stats["import_rejected"] += 1
                log.warning("imported block has the wrong geometry; import stopped",
                            source=source_pod or "<unknown>")
                break
            h = blk.block_hash
            if bm.is_block_resident(h):
                continue  # the local copy wins; the chain stays continuous
            parent = blk.parent_block_hash
            if parent is not None and not bm.is_block_resident(parent):
                self.transfer_stats["import_rejected"] += 1
                break  # a chain gap: unreachable by any prefix walk
            chain_parent = parent if parent is not None else bm.token_db.init_hash
            if hash_block(chain_parent, blk.token_ids) != h:
                # The prefix cache's truth is the hash chain: never register
                # a block this engine would not hash so itself.
                self.transfer_stats["import_rejected"] += 1
                log.warning("imported block's chain hash does not match its tokens; import "
                            "stopped", source=source_pod or "<unknown>")
                break
            try:
                page = bm.install_imported_block(h, parent, blk.token_ids, allow_evict=allow_evict)
            except AllocationError:
                break  # pool full: keep what landed
            if page is None:
                continue
            if quantized:
                src = ("qdata",
                       _tensor_from_bytes(blk.k_data, torch.int8, shape),
                       _tensor_from_bytes(blk.v_data, torch.int8, shape),
                       _tensor_from_bytes(blk.k_scale, torch.float32, sc_shape),
                       _tensor_from_bytes(blk.v_scale, torch.float32, sc_shape))
            else:
                src = ("data",
                       _tensor_from_bytes(blk.k_data, cfg.dtype, shape),
                       _tensor_from_bytes(blk.v_data, cfg.dtype, shape))
            self._pending_restores.append((page, src))
            self._restore_by_page[page] = src
            installed += 1
        if installed:
            self.transfer_stats["imported_blocks"] += installed
            bm.flush_events()
        return installed

    def add_request(
        self,
        prompt_tokens: list[int],
        sampling: Optional[SamplingParams] = None,
        request_id: Optional[str] = None,
        deadline: Optional[float] = None,
    ) -> Sequence:
        """``deadline``: absolute ``time.monotonic()`` deadline. Expired
        waiting sequences are shed before prefill; running sequences past
        it finish early with ``finish_reason="deadline"``."""
        if len(prompt_tokens) == 0:
            raise ValueError("empty prompt")
        if len(prompt_tokens) >= self.config.max_model_len:
            raise ValueError("prompt exceeds max_model_len")
        # A prompt whose pages can never all fit would wait forever and
        # starve the FCFS queue behind it; reject it up front.
        prompt_pages = -(-(len(prompt_tokens) + 1) // self.page_size)
        if prompt_pages > self.config.block_manager.total_pages - 1:
            raise ValueError(
                f"prompt needs {prompt_pages} pages but the pool holds only "
                f"{self.config.block_manager.total_pages - 1}"
            )
        seq = Sequence(
            prompt_tokens=list(prompt_tokens),
            sampling=sampling or SamplingParams(),
            request_id=request_id,
            deadline=deadline,
        )
        if deadline is not None:
            self._deadlines_used = True
        self.scheduler.add(seq)
        return seq

    def abort(self, request_id: str) -> Optional[Sequence]:
        """Abort a live request, releasing its pages immediately; marks it
        FINISHED with ``finish_reason="abort"``. Returns None when no live
        sequence carries ``request_id``. Engine thread only."""
        seq = None
        for cand in (
            list(self.scheduler.waiting)
            + self.scheduler.prefilling
            + self.scheduler.running
        ):
            if cand.request_id == request_id:
                seq = cand
                break
        if seq is None:
            return None
        # An in-flight pipelined burst may hold this lane on the device:
        # commit it first so batchmates keep their tokens and the lane set
        # the next dispatch sees matches scheduler state.
        if self._inflight is not None and any(
            s is seq for s in self._inflight["active"]
        ):
            self._drain_inflight()
        if seq in self.scheduler.waiting:
            self.scheduler.waiting.remove(seq)
        else:
            self.scheduler.on_preempted(seq)  # removes from running/prefilling
        self.block_manager.free_sequence(seq)
        seq.status = SequenceStatus.FINISHED
        seq.finish_reason = "abort"
        seq.finish_time = time.monotonic()
        self.lifecycle_stats["aborted"] += 1
        self.finished.append(seq)
        # Ship pending BlockStored/BlockRemoved now: an idle engine may not
        # step again for a while.
        self.block_manager.flush_events()
        log.warning(
            "aborted request; pages released",
            request=request_id,
            seq=seq.seq_id,
            generated=seq.num_generated,
        )
        return seq

    def abort_all(self) -> list[Sequence]:
        """Abort every live sequence: commits any in-flight burst, then
        releases all pages. Engine thread only."""
        self._drain_inflight()
        out: list[Sequence] = []
        for seq in (
            list(self.scheduler.waiting)
            + list(self.scheduler.prefilling)
            + list(self.scheduler.running)
        ):
            self.scheduler.on_preempted(seq)  # removes from running/prefilling
            if seq in self.scheduler.waiting:
                self.scheduler.waiting.remove(seq)
            self.block_manager.free_sequence(seq)
            seq.status = SequenceStatus.FINISHED
            seq.finish_reason = "abort"
            seq.finish_time = time.monotonic()
            self.lifecycle_stats["aborted"] += 1
            self.finished.append(seq)
            out.append(seq)
        if out:
            self.block_manager.flush_events()
            log.warning("aborted all live requests", count=len(out))
        return out

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    @property
    def has_ready_work(self) -> bool:
        return self.scheduler.has_ready_work

    def step(self) -> list[Sequence]:
        """One engine iteration — a prefill batch or a decode step, or with
        chunked prefill a mixed step (prefill chunks, then the running
        lanes' decode). Returns sequences finished this step."""
        shed: list[Sequence] = []
        if self._deadlines_used:
            # Deadline shedding BEFORE scheduling: an expired waiting seq
            # must never reach prefill.
            now = time.monotonic()
            shed = self.scheduler.shed_expired(now)
            for seq in shed:
                seq.finish_time = now
                self.lifecycle_stats["deadline_shed"] += 1
                self.finished.append(seq)
        if self.config.host_prefetch and self.config.block_manager.host_pages:
            # Ahead of the scheduler: waiting sequences' host-cached
            # prefixes start their copies now, so this step's flush only
            # waits for what has not landed.
            self._prefetch_host_pages()
        out = self.scheduler.schedule()
        if out.prefill:
            # Prefill must see committed decode state (page accounting,
            # finish detection): it never overlaps an in-flight burst.
            self._drain_inflight()
            self._run_prefill(out.prefill, out.chunks)
        if out.decode:
            # Mixed step: the lanes were snapshotted at schedule time — a
            # final chunk published above joins next step, and lanes its
            # page growth preempted are dropped by the decode path's
            # block_table/finish filters.
            self._run_decode_fused(out.decode)
        elif not out.prefill:
            self._drain_inflight()

        newly_finished = list(shed)
        for seq in list(self.scheduler.running):
            if self._should_finish(seq):
                seq.finish_time = time.monotonic()
                self.scheduler.on_finished(seq)
                self.finished.append(seq)
                newly_finished.append(seq)

        self.block_manager.flush_events()
        self._step_count += 1
        return newly_finished

    def run_until_complete(self, max_steps: int = 100_000) -> list[Sequence]:
        done: list[Sequence] = []
        for _ in range(max_steps):
            if not self.has_work:
                break
            done.extend(self.step())
        return done

    # -- internals ----------------------------------------------------------
    def _should_finish(self, seq: Sequence) -> bool:
        if seq.num_generated == 0:
            return False
        if seq.num_generated >= seq.sampling.max_new_tokens:
            return True
        if seq.all_tokens[-1] in seq.sampling.stop_token_ids:
            return True
        if seq.deadline is not None and time.monotonic() >= seq.deadline:
            # Past-deadline running lane: finish with what it has.
            if seq.finish_reason is None:
                seq.finish_reason = "deadline"
                self.lifecycle_stats["deadline_expired"] += 1
            return True
        return seq.num_tokens >= self.config.max_model_len

    def _run_prefill(self, seqs: list[Sequence], chunks: Optional[list[int]] = None) -> None:
        """Prefill one batch. ``chunks[i]`` = prompt tokens to process for
        ``seqs[i]`` this step (chunked prefill); None = each sequence's
        whole fresh suffix. Every row attends over the paged context
        already resident — its prefix-cache hit, plus the pages its earlier
        chunks wrote. Only a sequence's final chunk samples a first token
        and publishes it to the decode lanes."""
        ps = self.page_size
        if chunks is None:
            chunks = [s.prompt_remaining for s in seqs]
        # Bucketed shapes: batch padded to the configured prefill width,
        # chunk length and context pages bucketed.
        chunk = _round_up(max(chunks), self.config.prefill_bucket)
        b = self.config.scheduler.max_prefill_batch

        tokens = np.zeros((b, chunk), np.int32)
        positions = np.zeros((b, chunk), np.int32)
        valid = np.zeros((b, chunk), bool)
        page_ids = np.zeros((b, chunk), np.int32)
        slot_ids = np.zeros((b, chunk), np.int32)
        # Zero-width context when the whole batch is cache-cold.
        max_ctx = max(s.num_prefilled // ps for s in seqs)
        ctx_pages = _round_up(max_ctx, self.config.prefill_ctx_bucket)
        ctx_bt = np.zeros((b, ctx_pages), np.int32)
        ctx_lens = np.zeros((b,), np.int32)

        t_prefill_start = time.monotonic()
        for i, (seq, n) in enumerate(zip(seqs, chunks)):
            if seq.prefill_start_time is None:
                seq.prefill_start_time = t_prefill_start
            start = seq.num_prefilled
            tokens[i, :n] = seq.prompt_tokens[start : start + n]
            pos = np.arange(start, start + n)
            positions[i, :n] = pos
            valid[i, :n] = True
            page_ids[i, :n] = np.asarray(seq.block_table, np.int32)[pos // ps]
            slot_ids[i, :n] = pos % ps
            n_ctx_pages = start // ps
            ctx_bt[i, :n_ctx_pages] = seq.block_table[:n_ctx_pages]
            ctx_lens[i] = start

        # Queued page moves last before the dispatch: restores land before
        # attention reads them, spilled pages are copied before this
        # prefill overwrites them.
        self._flush_page_moves()
        span = _Span(self._compute_stream())
        # The pools (and scale pools) are written in place.
        logits = llama.prefill(
            self.params,
            self.model_cfg,
            self._to_device(tokens),
            self._to_device(positions),
            self._to_device(valid),
            self.k_pages,
            self.v_pages,
            self._to_device(page_ids),
            self._to_device(slot_ids),
            self._to_device(ctx_bt),
            self._to_device(ctx_lens),
            k_scales=self.k_scales,
            v_scales=self.v_scales,
        )[0]
        first_tokens = self._sample(logits, seqs)  # syncs the dispatch
        # Prefill-rate sample of the cost model: chunk tokens over the
        # dispatch's time (from after the flush's restores on the card).
        span.end(self._compute_stream()).wait()
        self._prefill_rate = self._ema(
            self._prefill_rate, float(valid.sum()) / max(span.seconds(), 1e-6)
        )
        self.prefill_stats["tokens_computed"] += int(valid.sum())
        self.prefill_stats["dispatches"] += 1
        now = time.monotonic()
        finals = [
            seq for seq, n in zip(seqs, chunks)
            if seq.num_prefilled + n >= len(seq.prompt_tokens)
        ]
        # Admit to running BEFORE appending slots: batchmates must be
        # preemption candidates if page growth exhausts the pool here.
        self.scheduler.on_prefill_done(finals)
        for (seq, n), tok in zip(zip(seqs, chunks), first_tokens):
            if not seq.block_table:
                continue  # preempted by an earlier seq in this very batch
            seq.num_prefilled += n
            seq.num_computed = seq.num_prefilled
            if seq.prompt_remaining == 0:
                # Final chunk: the last-position logits are the first-token
                # logits of the whole prompt — sample and publish.
                seq.output_tokens.append(int(tok))
                seq.num_generated += 1
                if seq.first_token_time is None:
                    seq.first_token_time = now
                self._append_slot_or_preempt(seq)
            self.block_manager.register_full_pages(seq)

    def _decode_table_width(self, seqs: list[Sequence]) -> int:
        """Block-table width for this decode call: longest active context in
        pages, rounded up to ``decode_pages_bucket``."""
        used = max((len(s.block_table) for s in seqs), default=1)
        bucket = max(1, self.config.decode_pages_bucket)
        return min(self.max_pages_per_seq, _round_up(used, bucket))

    def _run_decode_fused(self, seqs: list[Sequence]) -> None:
        """Every decode goes through here; at k=1 it is the classic
        step-per-token loop, sampling on the device inside the same dispatch
        (one transfer of sampled ids, never a [lanes, vocab] logit round
        trip).

        Fused multi-token decode: reserve page capacity for the whole
        burst up front, dispatch ``decode_steps`` (one graph replay with
        on-device sampling), then commit sampled tokens per sequence,
        truncating at stop conditions. Surplus device-side KV writes land in
        pages the sequence owns (or reserved page 0 for padded lanes) and
        are never registered in the prefix cache, so discarding them is
        safe.

        With pipelining, burst N+1 is dispatched BEFORE burst N is
        fetched: its input tokens are chained on the device from burst N's
        last sampled token, so host work (fetch, commit, next dispatch)
        overlaps device execution. The pipeline only continues while the
        lane set is unchanged and no lane is about to finish; anything else
        drains first, making greedy results identical to the unpipelined
        engine (a finished/preempted lane's surplus burst is discarded by
        the same rules as surplus tokens within a burst)."""
        k = self.config.decode_steps_per_iter
        lanes = self.config.decode_batch_size
        if len(seqs) > lanes:
            raise RuntimeError(f"{len(seqs)} running sequences exceed {lanes} decode lanes")

        prev = self._inflight
        if prev is not None:
            # Drain when the pipeline cannot (or should not) continue:
            # different lane set, or every lane reaches its token budget
            # within the in-flight burst (pipelining then only produces a
            # surplus burst that gets discarded).
            same_lanes = len(prev["active"]) == len(seqs) and all(
                a is b for a, b in zip(prev["active"], seqs)
            )
            all_done_after_prev = all(
                s.num_generated + k >= s.sampling.max_new_tokens for s in seqs
            )
            if not same_lanes or all_done_after_prev:
                self._drain_inflight()
                prev = None

        # Commit lag means any drain can finish lanes mid-call; never
        # reserve pages for (or redispatch) a finished sequence — the
        # unpipelined engine would have finished it a step() ago.
        seqs = [s for s in seqs if not self._should_finish(s)]
        if not seqs:
            return

        # Reserve capacity for the burst's growth per sequence (x 2 when a
        # previous burst is still in flight); preemption inside reservation
        # may knock batchmates out of `seqs` — or the in-flight set.
        reserve = k * (2 if self._pipeline else 1)
        for seq in seqs:
            # The finished re-check matters after a mid-loop degrade-drain
            # (below): committing the lagged burst can finish any lane.
            if not seq.block_table or self._should_finish(seq):
                continue
            if reserve > k:
                # Double-burst headroom is an optimization, not a
                # requirement: when the pool is too tight for it, drain and
                # degrade to the unpipelined reservation rather than
                # preempting/aborting lanes the unpipelined engine would
                # complete.
                try:
                    self.block_manager.reserve_slots(seq, reserve)
                    continue
                except AllocationError:
                    self._drain_inflight()
                    prev = None
                    reserve = k
                    if self._should_finish(seq):
                        continue  # the drain just finished this lane
            self._reserve_slots_or_preempt(seq, reserve)
        # A degrade-drain above may also have finished lanes.
        active = [s for s in seqs if s.block_table and not self._should_finish(s)]
        if prev is not None:
            same = len(prev["active"]) == len(active) and all(
                a is b for a, b in zip(prev["active"], active)
            )
            if not same:  # reservation preempted an in-flight lane
                self._drain_inflight()
                prev = None
                active = [s for s in active if not self._should_finish(s)]
        if not active:
            self._drain_inflight()
            return

        positions = np.zeros((lanes,), np.int32)
        seq_lens = np.zeros((lanes,), np.int32)  # 0 = inactive lane
        block_tables = np.zeros((lanes, self._decode_table_width(active)), np.int32)
        temperature = np.zeros((lanes,), np.float32)
        top_k = np.zeros((lanes,), np.int32)
        top_p = np.ones((lanes,), np.float32)
        for i, seq in enumerate(active):
            bt = seq.block_table
            block_tables[i, : len(bt)] = bt
            temperature[i] = seq.sampling.temperature
            top_k[i] = seq.sampling.top_k
            top_p[i] = seq.sampling.top_p

        if prev is not None:
            # Chain from the in-flight burst: its last sampled token stays
            # on the device; positions/lengths advance by k without a host
            # sync. Inactive padded lanes keep their 0 = inactive sentinel:
            # they must not run garbage attention or write KV into reserved
            # page 0 just because the active lanes advanced.
            tokens = None
            was_active = prev["seq_lens"] > 0
            positions = np.where(was_active, prev["positions"] + k, 0).astype(np.int32)
            seq_lens = np.where(was_active, prev["seq_lens"] + k, 0).astype(np.int32)
        else:
            tokens = np.zeros((lanes,), np.int32)
            for i, seq in enumerate(active):
                tokens[i] = seq.all_tokens[-1]
                positions[i] = seq.num_tokens - 1
                seq_lens[i] = seq.num_tokens

        # Flush after the burst reservation (which can preempt and recycle
        # pages, queueing offloads of what this burst overwrites) and just
        # before the replay. With a burst in flight, the gather is enqueued
        # on the compute stream after that burst's replay, so it reads the
        # pages as the burst leaves them — what the JAX engine's gather of
        # the burst's output pools reads — and the restores land after it.
        self._flush_page_moves()
        toks = self.decode_graphs.dispatch(
            k, tokens, positions, seq_lens, block_tables, temperature, top_k, top_p
        )
        self.decode_stats["dispatches"] += 1
        self.decode_stats["steps"] += k
        burst = {
            "toks": toks,
            "active": active,
            "k": k,
            "positions": positions,
            "seq_lens": seq_lens,
        }
        if prev is not None:
            # Commit burst N while burst N+1 executes on the device.
            self._inflight = None
            self._commit_burst(prev)
        if self._pipeline:
            self._inflight = burst
        else:
            self._commit_burst(burst)

    def _drain_inflight(self) -> None:
        if self._inflight is None:
            return
        burst, self._inflight = self._inflight, None
        self._commit_burst(burst)

    def _commit_burst(self, burst: dict) -> None:
        # [lanes, k] from pinned host memory: waits on this burst's copy
        # event, the one host sync of a burst.
        toks = burst["toks"].tokens()
        for i, seq in enumerate(burst["active"]):
            if not seq.block_table:
                continue  # preempted after this burst was dispatched
            for j in range(burst["k"]):
                # Pre-check keeps num_generated <= max_new_tokens even when
                # a reservation abort clamped the cap before the burst ran.
                if self._should_finish(seq):
                    break
                seq.num_computed = seq.num_tokens
                seq.output_tokens.append(int(toks[i, j]))
                seq.num_generated += 1
            self.block_manager.register_full_pages(seq)

    def _reserve_slots_or_preempt(self, seq: Sequence, n: int) -> None:
        """Ensure ``seq`` can grow by ``n`` tokens, preempting on pool
        exhaustion."""
        self._grow_or_preempt(seq, lambda: self.block_manager.reserve_slots(seq, n))

    def _append_slot_or_preempt(self, seq: Sequence) -> None:
        """Grow ``seq`` by one slot, preempting on pool exhaustion."""
        self._grow_or_preempt(seq, lambda: self.block_manager.append_slot(seq))

    def _bring_back_cost_s(self, cand: Sequence) -> float:
        """Modeled cost of preempting ``cand`` and bringing it back later:
        registered pages survive in the prefix cache or spill to the host
        tier (per page the cheaper of restore and recompute), unregistered
        computed tokens are recomputed. Counted off ``num_computed``: a
        mid-prefill sequence's unprefilled tail costs the same either way."""
        reg_pages = cand.num_registered_pages
        fresh_toks = max(cand.num_computed - reg_pages * self.page_size, 0)
        per_page_recompute = self.page_size / self._prefill_rate
        per_page = (
            min(1.0 / self._restore_rate, per_page_recompute)
            if self._restore_rate
            else per_page_recompute
        )
        return fresh_toks / self._prefill_rate + reg_pages * per_page

    def _pick_victim(self, seq: Sequence) -> Optional[Sequence]:
        """Preemption victim: recency (the most recently admitted) by
        default; with the host tier attached and a prefill rate measured,
        the candidate with the lowest modeled bring-back cost, recency
        breaking ties. Never a sequence that is done generating
        (re-prefilling a finished one would emit a token beyond its
        max_new_tokens contract). Mid-prefill sequences come after every
        running lane."""
        candidates = [
            cand
            for cand in list(reversed(self.scheduler.running))
            + list(reversed(self.scheduler.prefilling))
            if cand is not seq and not self._should_finish(cand)
        ]
        if not candidates:
            return None
        self._harvest_copy_spans()
        if self.config.block_manager.host_pages > 0 and self._prefill_rate is not None:
            return min(candidates, key=self._bring_back_cost_s)
        return candidates[0]

    def _grow_or_preempt(self, seq: Sequence, grow) -> None:
        """Run ``grow()``; on pool exhaustion, preempt another sequence
        (recompute-style: its pages are freed — surviving cached pages make
        its later re-prefill cheap — and it requeues). When nothing is left
        to reclaim, aborts ``seq`` rather than wedging the engine."""
        while True:
            try:
                grow()
                return
            except AllocationError:
                victim = self._pick_victim(seq)
                if victim is None:
                    seq.error = "KV page pool too small for sequence growth"
                    seq.sampling.max_new_tokens = seq.num_generated
                    log.error("aborting sequence: pool exhausted", seq=seq.seq_id)
                    return
                log.warning(
                    "preempting sequence for pages",
                    victim=victim.seq_id,
                    for_seq=seq.seq_id,
                )
                self.scheduler.on_preempted(victim)
                self.block_manager.free_sequence(victim)
                victim.fold_for_preemption()
                self.scheduler.waiting.appendleft(victim)

    def _sample(self, logits: torch.Tensor, seqs: list[Sequence]) -> np.ndarray:
        b = logits.shape[0]
        temperature = np.zeros((b,), np.float32)
        top_k = np.zeros((b,), np.int32)
        top_p = np.ones((b,), np.float32)
        for i, seq in enumerate(seqs[:b]):
            temperature[i] = seq.sampling.temperature
            top_k[i] = seq.sampling.top_k
            top_p[i] = seq.sampling.top_p
        out = sample_tokens(
            logits.float(),
            self._to_device(temperature),
            self._to_device(top_k),
            self._to_device(top_p),
            self._generator,
        )
        return out.cpu().numpy()
