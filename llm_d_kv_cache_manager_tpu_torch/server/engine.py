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
``import_kv_blocks``; see "KV transfer" below), and the step telemetry
behind the pod's ``OBS_METRICS`` (``obs_step_timing``: the step record of
``server/step_record.py``, every step's host and device spans and
counters, and ``step_stats``, the JAX engine's host-clock phases folded
from it), and the fleet's knob-gated tiers: the
remote tier (``remote_tier``, ``remote_store_pages``: last-copy evictions
demote to a peer's store, see "Remote tier" below), KV-block integrity
(``kv_integrity``: write-time digests verified at every tier transition,
see "Integrity" below) and the tenant classes of ``TENANT_QOS``
(``add_request``'s ``tenant``/``priority``/``qos_weight``, priority
preemption), and speculative decoding (``spec_decode="prompt_lookup"`` and
the ``spec_*`` knobs: prompt-lookup proposals verified by a warm prefill
over [last token ++ drafts] through the flash-prefill kernel, with
acceptance and ``spec_sample`` on the device, ``spec_rounds`` rounds a
host sync; see ``_run_decode_spec``), and sharded serving (``tp``,
``sp``, ``mesh=``: see "Meshes" below).

Shapes stay bucketed as in the JAX engine (prefill batch padded to
``max_prefill_batch``, chunk length to ``prefill_bucket``, decode lanes to
``decode_batch_size``), so the page-pool bytes the port writes match the
JAX package's, padded decode lanes included (they write reserved page 0,
slot 0).

The engine runs on CUDA (prefill through the flash-prefill kernel, decode
through the paged-decode kernel) unless it is built with ``device="cpu"``,
which runs the kernels' plain PyTorch versions. ``prefill_attn`` is JAX's:
``"auto"`` is the kernel on CUDA (on int8 pages too: the kernel path
widens the context pages first) and ``"xla"`` (the plain attention)
elsewhere.

Meshes. With ``tp > 1`` or ``sp > 1`` one engine drives a
``parallel.make_mesh`` mesh of ``sp × tp`` shards (default: the first
``sp * tp`` CUDA devices; ``mesh=`` passes one, e.g. every shard on one
device): parameters are ``parallel.shard_params``' per-shard trees, the KV
pools per-tp-shard lists on the first row's devices (``init_kv_pools``),
and prefill, decode and the verify rounds run the model's ``mesh=`` path.
The block manager, the scheduler and the KV-event stream stay single: one
pod publishes one stream. ``self.device`` is the first shard's device,
where the logits are sampled. Decode bursts are captured as CUDA graphs
when every shard shares one device; shards on distinct devices run each
burst eagerly (``decode_stats["dispatch"]`` says which). The host-DRAM
tier, the remote tier and KV transfer move whole-head pages over a mesh
too: a gather reads every tp shard's pool and concatenates the shards
along the KV-head axis, and a restore or an import splits each page's
heads back over the shards in place, so host slots, wire payloads, their
sizes and digests are those of an unsharded pod. An engine serves one
replica: a mesh with ``dp > 1`` is refused. Every decode burst goes
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
last flush's event (``_wait_host_copies``).

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
here). With the remote tier on, an export continues from the remote
store, and an import may recycle evictable pages.

Remote tier. The block manager calls ``_queue_demotion`` when an eviction
destroys the last local copy of a block. A device page joins the next
flush's gather, before any restore of that flush writes a page; a host slot
is copied at once (after ``_wait_host_copies``), since the block manager
reuses it. The flush turns the device rows into the wire's form on the
device, copies them into pinned staging on the copy stream and waits
(``step_stats["demote_s"]``), then hands the ``BlockPayload``s to
``on_demotion``. ``accept_remote_blocks`` commits a peer's push into the
remote store, whose blocks the index lists under this pod with
``medium="remote"``.

Integrity. Digests are taken over the stored bytes, bf16 through their
``int16`` view, so a page digests as the JAX engine's does. The flush only
enqueues its copies into the host slots, so a slot's write-time digest is
recorded once the copy has landed (``_pending_digests``, at the next
harvest of passed spans or host wait); every host read of a slot waits for
the copies first. A restore, prefetch, scrub or export that finds a slot
differing from its record quarantines it and publishes ``BadBlock``; the
chain breaks there and the suffix recomputes. Imports check the digest a
payload carries.
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
from ..parallel.mesh import MeshConfig, make_mesh
from ..parallel.sharding import ShardedParams, init_kv_pools, shard_params
from ..utils import get_logger
from .block_manager import AllocationError, BlockManager, BlockManagerConfig
from .decode_graphs import DecodeGraphs
from ..ops.sampling import sample_tokens
from .scheduler import Scheduler, SchedulerConfig
from .sequence import SamplingParams, Sequence, SequenceStatus
from .step_record import ANCHOR_AGE_NS, EngineSequence, StepRecord

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
    #: speculative decoding: "off" or "prompt_lookup" (draft-model-free:
    #: propose the continuation of the context's own last n-gram from an
    #: earlier occurrence; one verify dispatch, a warm prefill over
    #: [last token ++ proposals], scores all k+1 tokens). Greedy lanes
    #: accept iff draft == argmax; temperature>0 lanes run
    #: deterministic-draft speculative sampling (``ops.spec_sample``), exact
    #: for each lane's filtered distribution.
    spec_decode: str = "off"
    #: proposed tokens per verify round (accepted 0..k, plus one corrected
    #: or bonus token: a round never yields fewer tokens than a decode step)
    spec_k: int = 4
    #: n-gram length to match for prompt-lookup proposals
    spec_ngram: int = 3
    #: how far back the proposal search scans
    spec_max_scan: int = 4096
    #: verify rounds per dispatch, chained on the device (propose, verify,
    #: accept, advance; ``llama.spec_decode_steps``) with one host sync a
    #: burst. Higher values amortize the host's per-dispatch time, at the
    #: cost of gate and fallback decisions lagging a burst.
    spec_rounds: int = 1
    #: adaptive per-sequence gate (one-way): once a sequence has had at
    #: least spec_min_sample proposed tokens, stop proposing for it while
    #: its acceptance rate sits below spec_min_accept, so it takes the
    #: plain decode path instead of paying verify dispatches.
    spec_min_accept: float = 0.4
    spec_min_sample: int = 8
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
    #: remote tier (``REMOTE_TIER``): an eviction that would destroy the
    #: last local copy of a cached block builds a wire-ready demotion
    #: payload (int8 codes and scales under ``kv_quant``) and hands it to
    #: ``on_demotion``, the pod's pusher; imports may recycle evictable
    #: pages (their victims demote). Off by default: plain eviction.
    remote_tier: bool = False
    #: remote-store capacity in pages: how many demoted blocks this engine
    #: holds for peers (0 = none). Read only with ``remote_tier`` on.
    remote_store_pages: int = 0
    #: KV-block content integrity (``KV_INTEGRITY``): write-time digests of
    #: the stored bytes of every host spill, demotion and export, verified at
    #: every tier transition; a failed check quarantines the copy, cuts the
    #: chain at it (the suffix recomputes) and publishes ``BadBlock``. Off by
    #: default.
    kv_integrity: bool = False
    #: digest side-table capacity in entries (LRU); read only with
    #: ``kv_integrity`` on
    kv_integrity_table_cap: int = 65536
    #: tensor-parallel degree (``TP``): attention heads, FFN width, experts
    #: and vocabulary split over tp shards (``parallel/sharding.py``), the
    #: KV pools head-parallel. Requires n_heads % tp == 0 and
    #: n_kv_heads % tp == 0.
    tp: int = 1
    #: sequence-parallel degree for prefill (``SP``): the chunk is split
    #: over sp rows and attended by ring attention with an exact
    #: paged-context merge; decode stays tp-only. Composes with tp;
    #: requires sp | prefill_bucket.
    sp: int = 1
    #: prefill attention: "auto" (the flash-prefill kernel on CUDA, the
    #: plain attention elsewhere), "pallas" (the kernel's path) or "xla"
    #: (the plain attention, masked token by token)
    prefill_attn: str = "auto"
    seed: int = 0


class Engine:
    def __init__(
        self,
        config: EngineConfig,
        params=None,
        on_events: Optional[Callable[[list[Event]], None]] = None,
        device=None,
        mesh=None,
    ):
        """``params``: a parameter dict on ``device`` (``models.init_params``
        / ``models.params_from_jax``); None random-initialises from
        ``config.seed``. ``device``: None = the current CUDA device (raises
        when there is none), ``"cpu"`` = plain PyTorch on the CPU.
        ``mesh``: a ``parallel.make_mesh`` mesh whose sp and tp match the
        config (its first device is the engine's; ``device`` must then be
        None or that device); None with tp or sp > 1 builds one over the
        first ``sp * tp`` CUDA devices."""
        self.config = config
        cfg = config.model
        self.mesh = self._make_mesh(config, mesh, device)
        self.device = self.mesh.root if self.mesh is not None else resolve_device(device)
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
        if config.spec_decode not in ("off", "prompt_lookup"):
            raise ValueError(f"unknown spec_decode {config.spec_decode!r}")
        if config.spec_decode != "off":
            if config.spec_k < 1:
                raise ValueError("spec_k must be >= 1")
            if config.spec_ngram < 1:
                raise ValueError("spec_ngram must be >= 1")
            if config.spec_rounds < 1:
                raise ValueError("spec_rounds must be >= 1")
            if config.kv_quant_hbm is not None:
                # The verify rounds read pages full-width through the
                # flash-prefill kernel: refuse rather than quietly widen.
                raise ValueError("kv_quant_hbm is incompatible with spec_decode")
        if config.prefill_attn not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown prefill_attn {config.prefill_attn!r}")
        #: the prefill attention actually run ("auto" resolved)
        self.prefill_attn = config.prefill_attn
        if self.prefill_attn == "auto":
            self.prefill_attn = "pallas" if self.device.type == "cuda" else "xla"
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
        elif isinstance(params, ShardedParams):
            if self.mesh is None or params.mesh.grid != self.mesh.grid:
                raise ValueError("params are sharded over another mesh than the engine's")
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
        if self.mesh is not None:
            # A tree on the first shard's device: its slices are views
            # wherever a shard shares that device.
            params = shard_params(params, self.mesh, cfg)
        self.params = params
        # Updated in place by every prefill / decode dispatch. Under a mesh
        # each is a per-tp-shard list.
        self.k_scales: Optional[torch.Tensor] = None
        self.v_scales: Optional[torch.Tensor] = None
        if self.mesh is not None:
            self.k_pages, self.v_pages, self.k_scales, self.v_scales = init_kv_pools(
                cfg, config.block_manager.total_pages, ps, self.mesh,
                kv_quant_hbm=config.kv_quant_hbm,
            )
        else:
            self.k_pages, self.v_pages = llama.init_kv_pages(
                cfg, config.block_manager.total_pages, ps, self.device,
                kv_quant_hbm=config.kv_quant_hbm,
            )
            # Scale pools of the int8 pages (None when the knob is off).
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
        self._init_fleet_tiers()
        #: decode dispatches (a mixed step makes one prefill and one decode
        #: dispatch, so engine steps do not count them), the model steps
        #: they ran (``decode_steps_per_iter`` a dispatch), and how a burst
        #: is dispatched ("graph": one CUDA graph replay; "eager": the CPU,
        #: or shards on distinct devices)
        self.decode_stats = {"dispatches": 0, "steps": 0, "dispatch": ""}
        #: speculative decoding: proposed and accepted draft tokens, verify
        #: rounds and host-sync bursts (acceptance rate = accepted /
        #: proposed; rounds a sync = verify_steps / bursts)
        self.spec_stats = {"proposed": 0, "accepted": 0, "verify_steps": 0, "bursts": 0}
        self._generator = torch.Generator(device=self.device).manual_seed(
            config.seed ^ 0x5EED
        )
        #: every decode burst's dispatch: one CUDA graph replay on the card
        self.decode_graphs = DecodeGraphs(
            self.params, cfg, self.k_pages, self.v_pages, self.k_scales, self.v_scales,
            lanes=config.decode_batch_size, max_pages=self.max_pages_per_seq,
            page_size=ps, generator=self._generator, device=self.device,
            chain=self._pipeline, mesh=self.mesh,
        )
        self.decode_stats["dispatch"] = "graph" if self.decode_graphs.capture else "eager"
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
        #: the step record (``server/step_record.py``): None while
        #: ``obs_step_timing`` is off, when no clock is read for it
        self.step_record: Optional[StepRecord] = None
        #: engine-step telemetry, the JAX engine's phases and keys, folded
        #: from the step record: cumulative host wall seconds per phase —
        #: schedule, prefill (dispatch + sampling), decode (dispatch +
        #: commit), sample (the blocking fetch of sampled ids, a slice of
        #: prefill/decode), gather (page moves between tiers, enqueued on
        #: the streams), demote (the remote tier's demotion payloads, their
        #: copy back included), publish (finish detection + KV-event flush).
        #: Host clocks on an asynchronous device: a graph replay's decode
        #: seconds are its launch, and the wait for the device lands in
        #: ``sample_s`` where the sampled ids are read; the device's own
        #: time is in the record's ``device.*`` spans.
        self.step_stats = {
            "steps": 0,
            "schedule_s": 0.0,
            "prefill_s": 0.0,
            "decode_s": 0.0,
            "sample_s": 0.0,
            "gather_s": 0.0,
            "demote_s": 0.0,
            "publish_s": 0.0,
        }

    @property
    def obs_step_timing(self) -> bool:
        """Step telemetry: the step record, ``step_stats`` and the decode
        graphs' expert-group counter (in graphs captured while it is on).
        Off by default."""
        return self.step_record is not None

    @obs_step_timing.setter
    def obs_step_timing(self, on: bool) -> None:
        if bool(on) == (self.step_record is not None):
            return
        self.step_record = (
            StepRecord(self._compute_stream(), self.device, self.step_stats) if on else None
        )
        self.decode_graphs.clock = self.step_record.to_ns if on else None

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @staticmethod
    def _make_mesh(config: EngineConfig, mesh, device):
        """The engine's mesh (None for one device), with JAX's checks."""
        cfg = config.model
        if config.tp < 1 or config.sp < 1:
            raise ValueError(f"tp={config.tp} and sp={config.sp} must be >= 1")
        if config.kv_quant_hbm is not None and config.sp > 1:
            # The ring reads context pages full-width.
            raise ValueError("kv_quant_hbm is incompatible with sp > 1")
        if config.tp == 1 and config.sp == 1:
            if mesh is not None and len(mesh.devices) != 1:
                raise ValueError(f"a mesh of {len(mesh.devices)} devices for tp=1, sp=1")
            return None
        if cfg.n_heads % config.tp or cfg.n_kv_heads % config.tp:
            raise ValueError(
                f"tp={config.tp} must divide n_heads={cfg.n_heads} and "
                f"n_kv_heads={cfg.n_kv_heads}"
            )
        if config.sp > 1 and config.prefill_bucket % config.sp:
            raise ValueError(
                f"sp={config.sp} must divide prefill_bucket={config.prefill_bucket} "
                f"(chunk lengths are bucket multiples and must shard evenly)"
            )
        if mesh is None:
            return make_mesh(MeshConfig(dp=1, sp=config.sp, tp=config.tp))
        if mesh.shape["dp"] != 1:
            # Serving runs one replica, as the JAX engine builds dp=1 meshes.
            raise ValueError(f"an engine serves one replica: the mesh has dp={mesh.shape['dp']}")
        if mesh.shape["sp"] != config.sp or mesh.shape["tp"] != config.tp:
            raise ValueError(
                f"provided mesh {mesh.shape} does not match config sp={config.sp}, tp={config.tp}"
            )
        if device is not None and torch.device(device) != mesh.root:
            raise ValueError(f"device {device} is not the mesh's first device {mesh.root}")
        return mesh

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
        #: (pages, start_ns, end_ns) on ``time.monotonic_ns`` of the latest
        #: prefetch round that moved pages; the pod loop takes it
        self.last_prefetch: Optional[tuple[int, int, int]] = None
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

    def _init_fleet_tiers(self) -> None:
        """The integrity plane (``kv_integrity``) and the remote tier
        (``remote_tier``), attached as the JAX engine attaches them; with
        both knobs off nothing here changes a path."""
        config, cfg, ps = self.config, self.model_cfg, self.page_size
        #: the digest side table and quarantine ledger (None = knob off)
        self.integrity = None
        if config.kv_integrity:
            from ..kvcache.integrity import BlockIntegrity

            self.integrity = BlockIntegrity(table_cap=config.kv_integrity_table_cap)
            self.block_manager.attach_integrity(self.integrity, self._verify_host_slot)
        #: write-time digests whose slot copies may still be landing:
        #: (slot, block hash), recorded once the copies have passed
        self._pending_digests: list = []
        #: the demotion payloads' sink, set by the pod's pusher; None drops
        #: demotions (plain eviction)
        self.on_demotion: Optional[Callable[[list], None]] = None
        #: queued (info, source) demotions, built at the next flush
        self._pending_demotions: list = []
        self.remote_stats = {"demoted_blocks": 0, "demote_batches": 0, "accepted_blocks": 0}
        self.remote_store = None
        if config.remote_tier and config.remote_store_pages > 0:
            from ..kvcache.transfer.remote_store import RemoteBlockStore, RemoteStoreConfig

            def _store_events(events):
                # Late-bound: a pod attaches its publisher to the block
                # manager after an injected engine is built.
                sink = self.block_manager.on_events
                if sink is not None:
                    sink(events)

            shape = (cfg.n_layers, ps, cfg.n_kv_heads, cfg.hd)
            store_cfg = RemoteStoreConfig(
                capacity_pages=config.remote_store_pages,
                page_size=ps,
                page_shape=shape,
                dtype=_WIRE_DTYPES[cfg.dtype],
                scale_bytes=math.prod(quant.kv_scale_shape(shape)) * 4,
                init_hash=self.block_manager.token_db.init_hash,
            )
            try:
                np.dtype(store_cfg.dtype)
                sized = store_cfg
            except TypeError:
                # numpy knows bfloat16 only through ml_dtypes: the store
                # sizes its pages from a dtype of the same width and checks
                # payloads against the wire name.
                sized = dataclasses.replace(store_cfg, dtype="float16")
            self.remote_store = RemoteBlockStore(
                sized, on_events=_store_events, integrity=self.integrity
            )
            self.remote_store.config = store_cfg
        if config.remote_tier:
            self.block_manager.attach_demoter(self._queue_demotion)

    def _probe_link(self) -> None:
        """Measure the device-to-host rate once at start-up, so that the
        cost model gates the very first spills: 16 pages, K and V, gathered
        and copied into pinned host memory as a flush copies them, timed
        after a warm-up and only once the copies have finished (a timing of
        their enqueue would read as a far faster link)."""
        n = min(16, self.config.block_manager.total_pages)
        cuda = self.device.type == "cuda"
        pages = [0] * n
        dest = [torch.empty(r.shape, dtype=r.dtype, pin_memory=cuda)
                for r in self._gather_pages(pages)[:2]]

        def copy():
            for d, row in zip(dest, self._gather_pages(pages)[:2]):
                d.copy_(row, non_blocking=True)
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
        are int8 their scale pools ``[L, total_pages, n_kv]``; under a mesh
        every tp shard's pool, pool by pool (``_pool_shards``)."""
        return [t for shards in self._pool_shards() for t in shards]

    def _pool_shards(self) -> list[list[torch.Tensor]]:
        """Each of ``_device_pools``' pools as its list of tp shards: one
        whole pool without a mesh; under a mesh each shard holds ``n_kv /
        tp`` heads on the first sp row's devices."""
        pools = [t for t in (self.k_pages, self.v_pages, self.k_scales, self.v_scales)
                 if t is not None]
        return pools if self.mesh is not None else [[t] for t in pools]

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
        if self._pending_digests and self._host_ready.seconds() is not None:
            self._record_slot_digests()

    # -- KV-block content integrity (KV_INTEGRITY) --------------------------
    def _slot_digest(self, slot: int) -> int:
        """Content digest of one host slot's stored bytes (int8 codes and
        scales on an int8 tier, the model dtype's bytes otherwise: what a
        restore reads back and a host-tier export ships). The caller has
        waited for the copies into the slots."""
        from ..kvcache.integrity import page_digest

        return page_digest(*(_tensor_bytes(pool[slot]) for pool in self._host_pools()))

    def _record_slot_digests(self) -> None:
        """Record the write-time digests of the slots the flushes filled,
        once their copies have landed (a digest taken when the flush only
        enqueued the copy would hash the slot's old bytes). A slot that no
        longer holds the block it was written for is skipped: its copy was
        evicted or restored, and its record dropped, meanwhile."""
        pending, self._pending_digests = self._pending_digests, []
        host_info = self.block_manager._host_info
        for slot, h in pending:
            info = host_info.get(slot)
            if info is not None and info.chain_hash == h:
                self.integrity.record(h, self._slot_digest(slot))

    def _host_slot_digest(self, slot: int) -> int:
        """``_slot_digest`` once every copy into the slots has landed."""
        self._wait_host_copies()
        return self._slot_digest(slot)

    def _verify_host_slot(self, slot: int, h: int, reason: str) -> bool:
        """The block manager's integrity hook: recompute the digest of
        ``slot`` and compare it with the write-time record. False only for
        a corrupt copy, quarantined first; a missing record passes."""
        from ..kvcache.integrity import CHECK_CORRUPT

        outcome = self.integrity.check(h, self._host_slot_digest(slot), reason)
        if outcome == CHECK_CORRUPT:
            self.integrity.quarantine(h, tier="host_dram")
            return False
        return True

    def scrub_host_pages(self, max_pages: int) -> int:
        """One background scrub batch (the pod stages it onto the engine
        loop): flush the queued page moves, so fresh spills have their
        digests, then verify a rotating batch of resident host slots; the
        events of any quarantine flush at once. Returns slots checked."""
        if self.integrity is None:
            return 0
        self._flush_page_moves()
        n = self.block_manager.scrub_host_tier(max_pages)
        if n:
            self.block_manager.flush_events()
        return n

    def _verify_demote_src(self, info, src) -> bool:
        """Check a demotion's snapshot before it ships, when the snapshot is
        still in the stored form (a host slot's codes and scales, or its
        full-width bytes on a full-width tier); other sources are verified
        by the receiver against the payload's digest. A corrupt snapshot is
        quarantined here and revoked fleet-wide with ``BadBlock``."""
        from ..kvcache.integrity import CHECK_CORRUPT, page_digest
        from ..kvcache.kvevents.events import BadBlock

        if src[0] == "qdata" or (src[0] == "data" and not self._host_int8):
            d = page_digest(*(_tensor_bytes(t) for t in src[1:]))
        else:
            return True
        h = info.chain_hash
        if self.integrity.check(h, d, "export") != CHECK_CORRUPT:
            return True
        self.integrity.quarantine(h, tier="host_dram")
        self.block_manager._record_lifecycle(
            h, "none", "quarantine", tenant=getattr(info, "tenant", "")
        )
        self.block_manager._emit(BadBlock(block_hashes=[h], medium="host_dram"))
        log.warning("demotion payload failed digest check; quarantined", block=h)
        return False

    # -- remote-tier demotion (REMOTE_TIER) ---------------------------------
    def _queue_demotion(self, info, tier: str, idx: int) -> None:
        """The block manager's demotion hook: the last local copy of
        ``info.chain_hash`` is being destroyed, so queue its bytes for the
        next flush to build a payload from. A device page is read by the
        flush's gather (its contents hold until the next dispatch); a host
        slot is reused at once, so it is copied now, after the copies into
        the slots have landed. No sink: plain eviction, no work."""
        if self.on_demotion is None:
            return
        if tier == "tpu_hbm":
            src = self._restore_by_page.get(idx, ("page", idx))
        else:
            src = self._off_by_slot.get(idx)
            if src is None:
                self._wait_host_copies()
                kind = "qdata" if self._host_int8 else "data"
                src = (kind,) + tuple(pool[idx].clone() for pool in self._host_pools())
        self._pending_demotions.append((info, src))

    def _build_demotions(self, select) -> None:
        """Build the queued demotions' wire payloads and hand them to
        ``on_demotion``. Device-held sources (a page, or a slot a restore
        staged) come from the flush's rows through ``select``, in the wire's
        form on the device, then one copy into pinned staging on the copy
        stream and one wait; host sources are used as they are."""
        from ..kvcache.integrity import page_digest
        from ..kvcache.transfer.protocol import BlockPayload

        cfg = self.model_cfg
        shape = (cfg.n_layers, self.page_size, cfg.n_kv_heads, cfg.hd)
        device_srcs = [src for _, src in self._pending_demotions if src[0] in ("page", "slot")]
        host_rows: list = []
        if device_srcs:
            host_rows, _, _ = self._copy_rows_to_host(self._to_host_form(select(device_srcs)))
        payloads = []
        row = 0
        for info, src in self._pending_demotions:
            if src[0] in ("page", "slot"):
                data = [r[row] for r in host_rows]
                row += 1
            else:
                if self.integrity is not None and not self._verify_demote_src(info, src):
                    continue
                data = list(src[1:])
                if src[0] == "data" and self._host_int8:
                    (kq, ks), (vq, vs) = (quant.quantize_kv_page(t) for t in data)
                    data = [kq, vq, ks, vs]
            extra = {}
            if len(data) == 4:
                extra = {"quant": "int8", "k_scale": _tensor_bytes(data[2]),
                         "v_scale": _tensor_bytes(data[3])}
            payload = BlockPayload(
                block_hash=info.chain_hash,
                parent_block_hash=info.parent_hash,
                token_ids=list(info.token_ids),
                block_size=self.page_size,
                dtype=_WIRE_DTYPES[cfg.dtype],
                shape=shape,
                k_data=_tensor_bytes(data[0]),
                v_data=_tensor_bytes(data[1]),
                **extra,
            )
            if self.integrity is not None:
                # The digest of the final payload bytes travels with them;
                # the local record goes with the last local copy.
                payload.digest = page_digest(
                    payload.k_data, payload.v_data, payload.k_scale, payload.v_scale
                )
                self.integrity.drop(info.chain_hash)
            payloads.append(payload)
        self._pending_demotions.clear()
        self.remote_stats["demoted_blocks"] += len(payloads)
        self.remote_stats["demote_batches"] += 1
        sink = self.on_demotion
        if sink is not None:
            sink(payloads)

    def accept_remote_blocks(self, source_pod: str, payloads) -> tuple[int, int]:
        """Commit a peer's demotion push into this engine's remote store (its
        ``BlockStored(medium="remote")`` events flush at once). Returns
        ``(accepted, headroom)``. Engine thread only."""
        if self.remote_store is None:
            return 0, 0
        accepted = self.remote_store.accept(payloads, source_pod=source_pod)
        if accepted:
            self.remote_stats["accepted_blocks"] += accepted
        return accepted, self.remote_store.headroom

    @property
    def remote_headroom(self) -> Optional[int]:
        """Pages the remote store still accepts (the heartbeat's headroom);
        None with the tier off, so the heartbeat's bytes stay the legacy
        ones."""
        if not self.config.remote_tier:
            return None
        # `is not None`: an empty store (the largest headroom) is falsy.
        return self.remote_store.headroom if self.remote_store is not None else 0

    def block_digest(self) -> dict[str, list[int]]:
        """Resync digest across every tier this pod holds: the block
        manager's (device pages and host slots) and the remote store's, so
        a resync never wipes the demoted entries this pod holds."""
        digest = self.block_manager.block_digest()
        if self.remote_store is not None and len(self.remote_store):
            digest["remote"] = self.remote_store.hashes()
        return digest

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
        t0 = time.monotonic_ns()
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
            rec = self.step_record
            t1 = rec.host("engine.host_prefetch", t0) if rec else time.monotonic_ns()
            self.last_prefetch = (pages, t0, t1)

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
        if not (self._pending_offloads or self._pending_restores or self._pending_demotions):
            return
        t_host = time.perf_counter()
        self._harvest_copy_spans()
        compute = self._compute_stream()
        key = self._source_key
        offloads = dict(self._pending_offloads)  # slot -> source
        restores = dict(self._pending_restores)  # page -> source
        sources = list(offloads.values()) + list(restores.values())
        # Demotions read their device pages through the same gather; their
        # host bytes (a slot's snapshot, an import's payload) stay on the host.
        pages = list(dict.fromkeys(
            src[1] for src in sources + [src for _, src in self._pending_demotions]
            if src[0] == "page"
        ))
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
        pool_rows = (parts[0] if len(parts) == 1 else [torch.cat(c) for c in zip(*parts)]
                     if parts else [])

        def select(srcs) -> list[torch.Tensor]:
            idx = self._index([row_of[key(src)] for src in srcs])
            return [t.index_select(0, idx) for t in pool_rows]

        if restores:
            # In place: the decode graphs hold the pools by address.
            idx = self._index(list(restores))
            for shards, rows in zip(self._pool_shards(), select(restores.values())):
                self._scatter_rows(shards, idx, rows.transpose(0, 1))
            self._spans.append(("restore", len(restores), restore_span.end(compute)))
        if offloads:
            slots = sorted(offloads)
            rows = self._to_host_form(select([offloads[s] for s in slots]))
            self._copy_to_host(slots, rows, gather)
            if self.integrity is not None:
                # Write-time digests, taken once the copies have landed.
                host_info = self.block_manager._host_info
                self._pending_digests += [
                    (slot, host_info[slot].chain_hash) for slot in slots
                    if slot in host_info and host_info[slot].chain_hash is not None
                ]
                self._harvest_copy_spans()
        demote_s = 0.0
        if self._pending_demotions:
            # Remote-tier work, timed apart from the page moves.
            t_demote = time.perf_counter()
            self._build_demotions(select)
            demote_s = time.perf_counter() - t_demote
        self._pending_offloads.clear()
        self._pending_restores.clear()
        self._off_by_slot.clear()
        self._restore_by_page.clear()
        self._staged.clear()
        self._stage_batches.clear()
        stats = self.host_copy_stats
        stats["flushes"] += 1
        stats["restored"] += len(restores)
        host_s = time.perf_counter() - t_host - demote_s
        stats["flush_host_s"] += host_s
        if self.step_record:
            self.step_record.count("gather_s", host_s)
            self.step_record.count("demote_s", demote_s)

    def _gather_pages(self, pages: list[int]) -> list[torch.Tensor]:
        """Device pages ``pages`` of every pool, slot-major ``[n, L, ...]``
        on the engine's device. Under a mesh each tp shard's pages are
        concatenated along the KV-head axis: a row is the whole-head page a
        tp=1 pool (or the JAX engine's global array) holds."""
        idx = self._index(pages)
        out = []
        for shards in self._pool_shards():
            parts = [pool.index_select(1, idx.to(pool.device)).transpose(0, 1).contiguous()
                     for pool in shards]
            if len(parts) == 1:
                out.append(parts[0])
            else:  # heads: axis 3 of a page [n, L, ps, n_kv, hd], 2 of a scale [n, L, n_kv]
                axis = 3 if parts[0].dim() == 5 else 2
                out.append(torch.cat([p.to(self.device) for p in parts], dim=axis))
        return out

    @staticmethod
    def _scatter_rows(shards: list[torch.Tensor], idx: torch.Tensor, rows: torch.Tensor) -> None:
        """Write whole-head pages ``rows [L, n, ...]`` into pages ``idx`` of a
        pool's tp shards, in place: each shard takes its slice of the
        KV-head axis (``kv_pages_sharding``, ``kv_scales_sharding``)."""
        if len(shards) == 1:
            shards[0].index_copy_(1, idx, rows)
            return
        axis = 3 if rows.dim() == 5 else 2
        for t, pool in enumerate(shards):
            width = pool.shape[axis]
            part = rows.narrow(axis, t * width, width)
            pool.index_copy_(1, idx.to(pool.device), part.to(pool.device))

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
        compute = self._compute_stream()
        stats = self.transfer_copy_stats
        gather = _Span(compute)
        rows = self._to_host_form(self._gather_pages(pages))
        gather.end(compute)
        staging, d2h, n_bytes = self._copy_rows_to_host(rows)
        stats["export_gather_s"] += gather.seconds()
        stats["export_d2h_s"] += d2h.seconds()
        stats["export_pages"] += len(pages)
        stats["export_bytes"] += n_bytes
        return staging

    def _copy_rows_to_host(self, rows: list[torch.Tensor]) -> tuple[list, _Span, int]:
        """Copy device rows the compute stream made into pinned staging on
        the copy stream and wait for them: ``(staging, span of the copy,
        bytes)``."""
        compute, stream = self._compute_stream(), self._copy_stream
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
        return staging, d2h, sum(b.numel() * b.element_size() for b in staging)

    def export_kv_blocks(self, hashes: list, max_blocks: Optional[int] = None):
        """Serve a peer's prefix fetch: the longest consecutive resident run
        of ``hashes`` as ``BlockPayload``s, from device pages (one gather)
        and host slots, continued from the remote store. Engine thread only:
        it flushes the queued page moves first, so the bytes are committed
        state. With ``kv_integrity`` every payload carries its digest, and a
        host-tier block that fails its record is quarantined and ends the
        export there."""
        from ..kvcache.integrity import CHECK_CORRUPT, page_digest
        from ..kvcache.transfer.protocol import BlockPayload

        self._flush_page_moves()
        chain = self.block_manager.lookup_chain(hashes, max_blocks)
        # The remote store serves the rest of the run from its wire-ready
        # payloads, with the same stop at the first gap.
        remote_tail: list = []
        if self.remote_store is not None:
            cap = len(hashes) if max_blocks is None else min(max_blocks, len(hashes))
            remote_tail = self.remote_store.serve(hashes[len(chain) : cap], cap - len(chain))
        if not chain:
            if remote_tail:
                self.transfer_stats["exported_blocks"] += len(remote_tail)
            return remote_tail
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
            payload = BlockPayload(
                block_hash=h,
                parent_block_hash=info.parent_hash,
                token_ids=list(info.token_ids),
                block_size=self.page_size,
                dtype=_WIRE_DTYPES[cfg.dtype],
                shape=shape,
                k_data=_tensor_bytes(data[0]),
                v_data=_tensor_bytes(data[1]),
                **extra,
            )
            if self.integrity is not None:
                # A host-tier payload is the slot's stored bytes, so its
                # digest is checked against the write-time record; a device
                # page's is stamped. Never ship a corrupt copy: quarantine
                # it, revoke it and end the export at it.
                d = page_digest(payload.k_data, payload.v_data, payload.k_scale, payload.v_scale)
                if tier == "host_dram" and self.integrity.check(h, d, "export") == CHECK_CORRUPT:
                    self.integrity.quarantine(h, tier="host_dram")
                    self.block_manager.quarantine_host_block(h)
                    self.block_manager.flush_events()
                    remote_tail = []
                    break
                payload.digest = d
            blocks.append(payload)
        blocks.extend(remote_tail)
        self.transfer_copy_stats["export_encode_s"] += time.perf_counter() - t_encode
        self.transfer_copy_stats["exports"] += 1
        self.transfer_stats["exported_blocks"] += len(blocks)
        return blocks

    def import_kv_blocks(
        self, blocks, allow_evict: Optional[bool] = None, source_pod: str = ""
    ) -> int:
        """Install fetched prefix blocks as committed prefix-cache pages,
        with the JAX engine's checks in its order: geometry and payload
        length, already resident (skipped), parent gap, the chain hash of
        the carried tokens, a free page. The first failure stops the import
        (a block behind it can never prefix-hit). Each installed block
        queues a restore from its bytes, which lands before the next
        dispatch; ``BlockStored`` events flush at the end. Returns the
        blocks installed. Engine thread only.

        ``allow_evict``: recycle evictable pages to make room; None follows
        ``remote_tier`` (whose victims demote, so the trade is lossless),
        else only free pages are used. ``source_pod``: where the bytes came
        from, named in the log of a rejection and, with ``kv_integrity``, in
        the ``BadBlock`` published when a payload fails its carried digest
        (the import then stops there)."""
        from ..kvcache.kvblock.token_processor import hash_block

        if allow_evict is None:
            allow_evict = self.config.remote_tier

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
            if self.integrity is not None and not self._import_digest_ok(blk, source_pod):
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

    def _import_digest_ok(self, blk, source_pod: str) -> bool:
        """Check an imported payload against the digest it carries. A
        mismatch (the bytes rotted on the wire or in the holder's store) is
        rejected, quarantined here and revoked with a ``BadBlock`` naming
        ``source_pod``; a payload without a digest passes unverified."""
        from ..kvcache.integrity import CHECK_CORRUPT, page_digest
        from ..kvcache.kvevents.events import BadBlock

        h = blk.block_hash
        computed = page_digest(blk.k_data, blk.v_data, blk.k_scale, blk.v_scale)
        if self.integrity.check_carried(h, blk.digest, computed, "import") != CHECK_CORRUPT:
            return True
        self.transfer_stats["import_rejected"] += 1
        self.integrity.quarantine(h, tier="wire")
        self.block_manager._emit(BadBlock(block_hashes=[h], pod=source_pod))
        self.block_manager.flush_events()
        log.warning("imported KV payload failed digest check; rejected", block=h,
                    source=source_pod or "<unknown>")
        return False

    def add_request(
        self,
        prompt_tokens: list[int],
        sampling: Optional[SamplingParams] = None,
        request_id: Optional[str] = None,
        deadline: Optional[float] = None,
        tenant: str = "",
        priority: int = 0,
        qos_weight: float = 1.0,
    ) -> Sequence:
        """``deadline``: absolute ``time.monotonic()`` deadline. Expired
        waiting sequences are shed before prefill; running sequences past
        it finish early with ``finish_reason="deadline"``.
        ``tenant``/``priority``/``qos_weight``: the request's ``TENANT_QOS``
        class, which the pod resolves from its policy; the defaults (knob
        off) put every sequence in one class."""
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
        seq = EngineSequence(
            prompt_tokens=list(prompt_tokens),
            sampling=sampling or SamplingParams(),
            request_id=request_id,
            deadline=deadline,
            tenant=tenant,
            priority=priority,
            qos_weight=qos_weight,
            commit_times=[] if self.step_record else None,
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

    def freeze_for_migration(
        self, request_id: str
    ) -> Optional[tuple[Sequence, list[int]]]:
        """Freeze a live request for live migration (``FLEET_CONTROLLER``
        scale-down): commit any in-flight burst, take the sequence out of
        scheduling preemption-style (its registered pages survive in the
        prefix cache, exportable by chain hash), fold its generated tokens
        into the prompt, and park it back in the waiting queue
        ``importing`` so the scheduler skips it while the wire transfer
        runs. Returns ``(seq, chain_hashes)``, the hashes of the folded
        prompt's full pages (the chain ``export_kv_blocks`` can serve in
        this same engine-loop cycle), or None when no live sequence carries
        ``request_id`` or it is already importing. The caller must later
        finish the sequence (``finish_migrated``) or clear ``importing``
        (``cancel_migration``). Engine thread only."""
        seq = None
        for cand in (
            list(self.scheduler.waiting)
            + self.scheduler.prefilling
            + self.scheduler.running
        ):
            if cand.request_id == request_id:
                seq = cand
                break
        if seq is None or seq.importing or self._should_finish(seq):
            return None
        if self._inflight is not None and any(
            s is seq for s in self._inflight["active"]
        ):
            self._drain_inflight()
        if seq in self.scheduler.waiting:
            self.scheduler.waiting.remove(seq)
        else:
            self.scheduler.on_preempted(seq)  # removes from running/prefilling
        self.block_manager.free_sequence(seq)
        seq.fold_for_preemption()
        seq.importing = True
        self.scheduler.waiting.append(seq)
        # Ship the release events now: the index must not advertise this
        # pod as the only holder of pages a scale-down is about to move.
        self.block_manager.flush_events()
        self.lifecycle_stats["migration_frozen"] = (
            self.lifecycle_stats.get("migration_frozen", 0) + 1
        )
        return seq, self.block_manager.token_db.prefix_hashes(seq.prompt_tokens)

    def finish_migrated(self, seq: Sequence) -> None:
        """Commit a migration: the target resumed ``seq``, so finish the
        local half with ``finish_reason="migrated"`` (its pages were
        released at the freeze; the parked waiting entry is withdrawn).
        Engine thread only."""
        seq.importing = False
        if seq in self.scheduler.waiting:
            self.scheduler.waiting.remove(seq)
        seq.status = SequenceStatus.FINISHED
        seq.finish_reason = "migrated"
        seq.finish_time = time.monotonic()
        self.lifecycle_stats["migrated_out"] = (
            self.lifecycle_stats.get("migrated_out", 0) + 1
        )
        self.finished.append(seq)

    def cancel_migration(self, seq: Sequence) -> None:
        """Roll back a freeze (wire failure or target refusal): clear
        ``importing`` so the scheduler re-admits the folded sequence, a
        warm re-prefill over whatever registered pages survived, exactly
        the preemption outcome. Engine thread only."""
        seq.importing = False
        self.lifecycle_stats["migration_fallback"] = (
            self.lifecycle_stats.get("migration_fallback", 0) + 1
        )

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
        rec = self.step_record
        t_step = rec.begin() if rec else 0
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
        if self.scheduler.qos_enabled:
            # TENANT_QOS: when the highest class's waiting prefill cannot
            # allocate, free pages by preempting one lower-class sequence.
            self._preempt_for_priority()
        if self.config.host_prefetch and self.config.block_manager.host_pages:
            # Ahead of the scheduler: waiting sequences' host-cached
            # prefixes start their copies now, so this step's flush only
            # waits for what has not landed.
            self._prefetch_host_pages()
        out = self.scheduler.schedule()
        if rec:
            rec.host("engine.schedule", t_step)
        if out.prefill:
            # Prefill must see committed decode state (page accounting,
            # finish detection): it never overlaps an in-flight burst.
            self._drain_inflight(timed=True)
            self._run_prefill(out.prefill, out.chunks)
        if out.decode:
            # Mixed step: the lanes were snapshotted at schedule time — a
            # final chunk published above joins next step, and lanes its
            # page growth preempted are dropped by the decode path's
            # block_table/finish filters.
            self._run_decode(out.decode)
        elif not out.prefill:
            self._drain_inflight(timed=True)

        t_publish = rec.now() if rec else 0
        newly_finished = list(shed)
        for seq in list(self.scheduler.running):
            if self._should_finish(seq):
                seq.finish_time = time.monotonic()
                self.scheduler.on_finished(seq)
                self.finished.append(seq)
                newly_finished.append(seq)

        self.block_manager.flush_events()
        if rec:
            rec.host("engine.publish", t_publish)
            rec.end(t_step)
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
        rec = self.step_record
        t0 = rec.now() if rec else 0
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
        if rec:
            t0 = rec.host("engine.prefill.prepare", t0)
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
            attn_impl=self.prefill_attn,
            mesh=self.mesh,
        )[0]
        if rec:
            t0 = rec.host("engine.prefill.launch", t0)
        first_tokens = self._sample(logits, seqs)  # syncs the dispatch
        # Prefill-rate sample of the cost model: chunk tokens over the
        # dispatch's time (from after the flush's restores on the card).
        span.end(self._compute_stream()).wait()
        n_valid = int(valid.sum())
        self._prefill_rate = self._ema(self._prefill_rate, n_valid / max(span.seconds(), 1e-6))
        self.prefill_stats["tokens_computed"] += n_valid
        self.prefill_stats["dispatches"] += 1
        if rec:
            t0 = rec.host("engine.prefill.sample", t0)
            rec.count("prefill_rows", b)
            rec.count("prefill_chunk", chunk)
            rec.count("prefill_valid_tokens", n_valid)
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
                if rec and seq.commit_times is not None:
                    seq.commit_times.append((t0, 1))
                self._append_slot_or_preempt(seq)
            self.block_manager.register_full_pages(seq)
        if rec:
            rec.host("engine.prefill.commit", t0)

    def _decode_table_width(self, seqs: list[Sequence]) -> int:
        """Block-table width for this decode call: longest active context in
        pages, rounded up to ``decode_pages_bucket``."""
        used = max((len(s.block_table) for s in seqs), default=1)
        bucket = max(1, self.config.decode_pages_bucket)
        return min(self.max_pages_per_seq, _round_up(used, bucket))

    def _run_decode(self, seqs: list[Sequence]) -> None:
        if self.config.spec_decode == "prompt_lookup":
            # Commit lag: the drain can finish lanes, and a finished
            # sequence is never reserved for or dispatched. Lanes a mixed
            # step's prefill half preempted (empty block table) are dropped
            # too: their proposals must not defeat the fallback below.
            self._drain_inflight()
            seqs = [s for s in seqs if s.block_table and not self._should_finish(s)]
            if not seqs:
                return
            if self._run_decode_spec(seqs):
                return
            # Every lane's proposal came up empty: a verify round would emit
            # one token at a prefill's cost, so take the plain decode step.
        self._run_decode_fused(seqs)

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
        rec = self.step_record
        t0 = rec.now() if rec else 0

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
            "entry": rec.current if rec else None,
        }
        if rec:
            rec.host("engine.decode.launch", t0)
            rec.count("decode_steps", k)
        if prev is not None:
            # Commit burst N while burst N+1 executes on the device.
            self._inflight = None
            self._commit_burst(prev)
        if self._pipeline:
            self._inflight = burst
        else:
            self._commit_burst(burst)

    def _propose_prompt_lookup(self, seq: Sequence) -> list[int]:
        """Draft-model-free proposals: the tokens that followed the latest
        earlier occurrence of the context's final ``spec_ngram`` tokens,
        within ``spec_max_scan`` of the end. Host-side; the device burst
        recomputes the same proposal for its first round."""
        n = self.config.spec_ngram
        # Drafts past budget - 1 can never be emitted (a round emits
        # accepted + 1); the device burst clamps with the same budget, so
        # its first round proposes exactly this many.
        k = min(self.config.spec_k, self._spec_budget(seq) - 1)
        if k < 1:
            return []
        toks = seq.all_tokens
        if len(toks) < n + 1:
            return []
        if not self._gate_open(seq):
            return []  # adaptive gate: this sequence is not echoing
        pattern = toks[-n:]
        lo = max(0, len(toks) - 1 - self.config.spec_max_scan)
        # The latest match wins; the terminal occurrence (start == len - n)
        # is excluded.
        for start in range(len(toks) - n - 1, lo - 1, -1):
            if toks[start : start + n] == pattern:
                return [int(t) for t in toks[start + n : start + n + k]]
        return []

    def _gate_open(self, seq: Sequence) -> bool:
        """Adaptive spec gate (one-way, per sequence): closed once the
        sample fills with acceptance below the threshold."""
        return not (
            seq.spec_proposed >= self.config.spec_min_sample
            and seq.spec_accepted < self.config.spec_min_accept * seq.spec_proposed
        )

    def _spec_budget(self, seq: Sequence) -> int:
        """Remaining emittable tokens (the max_new_tokens and max_model_len
        caps): the one definition the host proposal's clamp and the device
        burst's budget share."""
        return max(
            0,
            min(
                seq.sampling.max_new_tokens - seq.num_generated,
                self.config.max_model_len - seq.num_tokens,
            ),
        )

    def _run_decode_spec(self, seqs: list[Sequence]) -> bool:
        """Speculative decode by prompt lookup, chained on the device: each
        verify round scores the last committed token plus up to ``spec_k``
        proposed tokens, a warm prefill over [paged context ++ chunk] with
        every position's logits, and ``spec_rounds`` rounds run in one
        dispatch (``llama.spec_decode_steps``), so the host syncs once a
        burst. Greedy lanes take the longest proposal prefix equal to the
        model's argmax plus the argmax at the first mismatch (or a bonus
        token); sampled lanes run ``ops.spec_sample``. A round emits 1..k+1
        tokens per lane. Returns False, having dispatched nothing, when
        every lane's first-round proposal is empty; the caller then runs
        the cheaper plain decode step.

        The rounds run eagerly (no CUDA graph): on the card every verify
        round launches the flash-prefill kernel once a layer. Greedy tokens
        are the model's choices as the prefill path scores them; on the CPU
        that equals plain greedy decode, while on the card the verify
        (flash prefill) and decode (paged decode) kernels reduce in
        different orders, so a near tie can resolve differently, as the JAX
        engine says of the TPU. Sampled lanes draw from the engine's
        generator differently from plain decode (the same distribution).

        Rejected drafts leave stale K/V in slots the sequence owns beyond
        ``num_computed``; nothing attends past ``seq_len`` and page
        registration is bounded by ``num_computed``, so rollback is
        bookkeeping."""
        rec = self.step_record
        t0 = rec.now() if rec else 0
        ps = self.page_size
        k = self.config.spec_k
        rounds = self.config.spec_rounds
        # Lane-aligned verify chunk (no sequence parallelism here).
        # Lane-aligned, and a multiple of sp so the chunk splits evenly.
        s_chunk = _round_up(k + 1, math.lcm(8, self.config.sp))
        b = self.config.decode_batch_size
        if len(seqs) > b:
            raise RuntimeError(f"{len(seqs)} running sequences exceed {b} decode lanes")

        # The device recomputes the first round's proposals; this host pass
        # decides entry (an all-empty round costs nothing) and sizes the
        # exact single-round reservation.
        prop_by_id = {s.seq_id: self._propose_prompt_lookup(s) for s in seqs}
        if not any(prop_by_id.values()):
            return False

        if rounds > 1:
            # Multi-round bursts reserve the budget-capped worst case (later
            # rounds' proposals are decided on the device). When that does
            # not fit the free pool, this burst degrades to one round, whose
            # reservation is exact, so speculation never evicts a batchmate
            # for headroom it may not use.
            need = 0
            for seq in seqs:
                worst = 1 + min(rounds * (k + 1), self._spec_budget(seq))
                need += max(0, -(-(seq.num_tokens + worst - 1) // ps) - len(seq.block_table))
            if need > self.block_manager.num_free:
                rounds = 1

        # Reserve before building tables (this can preempt batchmates or
        # abort; both leave block_table empty). One round reserves the
        # exact growth (the committed token plus its clamped proposals: the
        # chunk's padding writes no new slot); more rounds the worst case.
        for seq in seqs:
            if not seq.block_table:
                continue
            if rounds == 1:
                n_res = 1 + len(prop_by_id[seq.seq_id])
            else:
                n_res = 1 + min(rounds * (k + 1), self._spec_budget(seq))
            self._reserve_slots_or_preempt(seq, n_res)
        active = [s for s in seqs if s.block_table]
        if not active:
            return True

        # Device-resident token window: the last `scan_need` committed
        # tokens (all prompt lookup may match) plus room for the burst's
        # growth. The int32 inputs go up as one packed array, the sampling
        # floats as another.
        scan_need = min(
            self.config.spec_max_scan + self.config.spec_ngram + 1, self.config.max_model_len
        )
        W = scan_need + rounds * (k + 1)
        table_w = self._decode_table_width(active)
        packed_i32 = np.zeros((b, W + table_w + 5), np.int32)
        fparams = np.zeros((b, 2), np.float32)
        fparams[:, 1] = 1.0  # top_p disabled on padded lanes
        for i, seq in enumerate(active):
            toks = seq.all_tokens
            n_win = min(len(toks), scan_need)
            packed_i32[i, :n_win] = toks[-n_win:]
            packed_i32[i, W : W + len(seq.block_table)] = seq.block_table
            packed_i32[i, W + table_w] = n_win  # wlen
            packed_i32[i, W + table_w + 1] = seq.num_tokens
            packed_i32[i, W + table_w + 2] = self._spec_budget(seq)
            packed_i32[i, W + table_w + 3] = int(self._gate_open(seq))
            packed_i32[i, W + table_w + 4] = seq.sampling.top_k
            fparams[i, 0] = seq.sampling.temperature
            fparams[i, 1] = seq.sampling.top_p

        self._flush_page_moves()
        packed = llama.spec_decode_steps(
            self.params,
            self.model_cfg,
            self._to_device(packed_i32),
            self._to_device(fparams),
            self.k_pages,
            self.v_pages,
            self._generator,
            page_size=ps,
            num_rounds=rounds,
            s_chunk=s_chunk,
            ngram=self.config.spec_ngram,
            spec_k=k,
            max_scan=self.config.spec_max_scan,
            table_w=table_w,
            # All-greedy bursts draw nothing from the generator, so sampled
            # streams elsewhere in the run do not shift because a greedy
            # lane speculated.
            sampled=bool((fparams[:, 0] > 0).any()),
            attn_impl=self.prefill_attn,
            mesh=self.mesh,
        )[0]
        if rec:
            t0 = rec.host("engine.decode.launch", t0)
            rec.count("decode_steps", rounds)
        # The one host sync of the burst: one fetch of the packed result.
        packed = packed.cpu().numpy()  # [rounds, b, k + 4]
        if rec:
            t0 = rec.host("engine.decode.wait", t0)
        emit = packed[..., : k + 1]
        emit_len = packed[..., k + 1]
        prop_len = packed[..., k + 2]
        acc = packed[..., k + 3]

        self.spec_stats["verify_steps"] += rounds
        self.spec_stats["bursts"] += 1
        for i, seq in enumerate(active):
            if not seq.block_table:
                continue  # preempted by a batchmate's post-emit append
            n = seq.num_generated
            for r in range(rounds):
                if self._should_finish(seq):
                    break  # later rounds are surplus (discarded)
                # Stats and the gate count only rounds whose tokens are (at
                # least partly) committed.
                pl, ac = int(prop_len[r, i]), int(acc[r, i])
                self.spec_stats["proposed"] += pl
                self.spec_stats["accepted"] += ac
                seq.spec_proposed += pl
                seq.spec_accepted += ac
                for j in range(int(emit_len[r, i])):
                    if self._should_finish(seq):
                        break
                    seq.num_computed = seq.num_tokens
                    seq.output_tokens.append(int(emit[r, i, j]))
                    seq.num_generated += 1
            if rec and seq.commit_times is not None and seq.num_generated > n:
                seq.commit_times.append((t0, seq.num_generated - n))
            # The reservation covered the burst's writes exactly; a full
            # acceptance in the last committed round moves num_tokens past
            # them, so the next dispatch's input slot is ensured here, as
            # every other decode path does after it emits.
            if not self._should_finish(seq):
                self._append_slot_or_preempt(seq)
            self.block_manager.register_full_pages(seq)
        if rec:
            rec.host("engine.decode.commit", t0)
        return True

    def _drain_inflight(self, timed: bool = False) -> None:
        """Commit the in-flight burst, if any; ``timed``: as the step's
        ``engine.drain`` span."""
        if self._inflight is None:
            return
        rec = self.step_record if timed else None
        t0 = rec.now() if rec else 0
        burst, self._inflight = self._inflight, None
        self._commit_burst(burst)
        if rec:
            rec.host("engine.drain", t0)
            rec.refresh(ANCHOR_AGE_NS)

    def _commit_burst(self, burst: dict) -> None:
        # [lanes, k] from pinned host memory: waits on this burst's copy
        # event, the one host sync of a burst.
        rec = self.step_record
        t0 = rec.now() if rec else 0
        out = burst["toks"]
        toks = out.tokens()
        if rec:
            # The blocking share of the sampled-id fetch: near zero when a
            # pipelined burst's copy already landed.
            t0 = rec.host("engine.decode.wait", t0)
            entry = burst["entry"]
            if out.start is not None:
                rec.device(entry, "device.decode", out.start, out.stop)
            groups = out.expert_groups()
            if groups is not None and entry is not None:
                entry.counters.setdefault("k4_touched", []).extend(groups)
        for i, seq in enumerate(burst["active"]):
            if not seq.block_table:
                continue  # preempted after this burst was dispatched
            n = seq.num_generated
            for j in range(burst["k"]):
                # Pre-check keeps num_generated <= max_new_tokens even when
                # a reservation abort clamped the cap before the burst ran.
                if self._should_finish(seq):
                    break
                seq.num_computed = seq.num_tokens
                seq.output_tokens.append(int(toks[i, j]))
                seq.num_generated += 1
            if rec and seq.commit_times is not None and seq.num_generated > n:
                seq.commit_times.append((t0, seq.num_generated - n))
            self.block_manager.register_full_pages(seq)
        if rec:
            rec.host("engine.decode.commit", t0)

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
        if self.scheduler.qos_enabled:
            # TENANT_QOS: prefer victims of a strictly lower class than
            # ``seq``, falling back to every candidate so growth never wedges.
            lower = [c for c in candidates if c.priority > seq.priority]
            if lower:
                candidates = lower
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
                victim.num_preemptions += 1
                self.scheduler.waiting.appendleft(victim)

    def _preempt_for_priority(self) -> None:
        """TENANT_QOS priority preemption: when the highest-class waiting
        sequence cannot allocate its prefill pages, preempt one strictly
        lower-class sequence (the worst class, most recently admitted
        first): its pages are freed and it re-queues waiting, never
        errored. One victim a step. A pipelined burst in flight that holds
        the victim is committed first, so no page it still reads on the
        device is freed under it."""
        sch = self.scheduler
        sch.qos_reorder_waiting()
        head = next((s for s in sch.waiting if not s.importing), None)
        if head is None or self.block_manager.can_allocate(head):
            return
        candidates = [
            cand
            for cand in list(reversed(sch.running)) + list(reversed(sch.prefilling))
            if cand.priority > head.priority and not self._should_finish(cand)
        ]
        if not candidates:
            return
        victim = max(candidates, key=lambda c: c.priority)
        if self._inflight is not None and any(s is victim for s in self._inflight["active"]):
            self._drain_inflight()
            if self._should_finish(victim):
                return  # the commit finished it: it leaves this step
        log.warning(
            "priority preemption",
            victim=victim.seq_id,
            victim_tenant=victim.tenant,
            for_seq=head.seq_id,
            for_tenant=head.tenant,
        )
        sch.on_preempted(victim)
        self.block_manager.free_sequence(victim)
        victim.fold_for_preemption()
        victim.num_preemptions += 1
        sch.waiting.append(victim)  # the next reorder places it by class
        # The key appears only once a preemption happened (TENANT_QOS on),
        # so the knobs-off /stats payload is unchanged.
        self.lifecycle_stats["priority_preempted"] = (
            self.lifecycle_stats.get("priority_preempted", 0) + 1
        )

    def _sample(self, logits: torch.Tensor, seqs: list[Sequence]) -> np.ndarray:
        b = logits.shape[0]
        temperature = np.zeros((b,), np.float32)
        top_k = np.zeros((b,), np.int32)
        top_p = np.ones((b,), np.float32)
        for i, seq in enumerate(seqs[:b]):
            temperature[i] = seq.sampling.temperature
            top_k[i] = seq.sampling.top_k
            top_p[i] = seq.sampling.top_p
        return sample_tokens(
            logits.float(),
            self._to_device(temperature),
            self._to_device(top_k),
            self._to_device(top_p),
            self._generator,
        ).cpu().numpy()
