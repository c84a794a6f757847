"""Cross-pod KV transfer on the card, cut in depth: a short first card call
for new transfer code. Run from the repo root:

    DEPTH=4 python chip_probes/kv_transfer_probe.py

On a machine with a card it prints the toolchain and the card, builds the
kernels, then, for each KV page mode, imports the same chain of blocks
(full-width and int8 wires) into a CUDA engine and a CPU engine holding the
same TINY_LLAMA pages, tangled with offloads and restores in two flush
windows, and requires pools and slots bit-equal and both engines' exports
equal as wire bytes; then runs ``chip_smoke.kv_transfer`` on Llama-3.1-8B
at ``DEPTH`` layers and full width (every gate of the phase applies).

Without a card it rehearses the phase on the CPU at TINY_LLAMA, with the
CUDA calls the phase makes stubbed, and prints each gate that fails
instead of exiting (the launch-count gates fail there: a wrapper counts
only launches on the card)."""
import dataclasses, json, os, sys, time, traceback
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
print(json.dumps({"python": sys.version, "torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)
import chip_smoke as cs
from llm_d_kv_cache_manager_tpu_torch import models, ops, server
from llm_d_kv_cache_manager_tpu_torch.kvcache import kvblock
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.token_processor import hash_block
from llm_d_kv_cache_manager_tpu_torch.kvcache.transfer import protocol
from llm_d_kv_cache_manager_tpu_torch.models import llama, quant
from llm_d_kv_cache_manager_tpu_torch.ops import _build
from llm_d_kv_cache_manager_tpu_torch.server import decode_graphs, serve

pkg = {"models": models, "llama": llama, "server": server, "serve": serve, "kvblock": kvblock,
       "decode_graphs": decode_graphs}
depth = int(os.environ.get("DEPTH", "4"))


def chain(n, init, seed, shape, wire):
    rng = np.random.default_rng(seed)
    out, parent = [], None
    for _ in range(n):
        tokens = [int(t) for t in rng.integers(0, 1000, 4)]
        h = hash_block(parent if parent is not None else init, tokens)
        k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(2))
        extra = {}
        if wire == "int8":
            (k, ks), (v, vs) = quant.quantize_kv_page(k), quant.quantize_kv_page(v)
            extra = {"quant": "int8", "k_scale": ks.numpy().tobytes(), "v_scale": vs.numpy().tobytes()}
        out.append(protocol.BlockPayload(block_hash=h, parent_block_hash=parent, token_ids=tokens,
                                         block_size=4, dtype="float32", shape=shape,
                                         k_data=k.numpy().tobytes(), v_data=v.numpy().tobytes(), **extra))
        parent = h
    return out


def movers(knobs, wire, dev):
    engines = []
    for device in ("cpu", dev):
        cfg = server.EngineConfig(model=llama.TINY_LLAMA, host_tier_policy="always",
                                  block_manager=server.BlockManagerConfig(total_pages=8, page_size=4, host_pages=4),
                                  max_model_len=64, decode_batch_size=4, **knobs)
        engines.append(server.Engine(cfg, device=device))
    rng = np.random.default_rng(7)
    for c, g in zip(engines[0]._device_pools() + engines[0]._host_pools(),
                    engines[1]._device_pools() + engines[1]._host_pools()):
        a = (rng.integers(-127, 128, c.shape).astype(np.int8) if c.dtype == torch.int8
             else (np.abs(rng.standard_normal(c.shape)) * 0.5).astype(np.float32))
        c.copy_(torch.from_numpy(a))
        g.copy_(torch.from_numpy(a))
    cfg = llama.TINY_LLAMA
    shape = (cfg.n_layers, 4, cfg.n_kv_heads, cfg.hd)
    blocks = chain(3, engines[0].block_manager.token_db.init_hash, 21, shape, wire)
    exports = []
    for eng in engines:
        bm = eng.block_manager
        eng._restore_page(2, bm._free[-1])
        assert eng.import_kv_blocks(blocks[:2]) == 2
        b = bm._cached[blocks[1].block_hash]
        eng._offload_page(b, 0)
        eng._offload_page(5, 1)
        eng._restore_page(1, 6)
        eng._flush_page_moves()
        assert eng.import_kv_blocks(blocks[2:]) == 1
        c = bm._cached[blocks[2].block_hash]
        eng._restore_page(3, c)
        eng._offload_page(c, 2)
        eng._flush_page_moves()
        exports.append(protocol.encode_response(eng.export_kv_blocks([x.block_hash for x in blocks]), True))
    engines[1]._wait_host_copies()
    torch.cuda.synchronize()
    pairs = zip(engines[0]._device_pools() + engines[0]._host_pools(),
                engines[1]._device_pools() + engines[1]._host_pools())
    unequal = [i for i, (c, g) in enumerate(pairs) if not torch.equal(c, g.cpu())]
    return (not unequal and exports[0] == exports[1],
            {"unequal_pools_then_slots": unequal, "exports_equal": exports[0] == exports[1],
             **engines[1].transfer_copy_stats})


def quantizer_on_card(dev):
    """quantize_kv_page on the card against the CPU on random pages, and the
    old form (a Python-scalar divisor, which CUDA turns into a product with
    its reciprocal) beside it."""
    x = torch.randn((256, 4, 16, 8, 128), generator=torch.Generator().manual_seed(3))
    q, s = quant.quantize_kv_page(x)
    gq, gs = quant.quantize_kv_page(x.to(dev))
    amax = x.to(dev).abs().amax(dim=(-3, -1), keepdim=True)
    old = torch.clamp(amax, min=1e-8) / 127.0
    return {"codes_equal": torch.equal(q, gq.cpu()), "scales_equal": torch.equal(s, gs.cpu()),
            "scalar_divisor_scales_unequal": int((old.cpu() != s).sum()), "scales": s.numel()}


if torch.cuda.is_available():
    card = cs.card_line(); print(card, flush=True)
    t = time.perf_counter(); print("build", _build.build(), time.perf_counter() - t, flush=True)
    dev = torch.device("cuda", 0)
    print("quantizer", quantizer_on_card(dev), flush=True)
    for name, knobs in (("fp", {}), ("int8", {"kv_quant": "int8"}), ("hbm_int8", {"kv_quant_hbm": "int8"})):
        for wire in ("fp", "int8"):
            try:
                ok, stats = movers(knobs, wire, dev)
                print("movers", name, wire, "bit-equal to the CPU engine" if ok else "DIFFER", stats, flush=True)
            except Exception:
                traceback.print_exc()
    cfg = dataclasses.replace(llama.LLAMA_3_8B, n_layers=depth)
else:
    print("no card: rehearsing the kv_transfer phase on the CPU at TINY_LLAMA", flush=True)
    card, dev = "cpu rehearsal", torch.device("cpu")
    for name in ("synchronize", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    cs.pinned_copy_gb_s = lambda n_bytes, to_host: None
    cs.fail = lambda msg: print("GATE:", msg, flush=True)
    cfg = llama.TINY_LLAMA
params = models.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
t = time.perf_counter()
try:
    result, launches = cs.kv_transfer(pkg, ops, dev, card, params, cfg)
    cs.emit(result)
except SystemExit:
    print("kv_transfer failed", flush=True)
print("kv_transfer seconds", time.perf_counter() - t, flush=True)
