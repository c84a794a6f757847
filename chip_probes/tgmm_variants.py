"""Where K6's time goes, on the card: the kernel of
``csrc/grouped_matmul_tgmm.cu`` and variants of it made by editing a copy
of its source, each built with ``nvcc`` (the port's flags) into
``build/tgmm_variants/`` and timed at Qwen3-30B-A3B's two train forms
(16,384 rows routed top-8 over 128 experts, seed 0), L2 flushed before
each call, in turns (each variant twice, first to last then last to
first), beside a write-only yardstick (``Tensor.zero_`` of the same
[E, d, f] bf16 stack) and ``torch._grouped_mm``:

  base          the kernel as it is;
  store_only    every group treated as empty: no loads, no products, the
                stores of the zero tiles alone;
  no_store      loads, masking and products, the TMA stores left out;
  two_staging   2 ring stages and two staging tiles a warpgroup, so a
                tile's epilogue waits for the store of two tiles back;
  d_fastest     the tile walk with the d tiles fastest within a group;
  four_stages   4 ring stages, and the epilogue staged one 64 x 64 box at a
                time through two 8 KB buffers a warpgroup.

Variants that keep the function (two_staging, d_fastest, four_stages) must
give the base kernel's bits. Run from the repo root:

    python chip_probes/tgmm_variants.py
"""
import ctypes, json, os, subprocess, sys

sys.path.insert(0, os.getcwd())
import torch

import chip_smoke as cs
from llm_d_kv_cache_manager_tpu_torch import ops
from llm_d_kv_cache_manager_tpu_torch.ops import _build

SRC = _build.CSRC / "grouped_matmul_tgmm.cu"
OUT = _build.BUILD_DIR.parent / "tgmm_variants"
EDITS = {
    "base": [],
    "store_only": [("  t.r1 = (int)min(walk.start + max(__ldg(walk.sizes + t.g), 0), (long long)rows);",
                    "  t.r1 = t.r0;")],
    "no_store": [("tma_store_3d(&tm_out, staging + q * kBox, t.f0 + 64 * q, dr, t.g);", ";")],
    "two_staging": [
        ("constexpr int kStages = 3;", "constexpr int kStages = 2;"),
        ("constexpr int kBars = kOut + 2 * kOutBytes;", "constexpr int kBars = kOut + 4 * kOutBytes;"),
        ("unsigned char* staging = smem + kOut + wg * kOutBytes;",
         "unsigned char* const staging2 = smem + kOut + 2 * wg * kOutBytes;\n  int half = 0;"),
        ("    if (issuer) bulk_wait_read<0>();",
         "    unsigned char* staging = staging2 + half * kOutBytes;\n    half ^= 1;\n"
         "    if (issuer) bulk_wait_read<1>();"),
    ],
    "d_fastest": [("  t.d0 = rem / n_f * kTM;\n  t.f0 = rem % n_f * kTN;",
                   "  t.d0 = rem % n_d * kTM;\n  t.f0 = rem / n_d * kTN;")],
    "four_stages": [
        ("constexpr int kStages = 3;", "constexpr int kStages = 4;"),
        ("constexpr int kOutBytes = kTN / 64 * kBox;", "constexpr int kOutBytes = 2 * kBox;"),
        ("""    const bool issuer = tid % 128 == 0;
    if (issuer) bulk_wait_read<0>();
    named_barrier(2 + wg, 128);
    const int row = 16 * warp + gq;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      unsigned char* line = staging + (j >> 3) * kBox + row * 128 + (((j & 7) ^ gq) << 4) + tq * 4;
      *reinterpret_cast<unsigned*>(line) = pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<unsigned*>(line + 8 * 128) = pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    fence_proxy_async();
    named_barrier(2 + wg, 128);
    if (issuer) {
      const int dr = t.d0 + 64 * wg;
      if (dr < d)
        for (int q = 0; q < kTN / 64 && t.f0 + 64 * q < f; ++q)
          tma_store_3d(&tm_out, staging + q * kBox, t.f0 + 64 * q, dr, t.g);
      bulk_commit();
    }""", """    const bool issuer = tid % 128 == 0;
    const int row = 16 * warp + gq;
#pragma unroll
    for (int q = 0; q < kTN / 64; ++q) {
      unsigned char* buf = staging + (q & 1) * kBox;
      if (issuer) bulk_wait_read<1>();
      named_barrier(2 + wg, 128);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * q + jj;
        unsigned char* line = buf + row * 128 + ((jj ^ gq) << 4) + tq * 4;
        *reinterpret_cast<unsigned*>(line) = pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<unsigned*>(line + 8 * 128) = pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      fence_proxy_async();
      named_barrier(2 + wg, 128);
      if (issuer) {
        const int dr = t.d0 + 64 * wg;
        if (dr < d && t.f0 + 64 * q < f) tma_store_3d(&tm_out, buf, t.f0 + 64 * q, dr, t.g);
        bulk_commit();
      }
    }"""),
    ],
}
SAME_BITS = ("two_staging", "d_fastest", "four_stages")


def build() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    procs = {}
    for name, edits in EDITS.items():
        src = text
        for old, new in edits:
            assert src.count(old) == 1, (name, old)
            src = src.replace(old, new)
        path = OUT / f"{name}.cu"
        path.write_text(src)
        lib = OUT / f"{name}.so"
        procs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                                         "-o", str(lib), str(path)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                       path, lib)
    libs = {}
    for name, (proc, path, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"{name}: nvcc failed\n{log}")
        print(json.dumps({"variant": name, "ptxas": [ln.strip() for ln in log.splitlines()
                                                     if "registers" in ln or "spill" in ln]}), flush=True)
        fn = ctypes.CDLL(str(lib)).grouped_matmul_tgmm
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        libs[name] = fn
    return libs


def main() -> None:
    print(cs.card_line(), flush=True)
    libs = build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for width, (d, f) in cs.GMM_WIDTHS.items():
        sizes, rows = cs.gmm_bwd_group_sizes("train", gen, dev)
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        lhs = torch.randn((rows, d), generator=gen, device=dev).to(torch.bfloat16)
        dout = torch.randn((rows, f), generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty((cs.MOE_E, d, f), dtype=torch.bfloat16, device=dev)
        grid = ops.plan_grouped_matmul_tgmm(cs.MOE_E, d, f, sms)["grid"][0]

        def call(name):
            def run():
                err = libs[name](lhs.data_ptr(), dout.data_ptr(), gs.data_ptr(), out.data_ptr(),
                                 rows, d, f, cs.MOE_E, grid, torch.cuda.current_stream().cuda_stream)
                assert err == 0, (name, err)
            return run

        bits = {}
        for name in SAME_BITS + ("base",):
            call(name)()
            bits[name] = out.clone()
        same = {name: torch.equal(bits[name].view(torch.int16), bits["base"].view(torch.int16))
                for name in SAME_BITS}
        del bits
        ms = {name: [] for name in EDITS}
        order = list(EDITS)
        for name in order + order[::-1]:
            ms[name].append(cs.cold_time_ms(call(name)))
        library_ms, _ = cs.grouped_mm_library_ms(lhs.t(), dout, gs)
        n_bytes = rows * (d + f) * 2 + cs.MOE_E * d * f * 2
        print(json.dumps({"width": width, "d": d, "f": f, "ms": ms, "same_bits_as_base": same,
                          "zero_fill_ms": cs.cold_time_ms(out.zero_), "library_ms": library_ms,
                          "bound_ms": cs.bound_ms(n_bytes, 2 * rows * d * f)[0]}), flush=True)
        del lhs, dout, out
        cs.free_cuda()


if __name__ == "__main__":
    main()
