"""Qwen2 decoder in plain PyTorch and float32 (Hugging Face
``Qwen2ForCausalLM``), with no cache, kernel or batching: Qwen3's dense
layer (``perfbench/reference/qwen3.py``) without qk-norm, with a bias
added to each of the q, k and v projections."""

from __future__ import annotations

from typing import Callable

import torch

from perfbench.reference.qwen3 import HEAD_COLS, _attention, _Matmul, _rms, _rope, exact_float32


def forward(m, block: Callable[[int], dict], seqs: list[list[int]], want: list[list[int]], device,
            precision: str = "fp32") -> list[torch.Tensor]:
    """Logits [len(want[i]), vocab] (float32) at positions ``want[i]`` of
    each of ``seqs``, as ``reference/qwen3.py``'s ``forward``."""
    mm = _Matmul(precision)
    with exact_float32():
        glob = block(0)
        lens = [len(s) for s in seqs]
        tokens = torch.tensor([t for s in seqs for t in s], dtype=torch.long, device=device)
        x = glob["embed"][tokens].float()
        pos = torch.cat([torch.arange(n, device=device) for n in lens])
        for i in range(m.layers):
            w = block(i + 1)
            h = _rms(x, w["attn_norm"], m.eps)
            q = (mm(h, w["wq"]) + w["bq"].float()).view(-1, m.heads, m.hd)
            k = (mm(h, w["wk"]) + w["bk"].float()).view(-1, m.kv_heads, m.hd)
            v = (mm(h, w["wv"]) + w["bv"].float()).view(-1, m.kv_heads, m.hd)
            q, k = _rope(q, pos, m.theta), _rope(k, pos, m.theta)
            attn, a = torch.empty_like(q), 0
            for n in lens:
                attn[a : a + n] = _attention(q[a : a + n], k[a : a + n], v[a : a + n])
                a += n
            x = x + mm(attn.reshape(-1, m.heads * m.hd), w["wo"])
            h = _rms(x, w["mlp_norm"], m.eps)
            x = x + mm(torch.nn.functional.silu(mm(h, w["w_gate"])) * mm(h, w["w_up"]), w["w_down"])
        w_head = glob["embed"].T if m.tie else glob["lm_head"]
        out, a = [], 0
        for n, idx in zip(lens, want):
            h = _rms(x[a + torch.tensor(idx, device=device)], glob["final_norm"], m.eps)
            out.append(torch.cat([mm(h, w_head[:, c : c + HEAD_COLS])
                                  for c in range(0, w_head.shape[1], HEAD_COLS)], dim=1))
            a += n
        return out
