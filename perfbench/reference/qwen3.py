"""Qwen3 / Qwen3-MoE decoder in plain PyTorch and float32, from the
published architecture (Hugging Face ``Qwen3ForCausalLM`` /
``Qwen3MoeForCausalLM``), with no cache, kernel or batching.

Per layer: RMSNorm; q, k, v projections; RMSNorm of each head of q and k
(qk-norm); rotary embedding over the two halves of the head (theta
``rope_theta``); causal attention with grouped KV heads, scale
head_dim^-1/2; output projection and residual; RMSNorm; the FFN and
residual. The FFN is SwiGLU, silu(x Wg) * (x Wu) Wd, either dense or, for
the MoE, over the top ``num_experts_per_tok`` experts of a softmax router
with the kept probabilities renormalised (``norm_topk_prob``). Final
RMSNorm and an untied head.

The forward runs layer by layer over every sequence at once, drawing each
layer's weights when it gets to it (``block(i)``), so the whole model
never has to be resident in float32. Attention runs in blocks of queries.
``precision="fp8"`` is the control: every matrix product's operands are
rounded to float8 e4m3 (per-row scales for activations, per-column for
weights) before a float32 product.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from perfbench.model import Dims

Q_BLOCK = 1024
ROWS = 8192
#: vocabulary columns of the head taken at once (a float32 copy of the
#: whole head is 1.2 GB)
HEAD_COLS = 16384


@contextlib.contextmanager
def exact_float32():
    """Float32 products in float32: TF32 off for the duration."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


class _Matmul:
    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        if self.fp8:
            return _fp8(x, -1) @ _fp8(w, 0)
        return x @ w


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.float()


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd))
    ang = pos[:, None].double() * inv[None, :]
    cos, sin = ang.cos().float()[:, None, :], ang.sin().float()[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention of one sequence: q [S, H, hd], k/v [S, KV, hd]."""
    s, h, hd = q.shape
    group = h // k.shape[1]
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)  # [H, S, hd]
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for a in range(0, s, Q_BLOCK):
        b = min(a + Q_BLOCK, s)
        scores = torch.einsum("qhd,hkd->hqk", q[a:b], k[:, :b]) * hd**-0.5
        mask = torch.arange(b, device=q.device)[None, :] > torch.arange(a, b, device=q.device)[:, None]
        scores.masked_fill_(mask[None], float("-inf"))
        out[a:b] = torch.einsum("hqk,hkd->qhd", scores.softmax(dim=-1), v[:, :b])
    return out


def _ffn(m: Dims, w: dict, x: torch.Tensor, mm: _Matmul) -> torch.Tensor:
    out = torch.empty_like(x)
    for a in range(0, x.shape[0], ROWS):
        h = x[a : a + ROWS]
        if not m.experts:
            out[a : a + ROWS] = mm(torch.nn.functional.silu(mm(h, w["w_gate"])) * mm(h, w["w_up"]),
                                   w["w_down"])
            continue
        probs = mm(h, w["router"]).softmax(dim=-1)
        topv, topi = probs.topk(m.top_k, dim=-1)
        if m.norm_topk:
            topv = topv / topv.sum(dim=-1, keepdim=True)
        y = torch.zeros_like(h)
        for e in torch.unique(topi).tolist():
            rows, slot = (topi == e).nonzero(as_tuple=True)
            he = h[rows]
            act = torch.nn.functional.silu(mm(he, w["w_gate"][e])) * mm(he, w["w_up"][e])
            y.index_add_(0, rows, mm(act, w["w_down"][e]) * topv[rows, slot][:, None])
        out[a : a + ROWS] = y
    return out


def forward(m: Dims, block: Callable[[int], dict], seqs: list[list[int]],
            want: list[list[int]], device, precision: str = "fp32") -> list[torch.Tensor]:
    """Logits [len(want[i]), vocab] (float32) at positions ``want[i]`` of
    each token sequence ``seqs[i]``. ``block(0)`` gives the embedding, head
    and final norm; ``block(i + 1)`` layer i (the port's layout: [in, out]
    matrices, [E, in, out] experts)."""
    mm = _Matmul(precision)
    with exact_float32():
        glob = block(0)
        lens = [len(s) for s in seqs]
        tokens = torch.tensor([t for s in seqs for t in s], dtype=torch.long, device=device)
        x = glob["embed"][tokens].float()
        head, final_norm = glob.get("lm_head"), glob["final_norm"]
        embed = glob["embed"] if m.tie else None
        del glob
        pos = torch.cat([torch.arange(n, device=device) for n in lens])
        for i in range(m.layers):
            w = block(i + 1)
            h = _rms(x, w["attn_norm"], m.eps)
            q = mm(h, w["wq"]).view(-1, m.heads, m.hd)
            k = mm(h, w["wk"]).view(-1, m.kv_heads, m.hd)
            v = mm(h, w["wv"]).view(-1, m.kv_heads, m.hd)
            if m.qk_norm:
                q = _rms(q, w["q_norm"], m.eps)
                k = _rms(k, w["k_norm"], m.eps)
            q, k = _rope(q, pos, m.theta), _rope(k, pos, m.theta)
            attn = torch.empty_like(q)
            a = 0
            for n in lens:
                attn[a : a + n] = _attention(q[a : a + n], k[a : a + n], v[a : a + n])
                a += n
            x = x + mm(attn.reshape(-1, m.heads * m.hd), w["wo"])
            del q, k, v, attn, h
            x = x + _ffn(m, w, _rms(x, w["mlp_norm"], m.eps), mm)
            del w
        out, a = [], 0
        w_head = embed.T if m.tie else head
        for n, idx in zip(lens, want):
            h = _rms(x[a + torch.tensor(idx, device=device)], final_norm, m.eps)
            out.append(torch.cat([mm(h, w_head[:, c : c + HEAD_COLS])
                                  for c in range(0, w_head.shape[1], HEAD_COLS)], dim=1))
            a += n
        return out
