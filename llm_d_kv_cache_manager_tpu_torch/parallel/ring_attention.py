"""Ring attention: sequence-parallel causal attention for long-context
prefill, in plain PyTorch.

The port of the JAX package's ``parallel/ring_attention.py``. The sequence
is split over the mesh's ``sp`` rows; each shard keeps its query slice and
runs a blocked online-softmax (flash) pass over the key/value payload it
holds, then passes the payload on to the next shard's device (JAX's
``ppermute``: a move through the mesh's collective, a no-op when the
shards share a device). After ``sp`` steps every query has seen every key
with one exact accumulator, so the result equals single-device attention
up to float summation order. JAX runs no Pallas kernel here either.

Visibility rides on positions: a key is visible to a query when it is
valid and its position is at most the query's. The engine's sp prefill
(``models.llama._sp_prefill_attention``) rotates a longer payload than the
query slice, [context slice ++ chunk slice], with context keys at position
-1 (visible to every chunk query).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .mesh import Mesh

#: keys a flash block scores at once: the score tile stays [s_q, block]
#: however long the payload is
FLASH_KEY_BLOCK = 512

# Finite: a fully-masked block gives exp(-1e30 - -1e30) = 1, zeroed by the
# mask multiply.
_NEG_INF = -1e30


def _flash_over_keys(
    qf: torch.Tensor,  # [b, s, n_kv, group, d] f32
    k: torch.Tensor,  # [b, T, n_kv, d]
    v: torch.Tensor,  # [b, T, n_kv, d]
    k_valid: torch.Tensor,  # [b, T] bool
    k_pos: torch.Tensor,  # [b, T] (visibility: k_pos <= q_pos)
    q_pos: torch.Tensor,  # [b, s]
    scale: float,
    state: tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # (m, l, acc)
    block: int = FLASH_KEY_BLOCK,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Online softmax over a key sequence in key blocks, seeded with and
    returning the raw flash state ``(m [b, n_kv, g, s], l [b, n_kv, g, s],
    acc [b, n_kv, g, s, d])``, all float32."""
    m, denom, acc = state
    T = k.shape[1]
    qp = q_pos.long()[:, None, None, :, None]
    for t0 in range(0, T, block):
        kb = k[:, t0 : t0 + block].float()
        vb = v[:, t0 : t0 + block].float()
        mask = (k_valid[:, None, None, None, t0 : t0 + block]
                & (k_pos.long()[:, None, None, None, t0 : t0 + block] <= qp))
        scores = torch.einsum("bqhgd,bthd->bhgqt", qf, kb) * scale
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None]) * mask
        corr = torch.exp(m - m_new)
        denom = denom * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqt,bthd->bhgqd", p, vb)
        m = m_new
    return m, denom, acc


def ring_attention_shards(
    qs: Sequence[torch.Tensor],  # per shard [b, s_r, n_heads, d]
    ks: Sequence[torch.Tensor],  # per shard [b, t_r, n_kv_heads, d]
    vs: Sequence[torch.Tensor],
    *,
    q_pos: Sequence[torch.Tensor],  # per shard [b, s_r] absolute positions
    k_pos: Sequence[torch.Tensor],  # per shard [b, t_r] key positions
    k_valid: Optional[Sequence[torch.Tensor]] = None,  # per shard [b, t_r] bool
    mesh: Mesh,
    devices: Sequence[torch.device],
    scale: Optional[float] = None,
) -> list[torch.Tensor]:
    """The ring over ``len(qs)`` shards: shard ``r`` holds ``qs[r]`` and
    starts with payload ``r`` (``ks[r]``, ``vs[r]``, ``k_pos[r]``,
    ``k_valid[r]``) on ``devices[r]``; at each step it attends to what it
    holds and passes that to shard ``r + 1`` through ``mesh.collective``.
    Returns each shard's output ``[b, s_r, n_heads, d]`` in its query's
    dtype, on its device."""
    n = len(qs)
    move = mesh.collective.move
    b, _, n_q, d = qs[0].shape
    n_kv = ks[0].shape[2]
    group = n_q // n_kv
    if scale is None:
        scale = d**-0.5
    if k_valid is None:
        k_valid = [torch.ones(k.shape[:2], dtype=torch.bool, device=k.device) for k in ks]
    qfs, states = [], []
    for q, dev in zip(qs, devices):
        s = q.shape[1]
        qfs.append(q.float().reshape(b, s, n_kv, group, d))
        states.append((
            torch.full((b, n_kv, group, s), _NEG_INF, dtype=torch.float32, device=dev),
            torch.zeros((b, n_kv, group, s), dtype=torch.float32, device=dev),
            torch.zeros((b, n_kv, group, s, d), dtype=torch.float32, device=dev),
        ))
    held = list(zip(ks, vs, k_pos, k_valid))
    for step in range(n):
        for r in range(n):
            k, v, kp, kv = held[r]
            states[r] = _flash_over_keys(qfs[r], k, v, kv, kp, q_pos[r], scale, states[r])
        if step + 1 < n:
            # Each shard passes its payload to the next one on the ring.
            held = [tuple(move(x, devices[r]) for x in held[(r - 1) % n]) for r in range(n)]
    outs = []
    for q, (_, denom, acc) in zip(qs, states):
        out = acc / torch.where(denom > 0, denom, torch.ones_like(denom))[..., None]
        # [b, n_kv, g, s, d] -> [b, s, n_kv * g, d]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(q.shape).to(q.dtype))
    return outs


def ring_attention(
    q: torch.Tensor,  # [b, seq, n_heads, d], seq divisible by the sp size
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Sequence-parallel causal self-attention over ``mesh``'s ``sp`` rows
    (their first tp column): the sequence is split into contiguous slices,
    slice ``r`` onto row ``r``'s device, positions are the global indices,
    and the outputs are gathered back in order on the first device."""
    n = mesh.shape["sp"]
    b, seq = q.shape[:2]
    if seq % n != 0:
        raise ValueError(f"seq len {seq} not divisible by mesh axis 'sp' of size {n}")
    devices = [row[0] for row in mesh.grid]
    move = mesh.collective.move
    pos = torch.arange(seq, device=q.device).expand(b, seq)
    qs, ks, vs, ps = ([move(x, devices[r]) for r, x in enumerate(t.chunk(n, dim=1))]
                      for t in (q, k, v, pos))
    outs = ring_attention_shards(qs, ks, vs, q_pos=ps, k_pos=ps, mesh=mesh,
                                 devices=devices, scale=scale)
    return mesh.collective.cat(outs, dim=1)
