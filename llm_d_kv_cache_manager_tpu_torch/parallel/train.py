"""Training step on one device: forward, next-token loss, backward and
AdamW — the port of the JAX package's ``parallel/train.py``.

The forward is the serving model's own layer code (``_embed``, ``_qkv``,
``apply_rope``, ``_mlp``, ``_logits``) over a whole sequence with no KV
cache, attention through ``ops.causal_prefill_attention``. A routed MoE
layer's expert products go through ``ops.GroupedMatmul``, so the backward
launches K4^T and K6 on the card (the kernels megablox's ``custom_vjp``
launches on a TPU). JAX donates the state to a jitted step and gets a new
one back; here parameters and moments are updated in place and the same
state object comes back with its step advanced. Expert parallelism and a
mesh (``mesh=``) are not ported (ROADMAP A15c).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from ..models import llama
from ..models.llama import LlamaConfig, Params
from ..models.quant import QuantizedTensor
from ..ops import apply_rope, causal_prefill_attention, rms_norm


class TrainState(NamedTuple):
    params: Params
    optimizer: torch.optim.AdamW
    step: int


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("training over a mesh is not ported (ROADMAP A15c)")


def param_leaves(params: Params) -> list:
    """Every leaf of a parameter tree in a fixed order (the dict's insertion
    order, layers in turn): the optimizer's parameter order, which its
    state dict and ``models.convert.train_state_from_jax`` index by."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in param_leaves(v)]
    if isinstance(params, list):
        return [t for v in params for t in param_leaves(v)]
    return [params]


def _forward_logits(params: Params, cfg: LlamaConfig, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """Full-sequence forward for training (no KV cache): [b, s, vocab]
    float32 logits."""
    _no_mesh(mesh)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    inv_freq = llama._inv_freq(cfg, tokens.device)
    sharded = llama._placed(params, None, tokens.device)  # one shard
    h = llama._embed(sharded, cfg, tokens)
    for layer in params["layers"]:
        x = rms_norm(h, layer["attn_norm"], cfg.rms_norm_eps, cfg.norm_offset)
        q, k, v = llama._qkv(layer, cfg, x)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
        attn = causal_prefill_attention(q, k, v)
        h = h + attn.reshape(b, s, -1) @ llama._w(layer["wo"], h.dtype)
        x = rms_norm(h, layer["mlp_norm"], cfg.rms_norm_eps, cfg.norm_offset)
        h = h + llama._mlp(layer, cfg, x)
    return llama._logits(sharded, cfg, h)


def loss_fn(params: Params, cfg: LlamaConfig, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """Next-token cross-entropy over the sequence (mean, float32)."""
    logits = _forward_logits(params, cfg, tokens, mesh=mesh)  # [b, s, v]
    return F.cross_entropy(
        logits[:, :-1].reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1).long()
    )


def make_optimizer(params: Params, lr: float = 1e-4) -> torch.optim.AdamW:
    """AdamW over every leaf, matched to ``optax.adamw(lr,
    weight_decay=0.01)``: the same betas and eps (outside the square root),
    bias correction, decoupled decay of every leaf from its value before
    the step, and moments in each parameter's dtype."""
    return torch.optim.AdamW(
        param_leaves(params), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01
    )


def trainable(params: Params) -> Params:
    """Mark every leaf as requiring grad (in place); returns ``params``.
    Quantized weights cannot be trained."""
    for t in param_leaves(params):
        if isinstance(t, QuantizedTensor):
            raise ValueError("int8 (QuantizedTensor) parameters cannot be trained")
        t.requires_grad_(True)
    return params


def make_train_state(
    cfg: LlamaConfig,
    generator: Union[torch.Generator, int],
    lr: float = 1e-4,
    device: Union[torch.device, str] = "cuda",
) -> TrainState:
    """Random-init parameters (``models.init_params``; an int is a seed for
    a generator on ``device``), trainable, with a fresh AdamW."""
    if isinstance(generator, int):
        generator = torch.Generator(device=device).manual_seed(generator)
    params = trainable(llama.init_params(cfg, generator, device))
    return TrainState(params=params, optimizer=make_optimizer(params, lr), step=0)


def train_step(
    state: TrainState, cfg: LlamaConfig, tokens: torch.Tensor, lr: float = 1e-4,
    mesh=None,
) -> tuple[TrainState, torch.Tensor]:
    """One step on ``tokens [b, s]``: loss, gradients, AdamW at ``lr``.
    Returns the state (updated in place, step + 1) and the loss (a
    detached float32 scalar on the device; reading it syncs)."""
    _no_mesh(mesh)
    opt = state.optimizer
    for group in opt.param_groups:
        group["lr"] = lr
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(state.params, cfg, tokens)
    loss.backward()
    opt.step()
    return TrainState(state.params, opt, state.step + 1), loss.detach()


def detached(params: Params, device: Optional[Union[torch.device, str]] = None) -> Params:
    """A copy of a parameter tree that requires no grad (optionally on
    ``device``): what serves trained weights, so that no autograd graph is
    built inside the engine."""
    if isinstance(params, dict):
        return {k: detached(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [detached(v, device) for v in params]
    return params.detach().clone().to(device or params.device)
