"""Training step, on one device or over a (dp, tp) mesh: forward,
next-token loss, backward and AdamW — the port of the JAX package's
``parallel/train.py``.

The forward is the serving model's own layer code (``_embed``, ``_qkv``,
``apply_rope``, ``_mlp``, ``_logits``) over a whole sequence with no KV
cache, attention through ``ops.causal_prefill_attention``. A routed MoE
layer's expert products go through ``ops.GroupedMatmul``, so the backward
launches K4^T and K6 on the card (the kernels megablox's ``custom_vjp``
launches on a TPU). JAX donates the state to a jitted step and gets a new
one back; here parameters and moments are updated in place and the same
state object comes back with its step advanced.

Over a mesh (``mesh=``, or a state whose params are
``sharding.shard_train_params``' trees, which carry their mesh) the
parameters are per-shard leaves, every (dp, tp) shard its own, and one
process drives every shard, as JAX's jitted step does under GSPMD:

- each dp replica runs its even slice of the batch over its tp shards:
  the vocabulary-parallel embedding and head, attention on each shard's
  heads with the row-parallel ``wo`` partials summed through the mesh's
  collective, and the FFN's own per-shard code (K4 on each shard's E/tp
  experts when ``k * tp < E``, the dense fallbacks as JAX selects them);
- the ``wo`` partials are float32 products when tp > 1, so their sum is
  rounded once, as tp=1's one product is: bf16 partials round twice, and
  the weight gradients, sums of many cancelling terms, amplify that (on
  Qwen3-30B-A3B at 2 layers on the H100 the gathered gradients moved
  2.1 % of a leaf from tp=1's with bf16 partials, 1.5 % with float32
  ones; the rest is every GEMM's other shape and accumulation order);
- the loss is JAX's global mean: each replica's summed NLL, added up and
  divided by the whole batch's target count;
- after ``backward`` every leaf's gradient is summed over its copies (a
  replicated leaf over its tp copies and every leaf over the dp replicas),
  in a fixed order, and each copy receives the sum;
- AdamW then updates every per-shard leaf: its moments are sharded like
  their parameter (JAX's ``_opt_sharding``) and the step count is
  replicated. The same update on the same summed gradient keeps every copy
  bit-equal.

The sequence-parallel axis is not trained over (JAX's training never uses
it): a mesh with ``sp > 1`` is refused.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from ..models import llama
from ..models.llama import LlamaConfig, Params
from ..models.quant import QuantizedTensor
from ..ops import apply_rope, causal_prefill_attention, rms_norm
from .mesh import ShardedParams
from .sharding import leaf_specs, shard_batch, shard_train_params


class TrainState(NamedTuple):
    params: Params
    optimizer: torch.optim.AdamW
    step: int


def param_leaves(params: Params) -> list:
    """Every leaf of a parameter tree in a fixed order (the dict's insertion
    order, layers in turn): the optimizer's parameter order, which its
    state dict and ``models.convert.train_state_from_jax`` index by. Of
    sharded params: every replica's, row's and tp shard's tree in turn."""
    if isinstance(params, ShardedParams):
        return [t for grid in params.replicas for row in grid for tree in row
                for t in param_leaves(tree)]
    if isinstance(params, dict):
        return [t for v in params.values() for t in param_leaves(v)]
    if isinstance(params, list):
        return [t for v in params for t in param_leaves(v)]
    return [params]


def _sharded(params, mesh, device: torch.device) -> ShardedParams:
    """The per-shard trees a training forward runs on: a plain tree is the
    one shard of a 1x1 mesh (then ``mesh`` must be None); sharded params
    run on their own mesh, which ``mesh``, when given, must be."""
    if isinstance(params, ShardedParams):
        if mesh is not None and (params.mesh.replicas != mesh.replicas):
            raise ValueError("params are sharded over another mesh")
        if params.mesh.shape["sp"] > 1:
            raise ValueError("training does not run over sp > 1 (sequence parallelism "
                             "serves prefill only): build the mesh with sp=1")
        return params
    if mesh is not None:
        raise ValueError("with mesh= the params are parallel.shard_train_params(params, mesh, cfg)")
    return llama._placed(params, None, device)


def _replica_hidden(rep: ShardedParams, cfg: LlamaConfig, tokens: torch.Tensor) -> torch.Tensor:
    """One replica's forward over its tp shards up to the final norm:
    hidden states [b, s, d] on its first device."""
    mesh, coll = rep.mesh, rep.mesh.collective
    row, devs = rep.shards[0], mesh.grid[0]
    tp = len(row)
    scfg = llama._shard_cfg(cfg, tp)
    b, s = tokens.shape
    positions = [torch.arange(s, device=dev).expand(b, s) for dev in devs]
    inv = [llama._inv_freq(cfg, dev) for dev in devs]
    # Head-parallel attention needs whole heads on every shard; GSPMD also
    # splits a head, which the port does by gathering the attention weights.
    heads_split = cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0
    h = llama._embed(rep, cfg, tokens)
    for li in range(cfg.n_layers):
        layers = [tree["layers"][li] for tree in row]
        x = rms_norm(h, layers[0]["attn_norm"], cfg.rms_norm_eps, cfg.norm_offset)
        if not heads_split:
            layer = _gathered_attention(layers, coll)
            q, k, v = llama._qkv(layer, cfg, x)
            attn = causal_prefill_attention(apply_rope(q, positions[0], inv[0]),
                                            apply_rope(k, positions[0], inv[0]), v)
            h = h + attn.reshape(b, s, -1) @ llama._w(layer["wo"], h.dtype)
        else:
            parts = []
            for t, (layer, dev) in enumerate(zip(layers, devs)):
                q, k, v = llama._qkv(layer, scfg, coll.move(x, dev))
                q = apply_rope(q, positions[t], inv[t])
                k = apply_rope(k, positions[t], inv[t])
                attn = causal_prefill_attention(q, k, v).reshape(b, s, -1)
                wo = llama._w(layer["wo"], h.dtype)
                # Over tp > 1 the row-parallel partials stay float32 (the
                # module docstring says why).
                parts.append(attn @ wo if tp == 1 else attn.float() @ wo.float())
            h = h + coll.sum(parts, h.dtype)
        x = rms_norm(h, layers[0]["mlp_norm"], cfg.rms_norm_eps, cfg.norm_offset)
        h = h + llama._mlp(layers, cfg, x, mesh)
    return h


def _gathered_attention(layers: list, coll) -> dict:
    """One layer's attention weights whole on the first shard's device,
    gathered from the tp shards' slices (a differentiable gather: each
    shard's slice receives its part of the gradient): for a tp that does not
    divide the head counts, where a shard would hold part of a head."""
    out = {k: coll.cat([lay[k] for lay in layers], dim=-1)
           for k in ("wq", "wk", "wv", "bq", "bk", "bv") if k in layers[0]}
    out["wo"] = coll.cat([lay["wo"] for lay in layers], dim=0)
    out.update({k: layers[0][k] for k in ("q_norm", "k_norm") if k in layers[0]})
    return out


def _replica_logits(rep, cfg, tokens) -> torch.Tensor:
    return llama._logits(rep, cfg, _replica_hidden(rep, cfg, tokens))


def _forward_logits(params: Params, cfg: LlamaConfig, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """Full-sequence forward for training (no KV cache): [b, s, vocab]
    float32 logits, on the first shard's device under a mesh."""
    sharded = _sharded(params, mesh, tokens.device)
    mesh = sharded.mesh
    parts = [_replica_logits(sharded.replica(d), cfg, tok)
             for d, tok in enumerate(shard_batch(tokens, mesh))]
    return mesh.collective.cat(parts, dim=0)


def loss_fn(params: Params, cfg: LlamaConfig, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """Next-token cross-entropy over the sequence (mean, float32). Over dp
    replicas: the replicas' summed NLL over the whole batch's targets (the
    global mean), on the first shard's device."""
    sharded = _sharded(params, mesh, tokens.device)
    mesh = sharded.mesh
    batches = shard_batch(tokens, mesh)
    if len(batches) == 1:
        logits = _replica_logits(sharded, cfg, batches[0])  # [b, s, v]
        return F.cross_entropy(
            logits[:, :-1].reshape(-1, logits.shape[-1]), batches[0][:, 1:].reshape(-1).long()
        )
    sums = []
    for d, tok in enumerate(batches):
        logits = _replica_logits(sharded.replica(d), cfg, tok)
        sums.append(F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                                    tok[:, 1:].reshape(-1).long(), reduction="sum"))
    n_targets = tokens.shape[0] * (tokens.shape[1] - 1)
    return mesh.collective.sum(sums, torch.float32) / n_targets


def reduce_grads(params: ShardedParams) -> None:
    """Sum every leaf's gradient over its copies, into each copy: a leaf
    split over tp over its dp replicas, a replicated leaf over its dp × tp
    copies (the shards whose forward did not use their copy add zeros), in
    replica-then-shard order through the mesh's collective. Every copy then
    holds the same bits."""
    grid = [replica[0] for replica in params.replicas]  # [dp][tp] trees
    dp, tp = len(grid), len(grid[0])
    if dp * tp == 1:
        return
    leaves = [[param_leaves(tree) for tree in row] for row in grid]
    coll = params.mesh.collective
    for i, spec in enumerate(leaf_specs(grid[0][0], params.specs)):
        if "tp" in spec:
            groups = [[leaves[d][t][i] for d in range(dp)] for t in range(tp)]
        else:
            groups = [[leaves[d][t][i] for d in range(dp) for t in range(tp)]]
        for group in groups:
            if len(group) < 2:
                continue
            for p in group:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            coll.reduce_grads([p.grad for p in group])


def gather_grads(params: ShardedParams) -> list:
    """Every leaf's whole gradient (None where it has none) on the first
    shard's device, in the gathered tree's ``param_leaves`` order, from
    the first replica's shards (after ``reduce_grads`` every replica holds
    the same)."""
    from .sharding import gather_leaf

    row = params.shards[0]
    per_shard = [param_leaves(tree) for tree in row]
    out = []
    for i, spec in enumerate(leaf_specs(row[0], params.specs)):
        grads = [leaves[i].grad for leaves in per_shard]
        out.append(None if any(g is None for g in grads)
                   else gather_leaf(grads, spec, params.mesh.root))
    return out


def make_optimizer(params: Params, lr: float = 1e-4) -> torch.optim.AdamW:
    """AdamW over every leaf, matched to ``optax.adamw(lr,
    weight_decay=0.01)``: the same betas and eps (outside the square root),
    bias correction, decoupled decay of every leaf from its value before
    the step, and moments in each parameter's dtype. Of sharded params:
    over every shard's leaves, so the moments are sharded like them."""
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
    mesh=None,
) -> TrainState:
    """Random-init parameters (``models.init_params``; an int is a seed for
    a generator on ``device``), trainable, with a fresh AdamW. With
    ``mesh`` the tree is made on ``device`` and placed onto the mesh
    (``shard_train_params``)."""
    if isinstance(generator, int):
        generator = torch.Generator(device=device).manual_seed(generator)
    params = llama.init_params(cfg, generator, device)
    if mesh is not None:
        params = _sharded(shard_train_params(params, mesh, cfg), None, torch.device(device))
    params = trainable(params)
    return TrainState(params=params, optimizer=make_optimizer(params, lr), step=0)


def shard_train_state(state: TrainState, mesh, cfg: LlamaConfig) -> TrainState:
    """A mesh-free train state placed onto ``mesh``: the params as
    ``shard_train_params`` places them and the AdamW moments split like
    their parameters (the step counts replicated). A JAX ``TrainState``
    taken from a (dp, tp) mesh, carried over by ``models.
    train_state_from_jax``, goes onto the port's mesh this way."""
    if isinstance(state.params, ShardedParams):
        raise ValueError("the state is already sharded")
    leaves = param_leaves(state.params)
    saved = state.optimizer.state_dict()
    moments = [saved["state"].get(i) for i in range(len(leaves))]
    group = {k: v for k, v in saved["param_groups"][0].items() if k != "params"}
    return sharded_train_state(state.params, moments, group, state.step, mesh, cfg)


def sharded_train_state(params: Params, moments: list, group: dict, step: int, mesh,
                        cfg: LlamaConfig) -> TrainState:
    """A train state on ``mesh`` from a whole tree (on any device; a
    memory-mapped one is read a slice at a time) and its per-leaf AdamW
    state (``{"step", "exp_avg", "exp_avg_sq"}`` or None before the first
    step, in ``param_leaves`` order): each shard's slice of every moment
    on its device, each copy with its own step count."""
    from .sharding import _own, shard_leaf

    sharded = trainable(_sharded(shard_train_params(params, mesh, cfg), None, mesh.root))
    optimizer = make_optimizer(sharded, group.get("lr", 1e-4))
    specs = leaf_specs(params, sharded.specs)
    tp = mesh.shape["tp"]
    state, j = {}, 0
    for grid in sharded.replicas:
        for t, tree in enumerate(grid[0]):
            for i, p in enumerate(param_leaves(tree)):
                if moments[i] is not None:
                    m = moments[i]
                    state[j] = {
                        "step": m["step"].detach().clone(),
                        "exp_avg": _own(shard_leaf(m["exp_avg"], specs[i], t, tp), p.device),
                        "exp_avg_sq": _own(shard_leaf(m["exp_avg_sq"], specs[i], t, tp), p.device),
                    }
                j += 1
    optimizer.load_state_dict({"state": state,
                               "param_groups": [dict(group, params=list(range(j)))]})
    for st in optimizer.state.values():
        # AdamW keeps its step count on the host unless capturable or fused.
        st["step"] = st["step"].cpu()
    return TrainState(params=sharded, optimizer=optimizer, step=step)


def gather_train_state(state: TrainState) -> TrainState:
    """The inverse of ``shard_train_state``: a mesh-free state on the first
    shard's device, its params ``gather_params``' tree and its AdamW
    holding the first replica's moments gathered like their parameters
    (fresh tensors: ``state`` is left as it is)."""
    from .sharding import gather_params

    params = trainable(gather_params(state.params))
    optimizer = make_optimizer(params, state.optimizer.param_groups[0]["lr"])
    optimizer.load_state_dict(_gathered_optimizer_state(state))
    for st in optimizer.state.values():
        st["step"] = st["step"].cpu()
    return TrainState(params=params, optimizer=optimizer, step=state.step)


def _gathered_optimizer_state(state: TrainState) -> dict:
    """The state dict a mesh-free AdamW over the gathered params would
    have: per leaf (``param_leaves`` order) the first replica's moments
    gathered like their parameter and its step count; the param group's
    hyperparameters as they are."""
    from .sharding import gather_leaf

    sharded = state.params
    row = sharded.shards[0]
    opt = state.optimizer
    per_shard = [param_leaves(tree) for tree in row]
    specs = leaf_specs(row[0], sharded.specs)
    device = sharded.mesh.root
    out = {}
    for i, spec in enumerate(specs):
        sts = [opt.state.get(leaves[i]) for leaves in per_shard]
        if not sts[0]:
            continue
        out[i] = {
            "step": sts[0]["step"].detach().clone(),
            "exp_avg": gather_leaf([s["exp_avg"].detach() for s in sts], spec, device),
            "exp_avg_sq": gather_leaf([s["exp_avg_sq"].detach() for s in sts], spec, device),
        }
    group = {k: v for k, v in opt.state_dict()["param_groups"][0].items() if k != "params"}
    return {"state": out, "param_groups": [dict(group, params=list(range(len(specs))))]}


def train_step(
    state: TrainState, cfg: LlamaConfig, tokens: torch.Tensor, lr: float = 1e-4,
    mesh=None,
) -> tuple[TrainState, torch.Tensor]:
    """One step on ``tokens [b, s]``: loss, gradients, AdamW at ``lr``.
    Returns the state (updated in place, step + 1) and the loss (a
    detached float32 scalar on the first shard's device; reading it
    syncs). Over a mesh the batch splits evenly over the dp replicas and
    the gradients are reduced before the update (the module docstring)."""
    sharded = _sharded(state.params, mesh, tokens.device)
    opt = state.optimizer
    for group in opt.param_groups:
        group["lr"] = lr
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(state.params, cfg, tokens)
    loss.backward()
    reduce_grads(sharded)
    opt.step()
    return TrainState(state.params, opt, state.step + 1), loss.detach()


def detached(params: Params, device: Optional[Union[torch.device, str]] = None) -> Params:
    """A copy of a parameter tree that requires no grad (optionally on
    ``device``): what serves trained weights, so that no autograd graph is
    built inside the engine (of sharded params, ``gather_params``' tree
    is such a copy)."""
    if isinstance(params, dict):
        return {k: detached(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [detached(v, device) for v in params]
    return params.detach().clone().to(device or params.device)
