"""Step builders + abstract input specs for every (arch x shape) cell
(the reference's ``repro/launch/steps.py``).

``input_specs(cfg, shape)`` returns the spec trees of every input of a
cell (tokens, labels, caches, frontend stubs, the train state) with the
logical axes the sharding rules consume; ``abstract_inputs`` their meta
tensors (no allocation), ``input_shardings`` their shardings on a mesh.
``make_train_step`` returns the training step the reference's trainer
jits: loss and gradients (gradient accumulation over microbatches cut
from the batch's leading axis, summed in float32 over a Python loop
where the reference uses ``lax.scan``), int8 error-feedback compression
of the gradients, then AdamW.  ``make_prefill_step`` /
``make_decode_step`` wrap ``prefill`` / ``decode_step``.

``jit_cell(cfg, shape, mesh)`` is the reference's jit-with-shardings of
one cell, run eagerly: it returns ``(step, abstract_args)``, and
``step`` distributes its inputs to ``input_shardings``, runs the step
body and returns DTensors laid out as the reference's out-shardings,
writing the new state (train) or caches (prefill, decode) into the
inputs it was given (the reference donates them).  The body computes on
plain local tensors, so no DTensor reaches the kernels.  It takes one of
two layouts (``layout``), chosen from the config and the mesh:

* ``"sharded"``: the train cell of a decoder whose every block is
  attention + a dense FFN (qwen2-5-7b, gemma3-1b, granite-20b,
  command-r-35b) or a routed MoE FFN (mixtral-8x22b), laid out as GSPMD
  partitions the reference's step under ``TRAIN_RULES``.  Each rank
  keeps only its block of every state leaf (``to_local()``) and the
  optimizer runs on the blocks.  Each layer gathers its weights over
  "data" (FSDP) inside its checkpoint, and their gradients return to
  the blocks by reduce-scatters; heads and ffn are split over "model",
  the residual between blocks is split by rows over the batch's axes
  and by sequence over "model", gathered before the column-parallel
  products and reduce-scattered after the row-parallel ones
  (``sharding.ModelShards``, ``models/model.py``);
  the MoE FFN routes whole dispatch groups on the gathered sequence and
  computes the rank's experts, or its ffn block of every expert where
  the experts do not divide "model" (``models/moe.py``); the loss, the
  router's statistics, the global norm and the int8 scale are reduced
  over the shards.
* ``"sharded"`` also runs the ``prefill_32k`` / ``decode_32k`` cells
  of the same five decoders with a bf16 or float32 cache, laid out as
  the reference's step under ``SERVE_RULES`` or, for an arch whose
  weights cannot replicate over "data" (mixtral-8x22b),
  ``SERVE_BIG_RULES``: each rank keeps its block of every weight
  (heads, ffn, experts and vocab over "model"; "embed" over "data" under
  SERVE_BIG_RULES, else weights replicated over "data"), its rows over
  the batch's axes and its block of the KV cache's length over "model",
  which it writes in place (the reference donates the caches).  Each
  layer gathers its weights over "data" (SERVE_BIG_RULES), and those
  split by head dim or K/V head whole, each row-parallel product's (and
  the MoE's) partial sums are all-reduced over "model", a decode step's
  attention merged over the ranks' length blocks by their log-sum-exps
  (``sharding.ServeShards``, ``models/attention._serve_attention``); the
  step returns the rank's block of the logits, ("batch", "vocab"), and
  the caches it was given.
* ``"gathered"``: every other cell (``long_500k``, an int8 cache, the
  other six archs).  Every weight is gathered whole
  (``full_tensor()``: the ZeRO resolution of TRAIN_RULES' ``"embed" ->
  data``, and the tensor-parallel dims gathered too), each rank runs its
  block of the batch's rows (``sharding.BatchShards``: the mesh axes the
  "batch" dim is split over) and repeats the model axis' work, the loss
  and the MoE router take their share of the global batch's
  statistics, the gradients are summed over the batch's ranks, and each
  rank keeps its block of the new state.

Both compute the unsharded step's math; only the sharded one divides
its memory and work over the ranks.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (LONG_SERVE_BIG_RULES,
                                              LONG_SERVE_RULES,
                                              SERVE_BIG_RULES, SERVE_RULES,
                                              TRAIN_RULES, BatchShards, Mesh,
                                              ModelShards, NamedSharding,
                                              PartitionSpec, RuleSet,
                                              ServeShards,
                                              activation_sharding,
                                              partition_spec,
                                              shardings_for_specs)
from repro_torch.models.config import FFN, ArchConfig, Mixer
from repro_torch.models.model import (RunFlags, build_cache_specs,
                                      build_param_specs, decode_step,
                                      prefill, train_loss)
from repro_torch.models.params import (ParamSpec, abstract, spec,
                                       tree_leaves, tree_map,
                                       tree_unflatten)
from repro_torch.training.compression import compress_grads
from repro_torch.training.optimizer import AdamWConfig, adamw_init_specs, \
    adamw_update

Tree = Any


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped): the reference's skip rules."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: O(seq) KV per layer at "
                       "524k is architecturally unbounded; skipped per "
                       "assignment (DESIGN.md section 4)")
    return True, ""


def rules_for(shape: ShapeSpec, cfg: Optional[ArchConfig] = None
              ) -> RuleSet:
    if shape.kind == "train":
        return TRAIN_RULES
    big = cfg is not None and cfg.param_count() * 2 / 16 > 12e9
    if shape.global_batch == 1:
        return LONG_SERVE_BIG_RULES if big else LONG_SERVE_RULES
    return SERVE_BIG_RULES if big else SERVE_RULES


# ---------------------------------------------------------------------------
# abstract inputs (meta tensors) + logical axes, per shape kind
# ---------------------------------------------------------------------------

def _batch_specs(cfg: ArchConfig, b: int, s: int) -> Tree:
    t = {"tokens": spec([b, s], ["batch", "seq"], torch.int32, "zeros"),
         "labels": spec([b, s], ["batch", "seq"], torch.int32, "zeros")}
    if cfg.encoder is not None:
        t["source_embeds"] = spec(
            [b, cfg.encoder.source_len, cfg.d_model],
            ["batch", "seq", None], torch.bfloat16, "zeros")
    if cfg.n_prefix_embeddings > 0:
        t["prefix_embeds"] = spec(
            [b, cfg.n_prefix_embeddings, cfg.d_model],
            ["batch", "seq", None], torch.bfloat16, "zeros")
    return t


def train_state_specs(cfg: ArchConfig, *, compression: bool = False
                      ) -> Tree:
    p = build_param_specs(cfg)
    mu, nu = adamw_init_specs(p)
    state = {"params": p, "mu": mu, "nu": nu,
             "step": spec([], [], torch.int32, "zeros")}
    if compression:
        # error-feedback residuals for int8 gradient compression
        ef, _ = adamw_init_specs(p)
        state["ef"] = ef
    return state


def _cache_dt(flags: Optional[RunFlags]) -> torch.dtype:
    if flags is not None and flags.cache_dtype == "int8":
        return torch.int8
    return torch.bfloat16


def input_specs(cfg: ArchConfig, shape: ShapeSpec,
                flags: Optional[RunFlags] = None) -> Dict[str, Tree]:
    """All inputs of one cell as spec trees, keyed by step argument."""
    if shape.kind == "train":
        return {"state": train_state_specs(cfg),
                "batch": _batch_specs(cfg, shape.global_batch,
                                      shape.seq_len)}
    if shape.kind == "prefill":
        batch = _batch_specs(cfg, shape.global_batch, shape.seq_len)
        batch.pop("labels")
        # VLM prefix embeddings extend the prefill sequence past seq_len
        cache_len = shape.seq_len + cfg.n_prefix_embeddings
        return {"params": build_param_specs(cfg),
                "batch": batch,
                "caches": build_cache_specs(cfg, shape.global_batch,
                                            cache_len, _cache_dt(flags))}
    if shape.kind == "decode":
        b = shape.global_batch
        return {"params": build_param_specs(cfg),
                "tokens": spec([b, 1], ["batch", "seq"], torch.int32,
                               "zeros"),
                "caches": build_cache_specs(cfg, b, shape.seq_len,
                                            _cache_dt(flags)),
                "pos": spec([], [], torch.int32, "zeros")}
    raise ValueError(shape.kind)


def abstract_inputs(cfg: ArchConfig, shape: ShapeSpec,
                    flags: Optional[RunFlags] = None) -> Dict[str, Tree]:
    return {k: abstract(v)
            for k, v in input_specs(cfg, shape, flags).items()}


def input_shardings(cfg: ArchConfig, shape: ShapeSpec, mesh: Mesh,
                    flags: Optional[RunFlags] = None) -> Dict[str, Tree]:
    rules = rules_for(shape, cfg)
    return {k: shardings_for_specs(v, rules, mesh)
            for k, v in input_specs(cfg, shape, flags).items()}


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def _act_ctx(mesh: Optional[Mesh], rules: Optional[RuleSet]):
    """Activation-hint context for step bodies (no-op when unset)."""
    if mesh is None or rules is None:
        return contextlib.nullcontext()
    return activation_sharding(mesh, rules)


def value_and_grad(params: Tree, batch: Tree, cfg: ArchConfig,
                   flags: RunFlags) -> Tuple[torch.Tensor, Tree]:
    """(train_loss, its gradient tree) at ``params`` (which need not
    require grad); a parameter the loss does not reach gets zeros, as
    ``jax.grad`` gives."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    loss = train_loss(tree_unflatten(params, leaves), batch, cfg, flags)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def _reduce_over_batch(loss: torch.Tensor, grads: Tree
                       ) -> Tuple[torch.Tensor, Tree]:
    """Inside a sharded step body: the ranks' loss shares summed over the
    tokens' ranks (the global batch's loss), and the gradients made the
    global batch's: summed over the batch's ranks (gathered layout), or
    each over the axes its block is replicated over (sharded layout: the
    FSDP reduce-scatters ran in the backward).  Elsewhere as they
    are."""
    shards = sharding.batch_shards()
    tp = sharding.model_shards()
    if tp is not None:
        grads = tp.reduce_grads(grads)
    elif shards is not None:
        for g in tree_leaves(grads):
            shards.sum(g)
    if shards is None:
        return loss, grads
    return shards.sum(loss.clone()), grads


def make_train_step(cfg: ArchConfig, opt: AdamWConfig = AdamWConfig(),
                    flags: RunFlags = RunFlags(),
                    mesh: Optional[Mesh] = None,
                    rules: Optional[RuleSet] = None,
                    compression: bool = False) -> Callable:
    """``train_step(state, batch) -> (new_state, {"loss",
    "grad_norm"})``.  The step donates ``state``, as the reference's
    jitted step does (``donate_argnums=(0,)``): the parameters and
    moments are updated in place and the new state holds them."""
    def train_step(state: Tree, batch: Tree) -> Tuple[Tree, Tree]:
        with _act_ctx(mesh, rules):
            accum = max(flags.grad_accum, 1)
            if accum == 1:
                loss, grads = value_and_grad(state["params"], batch, cfg,
                                             flags)
            else:
                # microbatch gradient accumulation: splits the global
                # batch on the leading axis
                dev = state["step"].device
                n = torch.tensor(accum, dtype=torch.float32, device=dev)
                loss = torch.zeros((), dtype=torch.float32, device=dev)
                grads = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device),
                    state["params"])
                for i in range(accum):
                    mb = {k: v.reshape((accum, v.shape[0] // accum)
                                       + tuple(v.shape[1:]))[i]
                          for k, v in batch.items()}
                    l, g = value_and_grad(state["params"], mb, cfg, flags)
                    grads = tree_map(lambda a, b: a + b.to(a.dtype), grads,
                                     g)
                    loss = loss + l
                loss = loss / n
                grads = tree_map(lambda g: g / n, grads)
            loss, grads = _reduce_over_batch(loss, grads)
            tp = sharding.model_shards()
            groups = None if tp is None else tp.shard_groups()
            new_ef = None
            if compression:
                # int8 round trip + error feedback before the optimizer
                grads, new_ef = compress_grads(grads, state["ef"], groups)
            new_p, new_mu, new_nu, gnorm = adamw_update(
                state["params"], grads, state["mu"], state["nu"],
                state["step"], opt, groups)
            new_state = {"params": new_p, "mu": new_mu, "nu": new_nu,
                         "step": state["step"] + 1}
            if compression:
                new_state["ef"] = new_ef
            return new_state, {"loss": loss, "grad_norm": gnorm}
    return train_step


def make_prefill_step(cfg: ArchConfig, flags: RunFlags = RunFlags(),
                      mesh: Optional[Mesh] = None,
                      rules: Optional[RuleSet] = None) -> Callable:
    def prefill_step(params: Tree, batch: Tree, caches: Tree):
        with _act_ctx(mesh, rules):
            return prefill(params, batch, caches, cfg, flags)
    return prefill_step


def make_decode_step(cfg: ArchConfig, flags: RunFlags = RunFlags(),
                     mesh: Optional[Mesh] = None,
                     rules: Optional[RuleSet] = None) -> Callable:
    def serve_step(params: Tree, tokens: torch.Tensor, caches: Tree, pos):
        with _act_ctx(mesh, rules):
            return decode_step(params, tokens, caches, pos, cfg, flags)
    return serve_step


# ---------------------------------------------------------------------------
# one cell on a mesh
# ---------------------------------------------------------------------------

_ARGS = {"train": ("state", "batch"),
         "prefill": ("params", "batch", "caches"),
         "decode": ("params", "tokens", "caches", "pos")}


def _batch_dim(s: ParamSpec) -> Optional[int]:
    return s.axes.index("batch") if "batch" in s.axes else None


def _local(x: Any, s: ParamSpec, shards: Optional[BatchShards],
           groups: int) -> torch.Tensor:
    """The plain tensor the body computes on: the global value, or this
    rank's rows of it where the leaf has a batch dim."""
    full = sharding.gather(x)
    dim = _batch_dim(s)
    if shards is None or dim is None:
        return full
    return shards.rows(full, dim, groups)


def _laid_out(local: torch.Tensor, sh: NamedSharding, dim: Optional[int],
              shards: Optional[BatchShards]) -> DTensor:
    """A DTensor laid out as ``sh`` from this rank's value: its rows
    (``dim``: the batch dim) or, without one, the global value."""
    mesh = sh.mesh
    dm = mesh.device_mesh
    held = [Replicate()] * dm.ndim
    if shards is not None and dim is not None:
        for a in shards.axes:
            held[mesh.axis_names.index(a)] = Shard(dim)
    return DTensor.from_local(local, dm, held, run_check=False) \
        .redistribute(dm, sh.placements)


def _write_local(dst: DTensor, new: torch.Tensor) -> DTensor:
    """Write this rank's new block into ``dst``'s local tensor (no copy
    when it was updated in place)."""
    out = dst.to_local()
    # the same memory unless the storages or offsets differ (compared
    # without data_ptr(), which a dry run's fake tensors do not have)
    same = out.untyped_storage()._cdata == new.untyped_storage()._cdata \
        and out.storage_offset() == new.storage_offset()
    if not same:
        with torch.no_grad():
            out.copy_(new)
    return dst


def _donate(dst: DTensor, new: torch.Tensor, s: ParamSpec,
            sh: NamedSharding, shards: Optional[BatchShards]) -> DTensor:
    """Write this rank's block of ``new`` into ``dst``'s local tensor."""
    return _write_local(dst, _laid_out(new, sh, _batch_dim(s),
                                       shards).to_local())


def _attention_decoder(cfg: ArchConfig) -> bool:
    """A decoder-only config whose every block is attention + a dense
    FFN or a routed MoE FFN without shared experts (no encoder,
    cross-attention or prefix embeddings)."""
    ffns = (FFN.DENSE,) if cfg.moe is not None and \
        cfg.moe.n_shared_experts > 0 else (FFN.DENSE, FFN.MOE)
    return cfg.encoder is None and cfg.n_prefix_embeddings == 0 and all(
        b.mixer == Mixer.ATTN and b.ffn in ffns
        and not b.cross_attention for g in cfg.groups for b in g.pattern)


def layout(cfg: ArchConfig, shape: ShapeSpec, mesh: Any,
           flags: RunFlags = RunFlags()) -> str:
    """The body ``jit_cell`` runs for a cell (module docstring):
    ``"sharded"`` for the train cell of a decoder of attention + dense
    or MoE FFN blocks whose residual, at the reference's block-boundary
    hint ("batch", "seq", None) under TRAIN_RULES, splits its rows over
    every axis but "model" and its sequence over "model" (each rank's
    tokens its own), and for its prefill and decode cells under
    SERVE_RULES or SERVE_BIG_RULES with a float cache whose length
    splits over "model" (or no "model" axis to split), else
    ``"gathered"``.  ``mesh``: anything with ``axis_names`` and
    ``shape``."""
    if not _attention_decoder(cfg):
        return "gathered"
    if shape.kind != "train":
        rules = rules_for(shape, cfg)
        if rules not in (SERVE_RULES, SERVE_BIG_RULES) or \
                flags.cache_dtype == "int8":
            return "gathered"
        cache = partition_spec(("batch", "kv_len"), (
            shape.global_batch, shape.seq_len + cfg.n_prefix_embeddings),
            rules, mesh)
        split = mesh.shape.get("model", 1) == 1 or cache[1] == "model"
        return "sharded" if split else "gathered"
    rows = shape.global_batch // max(flags.grad_accum, 1)
    hint = partition_spec(("batch", "seq", None),
                          (rows, shape.seq_len, cfg.d_model),
                          rules_for(shape, cfg), mesh)
    split = sharding.entry_axes(hint[0]) + sharding.entry_axes(hint[1])
    if any(n > 1 and a not in split for a, n in mesh.shape.items()):
        return "gathered"
    return "sharded"


def _tp_batch(x: DTensor, groups: int, shards: Optional[BatchShards],
              tp: ModelShards) -> torch.Tensor:
    """A batch leaf [B, S] in the sharded body: this rank's rows (of each
    microbatch) and its sequence block.  Without accumulation that is
    the leaf's local block as laid out (rows over the batch's axes,
    sequence over "model"); with it the microbatches' blocks are cut
    from the gathered batch, as the gathered body cuts them."""
    if groups == 1:
        return x.to_local()
    full = sharding.gather(x)
    rows = full if shards is None else shards.rows(full, 0, groups)
    lo, hi = tp.rows(rows.shape[1])
    return rows[:, lo:hi]


def jit_cell(cfg: ArchConfig, shape: ShapeSpec, mesh: Mesh,
             flags: RunFlags = RunFlags(),
             opt: AdamWConfig = AdamWConfig(), *,
             compression: bool = False):
    """One (arch x shape) cell on ``mesh``.  Returns ``(step,
    abstract_args)``: ``step`` takes the cell's inputs (plain tensors,
    the same global value on every rank, or DTensors; the decode
    position may be an int), lays them out as
    ``input_shardings`` and runs the body of the cell's ``layout`` on
    local tensors (module docstring); ``abstract_args`` are the inputs'
    meta-tensor trees.  ``compression``: a train cell's step compresses
    its gradients as ``make_train_step``'s does, and its state carries
    the error-feedback residuals ("ef", laid out as the params)."""
    specs = input_specs(cfg, shape, flags)
    if compression and shape.kind == "train":
        specs["state"] = train_state_specs(cfg, compression=True)
    rules = rules_for(shape, cfg)
    shard = {k: shardings_for_specs(v, rules, mesh)
             for k, v in specs.items()}
    names = _ARGS[shape.kind]
    tokens = shard["tokens"] if shape.kind == "decode" \
        else shard["batch"]["tokens"]
    axes = sharding.entry_axes(tokens.spec[0])
    shards = BatchShards(mesh, axes) if axes else None
    train = shape.kind == "train"
    groups = max(flags.grad_accum, 1) if train else 1
    tp = None
    sharded = layout(cfg, shape, mesh, flags) == "sharded"
    if sharded and not train:
        tp = ServeShards(mesh, tree_map(lambda sh: sh.spec,
                                        shard["params"]), specs["params"])
    elif sharded:
        tp = ModelShards(mesh, tree_map(lambda sh: sh.spec,
                                        shard["state"]["params"]))
        # the loss's statistics are over the tokens' blocks: rows and
        # sequence
        tokens_axes = axes + ((tp.axis,) if tp.size > 1 else ())
        stats = BatchShards(mesh, tokens_axes) if tokens_axes else None
    if train:
        fn = make_train_step(cfg, opt, flags, mesh=mesh, rules=rules,
                             compression=compression)
    elif shape.kind == "prefill":
        fn = make_prefill_step(cfg, flags, mesh=mesh, rules=rules)
    else:
        fn = make_decode_step(cfg, flags, mesh=mesh, rules=rules)
    logits_sh = NamedSharding(mesh, partition_spec(
        ("batch", "vocab"), (shape.global_batch, cfg.vocab_size), rules,
        mesh))
    replicated = NamedSharding(mesh, PartitionSpec())

    def step(*args):
        # a Python number (the decode position) stays on the host: it is
        # the same on every rank, and the body reads it as an int
        ins = {n: a if isinstance(a, (int, float)) else
               tree_map(sharding.distribute, a, shard[n])
               for n, a in zip(names, args)}
        if isinstance(tp, ServeShards):
            local = [a if isinstance(a, (int, float)) else
                     tree_map(lambda x: x.to_local(), a)
                     for a in (ins[n] for n in names)]
            with sharding.model_parallel(tp):
                logits, caches = fn(*local)
            return DTensor.from_local(
                logits, mesh.device_mesh, logits_sh.placements,
                run_check=False, shape=torch.Size(
                    (shape.global_batch, cfg.vocab_size)),
                stride=(cfg.vocab_size, 1)), \
                tree_map(_write_local, ins["caches"], caches)
        if tp is not None:
            state = tree_map(lambda x: x.to_local(), ins["state"])
            batch = tree_map(lambda x: _tp_batch(x, groups, shards, tp),
                             ins["batch"])
            with sharding.data_parallel(stats), sharding.model_parallel(tp):
                new_state, metrics = fn(state, batch)
            return tree_map(_write_local, ins["state"], new_state), {
                k: _laid_out(v, replicated, None, None)
                for k, v in metrics.items()}
        local = [tree_map(lambda x, s: _local(x, s, shards, groups),
                          ins[n], specs[n]) for n in names]
        if train:
            with sharding.data_parallel(shards):
                new_state, metrics = fn(*local)
            state = tree_map(lambda d, x, s, sh: _donate(d, x, s, sh, shards),
                             ins["state"], new_state, specs["state"],
                             shard["state"])
            return state, {k: _laid_out(v, replicated, None, None)
                           for k, v in metrics.items()}
        logits, caches = fn(*local)
        caches = tree_map(lambda d, x, s, sh: _donate(d, x, s, sh, shards),
                          ins["caches"], caches, specs["caches"],
                          shard["caches"])
        return _laid_out(logits, logits_sh, 0, shards), caches

    return step, tuple(abstract(specs[n]) for n in names)
