"""The composable LM stack: param-spec construction + train/prefill/decode.

Layer stacks run over *scan groups* (config.py): parameters and caches
are stacked with a leading "layers" axis, as in the reference, and the
port walks the layers in a Python loop where the reference uses
``lax.scan``.  Everything runs eagerly; the attention and the RG-LRU
recurrence inside each layer go through the port's kernels
(``models/attention.py``, ``models/recurrent.py``); MLA, the xLSTM
blocks and the MoE FFN (``models/moe.py``) are plain PyTorch, as they
are plain jnp in the reference.  A vision-language config's prefix
embeddings (``batch["prefix_embeds"]``) go before the token embeddings
in a prefill.  An encoder-decoder config (whisper) runs its
bidirectional encoder tower over ``batch["source_embeds"]`` [B, T, D]
at prefill (``_encode``); each decoder block's cross-attention K/V of
the encoder output are written into the cache then, and decode steps
read them from there.

``train_loss`` is the reference's: the no-cache path of every block
(MLA naive, mLSTM parallel, sLSTM over the sequence, RG-LRU from a zero
state), the MoE router's auxiliary loss summed over layers, and under
``RunFlags.remat == "full"`` (the default) each layer's blocks wrapped
in ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
scan body), so the backward recomputes them.  ``remat == "dots"`` is the
reference's ``checkpoint_dots`` policy: the same checkpoint with a
selective policy that saves every matrix product's output (``aten.mm``,
``bmm``, ``addmm``, ``matmul``: the einsums) and recomputes the rest.
On the card the attention and the RG-LRU scan launch the kernels in the
forward and again in the recompute under either policy (a ctypes launch
is no aten op the policy could save); their gradients come from
``torch.autograd.Function``s (``kernels/flash_attention.py``,
``kernels/rglru_scan.py``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.distributed import sharding
from repro_torch.models.blocks import (WINDOW_INF, apply_block,
                                       block_cache_specs, block_param_specs)
from repro_torch.models.config import (ArchConfig, BlockSpec, FFN, Mixer,
                                       ScanGroup)
from repro_torch.models.layers import embed, embed_specs, rmsnorm, \
    rmsnorm_spec, softmax_xent, unembed
from repro_torch.models.params import ParamSpec, tree_leaves, \
    tree_map_specs

Tree = Any


@dataclasses.dataclass(frozen=True)
class RunFlags:
    """Per-step execution knobs (the reference's).  The port reads
    ``remat`` in ``train_loss`` ("full", "dots" or "none"),
    ``grad_accum`` in ``launch/steps.make_train_step``, ``moe_impl`` and
    ``moe_group`` (the MoE dispatch), and its callers ``cache_dtype``.
    ``scan_unroll`` and ``attn_chunk`` shape the reference's XLA program
    (``lax.scan`` unrolling, query-chunked jnp attention) and have no
    counterpart in an eager stack whose attention is the flash kernel;
    they are kept so the flags carry over."""
    remat: str = "full"            # none | full | dots
    moe_impl: Optional[str] = None  # override cfg.moe.impl
    scan_unroll: int = 1
    attn_chunk: int = 1024         # query-chunked attention working set
    grad_accum: int = 1            # microbatch gradient accumulation
    moe_group: int = 0             # MoE dispatch group size (0 = one group)
    cache_dtype: str = "bf16"      # decode KV cache dtype: bf16 | int8


# ---------------------------------------------------------------------------
# parameter / cache / metadata construction
# ---------------------------------------------------------------------------

def _stack_specs(tree: Tree, repeats: int) -> Tree:
    return tree_map_specs(
        lambda s: ParamSpec((repeats,) + s.shape, s.dtype,
                            ("layers",) + s.axes, s.init, s.init_scale),
        tree)


def _encoder_cfg(cfg: ArchConfig) -> ArchConfig:
    """The encoder tower reuses the arch dims with full bidirectional
    attention, roped at the arch's theta."""
    enc_blk = BlockSpec(Mixer.ATTN, FFN.DENSE, rope_theta=cfg.rope_theta)
    return dataclasses.replace(
        cfg, groups=(ScanGroup("enc", cfg.encoder.n_layers, (enc_blk,)),),
        encoder=None)


def _group_specs(cfg: ArchConfig) -> Tree:
    return {g.name: {f"pos{j}": _stack_specs(
        block_param_specs(cfg, blk), g.repeats)
        for j, blk in enumerate(g.pattern)} for g in cfg.groups}


def build_param_specs(cfg: ArchConfig) -> Tree:
    cfg.validate()
    p = {"embed": embed_specs(cfg),
         "final_norm": rmsnorm_spec(cfg.d_model),
         "groups": _group_specs(cfg)}
    if cfg.encoder is not None:
        p["encoder"] = {"final_norm": rmsnorm_spec(cfg.d_model),
                        "groups": _group_specs(_encoder_cfg(cfg))}
    return p


def build_cache_specs(cfg: ArchConfig, batch: int, max_len: int,
                      dtype: torch.dtype = torch.bfloat16) -> Tree:
    src = cfg.encoder.source_len if cfg.encoder is not None else 0
    return {g.name: {f"pos{j}": _stack_specs(
        block_cache_specs(cfg, blk, batch, max_len, source_len=src,
                          dtype=dtype), g.repeats)
        for j, blk in enumerate(g.pattern)} for g in cfg.groups}


def build_meta(cfg: ArchConfig) -> Dict[str, Dict[str, Dict[str, List]]]:
    """Per-group, per-pattern-position metadata lists [repeats] of each
    layer's window (``WINDOW_INF`` for none) and rope theta."""
    flat_windows = list(cfg.layer_windows) if cfg.layer_windows else None
    flat_thetas = list(cfg.layer_thetas) if cfg.layer_thetas else None
    metas: Dict[str, Dict[str, Dict[str, List]]] = {}
    li = 0
    for g in cfg.groups:
        per_pos = {f"pos{j}": {"window": [], "theta": []}
                   for j in range(len(g.pattern))}
        for _ in range(g.repeats):
            for j, blk in enumerate(g.pattern):
                w = flat_windows[li] if flat_windows is not None \
                    else blk.window
                th = flat_thetas[li] if flat_thetas is not None \
                    else blk.rope_theta
                per_pos[f"pos{j}"]["window"].append(
                    WINDOW_INF if w is None else int(w))
                per_pos[f"pos{j}"]["theta"].append(float(th))
                li += 1
        metas[g.name] = per_pos
    return metas


# ---------------------------------------------------------------------------
# layer-stack execution
# ---------------------------------------------------------------------------

def _layer(tree: Tree, i: int) -> Tree:
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: List[Tree]) -> Tree:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _apply_layer(h: torch.Tensor, r: int, g: ScanGroup, gp: Tree, gm: Tree,
                 gc: Optional[Tree], cfg: ArchConfig,
                 positions: torch.Tensor, cache_offset, enc_out, causal: bool,
                 flags: RunFlags, shards=None, tp=None):
    """Layer ``r`` of group ``g`` (every block of its pattern): (h, the
    blocks' aux summed, each block's new cache).  ``shards`` and ``tp``
    are the caller's ``batch_shards()`` and ``model_shards()``, passed
    in because a recompute in the backward may run on another thread
    (the card's autograd worker) that does not see the caller's
    context.  With ``tp`` each block's weights are gathered over their
    FSDP axes here, inside the layer's checkpoint (in the serving body:
    over "data" under SERVE_BIG_RULES, and the ones split by head dim or
    K/V head over "model" too).  A block whose cache was written in
    place (every leaf the one it was handed) gives None for its new
    cache."""
    aux = 0.0
    ncs = []
    with sharding.data_parallel(shards):
        for j, blk in enumerate(g.pattern):
            key = f"pos{j}"
            meta = {k: v[r] for k, v in gm[key].items()}
            lp = _layer(gp[key], r)
            if tp is not None:
                lp = tp.layer(lp, "groups", g.name, key)
            lc = _layer(gc[key], r) if gc is not None else None
            h, nc, a = apply_block(
                lp, blk, cfg, h, positions, meta, cache=lc,
                cache_offset=cache_offset, enc_out=enc_out, causal=causal,
                moe_impl=flags.moe_impl, moe_group=flags.moe_group or None,
                tp=tp)
            aux = aux + a
            same = lc is not None and all(
                x is y for x, y in zip(tree_leaves(nc), tree_leaves(lc)))
            ncs.append(None if same else nc)
    return h, aux, ncs


# the outputs "dots" saves: every matrix product (the einsums
# decompose into these below autograd)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.matmul.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _save_dots():
    return create_selective_checkpoint_contexts(_dots_policy)


# remat -> the checkpoint's context_fn (None: no checkpoint)
_REMAT = {"none": None, "full": noop_context_fn, "dots": _save_dots}


def _run_groups(
    params: Tree,
    groups: Tuple[ScanGroup, ...],
    cfg: ArchConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    metas: Tree,
    *,
    train: bool = False,
    caches: Optional[Tree] = None,
    cache_offset=None,
    enc_out: Optional[torch.Tensor] = None,
    causal: bool = True,
    flags: RunFlags = RunFlags(),
) -> Tuple[torch.Tensor, Optional[Tree], torch.Tensor]:
    """Run every layer in order; returns (x, new caches or None, the
    auxiliary loss summed over layers: 0.0 without an MoE FFN).
    ``train`` (no cache) wraps each layer in ``checkpoint`` unless
    ``flags.remat`` is ``"none"``; under ``"dots"`` the checkpoint saves
    the matrix products' outputs (``_save_dots``).  A group whose every
    layer wrote its cache in place (the sharded serving body) returns
    the caches it was given; else its layers' new caches are stacked."""
    if train and flags.remat not in _REMAT:
        raise ValueError(f"remat={flags.remat!r}: expected one of "
                         f"{sorted(_REMAT)}")
    remat = _REMAT[flags.remat] if train else None
    tp = sharding.model_shards() if train or caches is not None else None
    new_caches: Optional[Dict[str, Tree]] = {} if caches is not None \
        else None
    aux_total = 0.0
    for g in groups:
        gc = caches[g.name] if caches is not None else None
        layer_caches: Dict[str, List[Tree]] = {
            f"pos{j}": [] for j in range(len(g.pattern))}
        for r in range(g.repeats):
            run = functools.partial(
                _apply_layer, r=r, g=g, gp=params["groups"][g.name],
                gm=metas[g.name], gc=gc, cfg=cfg, positions=positions,
                cache_offset=cache_offset, enc_out=enc_out, causal=causal,
                flags=flags, shards=sharding.batch_shards(), tp=tp)
            if remat is not None:
                x, aux, _ = checkpoint(run, x, use_reentrant=False,
                                       context_fn=remat)
            else:
                x, aux, ncs = run(x)
                for j, nc in enumerate(ncs):
                    layer_caches[f"pos{j}"].append(nc)
            aux_total = aux_total + aux
        if new_caches is not None:
            done = [nc is None for v in layer_caches.values() for nc in v]
            if all(done):
                new_caches[g.name] = gc
            elif any(done):
                raise ValueError(f"group {g.name}: some layers wrote their "
                                 f"caches in place and some did not")
            else:
                new_caches[g.name] = {k: _stack(v)
                                      for k, v in layer_caches.items()}
    return x, new_caches, aux_total


# ---------------------------------------------------------------------------
# model-level entry points
# ---------------------------------------------------------------------------

def _encode(params: Tree, cfg: ArchConfig, source_embeds: torch.Tensor,
            flags: RunFlags, train: bool = False) -> torch.Tensor:
    """Run the bidirectional encoder tower (whisper-style) over
    ``source_embeds`` [B, T, D]: no cache, no causal mask; rematerialized
    as the decoder in ``train``."""
    ecfg = _encoder_cfg(cfg)
    b, t, _ = source_embeds.shape
    x = source_embeds.to(cfg.compute_dtype)
    positions = torch.arange(t, device=x.device)[None].expand(b, t)
    x, _, _ = _run_groups(params["encoder"], ecfg.groups, ecfg, x,
                          positions, build_meta(ecfg), train=train,
                          causal=False, flags=flags)
    return rmsnorm(params["encoder"]["final_norm"], x, cfg.norm_eps)


def _served(params: Tree, tp, *path: str) -> Tree:
    """The subtree at ``path`` of ``params``; in the sharded serving body
    (``tp`` a ``ServeShards``) each leaf gathered over its axes other
    than "model" (SERVE_BIG_RULES' "embed" over "data"; nothing under
    SERVE_RULES), at its use, as a layer's weights are."""
    if tp is None:
        for k in path:
            params = params[k]
        return params
    return tp.fsdp(params, *path)


def _prepare_inputs(params: Tree, cfg: ArchConfig, batch: Dict[str, Any],
                    tp=None) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Embed tokens, prepend a VLM's prefix embeddings if any.
    Returns (x, positions, n_prefix).  ``tp`` (the sharded train body):
    the tokens are this rank's sequence block, embedded against the
    table gathered whole; the positions are the whole sequence's.  A
    ``ServeShards`` (the serving body): the tokens whole, looked up in
    the rank's block of the table's vocab (``embed``)."""
    tokens = batch["tokens"]
    serve = isinstance(tp, sharding.ServeShards)
    if tp is None or serve:
        x = embed({"table": _served(params, tp, "embed", "table")}, tokens,
                  cfg, tp)
    else:
        x = embed({"table": tp.whole(params, "embed", "table")}, tokens,
                  cfg)
    x = x.to(cfg.compute_dtype)
    n_prefix = 0
    if cfg.n_prefix_embeddings > 0:
        pre = batch["prefix_embeds"].to(cfg.compute_dtype)
        n_prefix = pre.shape[1]
        x = torch.cat([pre, x], dim=1)
    b, s, _ = x.shape
    if tp is not None and not serve:
        s *= tp.size
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    return x, positions, n_prefix


def train_loss(params: Tree, batch: Dict[str, Any], cfg: ArchConfig,
               flags: RunFlags = RunFlags()) -> torch.Tensor:
    """Mean next-token loss (+ MoE aux).  batch: tokens, labels,
    [source_embeds], [prefix_embeds], [loss_mask].

    Inside the sharded train body (``sharding.model_shards()`` set; a
    decoder of attention + dense or MoE FFN blocks) ``params`` are this
    rank's blocks and the batch its rows' sequence block: the residual
    stays split by rows and sequence between the layers (the
    reference's hint at its block boundary), each layer gathers its
    weights (``_apply_layer``), and the local tokens' logits come from
    the head gathered whole, the reference's ("batch", "seq", "vocab")
    layout with the vocab whole ("seq" takes "model" first)."""
    tp = sharding.model_shards()
    x, positions, n_prefix = _prepare_inputs(params, cfg, batch, tp)
    enc_out = None
    if cfg.encoder is not None:
        enc_out = _encode(params, cfg, batch["source_embeds"], flags,
                          train=True)
    x, _, aux = _run_groups(params, cfg.groups, cfg, x, positions,
                            build_meta(cfg), train=True, enc_out=enc_out,
                            flags=flags)
    final, head = params["final_norm"], params["embed"]
    if tp is not None:
        final = tp.fsdp(params, "final_norm")
    x = rmsnorm(final, x, cfg.norm_eps)
    if n_prefix > 0:
        x = x[:, n_prefix:, :]
    if tp is not None:
        name = "table" if cfg.tie_embeddings else "head"
        head = {name: tp.whole(params, "embed", name)}
    logits = unembed(head, x, cfg)
    return softmax_xent(logits, batch["labels"], batch.get("loss_mask")) \
        + aux


def prefill(params: Tree, batch: Dict[str, Any], caches: Tree,
            cfg: ArchConfig, flags: RunFlags = RunFlags()
            ) -> Tuple[torch.Tensor, Tree]:
    """Process the full prompt, returning (last-token logits [B,V],
    populated caches).  Inside the sharded serving body
    (``sharding.model_shards()`` a ``ServeShards``) ``params`` and
    ``caches`` are this rank's blocks, the caches are written in place
    and returned as given, and the logits are the rank's block of the
    vocab."""
    tp = sharding.model_shards()
    x, positions, _ = _prepare_inputs(params, cfg, batch, tp)
    enc_out = None
    if cfg.encoder is not None:
        enc_out = _encode(params, cfg, batch["source_embeds"], flags)
    x, new_caches, _ = _run_groups(
        params, cfg.groups, cfg, x, positions, build_meta(cfg),
        caches=caches, cache_offset=0, enc_out=enc_out, flags=flags)
    x = rmsnorm(_served(params, tp, "final_norm"), x[:, -1:, :],
                cfg.norm_eps)
    head = "table" if cfg.tie_embeddings else "head"
    logits = unembed({head: _served(params, tp, "embed", head)}, x,
                     cfg)[:, 0, :]
    return logits, new_caches


def decode_step(params: Tree, tokens: torch.Tensor, caches: Tree,
                pos: int, cfg: ArchConfig, flags: RunFlags = RunFlags()
                ) -> Tuple[torch.Tensor, Tree]:
    """One decode step of C tokens.  tokens [B,C] at positions
    pos .. pos + C - 1; pos: the write offset (an int).  C = 1 is a
    decode step; C > 1 continues a prompt in chunks (chunked prefill) or
    verifies several tokens at once, each token seeing the cache before
    it and the step's earlier tokens (xLSTM takes C = 1 only, as the
    reference).  Returns (logits of the last token [B,V], updated
    caches).  Inside the sharded serving body as ``prefill`` (one token
    a step)."""
    pos = int(pos)
    tp = sharding.model_shards()
    x = embed({"table": _served(params, tp, "embed", "table")}, tokens,
              cfg, tp).to(cfg.compute_dtype)
    b, s, _ = x.shape
    positions = (pos + torch.arange(s, device=x.device))[None].expand(b, s)
    x, new_caches, _ = _run_groups(
        params, cfg.groups, cfg, x, positions, build_meta(cfg),
        caches=caches, cache_offset=pos, flags=flags)
    x = rmsnorm(_served(params, tp, "final_norm"), x, cfg.norm_eps)
    head = "table" if cfg.tie_embeddings else "head"
    logits = unembed({head: _served(params, tp, "embed", head)}, x,
                     cfg)[:, -1, :]
    return logits, new_caches
