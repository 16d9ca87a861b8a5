"""GPipe-style pipeline parallelism over the "pod" axis (the reference's
``repro/training/pipeline.py``).

The layer stack is split into ``n_stages = mesh.shape[axis]``
contiguous stages, one a rank of the axis; microbatches stream through
the stages on a GPipe schedule (fill, steady state, drain), each step's
activations handed to the next stage by a differentiable collective
(``all_to_all_single_autograd``: the reference's ``ppermute``, whose
transpose is the reverse permutation).  So ``torch.autograd.grad``
through ``loss_fn`` gives the pipelined backward, as ``jax.grad``
through ``ppermute`` does in the reference.

Every rank runs the same program on the same (replicated) parameters
and batch, as the reference's ``shard_map`` body does: each computes
its stage every step of the schedule (a stage's input is selected with
``torch.where``, so the collectives' gradients flow on every rank), the
last stage keeps the finished microbatches and computes the loss, and
every rank returns that loss.  Its gradient reaches the last stage
only, and each parameter's gradient is summed over the stages in the
backward, so each rank's ``torch.autograd.grad`` gives the whole
gradient: its stage's layers from the stage that ran them, the
embedding and head from the stages that used them.

Scope, as the reference: decoder-only dense stacks with a single scan
group of a single-block pattern.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from repro_torch.distributed.sharding import Mesh
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import embed, rmsnorm, softmax_xent, unembed
from repro_torch.models.model import RunFlags, _run_groups, build_meta
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten

Tree = Any


def split_stage_params(params: Tree, cfg: ArchConfig, n_stages: int) -> Tree:
    """Reshape the single scan group's stacked params [L, ...] into
    [n_stages, L/n_stages, ...] so stage s owns slice s."""
    if len(cfg.groups) != 1 or len(cfg.groups[0].pattern) != 1:
        raise ValueError("pipeline supports single-group single-pattern "
                         "stacks (dense decoder-only)")
    L = cfg.groups[0].repeats
    if L % n_stages:
        raise ValueError(f"{L} layers not divisible by {n_stages} stages")

    def reshape(leaf):
        return leaf.reshape((n_stages, L // n_stages) + tuple(leaf.shape[1:]))

    gname = cfg.groups[0].name
    out = dict(params)
    out["groups"] = {gname: {"pos0": tree_map(
        reshape, params["groups"][gname]["pos0"])}}
    return out


class _SumOverStages(torch.autograd.Function):
    """Identity forward; the gradient summed over the stages' ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _FromLastStage(torch.autograd.Function):
    """The last stage's value on every rank; the gradient reaches the
    last stage's value only."""

    @staticmethod
    def forward(ctx, x, group, last: int, is_last: bool):
        ctx.is_last = is_last
        out = x.detach().clone()
        dist.broadcast(out, src=dist.get_global_rank(group, last),
                       group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_last else torch.zeros_like(g)), None, None, None


def make_pipelined_train_loss(cfg: ArchConfig, mesh: Mesh, *,
                              n_microbatches: int,
                              axis: str = "pod",
                              flags: RunFlags = RunFlags()):
    """Returns ``loss_fn(params_staged, batch)`` running a GPipe schedule
    over ``axis``.  params_staged: ``split_stage_params``'s tree, the
    same on every rank (each runs its own stage's slice); batch:
    tokens/labels [B, S] with B % n_microbatches == 0."""
    n_stages = mesh.shape[axis]
    dm = mesh.device_mesh
    group = dm.get_group(axis) if n_stages > 1 else None
    stage = dm.get_local_rank(axis)
    gname = cfg.groups[0].name
    L_per = cfg.groups[0].repeats // n_stages
    stage_group = dataclasses.replace(cfg.groups[0], repeats=L_per)
    stage_cfg = dataclasses.replace(cfg, groups=(stage_group,),
                                    n_layers=L_per * len(
                                        stage_group.pattern))
    metas = build_meta(stage_cfg)

    def stage_fn(p_stage: Tree, h: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
        """Run this rank's L/n_stages layers."""
        params = {"groups": {gname: {"pos0": p_stage}}}
        out, _, _ = _run_groups(params, stage_cfg.groups, stage_cfg, h,
                                positions, metas, train=True, flags=flags)
        return out

    def ppermute(h: torch.Tensor) -> torch.Tensor:
        """Stage i's ``h`` to stage i + 1 (the last's to stage 0)."""
        if group is None:
            return h
        rows = h.shape[0]
        send = [0] * n_stages
        recv = [0] * n_stages
        send[(stage + 1) % n_stages] = rows
        recv[(stage - 1) % n_stages] = rows
        out = funcol.all_to_all_single_autograd(h.contiguous(), recv, send,
                                                group)
        return funcol.wait_tensor(out)

    def loss_fn(params_staged: Tree, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        if group is not None:
            params_staged = tree_unflatten(params_staged, [
                _SumOverStages.apply(t, group)
                for t in tree_leaves(params_staged)])
        tokens, labels = batch["tokens"], batch["labels"]
        b, s = tokens.shape
        M = n_microbatches
        x = embed(params_staged["embed"], tokens, cfg).to(cfg.compute_dtype)
        positions = torch.arange(s, device=x.device)[None].expand(b // M, s)
        emb_mb = x.reshape(M, b // M, s, x.shape[-1])
        p_stage = tree_map(lambda t: t[stage],
                           params_staged["groups"][gname]["pos0"])
        first = torch.tensor(stage == 0, device=x.device)
        last = torch.tensor(stage == n_stages - 1, device=x.device)
        carry = torch.zeros_like(emb_mb[0])
        outs = [torch.zeros_like(emb_mb[0])] * M   # finished microbatches
        # fill, steady state, drain: stage 0 takes microbatch t, the
        # others the previous stage's output of step t - 1
        for t in range(M + n_stages - 1):
            h_in = torch.where(first, emb_mb[min(t, M - 1)], carry)
            h_out = stage_fn(p_stage, h_in, positions)
            carry = ppermute(h_out)
            if t >= n_stages - 1:    # the last stage finished a microbatch
                j = t - (n_stages - 1)
                outs[j] = torch.where(last, h_out, outs[j])
        h = torch.stack(outs).reshape(b, s, -1)
        h = rmsnorm(params_staged["final_norm"], h, cfg.norm_eps)
        logits = unembed(params_staged["embed"], h, cfg)
        loss = softmax_xent(logits, labels)
        if group is None:
            return loss
        return _FromLastStage.apply(loss, group, n_stages - 1,
                                    stage == n_stages - 1)

    return loss_fn
