"""Analytic HBM-traffic floor per (arch x shape x mesh) cell (the
reference's ``repro/launch/analytic.py``).

The floor counts, per device, the traffic the card cannot avoid: the
weights streamed once per pass, the KV cache read, the optimizer state
read and written, the remat carries saved and reloaded, the logits
materialized.  It leaves out the activation traffic inside a layer,
which a fused kernel keeps in shared memory and registers, so it is a
lower bound.  The dry run (``launch/dryrun``) records it beside the
bytes its trace counts (every aten op's operands and results, every
kernel launch's table bytes), which include that intra-layer traffic.

The arithmetic is the reference's, on the port's specs, rules and
``partition_spec``, with torch dtype sizes: ``mesh`` is anything with
``shape`` (axis name -> size), ``axis_names`` and ``size``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

from repro_torch.distributed.sharding import RuleSet, partition_spec
from repro_torch.launch import steps as steps_lib
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import leaves_with_paths

Tree = Any


def _shards(entries, mesh) -> int:
    """How many ways the spec ``entries`` split a tensor over ``mesh``."""
    n = 1
    for entry in entries:
        if entry is None:
            continue
        for a in entry if isinstance(entry, tuple) else (entry,):
            n *= mesh.shape[a]
    return n


def _sharded_bytes(spec_tree: Tree, rules: RuleSet, mesh) -> int:
    """Exact per-device bytes of a ParamSpec tree under the rule set."""
    total = 0
    for _, s in leaves_with_paths(spec_tree):
        ps = partition_spec(s.axes, s.shape, rules, mesh)
        total += math.prod(s.shape) // _shards(ps, mesh) * s.dtype.itemsize
    return total


def analytic_bytes_per_device(cfg: ArchConfig, shape: "steps_lib.ShapeSpec",
                              mesh, *, remat: str = "full",
                              flags=None) -> Dict[str, float]:
    rules = steps_lib.rules_for(shape, cfg)
    specs = steps_lib.input_specs(cfg, shape, flags)
    act = cfg.compute_dtype.itemsize

    if shape.kind == "train":
        p_bytes = _sharded_bytes(specs["state"]["params"], rules, mesh)
        m_bytes = _sharded_bytes(specs["state"]["mu"], rules, mesh) \
            + _sharded_bytes(specs["state"]["nu"], rules, mesh)
        # local tokens: batch and seq sharding per rules
        tok_local = shape.global_batch * shape.seq_len // _shards(
            partition_spec(("batch", "seq"),
                           (shape.global_batch, shape.seq_len), rules, mesh),
            mesh)
        # passes: fwd reads params, bwd reads params; full remat re-reads
        passes = 3 if remat != "none" else 2
        weights = p_bytes * passes
        grads = p_bytes                                  # write grads
        opt = m_bytes * 2 + p_bytes                      # rw moments, write p
        carries = tok_local * cfg.d_model * act * cfg.n_layers * 2
        vocab_local = cfg.vocab_size // _shards(
            partition_spec(("vocab",), (cfg.vocab_size,), rules, mesh), mesh)
        logits = tok_local * vocab_local * 4 * 2         # fp32 rw
        total = weights + grads + opt + carries + logits
        return {"params": p_bytes, "optimizer": m_bytes, "total": total,
                "weights_traffic": weights, "carries": carries,
                "logits": logits}

    p_bytes = _sharded_bytes(specs["params"], rules, mesh)
    c_bytes = _sharded_bytes(specs["caches"], rules, mesh)
    if shape.kind == "decode":
        # one token: stream weights once, read the whole cache, tiny writes
        total = p_bytes + c_bytes
        return {"params": p_bytes, "cache": c_bytes, "total": total}
    # prefill: stream weights, write cache once, activation rw per layer
    tok_local = shape.global_batch * shape.seq_len // mesh.size * \
        max(mesh.shape.get("model", 1), 1)   # batch over data(,pod) only
    acts = tok_local * cfg.d_model * act * cfg.n_layers * 2
    total = p_bytes + c_bytes + acts
    return {"params": p_bytes, "cache": c_bytes, "acts": acts,
            "total": total}
