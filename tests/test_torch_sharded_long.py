"""The sharded long-context decode body (``launch/steps.jit_cell``'s
``"sharded"`` layout for the ``long_500k`` cells of gemma3-1b and
mixtral-8x22b, laid out as the reference's step under LONG_SERVE_RULES
and LONG_SERVE_BIG_RULES: one row, the KV cache's length split over
every mesh axis -- ("data", "model") here -- and written in place, the
heads, ffn and vocab over "model", a step's attention merged over all
the length blocks) on the CPU.

At world sizes 2 and 4 (gloo processes, ``_torch_spmd.sharded_long``,
both spawns side by side) every (mesh, config, case) of
``_torch_spmd.MESHES`` x ``LONG`` x ``LONG_CASES`` is held against the
unsharded ``make_decode_step`` on the same inputs: reduced gemma3-1b
under LONG_SERVE_RULES and reduced Mixtral under both long rule sets
(LONG_SERVE_BIG_RULES substituted for ``rules_for``'s choice: the
reduced weights would replicate over "data"), a cache of
``LONG_LEN`` rows filled up to the position by the unsharded prefill,
then two tokens stepped in a row, so the second reads the row the first
wrote in place.  The positions are taken over the number of length
blocks (data x model): in the first block, at the last row of block 0
and the first of block 1, and in the last block, so the reduced window
of 8 straddles two blocks and some blocks lie wholly before the window
or past the token.  Each step's logits and every float32 cache leaf
are within rtol 1e-5 of its max, bf16 ones by
``_torch_spmd.bf16_close``, each rank's caches its blocks; rank 0's
whole logits and caches of both steps are also held against the JAX
package's ``decode_step`` (its own ``jit_cell`` decode raises under JAX
0.9: ROADMAP.md, "Reference failures").  The "memory" case: each rank
holds 1 / (data x model) of the cache and writes it in place, no tensor
is as long as the whole cache, and an out-of-place writer fails that
check.  The planted faults of ``_torch_spmd.LONG_FAULTS`` (the merge
over "model" alone, the length block indexed model-major, the
one-block shortcut on "model"'s size) must miss by 10 x rtol.  The
weights are at the d_model fan-in law (``_torch_spmd._serve_params``).

Without processes: ``steps.layout`` of the long cells on the test
meshes, and rank 0's blocks of both long cells at full width on
(16, 16) and (2, 16, 16) against the analytic floor.
"""
import concurrent.futures
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_spmd
from _torch_spmd import (LONG, LONG_CASES, LONG_FAULTS, LONG_LEN, MESHES,
                         RTOL, bf16_close, long_positions)
from repro.configs import get_reduced as jget_reduced
from repro.models import RunFlags as JRunFlags
from repro.models import decode_step as jdecode_step
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import (LONG_SERVE_BIG_RULES,
                                              LONG_SERVE_RULES, entry_axes)
from repro_torch.launch import steps
from repro_torch.launch.analytic import analytic_bytes_per_device
from repro_torch.launch.steps import (SHAPES, ShapeSpec, input_shardings,
                                      input_specs)
from repro_torch.models import RunFlags
from repro_torch.models.params import leaves_with_paths, tree_map

MESH_LIST = [(world, data, model) for world in sorted(MESHES)
             for data, model in MESHES[world]]
CASES = [(w, d, m, arch, rules, case) for w, d, m in MESH_LIST
         for arch, rules in LONG for case in LONG_CASES]
SERVED = [c for c in CASES if c[-1] != "memory"]
FAULTS = [(w, d, m, arch, rules, fault) for w, d, m in MESH_LIST
          for arch, rules in LONG if rules == "long-big"
          or arch == "gemma3-1b"
          for fault, meshes in LONG_FAULTS.items() if (d, m) in meshes]


def _ids(cases):
    return [f"{d}x{m}-{a}-{r}-{c}" for _, d, m, a, r, c in cases]


class FakeMesh:
    """Just axis_names + shape, enough for partition_spec resolution."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = math.prod(self.shape.values())


SINGLE = FakeMesh({"data": 16, "model": 16})
MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """world -> (the job's folder, each rank's outcome a case): both
    worlds' jobs started together, once."""
    tmp = {w: tmp_path_factory.mktemp(f"sharded_long_{w}") for w in MESHES}
    with concurrent.futures.ThreadPoolExecutor(len(tmp)) as pool:
        jobs = [pool.submit(_torch_spmd.spawn, "sharded_long", w, t,
                            timeout=300) for w, t in tmp.items()]
        for f in jobs:
            f.result()
    return {w: (t, [json.loads((t / f"sharded_long.{r}.json").read_text())
                    for r in range(w)]) for w, t in tmp.items()}


@pytest.mark.parametrize("world,data,model,arch,rules,case", CASES,
                         ids=_ids(CASES))
def test_sharded_long_decode_matches_the_unsharded_step(
        runs, world, data, model, arch, rules, case):
    name = f"{data}x{model}-{arch}-{rules}-{case}"
    for rank, res in enumerate(runs[world][1]):
        assert res[name] == "ok", (rank, res[name])


@pytest.mark.parametrize("world,data,model,arch,rules,fault", FAULTS,
                         ids=_ids(FAULTS))
def test_planted_long_faults_miss(runs, world, data, model, arch, rules,
                                  fault):
    """Each planted fault's step lands farther than 10 x rtol 1e-5 from
    the unsharded step on some rank (``_torch_spmd._long_fault_case``:
    the logits' or a cache leaf's largest distance over its max)."""
    name = f"{data}x{model}-{arch}-{rules}-{fault}"
    got = [res[name] for res in runs[world][1]]
    assert all(isinstance(g, float) for g in got), got
    assert max(got) > 10 * RTOL, (name, got)


_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(_JNP[t.dtype])


def _jstep(arch, tok, caches, pos):
    """The JAX package's ``decode_step`` on the port's tensors: the
    logits (float32 numpy) and the new caches (jnp)."""
    _, params, _, _ = _inputs(arch, 3, torch.float32)
    logits, out = jdecode_step(tree_map(_jnp, params),
                               jnp.asarray(tok.numpy()), caches, pos,
                               jget_reduced(arch), JRunFlags())
    return np.asarray(logits, np.float32), out


@functools.lru_cache(maxsize=None)
def _inputs(arch, pos, dtype):
    return _torch_spmd.long_inputs(arch, pos, dtype)


@functools.lru_cache(maxsize=None)
def _reference_first(arch, pos, bf16):
    """The JAX package's first step from a case's inputs, and (float32)
    its second step from its own first step's caches."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    _, _, caches, tok = _inputs(arch, pos, dtype)
    first = _jstep(arch, tok[:, :1], tree_map(_jnp, caches), pos)
    second = None if bf16 else _jstep(arch, tok[:, 1:], first[1], pos + 1)
    return first, second


def _leaves(caches):
    return {jax.tree_util.keystr(k): np.asarray(v.astype(jnp.float32))
            for k, v in jax.tree_util.tree_flatten_with_path(caches)[0]}


@pytest.mark.parametrize("world,data,model,arch,rules,case", SERVED,
                         ids=_ids(SERVED))
def test_sharded_long_decode_matches_the_jax_reference(
        runs, world, data, model, arch, rules, case):
    """Each gloo case's whole logits and caches of both steps (rank 0's,
    saved by the job) against the JAX package's ``decode_step`` on the
    same weights, tokens and caches: float32 as a chain of two steps
    from the prefilled caches; bf16 the first step from them and the
    second from the sharded run's own first-step caches (a bf16 element
    written near a rounding midpoint may round either way, and the
    second step reads it).  The logits and float32 caches within rtol
    1e-5 of each leaf's max, bf16 caches by ``_torch_spmd.bf16_close``
    against the unsharded port's float32 K/V."""
    name = f"{data}x{model}-{arch}-{rules}-{case}"
    tmp, res = runs[world]
    assert all(r[name] == "ok" for r in res), name
    got = torch.load(tmp / f"long.{name}.pt")
    bf16 = case.endswith("bf16")
    pos = long_positions(data * model)[case]
    first, second = _reference_first(arch, pos, bf16)
    if second is None:
        _, _, _, tok = _inputs(arch, pos, torch.bfloat16)
        second = _jstep(arch, tok[:, 1:], tree_map(
            _jnp, _nested(got[0]["caches"])), pos + 1)
    for i, (jlog, jcaches) in enumerate((first, second)):
        label = f"{name} step {i}"
        _torch_spmd._close(got[i]["logits"], torch.from_numpy(jlog.copy()),
                           f"{label} logits")
        want = _leaves(jcaches)
        assert set(got[i]["caches"]) == set(want), label
        for path, g in got[i]["caches"].items():
            w = torch.from_numpy(want[path].copy())
            if got[i]["wide"] is None or g.dtype == torch.float32:
                _torch_spmd._close(g, w, f"{label} cache{path}")
            else:
                bf16_close(g, w.bfloat16(), got[i]["wide"][path],
                           f"{label} cache{path}")


def _nested(flat):
    """{"['a']['b']": t} -> {"a": {"b": t}}."""
    out = {}
    for path, t in flat.items():
        keys = [k.strip("'") for k in path[1:-1].split("][")]
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    return out


def test_layout_of_the_long_cells():
    """Both reduced configs' one-row decode cells are sharded on every
    test mesh under either long rule set (the length split over
    ("data", "model")); gathered with an int8 cache, with a length that
    does not split over every axis of more than one rank, and for a
    prefill of one row."""
    for arch in ("gemma3-1b", "mixtral-8x22b"):
        cfg = _torch_spmd.reduced(arch)
        for _, data, model in MESH_LIST:
            mesh = FakeMesh({"data": data, "model": model})
            for rules in ("long", "long-big"):
                with _torch_spmd.long_rules(rules):
                    shape = ShapeSpec("long", "decode", LONG_LEN, 1)
                    assert steps.rules_for(shape, cfg) is (
                        LONG_SERVE_BIG_RULES if rules == "long-big"
                        else LONG_SERVE_RULES)
                    assert steps.layout(cfg, shape, mesh) == "sharded"
                    assert steps.layout(cfg, shape, mesh, RunFlags(
                        cache_dtype="int8")) == "gathered"
                    odd = ShapeSpec("long", "decode", 30, 1)
                    want = "sharded" if data * model <= 2 else "gathered"
                    assert steps.layout(cfg, odd, mesh) == want, (data,
                                                                  model)
                    pre = ShapeSpec("long", "prefill", LONG_LEN, 1)
                    assert steps.layout(cfg, pre, mesh) == "gathered"


def _local(spec, sh, mesh):
    shape = list(spec.shape)
    for dim, entry in enumerate(sh.spec):
        for a in entry_axes(entry):
            shape[dim] //= mesh.shape[a]
    return tuple(shape)


# rank 0's long_500k blocks at full width: a layer's cache (1, rows, kv
# heads, head dim) on (16, 16) and on (2, 16, 16), the query
# projection's last two dims, the table's vocab rows and d_model share
LONG_LOCAL = {
    "gemma3-1b": ((1, 2048, 1, 256), (1, 1024, 1, 256), (4, 16),
                  (16384, 1152)),
    "mixtral-8x22b": ((1, 2048, 8, 128), (1, 1024, 8, 128), (3, 128),
                      (2048, 384)),
}


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("arch", sorted(LONG_LOCAL))
def test_long_local_blocks_at_full_width(arch, mesh_name):
    """Each rank's blocks of long_500k at full width, as meta tensors: the
    cache's 524,288 rows over every rank (2,048 on (16, 16), 1,024 on
    (2, 16, 16)), its kv heads and head dim whole; gemma3-1b's 4 query
    heads replicated and its head dim split over "model" (LONG_SERVE
    _RULES: the weights replicated over "data"), Mixtral's 3 of 48 heads
    and its "embed" over "data" (LONG_SERVE_BIG_RULES).  The rank's
    bytes of the weights and the cache are the analytic floor's."""
    cfg, shape = get_config(arch), SHAPES["long_500k"]
    mesh = SINGLE if mesh_name == "single" else MULTI
    assert steps.layout(cfg, shape, mesh) == "sharded"
    specs, sh = input_specs(cfg, shape), input_shardings(cfg, shape, mesh)
    cache, cache_multi, wq, table = LONG_LOCAL[arch]
    local = {key: {p: _local(s, h, mesh) for (p, s), (_, h) in zip(
        leaves_with_paths(specs[key]), leaves_with_paths(sh[key]))}
        for key in ("params", "caches")}
    want = cache if mesh_name == "single" else cache_multi
    assert {s[1:] for s in local["caches"].values()} == {want}
    attn = next(p for p in local["params"] if p.endswith("['attn']['wq']"))
    assert local["params"][attn][2:] == wq
    assert local["params"]["['embed']['table']"] == table
    floor = analytic_bytes_per_device(cfg, shape, mesh)
    for key, name in (("params", "params"), ("caches", "cache")):
        total = sum(math.prod(local[key][p]) * s.dtype.itemsize
                    for p, s in leaves_with_paths(specs[key]))
        assert total == floor[name], (key, total, floor[name])
