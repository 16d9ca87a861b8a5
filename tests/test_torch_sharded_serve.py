"""The sharded serving body (``launch/steps.jit_cell``'s ``"sharded"``
layout for the prefill and decode cells of the four dense decoders,
laid out as the reference's step under ``SERVE_RULES``: heads, ffn and
vocab over "model", the KV cache's length over "model" and written in
place, a decode step merged across the length blocks) on the CPU.

At world sizes 2 and 4 (gloo processes, ``_torch_spmd.sharded_serve``,
one spawn a world size) every (mesh, arch, case) of
``_torch_spmd.MESHES`` x ``DENSE`` x ``SERVE_CASES`` is held against the
unsharded ``make_prefill_step`` / ``make_decode_step`` on the same
inputs, and every case but "memory" also against the JAX package's
``prefill`` / ``decode_step`` (rank 0's whole logits and caches, saved
by the job): the logits and every float32 cache leaf within rtol 1e-5
of its max, each rank's caches its blocks; a bf16 cache leaf by
``_torch_spmd.bf16_close``, each element the bf16 rounding of a value
within 1e-5 of the leaf's max of the float32 K/V the unsharded step
wrote (bit-equal away from a rounding midpoint), at most
``BF16_OFF`` elements differing.  Decode runs at a position in the first
block, at the last row of a block and the first of the next, and in the
last block, so reduced gemma3-1b's window of 8 straddles two blocks on
(1, 4) and some blocks lie wholly past the position or before the
window.  The "memory" case: each rank holds its blocks of the weights
and caches, writes its cache in place (no restack, no tensor of the
cache's whole length or the whole table), and an out-of-place writer
fails that check.  The weights are at the d_model fan-in law: at the
reference's law reduced gemma3-1b's float32 prefill is chaotic enough
that the port and the JAX package miss each other's rtol 1e-5 unsharded
(``_torch_spmd._serve_params``).

Without processes: ``steps.layout`` over the production matrix and the
test meshes, the ranks' blocks at full width on (16, 16), the
log-sum-exp output of ``decode_attention``'s plain version against the
JAX package's Pallas kernel and the reference's scores, its merge over
2 and 4 length blocks (with a block of length 0 and a window across two
blocks) against one call over the whole cache with the planted wrong
merges of ``ref.decode_merge_faults`` missing, and the sharded cells at
world size 1 against the reference's ``prefill`` / ``decode_step`` (on
the reference's own weights).
"""
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_spmd
from _torch_spmd import (DENSE, MESHES, SERVE_CASES, bf16_close,
                         bf16_witness, serve_positions)
from repro.configs import get_reduced as jget_reduced
from repro.kernels import ops as jops
from repro.models import RunFlags as JRunFlags
from repro.models import build_cache_specs as jbuild_cache_specs
from repro.models import build_param_specs as jbuild_param_specs
from repro.models import decode_step as jdecode_step
from repro.models import materialize as jmaterialize
from repro.models import prefill as jprefill
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.distributed.sharding import entry_axes
from repro_torch.kernels import ref
from repro_torch.launch import steps
from repro_torch.launch.analytic import analytic_bytes_per_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import (SHAPES, ShapeSpec, input_shardings,
                                      input_specs, jit_cell)
from repro_torch.models import RunFlags, materialize
from repro_torch.models.params import leaves_with_paths, tree_map

CASES = [(world, data, model, arch, case)
         for world in sorted(MESHES) for data, model in MESHES[world]
         for arch in DENSE for case in SERVE_CASES]
SERVING = ("prefill_32k", "decode_32k")


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
    """world -> (the job's folder, each rank's outcome a case), the job
    run once a world."""
    done = {}

    def get(world):
        if world not in done:
            tmp = tmp_path_factory.mktemp(f"sharded_serve_{world}")
            _torch_spmd.spawn("sharded_serve", world, tmp, timeout=300)
            done[world] = tmp, [json.loads((tmp / f"sharded_serve.{r}.json")
                                           .read_text())
                                for r in range(world)]
        return done[world]
    return get


@pytest.mark.parametrize(
    "world,data,model,arch,case", CASES,
    ids=[f"{d}x{m}-{a}-{c}" for _, d, m, a, c in CASES])
def test_sharded_serving_matches_the_unsharded_steps(runs, world, data,
                                                     model, arch, case):
    name = f"{data}x{model}-{arch}-{case}"
    for rank, res in enumerate(runs(world)[1]):
        assert res[name] == "ok", (rank, res[name])


_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(_JNP[t.dtype])


@functools.lru_cache(maxsize=None)
def _reference_serving(arch, prefill, bf16, pos):
    """The JAX package's ``prefill`` / ``decode_step`` on a case's inputs
    (``_torch_spmd.serve_inputs``): the logits and {path: cache leaf},
    float32 numpy."""
    _, _, params, first, caches, _ = _torch_spmd.serve_inputs(
        arch, prefill, torch.bfloat16 if bf16 else torch.float32, pos)
    jcfg = jget_reduced(arch)
    jp, jc = tree_map(_jnp, params), tree_map(_jnp, caches)
    if prefill:
        logits, out = jprefill(jp, {"tokens": jnp.asarray(
            first["tokens"].numpy())}, jc, jcfg, JRunFlags())
    else:
        logits, out = jdecode_step(jp, jnp.asarray(first.numpy()), jc, pos,
                                   jcfg, JRunFlags())
    return np.asarray(logits, np.float32), {
        jax.tree_util.keystr(k): np.asarray(v.astype(jnp.float32))
        for k, v in jax.tree_util.tree_flatten_with_path(out)[0]}


SERVED = [c for c in CASES if c[-1] != "memory"]


@pytest.mark.parametrize(
    "world,data,model,arch,case", SERVED,
    ids=[f"{d}x{m}-{a}-{c}" for _, d, m, a, c in SERVED])
def test_sharded_serving_matches_the_jax_reference(runs, world, data, model,
                                                   arch, case):
    """Each gloo case's whole logits and caches (rank 0's, saved by the
    job) against the JAX package's ``prefill`` / ``decode_step`` on the
    same weights, tokens and caches (its own ``jit_cell`` serving cells
    raise under JAX 0.9: ROADMAP.md, "Reference failures"): the logits
    and float32 caches within rtol 1e-5 of each leaf's max, bf16 caches
    by ``_torch_spmd.bf16_close`` against the unsharded port's float32
    K/V."""
    name = f"{data}x{model}-{arch}-{case}"
    tmp, res = runs(world)
    assert all(r[name] == "ok" for r in res), name
    got = torch.load(tmp / f"serve.{name}.pt")
    prefill = case.startswith("prefill")
    pos = None if prefill else serve_positions(model)[case]
    jlog, jcaches = _reference_serving(arch, prefill, case.endswith("bf16"),
                                       pos)
    _torch_spmd._close(got["logits"], torch.from_numpy(jlog.copy()),
                       f"{name} logits")
    assert set(got["caches"]) == set(jcaches), name
    for path, g in got["caches"].items():
        w = torch.from_numpy(jcaches[path].copy())
        if got["wide"] is None:
            _torch_spmd._close(g, w, f"{name} cache{path}")
        else:
            bf16_close(g, w.bfloat16(), got["wide"][path],
                       f"{name} cache{path}")


def test_layout_of_the_serving_cells():
    """The dense decoders' prefill_32k and decode_32k cells are sharded
    on both production meshes and on the test meshes, and so are
    mixtral-8x22b's (``tests/test_torch_sharded_moe.py``); long_500k
    (its length over ("data", "model")), an int8 cache and every other
    arch's serving cells are gathered; so is a cell whose cache length
    does not split over "model"."""
    int8 = RunFlags(cache_dtype="int8")
    for arch in ARCHS:
        cfg = get_config(arch)
        for mesh in (SINGLE, MULTI):
            for sname, shape in SHAPES.items():
                if shape.kind == "train":
                    continue
                want = "sharded" if arch in DENSE + ("mixtral-8x22b",) \
                    and sname in SERVING else "gathered"
                assert steps.layout(cfg, shape, mesh) == want, (arch, sname)
                assert steps.layout(cfg, shape, mesh, int8) == "gathered"
    for arch in DENSE:
        cfg = get_reduced(arch)
        for data, model in (m for ms in MESHES.values() for m in ms):
            mesh = FakeMesh({"data": data, "model": model})
            for shape in (ShapeSpec("p", "prefill", 16, 4),
                          ShapeSpec("d", "decode", 32, 4)):
                assert steps.layout(cfg, shape, mesh) == "sharded"
        odd = ShapeSpec("d", "decode", 30, 4)
        assert steps.layout(cfg, odd, FakeMesh({"data": 1, "model": 4})) \
            == "gathered"
        assert steps.layout(cfg, odd, FakeMesh({"data": 2, "model": 1})) \
            == "sharded"


# rank (0, 0)'s blocks on (16, 16) at decode_32k: wq's and wk's last two
# dims, the ffn, the vocab rows of the table (and head), the cache
LOCAL = {
    "granite-20b": ((3, 128), (1, 8), 1536, 3072, (8, 2048, 1, 128)),
    "command-r-35b": ((4, 128), (8, 8), 1408, 16000, (8, 2048, 8, 128)),
    "qwen2-5-7b": ((28, 8), (4, 8), 1184, 9504, (8, 2048, 4, 128)),
    "gemma3-1b": ((4, 16), (1, 16), 432, 16384, (8, 2048, 1, 256)),
}


def _local(spec, sh, mesh):
    shape = list(spec.shape)
    for dim, entry in enumerate(sh.spec):
        for a in entry_axes(entry):
            shape[dim] //= mesh.shape[a]
    return torch.empty(shape, dtype=spec.dtype, device="meta")


@pytest.mark.parametrize("arch", DENSE)
def test_local_blocks_at_full_width(arch):
    """Each rank's blocks of decode_32k at full width on (16, 16), as meta
    tensors: the query heads split over "model" where they divide 16
    (granite's 48, command-r's 64), else the head dim (qwen's 28,
    gemma3's 4); K/V by head dim (their heads do not divide 16); ffn and
    vocab split; the cache 8 rows x 2,048 of the length.  The rank's
    bytes are the analytic floor's params and cache."""
    cfg, shape = get_config(arch), SHAPES["decode_32k"]
    specs, sh = input_specs(cfg, shape), input_shardings(cfg, shape, SINGLE)
    local = {"params": {}, "caches": {}}
    for key in local:
        for (path, s), (_, h) in zip(leaves_with_paths(specs[key]),
                                     leaves_with_paths(sh[key])):
            local[key][path] = _local(s, h, SINGLE)
    p, c = local["params"], local["caches"]
    attn = "['groups']['main']['pos0']['attn']"
    ffn = "['groups']['main']['pos0']['ffn']"
    wq, wk, f, vocab, cache = LOCAL[arch]
    assert tuple(p[attn + "['wq']"].shape[2:]) == wq
    assert tuple(p[attn + "['wk']"].shape[2:]) == wk
    assert tuple(p[attn + "['wo']"].shape[1:3]) == wq
    assert p[ffn + "['wi_gate']"].shape[-1] == f
    assert p[ffn + "['wo']"].shape[1] == f
    assert p["['embed']['table']"].shape[0] == vocab
    assert all(tuple(t.shape[1:]) == cache for t in c.values())
    floor = analytic_bytes_per_device(cfg, shape, SINGLE)
    for key, name in (("params", "params"), ("caches", "cache")):
        assert sum(t.numel() * t.element_size()
                   for t in local[key].values()) == floor[name]


def _blocks_inputs(b, h, hkv, t, d, dtype, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, h, d), (b, hkv, t, d), (b, hkv, t, d)))
    return q * scale, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lse_output_matches_pallas_and_the_reference_scores(dtype):
    """``ops.decode_attention(..., lse=True)`` on the CPU (the plain
    version) against the JAX package's Pallas kernel in interpret mode
    (the output: 2e-3 float32, 2e-2 bf16) and the log-sum-exp of the
    reference's scaled scores (jnp, float32: 1e-5 relative), over ragged
    rows: the whole cache, one key, none (output 0, log-sum-exp -inf)."""
    from repro_torch.kernels import ops
    b, h, hkv, t, d = 3, 8, 2, 96, 32
    q, k, v = _blocks_inputs(b, h, hkv, t, d, dtype, 0, 2.0)
    lengths = np.array([t, 1, 0], np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    want = np.asarray(jops.decode_attention(jq, jk, jv,
                                            jnp.asarray(lengths)),
                      np.float32)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .to(tdt) for x in (jq, jk, jv))
    out, lse = ops.decode_attention(tq, tk, tv, torch.from_numpy(lengths),
                                    lse=True)
    tol = 2e-3 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.float().numpy(), want, atol=tol,
                               rtol=tol)
    kk = jnp.repeat(jk.astype(jnp.float32), h // hkv, axis=1)
    scores = jnp.einsum("bhd,bhtd->bht", jq.astype(jnp.float32), kk) / \
        math.sqrt(d)
    valid = jnp.arange(t)[None, None] < jnp.asarray(lengths)[:, None, None]
    jlse = np.asarray(jax.nn.logsumexp(jnp.where(valid, scores, -jnp.inf),
                                       axis=-1))
    assert lse.dtype == torch.float32
    assert bool(torch.isneginf(lse[2]).all()) and np.isneginf(jlse[2]).all()
    np.testing.assert_allclose(lse[:2].numpy(), jlse[:2], rtol=1e-5)
    assert not out[2].any()


def _cut(t, n):
    """[lo, hi) of ``n`` equal length blocks of ``t`` rows."""
    return [(i * t // n, (i + 1) * t // n) for i in range(n)]


@pytest.mark.parametrize("blocks", [2, 4])
@pytest.mark.parametrize("softcap", [None, 5.0])
@pytest.mark.parametrize("window", [None, 20])
def test_lse_merge_equals_one_call(blocks, softcap, window):
    """A one-token decode over a cache of 128 rows cut into ``blocks``
    length blocks, each block's rows the token may see (it sits at row
    75) run alone with its log-sum-exp and merged (``ref.decode_merge``,
    as the serving body merges the ranks'), against one call over the
    visible rows: within 2e-6 (float32).  At 4 blocks the last lies
    wholly past the token (length 0); a window of 20 (rows 56-75)
    crosses two blocks, and at 4 the first lies wholly before it.  The
    planted wrong merges (``ref.decode_merge_faults``) miss by at least
    10x the tolerance (queries x4: a peaked softmax, so the blocks'
    weights differ)."""
    from repro_torch.kernels import ops
    b, h, hkv, t, d, pos = 2, 8, 2, 128, 32, 75
    q, k, v = (torch.from_numpy(x) for x in
               _blocks_inputs(b, h, hkv, t, d, "float32", 1, 4.0))
    first = 0 if window is None else pos + 1 - window
    kw = {} if softcap is None else {"softcap": softcap}
    want = ops.decode_attention(q, k[:, :, first:pos + 1],
                                v[:, :, first:pos + 1], pos + 1 - first,
                                **kw)
    outs, lses, ks, ns = [], [], [], []
    for lo, hi in _cut(t, blocks):
        a, n = max(lo, first), min(hi, pos + 1) - max(lo, first)
        start = min(a, hi - 1)
        kb = k[:, :, start:start + max(n, 1)]
        out, lse = ops.decode_attention(q, kb, v[:, :, start:start +
                                                 max(n, 1)],
                                        max(n, 0), lse=True, **kw)
        outs.append(out), lses.append(lse), ks.append(kb)
        ns.append(max(n, 0))
    if blocks == 4:
        assert ns[3] == 0 and (window is None or ns[0] == 0)
    if window is not None:
        assert sum(n > 0 for n in ns) == 2
    outs, lses = torch.stack(outs), torch.stack(lses)
    got = ref.decode_merge(outs, lses, q.dtype)
    tol = 2e-6
    err = float((got - want).abs().max())
    assert err <= tol, err
    for name, bad in ref.decode_merge_faults(q, ks, outs, lses, ns,
                                             softcap=softcap).items():
        miss = float((bad - want).abs().max())
        assert miss > 10 * tol, (name, miss)


@pytest.fixture
def gloo1():
    """A one-rank gloo group over an in-process store, torn down after."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_host_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_sharded_serving_matches_reference_model(gloo1):
    """Reduced gemma3-1b (windows, tied embeddings) at world size 1: the
    port's sharded prefill and decode cells against the reference's
    ``prefill`` / ``decode_step`` on the same carried-over weights and
    tokens: the logits within rtol 1e-5 of their max, the bf16 caches by
    ``_torch_spmd.bf16_close`` against the float32 K/V of the port's
    unsharded step, the decode (from the port's prefill caches on both
    sides) at row 12 of 16, where the window of 8 reaches back to row
    5."""
    arch = "gemma3-1b"
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    pre = ShapeSpec("p", "prefill", 16, 2)
    dec = ShapeSpec("d", "decode", 16, 2)
    assert steps.layout(cfg, pre, gloo1) == steps.layout(cfg, dec, gloo1) \
        == "sharded"
    jparams = jax.tree_util.tree_map(np.asarray, jmaterialize(
        jbuild_param_specs(jcfg), jax.random.PRNGKey(0)))
    params = params_from_numpy(cfg, jparams, "cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    rng = np.random.default_rng(7)
    tok = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jcaches = jmaterialize(jbuild_cache_specs(jcfg, 2, 16),
                           jax.random.PRNGKey(1))
    jlog, jcaches = jprefill(jparams, {"tokens": jnp.asarray(tok)},
                             jcaches, jcfg, JRunFlags())
    caches = materialize(input_specs(cfg, pre)["caches"],
                         torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.from_numpy(tok)}
    wide = _wide(steps.make_prefill_step(cfg), params, batch, caches)
    logits, caches = jit_cell(cfg, pre, gloo1)[0](params, batch, caches)
    _agree(logits.full_tensor(), jlog, caches, jcaches, wide)
    # the decode from the port's caches on both sides (the reference's
    # may hold an element rounded the other way)
    nxt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32))
    caches = tree_map(lambda c: c.full_tensor(), caches)
    jlog, jcaches = jdecode_step(jparams, jnp.asarray(nxt.numpy()),
                                 tree_map(_jnp, caches), 12, jcfg,
                                 JRunFlags())
    wide = _wide(steps.make_decode_step(cfg), params, nxt, caches, 12)
    logits, caches = jit_cell(cfg, dec, gloo1)[0](params, nxt, caches, 12)
    _agree(logits.full_tensor(), jlog, caches, jcaches, wide)


def _wide(step, params, first, caches, *rest):
    """The float32 K/V the unsharded ``step`` writes into ``caches``."""
    _, want = step(params, first, tree_map(torch.clone, caches), *rest)
    return dict(leaves_with_paths(bf16_witness(step, params, first, caches,
                                               want, *rest)))


def _agree(logits, jlog, caches, jcaches, wide):
    want = np.asarray(jlog, np.float32)
    err = float(np.abs(logits.float().numpy() - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), err
    jleaves = {jax.tree_util.keystr(k): v for k, v in
               jax.tree_util.tree_flatten_with_path(
                   jax.device_get(jcaches))[0]}
    for path, c in leaves_with_paths(caches):
        w = torch.from_numpy(np.asarray(jleaves[path].astype(jnp.float32)))
        bf16_close(c.full_tensor(), w.bfloat16(), wide[path], path)
