"""The port's dry run (``launch/{traceanalysis,dryrun,dryrun_pipeline}``)
on the CPU, at reduced sizes.

A trace of a cell on a fake process group (``device="cpu"``: the plain
versions, as a CPU run takes them) is held against a real run of the
same cell on gloo processes (``_spawn``): rank 0's aten FLOPs, its
collectives (counts and operand bytes) and, exactly, its peak of live
storage as ``MemTracker`` counts it on the real run.  A trace of the
card's program (``device="cuda"``) predicts the kernel launches and
routes ``chip_smoke.py``'s phase 22 counts on the card, with the fake
branch of each kernel wrapper taking the route a real tensor of its
shape would.  This module imports no JAX, so the gloo processes it
spawns start with torch alone; the parity with the reference's
arithmetic is ``tests/test_torch_analytic.py``.
"""
import dataclasses
import json
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

import chip_smoke
from _torch_spmd import WHISPER, reduced
from repro_torch.configs import get_config, get_reduced
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import Mesh
from repro_torch.kernels import decode_attention as dmod
from repro_torch.kernels import flash_attention as fmod
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rmod
from repro_torch.launch import dryrun, dryrun_pipeline, traceanalysis
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.steps import (ShapeSpec, input_shardings,
                                      input_specs, jit_cell)
from repro_torch.models import ScanGroup, materialize
from repro_torch.models.params import tree_leaves, tree_map

# the cells held against a real run: reduced granite-20b on {data: 2,
# model: 2}, batch over data (its train cell sharded: FSDP, its 4 heads
# over "model", the residual split by sequence; its prefill and decode
# cells sharded as SERVE_RULES lay them out: heads, ffn and vocab over
# "model", the cache's length over "model", written in place), and two more train
# cells of the sharded layout on {data: 1, model: 4}: gemma3-1b (2
# heads, replicated; tied embeddings; windows) and command-r-35b (2 K/V
# heads replicated under 4 split query heads) and internvl2-26b (4
# prefix rows and 28 tokens: its residual re-blocked from the tokens'
# blocks and back by all-to-alls); and two one-row decode
# cells of the long rules (LONG_SERVE_RULES: the cache's length over
# ("data", "model"), the partials merged by an all-gather over each) on
# {data: 2, model: 2}: gemma3-1b and Mixtral; and recurrentgemma-9b's four
# cells (its RG-LRU channels over "model", the gates' partial sums
# reduce-scattered by channel): train and decode on {data: 1, model: 4},
# prefill and the one-row decode on {data: 2, model: 2}; and whisper's
# three (``_torch_spmd.WHISPER``: 3 heads and 7 frames, which no "model"
# rank splits: every model rank runs the encoder on all frames, its ffn's
# partial sums all-reduced, and the cross-attention over all of them, its
# cache split by head dim): train and decode on {data: 1, model: 4},
# prefill on {data: 2, model: 2}
CELLS = {"train": ShapeSpec("tiny_train", "train", 32, 4),
         "prefill": ShapeSpec("tiny_prefill", "prefill", 16, 4),
         "decode": ShapeSpec("tiny_decode", "decode", 32, 4),
         "train_gemma3_1x4": ShapeSpec("tiny_train", "train", 32, 4),
         "train_command_r_1x4": ShapeSpec("tiny_train", "train", 32, 4),
         "train_internvl2_1x4": ShapeSpec("tiny_train", "train", 28, 4),
         "long_gemma3_2x2": ShapeSpec("tiny_long", "decode", 32, 1),
         "long_mixtral_2x2": ShapeSpec("tiny_long", "decode", 32, 1),
         "train_rg_1x4": ShapeSpec("tiny_train", "train", 32, 4),
         "prefill_rg_2x2": ShapeSpec("tiny_prefill", "prefill", 16, 4),
         "decode_rg_1x4": ShapeSpec("tiny_decode", "decode", 32, 4),
         "long_rg_2x2": ShapeSpec("tiny_long", "decode", 32, 1),
         "train_whisper_1x4": ShapeSpec("tiny_train", "train", 32, 4),
         "prefill_whisper_2x2": ShapeSpec("tiny_prefill", "prefill", 16, 4),
         "decode_whisper_1x4": ShapeSpec("tiny_decode", "decode", 32, 4)}
CELL_ARCH = {"train_gemma3_1x4": ("gemma3-1b", 1),
             "train_command_r_1x4": ("command-r-35b", 1),
             "train_internvl2_1x4": ("internvl2-26b", 1),
             "long_gemma3_2x2": ("gemma3-1b", 2),
             "long_mixtral_2x2": ("mixtral-8x22b", 2),
             "train_rg_1x4": ("recurrentgemma-9b", 1),
             "prefill_rg_2x2": ("recurrentgemma-9b", 2),
             "decode_rg_1x4": ("recurrentgemma-9b", 1),
             "long_rg_2x2": ("recurrentgemma-9b", 2),
             "train_whisper_1x4": (WHISPER, 1),
             "prefill_whisper_2x2": (WHISPER, 2),
             "decode_whisper_1x4": (WHISPER, 1)}
DECODE_POS = 20
WORLD = 4


def _cell(kind):
    """(reduced config, data axis size) of a cell of CELLS."""
    arch, data = CELL_ARCH.get(kind, ("granite-20b", 2))
    return reduced(arch), data


def _laid_out(x, sh):
    """``x`` laid out as ``sh``, each rank's block a storage of its own
    (as the dry run's inputs are)."""
    d = sharding.distribute(x, sh)
    return DTensor.from_local(d.to_local().clone(), sh.mesh.device_mesh,
                              sh.placements, run_check=False, shape=d.shape,
                              stride=d.stride())


def _real_cells(rank, world, out):
    """Rank ``rank``'s real run of CELLS; rank 0 writes its counts."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode
    res = {}
    for kind, shape in CELLS.items():
        cfg, data = _cell(kind)
        mesh = make_host_mesh(data=data, model=world // data,
                              device_type="cpu")
        specs = input_specs(cfg, shape)
        shards = input_shardings(cfg, shape, mesh)
        names = list(specs)
        full = [materialize(specs[n], torch.Generator().manual_seed(i), "cpu")
                for i, n in enumerate(names)]
        args = [tree_map(_laid_out, f, shards[n])
                for f, n in zip(full, names)]
        del full
        if shape.kind == "decode":
            args[-1] = DECODE_POS
        step, _ = jit_cell(cfg, shape, mesh)
        trace = traceanalysis._Trace(1)      # its collectives' bytes
        mt = MemTracker()
        mt.track_external(*[t for a in args if not isinstance(a, int)
                            for t in tree_leaves(a)])
        # the FLOP counter outermost: it runs an op that has a composite
        # kernel (silu_backward) through its decomposition, whose
        # temporaries a tracker below it would count and the step
        # without the counter does not make
        with FlopCounterMode(display=False) as fc, mt, \
                CommDebugMode() as cm, trace:
            step(*args)
        res[kind] = {"flops": fc.get_total_flops(),
                     "comm_debug": traceanalysis._comm_counts(cm),
                     "counts": {k: n for k, n in
                                trace.collectives.count_by_op.items() if n},
                     "bytes": {k: n for k, n in
                               trace.collectives.bytes_by_op.items() if n},
                     "peak": mt.get_tracker_snapshot("peak")[
                         torch.device("cpu")]["Total"]}
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)


def _run(rank, world, store, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        _real_cells(rank, world, out)
    finally:
        dist.destroy_process_group()


def _spawn(tmp, timeout=300):
    """Run ``_real_cells`` on WORLD gloo processes over a ``FileStore``
    (no network); return rank 0's counts."""
    out = tmp / "real.json"
    ctx = mp.start_processes(_run, args=(WORLD, str(tmp / "store"), str(out)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"real cells not done after {timeout} s")
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def real_cells(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("real_cells"))


@pytest.fixture(scope="module")
def traced_cells():
    out = {}
    with dryrun.fake_group(WORLD):
        for kind, shape in CELLS.items():
            cfg, data = _cell(kind)
            mesh = make_host_mesh(data=data, model=WORLD // data,
                                  device_type="cpu")
            out[kind] = dryrun.trace_cell(cfg, shape, mesh, device="cpu",
                                          pos=DECODE_POS)
    return out


@pytest.mark.parametrize("kind", list(CELLS))
def test_trace_matches_a_real_gloo_run(kind, real_cells, traced_cells):
    """Exact: rank 0's aten FLOPs, collective counts (equal to
    CommDebugMode's on the real run) and operand bytes, and the peak of
    live storage against MemTracker's on the real run."""
    got, real = traced_cells[kind], real_cells[kind]
    assert got["aten_flops"] == real["flops"] > 0
    counts = {k: n for k, n in got["collective_counts"].items() if n}
    assert counts == real["counts"] == real["comm_debug"]
    assert {k: n for k, n in got["collective_detail"].items() if n} == \
        real["bytes"]
    assert got["peak_device_bytes"] == got["peak_bytes"] == real["peak"]
    assert got["kernel_launches"] == {}          # the plain versions
    assert got["layout"] == "sharded"
    assert counts["all-gather"] > 0
    if kind.startswith("train"):
        # the FSDP gathers' gradients return by reduce-scatters
        assert counts["reduce-scatter"] > 0
        # a VLM's residual re-blocked in and out, each way in the
        # backward too
        assert counts.get("all-to-all", 0) == (
            4 if "internvl2" in kind else 0), counts
    else:
        # the row-parallel products' partial sums; an RG-LRU layer's two
        # gates' partial sums reduce-scattered by channel
        cfg, data = _cell(kind)
        assert counts["all-reduce"] > 0
        assert counts.get("reduce-scatter", 0) == 2 * _rglru_layers(cfg)


def _rglru_layers(cfg):
    from repro_torch.models import Mixer
    return sum(g.repeats for g in cfg.groups for b in g.pattern
               if b.mixer == Mixer.RGLRU)


# -- the card's program: launches and routes ---------------------------------

def _phase22_cfg(arch, dtype):
    """A reduced config whose attention takes the card's tensor-core
    routes (head dim 32), in ``dtype``."""
    return dataclasses.replace(get_reduced(arch), head_dim=32,
                               param_dtype=dtype, compute_dtype=dtype)


def _card_trace(cfg, shape, **kw):
    with dryrun.fake_group(1):
        mesh = make_host_mesh(device_type="cpu")
        return dryrun.trace_cell(cfg, shape, mesh, device="cuda", **kw)


def test_card_trace_predicts_phase22_launches_qwen():
    """Phase 22's counts a cell at 2 layers: 4 f32tc forwards and 2
    backward kernels a float32 train step (forward and remat
    recompute), 2 sm90 flash launches a bf16 prefill, 2 decode launches
    on the plan's route a bf16 decode."""
    f32 = _phase22_cfg("qwen2-5-7b", torch.float32)
    bf16 = _phase22_cfg("qwen2-5-7b", torch.bfloat16)
    train = _card_trace(f32, ShapeSpec("t", "train", 128, 2))
    assert train["kernel_launches"] == {"flash_attention": 4,
                                        "flash_attention_bwd": 2}
    assert train["kernel_routes"]["flash_attention"] == {"f32tc": 4}
    pre = _card_trace(bf16, ShapeSpec("p", "prefill", 64, 2))
    assert pre["kernel_launches"] == {"flash_attention": 2}
    assert pre["kernel_routes"]["flash_attention"] == {"sm90": 2}
    dec = _card_trace(bf16, ShapeSpec("d", "decode", 128, 2), pos=64)
    way = "split" if dmod.plan(2, bf16.n_heads, bf16.n_kv_heads, 65, 32,
                               dmod.FAKE_SMS).splits > 1 else "single"
    assert dec["kernel_launches"] == {"decode_attention": 2}
    assert dec["kernel_routes"]["decode_attention"] == {way: 2}
    # the kernels' work is in the totals, beside the aten FLOPs
    for out in (train, pre, dec):
        k = sum(w["operations"] for w in out["kernel_work"].values())
        assert k > 0 and out["flops_per_device"] == out["aten_flops"] + k


def test_card_trace_predicts_recurrentgemma_launches():
    """RecurrentGemma (2 RG-LRU + 1 local attention, then 2 RG-LRU):
    a float32 train step launches the scan 3 times an RG-LRU layer
    (forward, recompute, backward), the attention 2 f32tc forwards and 1
    backward; a bf16 prefill of 64 tokens takes the chunked scan, a
    decode step the serial one."""
    f32 = _phase22_cfg("recurrentgemma-9b", torch.float32)
    bf16 = _phase22_cfg("recurrentgemma-9b", torch.bfloat16)
    train = _card_trace(f32, ShapeSpec("t", "train", 32, 2))
    assert train["kernel_launches"] == {"flash_attention": 2,
                                        "flash_attention_bwd": 1,
                                        "rglru_scan": 12}
    assert train["kernel_routes"]["rglru_scan"] == {"serial": 12}
    pre = _card_trace(bf16, ShapeSpec("p", "prefill", 64, 2))
    assert pre["kernel_launches"] == {"flash_attention": 1,
                                      "rglru_scan": 4}
    assert pre["kernel_routes"] == {"flash_attention": {"sm90": 1},
                                    "decode_attention": {},
                                    "rglru_scan": {"chunked": 4}}
    dec = _card_trace(bf16, ShapeSpec("d", "decode", 64, 2), pos=40)
    assert dec["kernel_launches"] == {"decode_attention": 1,
                                      "rglru_scan": 4}
    assert dec["kernel_routes"]["rglru_scan"] == {"serial": 4}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_trace_predicts_sharded_recurrentgemma_launches(dtype):
    """Reduced RecurrentGemma's sharded cells on a fake {data: 1, model:
    4} group (its 64 RG-LRU channels 16 a rank): per mixer, the
    attention layer 2 flash launches a train step (forward and remat
    recompute; in float32 also 1 backward kernel, the f32tc route, in
    bf16 the sm90 route and the plain recompute), 1 a prefill, 1 decode
    a decode step; each of the 4 RG-LRU layers the scan on the rank's
    [rows, S, 16] on the route S picks: 3 a train step (forward,
    recompute, backward; S = 32, serial), 1 a prefill of 64 tokens
    (chunked), 1 a decode step (serial); and two reduce-scatters by
    channel a layer and pass (the gates), none else in serving."""
    cfg = _phase22_cfg("recurrentgemma-9b", dtype)
    n = _rglru_layers(cfg)
    flash = "f32tc" if dtype == torch.float32 else "sm90"
    with dryrun.fake_group(WORLD):
        mesh = make_host_mesh(data=1, model=WORLD, device_type="cpu")
        train = dryrun.trace_cell(cfg, ShapeSpec("t", "train", 32, 4), mesh,
                                  device="cuda")
        pre = dryrun.trace_cell(cfg, ShapeSpec("p", "prefill", 64, 4), mesh,
                                device="cuda")
        dec = dryrun.trace_cell(cfg, ShapeSpec("d", "decode", 64, 4), mesh,
                                device="cuda", pos=40)
    for out in (train, pre, dec):
        assert out["layout"] == "sharded"
    assert train["kernel_launches"] == {
        "flash_attention": 2, "rglru_scan": 3 * n,
        **({"flash_attention_bwd": 1} if dtype == torch.float32 else {})}
    assert train["kernel_routes"]["flash_attention"] == {flash: 2}
    assert train["kernel_routes"]["rglru_scan"] == {"serial": 3 * n}
    assert pre["kernel_launches"] == {"flash_attention": 1,
                                      "rglru_scan": n}
    assert pre["kernel_routes"]["rglru_scan"] == {"chunked": n}
    assert pre["kernel_routes"]["flash_attention"] == {flash: 1}
    assert dec["kernel_launches"] == {"decode_attention": 1,
                                      "rglru_scan": n}
    assert dec["kernel_routes"]["rglru_scan"] == {"serial": n}
    for out in (pre, dec):
        assert out["collective_counts"]["reduce-scatter"] == 2 * n
    work = rmod.work(4, 64, 64 // WORLD)        # float32 gates
    assert pre["kernel_work"]["rglru_scan"]["bytes"] == n * work[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_trace_predicts_sharded_whisper_launches(dtype):
    """``_torch_spmd.WHISPER`` at head dim 32 (the card's tensor-core
    routes; 8 of its dims a rank) on a fake {data: 1, model: 4} group:
    per layer, the encoder's attention (non-causal over the 7 frames),
    the decoder's self-attention and its cross-attention (its rows
    against the frames) each 2 flash launches a train step (forward and
    remat recompute; in float32 each also 1 backward kernel, the f32tc
    route) and 1 a prefill; a decode step 1 decode of the self block and
    1 of the cross-attention over all 7 frames a decoder layer; a decode
    step's all-gathers a decoder layer: the 8 projections split by head
    dim (the self- and cross-attention's ``wq``, ``wk``, ``wv``, ``wo``)
    gathered whole, the self blocks' partials merged, and the cross
    cache's K and V gathered whole over their head dim."""
    cfg = dataclasses.replace(reduced(WHISPER), head_dim=32,
                              param_dtype=dtype, compute_dtype=dtype)
    enc, dec = cfg.encoder.n_layers, cfg.n_layers
    flash = "f32tc" if dtype == torch.float32 else "sm90"
    with dryrun.fake_group(WORLD):
        mesh = make_host_mesh(data=1, model=WORLD, device_type="cpu")
        train = dryrun.trace_cell(cfg, ShapeSpec("t", "train", 32, 4), mesh,
                                  device="cuda")
        pre = dryrun.trace_cell(cfg, ShapeSpec("p", "prefill", 64, 4), mesh,
                                device="cuda")
        dec_out = dryrun.trace_cell(cfg, ShapeSpec("d", "decode", 64, 4),
                                    mesh, device="cuda", pos=40)
    for out in (train, pre, dec_out):
        assert out["layout"] == "sharded"
    n = enc + 2 * dec
    assert train["kernel_launches"] == {
        "flash_attention": 2 * n,
        **({"flash_attention_bwd": n} if dtype == torch.float32 else {})}
    assert train["kernel_routes"]["flash_attention"] == {flash: 2 * n}
    assert pre["kernel_launches"] == {"flash_attention": n}
    assert pre["kernel_routes"]["flash_attention"] == {flash: n}
    assert dec_out["kernel_launches"] == {"decode_attention": 2 * dec}
    assert dec_out["collective_counts"]["all-gather"] == (8 + 1 + 2) * dec


def _depth(cfg, n):
    return dataclasses.replace(cfg, n_layers=n, groups=(
        ScanGroup("main", n, cfg.groups[0].pattern),))


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_flops_are_linear_in_the_layers(device):
    """The layer stack needs no extrapolation: every layer is traced, so
    the FLOPs and launches grow by the same amount a layer (L, 2L, 3L).  (The
    bytes grow faster: the gradient of each layer's slice of a stacked
    parameter is a zero-filled gradient of the whole stack.)"""
    cfg = _phase22_cfg("granite-20b", torch.float32)
    shape = ShapeSpec("t", "train", 64, 2)
    with dryrun.fake_group(1):
        mesh = make_host_mesh(device_type="cpu")
        outs = [dryrun.trace_cell(_depth(cfg, n), shape, mesh,
                                  device=device) for n in (2, 4, 6)]
    for k in ("flops_per_device", "aten_flops"):
        a, b, c = (o[k] for o in outs)
        assert b - a == c - b > 0, k
    a, b, c = (o["bytes_per_device"] for o in outs)
    assert c - b > b - a > 0
    if device == "cuda":
        assert [o["kernel_launches"]["flash_attention"] for o in outs] == \
            [4, 8, 12]


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_stepped_recurrence_extrapolates_exactly(kind, monkeypatch):
    """xLSTM steps its recurrences token by token in Python, so its train
    and prefill cells are traced at three lengths and carried to the
    cell's: the FLOPs, bytes and collectives of reduced xLSTM at 40
    tokens from traces at 8, 16 and 24 equal a trace at 40; the peak, a
    maximum over the step and not a polynomial, is not reported."""
    cfg = get_reduced("xlstm-125m")
    shape = ShapeSpec("t", kind, 40, 4)
    monkeypatch.setattr(dryrun, "STEPPED_LENGTHS", (8, 16, 24))
    assert dryrun.steps_in_python(cfg, shape)
    assert not dryrun.steps_in_python(get_reduced("qwen2-5-7b"), shape)
    with dryrun.fake_group(WORLD):
        mesh = make_host_mesh(data=2, model=WORLD // 2, device_type="cpu")
        got = dryrun.trace_cell(cfg, shape, mesh)
        want = dryrun._trace_once(cfg, shape, mesh, flags=dryrun.RunFlags(),
                                  device="cuda", pos=None, mesh_name="",
                                  tag="baseline")
    assert got["extrapolated_from"] == [8, 16, 24]
    assert got["peak_device_bytes"] is got["temp_bytes"] is None
    for k in ("flops_per_device", "aten_flops", "bytes_per_device",
              "collective_bytes_per_device", "collective_detail",
              "collective_counts", "model_flops_global", "compute_s",
              "useful_flops_ratio", "argument_bytes", "alias_bytes"):
        assert got[k] == want[k], k
    assert got["collective_counts"]["all-gather"] > 0


@pytest.mark.parametrize("multi", [False, True])
def test_production_meshes_trace_with_all_gathers(multi):
    """A reduced cell on the fake (16, 16) and (2, 16, 16) meshes at
    world sizes 256 and 512: the weights are gathered (TRAIN_RULES shard
    "embed" over data), the gradients summed over the batch's ranks."""
    cfg = get_reduced("granite-20b")
    shape = ShapeSpec("t", "train", 16, 64)
    with dryrun.fake_group(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        out = dryrun.trace_cell(cfg, shape, mesh, device="cuda",
                                mesh_name="multi" if multi else "single")
    assert out["n_devices"] == (512 if multi else 256)
    assert out["collective_counts"]["all-gather"] > 0
    assert out["collective_counts"]["all-reduce"] > 0
    assert out["collective_detail"]["all-gather"] > 0
    assert not dist.is_initialized()


def test_dryrun_pipeline_hands_off_between_stages():
    """Reduced granite's 2-stage GPipe (M = 2, then 4) on a fake
    (2, 1, 2) mesh: an all-to-all hand-off a schedule step and one back
    for each but the last, flash forwards and remat recomputes of one
    layer a stage each step, the loss broadcast from the last stage."""
    cfg = get_reduced("granite-20b")
    with dryrun.fake_group(4):
        mesh = Mesh(init_device_mesh("cpu", (2, 1, 2),
                                     mesh_dim_names=("pod", "data",
                                                     "model")))
        outs = [dryrun_pipeline.trace_pipeline(cfg, mesh, batch=4, seq=16,
                                               micro=m) for m in (2, 4)]
    for m, out in zip((2, 4), outs):
        steps = m + 1
        assert out["expected_handoffs"] == 2 * steps - 1
        assert out["collective_counts"]["all-to-all"] == 2 * steps - 1
        assert out["collective_counts"]["broadcast"] == 1
        assert out["kernel_launches"] == {"flash_attention": 2 * steps}


def test_run_cell_at_full_size_and_save_result(monkeypatch, tmp_path):
    """granite-20b x decode_32k on the fake (16, 16) mesh, traced through
    the card's routes in the sharded layout: one split decode launch a
    layer at the cache's last row (rank 0's block of 2,048 rows), its
    peak beside the card's 80 GB, below its 74.5 GiB and at least the
    rank's blocks of the weights and the cache
    (``analytic_bytes_per_device``); results go under
    ``build/dryrun_results/``, never ``benchmarks/``."""
    res = dryrun.run_cell("granite-20b", "decode_32k", "single",
                          verbose=False)
    cfg = get_config("granite-20b")
    assert res["status"] == "ok" and res["n_devices"] == 256
    assert res["layout"] == "sharded"
    resident = res["analytic_bytes"]["params"] + \
        res["analytic_bytes"]["cache"]
    assert resident <= res["peak_device_bytes"] < 74.5 * 2 ** 30
    assert res["kernel_launches"] == {"decode_attention": cfg.n_layers}
    assert res["kernel_routes"]["decode_attention"] == {
        "split": cfg.n_layers}
    assert res["hbm_bytes"] == 80e9
    assert res["fits"] == (res["peak_device_bytes"] <= 80e9)
    assert res["dominant_floor"] in ("compute", "memory", "collective")
    assert dryrun.RESULTS_DIR.parts[-2:] == ("build", "dryrun_results")
    assert "benchmarks" not in dryrun.RESULTS_DIR.parts
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path / "dryrun_results")
    path = dryrun.save_result(dict(res, tag="t"))
    assert path == tmp_path / "dryrun_results" / \
        "granite-20b_decode_32k_single_t.json"
    assert json.loads(path.read_text())["peak_device_bytes"] == \
        res["peak_device_bytes"]


@pytest.mark.parametrize("shape_name,want", [("train_4k", "sharded"),
                                             ("decode_32k", "sharded")])
def test_matrix_row_prints_the_layout(shape_name, want, monkeypatch,
                                      capsys):
    """A row of the matrix (``run_cell``, verbose) names the body its
    cell ran: reduced granite-20b at the production shapes on the fake
    (16, 16) mesh, the train cell sharded (16 rows x 256 tokens a rank,
    its FSDP gathers' gradients reduce-scattered), decode sharded (8
    rows and 2,048 cache rows a rank, the ranks' partial attention
    merged by an all-gather, no reduce-scatter)."""
    monkeypatch.setattr(dryrun, "get_config", get_reduced)
    res = dryrun.run_cell("granite-20b", shape_name, "single")
    assert res["status"] == "ok" and res["layout"] == want
    assert f"layout: {want} |" in capsys.readouterr().out
    rs = res["collective_counts"]["reduce-scatter"]
    assert rs > 0 if shape_name == "train_4k" else rs == 0


def test_skipped_cell_and_list(capsys):
    res = dryrun.run_cell("command-r-35b", "long_500k", "single")
    assert res["status"] == "skipped" and "full-attention" in res["reason"]
    assert dryrun.main(["--list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(dryrun.ASSIGNED) * 4
    assert sum("SKIP" in ln for ln in lines) == sum(
        not ok for _, _, ok, _ in dryrun.cell_matrix())


# -- the kernels' fake branch ------------------------------------------------

def test_a_real_tensor_takes_the_real_route():
    """Real CPU tensors take the plain versions, inside ``card_trace`` or
    not, and the raw wrappers still refuse them; nothing is counted."""
    ops.reset_launches()
    q = torch.randn(1, 4, 8, 32)
    k = v = torch.randn(1, 2, 8, 32)
    want = ops.flash_attention(q, k, v)
    with ops.card_trace():
        assert torch.equal(ops.flash_attention(q, k, v), want)
        ops.decode_attention(q[:, :, 0], k, v, 8)
        ops.rglru_scan(torch.rand(1, 8, 4), torch.rand(1, 8, 4),
                       torch.zeros(1, 4))
    for raw in (lambda: fmod.flash_attention(q, k, v),
                lambda: dmod.decode_attention(q[:, :, 0], k, v, 8),
                lambda: rmod.rglru_scan(torch.rand(1, 8, 4),
                                        torch.rand(1, 8, 4),
                                        torch.zeros(1, 4))):
        with pytest.raises(ValueError, match="CUDA device"):
            raw()
    assert not any(ops.launch_counts().values())
    assert not any(ops.fake_launch_counts().values())


def test_fake_branch_allocates_and_keeps_the_checks():
    """A fake launch gets every output and workspace a real one does (the
    f32tc log-sum-exp and its backward's outputs, decode's split
    partials through the plan of 132 SMs, the scan's scratch kept
    between launches), passes the shape and stride checks but not the
    base address, and is counted in ``FAKE`` only."""
    ops.reset_launches()
    with FakeTensorMode():
        q = torch.empty(2, 8, 64, 128)
        k = v = torch.empty(2, 2, 64, 128)
        out, lse = fmod.flash_attention_lse(q, k, v)
        assert out.shape == q.shape and lse.shape == (2, 8, 64)
        dq, dk, dv = fmod.flash_attention_bwd(q, k, v, out, lse, out)
        assert dk.shape == k.shape
        kb = vb = torch.empty(2, 2, 64, 128, dtype=torch.bfloat16)
        qb = torch.empty(2, 8, 64, 128, dtype=torch.bfloat16)
        assert fmod.flash_attention(qb, kb, vb).shape == qb.shape
        with pytest.raises(ValueError, match="unit-stride"):
            fmod.flash_attention(qb.transpose(-1, -2), kb, vb)
        with pytest.raises(ValueError, match="multiples of 8"):
            fmod.flash_attention(torch.empty(
                2, 8, 64, 130, dtype=torch.bfloat16)[..., :128], kb, vb)
        kc = torch.empty(4, 2, 4096, 128, dtype=torch.bfloat16)
        dec = dmod.decode_attention(torch.empty(4, 8, 128,
                                                dtype=torch.bfloat16),
                                    kc, kc, torch.full((4,), 4096))
        assert dec.shape == (4, 8, 128)
        a = torch.empty(2, 128, 64)
        rmod.rglru_scan(a, a, torch.empty(2, 64))
        first = rmod.FAKE.scratch
        rmod.rglru_scan(a, a, torch.empty(2, 64))
        assert rmod.FAKE.scratch is first and first.numel() == \
            rmod.scratch_words(2, 128, 64)
    assert ops.fake_launch_counts() == {"flash_attention": 2,
                                        "flash_attention_bwd": 1,
                                        "decode_attention": 1,
                                        "rglru_scan": 2}
    assert ops.fake_route_counts() == {"sm90": 1, "f32tc": 1, "simt": 0}
    assert ops.fake_route_counts("decode_attention")["split"] == \
        (dmod.plan(4, 8, 2, 4096, 128, 132).splits > 1)
    assert ops.fake_route_counts("rglru_scan") == {"chunked": 2,
                                                   "serial": 0}
    assert not any(ops.launch_counts().values())
    work = ops.fake_work()
    assert work["flash_attention"]["operations"] == \
        2 * fmod.work(2, 8, 2, 64, 64, 128)[0]
    assert work["rglru_scan"]["bytes"] == 2 * rmod.work(2, 128, 64)[1]
    ops.reset_launches()
    assert rmod.FAKE.scratch is None


def _pairs(s, t, window, q_offset):
    n = 0
    for i in range(s):
        x = q_offset + i + 1
        lo = max(0, x - window) if window else 0
        n += max(0, min(x, t) - lo)
    return n


@pytest.mark.parametrize("case", [
    (1, 28, 4, 2048, 2048, 128, None, True, 0),
    (1, 16, 1, 2048, 2048, 256, 2048, True, 0),
    (1, 4, 1, 2048, 2048, 256, 512, True, 0),
    (1, 28, 4, 3, 48, 128, None, True, 0),
    (1, 8, 8, 1500, 1500, 64, None, False, 0),
    (2, 28, 4, 1024, 4096, 128, None, True, 3072),
    (1, 4, 1, 384, 896, 256, 512, True, 512)])
def test_kernel_work_is_the_kernel_table_yardstick(case):
    """``work`` / ``bwd_work`` count what ``chip_smoke.py``'s bounds count
    (``_flash_work`` / ``_bwd_work``, the kernel table of PERF.md), at
    its timed shapes, and pairs by brute force at a query offset."""
    b, h, hkv, s, t, d, window, causal, off = case
    ops_, nbytes = fmod.work(b, h, hkv, s, t, d, causal=causal,
                             window=window, q_offset=off)
    pairs = _pairs(s, t, window, off) if causal else s * t
    assert ops_ == 4 * b * h * pairs * d
    if off == 0:
        assert (nbytes, ops_) == chip_smoke._flash_work(b, h, hkv, s, t, d,
                                                        window, causal)
        if causal and window is None and s == t:
            assert fmod.bwd_work(b, h, hkv, s, s, d) == \
                chip_smoke._bwd_work(b, h, hkv, s, d)[::-1]
    assert dmod.work(4, 28, 4, 4096, 128) == (
        4 * 4 * 28 * 4096 * 128,
        (2 * 4 * 28 * 128 + 2 * 4 * 4 * 4096 * 128) * 2)
    assert rmod.work(1, 2048, 4096) == (2 * 2048 * 4096,
                                        (3 * 2048 * 4096 + 4096) * 4)


def test_collective_stats_total():
    stats = traceanalysis.CollectiveStats({"all-gather": 3, "broadcast": 4},
                                          {"all-gather": 1, "broadcast": 1})
    assert stats.total_bytes == 7
