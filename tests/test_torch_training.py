"""The port's training substrate (``repro_torch.training``, ``.data``,
``.checkpoint``, ``launch/train``) on the CPU: every case of the
reference's ``tests/test_training.py`` on the port, and the port against
the JAX package.

Contract: AdamW minimizes a quadratic; the schedule's shape; the int8
residual within half a step (hypothesis, no deadline) and the
compressed sum within 0.2 of the true one; checkpoint round trip and
retention; 10 steps straight == 5 + 5 resumed (rtol 1e-5); the loss
descends with accumulation and compression; the data stream
deterministic and resumable.  Against the reference: ``lr_at`` and
``adamw_update`` on random trees (rtol 1e-6), ``compress_grads`` bit for
bit, ``SyntheticLMDataset.batch`` bit for bit, checkpoints restored
across packages bit for bit both ways with the manifests' ``paths``
identical; the launcher raises without CUDA unless ``--torch-device
cpu``.
"""
import contextlib
import io
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:      # optional extra: property tests skip, rest run
    from _hypothesis_shim import given, settings, st

from repro.checkpoint import restore_pytree as jrestore_pytree
from repro.checkpoint import save_pytree as jsave_pytree
from repro.data import SyntheticLMDataset as JSyntheticLMDataset
from repro.training.compression import compress_grads as jcompress_grads
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.optimizer import adamw_update as jadamw_update
from repro.training.optimizer import lr_at as jlr_at
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_pytree, save_pytree)
from repro_torch.configs import get_reduced
from repro_torch.data import DataCursor, SyntheticLMDataset
from repro_torch.launch import train as train_launch
from repro_torch.models import RunFlags
from repro_torch.models.params import leaves_with_paths
from repro_torch.training.compression import (compress_grads,
                                              init_error_state)
from repro_torch.training.optimizer import AdamWConfig, adamw_update, lr_at
from repro_torch.training.trainer import TrainConfig, train


def _quiet(s):
    return None


# -- the reference's cases, on the port -------------------------------------

def test_adamw_descends_quadratic():
    """AdamW minimizes a quadratic: ||p - target||^2."""
    target = torch.tensor([1.0, -2.0, 3.0])
    p = {"w": torch.zeros(3)}
    mu = {"w": torch.zeros(3)}
    nu = {"w": torch.zeros(3)}
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                      total_steps=10_000)
    for step in range(300):
        g = {"w": 2.0 * (p["w"] - target)}
        p, mu, nu, _ = adamw_update(p, g, mu, nu,
                                    torch.tensor(step, dtype=torch.int32),
                                    cfg)
    np.testing.assert_allclose(p["w"].numpy(), target.numpy(), atol=0.05)


def test_lr_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    step = lambda n: torch.tensor(n, dtype=torch.int32)   # noqa: E731
    assert float(lr_at(step(0), cfg)) == 0.0
    assert float(lr_at(step(10), cfg)) == pytest.approx(1.0, rel=1e-3)
    assert float(lr_at(step(100), cfg)) == pytest.approx(0.1, rel=1e-2)
    assert lr_at(step(50), cfg).dtype == torch.float32


@given(st.integers(0, 2 ** 31 - 1))
@settings(max_examples=20, deadline=None)
def test_compression_error_feedback_bounded(seed):
    """Quantization residual never exceeds half a quantization step."""
    g = {"a": torch.from_numpy(
        np.random.default_rng(seed).standard_normal(64).astype(np.float32)
        * 10.0)}
    e = init_error_state(g)
    _, e2 = compress_grads(g, e)
    scale = float(g["a"].abs().max()) / 127.0
    assert float(e2["a"].abs().max()) <= 0.5 * scale + 1e-6


def test_compression_error_feedback_unbiased_sum():
    """Over many steps, compressed updates track the true gradient sum."""
    rng = np.random.default_rng(0)
    true_sum = np.zeros(16)
    comp_sum = np.zeros(16)
    e = {"g": torch.zeros(16)}
    for _ in range(200):
        g = rng.normal(size=16).astype(np.float32)
        true_sum += g
        gq, e = compress_grads({"g": torch.from_numpy(g)}, e)
        comp_sum += gq["g"].numpy()
    assert np.max(np.abs(true_sum - comp_sum)) < 0.2


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor(7, dtype=torch.int32)}}
    save_pytree(tree, tmp_path, 3)
    assert latest_step(tmp_path) == 3
    out = restore_pytree(tree, tmp_path)
    assert torch.equal(out["a"], tree["a"])
    assert int(out["b"]["c"]) == 7 and out["b"]["c"].dtype == torch.int32


def test_checkpoint_manager_async_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = {"x": torch.ones(4)}
    for s in (1, 2, 3, 4):
        mgr.save_async(tree, s)
    mgr.close()
    steps = sorted(int(p.name.split("_")[1])
                   for p in pathlib.Path(tmp_path).glob("step_*"))
    assert steps == [3, 4]


def test_train_resume_bitexact(tmp_path):
    """Crash/restart fault tolerance: 10 straight steps == 5 + resume 5."""
    cfg = get_reduced("granite-20b")
    tc = lambda n, ck: TrainConfig(steps=n, batch_size=2,  # noqa: E731
                                   seq_len=32, checkpoint_dir=str(ck),
                                   checkpoint_every=5, log_every=100)
    h_full = train(cfg, tc(10, tmp_path / "full"), log_fn=_quiet,
                   device="cpu")
    train(cfg, tc(5, tmp_path / "resume"), log_fn=_quiet, device="cpu")
    h_resumed = train(cfg, tc(10, tmp_path / "resume"), log_fn=_quiet,
                      device="cpu")
    np.testing.assert_allclose(h_full["loss"][-1], h_resumed["loss"][-1],
                               rtol=1e-5)
    assert len(h_resumed["loss"]) == 5


def test_loss_descends_with_grad_accum_and_compression():
    cfg = get_reduced("qwen2-5-7b")
    opt = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=40)
    h = train(cfg, TrainConfig(steps=40, batch_size=4, seq_len=64,
                               grad_compression=True, opt=opt,
                               flags=RunFlags(grad_accum=2),
                               log_every=100), log_fn=_quiet, device="cpu")
    assert np.mean(h["loss"][-8:]) < np.mean(h["loss"][:8])


def test_data_pipeline_deterministic_and_resumable():
    ds = SyntheticLMDataset(vocab_size=128, seq_len=16, batch_size=2, seed=1)
    b5 = ds.batch(5)
    np.testing.assert_array_equal(b5["tokens"], ds.batch(5)["tokens"])
    # labels are next-token shifted
    full = np.concatenate([b5["tokens"][:, :1], b5["labels"]], axis=1)
    np.testing.assert_array_equal(b5["tokens"][:, 1:], full[:, 1:-1])
    # cursor resume yields the same stream
    cur = DataCursor(batch_index=7)
    it = ds.iterate(cur)
    first = next(it)
    np.testing.assert_array_equal(first["tokens"], ds.batch(7)["tokens"])


# -- against the reference --------------------------------------------------

def _random_tree(rng, scale=1.0):
    return {"b": rng.standard_normal((7,)).astype(np.float32) * scale,
            "a": {"w": rng.standard_normal((5, 3)).astype(np.float32)
                  * scale,
                  "v": rng.standard_normal((2, 2, 2)).astype(np.float32)
                  * scale}}


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    return fn(tree)


@pytest.mark.parametrize("warmup,total", [(0, 10), (10, 100), (100, 10)])
def test_lr_at_matches_reference(warmup, total):
    kw = dict(lr=3e-4, warmup_steps=warmup, total_steps=total)
    for step in range(0, 130, 7):
        want = float(jlr_at(jnp.int32(step), JAdamWConfig(**kw)))
        got = lr_at(torch.tensor(step, dtype=torch.int32), AdamWConfig(**kw))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_matches_reference(clip):
    """Five steps on random trees (dict keys out of order, so the global
    norm sums leaves in sorted order on both sides)."""
    rng = np.random.default_rng(0)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=clip)
    p = _random_tree(rng)
    jp, jm, jv = (_to(p, jnp.asarray),
                  _to(p, lambda a: jnp.zeros(a.shape, jnp.float32)),
                  _to(p, lambda a: jnp.zeros(a.shape, jnp.float32)))
    tp, tm, tv = (_to(p, torch.from_numpy),
                  _to(p, lambda a: torch.zeros(a.shape)),
                  _to(p, lambda a: torch.zeros(a.shape)))
    for step in range(5):
        g = _random_tree(rng, scale=3.0)
        jp, jm, jv, jn = jadamw_update(jp, _to(g, jnp.asarray), jm, jv,
                                       jnp.int32(step), JAdamWConfig(**kw))
        tp, tm, tv, tn = adamw_update(tp, _to(g, torch.from_numpy), tm, tv,
                                      torch.tensor(step, dtype=torch.int32),
                                      AdamWConfig(**kw))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for got, want in ((tp, jp), (tm, jm), (tv, jv)):
        for (path, t), (_, w) in zip(leaves_with_paths(got),
                                     leaves_with_paths(want)):
            np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-9, err_msg=path)


def test_adamw_update_writes_in_place():
    """The update lands in the trees given (the reference's donated
    buffers), and only there."""
    rng = np.random.default_rng(1)
    p, g = _random_tree(rng), _random_tree(rng)
    tp = _to(p, lambda a: torch.from_numpy(a.copy()))
    tg = _to(g, torch.from_numpy)
    tm, tv = (_to(p, lambda a: torch.zeros(a.shape)) for _ in range(2))
    out = adamw_update(tp, tg, tm, tv, torch.tensor(3, dtype=torch.int32),
                       AdamWConfig())
    assert out[0] is tp and out[1] is tm and out[2] is tv
    assert not torch.equal(tp["a"]["w"], torch.from_numpy(p["a"]["w"]))
    assert torch.equal(tg["b"], torch.from_numpy(g["b"]))


@pytest.mark.parametrize("seed", range(4))
def test_compress_grads_bit_equal_to_reference(seed):
    rng = np.random.default_rng(seed)
    g = _random_tree(rng, scale=10.0 ** rng.uniform(-4, 2))
    e = _random_tree(rng, scale=1e-3)
    g["zero"] = np.zeros(4, np.float32)          # the 1e-12 scale floor
    e["zero"] = np.zeros(4, np.float32)
    jg, je = jcompress_grads(_to(g, jnp.asarray), _to(e, jnp.asarray))
    tg, te = compress_grads(_to(g, torch.from_numpy), _to(e, torch.from_numpy))
    for got, want in ((tg, jg), (te, je)):
        for (path, t), (_, w) in zip(leaves_with_paths(got),
                                     leaves_with_paths(want)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(w),
                                          err_msg=path)


@pytest.mark.parametrize("seed,vocab,seq,batch", [(0, 256, 64, 4),
                                                  (7, 152064, 128, 2)])
def test_dataset_batches_bit_equal_to_reference(seed, vocab, seq, batch):
    ours = SyntheticLMDataset(vocab_size=vocab, seq_len=seq,
                              batch_size=batch, seed=seed)
    theirs = JSyntheticLMDataset(vocab_size=vocab, seq_len=seq,
                                 batch_size=batch, seed=seed)
    for i in (0, 1, 13):
        a, b = ours.batch(i), theirs.batch(i)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def _tree_pair():
    """The same tree as the reference's jnp arrays and the port's tensors
    (float32, int32, a 0-d cursor, bfloat16; keys out of order)."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    h = rng.standard_normal((5,)).astype(np.float32)
    jt = {"state": {"params": {"w": jnp.asarray(w),
                               "h": jnp.asarray(h).astype(jnp.bfloat16)},
                    "step": jnp.int32(5)},
          "cursor": jnp.asarray(9, jnp.int32)}
    tt = {"state": {"params": {"w": torch.from_numpy(w),
                               "h": torch.from_numpy(h).to(torch.bfloat16)},
                    "step": torch.tensor(5, dtype=torch.int32)},
          "cursor": torch.tensor(9, dtype=torch.int32)}
    return jt, tt


def _manifest(path, step):
    return json.loads((pathlib.Path(path) / f"step_{step:08d}" /
                       "manifest.json").read_text())


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jt, tt = _tree_pair()
    jt["state"]["params"].pop("h")              # the reference cannot
    tt["state"]["params"].pop("h")              # restore bfloat16 (|V2)
    jsave_pytree(jt, tmp_path / "ref", 4)
    out = restore_pytree(tt, tmp_path / "ref")
    for (p1, a), (p2, b) in zip(leaves_with_paths(out),
                                leaves_with_paths(tt)):
        assert p1 == p2 and a.dtype == b.dtype and torch.equal(a, b)
    save_pytree(tt, tmp_path / "port", 4)
    assert _manifest(tmp_path / "port", 4) == _manifest(tmp_path / "ref", 4)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jt, tt = _tree_pair()
    save_pytree(tt, tmp_path / "port", 2)
    jsave_pytree(jt, tmp_path / "ref", 2)
    ours, theirs = _manifest(tmp_path / "port", 2), \
        _manifest(tmp_path / "ref", 2)
    assert ours["paths"] == theirs["paths"] == [
        "['cursor']", "['state']['params']['h']", "['state']['params']['w']",
        "['state']['step']"]
    assert ours == theirs
    # the bfloat16 leaf is stored as the reference stores it
    with np.load(tmp_path / "port" / "step_00000002" / "shard_0.npz") as a, \
            np.load(tmp_path / "ref" / "step_00000002" / "shard_0.npz") as b:
        for i in range(ours["n_leaves"]):
            assert a[f"leaf_{i}"].dtype == b[f"leaf_{i}"].dtype
            assert a[f"leaf_{i}"].tobytes() == b[f"leaf_{i}"].tobytes()
    jt["state"]["params"].pop("h")
    tt["state"]["params"].pop("h")
    save_pytree(tt, tmp_path / "port32", 2)
    out = jrestore_pytree(jt, tmp_path / "port32")
    for a, b in zip(jax.tree_util.tree_leaves(out),
                    jax.tree_util.tree_leaves(jt)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # and the port restores its own bfloat16 leaf bit for bit
    _, tt = _tree_pair()
    back = restore_pytree(tt, tmp_path / "port")
    assert torch.equal(back["state"]["params"]["h"],
                       tt["state"]["params"]["h"])


def test_launcher_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--torch-device cpu"):
        train_launch.main(["--arch", "qwen2-5-7b", "--reduced",
                           "--steps", "1"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train_launch.main(["--arch", "qwen2-5-7b", "--reduced",
                                  "--steps", "2", "--batch", "2", "--seq",
                                  "16", "--torch-device", "cpu"]) == 0
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("[train] qwen2-5-reduced: ")
    assert lines[-1].startswith("[train] final loss ")
