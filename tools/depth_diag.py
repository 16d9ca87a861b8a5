"""Where the float32 gaps of ``chip_smoke.py``'s phase 13 come from, on
one NVIDIA GPU::

    python3 tools/depth_diag.py

1. granite-20b at depth 2 (float32, full width) served as phase 13 does:
   for every attention call, the kernel's and the float32 plain
   version's max abs distance to float64 attention on the same inputs,
   the output's max, and their ratio.
2. gemma3-1b at depth 6 on phase 13's 600-token prompt, at the model
   level, every run fed the card's greedy tokens: the logits of each call
   and each layer's prefill output against a float64 run on the card
   (float64 attention, norms and router; the rope's angle table is
   float32, as the model computes it), for the card in float32 with the
   kernels and with the plain attention, the CPU in float32, the card in
   float64 with the model's float32 leaves and norms, the CPU in float64,
   and the card in float32 with its weights moved by one ulp (three
   seeds).
3. The same float64 run on the CPU and on the card, with the rope's
   angle table in float32 and in float64.

Prints the card's name and power limit, then one line a row.
"""
import contextlib
import dataclasses
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main():
    import torch
    if not torch.cuda.is_available():
        print("depth_diag: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention, build_param_specs, materialize
    from repro_torch.models import model as mmod
    from repro_torch.serving import ServingEngine

    dev, f32, f64 = cs.DEV, torch.float32, torch.float64
    print(cs._card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.build()

    class Calls:
        """Each attention call: the kernel's and the plain version's max
        abs distance to float64 attention, and the output's max."""

        def __enter__(self):
            self.real = (ops.flash_attention, ops.decode_attention)
            self.rows = []

            def flash(q, k, v, *, causal=True, window=None):
                out = self.real[0](q, k, v, causal=causal, window=window)
                self.add("flash", k, out, ref.flash_attention_ref(
                    q, k, v, causal=causal, window=window),
                    cs._flash64(q, k, v, causal, window))
                return out

            def decode(q, k, v, length):
                out = self.real[1](q, k, v, length)
                self.add("decode", k, out,
                         ref.decode_attention_ref(q, k, v, length),
                         cs._decode64(q, k, v, length))
                return out
            ops.flash_attention, ops.decode_attention = flash, decode
            return self

        def add(self, name, k, out, want, exact):
            self.rows.append((name, k.shape[2],
                              float((out.double() - exact).abs().max()),
                              float((want.double() - exact).abs().max()),
                              float(exact.abs().max())))

        def __exit__(self, *exc):
            ops.flash_attention, ops.decode_attention = self.real

    class Hidden:
        """Each block's output in a prefill (S > 1), on the host."""

        def __enter__(self):
            self.real, self.xs = mmod.apply_block, []

            def run(*a, **kw):
                x, nc, aux = self.real(*a, **kw)
                if x.shape[1] > 1:
                    self.xs.append(x.detach().double().cpu())
                return x, nc, aux
            mmod.apply_block = run
            return self

        def __exit__(self, *exc):
            mmod.apply_block = self.real

    @contextlib.contextmanager
    def pure64():
        """``Tensor.float()`` leaves float64 as it is (the norms and the
        router widen to float32 with it)."""
        real = torch.Tensor.float

        def widen(self, *a, **kw):
            return self if self.dtype == f64 else real(self, *a, **kw)
        torch.Tensor.float = widen
        try:
            yield
        finally:
            torch.Tensor.float = real

    real_rope = attention.rope

    def rope64(x, positions, theta):
        """``attention.rope`` with its angle table in float64 for float64
        inputs."""
        if x.dtype != f64:
            return real_rope(x, positions, theta)
        half = x.shape[-1] // 2
        fe = torch.arange(half, dtype=f64, device=x.device) / half
        ang = positions[..., :, None].to(f64) * \
            torch.tensor(theta, dtype=f64, device=x.device) ** (-fe)
        sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    # 1 -------------------------------------------------------------------
    cfg = cs.cut_depth(cs.GRANITE, 2, f32)
    card = materialize(build_param_specs(cfg),
                       torch.Generator().manual_seed(0), dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, 48),
                           generator=torch.Generator().manual_seed(1))
    with Calls() as calls:
        ServingEngine(cfg, card, max_batch=1, max_len=64,
                      device=dev).generate(tokens[0].tolist(), max_new=9)
    print("granite-20b depth 2, each attention call: kernel, rows, max abs "
          "|kernel - f64|, max abs |plain - f64|, max|f64|, kernel / plain")
    for name, t, e_k, e_p, m in calls.rows:
        print(f"  {name:6s} {t:3d} {e_k:.4e} {e_p:.4e} {m:.4e} "
              f"{e_k / max(e_p, 1e-30):.2f}")
    del card
    cs._free_card()

    # 2 -------------------------------------------------------------------
    t0 = time.perf_counter()
    cfg = cs.cut_depth(cs.GEMMA3, 6, f32)
    c64 = dataclasses.replace(cfg, param_dtype=f64, compute_dtype=f64)
    card = materialize(build_param_specs(cfg),
                       torch.Generator().manual_seed(0), dev)
    host = cs._cast(card, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 600),
                           generator=torch.Generator().manual_seed(1))

    def run(c, w, on, fed=None, *ctx):
        with contextlib.ExitStack() as st:
            for x in ctx:
                st.enter_context(x)
            h = st.enter_context(Hidden())
            toks, logits, _ = cs._model_generate(c, w, tokens, 8, on,
                                                 forced=fed)
        return toks, (logits, h.xs)

    toks, base = run(cfg, card, dev)
    fed = toks[:, :8]
    runs = {"card float32, kernels": base}
    runs["card float32, plain attention"] = run(
        cfg, card, dev, fed, cs._Plain("flash_attention"),
        cs._Plain("decode_attention"))[1]
    runs["CPU float32"] = run(cfg, host, "cpu", fed)[1]
    w = cs._cast(host, dev, build_param_specs(c64))
    runs["card float64, float32 leaves and norms"] = run(
        c64, w, dev, fed, cs._Exact())[1]
    w = cs._cast(host, f64)
    runs["CPU float64"] = run(c64, w, "cpu", fed, cs._Exact(), pure64())[1]
    exact = run(c64, cs._cast(w, dev), dev, fed, cs._Exact(), pure64())[1]
    del w
    cs._free_card()
    for seed in range(3):
        g = torch.Generator().manual_seed(100 + seed)

        def nudge(t):
            if isinstance(t, dict):
                return {k: nudge(v) for k, v in t.items()}
            return t * (1 + 2.0 ** -23 * torch.randn(
                t.shape, generator=g).sign().to(t.device))
        runs[f"card float32, kernels, weights x(1 +- 2^-23), seed "
             f"{seed}"] = run(cfg, nudge(card), dev, fed)[1]
    print(f"gemma3-1b depth 6, 600-token prompt + 8 steps "
          f"({time.perf_counter() - t0:.1f} s), card tokens "
          f"{toks[0].tolist()}; max |x - f64| / max|f64| of each call's "
          f"logits | of each layer's prefill output:")
    for name, (logits, xs) in runs.items():
        print(f"  {name:52s} " + " ".join(
            f"{rel(a, b):.2e}" for a, b in zip(logits, exact[0])) + " | "
            + " ".join(f"{rel(a, b):.2e}" for a, b in zip(xs, exact[1])))
    del card
    cs._free_card()

    # 3 -------------------------------------------------------------------
    w = cs._cast(host, f64)
    for label, fn in (("float32", real_rope), ("float64", rope64)):
        attention.rope = fn
        try:
            a = run(c64, w, "cpu", fed, cs._Exact(), pure64())[1]
            b = run(c64, cs._cast(w, dev), dev, fed, cs._Exact(),
                    pure64())[1]
        finally:
            attention.rope = real_rope
        cs._free_card()
        print(f"gemma3-1b float64 on the CPU against float64 on the card, "
              f"rope angles in {label}: logits " + " ".join(
                  f"{rel(x, y):.2e}" for x, y in zip(a[0], b[0]))
              + " | layers " + " ".join(
                  f"{rel(x, y):.2e}" for x, y in zip(a[1], b[1])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
