"""How reproducible the reference's float32 training gradients are, beside
the port's distance to them, on the CPU at the reduced configs.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/grad_conditioning.py \
        [--init reference|d_model] [--trials 3] [arch ...]

For each arch: the loss of both packages on the same weights (the
reference's ``materialize(PRNGKey(0))``, optionally with every
[d_model, heads, head_dim] projection at the d_model fan-in law) and the
same numpy batch as ``tests/test_torch_train_loss.py``; the port's worst
gradient leaf against the reference's, as a multiple of the tests'
bound (1e-4 of the leaf's max |g| plus 1e-7); and the same multiple for
the reference against itself with its weights multiplied by
(1 + 1e-7 N(0, 1)), the worst of ``--trials`` draws.  Where the
reference's own multiple passes 1, the bound sits below the float32
noise of the reference's gradient at that init.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("arch", nargs="*")
    ap.add_argument("--init", choices=("reference", "d_model"),
                    default="reference")
    ap.add_argument("--trials", type=int, default=3)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import torch
    from test_torch_train_loss import (GRAD_ABS, GRAD_REL, _batch,
                                       _weights)

    from repro.models import RunFlags as JRunFlags
    from repro.models.model import train_loss as jtrain_loss
    from repro_torch.configs import ARCHS
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import RunFlags
    from repro_torch.models.params import leaves_with_paths

    def multiple(got, want):
        return max((float(np.max(np.abs(g - want[p]) / (
            GRAD_REL * np.abs(want[p]).max() + GRAD_ABS))), p)
            for p, g in got.items())

    rng = np.random.default_rng(5)
    for arch in args.arch or ARCHS:
        jcfg, cfg, tree = _weights(arch, args.init == "d_model")
        batch = _batch(cfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        f = jax.jit(jax.value_and_grad(
            lambda p, b: jtrain_loss(p, b, jcfg, JRunFlags())))

        def ref(t):
            loss, g = f(jax.tree_util.tree_map(jnp.asarray, t), jb)
            return float(loss), {jax.tree_util.keystr(k): np.asarray(v)
                                 for k, v in jax.tree_util.
                                 tree_flatten_with_path(g)[0]}
        jl, want = ref(tree)
        loss, grads = value_and_grad(
            params_from_numpy(cfg, tree, "cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
            RunFlags())
        port = multiple({p: g.numpy() for p, g in leaves_with_paths(grads)},
                        want)
        spread = max(multiple(ref(jax.tree_util.tree_map(
            lambda x: x * (1 + 1e-7 * rng.standard_normal(x.shape)).astype(
                x.dtype), tree))[1], want) for _ in range(args.trials))
        print(f"{arch} ({args.init} init): loss reference {jl!r}, port "
              f"{float(loss)!r}; port vs reference {port[0]:.3f} x the "
              f"bound at {port[1]}; reference x (1 + 1e-7 N) vs itself "
              f"{spread[0]:.3f} x at {spread[1]}", flush=True)


if __name__ == "__main__":
    main()
