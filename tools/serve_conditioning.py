"""How far float32 rounding moves the serving prefill's caches, in the
port and in the reference, on the CPU at the reduced configs.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/serve_conditioning.py \
        [--init reference|d_model] [arch ...]

For each arch (the four dense decoders by default): the inputs of
``tests/test_torch_sharded_serve.py``'s prefill case (``_torch_spmd.
serve_inputs``: float32 caches), with the weights from seed 0 at the
reference's init law or at the d_model fan-in law; the port's unsharded
``make_prefill_step`` in float32 and in float64, and the JAX package's
``prefill`` in float32.  For each cache leaf: the float32 port's and the
reference's largest distance from the float64 step, and from each
other, as shares of the leaf's max.  Where a leaf's shares approach the
tests' rtol 1e-5, float32 alone (no port fault) can fail that bound.
"""
import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("arch", nargs="*")
    ap.add_argument("--init", choices=("reference", "d_model"),
                    default="reference")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import torch

    import _torch_spmd
    from repro.configs import get_reduced as jget_reduced
    from repro.models import RunFlags as JRunFlags
    from repro.models import prefill as jprefill
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import materialize
    from repro_torch.models.params import leaves_with_paths, tree_map

    for arch in args.arch or _torch_spmd.DENSE:
        cfg, shape, params, first, caches, _ = _torch_spmd.serve_inputs(
            arch, True, torch.float32)
        if args.init == "reference":
            from repro_torch.launch.steps import input_specs
            params = materialize(input_specs(cfg, shape)["params"],
                                 torch.Generator().manual_seed(0), "cpu")
        _, c32 = make_prefill_step(cfg)(params, first,
                                        tree_map(torch.clone, caches))
        cfg64 = dataclasses.replace(cfg, compute_dtype=torch.float64)
        _, c64 = make_prefill_step(cfg64)(
            tree_map(lambda t: t.double(), params), first,
            tree_map(lambda t: t.double(), caches))
        _, cj = jprefill(tree_map(lambda t: jnp.asarray(t.numpy()), params),
                         {"tokens": jnp.asarray(first["tokens"].numpy())},
                         tree_map(lambda t: jnp.asarray(t.numpy()), caches),
                         jget_reduced(arch), JRunFlags())
        cj = {jax.tree_util.keystr(k): np.asarray(v, np.float64)
              for k, v in jax.tree_util.tree_flatten_with_path(cj)[0]}
        c64 = dict(leaves_with_paths(c64))
        print(f"{arch} ({args.init} init): share of each leaf's max")
        for path, t in leaves_with_paths(c32):
            want = c64[path].numpy()
            port = t.double().numpy()
            scale = float(np.abs(want).max())

            def share(a, b):
                return float(np.abs(a - b).max()) / scale
            print(f"  {path:34s} port-float64 {share(port, want):.3e}  "
                  f"reference-float64 {share(cj[path], want):.3e}  "
                  f"port-reference {share(port, cj[path]):.3e}")


if __name__ == "__main__":
    main()
