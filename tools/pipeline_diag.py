"""Where the float32 gap between the one-stage GPipe loss and
``train_loss`` comes from, on one NVIDIA GPU::

    python3 tools/pipeline_diag.py

Qwen2.5-7B at full width, 2 of its 28 layers, B = 2, S = 1,024,
``remat="none"`` (``chip_smoke.py`` phase 22's pipeline cell), at the
reference's init law and at the d_model fan-in law
(``chip_smoke._fan_in_d_model``).  Four gradients of the same loss:

  A. ``train_loss`` on the whole batch, float32, the kernels;
  B. ``train_loss`` on each row alone, averaged (the microbatch split
     without the pipeline), float32, the kernels;
  C. the one-stage pipeline, 2 microbatches, float32, the kernels;
  D. ``train_loss`` on the whole batch in float64 with the plain
     attention (``chip_smoke._PlainOps``).

For each pair, the worst leaf's max |x - y| over max |y| and that leaf.
If C sits on B and both as far from A as A from D, the gap is the
float32 rounding of another microbatch split, amplified by the
weights, not the pipeline.  Prints the card's name and power limit,
then one line a pair.
"""
import dataclasses
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main():
    import torch
    if not torch.cuda.is_available():
        print("pipeline_diag: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import RunFlags, build_param_specs, materialize
    from repro_torch.models.params import (leaves_with_paths, tree_leaves,
                                           tree_map, tree_unflatten)
    from repro_torch.training.pipeline import (make_pipelined_train_loss,
                                               split_stage_params)
    print(cs._card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.build()
    cs._process_group(ROOT / "build" / "diag_store")
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.distributed.sharding import Mesh
        mesh = Mesh(init_device_mesh(torch.device(cs.DEV).type, (1,),
                                     mesh_dim_names=("pod",)))
        cfg = cs.cut_depth(cs.ARCH, cs.DIST_LAYERS, torch.float32)
        flags = RunFlags(remat="none")
        b, s = cs.PIPE_SHAPE
        batch = {"tokens": cs._tokens(cfg, b, s, 80),
                 "labels": cs._tokens(cfg, b, s, 81)}
        paths = [p for p, _ in leaves_with_paths(build_param_specs(cfg))]
        for law in ("reference init", "d_model fan-in"):
            params = materialize(build_param_specs(cfg),
                                 torch.Generator().manual_seed(0), cs.DEV)
            if law != "reference init":
                cs._fan_in_d_model(params, cfg)
            grads = {}
            _, g = value_and_grad(params, batch, cfg, flags)
            # the host holds the four copies (~37 GB)
            grads["A"] = [t.cpu() for t in tree_leaves(g)]
            rows = [value_and_grad(params, {k: v[i:i + 1]
                                            for k, v in batch.items()},
                                   cfg, flags)[1] for i in range(b)]
            grads["B"] = [(sum(t.double() for t in ts) / b).cpu()
                          for ts in zip(*(tree_leaves(r) for r in rows))]
            del rows, g
            loss_fn = make_pipelined_train_loss(
                cfg, mesh, n_microbatches=cs.PIPE_MICRO, flags=flags)
            staged = split_stage_params(params, cfg, n_stages=1)
            leaves = [t.detach().requires_grad_()
                      for t in tree_leaves(staged)]
            gc = torch.autograd.grad(
                loss_fn(tree_unflatten(staged, leaves), batch), leaves)
            grads["C"] = [t.reshape(w.shape).cpu()
                          for t, w in zip(gc, grads["A"])]
            del gc, leaves, staged
            cfg64 = dataclasses.replace(cfg, param_dtype=torch.float64,
                                        compute_dtype=torch.float64)
            p64 = tree_map(lambda t: t.double(), params)
            del params
            cs._free_card()
            with cs._PlainOps():
                _, g = value_and_grad(p64, batch, cfg64, flags)
            grads["D"] = [t.cpu() for t in tree_leaves(g)]
            del g, p64
            for x, y in (("C", "A"), ("B", "A"), ("C", "B"), ("A", "D"),
                         ("B", "D"), ("C", "D")):
                errs = [cs._rel_max(g, w) for g, w in zip(grads[x],
                                                          grads[y])]
                i = max(range(len(errs)), key=errs.__getitem__)
                print(f"{law}: {x} vs {y}: worst leaf {paths[i]} "
                      f"{errs[i]:.3e} of its max; median leaf "
                      f"{sorted(errs)[len(errs) // 2]:.3e}")
            del grads
            cs._free_card()
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
