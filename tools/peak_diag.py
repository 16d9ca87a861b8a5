"""Which aten ops allocate memory on the card that the dry run's trace
does not see, on one NVIDIA GPU::

    python3 tools/peak_diag.py [layers]

granite-20b x ``train_4k`` in the sharded layout at full width, cut to
``layers`` layers (2 by default), bf16: ``chip_smoke.py`` phase 24.3's
cell.  Its step runs as rank 0 of a ``fake`` group of 256 on the card
(``chip_smoke._rank0_inputs``) under a dispatch mode that resets the
allocator's peak before every op and reads it after: an op whose peak
passes what is live before and after it by more than 64 MiB allocated a
temporary inside its kernel, which a fake (meta) kernel does not.
Prints the card's name and power limit, the trace's peak
(``launch/dryrun.trace_cell``), the real one, and each such op with its
temporary's bytes and its operands' shapes, dtypes and strides.
"""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SPIKE = 64 << 20


def main():
    import torch
    if not torch.cuda.is_available():
        print("peak_diag: no CUDA device is available", file=sys.stderr)
        return 2
    from torch.utils._python_dispatch import TorchDispatchMode

    import chip_smoke as cs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import SHAPES, jit_cell
    layers = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    print(cs._card_line())
    cs.build()
    cfg = cs.cut_depth("granite-20b", layers, torch.bfloat16)
    shape = SHAPES["train_4k"]
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device_type="cuda")
        traced = dryrun.trace_cell(cfg, shape, mesh)["peak_device_bytes"]
    spikes = []

    class Spikes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = func(*args, **(kwargs or {}))
            inner = torch.cuda.max_memory_allocated() - max(
                before, torch.cuda.memory_allocated())
            if inner > SPIKE:
                spikes.append((str(func), inner, [
                    (tuple(a.shape), str(a.dtype), tuple(a.stride()))
                    for a in args if isinstance(a, torch.Tensor)]))
            return out

    with dryrun.fake_group(256):
        mesh = make_production_mesh(device_type="cuda")
        cs._free_card()
        base = torch.cuda.memory_allocated()
        args = cs._rank0_inputs(cfg, shape, mesh)
        step, _ = jit_cell(cfg, shape, mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(*args)
        torch.cuda.synchronize()
        real = torch.cuda.max_memory_allocated() - base
        with Spikes():
            step(*args)
        torch.cuda.synchronize()
    print(f"{cfg.name} x {layers} layers, train_4k rank 0 of (16, 16): "
          f"peak traced {traced:,} B, max_memory_allocated {real:,} B")
    for op, nbytes, operands in spikes:
        print(f"  {op}: {nbytes:,} B inside the op; operands {operands}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
