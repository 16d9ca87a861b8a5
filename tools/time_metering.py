"""Time the three metering wrappers (``fused_meter``, ``segment_trapz``,
``ordered_segment_sum``) of the ``repro_torch`` on the import path at
``chip_smoke.py``'s acceptance-day shapes, by the same method as
``chip_smoke`` (CUDA events around 20 calls queued behind a spin
kernel, rotating over input sets of >= 100 MB together, median of 7
rounds), through the public wrappers of
``repro_torch.kernels.segment_trapz``.

To compare two versions of the kernels on one card, run it once with
each tree's ``src`` on ``PYTHONPATH``, in the order A, B, B, A, on one
machine::

    PYTHONPATH=old/src python3 tools/time_metering.py old
    PYTHONPATH=src python3 tools/time_metering.py new

Prints the card's name and power limit, then one JSON line:
``{"tree": label, "ms": {kernel: ms}}``.
"""
import json
import pathlib
import sys


def main(label):
    import torch

    # the wrappers first: importing chip_smoke puts this tree's src ahead
    # on the path, and the module must come from the caller's PYTHONPATH
    from repro_torch.kernels import segment_trapz as cu
    sys.path.append(str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("time_metering: no CUDA device is available", file=sys.stderr)
        return 2
    print(cs._card_line())
    print(f"{label}: {cu.__file__}")
    ms = cs.time_metering(torch)
    for k, v in ms.items():
        print(f"{label} {k}: {v} ms")
    print(json.dumps({"tree": label, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "tree"))
