"""Time ``decode_attention`` of the ``repro_torch`` on the import path at
``chip_smoke.py``'s decode rows, by the same method as ``chip_smoke``
(CUDA events around calls queued behind a spin kernel, rotating over
input sets of >= 100 MB together, median of 7 rounds), through the
public wrapper ``repro_torch.kernels.decode_attention.decode_attention``.

To compare two versions of the kernel on one card, run it once with
each tree's ``src`` on ``PYTHONPATH``, in the order A, B, B, A, on one
machine::

    PYTHONPATH=old/src python3 tools/time_decode.py old
    PYTHONPATH=src python3 tools/time_decode.py new

Prints the card's name and power limit, then one JSON line:
``{"tree": label, "rows": {row label: ms}}``.
"""
import json
import pathlib
import sys


def main(label):
    import torch

    # the wrapper first: importing chip_smoke puts this tree's src ahead
    # on the path, and the module must come from the caller's PYTHONPATH
    from repro_torch.kernels import decode_attention as dmod
    sys.path.append(str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    decode_attention = dmod.decode_attention
    if not torch.cuda.is_available():
        print("time_decode: no CUDA device is available", file=sys.stderr)
        return 2
    print(cs._card_line())
    print(f"{label}: {dmod.__file__}")
    dt = torch.bfloat16
    rows = {}
    for i, (name, b, h, hkv, t, d, n, views) in enumerate(cs.DECODE_ROWS):
        q = cs._randn((b, h, d), 200 + i, dt, torch)
        sets = []
        for j in range(cs._sets(2 * b * hkv * t * d * 2)):
            shape = (b, t, hkv, d) if views else (b, hkv, t, d)
            k = cs._randn(shape, 300 + 2 * j, dt, torch)
            v = cs._randn(shape, 301 + 2 * j, dt, torch)
            sets.append((k.transpose(1, 2), v.transpose(1, 2)) if views
                        else (k, v))
        length = torch.full((b,), n, dtype=torch.int32, device=cs.DEV)
        fns = [lambda k=k, v=v: decode_attention(q, k, v, length)
               for k, v in sets]
        rows[name] = cs._time_rot(fns, torch)
        print(f"{label} decode_attention {name}: {rows[name]} ms over "
              f"{len(sets)} input sets")
    print(json.dumps({"tree": label, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "tree"))
