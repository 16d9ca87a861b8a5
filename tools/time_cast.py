"""Time how ``chip_smoke.check_depth`` puts a depth cut's float32 weights
on the card as float64 (phases 13 and 16's float64 run), two ways on the
same host leaves: a blocking ``.to("cuda", float64)`` of each leaf (which
casts on the host and moves the float64 leaf) and ``chip_smoke._cast``
(which moves the float32 leaf and casts it on the card).  Host clock
around each whole tree, ending in a synchronize; the card emptied
between runs; the order A, B, B, A.  The values are the same either way
(a float32 -> float64 cast is exact).

    python3 tools/time_cast.py [arch] [layers]     # default command-r-35b 2

Prints the card's name and power limit, then one JSON line:
``{"arch": ..., "layers": ..., "host_cast_s": [...], "card_cast_s": [...]}``.
"""
import dataclasses
import json
import pathlib
import sys
import time


def main(arch="command-r-35b", layers=2):
    import torch

    sys.path.append(str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from repro_torch.models import build_param_specs, materialize
    if not torch.cuda.is_available():
        print("time_cast: no CUDA device is available", file=sys.stderr)
        return 2
    print(cs._card_line())
    cfg = cs.cut_depth(arch, layers, torch.float32)
    specs = build_param_specs(dataclasses.replace(
        cfg, param_dtype=torch.float64, compute_dtype=torch.float64))
    host = materialize(build_param_specs(cfg),
                       torch.Generator().manual_seed(0), "cpu")

    def host_cast(tree, sp):
        if isinstance(tree, dict):
            return {k: host_cast(v, sp[k]) for k, v in tree.items()}
        return tree.to("cuda", sp.dtype)

    ways = {"host": lambda: host_cast(host, specs),
            "card": lambda: cs._cast(host, "cuda", specs)}
    secs = {"host": [], "card": []}
    for way in ("host", "card", "card", "host"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w = ways[way]()
        torch.cuda.synchronize()
        secs[way].append(time.perf_counter() - t0)
        del w
        cs._free_card()
    print(json.dumps({"arch": arch, "layers": layers,
                      "host_cast_s": secs["host"],
                      "card_cast_s": secs["card"]}))
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    sys.exit(main(*args[:1], *(int(a) for a in args[1:2])))
