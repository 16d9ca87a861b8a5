"""Time the attention kernels of the ``repro_torch`` on the import path,
with the logit softcap off and, where the tree's wrappers take one, on,
by ``chip_smoke.py``'s method (CUDA events around calls queued behind a
spin kernel, median of 7 rounds; decode rotating over input sets of
>= 100 MB together), through the public wrappers: the f32tc forward
(``flash_attention_lse``) and its backward (``flash_attention_bwd``) at
``chip_smoke.TRAIN_SHAPE``, the sm90 kernel (``flash_attention``) at
Qwen2.5-7B's causal S = T = 2,048 in bf16, and ``decode_attention`` at
``chip_smoke.DECODE_TIMED`` in bf16.

To compare two versions of the kernels on one card, run it once with
each tree's ``src`` on ``PYTHONPATH``, in the order A, B, B, A, on one
machine::

    PYTHONPATH=old/src python3 tools/time_flash.py old
    PYTHONPATH=src python3 tools/time_flash.py new

Prints the card's name and power limit, then one JSON line:
``{"tree": label, "ms": {kernel: {"off": ms, "on": ms or null}}}``.
"""
import inspect
import json
import pathlib
import sys

SOFTCAP = {"f32tc": 5.0, "sm90": 50.0, "decode": 50.0}


def main(label):
    import torch

    # the wrappers first: importing chip_smoke puts this tree's src ahead
    # on the path, and the modules must come from the caller's PYTHONPATH
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    sys.path.append(str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("time_flash: no CUDA device is available", file=sys.stderr)
        return 2
    print(cs._card_line())
    print(f"{label}: {fmod.__file__}")
    capped = "softcap" in inspect.signature(fmod.flash_attention).parameters
    ms = {}

    def both(name, run):
        ms[name] = {"off": run(None),
                    "on": run(SOFTCAP[name.split()[0]]) if capped else None}
        print(f"{label} {name}: cap off {ms[name]['off']} ms, on "
              f"{ms[name]['on']} ms")

    def kw(cap):
        return {} if cap is None else {"softcap": cap}

    b, h, hkv, s, d = cs.TRAIN_SHAPE
    q, k, v = cs._qkv(b, h, hkv, s, s, d, False, 910, torch.float32, torch)
    dout = cs._randn((b, h, s, d), 915, torch.float32, torch)
    both("f32tc forward", lambda cap: cs._time_ms(
        lambda: fmod.flash_attention_lse(q, k, v, **kw(cap)), torch,
        reps=5))

    def bwd(cap):
        out, lse = fmod.flash_attention_lse(q, k, v, **kw(cap))
        return cs._time_ms(lambda: fmod.flash_attention_bwd(
            q, k, v, out, lse, dout, **kw(cap)), torch, reps=5)

    both("f32tc backward", bwd)
    del q, k, v, dout
    torch.cuda.empty_cache()
    q, k, v = cs._qkv(1, 28, 4, 2048, 2048, 128, True, 900, torch.bfloat16,
                      torch)
    both("sm90 forward", lambda cap: cs._time_ms(
        lambda: fmod.flash_attention(q, k, v, **kw(cap)), torch))
    b, h, hkv, t, d = cs.DECODE_TIMED
    q = cs._randn((b, h, d), 920, torch.bfloat16, torch)
    sets = [(cs._randn((b, hkv, t, d), 921 + 2 * j, torch.bfloat16, torch),
             cs._randn((b, hkv, t, d), 922 + 2 * j, torch.bfloat16, torch))
            for j in range(cs._sets(2 * b * hkv * t * d * 2))]
    length = torch.full((b,), t, dtype=torch.int32, device=cs.DEV)
    both("decode", lambda cap: cs._time_rot(
        [lambda k=k, v=v: dmod.decode_attention(q, k, v, length, **kw(cap))
         for k, v in sets], torch))
    print(json.dumps({"tree": label, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "tree"))
