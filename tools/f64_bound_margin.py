"""How close the port's float64 plain flash attention comes to the float64
bound of ``tests/test_torch_softcap.py::test_plain_flash_matches_
reference_sdpa``, and how far its planted faults miss it, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/f64_bound_margin.py \
        [--draws 100] [--seed 0]

For the test's pinned draw and ``--draws`` random draws of its strategy
(sizes, heads, offset, window, cap and seed drawn uniformly from the
same choices): the largest share of ``_f64_bound`` that an output
element's gap to the reference takes, after the 1e-6 relative part
(below 1 passes).  For the pinned draw also the share each planted fault
of ``test_float64_bound_sees_the_planted_faults`` takes (above 1
misses).  A draw of new shapes compiles the reference anew, about 3 s.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--draws", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    import test_torch_softcap as t

    def share(got, want, q, k, v, off, window):
        gap = np.abs(got - want) - t.TOL["float64"] * np.abs(want)
        return float((gap / t._f64_bound(q, k, v, off, window)).max())

    def run(b, heads, s, off, d, window, cap, seed, q_scale=1.0,
            shift=0, drop_cap=False):
        q, k, v = t._draw(b, heads, s, off, d, seed)
        with jax.enable_x64(True):
            want = t._reference(q, k, v, off, window, True, cap, "float64")
        got = t._port(q * q_scale, k, v, off + shift, window, True,
                      None if drop_cap else cap, "float64")
        return share(got, want, q, k, v, off, window)

    b, heads, s, off, d, window, cap, _, seed = t.PINNED
    pinned = (b, heads, s, off, d, window, cap, seed)
    print(f"pinned draw {pinned}: {run(*pinned):.3f} of the bound")
    for name, kw in (("cap dropped", {"drop_cap": True}),
                     ("mask one row late", {"shift": 1}),
                     ("scores x (1 + 1e-5)", {"q_scale": 1 + 1e-5})):
        print(f"  planted fault {name}: {run(*pinned, **kw):.3f}")
    rng = np.random.default_rng(args.seed)
    worst = (0.0, None)
    for _ in range(args.draws):
        draw = (int(rng.integers(1, 3)),
                [(4, 4), (4, 2), (6, 1)][rng.integers(3)],
                int(rng.integers(1, 10)), int(rng.integers(0, 21)),
                [8, 16][rng.integers(2)], [None, 3, 7][rng.integers(3)],
                t.CAPS[rng.integers(3)], int(rng.integers(0, 2 ** 16)))
        r = run(*draw)
        if r > worst[0]:
            worst = (r, draw)
    print(f"{args.draws} random draws (seed {args.seed}): the largest "
          f"{worst[0]:.3f} of the bound, at {worst[1]}")


if __name__ == "__main__":
    main()
