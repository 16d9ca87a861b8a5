"""Serving launcher: `PYTHONPATH=src python -m repro_torch.launch.serve
--arch <id> [--reduced] [--policy breakeven] [--trace bursty]
[--torch-device cuda]`.

Spins up the energy-aware ModelManager + ServingEngine for one arch and
replays a traffic trace (the reference's ``repro.launch.serve``, same
flags and output lines).  ``--device`` is the power profile (``h100``,
...); the tensors live on ``--torch-device`` (default the card: a
missing card raises).  Weights are random, drawn from a fixed seed.
"""
from __future__ import annotations

import argparse
from typing import Optional

import torch

from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.core import PROFILES, loader_from_checkpoint
from repro_torch.core.scheduler import (AdaptiveBreakeven, AlwaysOn,
                                        Breakeven, FixedTTL)
from repro_torch.core import traffic
from repro_torch.models import RunFlags, build_param_specs, materialize, \
    param_bytes
from repro_torch.serving import ModelManager, ServingEngine, SimClock


def main(argv=None, *, device: Optional[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--policy", default="breakeven",
                    choices=["always-on", "ttl", "breakeven", "adaptive"])
    ap.add_argument("--trace", default="bursty",
                    choices=list(traffic.PATTERNS))
    ap.add_argument("--device", default="h100", choices=list(PROFILES),
                    help="power profile")
    ap.add_argument("--torch-device", default=None,
                    help="where the tensors live (default: cuda)")
    ap.add_argument("--hours", type=float, default=6.0)
    args = ap.parse_args(argv)
    dev = torch.device(device or args.torch_device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.launch.serve runs on a CUDA device "
                           "and none is available; pass --torch-device cpu "
                           "to run the plain PyTorch versions")

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    profile = PROFILES[args.device]
    # per-arch loader derived from the FULL config's checkpoint bytes
    full_bytes = param_bytes(build_param_specs(get_config(args.arch)))
    loader = loader_from_checkpoint(args.arch, full_bytes, profile)
    print(f"[serve] {cfg.name} on {profile.name}: checkpoint "
          f"{full_bytes/2**30:.1f} GiB -> t_load {loader.t_load_s:.1f}s, "
          f"parking tax {profile.dvfs_step_w:.1f} W")

    policy = {
        "always-on": AlwaysOn(),
        "ttl": FixedTTL(300.0),
        "breakeven": Breakeven(loader, profile),
        "adaptive": AdaptiveBreakeven(loader, profile),
    }[args.policy]

    params = materialize(build_param_specs(cfg),
                         torch.Generator().manual_seed(0), dev)

    def load_engine():
        return ServingEngine(cfg, params, max_batch=4, max_len=48,
                             flags=RunFlags(remat="none"), device=dev)

    mm = ModelManager(profile, clock=SimClock())
    mm.register(cfg.name, policy=policy, loader=loader,
                load_fn=load_engine)
    arrivals = traffic.PATTERNS[args.trace](seed=0)
    arrivals = [a for a in arrivals if a < args.hours * 3600.0]
    mm.handle_request(cfg.name,
                      work_fn=lambda e: e.generate([1, 2, 3], max_new=4))
    for a in arrivals:
        mm._advance_with_evictions(max(float(a), mm.clock()))
        mm.handle_request(cfg.name,
                          work_fn=lambda e: e.generate([1, 2, 3],
                                                       max_new=4))
    mm._advance_with_evictions(args.hours * 3600.0)
    m = mm.models[cfg.name]
    wh = mm.meter.totals()
    print(f"[serve] {policy.name}: {m.requests} requests, "
          f"{m.cold_starts} cold starts, energy {wh['total']:.1f} Wh "
          f"(parking tax {mm.meter.parking_tax_wh():.1f} Wh), "
          f"mean added latency {m.added_latency_s/max(m.requests,1):.2f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
