"""Calibrated service-time model: how long one request occupies a slot.

The fleet simulator used to treat ``service_s`` as one global constant,
which makes contention and batching occupancy -- the quantities that set
the effective arrival rate a device sees, and that Chung et al. ("Where
Do the Joules Go?") and Ozcan et al. show dominate inference energy
accounting -- fake.  This module replaces the constant with a model of
per-request prefill + decode time as a function of the model's
architecture numbers, the device's per-SKU throughput (``tflops_bf16``
on the catalog SKU, ``mem_bw_gbps`` on the power profile), and the
decode-batch occupancy at admission:

  prefill_s       = prompt_tokens * flops_per_token / (TFLOPS * MFU)
  decode_step_s   = weight_bytes / mem_bw          (batch-shared stream)
                    + batch * (kv_read + compute)  (per-sequence terms)
  service_s       = overhead + prefill_s + output_tokens * decode_step_s

Batching occupancy enters exactly as in a real continuous-batching
engine: weights stream from HBM once per step for the WHOLE batch, so a
fuller batch slows each step only by the per-sequence terms while
multiplying tokens/step -- per-request latency degrades gently, and
throughput scales until compute-bound.  The event-driven simulator
freezes a request's service time at admission occupancy (a documented
approximation; true continuous batching would re-time in-flight
requests as occupancy changes).

Calibration anchor: a 7B bf16 model (14.9 GB weights) on H100
(3.35 TB/s) gives a 4.5 ms decode step ~ 220 tok/s/slot, matching
published single-request H100 decode rates for that class
(tests/test_fleet.py pins the band).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

GB = 1024 ** 3


@dataclasses.dataclass(frozen=True)
class RequestShape:
    """The traffic's token shape (one knob pair, not per-request)."""
    prompt_tokens: int = 128
    output_tokens: int = 64


@dataclasses.dataclass(frozen=True)
class ModelServiceProfile:
    """The three per-model numbers the service-time model consumes."""
    name: str
    weight_bytes: float            # bytes streamed per decode step
    flops_per_token: float         # 2 * N_active (inference forward)
    kv_bytes_per_token: float = 0.0

    @classmethod
    def from_arch(cls, cfg, dtype_bytes: int = 2) -> "ModelServiceProfile":
        """Exact numbers from an ``ArchConfig`` (models/config.py)."""
        n_active = cfg.active_param_count()
        kv = 2 * cfg.total_layers * cfg.n_kv_heads * cfg.head_dim_ \
            * dtype_bytes
        return cls(name=cfg.name,
                   weight_bytes=float(cfg.param_count() * dtype_bytes),
                   flops_per_token=2.0 * n_active,
                   kv_bytes_per_token=float(kv))

    @classmethod
    def from_checkpoint_bytes(cls, name: str, checkpoint_bytes: int,
                              dtype_bytes: int = 2
                              ) -> "ModelServiceProfile":
        """Estimate from checkpoint size alone (bf16: N = bytes / 2).

        KV bytes/token uses the GQA-era ratio kv ~ 3e-6 * weights
        (Qwen2.5-7B: 56 KB/token vs 14.9 GB; Llama-70B: 320 KB vs
        140 GB) -- good to ~2x across 7B-70B, and the KV term is a
        small correction to the weight stream anyway.
        """
        n = checkpoint_bytes / dtype_bytes
        return cls(name=name, weight_bytes=float(checkpoint_bytes),
                   flops_per_token=2.0 * n,
                   kv_bytes_per_token=3e-6 * checkpoint_bytes)


class ServiceTimeModel:
    """How long one request occupies a decode slot on a given device."""

    name = "base"

    def request_service_s(self, spec, device, batch: int) -> float:
        """Service time for one request admitted at `batch` occupancy
        (the request itself included).  ``spec`` is a FleetModelSpec-like
        record; ``device`` a DeviceInstance-like (``.profile``/``.sku``)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ConstantServiceTime(ServiceTimeModel):
    """Occupancy-blind constant (the legacy ``FleetScenario.service_s``;
    0.0 reproduces the paper's service-energy-held-constant convention)."""

    service_s: float = 0.0
    name = "constant"

    def request_service_s(self, spec, device, batch: int) -> float:
        return self.service_s


@dataclasses.dataclass(frozen=True)
class RooflineServiceTime(ServiceTimeModel):
    """Roofline prefill/decode times from per-SKU throughput numbers."""

    shape: RequestShape = RequestShape()
    mfu: float = 0.4               # model-FLOP utilization for compute terms
    overhead_s: float = 0.01       # scheduling/tokenizer/network floor

    name = "roofline"

    def _profile_for(self, spec) -> ModelServiceProfile:
        svc = getattr(spec, "service", None)
        if svc is not None:
            return svc
        ckpt = getattr(spec, "checkpoint_bytes", None)
        if ckpt:
            return ModelServiceProfile.from_checkpoint_bytes(
                getattr(spec, "model_id", "model"), ckpt)
        # loader-only spec: assume a 7B-class bf16 checkpoint
        return ModelServiceProfile.from_checkpoint_bytes(
            getattr(spec, "model_id", "model"), 15 * GB)

    @staticmethod
    def _throughput(device) -> tuple:
        """(bytes/s, flop/s) roofs, validated: a SKU constructed without
        tflops_bf16 (it defaults to 0.0) must fail HERE with a clear
        message, not as a ZeroDivisionError deep in the event loop."""
        bw = device.profile.mem_bw_gbps * 1e9
        tflops = device.sku.tflops_bf16 * 1e12
        if bw <= 0 or tflops <= 0:
            raise ValueError(
                f"SKU {device.sku.key!r} lacks throughput numbers for the "
                f"roofline service model (mem_bw_gbps="
                f"{device.profile.mem_bw_gbps}, tflops_bf16="
                f"{device.sku.tflops_bf16}); set both in fleet/catalog.py")
        return bw, tflops

    def prefill_s(self, msp: ModelServiceProfile, device) -> float:
        _, tflops = self._throughput(device)
        return self.shape.prompt_tokens * msp.flops_per_token \
            / (tflops * self.mfu)

    def decode_step_s(self, msp: ModelServiceProfile, device,
                      batch: int) -> float:
        """One batched decode step: the weight stream is shared by the
        whole batch; each sequence adds its KV read + its compute."""
        bw, tflops = self._throughput(device)
        tflops *= self.mfu
        mean_ctx = self.shape.prompt_tokens + self.shape.output_tokens / 2
        per_seq = (msp.kv_bytes_per_token * mean_ctx / bw
                   + msp.flops_per_token / tflops)
        return msp.weight_bytes / bw + max(batch, 1) * per_seq

    def request_service_s(self, spec, device, batch: int) -> float:
        msp = self._profile_for(spec)
        return (self.overhead_s + self.prefill_s(msp, device)
                + self.shape.output_tokens
                * self.decode_step_s(msp, device, batch))

    def decode_tokens_per_s(self, spec, device, batch: int = 1) -> float:
        """Aggregate decode throughput at a given occupancy (reporting)."""
        msp = self._profile_for(spec)
        return max(batch, 1) / self.decode_step_s(msp, device, batch)
