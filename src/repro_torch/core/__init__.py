"""The paper's contribution: parking-tax power model, power-state
machine, measurement pipeline, breakeven model, and eviction
scheduling."""
from repro_torch.core.power_model import (A100, H100, L40S, PROFILES,
                                          TPU_V5E, DeviceProfile,
                                          get_profile)
from repro_torch.core.power_states import (IllegalPowerTransition,
                                           LEGAL_TRANSITIONS, PowerState,
                                           PowerStateMachine,
                                           TransitionModel, can_transition,
                                           gate_breakeven_s, state_power_w,
                                           wake_penalty_j)
from repro_torch.core.breakeven import (breakeven_seconds,
                                        critical_rate_per_hr, table4)
from repro_torch.core.coldstart import (LoaderSpec, TABLE4_LOADERS,
                                        QWEN25_7B_MEASURED, PYTORCH_70B,
                                        SERVERLESSLLM_70B,
                                        RUNAI_STREAMER_8B,
                                        loader_from_checkpoint)
from repro_torch.core.scheduler import (AdaptiveBreakeven, AlwaysOn,
                                        Breakeven, Clairvoyant,
                                        ExactBreakeven, FixedTTL, Policy)
from repro_torch.core.simulator import SimResult, compare_policies, simulate

__all__ = [
    "A100", "H100", "L40S", "TPU_V5E", "PROFILES", "DeviceProfile",
    "get_profile",
    "PowerState", "PowerStateMachine", "TransitionModel",
    "IllegalPowerTransition", "LEGAL_TRANSITIONS", "can_transition",
    "state_power_w", "gate_breakeven_s", "wake_penalty_j",
    "breakeven_seconds", "critical_rate_per_hr", "table4",
    "LoaderSpec", "TABLE4_LOADERS", "QWEN25_7B_MEASURED", "PYTORCH_70B",
    "SERVERLESSLLM_70B", "RUNAI_STREAMER_8B", "loader_from_checkpoint",
    "Policy", "AlwaysOn", "FixedTTL", "Breakeven", "ExactBreakeven",
    "AdaptiveBreakeven", "Clairvoyant", "SimResult", "simulate",
    "compare_policies",
]
