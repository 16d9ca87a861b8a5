from repro_torch.serving.energy import EnergyMeter, SimClock
from repro_torch.serving.engine import GenerationResult, ServingEngine
from repro_torch.serving.model_manager import ManagedModel, ModelManager
from repro_torch.serving.service_model import (ConstantServiceTime,
                                               ModelServiceProfile,
                                               RequestShape,
                                               RooflineServiceTime,
                                               ServiceTimeModel)
from repro_torch.serving.slots import DeviceRuntime, SlotPool

__all__ = ["EnergyMeter", "SimClock", "ServingEngine", "GenerationResult",
           "ModelManager", "ManagedModel",
           "SlotPool", "DeviceRuntime", "ServiceTimeModel",
           "ConstantServiceTime", "RooflineServiceTime",
           "ModelServiceProfile", "RequestShape"]
