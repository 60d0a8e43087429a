from multimodal_flows.dynamics.thermostats import (
    ConstantThermostat,
    InverseSquareThermostat,
    InverseThermostat,
    LinearThermostat,
    SigmoidThermostat,
    Thermostat,
    THERMOSTAT_REGISTRY,
)
from multimodal_flows.dynamics.bridges import RandomTelegraphBridge, UniformFlow
from multimodal_flows.dynamics import solvers

__all__ = [
    "Thermostat",
    "ConstantThermostat",
    "InverseThermostat",
    "LinearThermostat",
    "InverseSquareThermostat",
    "SigmoidThermostat",
    "THERMOSTAT_REGISTRY",
    "UniformFlow",
    "RandomTelegraphBridge",
    "solvers",
]
