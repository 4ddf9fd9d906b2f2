"""Core library: the paper's structure-aware simulation strategy in PyTorch."""

from repro_torch.core.areas import (
    AreaSpec,
    MultiAreaSpec,
    mam_benchmark_spec,
    mam_spec,
    ring_area_adjacency,
)
from repro_torch.core.connectivity import Network, build_network, network_from_numpy
from repro_torch.core.delivery import BACKENDS as DELIVERY_BACKENDS
from repro_torch.core.exchange import EXCHANGES
from repro_torch.core.engine import (
    ConfigError,
    ConfigViolation,
    Engine,
    EngineConfig,
    SimState,
)
from repro_torch.core.factory import make_simulation
from repro_torch.core.schedule import run_windows, state_from_numpy

__all__ = [
    "AreaSpec",
    "MultiAreaSpec",
    "mam_benchmark_spec",
    "mam_spec",
    "ring_area_adjacency",
    "Network",
    "build_network",
    "network_from_numpy",
    "DELIVERY_BACKENDS",
    "EXCHANGES",
    "ConfigError",
    "ConfigViolation",
    "Engine",
    "EngineConfig",
    "SimState",
    "make_simulation",
    "run_windows",
    "state_from_numpy",
]
