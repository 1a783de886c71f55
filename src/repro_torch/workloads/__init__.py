from .scenarios import SCENARIOS, build_scenarios, derive_scenario, with_power
from .theta import (THETA_BB_UNITS, THETA_NODES, ThetaConfig, generate_trace,
                    jobs_from_swf)

__all__ = [
    "SCENARIOS", "build_scenarios", "derive_scenario", "with_power",
    "THETA_BB_UNITS", "THETA_NODES", "ThetaConfig", "generate_trace",
    "jobs_from_swf",
]
