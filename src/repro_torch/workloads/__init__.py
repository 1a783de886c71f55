"""Workloads: the Theta-like generator, the paper's scenarios, the named
scenario registry, drift, curriculum jobsets and the sweep harness."""
from ..sim.lifecycle import DrainEvent, FaultSchedule
from .drift import (DriftPhase, DriftSchedule, PhaseResult, apply_drift,
                    run_phases, segment_jobs, step_schedule)
from .jobsets import (Curriculum, build_curriculum, real_jobsets,
                      sampled_jobsets, synthetic_jobsets)
from .registry import (ScenarioSpec, build_jobs, build_many, get_scenario,
                       register, register_swf, scenario_names)
from .scenarios import SCENARIOS, build_scenarios, derive_scenario, with_power
from .sweep import (SweepTask, build_sweep, build_train_mix, run_sweep,
                    scale_resources)
from .theta import (THETA_BB_UNITS, THETA_NODES, ThetaConfig, generate_trace,
                    jobs_from_swf)

__all__ = [
    "Curriculum", "build_curriculum", "real_jobsets", "sampled_jobsets",
    "synthetic_jobsets", "SCENARIOS", "build_scenarios", "derive_scenario",
    "with_power", "SweepTask", "build_sweep", "build_train_mix", "run_sweep",
    "scale_resources",
    "DriftPhase", "DriftSchedule", "PhaseResult", "apply_drift",
    "run_phases", "segment_jobs", "step_schedule",
    "DrainEvent", "FaultSchedule",
    "ScenarioSpec", "build_jobs", "build_many", "get_scenario",
    "register", "register_swf", "scenario_names",
    "THETA_BB_UNITS", "THETA_NODES", "ThetaConfig",
    "generate_trace", "jobs_from_swf",
]
