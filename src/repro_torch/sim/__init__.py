from .cluster import TTF_HORIZON, Cluster, ResourceSpec
from .device import (DeviceRollout, DeviceSimulator, DeviceStats,
                     run_traces_device)
from .job import Job
from .lifecycle import (DEFAULT_MAX_REQUEUES, ELIGIBLE, FAILED, FINISHED,
                        HELD, QUEUED, RUNNING, STATE_NAMES, DrainEvent,
                        FaultSchedule, JobLifecycle, cascade_failures,
                        pipeline_makespan, workflow_components, work_summary)
from .metrics import MetricsAccumulator, ScheduleMetrics
from .simulator import (ENGINES, SchedContext, SimConfig, SimResult,
                        Simulator, run_trace, sim_config)
from .vector import (BatchSchedulingPolicy, VectorSimulator, VectorStats,
                     run_traces)

__all__ = [
    "TTF_HORIZON", "Cluster", "ResourceSpec", "Job", "MetricsAccumulator",
    "ScheduleMetrics", "ENGINES", "SchedContext", "SimConfig", "SimResult",
    "Simulator", "run_trace", "sim_config",
    "BatchSchedulingPolicy", "VectorSimulator", "VectorStats", "run_traces",
    "DeviceRollout", "DeviceSimulator", "DeviceStats", "run_traces_device",
    "HELD", "ELIGIBLE", "QUEUED", "RUNNING", "FINISHED", "FAILED",
    "STATE_NAMES", "DEFAULT_MAX_REQUEUES", "DrainEvent", "FaultSchedule",
    "JobLifecycle", "cascade_failures", "pipeline_makespan",
    "workflow_components", "work_summary",
]
