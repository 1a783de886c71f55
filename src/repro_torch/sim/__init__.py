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
                        Simulator, run_trace)

__all__ = [
    "TTF_HORIZON", "Cluster", "ResourceSpec", "Job", "MetricsAccumulator",
    "ScheduleMetrics", "ENGINES", "SchedContext", "SimConfig", "SimResult",
    "Simulator", "run_trace",
    "DeviceRollout", "DeviceSimulator", "DeviceStats", "run_traces_device",
    "HELD", "ELIGIBLE", "QUEUED", "RUNNING", "FINISHED", "FAILED",
    "STATE_NAMES", "DEFAULT_MAX_REQUEUES", "DrainEvent", "FaultSchedule",
    "JobLifecycle", "cascade_failures", "pipeline_makespan",
    "workflow_components", "work_summary",
]
