"""Online scheduling-decision service: micro-batched DFP inference with
hot-reloadable checkpoints."""
from .batcher import MicroBatcher, Ticket
from .buckets import BucketCache, bucket_widths
from .reload import CheckpointWatcher
from .replay import ServicePolicy, ServiceSim
from .service import DecisionResponse, DecisionService, ServeConfig

__all__ = [
    "MicroBatcher", "Ticket", "BucketCache", "bucket_widths",
    "CheckpointWatcher", "ServicePolicy", "ServiceSim",
    "DecisionResponse", "DecisionService", "ServeConfig",
]
