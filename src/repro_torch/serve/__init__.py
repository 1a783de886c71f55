"""Online scheduling-decision service: micro-batched DFP inference."""
from .batcher import MicroBatcher, Ticket
from .buckets import BucketCache, bucket_widths
from .replay import ServicePolicy, ServiceSim
from .service import DecisionResponse, DecisionService, ServeConfig

__all__ = [
    "MicroBatcher", "Ticket", "BucketCache", "bucket_widths",
    "ServicePolicy", "ServiceSim",
    "DecisionResponse", "DecisionService", "ServeConfig",
]
