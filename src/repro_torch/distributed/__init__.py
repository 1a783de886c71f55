"""One-card stand-ins for the JAX package's ``distributed`` helpers."""
from .sharding import shard, tp_row_matmul

__all__ = ["shard", "tp_row_matmul"]
