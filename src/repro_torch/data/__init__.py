from .pipeline import DataConfig, make_batch, synthetic_batch_iter

__all__ = ["DataConfig", "make_batch", "synthetic_batch_iter"]
