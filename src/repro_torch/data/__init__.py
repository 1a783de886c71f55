from .pipeline import DataConfig, input_specs, make_batch, synthetic_batch_iter

__all__ = ["DataConfig", "input_specs", "make_batch", "synthetic_batch_iter"]
