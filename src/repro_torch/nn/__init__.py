from .backend import BACKENDS, dense_forward, mlp_forward, resolve_backend
from .modules import MLP, Dense, count_params, he_init

__all__ = ["BACKENDS", "dense_forward", "mlp_forward", "resolve_backend",
           "MLP", "Dense", "count_params", "he_init"]
