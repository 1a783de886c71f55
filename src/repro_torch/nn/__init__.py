from .backend import BACKENDS, dense_forward, mlp_forward, resolve_backend
from .modules import MLP, Dense, count_params, he_init
from .optim import AdamState, adam_init, adam_update

__all__ = ["BACKENDS", "dense_forward", "mlp_forward", "resolve_backend",
           "MLP", "Dense", "count_params", "he_init", "AdamState",
           "adam_init", "adam_update"]
