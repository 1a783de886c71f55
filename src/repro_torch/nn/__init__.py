from .backend import BACKENDS, dense_forward, mlp_forward, resolve_backend
from .modules import MLP, Conv1d, Dense, conv1d_apply, count_params, he_init
from .optim import AdamState, adam_init, adam_update
from .queue_encoder import (QueueEncoder, QueueEncoderConfig,
                            encode_queue_tokens, queue_state_features)

__all__ = ["BACKENDS", "dense_forward", "mlp_forward", "resolve_backend",
           "MLP", "Conv1d", "Dense", "conv1d_apply", "count_params",
           "he_init", "AdamState",
           "adam_init", "adam_update", "QueueEncoder", "QueueEncoderConfig",
           "encode_queue_tokens", "queue_state_features"]
