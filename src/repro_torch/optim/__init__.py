"""The LM zoo's optimizer: AdamW (factored second moment included) and the
learning-rate schedules."""
from .adamw import OptConfig, opt_init, opt_update
from .schedule import make_schedule

__all__ = ["OptConfig", "make_schedule", "opt_init", "opt_update"]
