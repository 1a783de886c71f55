"""Step builders of the LM zoo (prefill so far)."""
from .steps import make_prefill_step

__all__ = ["make_prefill_step"]
