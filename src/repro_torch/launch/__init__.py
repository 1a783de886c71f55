"""Step builders and the serving entry point of the LM zoo."""
from .steps import make_decode_step, make_prefill_step

__all__ = ["make_decode_step", "make_prefill_step"]
