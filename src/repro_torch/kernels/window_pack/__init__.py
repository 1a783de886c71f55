"""Window pack: the first W waiting jobs per environment, and the device
round's front built around it (CUDA kernels, wrappers, plain versions)."""
from .ops import pack_decision_rows, pack_window
from .ref import (DecisionRows, DecisionRowSpec,
                  pack_decision_rows_reference, pack_window_reference)

__all__ = ["DecisionRows", "DecisionRowSpec", "pack_decision_rows",
           "pack_decision_rows_reference", "pack_window",
           "pack_window_reference"]
