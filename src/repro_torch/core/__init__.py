"""The MRSch DFP scheduling agent (evaluation mode)."""
from .agent import AgentConfig, MRSchAgent
from .dfp import (DFPConfig, DFPNetwork, action_values, greedy_action,
                  greedy_actions_packed, predict)
from .encoding import (EncodingConfig, decision_row_dim, encode_decision_row,
                       encode_measurement, encode_state, pad_decision_rows)
from .goal import ctx_goal, goal_vector

__all__ = [
    "AgentConfig", "MRSchAgent", "DFPConfig", "DFPNetwork", "action_values",
    "greedy_action", "greedy_actions_packed", "predict", "EncodingConfig",
    "decision_row_dim", "encode_decision_row", "encode_measurement",
    "encode_state", "pad_decision_rows", "ctx_goal", "goal_vector",
]
