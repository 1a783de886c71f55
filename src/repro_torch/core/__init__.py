"""The MRSch DFP scheduling agent, its sequential training, the ``Policy``
protocol and FCFS."""
from .agent import AgentConfig, MRSchAgent
from .dfp import (DFPConfig, DFPNetwork, action_values, greedy_action,
                  greedy_actions_packed, loss_fn, predict)
from .encoding import (EncodingConfig, decision_row_dim, encode_decision_row,
                       encode_measurement, encode_state, pad_decision_rows)
from .goal import ctx_goal, goal_vector
from .policies import FCFSPolicy
from .policy_api import Policy, WindowPolicy, supports_batch, supports_device
from .replay import Episode, EpisodeRecorder, ReplayBuffer
from .train import TrainLog, evaluate, train_agent

__all__ = [
    "AgentConfig", "MRSchAgent", "DFPConfig", "DFPNetwork", "action_values",
    "greedy_action", "greedy_actions_packed", "loss_fn", "predict",
    "EncodingConfig", "decision_row_dim", "encode_decision_row",
    "encode_measurement", "encode_state", "pad_decision_rows", "ctx_goal",
    "goal_vector", "FCFSPolicy", "Policy", "WindowPolicy", "supports_batch",
    "supports_device", "Episode", "EpisodeRecorder", "ReplayBuffer",
    "TrainLog", "evaluate", "train_agent",
]
