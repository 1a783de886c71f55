"""The paper's primary contribution: the MRSch DFP scheduling agent, its
sequential and vectorised training, the ``Policy`` protocol and the
comparison policies (FCFS, GA, ScalarRL)."""
from .agent import AgentConfig, MRSchAgent
from .dfp import (DFPConfig, DFPNetwork, action_values, greedy_action,
                  greedy_actions_packed, loss_fn, predict)
from .encoding import (EncodingConfig, decision_row_dim, encode_decision_row,
                       encode_measurement, encode_state, encoding_for,
                       pad_decision_rows)
from .goal import ctx_goal, goal_vector
from .policies import (FCFSPolicy, GAConfig, GAOptimizer, ScalarRLConfig,
                       ScalarRLPolicy)
from .policy_api import Policy, WindowPolicy, supports_batch, supports_device
from .replay import (Episode, EpisodeRecorder, ReplayBuffer,
                     VectorEpisodeRecorder)
from .train import (EnvSlot, TrainConfig, TrainLog, evaluate,
                    slots_from_jobsets, train_agent, train_agent_vectorized)

__all__ = [
    "AgentConfig", "MRSchAgent", "DFPConfig", "DFPNetwork", "action_values",
    "greedy_action", "greedy_actions_packed", "loss_fn", "predict",
    "EncodingConfig", "decision_row_dim", "encode_decision_row",
    "encode_measurement", "encode_state", "encoding_for",
    "pad_decision_rows", "ctx_goal",
    "goal_vector", "FCFSPolicy", "GAConfig", "GAOptimizer",
    "ScalarRLConfig", "ScalarRLPolicy", "Policy", "WindowPolicy",
    "supports_batch", "supports_device", "Episode", "EpisodeRecorder", "ReplayBuffer",
    "VectorEpisodeRecorder", "EnvSlot", "TrainConfig", "TrainLog",
    "evaluate", "slots_from_jobsets", "train_agent",
    "train_agent_vectorized",
]
