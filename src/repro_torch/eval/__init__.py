"""Evaluation harnesses pitting MRSch against its baselines at scale (the
JAX package's ``repro/eval``)."""
from .matrix import (MATRIX_SCHEMA, MatrixConfig, default_policies,
                     eval_factory, kiviat_scores, matrix_columns, matrix_csv, run_matrix,
                     save_matrix)
from .tournament import (TOURNAMENT_SCHEMA, TournamentConfig,
                         leaderboard_columns, render_leaderboard,
                         run_tournament, save_tournament, zoo_policies)

__all__ = [
    "MATRIX_SCHEMA", "MatrixConfig", "default_policies", "eval_factory",
    "kiviat_scores",
    "matrix_columns", "matrix_csv", "run_matrix", "save_matrix",
    "TOURNAMENT_SCHEMA", "TournamentConfig", "leaderboard_columns",
    "render_leaderboard", "run_tournament", "save_tournament", "zoo_policies",
]
