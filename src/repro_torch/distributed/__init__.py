"""Distribution: the logical-axis sharding rules on ``DeviceMesh``/DTensor
(``sharding``), the collectives and vocab- and head-parallel ops the
models run on local shards (``collectives``), the analytic cost model
(``costs``) and the dry run's counter (``comm_analysis``)."""
from .sharding import (Rules, current_rules, default_rules, named_sharding,
                       param_pspecs, param_shardings, shard, tp_row_matmul,
                       use_rules)

__all__ = ["Rules", "current_rules", "default_rules", "named_sharding",
           "param_pspecs", "param_shardings", "shard", "tp_row_matmul",
           "use_rules"]
