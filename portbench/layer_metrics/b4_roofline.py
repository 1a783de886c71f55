"""B4, the deciding round's fused front (``kernels/window_pack``'s
``decision_rows_kernel``), against its roofline on this data: the mean
call's bytes and operations over the probe's calls
(``yardstick.front_cost``: the waiting, running and selected jobs it
counted), times the calls the trace holds, over their summed time."""
import numpy as np

from portbench import yardstick


def read(ctx):
    t = ctx.trace.seconds(yardstick.B4)
    n = ctx.trace.count(yardstick.B4)
    if t <= 0 or n == 0 or len(ctx.front) == 0:
        return None
    lay = ctx.layout
    R = lay.n_resources
    K = lay.queue_cap if lay.state_module == "attention" else lay.window
    row_dim = lay.state_dim + 2 * R + lay.window
    per_call = np.mean([
        yardstick.bound_s(*yardstick.front_cost(
            yardstick.FrontCall(lay.n_envs, lay.n_jobs, *map(int, row)),
            R, lay.n_units, K, row_dim))
        for row in ctx.front])
    return 100.0 * float(per_call) * n / t
