"""B1, the fused dense layer's forward (``kernels/fused_mlp``), against
its roofline: the window's forwards (one a deciding round, every
environment's row) costed layer by layer at M = rows (x, W, b read once,
y written once; 2MKN flops at the float32 peak), over the summed time of
the forward kernels and their split-K epilogue."""
from portbench import yardstick


def read(ctx):
    t = ctx.trace.seconds(yardstick.B1_FORWARD)
    if t <= 0:
        return None
    bound = (ctx.window.deciding_rounds
             * yardstick.b1_forward_bound_s(ctx.config, ctx.layout.n_envs))
    return 100.0 * bound / t
