"""PyTorch/CUDA port of the MRSch reproduction (the JAX package ``repro``
is the reference).  This package imports torch and numpy, never jax and
nothing of ``repro``; each module mirrors its counterpart in ``repro``.

Ported so far: the decision-service path — host simulator, Theta
workloads, state encoding, the DFP network (inference, "mlp" state
module) with the fused-MLP forward as a CUDA kernel for Hopper, the
evaluation-mode agent, and the micro-batched decision service.
"""
