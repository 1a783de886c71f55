"""PyTorch/CUDA port of the MRSch reproduction (the JAX package ``repro``
is the reference).  This package imports torch and numpy, never jax and
nothing of ``repro``; each module mirrors its counterpart in ``repro``.

Ported so far: the scheduler's paths — host simulator, Theta workloads,
state encoding, the DFP network ("mlp", "cnn" and "attention" state
modules), the decision service, the device rollout and lockstep engines,
sequential and vectorised training, the comparison policies, the
baseline zoo, the evaluation matrix and tournament, checkpoints and
telemetry — and the LM zoo's prefill, decode and training (configs,
batches, the decoder stack for every family, the loss with remat, AdamW
and the training driver), with every TPU kernel of the reference as a
CUDA kernel for Hopper (``kernels/``).
"""
