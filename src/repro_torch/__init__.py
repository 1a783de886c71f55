"""PyTorch/CUDA port of the MRSch reproduction (the JAX package ``repro``
is the reference).  This package imports torch and numpy, never jax and
nothing of ``repro``; each module mirrors its counterpart in ``repro``.

Ported so far: the scheduler's paths — host simulator, Theta workloads,
state encoding, the DFP network ("mlp", "cnn" and "attention" state
modules), the decision service, the device rollout and lockstep engines,
sequential and vectorised training, the comparison policies, the
baseline zoo, the evaluation matrix and tournament, checkpoints and
telemetry — and the LM zoo's prefill (configs, batches, the decoder stack for the
dense, vlm, audio, ssm and hybrid families), with every TPU kernel of
the reference as a CUDA kernel for Hopper (``kernels/``).
"""
