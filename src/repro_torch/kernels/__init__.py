"""Hand-written Hopper kernels, one package each: ``kernel`` (build and
launch), ``ops`` (checked public wrapper with a launch count) and ``ref``
(plain PyTorch version: the CPU path and the oracle)."""
