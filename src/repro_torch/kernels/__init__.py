"""Hand-written Hopper kernels, one package each: ``kernel`` (build and
launch), ``ops`` (checked public wrapper with a launch count) and ``ref``
(plain PyTorch version: the CPU path and the oracle)."""


def refuse_dtensors(name: str, label: str, named: dict) -> None:
    """Raise if any of ``named``'s operands is a DTensor: a kernel takes
    whole tensors on one card, and a sharded model runs the plain
    ``"torch"`` backend."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in named.values()):
        raise RuntimeError(
            f"{name}: {label} takes no DTensor; run sharded models on the "
            f"\"torch\" backend")
