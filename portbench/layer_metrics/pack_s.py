"""Seconds the device engine's constructor spends copying, sorting and
packing the traces into device tensors: the program's ``setup.pack``
span (``DeviceSimulator(spans=)``)."""


def read(ctx):
    packs = [s.end_ns - s.start_ns for s in getattr(ctx, "spans", None) or ()
             if s.name == "setup.pack"]
    return sum(packs) / 1e9 if packs else None
