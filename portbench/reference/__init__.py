"""Plain reference of the benchmark's cells: the scheduler and its state
encoding in NumPy (``sched``), the DFP network in plain PyTorch (``dfp``).
It imports nothing of the program and nothing of a JAX package."""
