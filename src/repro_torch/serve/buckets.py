"""Shape buckets for padded batched inference.

A serving workload offers an arbitrary mix of batch widths; padding
every batch up to one of a small fixed set of bucket widths (powers of
two up to ``max_batch``) keeps the set of forward shapes finite, so
whatever is specialised per shape (the JAX package's jit cache; in this
package, the kernel launch shapes, and later a CUDA graph per width) is
prepared once per bucket, at ``warmup``.

The cache tracks which widths have been dispatched, so the service can
report first dispatches ("compiles", the JAX package's name, kept so
``stats()`` has one schema) vs. bucket hits, and tests can pin that
steady-state serving adds no new width.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Tuple


def bucket_widths(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to (and including) the padded ``max_batch``."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out: List[int] = []
    w = 1
    while w < max_batch:
        out.append(w)
        w <<= 1
    out.append(w)                  # smallest power of two >= max_batch
    return tuple(out)


class BucketCache:
    """Pick padded widths and account for compile-cache behaviour."""

    def __init__(self, max_batch: int):
        self.widths = bucket_widths(max_batch)
        self._lock = threading.Lock()
        self._seen: Dict[int, int] = {}     # width -> dispatch count

    def width_for(self, n: int) -> int:
        """Smallest bucket that fits ``n`` rows."""
        if n < 1:
            raise ValueError(f"batch must have >= 1 rows, got {n}")
        for w in self.widths:
            if n <= w:
                return w
        raise ValueError(
            f"batch of {n} exceeds the largest bucket {self.widths[-1]}")

    def record(self, width: int) -> bool:
        """Account one dispatch at ``width``; True when it is the first
        at this width."""
        with self._lock:
            first = width not in self._seen
            self._seen[width] = self._seen.get(width, 0) + 1
            return first

    def stats(self) -> Dict[str, object]:
        with self._lock:
            seen = dict(sorted(self._seen.items()))
        dispatches = sum(seen.values())
        return {
            "buckets": list(self.widths),
            "compiled_widths": list(seen),
            "compiles": len(seen),
            "dispatches": dispatches,
            "bucket_hits": dispatches - len(seen),
        }
