"""Checkpoint hot-reload: watch a ``CheckpointManager`` directory and
atomically swap the served network (zero-downtime policy updates).

The watcher leans on the store's atomicity: ``save_pytree`` commits via
write-to-``.tmp`` + rename, so ``latest_step`` never names a half-written
checkpoint, and a step removed by retention between listing and reading is
retried on the next poll instead of killing the watcher.  A checkpoint
that restores but does not match the service's network (a different
architecture dropped into the watched directory) is rejected by
``DecisionService.update_params`` — the incident is counted and the
service keeps serving the weights it has.  Either package's checkpoints
load: the layout and the leaf paths are shared.

The restore copies the weights to the service's device from the watcher's
thread; the swap waits until those copies are complete, so the worker
never reads half-copied weights.

``check_once`` is the synchronous single poll (deterministic tests, or
callers with their own scheduler); ``start``/``stop`` run it on a
background thread every ``poll_interval_s``.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

from ..checkpoint import latest_step, restore_pytree
from .service import DecisionService


class CheckpointWatcher:
    """Poll a checkpoint directory; hot-swap new steps into a service."""

    def __init__(self, service: DecisionService, directory: str,
                 poll_interval_s: float = 1.0):
        self.service = service
        self.directory = directory
        self.poll_interval_s = float(poll_interval_s)
        self._loaded: Optional[int] = service.params_step
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._rejected = 0
        self._errors = 0

    # ------------------------------------------------------------ one poll
    def check_once(self) -> Optional[int]:
        """Load and swap in the newest unseen step; None when current.

        Never raises on transient store races (checkpoint removed
        mid-read); an incompatible checkpoint is counted as rejected and
        skipped — ``check_once`` will not retry it until a newer step
        appears.
        """
        step = None
        try:
            step = latest_step(self.directory)
            if step is None or (self._loaded is not None
                                and step <= self._loaded):
                return None
            net, _manifest = restore_pytree(self.service.params,
                                            self.directory, step)
            device = next(net.parameters()).device
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()
            self.service.update_params(net, step=step)
        except OSError:
            with self._lock:
                self._errors += 1        # racing the store's GC; next poll
            return None
        except (ValueError, KeyError):
            # Wrong architecture — or a stray step_* entry breaking the
            # directory listing itself (step is still None then).
            with self._lock:
                self._rejected += 1
            if step is not None:
                self._loaded = step      # don't re-reject every poll
            return None
        self._loaded = step
        return step

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "CheckpointWatcher":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.poll_interval_s):
                try:
                    self.check_once()
                except Exception:        # never let a poll kill the watcher
                    with self._lock:
                        self._errors += 1

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="mrsch-ckpt-watcher")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None

    def __enter__(self) -> "CheckpointWatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {"loaded_step": self._loaded, "rejected": self._rejected,
                    "transient_errors": self._errors}
