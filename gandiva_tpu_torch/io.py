"""Streaming batch IO: overlap host-side Arrow conversion with device compute.

The torch counterpart of gandiva_tpu.io. The reference's deployment streams
record batches through compiled plans (Make once / Evaluate many,
gandiva.pyx:634-636) with IO on the engine's own threads (SURVEY.md §3.5).
Here the host-side work per batch — validity unpacking, decimal limb
splitting, padding, the host→device copy (``from_arrow``) — runs on a worker
thread a batch ahead, so it hides behind the device's work on the batch
before.

``evaluate_stream`` drives any compiled plan (Projector / Filter /
FilterProject) over an iterable of pyarrow batches, on the plan's device.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

from .batch import Batch, from_arrow
from .device import DEFAULT_DEVICE


class BatchPrefetcher:
    """Iterator wrapper: converts upcoming pyarrow batches to device Batches
    on a worker thread, ``depth`` batches ahead. An exception of the source
    or the conversion is raised to the consumer after the batches before
    it."""

    _SENTINEL = object()

    def __init__(self, batches: Iterable, depth: int = 2,
                 pad_to: Optional[int] = None,
                 convert: Optional[Callable] = None,
                 device=DEFAULT_DEVICE):
        self._convert = convert or (
            lambda b: from_arrow(b, pad_to=pad_to, device=device))
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._worker, args=(iter(batches),), daemon=True)
        self._thread.start()

    def _worker(self, it):
        try:
            for b in it:
                self._q.put(self._convert(b))
        except BaseException as e:  # noqa: BLE001 — raised on the consumer
            self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self) -> Iterator[Batch]:
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                self._thread.join()
                if self._err is not None:
                    raise self._err
                return
            yield item


def evaluate_stream(plan, batches: Iterable, depth: int = 2,
                    pad_to: Optional[int] = None, device_only: bool = False):
    """Evaluate a compiled plan over a stream of pyarrow record batches.

    Yields the plan's evaluate() result per batch (or evaluate_device()
    results when ``device_only`` — no host copy of outputs, for
    engine-internal pipelines). Conversion onto the plan's device runs one
    batch ahead on a worker thread."""
    for dev_batch in BatchPrefetcher(batches, depth=depth, pad_to=pad_to,
                                     device=plan.device):
        if device_only:
            yield plan.evaluate_device(dev_batch)
        else:
            yield plan.evaluate(dev_batch)
