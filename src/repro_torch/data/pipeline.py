"""Host data pipeline with prefetch and straggler mitigation.

The counterpart of ``repro.data.pipeline``. A background thread pulls
batches from an iterator into a bounded queue, placing each with
``put_fn`` (``device_put_batch``: a pinned, non-blocking copy to the
card). If the producer misses the ``timeout_s`` budget (a slow storage
shard, a preprocessing straggler), the consumer re-serves the previous
batch and counts it instead of stalling the step. An error raised by the
iterator surfaces on the ``__next__`` after the batches made before it,
and again on every later call.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional

import torch


class PrefetchPipeline:
    def __init__(self, batch_iter: Iterator[Any], *,
                 put_fn: Optional[Callable[[Any], Any]] = None,
                 depth: int = 2, timeout_s: float = 30.0):
        self._iter = batch_iter
        self._put = put_fn or (lambda x: x)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._done = False          # the producer's end has been read
        self.stats = {"served": 0, "repeats": 0, "produced": 0}
        self._last = None
        self.timeout_s = timeout_s
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        try:
            for batch in self._iter:
                if self._stop.is_set():
                    return
                self._q.put(self._put(batch))
                self.stats["produced"] += 1
        except BaseException as e:  # surfaced by __next__ after the queue
            self._err = e
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        try:
            batch = self._q.get(timeout=self.timeout_s)
        except queue.Empty:
            # straggler: the producer missed the deadline; re-serve the
            # last batch
            if self._last is None:
                batch = self._q.get()     # the first batch: must wait
            else:
                self.stats["repeats"] += 1
                self.stats["served"] += 1
                return self._last
        if batch is None:
            self._done = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        self._last = batch
        self.stats["served"] += 1
        return batch

    def close(self):
        """Stop the producer and join it: it finishes the batch it is
        making, and the queue is drained until it has exited."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)


def device_put_batch(batch: Dict[str, torch.Tensor], target
                     ) -> Dict[str, Any]:
    """A host batch onto ``target``: a device, or a dict of per-key
    ``dist.sharding.NamedSharding`` (a key without one stays as it is).

    To a card through pinned memory with a non-blocking copy (ordered
    before later work on the same stream); tensors already there, or a
    CPU target, are returned as they are. With shardings each tensor goes
    to its mesh's device and becomes a DTensor of its placements (every
    rank holds the same batch)."""
    if isinstance(target, dict):
        from repro_torch.dist.sharding import distribute, mesh_device
        out = {}
        for k, v in batch.items():
            shd = target.get(k)
            out[k] = v if shd is None else distribute(
                _to(v, mesh_device(shd.mesh)), shd)
        return out
    dev = torch.device(target)
    return {k: _to(v, dev) for k, v in batch.items()}


def _to(v: torch.Tensor, dev: torch.device) -> torch.Tensor:
    if dev.type == "cuda" and v.device.type == "cpu":
        return v.pin_memory().to(dev, non_blocking=True)
    return v.to(dev)
