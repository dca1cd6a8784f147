"""Chunked device-to-host fetches for scoring sweeps — the port's
counterpart of ``fast_tffm_tpu/utils/fetch.py:ChunkedFetcher``.

A fetch per batch makes the host wait for the card every step, while
holding a whole sweep's scores grows device memory without bound.
``ChunkedFetcher`` takes the middle road: it accumulates score tensors
and every ``chunk`` additions copies them to the host in one
non-blocking copy into a pinned buffer, behind a CUDA event, and hands
the chunk to one worker thread, which waits for the event and runs the
consumer on the host arrays, in add order, while the caller goes on
launching the next chunk's work. Tensors on the CPU take the same path
without the copy. With a run's telemetry active, each chunk is a
``fetch/bulk`` span and adds to ``fetch/d2h_seconds``, on the worker.

``fetch_floats`` is the one fetch of the buffered scalars (the metrics
sink's barrier, the TensorBoard summaries): device tensors stacked per
device and copied in one ``.cpu()`` each.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

# Enough batches a chunk to amortize the wait, few enough to bound the
# device tensors held (256 x [B] f32 ~ 8 MB at B = 8192).
FETCH_CHUNK_BATCHES = 256


class ChunkedFetcher:
    """``add(tensor, meta)`` accumulates; every ``chunk`` adds (and at
    ``flush()``) the pending tensors are fetched together and
    ``consume(host_array, meta)`` runs for each on the worker thread,
    in add order. At most one fetched chunk waits behind the worker (a
    second full chunk blocks the producer), so the device tensors held
    stay within about 3 chunks. ``flush()`` fetches everything, joins
    the worker and re-raises its error, if any; ``close()``, for
    ``finally`` blocks, drops what is pending and always joins the
    worker without raising, so an exception on its way out is never
    masked and no thread is left behind."""

    def __init__(self, consume: Callable[[np.ndarray, Any], None],
                 chunk: int = FETCH_CHUNK_BATCHES):
        self._consume = consume
        self._chunk = chunk
        self._pending: List[Tuple[torch.Tensor, Any]] = []
        self._queue: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._err: List[BaseException] = []
        self._abandon = threading.Event()

    @property
    def pending_depth(self) -> int:
        """Entries held back for in-order delivery (the pending list and
        any full chunk queued behind the worker): the predict sweep's
        ``predict/fetch_depth`` histogram, a host-side read."""
        q = self._queue
        return len(self._pending) + (q.qsize() * self._chunk if q else 0)

    def add(self, tensor: torch.Tensor, meta: Any = None) -> None:
        if self._err:
            self.flush()  # raises the worker's error
        self._pending.append((tensor, meta))
        if len(self._pending) >= self._chunk:
            self._dispatch()

    def _dispatch(self) -> None:
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        if self._worker is None:
            self._queue = queue.Queue(maxsize=1)
            self._abandon.clear()
            self._worker = threading.Thread(
                target=self._worker_loop, args=(self._queue,),
                name="fetcher", daemon=True)
            self._worker.start()
        self._queue.put(_stage(batch))  # blocks while one chunk waits

    def _worker_loop(self, q: queue.Queue) -> None:
        while True:
            item = q.get()
            if item is None:
                return
            if self._err or self._abandon.is_set():
                continue  # drain without work after an error or close()
            try:
                self._fetch_and_consume(item)
            except BaseException as e:  # re-raised by add() / flush()
                self._err.append(e)

    def _fetch_and_consume(self, item) -> None:
        from fast_tffm_tpu_torch.obs.telemetry import active
        from fast_tffm_tpu_torch.obs.trace import span
        host, event, lengths, metas = item
        tel = active()
        t0 = time.perf_counter()
        with span("fetch/bulk", n=len(lengths)):
            if event is not None:
                event.synchronize()
            arr = host.numpy()
            off = 0
            for n, meta in zip(lengths, metas):
                self._consume(arr[off:off + n], meta)
                off += n
        if tel is not None:
            tel.count("fetch/d2h_seconds", time.perf_counter() - t0)

    def _join(self) -> None:
        if self._worker is not None:
            self._queue.put(None)
            self._worker.join()
            self._worker = None
            self._queue = None

    def flush(self) -> None:
        """Fetch and consume everything added so far, join the worker,
        and re-raise its error once; the fetcher is then clean for a
        new sweep."""
        self._dispatch()
        self._join()
        if self._err:
            e = self._err[0]
            self._err.clear()
            raise e

    def close(self) -> None:
        """Drop pending work, join the worker, swallow its errors."""
        self._pending.clear()
        self._abandon.set()
        self._join()
        self._err.clear()


def _stage(batch: List[Tuple[torch.Tensor, Any]]):
    """One chunk's tensors as one host tensor: on the card, concatenated
    and copied without blocking into pinned memory, with the event the
    worker waits on; on the CPU, concatenated."""
    flat = [t.reshape(-1) for t, _ in batch]
    lengths = [t.numel() for t in flat]
    metas = [m for _, m in batch]
    dev = torch.cat(flat) if len(flat) > 1 else flat[0]
    if not dev.is_cuda:
        return dev.detach(), None, lengths, metas
    host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
    host.copy_(dev, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event, lengths, metas


def fetch_floats(values) -> List[float]:
    """``values`` (tensors of one element, or host numbers) as Python
    floats, in order: the tensors of each device stacked and copied to
    the host in one ``.cpu()``, so N buffered device scalars cost one
    transfer, not N."""
    out: List[Optional[float]] = [None] * len(values)
    groups: dict = {}
    for i, v in enumerate(values):
        if isinstance(v, torch.Tensor):
            groups.setdefault((v.device, v.dtype), []).append(i)
        else:
            out[i] = float(v)
    for idx in groups.values():
        host = torch.stack([values[i].detach().reshape(())
                            for i in idx]).cpu().double().tolist()
        for i, val in zip(idx, host):
            out[i] = val
    return out
