"""Serving front end: coalesce concurrent queries into one batched search.

Counterpart of the JAX package's ``runtime/batcher.py``. A batched search
costs little more than one query (the whole batch rides one traversal), but
callers arrive one query at a time. :class:`BatchedSearcher` puts a queue in
front of a :class:`~leann_torch.api.LeannSearcher`: a worker thread drains up
to ``max_batch`` requests that share identical search parameters within a
``max_wait_ms`` window, runs them as ONE ``search()`` call, and resolves each
caller's future.

Usage::

    bs = BatchedSearcher("./idx/book.leann", max_batch=16, max_wait_ms=2.0, device="cuda")
    # from any number of threads:
    hits = bs.search("what does Darcy say?", top_k=3)   # blocks
    fut = bs.submit("and Bingley?", top_k=3)             # non-blocking
    hits = fut.result()
    bs.close()

The searches run on the worker thread only. They set none of torch's
process-wide precision flags, so a caller thread's own setting holds
before, during and after a batch.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


class _Request:
    __slots__ = ("query", "params_key", "params", "future")

    def __init__(self, query: str, params_key: tuple, params: Dict[str, Any]):
        self.query = query
        self.params_key = params_key
        self.params = params
        self.future: Future = Future()


class BatchedSearcher:
    """Thread-safe batching front end over a LeannSearcher.

    Only requests with identical search parameters share a batch; a
    parameter change (top_k/complexity/...) flushes into its own batch.
    ``searcher_kwargs`` (``device=`` among them) go to the
    ``LeannSearcher`` built from an index path.
    """

    def __init__(self, index_or_searcher, max_batch: int = 16, max_wait_ms: float = 2.0, **searcher_kwargs):
        from ..api import LeannSearcher

        if isinstance(index_or_searcher, str) or hasattr(index_or_searcher, "__fspath__"):
            self.searcher = LeannSearcher(str(index_or_searcher), **searcher_kwargs)
            self._owns_searcher = True
        else:
            self.searcher = index_or_searcher
            self._owns_searcher = False
        self.max_batch = max(1, int(max_batch))
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1000.0
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._closed = False
        self.batches_run = 0
        self.queries_run = 0
        self._worker = threading.Thread(target=self._run, name="leann-batcher", daemon=True)
        self._worker.start()

    # -- client API ---------------------------------------------------------

    def submit(self, query: str, **search_params) -> Future:
        """Enqueue one query -> a Future of List[SearchResult]."""
        if self._closed:
            raise RuntimeError("BatchedSearcher is closed")
        key = tuple(sorted(search_params.items(), key=lambda kv: kv[0]))
        req = _Request(query, key, search_params)
        self._q.put(req)
        return req.future

    def search(self, query: str, timeout: Optional[float] = None, **search_params):
        """Blocking form of :meth:`submit`."""
        return self.submit(query, **search_params).result(timeout=timeout)

    def close(self, timeout: float = 10.0) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(None)  # wake the worker
        self._worker.join(timeout=timeout)
        if self._owns_searcher:
            self.searcher.cleanup()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker -------------------------------------------------------------

    def _run(self) -> None:
        pending: List[_Request] = []
        while True:
            first = pending.pop(0) if pending else self._q.get()
            if first is None:
                break
            batch = [first]
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._flush(batch)
                    for r in pending:
                        r.future.set_exception(RuntimeError("BatchedSearcher closed"))
                    return
                if nxt.params_key != first.params_key:
                    pending.append(nxt)  # other knobs: a batch of its own
                    break
                batch.append(nxt)
            self._flush(batch)

    def _flush(self, batch: List[_Request]) -> None:
        queries = [r.query for r in batch]
        try:
            rows = self.searcher.search(queries, **batch[0].params)
        except Exception as e:  # every waiter gets the error; the worker goes on
            for r in batch:
                r.future.set_exception(e)
            return
        self.batches_run += 1
        self.queries_run += len(batch)
        for r, row in zip(batch, rows):
            r.future.set_result(row)
