"""Serving client — InputQueue / OutputQueue, same surface as the reference
(pyzoo/zoo/serving/client.py:82 InputQueue.enqueue/predict, :234
OutputQueue.dequeue/query). Passing ``host``/``port`` selects the Redis
transport exactly like the reference client's ``InputQueue(host, port)``;
otherwise ``queue`` picks a broker (memory:// file:// redis://)."""

from __future__ import annotations

import uuid
from typing import Any, Dict, Optional

import numpy as np

from .codecs import decode_payload, encode_payload
from .queue_api import Broker, make_broker


class API:
    def __init__(self, queue: str = "memory://serving_stream",
                 host: Optional[str] = None, port=None,
                 name: str = "serving_stream"):
        self.name = name
        if host is not None:
            # reference signature: API(host, port) → Redis transport
            queue = f"redis://{host}:{int(port or 6379)}/{name}"
        self.broker: Broker = make_broker(queue) if isinstance(queue, str) \
            else queue


class InputQueue(API):
    def __init__(self, queue: str = "memory://serving_stream",
                 host: Optional[str] = None, port=None,
                 name: str = "serving_stream",
                 max_pending: Optional[int] = None,
                 backpressure_poll_s: float = 0.002):
        """``max_pending`` caps the broker backlog: enqueue blocks while
        ``pending() >= max_pending``, so a burst of producers cannot grow the
        queue (and the tail latency of everything behind it) without bound.
        The reference relies on Flink backpressure for the same effect."""
        super().__init__(queue, host, port, name)
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_pending = max_pending
        self._poll_s = backpressure_poll_s
        # pending() costs a round trip on the Redis transport; only re-query
        # once the locally-sent count could plausibly have reached the cap
        self._last_pending = 0
        self._sent_since = 0

    def enqueue(self, uri: str, model_name: Optional[str] = None,
                deadline: Optional[float] = None, **data) -> str:
        """enqueue(uri, t=ndarray) or multiple named tensors
        (reference: client.py:144-233). ``model_name`` routes to one of a
        multiplexed engine's co-served models (default: the engine's
        default model); ``deadline`` is an absolute epoch-seconds stamp the
        engine sheds against."""
        if not data:
            raise ValueError("provide at least one named tensor, e.g. "
                             "input_api.enqueue('my-id', t=arr)")
        if self.max_pending is not None:
            import time as _time
            while self._last_pending + self._sent_since >= self.max_pending:
                self._last_pending = self.broker.pending()
                self._sent_since = 0
                if self._last_pending >= self.max_pending:
                    _time.sleep(self._poll_s)
            self._sent_since += 1
        from .codecs import SparseTensor

        def norm(v):
            return v if isinstance(v, SparseTensor) else np.asarray(v)

        meta: Dict[str, Any] = {"uri": uri}
        if model_name is not None:
            meta["model"] = model_name
        if deadline is not None:
            meta["deadline"] = float(deadline)
        if len(data) == 1:
            payload = encode_payload(norm(next(iter(data.values()))),
                                     meta=meta)
        else:
            payload = encode_payload({k: norm(v) for k, v in data.items()},
                                     meta=meta)
        self.broker.enqueue(uri, payload)
        return uri

    def predict(self, request_data, timeout_s: float = 30.0,
                model_name: Optional[str] = None):
        """Synchronous single prediction (reference: client.py:105-143)."""
        uri = uuid.uuid4().hex
        meta: Dict[str, Any] = {"uri": uri}
        if model_name is not None:
            meta["model"] = model_name
        self.broker.enqueue(uri, encode_payload(np.asarray(request_data),
                                                meta=meta))
        raw = self.broker.get_result(uri, timeout_s)
        if raw is None:
            raise TimeoutError(f"no result for {uri} within {timeout_s}s")
        data, meta = decode_payload(raw)
        if meta.get("error"):
            raise RuntimeError(f"serving error: {meta['error']}")
        return data


class OutputQueue(API):
    def query(self, uri: str, timeout_s: float = 10.0):
        """(reference: client.py:238-252)"""
        raw = self.broker.get_result(uri, timeout_s)
        if raw is None:
            return "{}"
        data, _ = decode_payload(raw)
        return data

    def dequeue(self, uris, timeout_s: float = 10.0) -> Dict[str, Any]:
        """Fetch many results (reference: client.py:253-265)."""
        out = {}
        for uri in uris:
            out[uri] = self.query(uri, timeout_s)
        return out
