"""Streaming training-data ingestion route.

Counterpart of ``deeplearning4j_tpu/parallel/streaming.py``
(``StreamingDataSetIterator`` ``:41-115``, ``StreamingIngestServer``
``:118-177``), host code: a bounded in-process topic that any producer (an
HTTP POST, a thread, a socket reader) publishes ``DataSet``s into, exposed
as a ``DataSetIterator`` so ``net.fit(iterator=topic)`` or a
``ParallelWrapper`` consumes a live stream with back-pressure. The
reference's Camel/Kafka transports are dropped, as there.

    topic = StreamingDataSetIterator(capacity=64)
    srv = StreamingIngestServer(topic).start()      # POST /publish
    net.fit(iterator=topic)                         # blocks on the stream
    ...producers POST {"features": [...], "labels": [...]} ...
    topic.end_of_stream()                           # drain, end the epoch

``net.fit(iterator=topic)`` runs the stream through the port's
``DevicePrefetchIterator``; back-pressure holds end to end: the
prefetcher keeps at most ``depth`` shipped batches (plus one in its
producer's hands), its thread blocks on that bounded queue and stops
pulling from the topic, and publishers block on the topic's own
``capacity``. ``topic.prefetch(depth, sharding=data_sharding(mesh))``
lands batches on the mesh's device checked to tile its data axis, for a
``ParallelWrapper``'s feed.
"""
from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np

from ..datasets.dataset import DataSet, DataSetIterator


class StreamingDataSetIterator(DataSetIterator):
    """Bounded-queue topic of DataSets (the Kafka-topic analogue).

    Producers call :meth:`publish` (blocking when the queue is full — the
    back-pressure Kafka gives via the broker); the training loop iterates,
    blocking until data arrives, and the iteration ends when
    :meth:`end_of_stream` is called and the queue drains (or after
    ``timeout`` seconds with no data, if set).
    """

    _TICK = 0.05   # close-signal poll interval for a blocked consumer

    def __init__(self, capacity: int = 64, timeout: Optional[float] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=capacity)
        self.timeout = timeout
        self._closed = threading.Event()
        self.published = 0
        self.consumed = 0

    # ------------------------------------------------------------- producer
    def publish(self, features, labels, features_mask=None, labels_mask=None,
                block: bool = True, timeout: Optional[float] = None) -> bool:
        """Enqueue one minibatch. Returns False if the stream is closed or
        the queue stayed full past ``timeout`` (non-blocking publish). A
        publish racing :meth:`end_of_stream` may still be delivered — every
        batch this method accepted (returned True) IS consumed, because the
        consumer drains the queue before honoring the close."""
        if self._closed.is_set():
            return False
        ds = DataSet(np.asarray(features, np.float32),
                     np.asarray(labels, np.float32),
                     None if features_mask is None else np.asarray(features_mask),
                     None if labels_mask is None else np.asarray(labels_mask))
        try:
            self._q.put(ds, block=block, timeout=timeout)
        except queue.Full:
            return False
        self.published += 1
        return True

    def end_of_stream(self):
        """Close the topic: consumers drain what's queued, then stop.
        Never blocks (no sentinel occupies queue capacity — the close is an
        event the consumer polls between gets)."""
        self._closed.set()

    # ------------------------------------------------------------- consumer
    def __iter__(self):
        idle = 0.0
        while True:
            try:
                item = self._q.get(timeout=self._TICK)
            except queue.Empty:
                if self._closed.is_set():
                    return        # closed AND drained
                idle += self._TICK
                if self.timeout is not None and idle >= self.timeout:
                    return        # idle timeout: end the epoch
                continue
            idle = 0.0
            self.consumed += 1
            yield item

    def reset(self):
        # a stream has no beginning to rewind to; epochs>1 over a live
        # stream just keep consuming (reference Kafka-consumer semantics)
        pass


class StreamingIngestServer:
    """HTTP front door for the topic (the Camel HTTP/Kafka endpoint
    analogue): POST /publish {"features": [[...]], "labels": [[...]]} feeds
    training; GET /stats reports counters; POST /end closes the stream."""

    def __init__(self, topic: StreamingDataSetIterator, port: int = 0,
                 host: str = "127.0.0.1"):
        self.topic = topic
        self.host = host
        self._port = port
        self._httpd = None
        self._thread = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    def start(self) -> "StreamingIngestServer":
        import http.server
        from ..util.httpjson import read_json, write_json
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):   # noqa: N802
                if self.path == "/stats":
                    write_json(self, 200, {
                        "published": server.topic.published,
                        "consumed": server.topic.consumed,
                        "queued": server.topic._q.qsize(),
                        "closed": server.topic._closed.is_set()})
                else:
                    self.send_error(404)

            def do_POST(self):  # noqa: N802
                try:
                    if self.path == "/publish":
                        req = read_json(self)
                        ok = server.topic.publish(
                            req["features"], req["labels"],
                            req.get("features_mask"), req.get("labels_mask"),
                            block=False)
                        write_json(self, 200 if ok else 503,
                                   {"ok": ok,
                                    **({} if ok else
                                       {"error": "stream closed or full"})})
                    elif self.path == "/end":
                        server.topic.end_of_stream()
                        write_json(self, 200, {"ok": True})
                    else:
                        self.send_error(404)
                except (KeyError, ValueError, TypeError) as e:
                    write_json(self, 400, {"error": str(e)})

            def log_message(self, *a):
                pass

        self._httpd = http.server.ThreadingHTTPServer((self.host, self._port),
                                                      Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
