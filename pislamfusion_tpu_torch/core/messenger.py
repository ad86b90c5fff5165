"""In-process pub/sub messenger and bounded queues.

Equivalents of:
  * GSLAM/GSLAM/core/Messenger.h — ROS-like advertise/subscribe topics with a
    per-subscriber worker (used for the `fitted_map` topic).
  * src/DataTrans.h — the bounded drop-oldest producer/consumer queues that
    connect the SLAM half to the mosaic half (`Trans`, `Trans_Plane`).
  * Messenger.h:70-166 ThreadPool — the Mapper's 1-worker pool.

A copy of pislamfusion_tpu/core/messenger.py, except that `Messenger`
counts each topic's publishes (`published`): SLAM stamps every frame it
queues for the mosaic with the count of map-transform publishes so far,
and the fusion consumer gauges the frame by the map epoch it was tracked
in (models/fusion.py); and a `DataTrans` counts the items it dropped
(`dropped`).
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List


class Publisher:
    def __init__(self, messenger: "Messenger", topic: str):
        self._messenger = messenger
        self.topic = topic

    def publish(self, msg: Any):
        self._messenger._dispatch(self.topic, msg)


class Messenger:
    def __init__(self):
        self._subs: Dict[str, List[Callable[[Any], None]]] = {}
        self._published: Dict[str, int] = {}
        self._lock = threading.Lock()

    def advertise(self, topic: str) -> Publisher:
        return Publisher(self, topic)

    def subscribe(self, topic: str, callback: Callable[[Any], None]):
        with self._lock:
            self._subs.setdefault(topic, []).append(callback)

    def _dispatch(self, topic: str, msg: Any):
        with self._lock:
            self._published[topic] = self._published.get(topic, 0) + 1
            cbs = list(self._subs.get(topic, ()))
        for cb in cbs:
            cb(msg)

    def published(self, *topics: str) -> int:
        """How many messages the topics have had published, summed (a
        subscriber called back for the n-th reads n here)."""
        with self._lock:
            return sum(self._published.get(t, 0) for t in topics)


class DataTrans:
    """Bounded MPMC queue: `product` drops the oldest item when full
    (DataTrans.h:57-64), `consumption` blocks when empty (:70-83)."""

    def __init__(self, capacity: int = 30):
        self._q: queue.Queue = queue.Queue(maxsize=capacity)
        self._lock = threading.Lock()
        self.dropped = 0

    def product(self, item: Any):
        with self._lock:
            while True:
                try:
                    self._q.put_nowait(item)
                    return
                except queue.Full:
                    try:
                        self._q.get_nowait()   # drop oldest
                        self.dropped += 1
                    except queue.Empty:
                        pass

    def consumption(self, timeout: float | None = None) -> Any:
        return self._q.get(timeout=timeout)

    def try_consume(self):
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None

    def qsize(self) -> int:
        return self._q.qsize()


class ThreadPool:
    """Thin wrapper matching the reference's usage: Add(job), popSize()."""

    def __init__(self, workers: int = 1):
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._pending = 0
        self._lock = threading.Lock()

    def add(self, fn: Callable, *args, **kwargs):
        with self._lock:
            self._pending += 1

        def run():
            try:
                fn(*args, **kwargs)
            finally:
                with self._lock:
                    self._pending -= 1
        return self._pool.submit(run)

    def pending(self) -> int:
        with self._lock:
            return self._pending

    def shutdown(self, wait: bool = True):
        self._pool.shutdown(wait=wait)


messenger = Messenger()
# the two fusion-glue queues (reference src/DataTrans.h:8-9)
trans = DataTrans(30)         # (image, SE3 pose) tracked frames -> mosaic
trans_plane = DataTrans(30)   # dominant ground plane SE3 -> mosaic
