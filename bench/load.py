"""The traffic generator: a seeded image stream and closed-loop clients.

Images are windows of one pool of pixels drawn from the seed in set-up:
uint8 values, centred and scaled to about unit variance, as float32.
Image ``j`` of a run starts at an offset drawn from ``(seed, j)``, so
every request carries its own image, none is drawn inside the window,
and the reference can draw any image again from the seed alone.  The
clients take the stream's images in order.

A client sends one request, waits for its answer and sends the next:
``infer`` (one image) or ``infer_batch`` (a call of ``images_per_call``
images), a thread each, or ``submit`` (one image through the continuous
scheduler; one thread drives all such clients from their futures).
Each request records its start (the call or the submission), its end
(the answer back on the host), its images and, for the images that the
check samples, their outputs.  The traced run pauses the clients while
it stops the profiler.
"""
from __future__ import annotations

import queue
import threading
import time
import traceback
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

#: float32 values in the pool (256 MiB)
POOL = 1 << 26


def pool(seed: int) -> np.ndarray:
    """The pool of pixels of ``seed``'s stream."""
    u8 = np.frombuffer(np.random.default_rng([seed, 0]).bytes(POOL),
                       np.uint8)
    x = u8.astype(np.float32)
    x -= 127.5
    x *= 1.0 / 64.0
    return x


def image(px: np.ndarray, seed: int, j: int,
          shape: Sequence[int]) -> np.ndarray:
    """Image ``j`` of the stream of ``seed`` whose pool is ``px``: a view
    of shape (C, H, W)."""
    n = int(np.prod(shape))
    off = mix(seed, 2 * j) % (len(px) - n + 1)
    return px[off:off + n].reshape(shape)


_MASK = (1 << 64) - 1


def mix(seed: int, j: int) -> int:
    """A 64-bit hash of (seed, j) (splitmix64's finaliser)."""
    z = (seed ^ (j * 0x9E3779B97F4A7C15)) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def sampled(seed: int, j: int, every: int) -> bool:
    """Whether the check samples image ``j``: about one in ``every``, by a
    hash of (seed, j), so the samples fall on every row of a batch."""
    return mix(seed, 2 * j + 1) % every == 0


@dataclass
class Request:
    start: float
    end: float
    ok: bool
    images: int
    #: stream index -> output dict, for the sampled images
    kept: Dict[int, Dict[str, np.ndarray]] = field(default_factory=dict)


class Stream:
    """The images of one run, in order: ``take(k)`` returns the next
    ``k`` as (index, image) pairs."""

    def __init__(self, seed: int, shape: Sequence[int]) -> None:
        self.seed, self.shape = seed, tuple(shape)
        self.px = pool(seed)
        self._next = 0
        self._lock = threading.Lock()

    def take(self, k: int) -> List[Tuple[int, np.ndarray]]:
        with self._lock:
            j, self._next = self._next, self._next + k
        return [(i, image(self.px, self.seed, i, self.shape))
                for i in range(j, j + k)]


class Clients:
    """``n`` closed-loop clients sending requests through ``send`` until
    :meth:`stop`.  ``send(images) -> list of output dicts`` blocks until
    the answers are back on the host; ``keep(j)`` says whether image
    ``j``'s output is kept for the check."""

    def __init__(self, n: int, images_per_call: int, stream: Stream,
                 send: Callable[[List[np.ndarray]], List[Dict]],
                 keep: Callable[[int], bool]) -> None:
        self.k, self.stream, self.send, self.keep = \
            images_per_call, stream, send, keep
        self._init_state()
        self._threads = [threading.Thread(target=self._run,
                                          name=f"bench-client{i}",
                                          daemon=True) for i in range(n)]
        for t in self._threads:
            t.start()

    def _init_state(self) -> None:
        self.requests: List[Request] = []
        self.errors: List[str] = []
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._open = True
        #: requests sent and not yet answered
        self._busy = 0

    def _begin(self) -> bool:
        """Wait while paused; False once stopped, else one more request
        is in flight."""
        with self._cond:
            self._cond.wait_for(lambda: self._open or self._stop.is_set())
            if self._stop.is_set():
                return False
            self._busy += 1
            return True

    def _end(self) -> None:
        with self._cond:
            self._busy -= 1
            self._cond.notify_all()

    def _failed(self) -> None:
        with self._lock:
            if len(self.errors) < 5:
                self.errors.append(traceback.format_exc())

    def _run(self) -> None:
        while self._begin():
            batch = self.stream.take(self.k)
            t0 = time.perf_counter()
            try:
                outs = self.send([x for _, x in batch])
                ok = len(outs) == len(batch)
            except Exception:  # a failed request counts; the run goes on
                outs, ok = [], False
                self._failed()
            t1 = time.perf_counter()
            req = Request(t0, t1, ok, len(batch))
            if ok:
                req.kept = {j: out for (j, _), out in zip(batch, outs)
                            if self.keep(j)}
            with self._lock:
                self.requests.append(req)
            self._end()

    def count(self) -> int:
        with self._lock:
            return len(self.requests)

    def pause(self, timeout: float) -> None:
        """Send nothing more until :meth:`resume`; wait up to ``timeout``
        s until every request in flight is answered."""
        with self._cond:
            self._open = False
            self._cond.wait_for(lambda: self._busy == 0, timeout)

    def resume(self) -> None:
        with self._cond:
            self._open = True
            self._cond.notify_all()

    def stop(self, timeout: float) -> int:
        """Stop sending; wait up to ``timeout`` s for the requests in
        flight.  Returns how many clients still wait for an answer."""
        self._stop.set()
        self.resume()
        deadline = time.perf_counter() + timeout
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.perf_counter()))
        return sum(t.is_alive() for t in self._threads)

    def in_window(self, t0: float, t1: float) -> List[Request]:
        """Requests that ended inside [t0, t1]."""
        with self._lock:
            return [r for r in self.requests if t0 <= r.end <= t1]

    def started_in(self, t0: float, t1: float) -> List[Request]:
        """Requests sent inside [t0, t1] (their answers are due)."""
        with self._lock:
            return [r for r in self.requests if t0 <= r.start <= t1]


class SubmitClients(Clients):
    """``n`` closed-loop clients of a continuous scheduler, driven by one
    thread: each sends one image through ``submit(image) -> Future``,
    and the moment its future resolves (the answer on the host) it is
    due to send the next.  One thread keeps the load from taking the
    interpreter's lock from the server it measures."""

    def __init__(self, n: int, stream: Stream,
                 submit: Callable[[np.ndarray], Future],
                 keep: Callable[[int], bool]) -> None:
        self.n, self.stream, self.submit, self.keep = n, stream, submit, keep
        self._init_state()
        self._done: "queue.SimpleQueue" = queue.SimpleQueue()
        self._threads = [threading.Thread(target=self._drive,
                                          name="bench-sender", daemon=True)]
        self._threads[0].start()

    def _answered(self, j: int, t0: float, fut: Future) -> None:
        self._done.put((j, t0, time.perf_counter(), fut))
        self._end()

    def _send(self) -> bool:
        if not self._begin():
            return False
        (j, x), = self.stream.take(1)
        t0 = time.perf_counter()
        try:
            fut = self.submit(x)
        except Exception:  # refused at admission: failed, and not resent
            with self._lock:
                self.requests.append(Request(t0, time.perf_counter(),
                                             False, 1))
            self._failed()
            self._end()
            return False
        fut.add_done_callback(lambda f: self._answered(j, t0, f))
        return True

    def _drive(self) -> None:
        inflight = sum(self._send() for _ in range(self.n))
        while inflight:
            j, t0, t1, fut = self._done.get()
            inflight -= 1
            try:
                out, ok = fut.result(), True
            except Exception:  # a failed request counts; the run goes on
                out, ok = None, False
                self._failed()
            req = Request(t0, t1, ok, 1)
            if ok and self.keep(j):
                req.kept = {j: out}
            with self._lock:
                self.requests.append(req)
            inflight += self._send()
