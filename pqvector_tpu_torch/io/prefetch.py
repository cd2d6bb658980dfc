"""Background byte-range prefetch for sequential row-group decode.

Where the native chunk decoder runs faster than the disk reads cold (as
the JAX package measured on its host), a serialized read-then-decode loop
over row groups is I/O-bound with the CPU idle during every read (and vice
versa warm). Both the file read and the native decode release the GIL, so one
background reader thread overlaps the next row group's I/O with the
current decode, taking the full-column load from read+decode summed to
max(read, decode).

The reference loads the whole file through Arrow's reader in one call
(pq-vector src/ivf/parquet.rs:216-233), inheriting parquet-rs's
internal readahead; this module is the explicit host-side equivalent for
the native decode path.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterable, Iterator, Sequence, Tuple, TypeVar

T = TypeVar("T")

_DONE = object()


def iter_prefetched(
    path: str | os.PathLike,
    items: Sequence[T] | Iterable[T],
    span: Callable[[T], Tuple[int, int]],
    depth: int = 2,
) -> Iterator[Tuple[T, bytes]]:
    """Yield ``(item, bytes)`` for each item, reading ahead in a thread.

    ``span(item)`` returns the ``(offset, length)`` byte range to read.
    At most ``depth`` buffers are in flight, bounding host memory at
    ``depth + 2`` row-group chunks (a recycled slot pool — see _reader).
    Reads fill the pool in place via ``os.preadv`` on a dedicated fd (no
    seek state shared with the consumer). The yielded buffer is a
    memoryview into a pool slot: it is valid until the NEXT iteration of
    this generator — consume (decode/copy) before advancing, never
    retain. Reader exceptions re-raise in the consumer at the failing
    item's position; closing the generator early (e.g. a sampling pass
    that has seen enough rows) stops the reader promptly without
    draining the file.
    """
    if depth < 1:
        raise ValueError("prefetch depth must be >= 1")
    out: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    fd = os.open(os.fspath(path), os.O_RDONLY)

    def _put(payload) -> bool:
        # Bounded put that stays responsive to consumer shutdown: a plain
        # blocking put would deadlock the reader (and leak the thread) if
        # the consumer exits while the queue is full.
        while not stop.is_set():
            try:
                out.put(payload, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _reader() -> None:
        # Pooled read buffers: a fresh ``bytes`` per chunk pays slow
        # first-touch faults on every read (utils/alloc.py module
        # docstring); the
        # pool recycles ``depth + 2`` slots (at most ``depth`` queued +
        # one being consumed + one being filled), preadv-filling in
        # place. Slots only GROW, so a mixed-size chunk sequence
        # stabilizes at the largest span.
        pool: list[bytearray] = [bytearray() for _ in range(depth + 2)]
        slot = 0
        try:
            for item in items:
                if stop.is_set():
                    return
                offset, length = span(item)
                buf = pool[slot]
                slot = (slot + 1) % len(pool)
                if len(buf) < length:
                    buf[:] = bytes(length)
                got = os.preadv(fd, [memoryview(buf)[:length]], offset)
                if got != length:
                    raise OSError(
                        f"short read at {offset}: got {got} of {length}"
                    )
                if not _put((item, memoryview(buf)[:length])):
                    return
            _put(_DONE)
        except BaseException as exc:  # re-raised at the consumer
            _put(exc)
        finally:
            os.close(fd)

    thread = threading.Thread(
        target=_reader, name="pqvector-prefetch", daemon=True
    )
    thread.start()
    try:
        while True:
            got = out.get()
            if got is _DONE:
                return
            if isinstance(got, BaseException):
                raise got
            yield got
    finally:
        stop.set()
        # Unblock a reader waiting on a full queue so the thread exits.
        while True:
            try:
                out.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=5.0)
