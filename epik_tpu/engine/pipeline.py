"""In-flight host pipeline for the batch loop.

The reference's loop is fully synchronous: read batch -> place -> write
(reference: epik/src/epik/main.cpp:332-365; a ``<future>`` include and
``is_busy`` helper exist but are dead code, main.cpp:4,39-43).  Here the
stages overlap with ``inflight`` batches being placed concurrently:

  reader thread:    FASTA parse ahead              (io/fasta.py or native)
  placer pool:      ``inflight`` worker threads, each running one batch's
                    full place() -- tokenize, upload, device dispatch,
                    result fetch, assembly.  Overlapping whole batches in
                    threads hides each batch's host work behind the
                    others' device compute; the GIL is released inside
                    the native stager, numpy and the device waits, so
                    threads scale.
  main thread:      collects finished batches IN SUBMISSION ORDER
  writer thread:    jplace serialization

The device itself serializes compute, so throughput converges to the
device step time plus any non-overlapped host work.  With a placer exposing only synchronous ``place`` this is
still correct -- each worker just blocks a little longer.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

__all__ = ["run_pipeline", "PipelineStats"]


class PipelineStats:
    """Throughput + stage-time breakdown (the metrics surface; the reference
    has only the per-batch seq/s meter, SURVEY.md section 5.1)."""

    def __init__(self):
        self.num_seq_placed = 0
        self.num_iterations = 0
        self.average_speed = 0.0
        self.wall_seconds = 0.0
        self.dispatch_seconds = 0.0  # batch submission (host-side staging)
        self.wait_seconds = 0.0  # blocked on a batch's completion
        self.write_seconds = 0.0  # jplace serialization

    def summary(self) -> str:
        return (
            f"batches={self.num_iterations} reads={self.num_seq_placed} "
            f"wall={self.wall_seconds:.2f}s "
            f"dispatch={self.dispatch_seconds:.2f}s "
            f"wait={self.wait_seconds:.2f}s write={self.write_seconds:.2f}s"
        )


def _reader_thread(reader, q: queue.Queue):
    try:
        while True:
            batch = reader.next_batch()
            q.put(batch)
            if not batch:
                return
    except BaseException as e:  # propagate to consumer
        q.put(e)


def run_pipeline(placer, reader, writer, progress=None, read_ahead: int = 2,
                 inflight: int = 3) -> PipelineStats:
    """Stream all batches from ``reader`` through ``placer`` into ``writer``.

    ``progress(seq_per_second, num_seq_placed, bytes_read)`` is called per
    batch (the reference's meter, main.cpp:347-358).  ``inflight`` batches
    are placed concurrently; results are written in input order.
    """
    stats = PipelineStats()
    q: queue.Queue = queue.Queue(maxsize=max(read_ahead, inflight + 1))
    t = threading.Thread(target=_reader_thread, args=(reader, q), daemon=True)
    t.start()

    # writer thread: jplace serialization overlaps the next batch's compute;
    # a single consumer preserves append order
    wq: queue.Queue = queue.Queue(maxsize=max(read_ahead, inflight + 1))
    werr: list = []

    def _writer_thread():
        while True:
            item = wq.get()
            if item is None:
                return
            t0 = time.monotonic()
            try:
                writer << item
            except BaseException as e:  # surfaced at the end of the run
                werr.append(e)
                return
            stats.write_seconds += time.monotonic() - t0

    wt = threading.Thread(target=_writer_thread, daemon=True)
    wt.start()

    inflight = max(1, inflight)
    pool = ThreadPoolExecutor(max_workers=inflight)
    pending: collections.deque = collections.deque()  # (future, size, t_start)
    begin = time.monotonic()

    def flush_one():
        fut, bsize, t_start = pending.popleft()
        t0 = time.monotonic()
        placed = fut.result()  # re-raises placer exceptions
        stats.wait_seconds += time.monotonic() - t0
        ms = max((time.monotonic() - t_start) * 1000.0, 1.0)
        if werr:
            raise werr[0]
        wq.put(placed)
        seq_per_second = 1000.0 * bsize / ms
        stats.average_speed += seq_per_second
        stats.num_seq_placed += bsize
        stats.num_iterations += 1
        if progress is not None:
            progress(seq_per_second, stats.num_seq_placed, reader.bytes_read())

    try:
        while True:
            batch = q.get()
            if isinstance(batch, BaseException):
                raise batch
            if not batch:
                break
            t_start = time.monotonic()
            fut = pool.submit(placer.place, batch)
            stats.dispatch_seconds += time.monotonic() - t_start
            pending.append((fut, len(batch), t_start))
            if len(pending) >= inflight:
                flush_one()
        while pending:
            flush_one()
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
    wq.put(None)
    wt.join()
    if werr:
        raise werr[0]

    if stats.num_iterations:
        stats.average_speed /= stats.num_iterations
    stats.wall_seconds = time.monotonic() - begin
    return stats
