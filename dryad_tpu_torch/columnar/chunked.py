"""Windowed chunk-parallel ranged reads through the native Fifo (a copy
of ``dryad_tpu/columnar/chunked.py``).

The async channel-buffer read-ahead pipeline of the reference's DFS
stream readers (``channelbufferhdfs.cpp``; Azure page reads in
``DrAzureBlobClient.h``) factored once for every ranged-byte client:
a thread pool fetches ``chunk``-sized ranges ahead, completed chunks
flow to the consumer IN ORDER through the native ``Fifo``
(``runtime/native/dryadnative.cpp``), and memory stays bounded at
``depth`` chunks while the pipe stays full.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List


class _ReadCancelled(Exception):
    """Internal: a queued fetch noticed the consumer went away."""


def chunked_read_iter(
    size: int,
    fetch_range: Callable[[int, int], bytes],
    chunk: int,
    threads: int = 4,
    depth: int = 4,
) -> Iterator[bytes]:
    """Yield ``size`` bytes as in-order blocks from parallel ranged
    fetches.  Closing the generator early (a consumer that stops after
    a partial read) propagates PROMPTLY to the fetch side: queued
    range fetches are cancelled, fetches that have not yet issued
    their request notice the stop flag and return without fetching,
    and the feed thread exits without waiting out the remaining
    window — bytes for ranges the consumer will never see are not
    silently fetched and dropped."""
    if size <= 0:
        return
    if size <= chunk:
        yield fetch_range(0, size)
        return
    from dryad_tpu_torch.runtime.bindings import Fifo

    nchunks = -(-size // chunk)
    fifo = Fifo(depth=depth)
    err: List[BaseException] = []
    stop = threading.Event()

    def guarded(offset: int, length: int) -> bytes:
        # checked at dequeue time: a cancelled consumer stops NEW
        # fetches immediately, not after the pool drains the window
        if stop.is_set():
            raise _ReadCancelled()
        return fetch_range(offset, length)

    def feed() -> None:
        try:
            with ThreadPoolExecutor(max_workers=threads) as ex:
                futs = [
                    ex.submit(
                        guarded,
                        i * chunk,
                        min(chunk, size - i * chunk),
                    )
                    for i in range(nchunks)
                ]
                # in-order push; the pool keeps later chunks fetching
                for f in futs:
                    if stop.is_set() or not fifo.push(f.result()):
                        stop.set()
                        for g in futs:
                            g.cancel()
                        return
        except _ReadCancelled:
            pass
        except BaseException as e:  # noqa: BLE001 - surfaced below
            err.append(e)
            stop.set()
        finally:
            fifo.close()

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    got = 0
    try:
        while True:
            block = fifo.pop()
            if block is None:
                break
            got += len(block)
            yield block
    finally:
        stop.set()
        fifo.close()
        t.join()
        fifo.destroy()
    if err:
        raise err[0]
    if got != size:
        raise IOError(f"chunked read: got {got} of {size} bytes")


def chunked_read(
    size: int,
    fetch_range: Callable[[int, int], bytes],
    chunk: int,
    threads: int = 4,
    depth: int = 4,
) -> bytes:
    """Read ``size`` bytes as parallel ranged fetches, reassembled in
    order.  ``fetch_range(offset, length) -> bytes``."""
    if size <= 0:
        return b""
    out = bytearray()
    for block in chunked_read_iter(size, fetch_range, chunk, threads, depth):
        out += block
    return bytes(out)
