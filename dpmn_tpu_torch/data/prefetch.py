"""Background host→device prefetch for the input pipeline.

Counterpart of dpmn_tpu/data/prefetch.py.  A producer thread takes the next
batches from the host iterator and copies each array to the device while
the card runs the current step: on a CUDA device it pins the array, copies
it with non_blocking=True on a side stream and records an event; the
consumer makes its current stream wait on that event and marks each tensor
with `record_stream`, so the caching allocator does not hand its memory to
another tensor while the consumer's stream may still read it.  On the CPU
the arrays become tensors as they are.  Entries without a shape (None, the
label lists) pass through unchanged.

One deliberate difference from the JAX package: an exception in the producer
ends the JAX epoch quietly (its `finally` puts the stop marker); here it is
raised again in the consumer.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from .. import resolve_device


def normalize_uint8(x: torch.Tensor) -> torch.Tensor:
    """Device-side inverse of resize_quantized's uint8 transport: the same
    uint8 values divided by the same float32 255 (a true IEEE divide), so
    bit-identical to the host resize_normalize; the {0, 255} mask channel
    lands exactly on 0.0 / 1.0."""
    return x.to(torch.float32) / torch.tensor(255.0, dtype=torch.float32, device=x.device)


def _to_device(x, device, stream):
    if not hasattr(x, "shape"):
        return x
    t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t.to(device)
    with torch.cuda.stream(stream):
        return t.pin_memory().to(device, non_blocking=True)


def prefetch_to_device(iterator, size: int = 2, device=None):
    """Wrap a host batch iterator with a `size`-deep device-side prefetch
    queue; yields tuples of device tensors (and the entries that have no
    shape, unchanged)."""
    device = resolve_device(device)
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = object()
    cancelled = threading.Event()
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(item) -> bool:
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                batch = tuple(_to_device(x, device, stream) for x in batch)
                event = None
                if stream is not None:
                    event = torch.cuda.Event()
                    event.record(stream)
                if not put((batch, event, None)):
                    break
            else:
                put(stop)
        except BaseException as e:  # handed to the consumer, which raises it
            put((None, None, e))
        finally:
            if cancelled.is_set() and hasattr(iterator, "close"):
                iterator.close()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                return
            batch, event, err = item
            if err is not None:
                raise err
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for x in batch:
                    if torch.is_tensor(x):
                        x.record_stream(current)
            yield batch
    finally:
        cancelled.set()
        t.join()  # a blocked producer sees the flag within 0.1 s
