"""Host streaming driver (port of doa_tpu/io/stream.py): the thin driver
between a sample producer and a pipeline.

A producer (file reader, socket, SDR bridge) pushes fixed-size sample
blocks into a bounded ring; the driver thread frames them with the
overlap carried over (each block is served behind the trailing `overlap`
samples of the one before, so the windows are those of the concatenated
stream), calls the pipeline, and emits (block index, DoaResult) on an
output queue in block order.

The pipeline is either of the port's: ``build_pipeline_torch(cfg)`` or
``pipeline.build_pipeline(cfg)``; both take ``(x, correction)`` for a
complex (T, N) capture and have ``.config``. Results stay on the
pipeline's device.

A call of the port's pipelines ends in a host sync (its escalation check
and peak reads), so ``max_in_flight`` overlaps no framing with device
work, as it does under JAX's asynchronous dispatch in doa_tpu: it keeps
its meaning for the emission order and counts (up to that many results
held before the oldest is fenced and emitted). The fence reads one
element of a result to the host (``.cpu()``), which completes on a CUDA
tensor once the device has computed it.

Failure detection: a full ring drops whole blocks and counts them (the
analog of UHD overflow 'O' indications) in ``StreamStats``; processing
never stalls the producer.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
from typing import Iterable, Optional

import numpy as np


@dataclasses.dataclass
class StreamStats:
    blocks_in: int = 0
    blocks_dropped: int = 0
    blocks_processed: int = 0
    samples_processed: int = 0
    windows_emitted: int = 0
    # Subspace-escalation observability (DoaResult.escalation_*, summed
    # over emitted blocks; None on the paths that have no detector): the
    # windows the safety net fired on, and flagged windows beyond
    # subspace_escalate_capacity left unescalated.
    windows_escalated: int = 0
    escalation_overflow: int = 0

    @property
    def drop_fraction(self) -> float:
        return self.blocks_dropped / max(self.blocks_in, 1)


class StreamingDriver:
    """Feed blocks of (block_samples, N) complex64; receive per-block
    pipeline results on `results` (a Queue of (block_index, DoaResult)).

    block_samples must be a multiple of the config hop. The driver re-serves
    the trailing `overlap` samples of each block in front of the next one,
    so the window sequence is identical to offline processing of the
    concatenated stream.
    """

    def __init__(self, pipeline, block_samples: int, *,
                 ring_capacity: int = 8, correction=None,
                 max_in_flight: int = 2):
        cfg = pipeline.config
        if block_samples % cfg.hop:
            raise ValueError("block_samples must be a multiple of hop")
        self._pipe = pipeline
        self._cfg = cfg
        self._block = block_samples
        self._corr = correction
        self._ring: queue.Queue = queue.Queue(maxsize=ring_capacity)
        self.results: queue.Queue = queue.Queue()
        self.stats = StreamStats()
        self._tail: Optional[np.ndarray] = None  # last `overlap` samples
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._started = False
        self._max_in_flight = max(1, max_in_flight)

    # -- producer side -------------------------------------------------
    def push(self, block: np.ndarray) -> bool:
        """Producer call. Non-blocking: returns False (and counts a drop)
        if the ring is full — backpressure by dropping, like an SDR."""
        self.stats.blocks_in += 1
        try:
            self._ring.put_nowait(np.asarray(block))
            return True
        except queue.Full:
            self.stats.blocks_dropped += 1
            return False

    def start(self):
        self._started = True
        self._thread.start()
        return self

    def stop(self, wait: bool = True):
        self._stop.set()
        if wait and self._started:
            self._thread.join()

    # -- consumer thread -----------------------------------------------
    def _frame(self, block: np.ndarray) -> np.ndarray:
        overlap = self._cfg.overlap
        if self._tail is not None and overlap > 0:
            x = np.concatenate([self._tail, block], axis=0)
        else:
            x = block
        if overlap > 0:
            self._tail = block[-overlap:]
        return x

    def _fence_emit(self, idx, res):
        first = next(iter(res.peak_angles.values()), None)
        if first is not None:
            first.reshape(-1)[:1].cpu()         # completion fence
            self.stats.windows_emitted += int(first.shape[0])
        if res.escalation_flagged is not None:
            self.stats.windows_escalated += int(res.escalation_flagged)
            self.stats.escalation_overflow += int(res.escalation_overflow)
        self.results.put((idx, res))

    def _run(self):
        pending = collections.deque()
        while not (self._stop.is_set() and self._ring.empty()):
            try:
                block = self._ring.get(timeout=0.05)
            except queue.Empty:
                while pending:
                    self._fence_emit(*pending.popleft())
                continue
            res = self._pipe(self._frame(block), self._corr)
            idx = self.stats.blocks_processed
            self.stats.blocks_processed += 1
            self.stats.samples_processed += block.shape[0]
            pending.append((idx, res))
            while len(pending) >= self._max_in_flight:
                self._fence_emit(*pending.popleft())
        while pending:
            self._fence_emit(*pending.popleft())

    # -- convenience ----------------------------------------------------
    def run_iter(self, blocks: Iterable[np.ndarray]):
        """Synchronous helper: process an iterable of blocks, yielding
        (index, result) in order. Bypasses the ring (no drops)."""
        for i, block in enumerate(blocks):
            block = np.asarray(block)
            x = self._frame(block)
            self.stats.blocks_in += 1
            self.stats.blocks_processed += 1
            self.stats.samples_processed += block.shape[0]
            yield i, self._pipe(x, self._corr)


def iterate_file_blocks(path: str, block_samples: int, num_channels=None):
    """Yield (block_samples, N) blocks from a recorded IQ file."""
    from doa_tpu_torch.io.recorded import load_iq

    x = load_iq(path, num_channels)
    T = (x.shape[0] // block_samples) * block_samples
    for i in range(0, T, block_samples):
        yield x[i : i + block_samples]
