"""Host panels to the card: a ring of pinned buffers and a copy stream.

The host data path of the out-of-core solver (``solvers/streaming.py``)
and of ``serve/topk.py::topk_streaming``.  ``PanelPipeline.run`` walks a
schedule of panels; for each, a filler writes the panel into a pinned host
buffer (the panelizer writes straight into it), a dedicated copy stream
moves it to a device panel with a non-blocking copy, and the caller's
stream waits on that copy alone before it computes on the panel.  While
the card computes on panel t, the host fills and the copy stream moves
the next ones, ``slots - 1`` panels ahead.

A slot is rewritten only when both of its earlier users are done:

  * the host buffer once the copy out of it has finished (the host waits
    on the copy's event before the filler writes), and
  * the device panel once the compute that read it has finished (the copy
    stream waits on the event recorded on the caller's stream after the
    caller's step).

So a panel is never overwritten in flight, whatever the count of slots;
``tpunmf`` took a fresh host array per panel for the same reason
(tpunmf/solvers/streaming.py:123-127).

On the CPU the pipeline is the plain synchronous loop in the same order:
one host buffer, filled and handed to the caller in turn.
"""
from __future__ import annotations

from collections import deque

import torch

SLOTS = 3


def _view(buf: torch.Tensor, shape) -> torch.Tensor:
    numel = 1
    for d in shape:
        numel *= d
    return buf[:numel].view(shape)


class PanelPipeline:
    """A ring of ``slots`` pinned host buffers and device panels of up to
    ``numel`` elements of ``dtype`` each, for panels bound for ``device``."""

    def __init__(self, numel: int, dtype, device, slots: int = SLOTS):
        if slots < 2:
            raise ValueError("a ring needs at least 2 slots")
        self.device = torch.device(device)
        self.slots = slots
        if self.device.type == "cuda":
            self._host = [torch.empty(numel, dtype=dtype, pin_memory=True)
                          for _ in range(slots)]
            self._dev = [torch.empty(numel, dtype=dtype, device=self.device)
                         for _ in range(slots)]
            self._copy = torch.cuda.Stream(self.device)
            self._copied = [torch.cuda.Event() for _ in range(slots)]
            self._used = [torch.cuda.Event() for _ in range(slots)]
        else:
            self._host = [torch.empty(numel, dtype=dtype)]

    def _stage(self, t, item, fill, shape):
        s = t % self.slots
        self._copied[s].synchronize()  # the copy out of this buffer is done
        host = _view(self._host[s], shape)
        fill(item, host)
        dev = _view(self._dev[s], shape)
        with torch.cuda.stream(self._copy):
            self._copy.wait_event(self._used[s])  # the compute on this panel is done
            dev.copy_(host, non_blocking=True)
            self._copied[s].record(self._copy)
        return dev

    def run(self, items, fill, shape_of):
        """Yield ``(item, panel)`` for each item in order.

        ``fill(item, host)`` writes the item's panel into ``host``, a CPU
        tensor of shape ``shape_of(item)``.  ``panel`` has that shape, lies
        on the device and is ready for work queued on the caller's current
        stream; it stays valid until the caller advances the iterator."""
        items = list(items)
        if self.device.type != "cuda":
            for item in items:
                host = _view(self._host[0], shape_of(item))
                fill(item, host)
                yield item, host
            return
        compute = torch.cuda.current_stream(self.device)
        ahead = self.slots - 1
        pending = deque()
        try:
            for t in range(min(ahead, len(items))):
                pending.append(self._stage(t, items[t], fill, shape_of(items[t])))
            for t, item in enumerate(items):
                s = t % self.slots
                panel = pending.popleft()
                compute.wait_event(self._copied[s])
                yield item, panel
                self._used[s].record(compute)
                nxt = t + ahead
                if nxt < len(items):
                    pending.append(self._stage(nxt, items[nxt], fill, shape_of(items[nxt])))
        finally:
            # copies started but never consumed finish before the caller's
            # stream reuses or frees anything
            compute.wait_stream(self._copy)
