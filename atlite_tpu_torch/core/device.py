"""Device policy of the port: the device a call runs on, the precision of
its products, and how host arrays reach a card.

- ``resolve_device``: the given device, else the current CUDA card;
- ``fp32_matmul``: full float32 products (TF32 off) for a block;
- ``PinnedRing``: two page-locked staging buffers used in turn, the one
  road from host memory to a card for uploads that repeat (the streamer's
  time chunks, the availability path's mask blocks).

It imports nothing of the port but ``profiling``, so every layer may use
it.
"""

from __future__ import annotations

import contextlib

import torch

from atlite_tpu_torch.profiling import span


def resolve_device(device=None) -> torch.device:
    """The device to run on: the given one, else the current CUDA card.
    Without a card, asking for the default raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available; pass device='cpu' "
                           "to run the plain version on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


@contextlib.contextmanager
def fp32_matmul():
    """Full float32 products: TF32 off for the duration of the block
    (it keeps ~3 decimal digits, far outside the parity tolerances)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class PinnedRing:
    """Host-to-card staging through two page-locked byte buffers in turn.

    ``host(nbytes)`` hands out the next slot, once the event of its last
    copy has completed; ``copy(host, stream)`` moves it to the card
    without blocking on ``stream`` and records the copy's event there.
    A slot too small grows with the other one, both sized together before
    either is filled: a pinned allocation stalls the card, so it happens
    once for a run of uploads of one size.  On the CPU ``host`` is fresh
    memory each time and ``copy`` returns it.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self._buffers = [None, None]
        self._copied = [None, None]  # the event of each slot's last copy
        self._turn = self._last = 0

    def host(self, nbytes, t0=None, t1=None):
        """``nbytes`` bytes of the next slot, a uint8 tensor; a growth
        runs in a ``pin <t0>:<t1>`` span."""
        if self.device.type != "cuda":
            return torch.empty(nbytes, dtype=torch.uint8)
        i = self._last = self._turn
        self._turn = 1 - i
        if self._copied[i] is not None:
            self._copied[i].synchronize()
        if self._buffers[i] is None or self._buffers[i].numel() < nbytes:
            with span("pin", t0, t1):
                for j in (0, 1):
                    if self._copied[j] is not None:
                        self._copied[j].synchronize()
                    if self._buffers[j] is None or self._buffers[j].numel() < nbytes:
                        self._buffers[j] = torch.empty(nbytes, dtype=torch.uint8,
                                                       pin_memory=True)
        return self._buffers[i][:nbytes]

    def copy(self, host, stream=None):
        """``host``, a view of the slot handed out last, on the device: a
        non-blocking copy on ``stream`` (default: the current one)."""
        if self.device.type != "cuda":
            return host
        stream = torch.cuda.current_stream(self.device) if stream is None else stream
        with torch.cuda.stream(stream):
            out = host.to(self.device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
        self._copied[self._last] = done
        return out
