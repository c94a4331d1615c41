"""Wall-clock stopwatch, a portable replacement for the Windows
QueryPerformanceCounter StopWatch (swatch.h/swatch.cpp); the port's copy of
the JAX package's ``utils/stopwatch.py``.

Same API shape: Reset / Start / Stop with an accumulating Stop
(swatch.cpp:22-29 adds each Start..Stop span), GetTime in seconds.

``sync`` waits for the card when given a CUDA tensor, the cudaDeviceSynchronize bracketing of render.h:223-225, so
that a span includes the device's work and not only its enqueueing.
"""

from __future__ import annotations

import time

import torch


class StopWatch:
    def __init__(self):
        self._accum = 0.0
        self._start = None

    def Reset(self) -> None:
        self._accum = 0.0
        self._start = None

    def Start(self) -> None:
        self._start = time.perf_counter()

    def Stop(self) -> None:
        if self._start is not None:
            self._accum += time.perf_counter() - self._start
            self._start = None

    def GetTime(self) -> float:
        return self._accum


def sync(x):
    """Wait until the device work behind ``x`` is done: torch.cuda.synchronize
    on the tensor's card for a CUDA tensor (or a tuple / list holding one);
    a CPU tensor is ready when it is returned."""
    tensors = x if isinstance(x, (tuple, list)) else (x,)
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            break
    return x
