"""Failure detection and bounded retry for long device jobs (the port's
copy of the JAX package's ``utils/recovery.py``, classifying CUDA errors).

The reference has no failure handling: checkCudaErrors aborts the process on
any CUDA error (kernel.cu:24-27 via helper_cuda.h), so a mid-animation
device fault loses the run.  ``retry_transient`` runs a step, classifies a
raised error as a transient device condition or not, backs off and retries
the transient ones a bounded number of times.  With the per-frame PNGs and
``checkpoint.next_frame``'s resume scan, a driver loses at most one frame.

Classification is by exception type and message, since PyTorch raises CUDA
failures as ``RuntimeError`` (``torch.cuda.OutOfMemoryError``,
``torch.AcceleratorError`` and NCCL's errors among its subclasses) with the
driver's text:
  * a STICKY error (an illegal address, an unspecified launch failure, an
    uncorrectable ECC error, a device-side assert, a misaligned address, an
    illegal instruction, a launch timeout) leaves the CUDA context unusable
    for the rest of the process: it is not transient and re-raises at once;
  * a device that is busy or unavailable, or a lost connection or timeout
    of a collective, is transient and retried;
  * anything else (shape errors, a build failure, running out of memory on
    a deterministic workload) re-raises at once, so bugs stay loud.
Nothing retries onto the CPU: a retry runs on the same card.
"""

from __future__ import annotations

import re
import time
from typing import Any, Callable, Optional

# CUDA errors after which the context cannot be used again (cudaError_t:
# cudaErrorIllegalAddress, cudaErrorLaunchFailure, cudaErrorECCUncorrectable,
# cudaErrorAssert, cudaErrorMisalignedAddress, cudaErrorIllegalInstruction,
# cudaErrorHardwareStackError, cudaErrorInvalidPc, cudaErrorLaunchTimeout),
# by cudaGetErrorString's text or the enum's name.
STICKY_PATTERNS = (
    r"illegal memory access",
    r"unspecified launch failure",
    r"uncorrectable ECC error",
    r"device-side assert",
    r"misaligned address",
    r"illegal instruction",
    r"hardware stack error",
    r"invalid program counter",
    r"launch timed out",
    r"cudaError(IllegalAddress|LaunchFailure|ECCUncorrectable|Assert"
    r"|MisalignedAddress|IllegalInstruction|HardwareStackError|InvalidPc"
    r"|LaunchTimeout)",
)
# Conditions of the device or its links that a later attempt can outlive.
TRANSIENT_PATTERNS = (
    r"busy or unavailable",
    r"cudaError(DevicesUnavailable|NotReady)",
    r"device or resource busy",
    r"temporarily unavailable",
    r"socket closed",
    r"connection (reset|refused|closed)",
    r"deadline exceeded",
    r"(collective operation|watchdog).*time(d)? ?out",
)
_STICKY_RE = re.compile("|".join(STICKY_PATTERNS), re.IGNORECASE)
_TRANSIENT_RE = re.compile("|".join(TRANSIENT_PATTERNS), re.IGNORECASE)


def is_sticky_cuda_error(err: BaseException) -> bool:
    """True if ``err`` reports a CUDA error that leaves the context
    unusable."""
    return bool(_STICKY_RE.search(str(err)))


def is_transient_device_error(err: BaseException) -> bool:
    """True if ``err`` looks like a recoverable device or transport
    failure; a sticky CUDA error never is."""
    if not isinstance(err, (RuntimeError, OSError, ConnectionError)):
        return False
    if is_sticky_cuda_error(err):
        return False
    return bool(_TRANSIENT_RE.search(str(err)))


class RetriesExhausted(RuntimeError):
    """Raised when a transient failure persists past the retry budget."""

    def __init__(self, attempts: int, last: BaseException):
        super().__init__(
            f"device still failing after {attempts} attempts: {last}")
        self.attempts = attempts
        self.last = last


def retry_transient(fn: Callable[[], Any], *, retries: int = 3,
                    backoff_s: float = 20.0, backoff_mult: float = 2.0,
                    classify: Callable[[BaseException], bool]
                    = is_transient_device_error,
                    on_retry: Optional[Callable[[int, BaseException], None]]
                    = None,
                    sleep: Callable[[float], None] = time.sleep) -> Any:
    """Run ``fn()``; on a transient device error, back off and retry.

    retries: additional attempts after the first (so up to retries+1 calls).
    backoff_s: sleep before the first retry; multiplied by ``backoff_mult``
    each further retry.
    on_retry(attempt, err) runs AFTER each backoff sleep (the device has had
    time to recover) — drivers log and RESTORE device state there.  A
    transient error raised by on_retry itself (e.g. re-uploading state to a
    still-busy device) consumes retry budget and backs off again instead of
    escaping; non-transient errors propagate immediately.
    """
    delay = backoff_s
    attempt = 0
    while True:
        try:
            return fn()
        except BaseException as err:  # noqa: BLE001 — classify() filters
            if not classify(err):
                raise
            attempt += 1
            if attempt > retries:
                if attempt > 1:
                    raise RetriesExhausted(attempt, err) from err
                raise           # retries=0: surface the original error
            last = err
        while True:         # backoff, then restore; restore may itself fail
            sleep(delay)
            delay *= backoff_mult
            if on_retry is None:
                break
            try:
                on_retry(attempt, last)
                break
            except BaseException as err:  # noqa: BLE001
                if not classify(err):
                    raise
                attempt += 1
                if attempt > retries:
                    raise RetriesExhausted(attempt, err) from err
                last = err
