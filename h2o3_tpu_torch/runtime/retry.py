"""Error classification — the device-error test the serving failover uses.

A copy of `is_device_error` from `h2o3_tpu/runtime/retry.py`. The
reference names accelerator-runtime failures by XLA's status tags; the port
classes PyTorch's own device failures: `torch.cuda.OutOfMemoryError`,
`torch.AcceleratorError` (what a faulted CUDA call raises), and a
`RuntimeError` whose message carries one of torch's CUDA runtime tags
("CUDA error: ...", as torch before `AcceleratorError` raised it). A kernel
of the port that fails to build or launch raises `hist_cuda.KernelError`,
which is never a device error: it is the kernel's fault or its caller's,
and serving around it would move the work off the card.

The train pool retries a candidate that failed with a device error, and
spends each retry from a `RetryBudget`, the reference's token bucket at
its default size. The reference's `RetryPolicy` with its backoff and
counters serves persist I/O and the client, which the port has not yet
(ROADMAP queue A, item 11).
"""

from __future__ import annotations

import threading
import time

import torch

from ..ops.hist_cuda import KernelError

__all__ = ["is_device_error", "RetryBudget"]

# torch.AcceleratorError exists from torch 2.8 on
_DEVICE_TYPES = (torch.cuda.OutOfMemoryError,
                 getattr(torch, "AcceleratorError", torch.cuda.OutOfMemoryError))
# substrings that mark a device-runtime failure in the message of a bare
# RuntimeError. Deliberately NARROW: a bare "device" or "cuda" would
# misclassify ordinary config errors ("h2o3_tpu_torch runs on cuda, and
# torch.cuda.is_available() is False") as accelerator faults and
# quarantine healthy scorers.
_DEVICE_MARKERS = ("CUDA error", "CUBLAS_STATUS", "CUDA out of memory",
                   "device-side assert")


def is_device_error(exc: BaseException) -> bool:
    """True for device-runtime failures (CUDA errors, device memory
    exhaustion and the injected `faults.InjectedDeviceError`) — the class
    the serving layer quarantines + falls back on. Request errors
    (`ValueError`, `TypeError`, `KeyError`) and the port's own kernel
    failures (`KernelError`) are never device errors."""
    from . import faults

    if isinstance(exc, KernelError):
        return False
    if isinstance(exc, (faults.InjectedDeviceError,) + _DEVICE_TYPES):
        return True
    if isinstance(exc, RuntimeError):
        msg = str(exc)
        return any(m in msg for m in _DEVICE_MARKERS)
    return False


class RetryBudget:
    """Token bucket bounding retries per process: a hard outage must
    degrade to fail-fast, not multiply load by the attempt count.
    Refills continuously."""

    CAPACITY = 64
    REFILL_PER_S = 2.0

    def __init__(self):
        self._tokens = float(self.CAPACITY)
        self._t_last = time.monotonic()
        self._lock = threading.Lock()

    def try_spend(self) -> bool:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.CAPACITY,
                               self._tokens
                               + (now - self._t_last) * self.REFILL_PER_S)
            self._t_last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False
