"""Error classification — the device-error test the serving failover uses.

A copy of `is_device_error` from `h2o3_tpu/runtime/retry.py`. The
reference names accelerator-runtime failures by XLA's status tags; the port
classes PyTorch's own device failures: `torch.cuda.OutOfMemoryError`,
`torch.AcceleratorError` (what a faulted CUDA call raises), and a
`RuntimeError` whose message carries one of torch's CUDA runtime tags
("CUDA error: ...", as torch before `AcceleratorError` raised it). A kernel
of the port that fails to build or launch raises `hist_cuda.KernelError`,
which is never a device error: it is the kernel's fault or its caller's,
and serving around it would move the work off the card. The reference's
`RetryPolicy`, budget and counters serve persist I/O, the client and the
train pool, which the port has not yet (ROADMAP queue A, item 11).
"""

from __future__ import annotations

import torch

from ..ops.hist_cuda import KernelError

__all__ = ["is_device_error"]

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
