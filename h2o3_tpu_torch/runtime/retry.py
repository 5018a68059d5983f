"""Error classification and the shared retry policy.

A copy of `is_device_error`, `is_transient` and `RetryPolicy` from
`h2o3_tpu/runtime/retry.py`. The
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
its default size. `RetryPolicy` (capped decorrelated-jitter backoff, a
wall deadline, a process-wide budget and per-policy counters) serves the
local-file persist layer (`runtime/persist.py`), through which the block
store's disk tier reads its spill files back; the reference's client is
ROADMAP queue A, item 11.

Env knobs (constructor arguments win): ``H2O3_RETRY_MAX_ATTEMPTS``,
``H2O3_RETRY_BASE_MS``, ``H2O3_RETRY_MAX_MS``, ``H2O3_RETRY_DEADLINE_S``,
``H2O3_RETRY_SEED``.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Callable, Optional

import torch

from ..ops.hist_cuda import KernelError

__all__ = ["is_device_error", "is_transient", "RetryBudget", "RetryPolicy"]

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

# permanent OSError subclasses: retrying cannot make the file appear or the
# permission bit flip
_PERMANENT_OS = (FileNotFoundError, PermissionError, IsADirectoryError,
                 NotADirectoryError, FileExistsError)


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


def is_transient(exc: BaseException) -> bool:
    """True when a retry has a chance: connection-level failures, timeouts,
    device runtime errors, injected transient faults and I/O-shaped
    OSErrors. False for semantic errors (ValueError/TypeError/KeyError,
    missing files, cancellation, `InjectedCrash`)."""
    from ..models.model_base import JobCancelled
    from . import faults

    if isinstance(exc, JobCancelled):
        return False
    if isinstance(exc, faults.FaultInjected):
        # injected faults declare their own class: transient kinds subclass
        # transient builtins, InjectedCrash is the permanent one
        return not isinstance(exc, faults.InjectedCrash)
    if isinstance(exc, (ConnectionError, TimeoutError, InterruptedError,
                        BrokenPipeError)):
        return True
    if is_device_error(exc):
        return True
    if isinstance(exc, _PERMANENT_OS):
        return False
    if isinstance(exc, (ValueError, TypeError, KeyError, NotImplementedError,
                        AssertionError)):
        return False
    # residual OSErrors are I/O-shaped (EIO, network filesystems)
    return isinstance(exc, OSError)


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


_BUDGET_LOCK = threading.Lock()
_DEFAULT_BUDGET: Optional[RetryBudget] = None


def _default_budget() -> RetryBudget:
    """The process-wide budget the policies spend their retries from."""
    global _DEFAULT_BUDGET
    with _BUDGET_LOCK:
        if _DEFAULT_BUDGET is None:
            _DEFAULT_BUDGET = RetryBudget()
        return _DEFAULT_BUDGET


# -- counters ------------------------------------------------------------------

_REG_COUNTER = None


def _bump(policy: str, counter: str) -> None:
    """One policy event (calls, retries, recovered, permanent_failures,
    deadline_exceeded, attempts_exhausted, budget_exhausted) on the
    ``h2o3_retry_events`` registry family."""
    global _REG_COUNTER
    if _REG_COUNTER is None:
        from . import metrics_registry as reg

        _REG_COUNTER = reg.counter(
            "h2o3_retry_events",
            "shared retry-policy events (calls/retries/recovered/"
            "exhaustions) per policy", labelnames=("policy", "event"))
    _REG_COUNTER.inc(1, policy, counter)


class RetryPolicy:
    """Capped decorrelated-jitter backoff with a wall deadline and budget.
    ``call(fn)`` runs `fn()` to success or final failure; the last error is
    re-raised unchanged."""

    def __init__(self, name: str = "default",
                 max_attempts: Optional[int] = None,
                 base_delay_s: Optional[float] = None,
                 max_delay_s: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 classify: Callable[[BaseException], bool] = is_transient,
                 budget: Optional[RetryBudget] = None,
                 sleep: Callable[[float], None] = time.sleep):
        from . import env_float

        self.name = name
        self.max_attempts = int(max_attempts if max_attempts is not None
                                else env_float("H2O3_RETRY_MAX_ATTEMPTS", 4))
        self.base_delay_s = (base_delay_s if base_delay_s is not None
                             else env_float("H2O3_RETRY_BASE_MS", 50) / 1e3)
        self.max_delay_s = (max_delay_s if max_delay_s is not None
                            else env_float("H2O3_RETRY_MAX_MS", 2000) / 1e3)
        self.deadline_s = (deadline_s if deadline_s is not None
                           else env_float("H2O3_RETRY_DEADLINE_S", 30.0))
        self.classify = classify
        self._budget = budget
        self._sleep = sleep
        seed = os.environ.get("H2O3_RETRY_SEED")
        self._rng = random.Random(int(seed) if seed not in (None, "")
                                  else None)

    @property
    def budget(self) -> RetryBudget:
        return self._budget if self._budget is not None \
            else _default_budget()

    def next_delay(self, prev_delay: float) -> float:
        """Decorrelated jitter: uniform on [base, prev*3], capped."""
        hi = max(self.base_delay_s, min(self.max_delay_s, prev_delay * 3.0))
        return self._rng.uniform(self.base_delay_s, hi)

    def call(self, fn: Callable, *args, **kwargs):
        """Run fn(*args, **kwargs) under this policy."""
        _bump(self.name, "calls")
        t0 = time.monotonic()
        delay = self.base_delay_s
        attempt = 1
        while True:
            try:
                out = fn(*args, **kwargs)
                if attempt > 1:
                    _bump(self.name, "recovered")
                return out
            except Exception as e:
                if not self.classify(e):
                    _bump(self.name, "permanent_failures")
                    raise
                if attempt >= self.max_attempts:
                    _bump(self.name, "attempts_exhausted")
                    raise
                delay = self.next_delay(delay)
                if time.monotonic() - t0 + delay > self.deadline_s:
                    _bump(self.name, "deadline_exceeded")
                    raise
                if not self.budget.try_spend():
                    _bump(self.name, "budget_exhausted")
                    raise
                _bump(self.name, "retries")
                self._sleep(delay)
                attempt += 1
