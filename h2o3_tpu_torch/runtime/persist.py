"""Persist SPI — the local-file storage backend.

A copy of the local-file half of `h2o3_tpu/runtime/persist.py`
(`Persist`, its resuming reader and the scheme dispatch `for_uri`), the
part the block store's disk tier (`models/block_store.py`) writes and
reads its spill files through. Every open, read and list runs under the
shared `runtime/retry.RetryPolicy` ("persist" policy); a read that fails
part way re-opens the file and resumes at the byte it reached. The fault
points ``persist.open``, ``persist.read`` and ``persist.list``
(`runtime/faults.py`) exercise those paths deterministically.

The reference's HTTP and Arrow-filesystem backends (s3, gs, hdfs, http)
are not ported: `for_uri` raises `NotImplementedError` for their schemes
(ROADMAP queue A, item 11).
"""

from __future__ import annotations

import glob as _glob
import os
import threading
from typing import List, Optional

from . import faults
from . import retry as _retry

_POLICY: Optional[_retry.RetryPolicy] = None
_POLICY_LOCK = threading.Lock()


def _policy() -> _retry.RetryPolicy:
    global _POLICY
    with _POLICY_LOCK:
        if _POLICY is None:
            _POLICY = _retry.RetryPolicy(name="persist")
        return _POLICY


def reset_policy() -> None:
    """Rebuild the policy from the environment (tests tune H2O3_RETRY_*)."""
    global _POLICY
    with _POLICY_LOCK:
        _POLICY = None


class Persist:
    """file:// and bare paths — the reference's PersistNFS/PersistFS."""

    scheme = "file"

    def open(self, uri: str, mode: str = "rb"):
        def _open():
            faults.check("persist.open", uri)
            return open(self._strip(uri), mode)

        return _policy().call(_open)

    def exists(self, uri: str) -> bool:
        return os.path.exists(self._strip(uri))

    def list(self, uri: str) -> List[str]:
        def _list():
            faults.check("persist.list", uri)
            p = self._strip(uri)
            if os.path.isdir(p):
                return sorted(os.path.join(p, f) for f in os.listdir(p))
            return sorted(_glob.glob(p))

        return _policy().call(_list)

    def size(self, uri: str) -> int:
        return os.path.getsize(self._strip(uri))

    def open_resuming(self, uri: str):
        """A read stream that survives torn reads: a failed read() re-opens
        the file and seeks back to the current offset under the shared
        retry policy."""
        return _ResumingStream(self, uri)

    @staticmethod
    def _strip(uri: str) -> str:
        return uri[len("file://"):] if uri.startswith("file://") else uri


class _ResumingStream:
    """Resuming reader: tracks the byte offset handed to the caller; a
    read failure marks the stream dead and the next retry attempt re-opens
    the file and positions itself at the offset (``seek``, or a skip-read
    loop where the handle cannot seek). ``persist.read`` faults are checked
    per attempt, so an armed fault exercises exactly this resume."""

    def __init__(self, backend: Persist, uri: str):
        self._backend = backend
        self._uri = uri
        self._pos = 0
        self._fh = None
        self._dead = True          # the first read opens lazily

    def _reopen(self):
        fh = self._backend.open(self._uri, "rb")
        if self._pos:
            try:
                fh.seek(self._pos)
            except (AttributeError, OSError, ValueError):
                left = self._pos
                while left > 0:
                    chunk = fh.read(min(left, 1 << 20))
                    if not chunk:
                        break
                    left -= len(chunk)
        self._fh = fh

    def read(self, n: int = -1) -> bytes:
        def _read():
            faults.check("persist.read", self._uri)
            # reopen at the top of the attempt: a reopen that fails must
            # leave the stream dead, or the next retry would read the
            # closed handle and truncate
            if self._dead:
                self._reopen()
                self._dead = False
            try:
                return self._fh.read(n)
            except (OSError, ValueError) as e:
                self._dead = True
                try:
                    self._fh.close()
                except OSError:
                    pass
                raise ConnectionError(
                    f"read of {self._uri} dropped at byte "
                    f"{self._pos}: {e}") from e

        out = _policy().call(_read)
        self._pos += len(out)
        return out

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_REGISTRY = {"file": Persist()}
# the reference's remote backends: ROADMAP queue A, item 11
_UNPORTED = ("s3", "s3a", "hdfs", "gs", "http", "https")


def for_uri(uri: str) -> Persist:
    scheme = uri.split("://", 1)[0] if "://" in uri else "file"
    if scheme in _UNPORTED:
        raise NotImplementedError(
            f"the {scheme!r} persist backend is not ported (ROADMAP queue A, "
            "item 11: the HTTP and Arrow-filesystem backends)")
    if scheme not in _REGISTRY:
        raise ValueError(f"no persistence backend for scheme {scheme!r}")
    return _REGISTRY[scheme]
