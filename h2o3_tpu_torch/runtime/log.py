"""Log — per-process logger with an in-memory ring exposed over REST.

A copy of `h2o3_tpu/runtime/log.py`. Reference parity:
`h2o-core/src/main/java/water/util/Log.java` (per-node rotating log files +
levels TRACE..FATAL) and `water/api/LogsHandler.java` (`/3/Logs/download`
serves the ring). One process plays the role of one H2O node, so one ring +
one file per process.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import List, Optional

LEVELS = ("TRACE", "DEBUG", "INFO", "WARN", "ERRR", "FATAL")


class Log:
    _ring: deque = deque(maxlen=10000)
    _lock = threading.Lock()
    _file = None
    _level = "INFO"

    @classmethod
    def set_level(cls, level: str):
        if level not in LEVELS:
            raise ValueError(f"bad log level {level!r}")
        cls._level = level

    @classmethod
    def set_log_dir(cls, path: Optional[str]):
        with cls._lock:
            if cls._file:
                cls._file.close()
                cls._file = None
            if path:
                os.makedirs(path, exist_ok=True)
                fname = os.path.join(path, f"h2o3tpu_{os.getpid()}.log")
                cls._file = open(fname, "a", buffering=1)

    @classmethod
    def _write(cls, level: str, msg: str):
        if LEVELS.index(level) < LEVELS.index(cls._level):
            return
        ts = time.strftime("%m-%d %H:%M:%S")
        line = f"{ts} {os.getpid()} {level} {msg}"
        with cls._lock:
            cls._ring.append(line)
            if cls._file:
                cls._file.write(line + "\n")

    @classmethod
    def trace(cls, msg):
        cls._write("TRACE", str(msg))

    @classmethod
    def debug(cls, msg):
        cls._write("DEBUG", str(msg))

    @classmethod
    def info(cls, msg):
        cls._write("INFO", str(msg))

    @classmethod
    def warn(cls, msg):
        cls._write("WARN", str(msg))

    @classmethod
    def err(cls, msg):
        cls._write("ERRR", str(msg))

    @classmethod
    def get_logs(cls, n: int = 1000) -> List[str]:
        with cls._lock:
            return list(cls._ring)[-n:]

    @classmethod
    def clear(cls):
        with cls._lock:
            cls._ring.clear()
