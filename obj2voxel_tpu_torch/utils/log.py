"""Leveled logging with an optional user callback and an async backend.

Mirrors the voxelio logging surface the reference exposes through its C API
(reference: include/obj2voxel.h:100-120, src/obj2voxel.cpp:658-682): numeric
levels SILENT..DEBUG, a pluggable callback that may swallow messages or fall
through to the default printer, and a module-global level.  Two voxelio-only
facilities are reproduced as well:

* SPAM (level 5): more verbose than DEBUG, used for per-slab progress logs
  (reference logs per-chunk progress at SPAM, src/obj2voxel.cpp:304-308).
  It is not part of the public C enum -- the CLI's -v enables it like the
  reference's verbose flag enables DEBUG+timestamps (main.cpp:357-361).
* Async backend (reference constants.hpp:23 ENABLE_ASYNC_LOGGING, enabled by
  the CLI in main.cpp:216): formatting/printing happens on a daemon thread so
  the engine's host loop never blocks on stderr.
"""

from __future__ import annotations

import queue
import sys
import threading
import time

from ..constants import (
    LOG_LEVEL_DEBUG,
    LOG_LEVEL_ERROR,
    LOG_LEVEL_INFO,
    LOG_LEVEL_SILENT,
    LOG_LEVEL_SPAM,
    LOG_LEVEL_WARNING,
)

_LEVEL_NAMES = {
    LOG_LEVEL_ERROR: "ERROR",
    LOG_LEVEL_WARNING: "WARNING",
    LOG_LEVEL_INFO: "INFO",
    LOG_LEVEL_DEBUG: "DEBUG",
    LOG_LEVEL_SPAM: "SPAM",
}


class Logger:
    def __init__(self):
        self.level = LOG_LEVEL_INFO
        self.callback = None
        self.timestamps = False
        self._queue: queue.Queue | None = None
        self._thread: threading.Thread | None = None

    def set_level(self, level: int):
        self.level = int(level)

    def get_level(self) -> int:
        return self.level

    def set_callback(self, callback):
        """callback(message, level) -> bool; True means "handled"."""
        self.callback = callback

    # --- async backend -------------------------------------------------------

    def set_async(self, enabled: bool):
        """Route printing through a daemon thread (reference async backend)."""
        if enabled and self._thread is None:
            self._queue = queue.Queue()
            self._thread = threading.Thread(
                target=self._drain, name="o2v-log", daemon=True
            )
            self._thread.start()
        elif not enabled and self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=2)
            self._queue = None
            self._thread = None

    def flush(self):
        if self._queue is not None:
            self._queue.join()

    def _drain(self):
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            try:
                self._print(*item)
            finally:
                self._queue.task_done()

    # --- emission -------------------------------------------------------------

    def _print(self, level: int, msg: str, stamp: str):
        name = _LEVEL_NAMES.get(level, "LOG")
        print(f"{stamp}[{name}] {msg}", file=sys.stderr)

    def _emit(self, level: int, msg: str):
        if level > self.level or self.level == LOG_LEVEL_SILENT:
            return
        if self.callback is not None and self.callback(msg, level):
            return
        stamp = time.strftime("%H:%M:%S ") if self.timestamps else ""
        if self._queue is not None:
            self._queue.put((level, msg, stamp))
        else:
            self._print(level, msg, stamp)

    def error(self, msg: str):
        self._emit(LOG_LEVEL_ERROR, msg)

    def warning(self, msg: str):
        self._emit(LOG_LEVEL_WARNING, msg)

    def info(self, msg: str):
        self._emit(LOG_LEVEL_INFO, msg)

    def debug(self, msg: str):
        self._emit(LOG_LEVEL_DEBUG, msg)

    def spam(self, msg: str):
        self._emit(LOG_LEVEL_SPAM, msg)


log = Logger()
