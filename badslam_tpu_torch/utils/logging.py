"""Leveled logging + CHECK-style diagnostics.

Replaces the reference's loguru usage (libvis/src/libvis/logging.h wraps
loguru: LOG(INFO/WARNING/ERROR/FATAL) streams and CHECK / CHECK_EQ / ...
assertion macros that abort with a readable message). The port's own copy of
``badslam_tpu/utils/logging.py`` (same functions, same behaviour):

  * log records carry a severity and go through one process-wide sink (the
    BA / loop-detection worker threads log through the same lock-protected
    writer, so interleaved lines stay whole);
  * CHECK failures raise CheckFailedError (Python's structured analog of
    loguru's abort) with both reprs in the message;
  * verbosity is settable via code (`set_level`), CLI (`--log_level` in
    main.py) or the BADSLAM_LOG_LEVEL environment variable.

Kept deliberately on the standard `logging` module underneath so users can
re-route records into their own handlers.
"""

from __future__ import annotations

import logging as _pylogging
import os
import sys
import threading
import time
from typing import Any

DEBUG = _pylogging.DEBUG
INFO = _pylogging.INFO
WARNING = _pylogging.WARNING
ERROR = _pylogging.ERROR
FATAL = _pylogging.CRITICAL

_LEVELS = {"debug": DEBUG, "info": INFO, "warning": WARNING,
           "error": ERROR, "fatal": FATAL}

_logger = _pylogging.getLogger("badslam_tpu_torch")
_lock = threading.Lock()
_configured = False


class _Formatter(_pylogging.Formatter):
  """loguru-like line: `2026-08-17 12:00:01.123 I thread| message`."""

  _SHORT = {_pylogging.DEBUG: "D", _pylogging.INFO: "I",
            _pylogging.WARNING: "W", _pylogging.ERROR: "E",
            _pylogging.CRITICAL: "F"}

  def format(self, record):
    ts = time.strftime("%H:%M:%S", time.localtime(record.created))
    ms = int(record.msecs)
    lvl = self._SHORT.get(record.levelno, "?")
    return (f"{ts}.{ms:03d} {lvl} {record.threadName}| "
            f"{record.getMessage()}")


def _ensure_configured():
  global _configured
  if _configured:
    return
  with _lock:
    if _configured:
      return
    handler = _pylogging.StreamHandler(sys.stderr)
    handler.setFormatter(_Formatter())
    _logger.addHandler(handler)
    _logger.propagate = False
    env = os.environ.get("BADSLAM_LOG_LEVEL", "info").lower()
    _logger.setLevel(_LEVELS.get(env, INFO))
    _configured = True


def set_level(level) -> None:
  """Accepts a name ('debug', ..., 'fatal') or a numeric level."""
  _ensure_configured()
  if isinstance(level, str):
    level = _LEVELS[level.lower()]
  _logger.setLevel(level)


def debug(msg: str, *args):
  _ensure_configured()
  _logger.debug(msg, *args)


def info(msg: str, *args):
  _ensure_configured()
  _logger.info(msg, *args)


def warning(msg: str, *args):
  _ensure_configured()
  _logger.warning(msg, *args)


def error(msg: str, *args):
  _ensure_configured()
  _logger.error(msg, *args)


def fatal(msg: str, *args):
  """LOG(FATAL): logs and raises (loguru aborts; here the exception carries
  the message up to the caller / test harness)."""
  _ensure_configured()
  _logger.critical(msg, *args)
  raise CheckFailedError(msg % args if args else msg)


class CheckFailedError(AssertionError):
  """Raised by the CHECK family (logging.h CHECK macros)."""


def _fail(expr: str, detail: str):
  _ensure_configured()
  msg = f"CHECK failed: {expr}{detail}"
  _logger.critical(msg)
  raise CheckFailedError(msg)


def check(cond: Any, msg: str = ""):
  """CHECK(cond) — use for invariants, not control flow."""
  if not cond:
    _fail(msg or "condition", "")


def check_eq(a, b, msg: str = ""):
  if not (a == b):
    _fail(f"{msg or 'a == b'}", f" ({a!r} vs {b!r})")


def check_ne(a, b, msg: str = ""):
  if a == b:
    _fail(f"{msg or 'a != b'}", f" (both {a!r})")


def check_le(a, b, msg: str = ""):
  if not (a <= b):
    _fail(f"{msg or 'a <= b'}", f" ({a!r} vs {b!r})")


def check_lt(a, b, msg: str = ""):
  if not (a < b):
    _fail(f"{msg or 'a < b'}", f" ({a!r} vs {b!r})")


def check_ge(a, b, msg: str = ""):
  if not (a >= b):
    _fail(f"{msg or 'a >= b'}", f" ({a!r} vs {b!r})")


def check_gt(a, b, msg: str = ""):
  if not (a > b):
    _fail(f"{msg or 'a > b'}", f" ({a!r} vs {b!r})")


def check_notnull(x, msg: str = ""):
  if x is None:
    _fail(msg or "x != None", "")
  return x
