"""Crash-consistent file IO — the port's copy of ``shifu_tpu.ioutil``'s
atomic writes and transient-failure retry: content lands in a
same-directory temp file and ``os.replace``s into place, so a reader never
observes a torn file; ``io_retry`` absorbs up to ``shifu.io.retries``
transient ``OSError``s with exponential backoff and jitter."""

from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import random
import time
from typing import Any, Callable, Iterator, TypeVar

import numpy as np

log = logging.getLogger(__name__)

T = TypeVar("T")


def io_retry(fn: Callable[[], T], what: str, path: str = "") -> T:
    """Run ``fn``, absorbing transient ``OSError``s with exponential
    backoff + jitter.  The final failure re-raises the original error
    wrapped with provenance (``what`` + ``path``)."""
    from .config import environment
    attempts = max(0, environment.get_int("shifu.io.retries", 3)) + 1
    base = environment.get_int("shifu.io.retryBaseMs", 50) / 1000.0
    where = f" [{path}]" if path else ""
    for attempt in range(attempts):
        try:
            return fn()
        except OSError as e:
            if attempt + 1 >= attempts:
                raise OSError(f"{what} failed after {attempts} attempt(s)"
                              f"{where}: {e}") from e
            from . import obs
            obs.counter("ingest.retries").inc()
            delay = base * (2 ** attempt) * (1.0 + random.random())
            log.warning("transient IO error in %s%s (attempt %d/%d, "
                        "retrying in %.0f ms): %s", what, where,
                        attempt + 1, attempts, delay * 1000, e)
            time.sleep(delay)
    raise AssertionError("unreachable")


def _tmp_path(path: str) -> str:
    return f"{path}.tmp{os.getpid()}"


def atomic_write_bytes(path: str, data: bytes) -> None:
    tmp = _tmp_path(path)
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def atomic_write_text(path: str, text: str) -> None:
    atomic_write_bytes(path, text.encode("utf-8"))


def atomic_write_json(path: str, obj: Any, indent: int = 2) -> None:
    atomic_write_text(path, json.dumps(obj, indent=indent))


def atomic_savez(path: str, **arrays: np.ndarray) -> None:
    """npz written whole-or-not-at-all."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    atomic_write_bytes(path, buf.getvalue())


def atomic_save_npy(path: str, arr: np.ndarray) -> None:
    """Single-array ``.npy`` twin of :func:`atomic_savez`."""
    buf = io.BytesIO()
    np.save(buf, arr)
    atomic_write_bytes(path, buf.getvalue())


@contextlib.contextmanager
def atomic_open(path: str, mode: str = "w", **kwargs) -> Iterator[Any]:
    """Streaming writer with the temp + ``os.replace`` discipline: a clean
    exit commits the file into place, an exception unlinks the temp, so
    the final path is never observed half-written."""
    if "r" in mode or "a" in mode or "+" in mode:
        raise ValueError(f"atomic_open is write-only (mode={mode!r})")
    tmp = _tmp_path(path)
    f = open(tmp, mode, **kwargs)
    try:
        yield f
    except BaseException:
        f.close()
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    else:
        f.close()
        os.replace(tmp, path)


#: a ``*.tmp<pid>`` file younger than this may be a live writer's: its
#: rename follows its write within milliseconds
ORPHAN_MIN_AGE_S = 60.0


def sweep_orphan_tmp(directory: str) -> int:
    """Remove ``*.tmp<pid>`` droppings a previous crash left next to the
    artifacts, once older than :data:`ORPHAN_MIN_AGE_S`: several processes
    share some of these directories (the elastic board, the heartbeats),
    and one starting must not remove another's file between its write and
    its rename.  Returns the number removed (best-effort)."""
    n = 0
    try:
        entries = os.listdir(directory)
    except OSError:
        return 0
    now = time.time()
    for f in entries:
        _, tmp, pid = f.rpartition(".tmp")
        if tmp and pid.isdigit():
            path = os.path.join(directory, f)
            try:
                if now - os.path.getmtime(path) < ORPHAN_MIN_AGE_S:
                    continue
                os.remove(path)
                n += 1
            except OSError:
                pass
    return n
