"""Atomic file writes (the port's copy of the write half of
``shifu_tpu.ioutil``): content lands in a same-directory temp file and
``os.replace``s into place, so a reader never observes a torn file."""

from __future__ import annotations

import json
import os
from typing import Any


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
