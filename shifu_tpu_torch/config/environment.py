"""Global key-value config, the reference's ``Environment`` + ``shifuconfig``
(the port's copy of ``shifu_tpu.config.environment``; the serving path
reads ``shifu.serve.buckets`` and ``shifu.serve.maxDelayMs`` from it).

Three tiers, mirroring reference ``util/Environment.java:35,62-73`` and
``ShifuCLI.java:430-453``:

1. per-model ``ModelConfig.json`` (see ``model_config``),
2. global ``$SHIFU_TPU_HOME/conf/shifuconfig`` (``key=value`` lines),
3. ``-Dkey=value`` CLI overrides (highest priority).

Environment variables prefixed ``SHIFU_`` are folded in between tiers 2 and 3.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

_props: Dict[str, str] = {}
_loaded = False


def _load_config_file(path: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    if not os.path.isfile(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            key, sep, val = line.partition("=")
            if sep:
                out[key.strip()] = val.strip()
    return out


def _ensure_loaded() -> None:
    global _loaded
    if _loaded:
        return
    home = os.environ.get("SHIFU_TPU_HOME") or os.environ.get("SHIFU_HOME")
    if home:
        _props.update(_load_config_file(os.path.join(home, "conf", "shifuconfig")))
    for k, v in os.environ.items():
        if k.startswith("SHIFU_"):
            _props.setdefault(k.lower().replace("_", "."), v)
    _loaded = True


def set_property(key: str, value: Any) -> None:
    _ensure_loaded()
    _props[key] = str(value)


def get_property(key: str, default: Optional[str] = None) -> Optional[str]:
    _ensure_loaded()
    v = _props.get(key)
    if v is None:
        # env vars lowercase on import (SHIFU_TRAIN_WINDOWROWS ->
        # shifu.train.windowrows) — camelCase property names still match
        v = _props.get(key.lower())
    # empty string = unset (clearing a property restores the default)
    return default if v is None or v == "" else v


def get_int(key: str, default: int) -> int:
    v = get_property(key)
    try:
        return int(v) if v is not None else default
    except ValueError:
        return default


def get_float(key: str, default: float) -> float:
    v = get_property(key)
    try:
        return float(v) if v is not None else default
    except ValueError:
        return default


def get_bool(key: str, default: bool) -> bool:
    v = get_property(key)
    if v is None:
        return default
    return v.strip().lower() in ("true", "1", "yes", "on")


def all_properties() -> Dict[str, str]:
    _ensure_loaded()
    return dict(_props)


def reset_for_tests() -> None:
    global _loaded
    _props.clear()
    _loaded = False
