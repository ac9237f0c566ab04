"""The resident-vs-streamed decision — the port's copy of
``shifu_tpu.data.streaming.should_stream``.  The out-of-core planes
themselves (``ShardStream``, the streamed trainers) are not ported yet
(ROADMAP Queue 1 item 8)."""

from __future__ import annotations

from typing import Optional


def should_stream(shards, schema: Optional[dict] = None) -> bool:
    """Stream out-of-core when the f32 norm plane would not fit
    ``shifu.train.memoryBudgetBytes`` (default 2 GiB); forced either way
    via ``-Dshifu.train.streaming=on|off``."""
    from ..config import environment
    mode = (environment.get_property("shifu.train.streaming", "auto")
            or "auto").lower()
    if mode in ("on", "true", "force"):
        return True
    if mode in ("off", "false"):
        return False
    schema = schema if schema is not None else getattr(shards, "schema", {})
    budget = environment.get_int("shifu.train.memoryBudgetBytes", 1 << 31)
    width = len(schema.get("outputNames") or []) or 1
    n_rows = schema.get("numRows") or shards.num_rows
    return n_rows * 4 * (width + 2) > budget
