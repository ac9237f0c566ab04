"""Live-model registry: modelset-keyed scorers — the load/lookup core of
``shifu_tpu.serve.registry``.  (The serving journal, hot-swap and rollback
wait for a later slice.)"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

from ..eval.scorer import load_models
from .scorer import AOTScorer


class ModelRegistry:
    """One :class:`AOTScorer` per modelset key, built and warmed on load."""

    def __init__(self):
        self._lock = threading.Lock()
        self._live: Dict[str, AOTScorer] = {}
        self._gen: Dict[str, int] = {}

    def get(self, key: str) -> AOTScorer:
        with self._lock:
            try:
                return self._live[key]
            except KeyError:
                raise KeyError(f"no live model under {key!r} — load() one "
                               "first") from None

    def provider(self, key: str):
        """A per-flush scorer resolver for :class:`MicroBatcher`."""
        return lambda: self.get(key)

    def generation(self, key: str) -> int:
        with self._lock:
            return self._gen.get(key, 0)

    def load(self, key: str, models_or_dir,
             buckets: Optional[Sequence[int]] = None, transform=None,
             device=None) -> AOTScorer:
        """Load a modelset from a models dir or an in-memory model
        sequence and launch every rung once; a ``transform``
        (:class:`FusedTransform`) enables the raw-record path."""
        models = load_models(models_or_dir) \
            if isinstance(models_or_dir, str) else list(models_or_dir)
        scorer = AOTScorer(models, buckets=buckets, transform=transform,
                           device=device)
        scorer.warm()
        with self._lock:
            self._live[key] = scorer
            self._gen[key] = 0
        return scorer
