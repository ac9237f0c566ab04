"""Continual refresh — the port's copy of ``shifu_tpu.refresh``: the
drift-gated train → gate → promote loop that turns the one-shot pipeline
into a long-running service.

- :mod:`controller` — the :class:`RefreshController` state machine
  (trigger on a PSI breach, live quality or a schedule; warm retrain;
  AUC-gated hot-swap; SLO- and canary-watched probation with automatic
  rollback);
- :mod:`journal` — crash-consistent cycle state and the immutable
  decision records under ``<modelset>/refresh/``;
- :mod:`retrain` — warm-start retraining over the data-window cursor
  (checkpoint resume, never a cold re-run).
"""

from .controller import (RefreshConfig, RefreshController,  # noqa: F401
                         drift_columns_for)
from .journal import (IDLE, PROBATION, TRAINED,  # noqa: F401
                      TRIGGERED, RefreshJournal, refresh_dir_for)
from .retrain import warm_retrain  # noqa: F401

__all__ = [
    "RefreshConfig", "RefreshController", "drift_columns_for",
    "RefreshJournal", "refresh_dir_for", "warm_retrain",
    "IDLE", "TRIGGERED", "TRAINED", "PROBATION",
]
