"""Overload-protection primitives shared by the serving plane — the port
of ``shifu_tpu.serve.overload`` (the same knobs, codes and state
machines; the retry budget and the breaker serve the fleet router).

The serving path degrades PREDICTABLY under stress instead of
congestion-collapsing (the reference system's 97%-quorum / iteration-
timeout philosophy applied to serving):

- **Coded fast-fail errors** — :class:`OverloadedError` (HTTP 429 with a
  drain-rate-derived ``Retry-After``) for submits rejected at the
  admission cap, :class:`DeadlineExceededError` (HTTP 504) for tickets
  whose deadline passed before their rows launched.  A shed request is
  ALWAYS answered with one of these, never silently dropped.
- **Admission cap** — ``-Dshifu.serve.maxQueueRows`` bounds the
  micro-batcher queue (0 = auto: :data:`AUTO_QUEUE_BUCKETS` x the top
  bucket rung — enough runway for a burst, small enough that queue wait
  cannot blow the deadline by itself).
- **Request deadlines** — ``-Dshifu.serve.requestDeadlineMs`` is the
  default per-request budget; the ``X-Shifu-Deadline-Ms`` header
  overrides per request and propagates router -> worker -> batcher.
- :class:`RetryBudget` — a token bucket capping router requeues at
  ``-Dshifu.serve.retryBudgetFrac`` of recent successes, so a dying
  fleet sheds retries instead of amplifying its own overload.
- :class:`CircuitBreaker` — per-replica consecutive-failure breaker
  (``-Dshifu.serve.breakerFailures``): open after N consecutive
  transport/5xx failures, half-open single probe after a cooldown,
  closed again on the first success.

Everything here is plain state-machine code with injectable time — the
serve tests drive every transition with a fake clock and zero sleeps.
"""

from __future__ import annotations

import threading
from typing import Optional

#: auto admission cap: this many top-bucket flushes of queue runway
AUTO_QUEUE_BUCKETS = 128

DEFAULT_RETRY_BUDGET_FRAC = 0.1
DEFAULT_BREAKER_FAILURES = 3
#: breaker cooldown before the half-open probe (seconds)
DEFAULT_BREAKER_COOLDOWN_S = 2.0
#: retry tokens a fresh budget starts with — the full cap, so a replica
#: death right after startup can be absorbed by healthy peers; sustained
#: failure still drains it and sheds (successes refill only ``frac`` each)
RETRY_BUDGET_INITIAL = 10.0
#: retry tokens never accumulate past this many
RETRY_BUDGET_CAP = 10.0


class OverloadedError(RuntimeError):
    """Coded admission rejection: the queue is at ``maxQueueRows`` (or a
    retry budget is exhausted).  Maps to HTTP 429 with a ``Retry-After``
    derived from the batcher's current drain rate."""

    code = "overloaded"

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = max(0.001, float(retry_after_s))


class DeadlineExceededError(RuntimeError):
    """Coded deadline shed: the request's deadline passed before its
    rows launched (or the client abandoned the ticket), so ``pump()``
    dropped it BEFORE pad/launch.  Maps to HTTP 504."""

    code = "deadline_exceeded"


# ------------------------------------------------------------- knob readers
def configured_max_queue_rows() -> int:
    """Admission cap (rows): property ``shifu.serve.maxQueueRows``;
    0 (the default) = auto, ``AUTO_QUEUE_BUCKETS`` x the top rung."""
    from ..config import environment
    return max(0, environment.get_int("shifu.serve.maxQueueRows", 0))


def configured_deadline_s() -> float:
    """Default per-request deadline (seconds): property
    ``shifu.serve.requestDeadlineMs``; 0 (the default) = no deadline."""
    from ..config import environment
    return max(0.0, environment.get_float(
        "shifu.serve.requestDeadlineMs", 0.0)) / 1000.0


def configured_retry_budget_frac() -> float:
    """Router retry allowance per recent success: property
    ``shifu.serve.retryBudgetFrac`` (default 0.1; 0 = no retries)."""
    from ..config import environment
    return max(0.0, environment.get_float("shifu.serve.retryBudgetFrac",
                                          DEFAULT_RETRY_BUDGET_FRAC))


def configured_hedge_s() -> float:
    """Hedged-dispatch floor/fallback delay (seconds): property
    ``shifu.serve.hedgeMs``; 0 (the default) = hedging off.  When the
    router's latency tracker has data, the ACTUAL delay is its observed
    p99 (never below this floor) — the knob both arms hedging and keeps
    a cold tracker from hedging instantly."""
    from ..config import environment
    return max(0.0, environment.get_float("shifu.serve.hedgeMs",
                                          0.0)) / 1000.0


def configured_breaker_failures() -> int:
    """Consecutive transport/5xx failures that open a replica's breaker:
    property ``shifu.serve.breakerFailures`` (default 3; 0 = off)."""
    from ..config import environment
    return max(0, environment.get_int("shifu.serve.breakerFailures",
                                      DEFAULT_BREAKER_FAILURES))


def configured_brownout_enabled() -> bool:
    """Brownout degradation switch: property ``shifu.serve.brownout``
    (default true)."""
    from ..config import environment
    return environment.get_bool("shifu.serve.brownout", True)


# ------------------------------------------------------------- retry budget
class RetryBudget:
    """Token bucket bounding retries to a fraction of recent successes.

    Each success deposits ``frac`` of a token (capped); each retry
    spends one whole token.  Under total backend failure the budget
    drains after ``RETRY_BUDGET_INITIAL`` + accrued retries and further
    requests fast-fail as :class:`OverloadedError` instead of hammering
    dead replicas — retry *amplification* is the collapse mechanism this
    caps."""

    def __init__(self, frac: Optional[float] = None,
                 initial: float = RETRY_BUDGET_INITIAL,
                 cap: float = RETRY_BUDGET_CAP):
        self.frac = configured_retry_budget_frac() if frac is None \
            else max(0.0, float(frac))
        self.cap = float(cap)
        self._tokens = min(float(initial), self.cap) if self.frac > 0 \
            else 0.0
        self._lock = threading.Lock()

    @property
    def tokens(self) -> float:
        return self._tokens

    def on_success(self) -> None:
        with self._lock:
            self._tokens = min(self.cap, self._tokens + self.frac)

    def try_retry(self) -> bool:
        """Spend one token; False = budget exhausted, shed the retry."""
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False


# ----------------------------------------------------------- circuit breaker
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Per-replica consecutive-failure breaker (see module docs).

    ``allow(now)`` gates dispatch: CLOSED always allows; OPEN refuses
    until ``cooldown_s`` has passed, then flips HALF_OPEN and allows
    exactly ONE probe; the probe's outcome closes (success) or re-opens
    (failure) the breaker.  ``threshold`` 0 disables the breaker (always
    allows, never opens)."""

    def __init__(self, threshold: Optional[int] = None,
                 cooldown_s: float = DEFAULT_BREAKER_COOLDOWN_S):
        self.threshold = configured_breaker_failures() \
            if threshold is None else max(0, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self.state = CLOSED
        self.failures = 0
        self.opens = 0                    # lifetime open transitions
        self._open_until = 0.0
        self._probing = False
        self._lock = threading.Lock()

    def allow(self, now: float) -> bool:
        if self.threshold <= 0:
            return True
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                if now < self._open_until:
                    return False
                self.state = HALF_OPEN
                self._probing = True
                return True               # the single half-open probe
            # HALF_OPEN: one probe outstanding at a time
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self) -> None:
        if self.threshold <= 0:
            return
        with self._lock:
            self.state = CLOSED
            self.failures = 0
            self._probing = False

    def record_failure(self, now: float) -> bool:
        """One transport/5xx failure; True when this one OPENED the
        breaker (the ``serve.fleet_breaker_opens`` edge)."""
        if self.threshold <= 0:
            return False
        with self._lock:
            if self.state == HALF_OPEN:   # failed probe: straight back
                self.state = OPEN
                self.opens += 1
                self._open_until = now + self.cooldown_s
                self._probing = False
                return True
            self.failures += 1
            if self.state == CLOSED and self.failures >= self.threshold:
                self.state = OPEN
                self.opens += 1
                self._open_until = now + self.cooldown_s
                return True
            return False
