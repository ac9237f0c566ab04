"""Live SLO plane — sliding-window latency quantiles, availability and
multi-window error-budget burn-rate alerts for the serving path; the
port of ``shifu_tpu.obs.slo`` (same bins, windows and rules, so the two
packages report the same numbers for the same stream).

The serving contract is a latency/availability OBJECTIVE, not a metric:
``-Dshifu.serve.sloP99Ms`` (default 2x the flush deadline — the
measured "deadline + one launch" p99 of a healthy server) and
``-Dshifu.serve.sloAvailability`` (default 0.999).  This module tracks
compliance LIVE with bounded memory:

- :class:`LogBins` / :class:`SLOTracker` — latency quantiles come from a
  fixed-bin LOG histogram sketch (128 bins over 10 us..100 s, ~6.6%
  relative error per bin), held in a ring of sliding windows.  NO
  per-request storage: at 1M+ QPS the tracker's state stays a few KB and
  an ``observe_batch`` is one vectorized bincount under a lock.
- **Burn rates** — the SRE error-budget formulation.  Each objective
  defines an allowed failure fraction (p99 objective -> 1% of requests
  may exceed it; availability 0.999 -> 0.1% may error); the burn rate is
  the observed failure fraction over that allowance (burn 1.0 = exactly
  spending the budget, 14.4 = the classic page threshold).  Alerts are
  MULTI-WINDOW: a rule fires only when the burn exceeds its threshold
  over BOTH the short horizon (the current window — fast detection) and
  the long horizon (the whole ring — flap suppression), so a hard breach
  trips within one window while a transient blip does not page.
- Surfaces: :meth:`SLOTracker.summary` backs the ``/slo`` endpoint,
  :meth:`SLOTracker.compact` rides SERVE heartbeats into the monitor, and :meth:`SLOTracker.emit_gauges` mirrors the
  headline numbers into the ``slo.*`` registry gauges each beat so
  ``metrics.prom`` scrapes them.

The tracker itself is telemetry-independent (the SLO is the serving
contract whether or not tracing is on); only the gauge mirror is gated
on the obs enable, per the zero-cost convention.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

DEFAULT_AVAILABILITY = 0.999
# p99 objective means 1% of requests may exceed it — the latency
# budget's allowed failure fraction is fixed by the quantile, not a knob
LATENCY_BUDGET_FRAC = 0.01

# multi-window burn thresholds (severity, burn): the classic SRE pair —
# 14.4 burns a 30-day budget in 2 days (page), 6.0 in 5 days (ticket)
ALERT_RULES: Tuple[Tuple[str, float], ...] = (("page", 14.4),
                                              ("ticket", 6.0))


def slo_objectives(max_delay_ms: float) -> Tuple[float, float]:
    """(p99_ms, availability) objectives: properties
    ``shifu.serve.sloP99Ms`` / ``shifu.serve.sloAvailability``, with
    defaults 2x the flush deadline (deadline + one launch, the healthy
    low-load p99) and 0.999."""
    from ..config import environment
    p99 = environment.get_float("shifu.serve.sloP99Ms",
                                2.0 * float(max_delay_ms))
    avail = environment.get_float("shifu.serve.sloAvailability",
                                  DEFAULT_AVAILABILITY)
    return max(float(p99), 0.0), min(max(float(avail), 0.0), 1.0 - 1e-9)


class LogBins:
    """Fixed log-spaced bin edges over [10**lo_exp, 10**hi_exp) seconds
    plus an underflow and an overflow bin.  Shared by the SLO tracker
    and the registry histogram sketch, so every quantile in the system
    has the same resolution."""

    __slots__ = ("lo_exp", "hi_exp", "per_decade", "n", "_scale")

    def __init__(self, lo_exp: int = -5, hi_exp: int = 2,
                 per_decade: int = 18):
        self.lo_exp = lo_exp
        self.hi_exp = hi_exp
        self.per_decade = per_decade
        # bin 0 = underflow (v <= 10**lo_exp), bin n-1 = overflow
        self.n = (hi_exp - lo_exp) * per_decade + 2
        self._scale = float(per_decade) / math.log(10.0)

    def index(self, v: float) -> int:
        if not v > 10.0 ** self.lo_exp:
            return 0
        i = int(math.log(v) * self._scale - self.lo_exp * self.per_decade) + 1
        return min(max(i, 1), self.n - 1)

    def indices(self, values: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`index` (the observe_batch hot path)."""
        v = np.asarray(values, np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            i = np.floor(np.log(np.maximum(v, 1e-300)) * self._scale
                         - self.lo_exp * self.per_decade).astype(np.int64) + 1
        i[~(v > 10.0 ** self.lo_exp)] = 0
        return np.clip(i, 0, self.n - 1)

    def value(self, i: int) -> float:
        """Representative value for a bin (geometric midpoint; edge
        values for the under/overflow bins)."""
        if i <= 0:
            return 10.0 ** self.lo_exp
        if i >= self.n - 1:
            return 10.0 ** self.hi_exp
        lo = 10.0 ** (self.lo_exp + (i - 1) / self.per_decade)
        hi = 10.0 ** (self.lo_exp + i / self.per_decade)
        return math.sqrt(lo * hi)


# one shared ladder: SLO windows and registry histograms agree on bins
LOG_BINS = LogBins()


def quantile_from_counts(counts: np.ndarray, q: float,
                         bins: LogBins = LOG_BINS) -> Optional[float]:
    """Quantile estimate (seconds/native units) from a bin-count vector;
    None when the sketch is empty."""
    total = int(counts.sum())
    if total == 0:
        return None
    target = q * total
    cum = 0
    for i, c in enumerate(counts):
        cum += int(c)
        if cum >= target:
            return bins.value(i)
    return bins.value(len(counts) - 1)


class SLOTracker:
    """Sliding-window SLO compliance for one serving surface; see module
    docs.  ``window_s`` x ``n_windows`` is the long alert horizon
    (default 10 s x 30 = 5 min); the short horizon is the current
    window.  Thread-safe; the clock is injectable for tests."""

    def __init__(self, p99_ms: float, availability: float = DEFAULT_AVAILABILITY,
                 window_s: float = 10.0, n_windows: int = 30,
                 clock: Callable[[], float] = time.monotonic,
                 bins: LogBins = LOG_BINS):
        self.p99_ms = float(p99_ms)
        self.availability_objective = min(max(float(availability), 0.0),
                                          1.0 - 1e-9)
        self.window_s = float(window_s)
        self.n_windows = int(n_windows)
        self.clock = clock
        self.bins = bins
        self._lock = threading.Lock()
        self._t0 = clock()
        # ring of windows: slot s holds absolute window number _win_no[s]
        self._counts = np.zeros((self.n_windows, bins.n), np.int64)
        self._ok = np.zeros(self.n_windows, np.int64)
        self._err = np.zeros(self.n_windows, np.int64)
        self._over = np.zeros(self.n_windows, np.int64)
        self._win_no = np.full(self.n_windows, -1, np.int64)
        # load-shed accounting (overload protection): sheds are counted
        # SEPARATELY from errors — a coded fast-fail is the designed
        # response to overload, and folding it into availability burn
        # would drain every replica exactly when the fleet most needs
        # them serving (congestion collapse by alerting)
        self._shed = 0

    # ------------------------------------------------------------ writes
    def _slot(self, now: float) -> int:
        """Ring slot for ``now``, resetting it if it held an expired
        window.  Caller holds the lock."""
        wno = int((now - self._t0) / self.window_s)
        s = wno % self.n_windows
        if self._win_no[s] != wno:
            self._counts[s, :] = 0
            self._ok[s] = self._err[s] = self._over[s] = 0
            self._win_no[s] = wno
        return s

    def observe_batch(self, latencies_s: np.ndarray,
                      now: Optional[float] = None) -> None:
        """Fold one batch's per-row latencies (seconds) into the current
        window — one vectorized bincount, no per-request storage."""
        lat = np.asarray(latencies_s, np.float64)
        if lat.size == 0:
            return
        idx = self.bins.indices(lat)
        over = int((lat * 1000.0 > self.p99_ms).sum())
        now = self.clock() if now is None else now
        with self._lock:
            s = self._slot(now)
            self._counts[s] += np.bincount(idx, minlength=self.bins.n)
            self._ok[s] += lat.size
            self._over[s] += over

    def record_errors(self, n: int = 1, now: Optional[float] = None) -> None:
        now = self.clock() if now is None else now
        with self._lock:
            self._err[self._slot(now)] += int(n)

    def record_shed(self, n: int = 1) -> None:
        """Count load-shed requests (admission rejects, deadline drops,
        client cancels) — deliberately OUTSIDE the availability budget;
        see the constructor comment."""
        with self._lock:
            self._shed += int(n)

    @property
    def shed_total(self) -> int:
        return self._shed

    # ------------------------------------------------------------- reads
    def _merged(self, horizon_s: Optional[float],
                now: float) -> Tuple[np.ndarray, int, int, int]:
        """(bin counts, ok, err, over) summed over the windows inside
        ``horizon_s`` (None = the whole ring), current partial window
        included."""
        cur = int((now - self._t0) / self.window_s)
        if horizon_s is None:
            need = self.n_windows
        else:
            need = max(1, int(math.ceil(horizon_s / self.window_s)))
        with self._lock:
            live = (self._win_no > cur - need) & (self._win_no >= 0) \
                & (self._win_no <= cur)
            return (self._counts[live].sum(axis=0),
                    int(self._ok[live].sum()), int(self._err[live].sum()),
                    int(self._over[live].sum()))

    def quantile_ms(self, q: float, horizon_s: Optional[float] = None,
                    now: Optional[float] = None) -> Optional[float]:
        now = self.clock() if now is None else now
        counts, _, _, _ = self._merged(horizon_s, now)
        v = quantile_from_counts(counts, q, self.bins)
        return None if v is None else v * 1000.0

    def availability_observed(self, horizon_s: Optional[float] = None,
                              now: Optional[float] = None) -> float:
        now = self.clock() if now is None else now
        _, ok, err, _ = self._merged(horizon_s, now)
        total = ok + err
        return 1.0 if total == 0 else ok / total

    def burn_rates(self, horizon_s: Optional[float] = None,
                   now: Optional[float] = None) -> Dict[str, float]:
        """{'latency': burn, 'availability': burn} over the horizon —
        observed failure fraction over the budgeted allowance."""
        now = self.clock() if now is None else now
        _, ok, err, over = self._merged(horizon_s, now)
        total = ok + err
        out = {"latency": 0.0, "availability": 0.0}
        if ok:
            out["latency"] = (over / ok) / LATENCY_BUDGET_FRAC
        if total:
            allowed = max(1.0 - self.availability_objective, 1e-9)
            out["availability"] = (err / total) / allowed
        return {k: round(v, 3) for k, v in out.items()}

    def alerts(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Multi-window burn-rate alerts (see module docs): a rule fires
        when the burn exceeds its threshold over BOTH the short horizon
        (current window) and the long horizon (the ring)."""
        now = self.clock() if now is None else now
        short = self.burn_rates(self.window_s, now=now)
        long_ = self.burn_rates(None, now=now)
        out: List[Dict[str, Any]] = []
        for budget in ("latency", "availability"):
            for severity, threshold in ALERT_RULES:
                if short[budget] >= threshold and long_[budget] >= threshold:
                    out.append({"severity": severity, "budget": budget,
                                "burn_short": short[budget],
                                "burn_long": long_[budget],
                                "threshold": threshold})
                    break
        return out

    # ---------------------------------------------------------- surfaces
    def summary(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The ``/slo`` payload: objectives, short/long horizon numbers,
        burn rates and any firing alerts."""
        now = self.clock() if now is None else now
        doc: Dict[str, Any] = {
            "objectives": {"p99_ms": self.p99_ms,
                           "availability": self.availability_objective},
            "window_s": self.window_s,
            "horizon_s": self.window_s * self.n_windows,
            "horizons": {},
        }
        for label, horizon in (("short", self.window_s), ("long", None)):
            _, ok, err, over = self._merged(horizon, now)
            doc["horizons"][label] = {
                "requests": ok + err,
                "errors": err,
                "over_objective": over,
                "p50_ms": self.quantile_ms(0.50, horizon, now=now),
                "p99_ms": self.quantile_ms(0.99, horizon, now=now),
                "availability": round(
                    self.availability_observed(horizon, now=now), 6),
                "burn": self.burn_rates(horizon, now=now),
            }
        doc["alerts"] = self.alerts(now=now)
        doc["alerting"] = bool(doc["alerts"])
        doc["shed"] = self._shed
        return doc

    def compact(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The heartbeat-sized summary the monitor renders."""
        now = self.clock() if now is None else now
        burn_s = self.burn_rates(self.window_s, now=now)
        burn_l = self.burn_rates(None, now=now)
        alerts = self.alerts(now=now)
        return {
            "p99_ms": self.quantile_ms(0.99, now=now),
            "objective_p99_ms": self.p99_ms,
            "availability": round(self.availability_observed(now=now), 6),
            "objective_availability": self.availability_objective,
            "burn_short": max(burn_s.values()) if burn_s else 0.0,
            "burn_long": max(burn_l.values()) if burn_l else 0.0,
            "alerting": bool(alerts),
            "alerts": [f"{a['severity']}:{a['budget']}" for a in alerts],
        }

    def emit_gauges(self, now: Optional[float] = None) -> None:
        """Mirror the headline numbers into ``slo.*`` registry gauges
        (no-op when telemetry is disabled) — the metrics.prom surface."""
        from . import registry
        now = self.clock() if now is None else now
        p50 = self.quantile_ms(0.50, now=now)
        p99 = self.quantile_ms(0.99, now=now)
        if p50 is not None:
            registry.gauge("slo.p50_ms").set(p50)
        if p99 is not None:
            registry.gauge("slo.p99_ms").set(p99)
        registry.gauge("slo.availability").set(
            self.availability_observed(now=now))
        burn_s = self.burn_rates(self.window_s, now=now)
        burn_l = self.burn_rates(None, now=now)
        registry.gauge("slo.burn_rate_short").set(max(burn_s.values()))
        registry.gauge("slo.burn_rate_long").set(max(burn_l.values()))
        registry.gauge("slo.alerts_firing").set(len(self.alerts(now=now)))


# hysteresis: consecutive stressed evaluations before brownout engages,
# consecutive healthy ones before it lifts.  Exit is slower than entry
# on purpose — flapping in and out of degraded mode is worse than
# staying degraded one beat too long.
BROWNOUT_ENTER_CHECKS = 2
BROWNOUT_EXIT_CHECKS = 3

NORMAL, BROWNOUT = "normal", "brownout"


class BrownoutGovernor:
    """Hysteresis state machine behind the serving brownout mode.

    The worker evaluates one boolean per heartbeat — *stressed* =
    sustained burn-rate alert OR queue buildup — and feeds it to
    :meth:`check`; the governor debounces it into a ``normal`` <->
    ``brownout`` mode with asymmetric hysteresis (enter after
    ``enter_checks`` consecutive stressed beats, exit after
    ``exit_checks`` consecutive healthy ones).  The POLICY of what
    brownout suspends lives in the server (shrink the flush deadline,
    stop trace/score-log sampling and ladder refinement); this class
    only decides WHEN."""

    def __init__(self, enter_checks: int = BROWNOUT_ENTER_CHECKS,
                 exit_checks: int = BROWNOUT_EXIT_CHECKS):
        self.enter_checks = max(1, int(enter_checks))
        self.exit_checks = max(1, int(exit_checks))
        self.mode = NORMAL
        self.entries = 0                 # lifetime brownout entries
        self._stressed_run = 0
        self._healthy_run = 0

    def check(self, stressed: bool) -> bool:
        """Fold one evaluation in; True when the MODE just changed."""
        if stressed:
            self._stressed_run += 1
            self._healthy_run = 0
        else:
            self._healthy_run += 1
            self._stressed_run = 0
        if self.mode == NORMAL \
                and self._stressed_run >= self.enter_checks:
            self.mode = BROWNOUT
            self.entries += 1
            return True
        if self.mode == BROWNOUT \
                and self._healthy_run >= self.exit_checks:
            self.mode = NORMAL
            return True
        return False
