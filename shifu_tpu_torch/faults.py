"""Deterministic fault-injection harness — the port's copy of
``shifu_tpu.faults``: hot paths call :func:`fire` at named boundaries and
a spec names which of those points should fail, and how, so recovery
paths are testable at an exact point.

Spec grammar (env ``SHIFU_TPU_FAULTS`` or property ``-Dshifu.faults``)::

    clause[,clause...]
    clause := <site>:<point>=<value>:<action>[@<count>]

    SHIFU_TPU_FAULTS="norm:shard=3:ioerror,train:tree=17:kill"
    SHIFU_TPU_FAULTS="reader:file=0:ioerror@2"    # first 2 hits fail

The spec grammar, the actions and the declared sites are the
reference's, so one spec drives either package, and the port fires every
declared site at the reference's boundary (``dcn:step`` and
``train:rejoin`` in the elastic step protocol, ``parallel/elastic.py``).
The sites:

    norm:shard=<k>      before shard k's commit record lands
    norm:wire=<k>       before shard k's rows append to the direct-to-
                        wire plane (a kill leaves truncatable tail
                        bytes past the last committed wire manifest)
    rawcache:commit=0   raw-cache manifest commit (a kill leaves only
                        tmp files — absent manifest == absent cache)
    stats:chunk=<ci>    before chunk ci is absorbed by the accumulators
    train:tree=<ti>     after tree ti's progress line (GBT/RF)
    train:superbatch=<k>  after disk-tail super-batch drain k lands its
                        trees on host (streamed GBT coarse-to-fine pend
                        drain / streamed RF tail batch commit) — the
                        checkpoint-cadence boundary of the one-pass tail
                        schedule
    train:epoch=<e>     after epoch e's progress line (NN/LR/WDL/SVM)
    train:bag=<b>       before kernel-SVM bag b trains
    reader:file=<i>     opening the i-th raw input file
    shards:shard=<i>    decoding the i-th materialized npz shard
    spill:append=<k>    spill write-through of shard k
    spill:manifest=0    spill manifest commit
    step:phase=<name>   entering a named processor phase span
    obs:heartbeat=<b>   before heartbeat b's atomic commit (obs/health) —
                        a kill here proves a death mid-heartbeat leaves
                        the previous valid health file, never a torn one
    serve:request=<k>   before serving batch k's device launch — an
                        ioerror fails exactly that batch's tickets and
                        must leave the scorer/registry serviceable
    serve:swap=<key>    after a hot-swap candidate is built+warmed,
                        before the journal commit and the live flip — a
                        crash here must leave the PREVIOUS model live,
                        scoring bit-identically
    serve:replica=<name>  in a fleet worker's HTTP /score path, before
                        the request enqueues — a kill here is the
                        replica-death drill: the router must drain the
                        dead backend and requeue un-launched tickets on
                        a peer so every accepted request completes
    serve:admit=<k>     while the k-th shed submit is being rejected at
                        the admission cap — an ioerror there must leave
                        the queue depth and SLO shed accounting
                        consistent; a kill is the die-during-shed drill
    obs:scorelog=<k>    before score-log segment k's atomic rotation
                        commit (the os.replace that drops the .open torn
                        marker) — a kill here leaves a torn final
                        segment readers skip with a surfaced count;
                        committed segments stay intact and the next
                        writer sweeps the orphan and continues
    refresh:trigger=<key>   before a refresh trigger record commits
    refresh:promote=<key>   after the candidate passes the AUC gate,
                        before the hot-swap — the incumbent stays live
                        and the refresh journal resumes at the gate
    refresh:rollback=<key>  before a probation failure re-flips the
                        registry to the previous generation

Actions:

- ``ioerror``   raise :class:`InjectedFault` (an ``OSError``) — exercises
  the transient-IO retry ladder and step-failure paths in-process;
- ``kill``      ``os._exit(137)`` — a SIGKILL-equivalent hard death (no
  atexit, no flushing); subprocess tests resume afterwards;
- ``truncate``  truncate the target file to half its size, then hard-exit
  — manufactures a torn, committed-looking artifact.

Each clause fires ``count`` times (default 1) then disarms, so a retry
ladder can be tested to succeed on attempt 2 (``@1``, the default) or be
driven to exhaustion (``@99``).  Parsing is lazy and cached; with no
spec configured :func:`fire` is a dict-lookup no-op.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

_ACTIONS = ("ioerror", "kill", "truncate")

# Declared fault sites: (site, point) -> one-line description of the
# boundary (the reference's manifest, kept whole so a spec written for
# either package parses the same).
SITES: dict = {
    ("norm", "shard"): "before shard k's commit record lands",
    ("stats", "chunk"): "before chunk ci is absorbed by the accumulators",
    ("train", "tree"): "after tree ti's progress line (GBT/RF)",
    ("train", "superbatch"): "after disk-tail super-batch drain k lands",
    ("train", "epoch"): "after epoch e's progress line (NN/LR/WDL/SVM)",
    ("train", "bag"): "before kernel-SVM bag b trains",
    ("reader", "file"): "opening the i-th raw input file",
    ("shards", "shard"): "decoding the i-th materialized npz shard",
    ("spill", "append"): "spill write-through of shard k",
    ("spill", "manifest"): "spill manifest commit",
    ("step", "phase"): "entering a named processor phase span",
    ("obs", "heartbeat"): "before heartbeat b's atomic commit",
    ("obs", "scorelog"): "before score-log segment k's atomic rotation "
                         "commit — a kill leaves a torn .open final "
                         "segment readers skip; prior segments intact, "
                         "the next writer recovers",
    ("serve", "request"): "before serving batch k's device launch",
    ("serve", "swap"): "after a hot-swap candidate is built+warmed, "
                       "before the journal commit and the live flip",
    ("serve", "replica"): "in a fleet worker's /score path before the "
                          "request enqueues — a kill is the replica-"
                          "death drill (router drains + requeues)",
    ("serve", "admit"): "while shed #k is being rejected at the "
                        "admission cap (queue at maxQueueRows) — an "
                        "ioerror must leave the queue depth and the "
                        "SLO shed accounting consistent; a kill is the "
                        "die-during-shed drill",
    ("dcn", "step"): "at elastic step s's boundary, before this "
                     "controller's contribution commit — a kill here is "
                     "the worker-loss drill the quorum must mask",
    ("train", "rejoin"): "when a rejoined controller starts replaying "
                         "committed step s from the close journal",
    ("refresh", "trigger"): "before a refresh trigger decision record "
                            "commits (the cycle has not started yet)",
    ("refresh", "promote"): "after the candidate passes the AUC gate, "
                            "before the registry hot-swap — a crash "
                            "here must leave the incumbent live and "
                            "bit-identical, and the refresh journal "
                            "must resume the cycle at the gate",
    ("refresh", "rollback"): "before a probation-failure rollback "
                             "re-flips the registry to the previous "
                             "generation",
    ("rawcache", "commit"): "before the raw-cache manifest commit — a "
                            "kill/truncate here must leave only tmp "
                            "files (absent manifest == absent cache) "
                            "the next writer sweeps and rebuilds",
    ("norm", "wire"): "before shard k's rows append to the wire plane "
                      "— a kill here leaves raw-file tail bytes past "
                      "the last committed manifest; the journal resume "
                      "truncates them and re-lands the shard",
}


def is_declared_site(site: str, point: str) -> bool:
    return (site, point) in SITES

_clauses: Optional[Dict[Tuple[str, str, str], List]] = None  # [action, left]


class InjectedFault(OSError):
    """An injected IO failure (distinguishable from real OS errors)."""


def _spec_string() -> str:
    spec = os.environ.get("SHIFU_TPU_FAULTS")
    if spec:
        return spec
    from .config import environment
    return environment.get_property("shifu.faults") or ""


def parse_spec(spec: str) -> Dict[Tuple[str, str, str], List]:
    """``"norm:shard=3:ioerror@2"`` -> {("norm","shard","3"): ["ioerror", 2]}.

    Malformed clauses fail loudly — a typo'd fault spec silently testing
    nothing is worse than no spec."""
    out: Dict[Tuple[str, str, str], List] = {}
    for clause in filter(None, (c.strip() for c in spec.split(","))):
        try:
            site, point_eq, action = clause.split(":")
            point, _, value = point_eq.partition("=")
            count = 1
            if "@" in action:
                action, _, cnt = action.partition("@")
                count = int(cnt)
            if action not in _ACTIONS or not point or not value:
                raise ValueError(action)
        except ValueError:
            raise ValueError(
                f"bad fault clause {clause!r} — expected "
                "<site>:<point>=<value>:<action>[@<count>] with action in "
                f"{_ACTIONS}") from None
        out[(site, point, value)] = [action, count]
    return out


def _armed() -> Dict[Tuple[str, str, str], List]:
    global _clauses
    if _clauses is None:
        _clauses = parse_spec(_spec_string())
    return _clauses


def active() -> bool:
    return bool(_armed())


def fire(site: str, point: str, value, path: Optional[str] = None) -> None:
    """Fault hook: no-op unless an armed clause matches (site, point,
    value).  ``path`` names the artifact a ``truncate`` action mangles."""
    clauses = _armed()
    if not clauses:
        return
    hit = clauses.get((site, point, str(value)))
    if hit is None or hit[1] <= 0:
        return
    hit[1] -= 1
    action = hit[0]
    log.warning("FAULT INJECTED at %s:%s=%s action=%s path=%s",
                site, point, value, action, path)
    if action == "ioerror":
        raise InjectedFault(
            f"injected IO error at {site}:{point}={value}"
            + (f" ({path})" if path else ""))
    if action == "truncate" and path and os.path.isfile(path):
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size // 2)
    # kill (and truncate's tail): a SIGKILL-equivalent hard death — no
    # atexit handlers, no buffered writes, exactly what a preempted VM
    # or OOM-killed container leaves behind
    os.sys.stderr.write(
        f"shifu-tpu-torch: injected hard exit at {site}:{point}={value}\n")
    os.sys.stderr.flush()
    os._exit(137)


def reset_for_tests() -> None:
    """Drop the parsed-spec cache (tests flip the env/property per case)."""
    global _clauses
    _clauses = None
