"""The elastic multi-controller step protocol — the port's copy of
``shifu_tpu.parallel.elastic`` (the reference's Guagua master/worker BSP
close: an iteration ends when 97% of the workers reported or 2 s passed,
``GuaguaConstants``' quorum wiring).

A ``torch.distributed`` collective is synchronous: one dead rank hangs
every peer inside it.  This protocol is the opt-in escape
(``-Dshifu.dcn.elastic``): each controller is a world of one, and the
cross-controller combine rides a shared directory instead of a
collective, so the survivors close a step without a dead controller.

Each step, a controller commits a CONTRIBUTION record (its host-side
partial sums and the step id, written atomically) under
``<modelset>/telemetry/steps/``.  The step CLOSES when
``-Dshifu.dcn.quorumFrac`` (0.97) of the live members contributed or
``-Dshifu.dcn.stepTimeoutMs`` (2000) passed; the first controller to see
the close condition publishes the close record EXCLUSIVELY (``os.link``,
first writer wins), and every controller — the loser of the race and a
straggler too — goes on with the SAME aggregate, summed in sorted
controller order so its bits agree everywhere.  A contribution that
lands after its step closed is dropped (quorum mode,
``-Dshifu.dcn.staleness=0``) or folded into a later step within
``staleness`` steps.

Liveness is the heartbeat staleness rule of :mod:`..obs.health`: a
controller whose heartbeat went stale or exited leaves the live set, the
quorum's denominator shrinks, and a membership EPOCH record is published
(exclusively too).  A dead controller REJOINS without a job restart: the
close records are a journal, so a restarted controller replays the
committed step prefix (:meth:`ElasticContext.closed_step`), applying the
recorded aggregates without streaming its data (``dcn.catchup_steps``).

The records (the reference's layout and base64 npz payloads, so a board
written by either package reads in the other)::

    telemetry/steps/member-<proc>.json   join record (incarnation, pid)
    telemetry/steps/epoch-<n>.json       membership epoch chain
    telemetry/steps/c-<step>-<proc>.json contribution (payload inline)
    telemetry/steps/close-<step>.json    close record and its aggregate

Fault sites: ``dcn:step=<s>`` fires at step s's boundary, before the
contribution commit (a kill there is the worker-loss drill), and
``train:rejoin=<s>`` when a rejoined controller replays its first
committed step s.
"""

from __future__ import annotations

import base64
import io
import json
import logging
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .. import faults
from ..ioutil import atomic_write_json, sweep_orphan_tmp

log = logging.getLogger(__name__)

STEPS_DIRNAME = "steps"

# close verdicts
CLOSE_QUORUM = "quorum"      # quorumFrac of the live members contributed
CLOSE_TIMEOUT = "timeout"    # stepTimeoutMs passed with a partial set


def elastic_enabled() -> bool:
    """The ``-Dshifu.dcn.elastic`` switch (off: the synchronous mesh)."""
    from ..config import environment
    return environment.get_bool("shifu.dcn.elastic", False)


def steps_dir_for(model_set_dir: str) -> str:
    return os.path.join(os.path.abspath(model_set_dir), "telemetry",
                        STEPS_DIRNAME)


@dataclass
class ElasticConfig:
    """The protocol's knobs (see the module docstring)."""
    quorum_frac: float = 0.97
    step_timeout_ms: float = 2000.0
    staleness: int = 0           # 0 = quorum mode (drop late); >0 = bounded
    poll_interval_s: float = 0.02

    @classmethod
    def from_env(cls) -> "ElasticConfig":
        from ..config import environment
        return cls(
            quorum_frac=environment.get_float("shifu.dcn.quorumFrac", 0.97),
            step_timeout_ms=environment.get_float("shifu.dcn.stepTimeoutMs",
                                                  2000.0),
            staleness=environment.get_int("shifu.dcn.staleness", 0))


def quorum_needed(n_live: int, frac: float) -> int:
    """Contributors needed to close over ``n_live`` members, at least 1
    (a lone survivor makes progress)."""
    return max(1, math.ceil(frac * n_live - 1e-9))


# ---------------------------------------------------------------- payloads
def encode_payload(payload: Dict[str, np.ndarray]) -> str:
    """Arrays as base64(npz), inline in their record, so a record commits
    in one atomic file."""
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in payload.items()})
    return base64.b64encode(buf.getvalue()).decode("ascii")


def decode_payload(data: str) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(base64.b64decode(data))) as z:
        return {k: z[k] for k in z.files}


def sum_payloads(payloads: Sequence[Dict[str, np.ndarray]]
                 ) -> Dict[str, np.ndarray]:
    """Element-wise sum; callers pass the contributions in sorted
    controller order, so every controller adds in the same order."""
    out: Dict[str, np.ndarray] = {}
    for p in payloads:
        for k, v in p.items():
            out[k] = v if k not in out else out[k] + v
    return out


# ---------------------------------------------------- the close decision
@dataclass
class QuorumStep:
    """One step's close decision in one controller's view: plain state
    with the clock passed in, so the quorum rules test without processes,
    files or sleeps."""
    step: int
    cfg: ElasticConfig
    live: Set[str]
    opened_at: float
    contributed: Set[str] = field(default_factory=set)

    @property
    def deadline(self) -> float:
        return self.opened_at + self.cfg.step_timeout_ms / 1000.0

    @property
    def needed(self) -> int:
        return quorum_needed(len(self.live), self.cfg.quorum_frac)

    def offer(self, proc: str) -> None:
        self.contributed.add(proc)

    def update_live(self, live: Set[str]) -> None:
        self.live = set(live)

    def stragglers(self) -> List[str]:
        return sorted(self.live - self.contributed)

    def decide(self, now: float) -> Optional[str]:
        """None (keep waiting), CLOSE_QUORUM or CLOSE_TIMEOUT.  A timeout
        close needs one contribution at least: an empty aggregate is not a
        step."""
        if len(self.contributed & self.live) >= self.needed:
            return CLOSE_QUORUM
        if now >= self.deadline and self.contributed:
            return CLOSE_TIMEOUT
        return None


@dataclass
class StepResult:
    """What a closed step hands the trainer."""
    step: int
    payload: Dict[str, np.ndarray]
    contributors: List[str]
    stragglers: List[str]
    reason: str
    epoch: int
    closed_by: str
    late_applied: List[Tuple[int, str]] = field(default_factory=list)

    @classmethod
    def from_doc(cls, doc: Dict[str, Any]) -> "StepResult":
        return cls(step=int(doc["step"]),
                   payload=decode_payload(doc["payload"]),
                   contributors=list(doc.get("contributors") or []),
                   stragglers=list(doc.get("stragglers") or []),
                   reason=str(doc.get("reason") or CLOSE_QUORUM),
                   epoch=int(doc.get("epoch") or 0),
                   closed_by=str(doc.get("by") or "?"),
                   late_applied=[(int(s), p) for s, p in
                                 (doc.get("late") or [])])


# ------------------------------------------------------------ the board
class StepBoard:
    """The shared directory: contribution, close and membership records
    under ``telemetry/steps/``.  Every write is atomic; close and epoch
    records are exclusive (``os.link``: the loser reads the winner's
    record, so one close exists a step)."""

    def __init__(self, steps_dir: str, health_dir: Optional[str] = None):
        self.steps_dir = steps_dir
        # liveness reads the heartbeat records beside the board
        self.health_dir = health_dir or os.path.join(
            os.path.dirname(os.path.abspath(steps_dir)), "health")

    def ensure(self) -> None:
        os.makedirs(self.steps_dir, exist_ok=True)
        sweep_orphan_tmp(self.steps_dir)

    def _path(self, name: str) -> str:
        return os.path.join(self.steps_dir, name)

    def _read_json(self, name: str) -> Optional[Dict[str, Any]]:
        try:
            with open(self._path(name)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _names(self) -> List[str]:
        try:
            return os.listdir(self.steps_dir)
        except OSError:
            return []

    def _exclusive_publish(self, name: str, doc: Dict[str, Any]) -> bool:
        """First writer wins: write a temp file and ``os.link`` it to the
        name (which fails if the name exists; ``os.replace`` would
        overwrite).  True when this writer won."""
        path = self._path(name)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        try:
            os.link(tmp, path)
            return True
        except FileExistsError:
            return False
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass

    # ------------------------------------------------------ contributions
    def contribute(self, step: int, proc: str,
                   payload: Dict[str, np.ndarray],
                   epoch: int = 0, late: bool = False) -> None:
        atomic_write_json(self._path(f"c-{step:06d}-{proc}.json"), {
            "kind": "dcn_contribution", "step": step, "proc": proc,
            "epoch": epoch, "late": late, "ts": round(time.time(), 3),
            "payload": encode_payload(payload)}, indent=0)

    def has_contribution(self, step: int, proc: str) -> bool:
        return os.path.isfile(self._path(f"c-{step:06d}-{proc}.json"))

    def contributions(self, step: int) -> Dict[str, Dict[str, Any]]:
        """proc -> its committed contribution record for ``step`` (the
        payload still encoded)."""
        out: Dict[str, Dict[str, Any]] = {}
        prefix = f"c-{step:06d}-"
        for name in self._names():
            if name.startswith(prefix) and name.endswith(".json"):
                doc = self._read_json(name)
                if doc is not None:
                    out[name[len(prefix):-5]] = doc
        return out

    # ------------------------------------------------------------- closes
    def close_doc(self, step: int) -> Optional[Dict[str, Any]]:
        return self._read_json(f"close-{step:06d}.json")

    def try_close(self, step: int, doc: Dict[str, Any]) -> bool:
        return self._exclusive_publish(f"close-{step:06d}.json", doc)

    def last_closed_step(self) -> int:
        """The highest closed step, -1 when none."""
        last = -1
        for name in self._names():
            if name.startswith("close-") and name.endswith(".json"):
                try:
                    last = max(last, int(name[6:-5]))
                except ValueError:
                    pass
        return last

    # --------------------------------------------------------- membership
    def announce(self, proc: str, step_name: Optional[str] = None) -> int:
        """Commit this controller's join record; returns its incarnation
        (1 on the first join, one more a restart)."""
        prev = self._read_json(f"member-{proc}.json")
        inc = int(prev.get("incarnation", 0)) + 1 if prev else 1
        atomic_write_json(self._path(f"member-{proc}.json"), {
            "kind": "dcn_member", "proc": proc, "pid": os.getpid(),
            "incarnation": inc, "step_name": step_name,
            "ts": round(time.time(), 3)})
        return inc

    def members(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for name in self._names():
            if name.startswith("member-") and name.endswith(".json"):
                doc = self._read_json(name)
                if doc is not None:
                    out[name[7:-5]] = doc
        return out

    def live_members(self, now: Optional[float] = None) -> Dict[str, int]:
        """proc -> incarnation of every member the heartbeat staleness
        rule holds alive.  A stale or exited heartbeat is dead; a member
        with no heartbeat yet is alive (its first beat may be in
        flight)."""
        from ..obs.health import classify, read_health
        now = time.time() if now is None else now
        health = {r.get("proc"): r for r in read_health(self.health_dir)}
        out: Dict[str, int] = {}
        for proc, doc in self.members().items():
            rec = health.get(proc)
            if rec is not None and classify(rec, now=now) in ("stale",
                                                             "exited"):
                continue
            out[proc] = int(doc.get("incarnation", 1))
        return out

    def current_epoch(self) -> Tuple[int, Dict[str, int]]:
        """(number, member -> incarnation) of the newest epoch record,
        (0, {}) before the first."""
        best, members = 0, {}
        for name in self._names():
            if name.startswith("epoch-") and name.endswith(".json"):
                try:
                    n = int(name[6:-5])
                except ValueError:
                    continue
                if n > best:
                    doc = self._read_json(name) or {}
                    best, members = n, dict(doc.get("members") or {})
        return best, members

    def maybe_bump_epoch(self, live: Dict[str, int], by: str,
                         reason: str = "membership") -> int:
        """Publish epoch N+1 when the live member -> incarnation map
        changed (a join, a leave or a rejoin: a restart bumps though the
        names are the same); returns the current epoch either way."""
        n, members = self.current_epoch()
        if members == live:
            return n
        if self._exclusive_publish(f"epoch-{n + 1:06d}.json", {
                "kind": "dcn_epoch", "epoch": n + 1, "members": live,
                "previous": members, "by": by, "reason": reason,
                "ts": round(time.time(), 3)}):
            log.info("membership epoch %d: %s (%s)", n + 1, sorted(live),
                     reason)
            return n + 1
        return self.current_epoch()[0]


# --------------------------------------------------------------- context
class ElasticContext:
    """One controller's handle on the job: join, heartbeat, and
    :meth:`step` once a training step.  The clock and the sleep are
    parameters, so the quorum and timeout rules test without wall
    time."""

    def __init__(self, model_set_dir: str, proc: str,
                 cfg: Optional[ElasticConfig] = None,
                 step_name: str = "TRAIN",
                 heartbeat: bool = True,
                 now_fn: Callable[[], float] = time.time,
                 sleep_fn: Callable[[float], None] = time.sleep):
        from ..obs.health import health_dir_for
        self.model_set_dir = model_set_dir
        self.proc = proc
        self.cfg = cfg or ElasticConfig.from_env()
        self.step_name = step_name
        self.board = StepBoard(steps_dir_for(model_set_dir),
                               health_dir=health_dir_for(model_set_dir))
        self._heartbeat_wanted = heartbeat
        self._hb = None
        self._now = now_fn
        self._sleep = sleep_fn
        self.incarnation = 0
        self.rejoined = False
        self._rejoin_announced = False
        # the protocol's counts as plain attributes too: the obs counters
        # are null instruments with telemetry off
        self.catchup_steps = 0
        self.steps_closed = 0
        self.step_timeouts = 0
        self.late_applied = 0
        self.late_dropped = 0
        self.wait_s = 0.0

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "ElasticContext":
        from .. import obs
        self.board.ensure()
        self.incarnation = self.board.announce(self.proc, self.step_name)
        self.rejoined = self.incarnation > 1
        if self.rejoined:
            obs.counter("dcn.rejoins").inc()
            log.info("controller %s rejoining (incarnation %d): replaying "
                     "the committed steps", self.proc, self.incarnation)
        if self._heartbeat_wanted:
            # the protocol's death detector is the heartbeat, so it beats
            # whatever the telemetry switch says
            from ..obs.health import HeartbeatWriter
            self._hb = HeartbeatWriter(self.board.health_dir,
                                       step=self.step_name,
                                       proc=self.proc).start()
        self._refresh_live(reason="join")
        return self

    def stop(self, exit_code: Optional[int] = 0) -> None:
        if self._hb is not None:
            self._hb.stop(exit_code=exit_code)
            self._hb = None

    def __enter__(self) -> "ElasticContext":
        return self.start()

    def __exit__(self, et, ev, tb) -> None:
        self.stop(exit_code=0 if et is None else 1)

    # ------------------------------------------------------------ internals
    def _refresh_live(self, reason: str = "membership") -> Dict[str, int]:
        from .. import obs
        live = self.board.live_members(now=self._now())
        epoch = self.board.maybe_bump_epoch(live, by=self.proc,
                                            reason=reason)
        obs.gauge("dcn.membership_epoch").set(float(epoch))
        obs.gauge("dcn.live_members").set(float(len(live)))
        return live

    def _scan_from(self, closing_step: int) -> int:
        return max(0, closing_step - 2 * max(self.cfg.staleness, 1) - 2)

    def _late_candidates(self, closing_step: int,
                         applied: Set[Tuple[int, str]]
                         ) -> Tuple[List[Tuple[int, str, Dict[str, Any]]],
                                    List[Tuple[int, str]]]:
        """(apply, dropped): late contributions to closed steps that no
        close folded yet, split into those inside the staleness window
        (folded into this close) and those past it (recorded dropped, so
        no later closer counts them).  Quorum mode drops them all."""
        apply: List[Tuple[int, str, Dict[str, Any]]] = []
        dropped: List[Tuple[int, str]] = []
        for s in range(self._scan_from(closing_step), closing_step):
            close = self.board.close_doc(s)
            if close is None:
                continue
            in_close = set(close.get("contributors") or [])
            for proc, doc in sorted(self.board.contributions(s).items()):
                if proc in in_close or (s, proc) in applied:
                    continue
                if self.cfg.staleness > 0 and \
                        closing_step - s <= self.cfg.staleness:
                    apply.append((s, proc, doc))
                else:
                    dropped.append((s, proc))
        return apply, dropped

    def _applied_late(self, closing_step: int) -> Set[Tuple[int, str]]:
        """Late pairs earlier closes already folded or dropped, read back
        from the close chain: each is applied once across racing
        closers."""
        out: Set[Tuple[int, str]] = set()
        for s in range(self._scan_from(closing_step), closing_step):
            close = self.board.close_doc(s)
            if close is None:
                continue
            for pair in (close.get("late") or []) + \
                    (close.get("late_dropped") or []):
                out.add((int(pair[0]), pair[1]))
        return out

    def _try_close(self, qs: QuorumStep, verdict: str,
                   contribs: Dict[str, Dict[str, Any]]
                   ) -> Optional[StepResult]:
        from .. import obs
        procs = sorted(contribs)
        payloads = [decode_payload(contribs[p]["payload"]) for p in procs]
        late, dropped_pairs = self._late_candidates(
            qs.step, self._applied_late(qs.step))
        late_pairs: List[Tuple[int, str]] = []
        for s, proc, doc in late:
            payloads.append(decode_payload(doc["payload"]))
            late_pairs.append((s, proc))
        epoch, _ = self.board.current_epoch()
        doc = {
            "kind": "dcn_close", "step": qs.step, "reason": verdict,
            "contributors": procs, "stragglers": qs.stragglers(),
            "needed": qs.needed, "live": sorted(qs.live),
            "epoch": epoch, "by": self.proc,
            "late": [[s, p] for s, p in late_pairs],
            "late_dropped": [[s, p] for s, p in dropped_pairs],
            "ts": round(time.time(), 3),
            "payload": encode_payload(sum_payloads(payloads)),
        }
        if not self.board.try_close(qs.step, doc):
            return None                     # lost the race: read the winner
        self.steps_closed += 1
        obs.counter("dcn.steps_closed").inc()
        if verdict == CLOSE_TIMEOUT:
            self.step_timeouts += 1
            obs.counter("dcn.step_timeouts").inc()
            log.warning("dcn step %d closed on timeout with %d/%d "
                        "contributors (stragglers: %s)", qs.step,
                        len(procs), len(qs.live), qs.stragglers())
        if late_pairs:
            self.late_applied += len(late_pairs)
            obs.counter("dcn.late_applied").inc(len(late_pairs))
        if dropped_pairs:
            self.late_dropped += len(dropped_pairs)
            obs.counter("dcn.late_dropped").inc(len(dropped_pairs))
        return StepResult.from_doc(doc)

    # ------------------------------------------------------------ protocol
    def closed_step(self, step: int) -> Optional[StepResult]:
        """The close record of ``step`` if it exists: the journal a
        rejoined controller replays instead of recomputing (its first
        replayed step fires ``train:rejoin``)."""
        doc = self.board.close_doc(step)
        if doc is None:
            return None
        from .. import obs
        if self.rejoined and not self._rejoin_announced:
            self._rejoin_announced = True
            faults.fire("train", "rejoin", step)
            log.info("controller %s replaying committed steps from %d",
                     self.proc, step)
        self.catchup_steps += 1
        obs.counter("dcn.catchup_steps").inc()
        return StepResult.from_doc(doc)

    def step(self, step: int, payload: Dict[str, np.ndarray]
             ) -> StepResult:
        """One quorum-gated step: commit this controller's contribution,
        wait for the quorum, the timeout or another controller's close,
        and return the aggregate every controller applies."""
        from .. import obs
        faults.fire("dcn", "step", step)
        existing = self.board.close_doc(step)
        if existing is not None:
            # behind the front (a masked straggler or a rejoiner): with
            # staleness the work still lands late, in quorum mode it is
            # dropped; either way the committed aggregate is adopted
            if self.cfg.staleness > 0 \
                    and not self.board.has_contribution(step, self.proc):
                self.board.contribute(step, self.proc, payload,
                                      epoch=existing.get("epoch", 0),
                                      late=True)
            return StepResult.from_doc(existing)
        live = self._refresh_live()
        epoch, _ = self.board.current_epoch()
        self.board.contribute(step, self.proc, payload, epoch=epoch)
        t0 = self._now()
        qs = QuorumStep(step=step, cfg=self.cfg,
                        live=set(live) | {self.proc}, opened_at=t0)
        with obs.span("dcn.step", step=step):
            while True:
                doc = self.board.close_doc(step)
                if doc is not None:
                    res = StepResult.from_doc(doc)
                    break
                contribs = self.board.contributions(step)
                for p in contribs:
                    qs.offer(p)
                verdict = qs.decide(self._now())
                if verdict is not None:
                    res = self._try_close(qs, verdict, contribs)
                    if res is not None:
                        break
                    continue                # lost the race: reread
                self._sleep(self.cfg.poll_interval_s)
                # a peer dying mid-step must shrink the denominator, or
                # the step would only ever close on the timeout
                qs.update_live(set(self._refresh_live()) | {self.proc})
        waited = max(0.0, self._now() - t0)
        self.wait_s += waited
        obs.counter("dcn.step_wait_seconds").inc(waited)
        return res


# ---------------------------------------------------------- trainer glue
def grad_codec(zero_grads):
    """(ravel, unravel) for shipping a gradient tree (lists and dicts of
    tensors) over the board as ONE f32 vector, the leaves in the
    reference's ``ravel_pytree`` order (dict keys sorted): transport is
    f32 whatever the training precision; ``unravel`` restores the tree on
    the template's devices and narrows each leaf back to the template's
    dtype."""
    import torch

    from ..train.checkpoint import tree_leaves, tree_unflatten
    template = tree_leaves(zero_grads)
    sizes = [t.numel() for t in template]

    def ravel(tree) -> np.ndarray:
        leaves = tree_leaves(tree)
        if not leaves:
            return np.zeros(0, np.float32)
        return torch.cat([t.detach().reshape(-1).float()
                          for t in leaves]).cpu().numpy()

    def unravel(flat: np.ndarray):
        flat_t = torch.from_numpy(np.ascontiguousarray(flat, np.float32))
        parts = flat_t.split(sizes) if sizes else []
        return tree_unflatten(zero_grads, [
            p.reshape(z.shape).to(device=z.device, dtype=z.dtype)
            for p, z in zip(parts, template)])

    return ravel, unravel


# ----------------------------------------------------------- pipeline glue
def elastic_context_for(model_set_dir: str, step_name: str = "TRAIN"
                        ) -> Optional[ElasticContext]:
    """An :class:`ElasticContext` when ``-Dshifu.dcn.elastic`` is on and
    the run has a stable controller identity (``SHIFU_PROCESS_ID``), None
    otherwise (a single controller stays synchronous)."""
    if not elastic_enabled():
        return None
    pid = os.environ.get("SHIFU_PROCESS_ID")
    if pid is None:
        log.warning("shifu.dcn.elastic is on but SHIFU_PROCESS_ID is "
                    "unset: elastic mode needs a stable controller "
                    "identity to rejoin as; staying synchronous")
        return None
    return ElasticContext(model_set_dir, proc=f"ctrl-{int(pid)}",
                          step_name=step_name)
