"""The elastic step protocol of the port (``shifu_tpu_torch.parallel.
elastic``) against the reference's (``shifu_tpu.parallel.elastic``):
``tests/test_elastic.py``'s scenarios (quorum math, quorum and timeout
closes, the live set shrinking, payloads, the exclusive close, two
controllers adopting one aggregate, late contributions within and beyond
the staleness window, membership epochs, the masked straggler), each run
by both packages on the same fake clock in boards of their own: the
verdicts, aggregates, counters and record names must be equal.  A close
record written by either package reads in the other; the port's
single-controller elastic streamed NN equals its plain streamed NN bit
for bit and the reference's single-controller run within rtol 1e-4.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from shifu_tpu import faults as j_faults
from shifu_tpu.config import environment as j_environment
from shifu_tpu_torch import faults
from shifu_tpu_torch.config import environment

pytestmark = pytest.mark.torch_port

PACKAGES = ("ref", "port")


@pytest.fixture(autouse=True)
def _clean_env():
    for m in (environment, j_environment, faults, j_faults):
        m.reset_for_tests()
    yield
    for m in (environment, j_environment, faults, j_faults):
        m.reset_for_tests()


def _el(pkg):
    if pkg == "ref":
        from shifu_tpu.parallel import elastic
    else:
        from shifu_tpu_torch.parallel import elastic
    return elastic


def _ctx(el, root, proc, cfg, clock=None):
    """An in-process controller: no heartbeat thread; the clock a
    one-element list that ``sleep`` advances."""
    kw = {}
    if clock is not None:
        kw = {"now_fn": lambda: clock[0],
              "sleep_fn": lambda s: clock.__setitem__(0, clock[0] + s)}
    return el.ElasticContext(str(root), proc, cfg=cfg, heartbeat=False,
                             **kw)


def _pay(v, n=3):
    return {"g": np.full(n, float(v), np.float32)}


def _view(res):
    """What a StepResult decides, comparable across packages."""
    return {"step": res.step, "g": res.payload["g"].tolist(),
            "contributors": res.contributors,
            "stragglers": res.stragglers, "reason": res.reason,
            "by": res.closed_by, "late": sorted(res.late_applied)}


def _counts(ctx):
    return {k: getattr(ctx, k) for k in (
        "steps_closed", "step_timeouts", "late_applied", "late_dropped",
        "catchup_steps", "incarnation", "rejoined")}


def _records(root):
    """The board's record names and each close's decision fields."""
    d = os.path.join(str(root), "telemetry", "steps")
    out = {"names": sorted(os.listdir(d))}
    for name in out["names"]:
        if name.startswith("close-"):
            with open(os.path.join(d, name)) as f:
                doc = json.load(f)
            out[name] = {k: doc.get(k) for k in (
                "step", "reason", "contributors", "stragglers", "needed",
                "live", "epoch", "by", "late", "late_dropped")}
    return out


# ------------------------------------------------------------ scenarios
def sc_quorum_math(el, root):
    got = [el.quorum_needed(n, f) for n, f in ((1000, 0.97), (2, 0.97),
                                               (1, 0.97), (0, 0.97),
                                               (3, 0.5))]
    assert got == [970, 2, 1, 1, 2]
    return got


def sc_closes_on_quorum(el, root):
    cfg = el.ElasticConfig(quorum_frac=0.6, step_timeout_ms=2000)
    qs = el.QuorumStep(step=0, cfg=cfg, live={"a", "b", "c"},
                       opened_at=100.0)
    out = [qs.needed, qs.decide(100.0)]
    qs.offer("a")
    out.append(qs.decide(100.1))
    qs.offer("b")
    out += [qs.decide(100.2), qs.stragglers()]
    assert out == [2, None, None, el.CLOSE_QUORUM, ["c"]]
    return out


def sc_closes_on_timeout(el, root):
    cfg = el.ElasticConfig(quorum_frac=1.0, step_timeout_ms=2000)
    qs = el.QuorumStep(step=0, cfg=cfg, live={"a", "b"}, opened_at=100.0)
    qs.offer("a")
    out = [qs.decide(101.9), qs.decide(102.1), qs.stragglers()]
    qs2 = el.QuorumStep(step=1, cfg=cfg, live={"a"}, opened_at=100.0)
    out.append(qs2.decide(200.0))      # a timeout needs one contribution
    assert out == [None, el.CLOSE_TIMEOUT, ["b"], None]
    return out


def sc_live_set_shrinks(el, root):
    cfg = el.ElasticConfig(quorum_frac=0.97, step_timeout_ms=60000)
    qs = el.QuorumStep(step=0, cfg=cfg, live={"a", "b"}, opened_at=0.0)
    qs.offer("a")
    out = [qs.decide(1.0)]
    qs.update_live({"a"})                       # b declared dead
    out.append(qs.decide(1.0))
    assert out == [None, el.CLOSE_QUORUM]
    return out


def sc_payload_and_board(el, root):
    board = el.StepBoard(os.path.join(str(root), "telemetry", "steps"))
    board.ensure()
    pay = {"g": np.arange(5, dtype=np.float32),
           "stats": np.ones((2, 4), np.float32)}
    rt = el.decode_payload(el.encode_payload(pay))
    assert all(np.array_equal(rt[k], pay[k]) and rt[k].dtype == pay[k].dtype
               for k in pay)
    board.contribute(3, "ctrl-0", pay, epoch=1)
    got = board.contributions(3)
    dec = el.decode_payload(got["ctrl-0"]["payload"])
    out = [sorted(got), dec["g"].tolist(), dec["stats"].tolist(),
           board.has_contribution(3, "ctrl-0"),
           board.has_contribution(3, "ctrl-1"), board.last_closed_step()]
    assert out[0] == ["ctrl-0"] and out[3:] == [True, False, -1]
    return out


def sc_exclusive_close(el, root):
    b1 = el.StepBoard(os.path.join(str(root), "telemetry", "steps"))
    b2 = el.StepBoard(os.path.join(str(root), "telemetry", "steps"))
    b1.ensure()
    won = [b1.try_close(0, {"step": 0, "by": "ctrl-0",
                            "payload": el.encode_payload(_pay(1))}),
           b2.try_close(0, {"step": 0, "by": "ctrl-1",
                            "payload": el.encode_payload(_pay(2))})]
    out = [won, b2.close_doc(0)["by"], b1.last_closed_step()]
    assert out == [[True, False], "ctrl-0", 0]
    return out


def sc_two_controllers(el, root):
    cfg = el.ElasticConfig(quorum_frac=1.0, step_timeout_ms=60000)
    a = _ctx(el, root, "ctrl-0", cfg).start()
    b = _ctx(el, root, "ctrl-1", cfg).start()
    b.board.contribute(0, "ctrl-1", _pay(2), epoch=1)
    ra, rb = a.step(0, _pay(1)), b.step(0, _pay(2))
    assert ra.reason == el.CLOSE_QUORUM and ra.payload["g"].tolist() == \
        [3.0] * 3 and rb.payload["g"].tolist() == ra.payload["g"].tolist()
    assert rb.closed_by == "ctrl-0"
    return [_view(ra), _view(rb), _counts(a), _counts(b)]


def sc_timeout_with_fake_clock(el, root):
    cfg = el.ElasticConfig(quorum_frac=1.0, step_timeout_ms=2000)
    clock = [1000.0]
    a = _ctx(el, root, "ctrl-0", cfg, clock).start()
    a.board.announce("ctrl-1")                  # a peer that never shows
    res = a.step(0, _pay(1))
    assert res.reason == el.CLOSE_TIMEOUT and res.stragglers == ["ctrl-1"]
    assert clock[0] >= 1002.0                   # the deadline was honoured
    return [_view(res), _counts(a), round(clock[0], 6)]


def sc_late_within_staleness(el, root):
    cfg = el.ElasticConfig(quorum_frac=1.0, step_timeout_ms=2000,
                           staleness=2)
    clock = [0.0]
    a = _ctx(el, root, "ctrl-0", cfg, clock).start()
    a.board.announce("ctrl-1")
    r0 = a.step(0, _pay(1))
    a.board.contribute(0, "ctrl-1", _pay(10), late=True)
    r1 = a.step(1, _pay(2))
    assert (0, "ctrl-1") in r1.late_applied
    assert r1.payload["g"].tolist() == [12.0] * 3
    return [_view(r0), _view(r1), _counts(a)]


def sc_late_beyond_staleness(el, root):
    cfg = el.ElasticConfig(quorum_frac=1.0, step_timeout_ms=2000,
                           staleness=1)
    clock = [0.0]
    a = _ctx(el, root, "ctrl-0", cfg, clock).start()
    a.board.announce("ctrl-1")
    views = [_view(a.step(0, _pay(1))), _view(a.step(1, _pay(2)))]
    a.board.contribute(0, "ctrl-1", _pay(10), late=True)
    r2 = a.step(2, _pay(3))
    assert r2.late_applied == [] and r2.payload["g"].tolist() == [3.0] * 3
    assert a.late_dropped == 1
    return views + [_view(r2), _counts(a)]


def sc_quorum_mode_drops_late(el, root):
    cfg = el.ElasticConfig(quorum_frac=1.0, step_timeout_ms=2000,
                           staleness=0)
    clock = [0.0]
    a = _ctx(el, root, "ctrl-0", cfg, clock).start()
    a.board.announce("ctrl-1")
    r0 = a.step(0, _pay(1))
    a.board.contribute(0, "ctrl-1", _pay(10), late=True)
    r1 = a.step(1, _pay(2))
    assert r1.late_applied == [] and r1.payload["g"].tolist() == [2.0] * 3
    assert a.late_dropped == 1
    return [_view(r0), _view(r1), _counts(a)]


def _beat(hd, proc, age):
    os.makedirs(hd, exist_ok=True)
    now = time.time()
    with open(os.path.join(hd, f"{proc}.json"), "w") as f:
        json.dump({"proc": proc, "state": "running", "ts": now - age,
                   "last_progress_ts": now - age, "interval_s": 0.5}, f)


def sc_membership_epochs(el, root):
    cfg = el.ElasticConfig()
    a = _ctx(el, root, "ctrl-0", cfg).start()
    _ctx(el, root, "ctrl-1", cfg).start()
    e0, m0 = a.board.current_epoch()
    hd = os.path.join(str(root), "telemetry", "health")
    _beat(hd, "ctrl-1", 60)                     # leave: a stale heartbeat
    a._refresh_live(reason="test-leave")
    e1, m1 = a.board.current_epoch()
    _beat(hd, "ctrl-1", 0)                      # rejoin: fresh, incarnation 2
    b2 = _ctx(el, root, "ctrl-1", cfg).start()
    e2, m2 = a.board.current_epoch()
    assert set(m0) == {"ctrl-0", "ctrl-1"} and e1 == e0 + 1
    assert set(m1) == {"ctrl-0"} and b2.rejoined and b2.incarnation == 2
    assert e2 >= e1 + 1 and m2.get("ctrl-1") == 2
    return [(e0, m0), (e1, m1), (e2, m2), _counts(b2)]


def sc_masked_straggler(el, root):
    cfg = el.ElasticConfig(quorum_frac=0.4, step_timeout_ms=60000)
    a = _ctx(el, root, "ctrl-0", cfg).start()
    front = [a.step(s, _pay(s + 1)) for s in range(3)]
    b = _ctx(el, root, "ctrl-1", cfg).start()
    got = [b.step(s, _pay(100)) for s in range(3)]
    assert all(g.payload["g"].tolist() == f.payload["g"].tolist()
               for g, f in zip(got, front))
    assert b.steps_closed == 0 and b.closed_step(1) is not None \
        and b.closed_step(99) is None
    return [[_view(r) for r in front], [_view(r) for r in got],
            _counts(a), _counts(b)]


SCENARIOS = {name[3:]: fn for name, fn in list(globals().items())
             if name.startswith("sc_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_protocol_scenarios_agree_with_the_reference(tmp_path, name):
    """Each scenario's verdicts, aggregates, counters and board records,
    the same in both packages (each scenario also asserts the reference
    test's expectations on both)."""
    out = {}
    for pkg in PACKAGES:
        root = tmp_path / pkg
        root.mkdir()
        out[pkg] = SCENARIOS[name](_el(pkg), root)
        steps = root / "telemetry" / "steps"
        if steps.is_dir():
            out[pkg] = (out[pkg], _records(root))
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("writer,reader", [("ref", "port"),
                                           ("port", "ref")])
def test_a_close_record_crosses_packages(tmp_path, writer, reader):
    """A board closed by one package: the other's controller adopts the
    aggregate (a straggler's step), replays it from the journal as a
    rejoiner and reads its membership, its payload bits intact."""
    cfg_w = _el(writer).ElasticConfig(quorum_frac=1.0,
                                      step_timeout_ms=60000)
    a = _ctx(_el(writer), tmp_path, "ctrl-0", cfg_w).start()
    grads = np.random.default_rng(0).normal(size=17).astype(np.float32)
    first = a.step(0, {"grads": grads, "stats": np.ones((2, 4),
                                                        np.float32)})
    el = _el(reader)
    b = _ctx(el, tmp_path, "ctrl-0", el.ElasticConfig(
        quorum_frac=1.0, step_timeout_ms=60000)).start()
    assert b.rejoined and b.incarnation == 2
    replay = b.closed_step(0)
    adopt = b.step(0, {"grads": np.zeros(17, np.float32),
                       "stats": np.zeros((2, 4), np.float32)})
    for res in (replay, adopt):
        assert res.payload["grads"].tobytes() == grads.tobytes()
        assert res.payload["stats"].tolist() == \
            first.payload["stats"].tolist()
        assert res.contributors == ["ctrl-0"] and res.closed_by == "ctrl-0"
    assert b.board.last_closed_step() == 0
    assert set(b.board.current_epoch()[1]) == {"ctrl-0"}


def test_grad_codec_round_trip_restores_dtypes():
    """One f32 vector in the reference's leaf order (dict keys sorted);
    unravel narrows each leaf back to the template's dtype."""
    from shifu_tpu_torch.parallel.elastic import grad_codec
    tree = [{"w": torch.arange(6, dtype=torch.float32).reshape(2, 3) / 7,
             "b": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)},
            {"w": torch.ones((3, 1)), "b": torch.zeros(1)}]
    ravel, unravel = grad_codec(tree)
    flat = ravel(tree)
    assert flat.dtype == np.float32 and flat.shape == (2 + 6 + 1 + 3,)
    assert flat[:2].tolist() == [1.5, -2.25]     # "b" before "w"
    back = unravel(flat)
    for a, b in zip((tree[0]["w"], tree[0]["b"], tree[1]["w"]),
                    (back[0]["w"], back[0]["b"], back[1]["w"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_a_starting_controller_keeps_a_peers_temp_file(tmp_path):
    """Controllers start together on one board: one's start-up sweep must
    not remove the temp file another has written and not yet renamed
    (its record's write would fail); a crash's dropping goes once old."""
    from shifu_tpu_torch.ioutil import ORPHAN_MIN_AGE_S
    from shifu_tpu_torch.parallel.elastic import StepBoard
    board = StepBoard(str(tmp_path / "steps"))
    board.ensure()
    live = tmp_path / "steps" / "member-ctrl-1.json.tmp4242"
    live.write_text("{}")
    board.ensure()
    assert live.exists()
    old = time.time() - ORPHAN_MIN_AGE_S - 1
    os.utime(live, (old, old))
    board.ensure()
    assert not live.exists()


# --------------------------------------------- the streamed trainer's hook
def _norm_plane(d, n=256, dim=6):
    from shifu_tpu_torch import ioutil
    rng = np.random.default_rng(3)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    y = (rng.random(n) < 0.4).astype(np.float32)
    os.makedirs(d)
    ioutil.atomic_savez(os.path.join(d, "part-00000.npz"), x=x, y=y,
                        w=np.ones(n, np.float32))
    ioutil.atomic_write_json(os.path.join(d, "schema.json"), {
        "outputNames": [f"c{i}" for i in range(dim)],
        "columnNums": list(range(dim)), "numShards": 1, "numRows": n})
    return d


def _port_streamed(d, elastic, init=None):
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.data.streaming import (ShardStream,
                                                mask_fn_from_settings)
    from shifu_tpu_torch.models.nn import NNModelSpec
    from shifu_tpu_torch.train.nn_trainer import (TrainSettings,
                                                  train_ensemble_streamed)
    return train_ensemble_streamed(
        ShardStream(Shards.open(d), ("x", "y", "w"), 128),
        NNModelSpec(input_dim=6, hidden_nodes=[4], activations=["tanh"],
                    loss="log"),
        TrainSettings(optimizer="ADAM", learning_rate=0.05, epochs=3,
                      batch_size=0, seed=5), 1,
        mask_fn_from_settings(1, valid_rate=0.25, seed=5),
        init_params_list=init, device="cpu", elastic=elastic)


def test_single_controller_elastic_nn_is_the_plain_run(tmp_path):
    """``tests/test_elastic.py:261``: a one-controller elastic run (a
    quorum of itself; f32 transport round-trips exactly) trains the plain
    streamed run's params bit for bit, closing epochs 0-2 and the final
    eval on the board; its valid errors are the reference's
    single-controller run's from the same initial weights within 1e-4."""
    import jax
    import jax.numpy as jnp
    from shifu_tpu.data.shards import Shards as RShards
    from shifu_tpu.data.streaming import (ShardStream as RStream,
                                          mask_fn_from_settings as rmask)
    from shifu_tpu.models.nn import NNModelSpec as RSpec
    from shifu_tpu.parallel.mesh import device_mesh
    from shifu_tpu.train.nn_trainer import (TrainSettings as RSettings,
                                            train_ensemble_streamed as rtrain)
    from shifu_tpu_torch.models import nn as nn_model
    from shifu_tpu_torch.ops import prng
    d = _norm_plane(str(tmp_path / "data"))
    port_el = _el("port")
    plain = _port_streamed(d, None)
    ctx = _ctx(port_el, tmp_path / "job", "ctrl-0", port_el.ElasticConfig(
        quorum_frac=1.0, step_timeout_ms=60000)).start()
    elas = _port_streamed(d, ctx)
    for pl, el_ in zip(plain.params[0], elas.params[0]):
        for k in ("w", "b"):
            assert torch.equal(pl[k], el_[k])
    assert plain.history == elas.history
    assert ctx.board.last_closed_step() == 3
    spec = nn_model.NNModelSpec(input_dim=6, hidden_nodes=[4],
                                activations=["tanh"], loss="log")
    init = [nn_model.init_params(prng.split(prng.prng_key(5), 1)[0], spec)]
    ref_el = _el("ref")
    rctx = _ctx(ref_el, tmp_path / "rjob", "ctrl-0", ref_el.ElasticConfig(
        quorum_frac=1.0, step_timeout_ms=60000)).start()
    with jax.enable_x64(False):
        ref = rtrain(RStream(RShards.open(d), ("x", "y", "w"), 128),
                     RSpec(input_dim=6, hidden_nodes=[4],
                           activations=["tanh"], loss="log"),
                     RSettings(optimizer="ADAM", learning_rate=0.05,
                               epochs=3, batch_size=0, seed=5), 1,
                     rmask(1, valid_rate=0.25, seed=5),
                     init_params_list=[[{k: jnp.asarray(v.numpy())
                                         for k, v in layer.items()}
                                        for layer in p] for p in init],
                     mesh=device_mesh(1, devices=jax.devices("cpu")[:1]),
                     elastic=rctx)
    np.testing.assert_allclose(elas.valid_errors, ref.valid_errors,
                               rtol=1e-4)
    np.testing.assert_allclose(elas.history, ref.history, rtol=1e-4)
    assert rctx.board.last_closed_step() == 3


def test_elastic_needs_full_batch(tmp_path):
    from shifu_tpu_torch.models.nn import NNModelSpec
    from shifu_tpu_torch.train.nn_trainer import (TrainSettings,
                                                  train_ensemble_streamed)
    el = _el("port")
    with pytest.raises(ValueError, match="full-batch"):
        train_ensemble_streamed(
            None, NNModelSpec(input_dim=2, hidden_nodes=[2],
                              activations=["tanh"]),
            TrainSettings(batch_size=32), 1, None,
            elastic=_ctx(el, tmp_path, "ctrl-0", el.ElasticConfig()))


def test_an_elastic_controller_joins_no_world(monkeypatch, tmp_path):
    """``SHIFU_PROCESS_ID`` without ``SHIFU_COORDINATOR``: the CLI's
    ``initialize_distributed`` stays a no-op (reference ``cli.py:309``),
    the mesh is one rank, and the elastic context takes the id."""
    from shifu_tpu_torch.parallel.elastic import elastic_context_for
    from shifu_tpu_torch.parallel.mesh import (device_mesh,
                                               initialize_distributed)
    monkeypatch.delenv("SHIFU_COORDINATOR", raising=False)
    monkeypatch.setenv("SHIFU_PROCESS_ID", "3")
    assert initialize_distributed() is None
    assert device_mesh().size == 1
    assert elastic_context_for(str(tmp_path)) is None       # switch off
    environment.set_property("shifu.dcn.elastic", "true")
    ctx = elastic_context_for(str(tmp_path))
    assert ctx is not None and ctx.proc == "ctrl-3"
