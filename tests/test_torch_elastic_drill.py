"""The elastic kill drills of ``tests/test_multihost.py:135-201`` on the
port's demo controller (``python -m shifu_tpu_torch.parallel.elastic_demo
--device cpu``, the reference's shape: 1,024 rows x 8 features x 6
epochs, 2 controllers).  Each controller logs to a file of its own (two
unread pipes can hang a drill, ROADMAP C7).

- Sync mode (quorumFrac 1.0, heartbeats every 300 s so the dead
  controller stays in the live set): a SIGKILL-equivalent exit at
  ``dcn:step=3``, a relaunch with the same ``--proc``; both controllers
  end bit-identical to an uninterrupted control run, the rejoiner having
  replayed the committed steps (``catchup_steps >= 3``).
- Quorum mode (0.97, a 2 s timeout, heartbeats every 0.25 s): the
  survivor masks the dead controller and finishes within 0.01 AUC of the
  control; a late relaunch replays the whole journal and lands
  bit-identical to the survivor.

The control run starts once a module.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_SHAPE = ["--rows", "1024", "--features", "8", "--epochs", "6"]
SYNC_MODE = ["--quorum-frac", "1.0", "--timeout-ms", "120000"]
QUORUM_MODE = ["--quorum-frac", "0.97", "--timeout-ms", "2000"]
KILL_STEP = 3


def _launch(out: str, proc: int, mode, heartbeat_s: float,
            faults_spec=None, tag: str = ""):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               SHIFU_TPU_HEARTBEAT_S=str(heartbeat_s))
    env.pop("SHIFU_TPU_FAULTS", None)
    env.pop("SHIFU_COORDINATOR", None)
    if faults_spec:
        env["SHIFU_TPU_FAULTS"] = faults_spec
    os.makedirs(out, exist_ok=True)
    log = open(os.path.join(out, f"log-{proc}{tag}.txt"), "w")
    p = subprocess.Popen(
        [sys.executable, "-m", "shifu_tpu_torch.parallel.elastic_demo",
         "--out", out, "--proc", str(proc), "--nproc", "2", "--device",
         "cpu"] + DEMO_SHAPE + list(mode), env=env, stdout=log,
        stderr=subprocess.STDOUT, cwd=REPO)
    p.log = log
    return p


def _wait(p, what: str, rc_expect: int = 0) -> str:
    try:
        p.wait(timeout=120)
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
        pytest.fail(f"{what} hung")
    finally:
        p.log.close()
    with open(p.log.name) as f:
        text = f.read()
    assert p.returncode == rc_expect, \
        f"{what}: rc={p.returncode} (wanted {rc_expect})\n{text[-3000:]}"
    return text


def _params(out: str, proc: int) -> dict:
    with np.load(os.path.join(out, f"params-{proc}.npz")) as z:
        return {k: z[k] for k in z.files}


def _result(out: str, proc: int) -> dict:
    with open(os.path.join(out, f"result-{proc}.json")) as f:
        return json.load(f)


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].tobytes() == b[k].tobytes() for k in a)


@pytest.fixture(scope="module")
def control(tmp_path_factory):
    """The uninterrupted 2-controller sync run both drills compare with."""
    out = str(tmp_path_factory.mktemp("elastic_control"))
    procs = [_launch(out, p, SYNC_MODE, 300) for p in range(2)]
    for i, p in enumerate(procs):
        _wait(p, f"control controller {i}")
    assert _same(_params(out, 0), _params(out, 1)), \
        "the control controllers diverged"
    return out


def test_sync_kill_and_rejoin_is_bit_identical(tmp_path, control):
    out = str(tmp_path / "job")
    survivor = _launch(out, 0, SYNC_MODE, 300)
    victim = _launch(out, 1, SYNC_MODE, 300,
                     faults_spec=f"dcn:step={KILL_STEP}:kill")
    assert "injected hard exit at dcn:step" in _wait(victim, "victim", 137)
    rejoiner = _launch(out, 1, SYNC_MODE, 300, tag="-rejoin")
    assert "rejoined=1" in _wait(rejoiner, "rejoined controller")
    _wait(survivor, "surviving controller")
    rj = _result(out, 1)
    assert rj["dcn"]["rejoined"] and rj["dcn"]["incarnation"] == 2
    assert rj["dcn"]["catchup_steps"] >= KILL_STEP     # replayed, not redone
    want = _params(control, 0)
    for proc in (0, 1):
        assert _same(_params(out, proc), want), \
            f"controller {proc} diverged from the uninterrupted control"
    # the monitor's verdict: both exited cleanly, both in the lag table
    from shifu_tpu_torch.obs.monitor import aggregate_records, step_lag_table
    recs, counts = aggregate_records([out])
    assert counts.get("exited", 0) == 2 and not counts.get("stale") \
        and not counts.get("stalled"), counts
    assert len(step_lag_table(recs)) == 2


def test_quorum_kill_masks_the_loss_and_a_late_rejoiner_replays(tmp_path,
                                                               control):
    out = str(tmp_path / "job")
    survivor = _launch(out, 0, QUORUM_MODE, 0.25)
    victim = _launch(out, 1, QUORUM_MODE, 0.25,
                     faults_spec=f"dcn:step={KILL_STEP}:kill")
    _wait(victim, "victim", 137)
    _wait(survivor, "surviving controller")     # finishes under quorum
    sv = _result(out, 0)
    assert sv["epochs_run"] == 6
    assert abs(sv["auc"] - _result(control, 0)["auc"]) <= 0.01
    rejoiner = _launch(out, 1, QUORUM_MODE, 0.25, tag="-rejoin")
    assert "rejoined=1" in _wait(rejoiner, "late rejoiner")
    assert _result(out, 1)["dcn"]["catchup_steps"] >= 6   # epochs + eval
    assert _same(_params(out, 0), _params(out, 1)), \
        "the rejoiner's replay diverged from the survivor"
