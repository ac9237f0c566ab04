"""Port parity for the commands around the offline path: ``analysis -fi``,
``convert``, the version commands (``save``, ``switch``, ``history``,
``show``, ``delete``, ``cp``), ``test`` and ``combo`` —
``shifu_tpu_torch.pipeline.{analysis,convert,manage,smoke,combo}`` and
the CLI against ``shifu_tpu``'s on copies of the prepared fraud set.

Files are compared byte for byte (``.fi``, ``convert``'s JSON and the
npz it converts back, every file of the snapshot trees); ``test`` gives
the reference's return codes for each ``-filter`` form; ``combo``'s
member and assembled AUCs are within 0.005 of the reference's (each
package trains its own members: the reference under
``jax.enable_x64(False)``, so its initial weights are the port's,
C3).  The CLI carries every reference subcommand: ``lint`` parses any
arguments and raises ``NotImplementedError`` naming ROADMAP Queue 1
item 13.
"""

import json
import logging
import os
import shutil
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def gbt_set(tmp_path_factory, _prepared_template):
    from pipeline import train_algorithm
    d = str(tmp_path_factory.mktemp("aux_gbt") / "set")
    shutil.copytree(_prepared_template, d)
    train_algorithm(d, "GBT", {"TreeNum": 5, "MaxDepth": 3, "Loss": "log"})
    return d


def _pair(src, root):
    dirs = []
    for who in ("ref", "port"):
        d = str(root / who)
        shutil.copytree(src, d)
        dirs.append(d)
    return dirs


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _tree(d):
    """{relative path: bytes} of every file under ``d``."""
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            out[os.path.relpath(p, d)] = _read(p)
    return out


def test_cli_has_every_reference_subcommand_but_monitor_refresh_lint():
    from shifu_tpu.cli import build_parser as j_parser
    from shifu_tpu_torch.cli import build_parser

    def commands(p):
        sub = next(a for a in p._actions if a.dest == "command")
        return set(sub.choices)
    missing = commands(j_parser()) - commands(build_parser())
    # monitor and refresh are ported; lint parses and raises naming its
    # ROADMAP item
    assert missing == set()


def test_analysis_fi_is_byte_equal(gbt_set, tmp_path, capsys):
    from shifu_tpu.cli import main as jmain
    from shifu_tpu_torch.cli import main
    ref, port = _pair(gbt_set, tmp_path)
    for run, d in ((jmain, ref), (main, port)):
        mp = os.path.join(d, "models", "model0.gbt")
        assert run(["--dir", d, "analysis", "-fi", mp]) == 0
        assert run(["--dir", d, "analysis", "-fi", d + "/nope.gbt"]) == 1
    got, want = (_read(os.path.join(d, "models", "model0.gbt.fi"))
                 for d in (port, ref))
    assert got == want and len(got.splitlines()) >= 4
    # with no trace recorded, both render the same hint
    outs = []
    for run, d in ((jmain, ref), (main, port)):
        capsys.readouterr()
        assert run(["--dir", d, "analysis", "--telemetry"]) == 0
        outs.append(capsys.readouterr().out.replace(d, "<set>"))
    assert outs[0] == outs[1] and "telemetry" in outs[0]


def test_convert_json_and_back_are_equal(gbt_set, tmp_path):
    from shifu_tpu.pipeline.convert import run_convert as j_convert
    from shifu_tpu_torch.models import load_any
    from shifu_tpu_torch.pipeline.convert import run_convert
    ref, port = _pair(gbt_set, tmp_path)
    assert j_convert(ref, {"tozipb": True}) == 0
    assert run_convert(port, {"tozipb": True}) == 0
    js = "models/model0.gbt.json"
    assert _read(os.path.join(port, js)) == _read(os.path.join(ref, js))
    bins = np.random.default_rng(0).integers(0, 5, (64, 6)).astype(np.int32)
    want = load_any(os.path.join(port, "models", "model0.gbt")).compute(
        bins, device="cpu")
    for d, run in ((ref, j_convert), (port, run_convert)):
        os.remove(os.path.join(d, "models", "model0.gbt"))
        assert run(d, {"tob": True}) == 0
    got, ref_model = (_read(os.path.join(d, "models", "model0.gbt"))
                      for d in (port, ref))
    assert got == ref_model
    np.testing.assert_array_equal(
        load_any(os.path.join(port, "models", "model0.gbt")).compute(
            bins, device="cpu"), want)
    empty = str(tmp_path / "empty")
    os.makedirs(os.path.join(empty, "models"))
    assert run_convert(empty, {"tob": True}) == 1


def test_version_commands_make_the_reference_snapshot_trees(gbt_set,
                                                            tmp_path):
    from shifu_tpu.cli import main as jmain
    from shifu_tpu_torch.cli import main
    ref, port = _pair(gbt_set, tmp_path)
    steps = [["save", "v1"], ["history"], ["show"], ["save", "v2"],
             ["switch", "v1"], ["show"], ["delete", "v2"],
             ["delete", "nope"], ["switch", "nope"], ["history"],
             ["cp", "CLONE"]]
    for argv in steps:
        for run, d in ((jmain, ref), (main, port)):
            args = list(argv)
            if args[0] == "cp":
                args[1] = os.path.join(os.path.dirname(d), "clone_"
                                       + os.path.basename(d))
            rc = run(["--dir", d] + args)
            want = 1 if "nope" in argv else 0
            assert rc == want, (argv, d)
    assert _tree(os.path.join(port, ".backup")) == \
        _tree(os.path.join(ref, ".backup"))
    got, want = (_tree(os.path.join(tmp_path, f"clone_{w}"))
                 for w in ("port", "ref"))
    mc = {k: json.loads(v) for k, v in got.items()}
    mc_ref = {k: json.loads(v) for k, v in want.items()}
    assert mc["ModelConfig.json"].pop("basic")["name"] == "clone_port"
    assert mc_ref["ModelConfig.json"].pop("basic")["name"] == "clone_ref"
    assert mc == mc_ref
    assert main(["--dir", port, "cp", os.path.join(tmp_path,
                                                   "clone_port")]) == 1


@pytest.mark.parametrize("target,want", [
    (None, 0), ("", 0), ("*", 0), ("Eval1", 0), ("nosuch", 1), (",", 1)])
def test_test_step_return_codes_match(gbt_set, tmp_path, target, want):
    from shifu_tpu.pipeline.smoke import SmokeTestProcessor as JSmoke
    from shifu_tpu_torch.pipeline.smoke import SmokeTestProcessor
    ref, port = _pair(gbt_set, tmp_path)
    params = {"filter_target": target}
    assert JSmoke(ref, params=params).run() == want
    assert SmokeTestProcessor(port, params=params).run() == want


def test_test_step_one_sided_tags_and_filter_expressions(gbt_set,
                                                         tmp_path, caplog,
                                                         monkeypatch):
    """Tags that never match fail in both; with a non-empty
    filterExpressions both pass and log the same sampled and filtered
    counts."""
    from shifu_tpu.pipeline.smoke import SmokeTestProcessor as JSmoke
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.pipeline.smoke import SmokeTestProcessor
    ref, port = _pair(gbt_set, tmp_path)
    for d in (ref, port):
        path = os.path.join(d, "ModelConfig.json")
        mc = ModelConfig.load(path)
        mc.dataSet.posTags = ["never-matches"]
        mc.save(path)
    assert JSmoke(ref, params={}).run() == 1
    assert SmokeTestProcessor(port, params={}).run() == 1
    from torch_port import writable_reference_filter
    writable_reference_filter(monkeypatch)      # C14
    logs = []
    for d, proc in ((ref, JSmoke), (port, SmokeTestProcessor)):
        path = os.path.join(d, "ModelConfig.json")
        mc = ModelConfig.load(path)
        mc.dataSet.posTags = ["bad"]
        mc.dataSet.filterExpressions = "amount > 10 & channel == 'web'"
        mc.save(path)
        caplog.clear()
        with caplog.at_level(logging.INFO):
            assert proc(d, params={"filter_target": ""}).run() == 0
        logs.append([r.getMessage() for r in caplog.records
                     if "records sampled" in r.getMessage()])
    assert logs[0] == logs[1] and len(logs[0]) == 1
    assert " 0 filtered" not in logs[0][0]


def _combo_set(template, d):
    """The prepared set without ``txn_id`` (a leaking id) and with the
    members' params."""
    from shifu_tpu_torch.config import ModelConfig
    shutil.copytree(template, d)
    cpath = os.path.join(d, "ColumnConfig.json")
    with open(cpath) as f:
        ccs = json.load(f)
    for c in ccs:
        c["finalSelect"] = c.get("columnFlag") not in (
            "Target", "Weight", "Meta") and c["columnName"] != "txn_id"
    with open(cpath, "w") as f:
        json.dump(ccs, f, indent=1)
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    mc.train.numTrainEpochs = 10
    mc.train.params = {"TreeNum": 5, "MaxDepth": 3, "NumHiddenNodes": [8],
                       "ActivationFunc": ["tanh"], "Loss": "log",
                       "LearningRate": 0.1}
    mc.save(path)


def test_combo_aucs_match_the_reference(_prepared_template, tmp_path):
    import jax
    from shifu_tpu.pipeline.combo import run_combo as j_combo
    from shifu_tpu_torch.pipeline.combo import run_combo
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    _combo_set(_prepared_template, ref)
    _combo_set(_prepared_template, port)
    with jax.enable_x64(False):
        assert j_combo(ref, "new", "LR:GBT") == 0
        assert j_combo(ref, "run", None) == 0
        assert j_combo(ref, "eval", None) == 0
    assert run_combo(port, "new", "LR:GBT") == 0
    assert _read(os.path.join(port, "combo.json")) == \
        _read(os.path.join(ref, "combo.json"))
    assert run_combo(port, "run", None, device="cpu") == 0
    for m in ("combo_0_LR/models/model0.lr", "combo_1_GBT/models/model0.gbt"):
        assert os.path.isfile(os.path.join(port, m))
    assert _read(os.path.join(port, "combo_0_LR", "ModelConfig.json")) == \
        _read(os.path.join(ref, "combo_0_LR", "ModelConfig.json"))
    assert run_combo(port, "run", None, resume=True, device="cpu") == 0
    assert run_combo(port, "eval", None, device="cpu") == 0
    got, want = (json.load(open(os.path.join(d, "ComboEval.Eval1.json")))
                 for d in (port, ref))
    assert got["members"] == want["members"] == ["LR", "GBT"]
    assert abs(got["areaUnderRoc"] - want["areaUnderRoc"]) <= 0.005
    for g, w in zip(got["memberAuc"], want["memberAuc"]):
        assert g["member"] == w["member"]
        assert abs(g["areaUnderRoc"] - w["areaUnderRoc"]) <= 0.005, (g, w)
    assert got["areaUnderRoc"] > 0.7


def test_combo_refuses_what_is_not_ported(_prepared_template, tmp_path):
    """WDL and SVM members, refused until ROADMAP item 10, now train and
    score (``tests/test_torch_wdl_train.py`` holds their AUCs to the
    reference's); a missing ``combo.json`` or ``-alg`` still fails."""
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.pipeline.combo import run_combo
    d = str(tmp_path / "set")
    shutil.copytree(_prepared_template, d)
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    mc.train.numTrainEpochs = 2
    mc.train.params = {"NumHiddenNodes": [4], "ActivationFunc": ["relu"],
                       "MiniBatchs": 1024, "Kernel": "linear"}
    mc.save(os.path.join(d, "ModelConfig.json"))
    assert run_combo(d, "new", "WDL:SVM") == 0
    assert run_combo(d, "run", None, device="cpu") == 0
    assert sorted(os.listdir(os.path.join(d, "combo_0_WDL", "models"))) \
        == ["model0.wdl"]
    assert sorted(os.listdir(os.path.join(d, "combo_1_SVM", "models"))) \
        == ["model0.svm"]
    assert run_combo(d, "eval", None, device="cpu") == 0
    with open(os.path.join(d, "ComboEval.Eval1.json")) as f:
        assert json.load(f)["members"] == ["WDL", "SVM"]
    os.remove(os.path.join(d, "combo.json"))
    assert run_combo(d, "run", None, device="cpu") == 1
    assert run_combo(d, "new", None) == 1
