"""Grid search / hyper-param fan-out — the port's copy of
``shifu_tpu.train.grid_search`` (reference
``core/dtrain/gs/GridSearch.java:62``).

List-valued entries in ``train#params`` expand cartesian-product style into
flattened trial param dicts; alternatively ``train.gridConfigFile`` lists one
EXPLICIT trial per line (``key:value;key:value``, :func:`load_grid_config`).
In the reference each combo becomes its own Guagua YARN job; here trials
whose params differ only in per-member scalars train together as members
of one ensemble run (:func:`tree_stackable_groups` for the tree trainers,
:func:`stackable_groups` for the NN ensemble).
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List


def is_grid_search(params: Dict[str, Any]) -> bool:
    return any(isinstance(v, list) and _is_axis(k, v) for k, v in params.items())


def _is_axis(key: str, v: list) -> bool:
    """A list value is a grid axis unless the key naturally takes a list
    (hidden node counts / activations), where only list-of-list is an axis."""
    if key in ("NumHiddenNodes", "ActivationFunc", "FixedLayers",
               "NumEmbedColumnIds"):
        return bool(v) and isinstance(v[0], list)
    return True


def expand(params: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Flatten list-valued params into trial dicts (order = reference's
    row-major cartesian iteration)."""
    axes, fixed = [], {}
    for k, v in params.items():
        if isinstance(v, list) and _is_axis(k, v):
            axes.append((k, v))
        else:
            fixed[k] = v
    if not axes:
        return [dict(params)]
    trials = []
    for combo in itertools.product(*(v for _, v in axes)):
        t = dict(fixed)
        t.update({k: c for (k, _), c in zip(axes, combo)})
        trials.append(t)
    return trials


# hypers an NN ensemble can vary per member (scalar multipliers in the
# update rule / loss); everything else changes the network's structure
STACKABLE_KEYS = ("LearningRate", "RegularizedConstant", "L2Const",
                  "L1Const", "DropoutRate")

# optimizers whose update delta is LINEAR in learning_rate — only for these
# can a LearningRate axis stack as a per-member delta multiplier.  RPROP
# ('R', the default) ignores lr entirely and quickprop is nonlinear in it.
LR_LINEAR_OPTS = frozenset({"ADAM", "SGD", "MOMENTUM", "NESTEROV",
                            "RMSPROP", "ADAGRAD", "B", "M"})


def _trial_stackable(trial: Dict[str, Any]) -> frozenset:
    opt = str(trial.get("Propagation", trial.get("Optimizer", "R"))).upper()
    if opt in LR_LINEAR_OPTS:
        return frozenset(STACKABLE_KEYS)
    return frozenset(k for k in STACKABLE_KEYS if k != "LearningRate")


def stackable_groups(trials: List[Dict[str, Any]]) -> List[List[int]]:
    """Group trial indices whose params differ ONLY in stackable scalar
    hypers — each group trains as ONE ensemble run (scalar hypers become
    per-member arrays), instead of the reference's queue of 5
    concurrent YARN jobs (``TrainModelProcessor.java:768-781``)."""
    import json
    groups: Dict[str, List[int]] = {}
    for i, t in enumerate(trials):
        stackable = _trial_stackable(t)
        key = json.dumps({k: v for k, v in sorted(t.items())
                          if k not in stackable}, default=str)
        groups.setdefault(key, []).append(i)
    return list(groups.values())


# tree-trainer hypers that may differ between the members of ONE bagged
# run (per-member scalars beside per-member weights, bags and feature
# subsets); everything else (TreeNum/MaxDepth/Impurity/Loss/...) changes
# the trees' shape, so such trials train group by group
TREE_STACKABLE_KEYS = ("LearningRate", "MinInstancesPerNode", "MinInfoGain",
                       "Seed")


def tree_stackable_groups(trials: List[Dict[str, Any]]) -> List[List[int]]:
    """Group tree-trial indices whose params differ only in per-member
    scalar hypers (see :data:`TREE_STACKABLE_KEYS`) — each group trains as
    one multi-forest run (reference queues one Guagua job per combo,
    ``TrainModelProcessor.java:768-781``)."""
    import json
    groups: Dict[str, List[int]] = {}
    for i, t in enumerate(trials):
        key = json.dumps({k: v for k, v in sorted(t.items())
                          if k not in TREE_STACKABLE_KEYS}, default=str)
        groups.setdefault(key, []).append(i)
    return list(groups.values())


def rank_and_report(tmp_dir: str, valid_errors: List[float],
                    trial_params: List[Dict[str, Any]]) -> List[int]:
    """THE grid-report contract (one place): rank trials by validation
    error, write the ordered ``[{trial, validError, params}]`` list to
    ``tmp_dir/grid_search.json``, return the ranked trial indices (best
    first).  Consumers: NN/tree/WDL grid drivers + their tests."""
    import json
    import os
    order = sorted(range(len(valid_errors)), key=lambda i: valid_errors[i])
    report = [{"trial": i, "validError": float(valid_errors[i]),
               "params": trial_params[i]} for i in order]
    os.makedirs(tmp_dir, exist_ok=True)
    with open(os.path.join(tmp_dir, "grid_search.json"), "w") as f:
        json.dump(report, f, indent=2, default=str)
    return order


def load_grid_config(path: str) -> List[Dict[str, Any]]:
    """Explicit trial list from ``train.gridConfigFile`` — one trial per
    line, ``key:value;key:value`` (reference ``GridSearch.java:119-153``);
    values parse as JSON when possible (lists/numbers), else strings."""
    import json
    trials: List[Dict[str, Any]] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t: Dict[str, Any] = {}
            for ele in line.split(";"):
                if not ele.strip():
                    continue
                key, sep, val = ele.partition(":")
                if not sep:
                    raise ValueError(
                        f"{path}:{lineno}: expected <name>:<value> "
                        f"elements joined by ';', got {ele!r}")
                val = val.strip()
                try:
                    t[key.strip()] = json.loads(val)
                except json.JSONDecodeError:
                    t[key.strip()] = val
            if t:
                trials.append(t)
    return trials
