"""Trainer-state checkpointing — the port of ``shifu_tpu.train.checkpoint``
(the reference's fail-over story: Guagua restarts from the last iteration
state, ``NNMaster.java:517-528``).

Format, shared with the reference: one ``ckpt-<epoch>.npz`` a checkpoint
with the state's leaves as ``leaf<i>`` in JAX's tree-flatten order (dict
keys sorted, lists and tuples in order), a ``__meta__`` json record (epoch,
leaf count, per-leaf dtype names, the precision tag), bfloat16 leaves
stored as their uint16 bit pattern.  Restore maps the leaves back onto a
template tree of the same structure, so a checkpoint either package wrote
resumes in the other.
"""

from __future__ import annotations

import io
import json
import logging
import os
import re
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger(__name__)

_NAME = re.compile(r"ckpt-(\d+)\.npz$")


def tree_leaves(tree) -> List[Any]:
    """Leaves in JAX's tree-flatten order: dict keys sorted, lists and
    tuples in order, None and empty containers leafless."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for t in tree for l in tree_leaves(t)]
    return [tree]


def tree_unflatten(template, leaves: List[Any]):
    """``template``'s structure with its leaves replaced, in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            new = {k: build(t[k]) for k in sorted(t)}
            return {k: new[k] for k in t}
        if isinstance(t, (list, tuple)):
            out = [build(x) for x in t]
            return out if isinstance(t, list) else tuple(out)
        return next(it)
    return build(template)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as numpy for the npz: bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(leaf)
    if a.dtype.kind not in "biufc":
        a = a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint8)
    return a


def save_state(directory: str, epoch: int, state: Any, keep: int = 3,
               precision: Optional[str] = None) -> str:
    """Write ``state`` (a tree of tensors and arrays) as
    ``ckpt-<epoch>.npz``, atomically, keeping the last ``keep``;
    ``precision`` tags the checkpoint with its training-precision mode."""
    os.makedirs(directory, exist_ok=True)
    for f in os.listdir(directory):          # orphans of a crash mid-rename
        if f.endswith(".npz.tmp"):
            try:
                os.remove(os.path.join(directory, f))
            except OSError:
                pass
    leaves = tree_leaves(state)
    arrays = {f"leaf{i}": _to_numpy(l) for i, l in enumerate(leaves)}
    meta = {"epoch": epoch, "n_leaves": len(leaves),
            "dtypes": [_dtype_name(l) for l in leaves]}
    if precision is not None:
        meta["precision"] = precision
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    path = os.path.join(directory, f"ckpt-{epoch}.npz")
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)   # atomic: a crash never leaves a torn checkpoint
    _prune(directory, keep)
    return path


def latest_epoch(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    epochs = [int(m.group(1)) for f in os.listdir(directory)
              if (m := _NAME.search(f))]
    return max(epochs) if epochs else None


def _restore_leaf(a: np.ndarray, tmpl):
    """Saved array ``a`` as the template leaf's kind: a CPU tensor for a
    tensor template (bf16 from its bits), numpy otherwise."""
    if isinstance(tmpl, torch.Tensor):
        if tmpl.dtype == torch.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return np.array(a)


def restore_state(directory: str, template: Any,
                  expect_precision: Optional[str] = None
                  ) -> Optional[Tuple[int, Any]]:
    """Load the latest checkpoint onto ``template``'s structure.  Returns
    (epoch, state) or None when there is none or it does not fit (leaf
    count, shape or dtype differ: the config changed).

    ``expect_precision`` enforces the precision handshake: a checkpoint
    written under another ``shifu.train.precision`` (untagged counts as
    ``f32``) raises ``ERROR_CHECKPOINT_PRECISION_MISMATCH`` rather than
    silently casting."""
    epoch = latest_epoch(directory)
    if epoch is None:
        return None
    data = np.load(os.path.join(directory, f"ckpt-{epoch}.npz"))
    meta = json.loads(bytes(data["__meta__"]).decode())
    if expect_precision is not None:
        found = meta.get("precision") or "f32"
        if found != expect_precision:
            from ..config.errors import ErrorCode, ShifuError
            raise ShifuError(
                ErrorCode.ERROR_CHECKPOINT_PRECISION_MISMATCH,
                f"checkpoint {directory}/ckpt-{epoch}.npz was written "
                f"under precision={found!r} but this run trains under "
                f"precision={expect_precision!r} — restart from scratch "
                "or set shifu.train.precision back")
    leaves = tree_leaves(template)
    if meta["n_leaves"] != len(leaves):
        log.warning("checkpoint %d has %d leaves, template %d — ignoring",
                    epoch, meta["n_leaves"], len(leaves))
        return None
    saved_dtypes = meta.get("dtypes")
    new_leaves = []
    for i, tmpl in enumerate(leaves):
        a = data[f"leaf{i}"]
        if tuple(a.shape) != tuple(tmpl.shape):
            log.warning("checkpoint leaf %d shape %s != template %s — "
                        "ignoring checkpoint", i, a.shape, tuple(tmpl.shape))
            return None
        saved_dt = saved_dtypes[i] if saved_dtypes else str(a.dtype)
        if saved_dt != _dtype_name(tmpl):
            log.warning("checkpoint leaf %d dtype %s != template %s — "
                        "ignoring checkpoint", i, saved_dt,
                        _dtype_name(tmpl))
            return None
        new_leaves.append(_restore_leaf(a, tmpl))
    return meta["epoch"], tree_unflatten(template, new_leaves)


def _prune(directory: str, keep: int) -> None:
    files = sorted(((int(m.group(1)), f) for f in os.listdir(directory)
                    if (m := _NAME.search(f))))
    for _, f in files[:-keep]:
        os.remove(os.path.join(directory, f))
