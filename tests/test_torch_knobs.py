"""Port parity for the knob registry — ``shifu_tpu_torch.config.knobs``
against the port's code and ``shifu_tpu.config.knobs``.

The port's AST is walked for the reads the reference's ``knob-registry``
lint rule checks — ``environment.get_*`` / ``set_property`` calls and
``os.environ`` / ``os.getenv`` reads of a ``shifu.*`` / ``SHIFU_*``
literal: each must name a declared knob (properties case-insensitively).
Each declared knob must be named in the port outside the registry, and a
knob both packages declare must have equal fields in both.
"""

import ast
import os

import pytest

from shifu_tpu.config import knobs as jknobs
from shifu_tpu_torch.config import knobs

pytestmark = pytest.mark.torch_port

PORT = os.path.join(os.path.dirname(__file__), "..", "shifu_tpu_torch")
READS = ("get_property", "get_int", "get_float", "get_bool", "set_property")


def _qual(node) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _str(node):
    return node.value if isinstance(node, ast.Constant) \
        and isinstance(node.value, str) else None


def _port_trees():
    for root, _, files in os.walk(PORT):
        for f in sorted(files):
            path = os.path.join(root, f)
            if f.endswith(".py") and not path.endswith(
                    os.path.join("config", "knobs.py")):
                with open(path) as fh:
                    yield os.path.relpath(path, PORT), ast.parse(fh.read())


def _reads():
    out = {}
    for rel, tree in _port_trees():
        for n in ast.walk(tree):
            tok = None
            if isinstance(n, ast.Call) and n.args:
                fq = _qual(n.func)
                if fq.rsplit(".", 1)[-1] in READS or fq in (
                        "os.getenv", "os.environ.get", "environ.get"):
                    tok = _str(n.args[0])
            elif isinstance(n, ast.Subscript) \
                    and _qual(n.value) in ("os.environ", "environ"):
                tok = _str(n.slice)
            if tok and tok.startswith(("shifu.", "SHIFU_")):
                out.setdefault(tok, []).append(rel)
    return out


def test_every_knob_the_port_reads_is_declared():
    reads = _reads()
    assert len(reads) >= 40
    undeclared = {k: v for k, v in reads.items() if not knobs.is_declared(k)}
    assert not undeclared


def test_every_declared_knob_is_named_in_the_port():
    names = set()
    for _, tree in _port_trees():
        names |= {n.value for n in ast.walk(tree)
                  if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    lower = {n.lower() for n in names}
    dead = [k.name for k in knobs.KNOBS.values()
            if k.name not in names
            and not (k.kind == "property" and k.name.lower() in lower)]
    assert not dead


def test_shared_knobs_have_the_reference_fields():
    shared = [k for k in knobs.KNOBS if k in jknobs.KNOBS]
    assert len(shared) == len(knobs.KNOBS) - 1      # SHIFU_TORCH_BUILD_DIR
    for k in shared:
        assert vars(knobs.KNOBS[k]) == vars(jknobs.KNOBS[k]), k
    assert knobs.is_declared("shifu.train.windowrows")
    assert not knobs.is_declared("shifu.serve.maxDelayMS.typo")
