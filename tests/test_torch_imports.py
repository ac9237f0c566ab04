"""Port hygiene: ``shifu_tpu_torch`` and ``chip_smoke.py`` never import
``jax``, ``pandas`` or ``shifu_tpu`` (the machine with the card has none of
them), and the port's entry points default to CUDA — raising, not quietly
running on the CPU, when CUDA is absent."""

import ast
import os

import pytest
import torch

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "pandas", "shifu_tpu")


def _port_sources():
    """chip_smoke.py first, then every module of the package."""
    pkg = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "shifu_tpu_torch")):
        pkg += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return [os.path.join(ROOT, "chip_smoke.py")] + sorted(pkg)


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "__import__", "import_module") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value)


def test_port_imports_no_jax_pandas_or_reference_package():
    sources = _port_sources()
    assert len(sources) > 20 and os.path.isfile(sources[0])
    bad = [f"{os.path.relpath(p, ROOT)}:{line} imports {mod}"
           for p in sources for line, mod in _imported_modules(p)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, "\n".join(bad)


def test_serve_server_defaults_to_cuda_and_raises_without_it(monkeypatch,
                                                             tmp_path):
    """No ``device=``: the server asks for CUDA and refuses to start on a
    machine without it, before touching the model set."""
    from shifu_tpu_torch import resolve_device
    from shifu_tpu_torch.serve import ServeServer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeServer(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    from shifu_tpu_torch.cli import build_parser, main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert build_parser().parse_args(["serve"]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--dir", str(tmp_path), "serve", "--selfcheck", "1"])


def test_package_imports_without_building_kernels(monkeypatch):
    """Importing every module builds nothing: nvcc runs only at the first
    CUDA launch."""
    import importlib
    import subprocess
    calls = []
    monkeypatch.setattr(subprocess, "Popen",
                        lambda *a, **k: calls.append(a))
    for p in _port_sources()[1:]:
        rel = os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".")
        importlib.import_module(rel.removesuffix(".__init__"))
    assert calls == []


def test_pyarrow_and_fsspec_are_imported_only_inside_functions():
    """The card's machine is not known to have ``pyarrow`` or ``fsspec``:
    the port (and the smoke) import them only inside the functions that
    read a parquet or a remote source, never at a module's top level."""
    lazy = ("pyarrow", "fsspec")
    bad, inside = [], 0
    for path in _port_sources():
        tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
        for node in tree.body:
            for sub in ast.walk(node):
                if isinstance(sub, (ast.Import, ast.ImportFrom)):
                    names = [a.name for a in sub.names] \
                        if isinstance(sub, ast.Import) else [sub.module or ""]
                    if not any(n.split(".")[0] in lazy for n in names):
                        continue
                    if isinstance(node, (ast.FunctionDef, ast.ClassDef,
                                         ast.AsyncFunctionDef)):
                        inside += 1
                    else:
                        bad.append(f"{os.path.relpath(path, ROOT)}:"
                                   f"{sub.lineno}")
    assert not bad, bad
    assert inside >= 4           # the reader's parquet and fsspec paths
