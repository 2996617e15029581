"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``repro``.

With ``PYTHONPATH=src`` both packages sit on the path, so an accidental
``from repro.core.protocol import Packet`` in the port works here and
fails on a machine that has only PyTorch.  This walks the sources with
``ast`` instead of importing them.
"""
import ast
import pathlib

import jax  # noqa: F401  (the port's tests import both packages)
import pytest
import torch  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [f"{path.relative_to(REPO)}:{line}: import {mod}"
           for line, mod in _imported_modules(path) if _forbidden(mod)]
    assert not bad, "\n".join(bad)


def test_the_walk_sees_the_whole_port():
    rel = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for want in ("src/repro_torch/core/server.py",
                 "src/repro_torch/core/engine_compiled.py",
                 "src/repro_torch/kernels/packet_scatter.py",
                 "src/repro_torch/kernels/fedavg_accum.py",
                 "src/repro_torch/kernels/quantized_accum.py",
                 "src/repro_torch/kernels/_build.py",
                 "src/repro_torch/core/aggregation.py",
                 "src/repro_torch/core/fedavg.py",
                 "src/repro_torch/data/synthetic.py",
                 "src/repro_torch/data/federated.py",
                 "src/repro_torch/models/cnn.py",
                 "src/repro_torch/core/rounds.py",
                 "src/repro_torch/runtime/fault_tolerance.py",
                 "chip_smoke.py"):
        assert want in rel


@pytest.mark.parametrize("src,bad", [
    ("import jax.numpy as jnp", True),
    ("from repro.core.protocol import Packet", True),
    ("import repro", True),
    ("from repro_torch.core import server", False),
    ("import torch", False),
])
def test_forbidden_import_detection(tmp_path, src, bad):
    f = tmp_path / "m.py"
    f.write_text(src + "\n")
    assert any(_forbidden(m) for _, m in _imported_modules(f)) == bad
