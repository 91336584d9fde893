"""The port's own native source: ``native/sais.c`` is a byte-for-byte
copy of the JAX package's (only this test reads both), the loader
builds the copy, and no module of the port builds a path into the JAX
package."""

import ast
import pathlib
import re

import numpy as np

from hpc_suffix_array_tpu_torch import native

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "hpc_suffix_array_tpu_torch"
JAX_PKG_PART = re.compile(r"(^|[/\\])hpc_suffix_array_tpu([/\\]|$)")


def test_sais_source_is_the_jax_copy():
    ours = (PKG / "native" / "sais.c").read_bytes()
    assert ours == (ROOT / "hpc_suffix_array_tpu" / "native"
                    / "sais.c").read_bytes()


def test_loader_builds_the_ports_own_source():
    assert native.SAIS_SRC == PKG / "native" / "sais.c"
    assert native.BUILD_DIR == ROOT / "build" / "native"
    text = np.frombuffer(b"mississippi", np.uint8)
    sa = native.sa_build(text)
    assert sa.tolist() == [10, 7, 4, 1, 0, 9, 8, 6, 3, 5, 2]
    assert native.lcp_kasai(text, sa).tolist() == [0, 1, 1, 4, 0, 0, 1, 0,
                                                   2, 1, 3]
    assert native.sa_validate(text, sa)


def _code_strings(path: pathlib.Path):
    """The string constants of a module that are not docstrings."""
    tree = ast.parse(path.read_text())
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            yield node.lineno, node.value


def test_no_module_builds_a_path_into_the_jax_package():
    """No string in the port's code names the JAX package's directory as
    a path component (e.g. ``_ROOT / "hpc_suffix_array_tpu" / ...``)."""
    offenders = [f"{p.relative_to(ROOT)}:{line}"
                 for p in PKG.rglob("*.py")
                 for line, value in _code_strings(p)
                 if JAX_PKG_PART.search(value)]
    assert offenders == []


def test_scan_catches_a_path_component():
    """The scan above sees the form the old loader used."""
    assert JAX_PKG_PART.search("hpc_suffix_array_tpu")
    assert JAX_PKG_PART.search("x/hpc_suffix_array_tpu/native/sais.c")
    assert not JAX_PKG_PART.search("hpc_suffix_array_tpu_torch/native")


def test_package_data_ships_the_c_source():
    text = (ROOT / "pyproject.toml").read_text()
    assert '"hpc_suffix_array_tpu_torch.native" = ["*.c"]' in text
