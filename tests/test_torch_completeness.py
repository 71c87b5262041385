"""The port is complete: every source file of the JAX package has its
counterpart in pecos_tpu_torch, and every command-line option of the JAX
package's CLIs is accepted by the port's counterpart.  Read from file paths
and by ``ast``; neither package is imported.

The exceptions, each with its reason:

- ``core/<name>.cpp`` lives at ``core/csrc/<name>.cpp`` (the host core's
  sources sit beside the CUDA kernels' ``ops/csrc``);
- ``utils/jax_util.py`` is ``utils/torch_util.py`` (device and dtype helpers
  of the framework in use);
- ``xmc/xtransformer/flax_xlnet.py`` has none: it exists because
  ``transformers`` has no Flax XLNet, and the port uses torch's
  ``XLNetModel``;
- distributed train's ``--multihost`` is replaced by ``--device`` with
  torchrun, which starts the processes.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = REPO / "pecos_tpu", REPO / "pecos_tpu_torch"
SOURCE_SUFFIXES = {".py", ".cpp", ".h", ".cu", ".cuh"}
RENAMED = {"utils/jax_util.py": "utils/torch_util.py"}
NO_COUNTERPART = {"xmc/xtransformer/flax_xlnet.py"}
REPLACED_OPTIONS = {"distributed/xmc/xlinear/train.py": {"--multihost": "--device"}}
N_CLIS = 13


def _sources(pkg):
    return sorted(
        p.relative_to(pkg).as_posix()
        for p in pkg.rglob("*")
        if p.is_file() and p.suffix in SOURCE_SUFFIXES and "__pycache__" not in p.parts
    )


def _counterpart(rel):
    if rel in RENAMED:
        return RENAMED[rel]
    if rel.startswith("core/") and rel.endswith(".cpp"):
        return "core/csrc/" + rel[len("core/"):]
    return rel


def _options(path):
    """Every option string passed to an ``add_argument`` call in the file."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "add_argument":
            for arg in node.args:
                assert isinstance(arg, ast.Constant) and isinstance(arg.value, str), f"{path}: an option not written out"
                if arg.value.startswith("-"):
                    out.add(arg.value)
    return out


def _clis():
    return [rel for rel in _sources(JAX_PKG) if rel.endswith(".py") and _options(JAX_PKG / rel)]


def test_allowlist_names_existing_files():
    for rel in list(RENAMED) + sorted(NO_COUNTERPART) + list(REPLACED_OPTIONS):
        assert (JAX_PKG / rel).is_file(), rel
    for rel in RENAMED.values():
        assert (PORT_PKG / rel).is_file(), rel


@pytest.mark.parametrize("rel", _sources(JAX_PKG))
def test_every_source_file_has_a_counterpart(rel):
    if rel in NO_COUNTERPART:
        return
    assert (PORT_PKG / _counterpart(rel)).is_file(), f"pecos_tpu/{rel} has no pecos_tpu_torch/{_counterpart(rel)}"


def test_every_cli_is_found():
    assert len(_clis()) == N_CLIS, _clis()


@pytest.mark.parametrize("rel", _clis())
def test_every_cli_option_is_accepted(rel):
    want, got = _options(JAX_PKG / rel), _options(PORT_PKG / rel)
    replaced = REPLACED_OPTIONS.get(rel, {})
    for old, new in replaced.items():
        assert old in want and new in got, (rel, old, new)
    missing = sorted(want - got - set(replaced))
    assert not missing, f"pecos_tpu_torch/{rel} lacks {missing}"
