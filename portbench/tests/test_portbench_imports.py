"""Nothing the benchmark runs loads JAX or the JAX package, and it reads
none of the JAX package's benchmark files."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.core import harness

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def test_top_level_names_are_compared_whole():
    mods = ["cross_patient_speech_decoding_tpu_torch",
            "cross_patient_speech_decoding_tpu_torch.ops.gru", "jaxtyping",
            "flaxen", "torch", "jax", "jaxlib.xla_client", "flax.linen",
            "cross_patient_speech_decoding_tpu",
            "cross_patient_speech_decoding_tpu.models"]
    assert harness.forbidden_modules(mods) == [
        "cross_patient_speech_decoding_tpu",
        "cross_patient_speech_decoding_tpu.models", "flax.linen", "jax",
        "jaxlib.xla_client"]


def _imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax(path):
    for name in _imported(path):
        assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)
    if path.parent.name != "tests":
        for text in _strings(path):
            assert "bench.py" not in text and "BENCH_" not in text, path


def _strings(path: Path):
    """String constants of a source, its docstrings left out."""
    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)) \
                and node.body and isinstance(node.body[0], ast.Expr):
            docs.add(id(node.body[0].value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            yield node.value


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    for name in _imported(path):
        assert not name.startswith("cross_patient_speech_decoding_tpu"), \
            (path, name)


def test_a_small_run_loads_no_jax():
    code = ("import sys; from portbench.tests.small import run_small; "
            "run_small('rnn_fig5.eval', seconds=0.1); "
            "from portbench.core.harness import forbidden_modules; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_means_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal is not reached")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "rnn_fig5.eval",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
