"""No run loads JAX or the JAX package, the plain reference loads nothing
of the port, nothing under portbench/ imports either or tests/, and the
command refuses to run without a card."""

import ast
import json
import pathlib
import subprocess
import sys
import types

import pytest

from portbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)


def test_no_source_imports_jax_the_jax_package_or_tests():
    for path in harness.HERE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in harness.FORBIDDEN + ("tests",), (path,
                                                                   name)


def test_a_run_loads_no_forbidden_module():
    code = ("import json, sys; from portbench import harness; "
            "r = harness.run_cell('raw-turbo.write', 3, 0.05, True, "
            "device='cpu', sizes={'pool_bytes': 3 << 16, 'call_bytes': "
            "2 << 16, 'stride_bytes': 1 << 16, 'slices': 2}); "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = _run(code)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "tpu_snappy_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    out = _run("import sys, json; import portbench.reference, "
               "portbench.yardstick, portbench.generators.mix; "
               "print(json.dumps(sorted({m.split('.')[0] "
               "for m in sys.modules})))")
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "tpu_snappy_torch" not in tops and "portbench" in tops


def test_forbidden_module_ends_the_run(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_modules() == ["jax"]
    with pytest.raises(harness.RunError) as err:
        harness.run_cell("raw-turbo.write", 3, 0.05, False, device="cpu",
                         sizes={"pool_bytes": 3 << 16,
                                "call_bytes": 2 << 16,
                                "stride_bytes": 1 << 16, "slices": 2})
    assert err.value.code == 3


def test_the_port_name_passes_the_check(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_snappy_torch_extra",
                        types.ModuleType("tpu_snappy_torch_extra"))
    assert "tpu_snappy" not in harness.forbidden_modules()


def test_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "raw-default.write", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
