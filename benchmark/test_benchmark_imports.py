"""What a run may load: no module whose top-level name is JAX's or the JAX
package's, compared as whole names, and a reference that imports nothing of
the program."""
import subprocess
import sys

import pytest

from benchmark import harness, run


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "anatomask_tpu_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    assert "jax" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


@pytest.mark.parametrize("module", ["benchmark.reference.stunet", "benchmark.yardstick.stunet",
                                    "benchmark.inputs", "benchmark.trace"])
def test_yardstick_and_reference_load_nothing_of_the_program(module):
    code = (f"import sys, {module}; bad = {{m.split('.')[0] for m in sys.modules}} & "
            "{'jax', 'jaxlib', 'flax', 'anatomask_tpu', 'anatomask_torch'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_a_cell_run_loads_nothing_of_jax():
    code = ("import sys, time; from benchmark.conftest import run_tiny, tiny_spec; "
            "run_tiny(tiny_spec('predict-B.volume')); from benchmark.run import forbidden_modules; "
            "print(forbidden_modules()); sys.exit(1 if forbidden_modules() else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr


def test_run_without_a_card_exits_non_zero_with_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "predict-B.volume",
                          "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(harness.ROOT)})
    assert out.returncode != 0 and out.stdout.strip() == ""
