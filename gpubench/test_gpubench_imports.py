"""Nothing the benchmark runs loads JAX or the JAX package; the reference
imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

from gpubench.run import jax_modules

HERE = Path(__file__).resolve().parent


def test_top_level_names_are_compared_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "stochastic_gcn_tpu", "stochastic_gcn_tpu.ops.layers",
             "stochastic_gcn_tpu_torch", "stochastic_gcn_tpu_torch.ops",
             "jaxtyping", "flaxen", "numpy"]
    assert jax_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "stochastic_gcn_tpu", "stochastic_gcn_tpu.ops.layers"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax():
    for path in HERE.rglob("*.py"):
        assert not jax_modules(_imports(path)), path


def test_the_reference_imports_nothing_of_the_port():
    for name in ("reference.py", "check.py", "counts.py", "model.py",
                 "peaks.py"):
        assert "stochastic_gcn_tpu_torch" not in _imports(HERE / name)


def test_a_run_loads_no_jax(tmp_path):
    """A whole run of a cell at a small size on the CPU, in a fresh
    interpreter, then ``sys.modules``."""
    code = f"""
import sys, time
sys.path.insert(0, {str(HERE.parent)!r})
from gpubench import cells
from gpubench.manifest import Bench
from gpubench.run import jax_modules
res = cells.run(Bench({str(HERE.parent)!r}), "reddit-cvpp-b512", 7, 0.2,
                False, "cpu", time.perf_counter(),
                {{"config": {{"num_nodes": 600, "avg_degree": 6,
                             "feature_dim": 8, "hidden1": 8,
                             "num_classes": 3}},
                 "traffic": {{"batch_size": 32, "test_batch_size": 32}}}})
assert res["correct"], res
print("LOADED", jax_modules(sys.modules), "stochastic_gcn_tpu_torch" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED [] True" in out.stdout
