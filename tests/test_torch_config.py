"""The port's own ``Config`` (stochastic_gcn_tpu_torch/config.py) against the
JAX package's, and the port's freedom from the JAX package.

The port keeps its own copy of the flag dataclass so that it imports
nothing of ``stochastic_gcn_tpu``.  The copy must stay the same set of
options: same field names, order, types and defaults, same derived
properties, and the same parse of the same command line.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

from stochastic_gcn_tpu import config as JC
from stochastic_gcn_tpu_torch import config as TC

ROOT = Path(__file__).resolve().parent.parent

# the benchmark recipe's flags (bench.py:628-633) as a command line
RECIPE = ["--dataset", "reddit_like", "--batch_size", "512", "--degree", "1",
          "--test_degree", "1", "--cv", "--test_cv", "--hidden1", "128",
          "--normalization", "graphsage", "--layer_norm", "--num_fc_layers",
          "2", "--weight_decay", "0.0", "--dropout", "0.2", "--pad_degree",
          "64", "--seed", "1", "--test_batch_size", "2048"]

ARGVS = [
    [],
    RECIPE,
    RECIPE + ["--nopreprocess", "--history_dtype", "float32"],
    ["--cv=True", "--test_cv=false", "--layer_norm=1", "--nofadj_tier"],
    ["--preprocess=False", "--notest_preprocess", "--field_dedup",
     "--ckpt_compress=no", "--resume", "--learning_rate", "3e-3"],
    ["--epochs", "7", "--data", "1000", "--ckpt_dir", "/x/y", "--dp", "4",
     "--scatter_cap_mult", "1.5", "--profile_epochs", "2,3"],
]


def _fields(cls):
    return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]


def test_same_fields_types_and_defaults():
    assert _fields(TC.Config) == _fields(JC.Config)
    assert dataclasses.asdict(TC.Config()) == dataclasses.asdict(JC.Config())


@pytest.mark.parametrize("over", [
    {}, {"dataset": "ppi"}, {"preprocess": False},
    {"test_preprocess": False, "num_layers": 3}, {"dropout": 0.2}])
def test_same_derived_values(over):
    t, j = TC.Config(**over), JC.Config(**over)
    for prop in ("multitask", "train_L", "test_L", "keep_prob"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert dataclasses.asdict(t.replace(seed=5)) == \
        dataclasses.asdict(j.replace(seed=5))
    assert hash(t) == hash(TC.Config(**over))          # frozen, hashable
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.seed = 3


@pytest.mark.parametrize("argv", ARGVS)
def test_parse_flags_gives_equal_fields(argv):
    got = dataclasses.asdict(TC.parse_flags(argv))
    want = dataclasses.asdict(JC.parse_flags(argv))
    assert got == want
    assert {k: type(v) for k, v in got.items()} == \
        {k: type(v) for k, v in want.items()}


def test_parser_has_the_same_flags():
    def flags(parser):
        return sorted((s, a.nargs, a.default) for a in parser._actions
                      for s in a.option_strings)
    assert flags(TC.build_parser()) == flags(JC.build_parser())


def test_parse_flags_rejects_an_unknown_flag():
    with pytest.raises(SystemExit):
        TC.parse_flags(["--no_such_flag", "1"])


def test_from_fields_round_trips_and_refuses_unknown_names():
    j = JC.parse_flags(RECIPE)
    t = TC.from_fields(dataclasses.asdict(j))
    assert isinstance(t, TC.Config) and not isinstance(t, JC.Config)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert TC.from_fields({"seed": 4}) == TC.Config(seed=4)
    with pytest.raises(ValueError, match="no_such_field"):
        TC.from_fields({"seed": 4, "no_such_field": 1})


def test_the_port_imports_nothing_of_the_jax_package():
    """A fresh interpreter imports the port's package, every submodule of
    it and ``chip_smoke``; no module of JAX or of the JAX package may have
    been loaded by then."""
    code = """
import importlib, pkgutil, sys
import stochastic_gcn_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert len(names) > 15, names
bad = sorted(m for m in sys.modules
             if m == "stochastic_gcn_tpu" or m.startswith("stochastic_gcn_tpu.")
             or m == "jax" or m.startswith(("jax.", "jaxlib")))
assert not bad, bad
print("imported", len(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "imported" in proc.stdout


def test_no_source_file_of_the_port_names_a_jax_import():
    import re
    pattern = re.compile(r"^\s*(import|from)\s+(stochastic_gcn_tpu|jax)\b",
                         re.M)
    files = [ROOT / "chip_smoke.py",
             *sorted((ROOT / "stochastic_gcn_tpu_torch").rglob("*.py"))]
    assert len(files) > 15
    bad = [str(f.relative_to(ROOT)) for f in files
           if pattern.search(f.read_text())]
    assert not bad, bad
