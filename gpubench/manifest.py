"""``BENCHMARK.json`` and the files it names, found by name.

A cell (a workload) names a configuration and a traffic mix; the
configuration's file is its entry's ``file``, the traffic mix is
``gpubench/traffic/<traffic>.json``, the correctness limits of the cell
``gpubench/limits/<workload>.json`` and a per-layer metric's reader
``gpubench/metrics/<metric>/reader.py``.  Adding any of them adds files
and edits none.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int


class Bench:
    """The benchmark rooted at ``root`` (the checkout)."""

    def __init__(self, root):
        self.root = Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self.home = self.root / "gpubench"

    def cell(self, name: str) -> Cell:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return Cell(w["name"], w["config"], w["traffic"],
                            int(w["chips"]))
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.home / "traffic" / f"{name}.json")
                          .read_text())

    def limits(self, workload: str) -> dict:
        return json.loads((self.home / "limits" / f"{workload}.json")
                          .read_text())

    @staticmethod
    def _applies(metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.doc["end_to_end"]
                if self._applies(m, cell)]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics of ``cell``: those listing it, and those
        without a list whose end-to-end metric the cell reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.doc["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    def metric_dir(self, name: str) -> Path:
        return self.home / "metrics" / name
