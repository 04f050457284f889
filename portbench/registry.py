"""Finding a cell's parts by name.

``BENCHMARK.json`` names the cells, their configurations and metrics; each
part sits in a file of its own under ``portbench/``, found by its name:

- a configuration: the ``file`` its entry names (``configs/<config>.json``);
- a traffic mix: ``traffic/<mix>.json``, whose ``script`` names
- the script's module, ``scripts/<script>.py`` (the draw, the port's entry,
  the work a fit), and its plain reference, ``reference/<script>.py``;
- a per-layer metric: its reader, ``metrics/<metric>.py``.

A new cell, configuration, mix or metric is new files and new entries;
nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((Path(root) / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix(name: str, base: Path = HERE) -> dict:
    return json.loads((Path(base) / "traffic" / f"{name}.json").read_text())


def module(kind: str, name: str, base: Path = HERE):
    """``<base>/<kind>/<name>.py`` imported as a module of its own."""
    path = Path(base) / kind / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no {kind} file {path}")
    mod_name = f"portbench_{kind}_{name}".replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, cell_name: str) -> bool:
    return "workloads" not in entry or cell_name in entry["workloads"]


def end_to_end(bench: dict, cell_name: str) -> list[dict]:
    return [e for e in bench["end_to_end"] if _applies(e, cell_name)]


def per_layer(bench: dict, cell_name: str) -> list[dict]:
    return [e for e in bench["per_layer"] if _applies(e, cell_name)]


def readers(bench: dict, cell_name: str, base: Path = HERE) -> list:
    """(metric entry, reader module) of every per-layer metric of the
    cell."""
    return [(e, module("metrics", e["name"], base))
            for e in per_layer(bench, cell_name)]
