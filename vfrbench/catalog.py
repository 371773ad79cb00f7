"""Finding a cell's parts by name, from files.

A cell is ``workloads/<cell>.json``: its configuration's name, its traffic
mix's name, the chips it needs, why it exists and the limits of its check.
A configuration is ``configs/<config>.json`` (whose ``tower`` names
``towers/<tower>.py``, ``mcn`` where it names none), a traffic mix
``traffic/<traffic>.json`` (whose ``driver`` names ``drivers/<driver>.py``)
and a metric ``metrics/<metric>.py``.  Adding a cell, a configuration, a
query tower, a traffic mix or a metric is adding files; nothing here lists
them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)
DEFAULT_TOWER = "mcn"
CODE = ("metrics", "drivers", "towers")


def names(kind: str, root: str = ROOT) -> List[str]:
    """The names of ``kind``'s files (configs, traffic, workloads: .json;
    metrics, drivers, towers: .py), sorted."""
    ext = ".py" if kind in CODE else ".json"
    folder = os.path.join(root, kind)
    if not os.path.isdir(folder):
        return []
    return sorted(f[:-len(ext)] for f in os.listdir(folder)
                  if f.endswith(ext) and not f.startswith("_"))


def load_json(kind: str, name: str, root: str = ROOT) -> Dict:
    path = os.path.join(root, kind, name + ".json")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind} named {name!r} (have {names(kind, root)})")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: str = ROOT) -> ModuleType:
    """``<root>/<kind>/<name>.py`` as a module (a metric's name may hold
    dots, so it is loaded from its path, not imported by name)."""
    path = os.path.join(root, kind, name + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind} named {name!r} (have {names(kind, root)})")
    spec = importlib.util.spec_from_file_location(
        f"vfrbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    cell: Dict
    config: Dict
    traffic: Dict
    root: str = ROOT

    @property
    def limits(self) -> Dict[str, float]:
        return self.cell["limits"]

    @property
    def driver(self) -> str:
        return self.traffic["driver"]

    @property
    def tower(self) -> str:
        return self.config.get("tower", DEFAULT_TOWER)


def cell(name: str, root: str = ROOT) -> Cell:
    c = load_json("workloads", name, root)
    return Cell(name, c, load_json("configs", c["config"], root),
                load_json("traffic", c["traffic"], root), root)


def tower(name: Optional[str] = None, root: str = ROOT) -> ModuleType:
    """The query tower ``towers/<name>.py`` (``mcn`` for None): its sizes,
    its check of a configuration, its seeded weights, its query stages'
    precisions, its plain reference and its encode's work."""
    return load_module("towers", name or DEFAULT_TOWER, root)


def experiment(config: Dict):
    """The port's ``ExperimentConfig`` of a configuration file: its preset
    with every key set of each section the file gives (each field of the
    ``ExperimentConfig`` that is itself a dataclass).  A key that differs
    from the preset and is not listed in ``reduced`` raises: the file is
    the configuration as it is run, and says what it changed."""
    from vfr_tpu_torch.config import get_preset

    cfg = get_preset(config["preset"])
    reduced = set(config.get("reduced", []))
    parts = {}
    for sec in (f.name for f in dataclasses.fields(cfg)):
        base = getattr(cfg, sec)
        if sec not in config or not dataclasses.is_dataclass(base):
            continue
        want = dict(config[sec])
        for key, value in want.items():
            have = getattr(base, key)
            if isinstance(have, tuple):
                value = tuple(value)
                want[key] = value
            if value != have and key not in reduced:
                raise ValueError(
                    f"configuration {config['preset']!r}: {sec}.{key} = "
                    f"{value!r} differs from the preset's {have!r} and is "
                    f"not listed in 'reduced'")
        parts[sec] = dataclasses.replace(base, **want)
    return dataclasses.replace(cfg, **parts)


def metric_modules(root: str = ROOT) -> Dict[str, ModuleType]:
    return {n: load_module("metrics", n, root) for n in names("metrics", root)}


def benchmark() -> Optional[Dict]:
    """``BENCHMARK.json`` at the root of the checkout, or None."""
    path = os.path.join(REPO, "BENCHMARK.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def cell_metrics(bench: Optional[Dict], cell_name: str, traced: bool,
                 available: List[str]) -> List[str]:
    """The metrics a run of ``cell_name`` reports: with ``bench``, its
    end-to-end metrics for an untraced run and its per-layer ones for a
    traced run, each where its ``workloads`` (or, for a per-layer metric
    without them, the cell's report of its ``moves``) takes in the cell;
    without ``bench``, every metric of the kind that has a reader."""
    if bench is None:
        return list(available)
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not traced:
        return [m["name"] for m in e2e]
    reports = {m["name"] for m in e2e}

    def takes(m):
        if "workloads" in m:
            return cell_name in m["workloads"]
        return m["moves"] in reports

    return [m["name"] for m in bench["per_layer"] if takes(m)]
