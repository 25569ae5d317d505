"""The benchmark's manifest and the files it names.

``BENCHMARK.json`` (at the root of the checkout) lists the configurations,
the cells and the metrics. Each piece is a file of its own under this
folder, found by name:

  * ``configs/<config>.json``: a configuration (the manifest names its file);
  * ``traffic/<traffic>.json``: a traffic mix, read by the driver it names;
  * ``drivers/<driver>.py``: one per kind of traffic, ``run(cell)``;
  * ``workloads/<cell>.json``: what belongs to one cell alone: the limits of
    its correctness check, and the settings of that check (``judge``);
  * ``metrics/<metric>.py``: one reader per metric, ``read(run)``.

Which metrics a cell reports is the manifest's: a metric with a
``workloads`` list is reported in those cells, one without in every cell.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the Python file ``path`` under the module name ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    kind: str  # "end_to_end" or "per_layer"
    reader: Callable[[Any], Optional[float]]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    judge: Dict[str, Any]
    end_to_end: List[Metric]
    per_layer: List[Metric]

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def manifest(root: Path = ROOT) -> Dict[str, Any]:
    return _json(root / "BENCHMARK.json")


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_metric(entry: Dict[str, Any], kind: str) -> Metric:
    mod = load_module(HERE / "metrics" / f"{entry['name']}.py",
                      "vosbench_metric_" + entry["name"].replace(".", "_").replace("-", "_"))
    return Metric(entry["name"], entry["unit"], kind, mod.read)


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the manifest with its configuration, traffic,
    limits and metrics loaded; KeyError for a name the manifest lacks."""
    m = manifest(root)
    entry = next((w for w in m["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in m["configs"] if c["name"] == entry["config"])
    own = _json(HERE / "workloads" / f"{name}.json")
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=_json(root / conf["file"]),
        traffic=_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        limits=own.get("limits", {}), judge=own.get("judge", {}),
        end_to_end=[load_metric(e, "end_to_end") for e in m["end_to_end"]
                    if _applies(e, name)],
        per_layer=[load_metric(e, "per_layer") for e in m["per_layer"] if _applies(e, name)],
    )


def driver(name: str):
    return load_module(HERE / "drivers" / f"{name}.py", f"vosbench_driver_{name}")
