"""What ``BENCHMARK.json`` says about one cell, found by name.

A cell names a configuration and a traffic mix; the harness finds the
configuration's file through ``configs[].file``, the mix in
``portbench/traffic/<traffic>.json`` and its generator in
``portbench/traffic/<generator>.py`` (the mix's ``"generator"``, by default
``circle``), the limits of its correctness check in
``portbench/limits/<cell>.json`` and each metric's reader in
``portbench/metrics/<metric>.py``. A new cell, mix or metric is a new file
and a new entry in ``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Metric:
  name: str
  unit: str
  read: Callable


@dataclasses.dataclass
class Generator:
  """A traffic mix's code (``traffic/circle.py`` says what each does)."""
  poses: Callable
  world: Callable
  frames: Callable
  surface_z: Callable


@dataclasses.dataclass
class Cell:
  name: str
  chips: int
  config: dict
  traffic: dict
  generator: Generator
  limits: Dict[str, float]
  end_to_end: List[Metric]
  per_layer: List[Metric]


def _for_cell(entry: dict, cell: str) -> bool:
  return "workloads" not in entry or cell in entry["workloads"]


def _load_module(path: Path, name: str):
  """The module of a file under ``portbench`` (a name may hold dots, so the
  file is loaded by its path)."""
  spec = importlib.util.spec_from_file_location(
      f"portbench_{name.replace('.', '_')}", path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def load_reader(root: Path, name: str) -> Callable:
  """``read(record)`` of ``portbench/metrics/<name>.py``."""
  return _load_module(root / "portbench" / "metrics" / f"{name}.py",
                      f"metric_{name}").read


def load_generator(root: Path, name: str) -> Generator:
  """The generator ``portbench/traffic/<name>.py``; the heightmap world,
  its device renderer and its surface where the module has none."""
  from portbench.harness import render
  from portbench.reference import scene
  module = _load_module(root / "portbench" / "traffic" / f"{name}.py",
                        f"traffic_{name}")
  return Generator(
      poses=module.poses,
      world=getattr(module, "world", scene.world_of),
      frames=getattr(module, "frames", render.render_frames),
      surface_z=getattr(module, "surface_z", scene.heightmap_z))


def load_json(path: Path) -> dict:
  with open(path) as f:
    return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
  bench = load_json(root / "BENCHMARK.json")
  cells = {w["name"]: w for w in bench["workloads"]}
  if name not in cells:
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                     f"(have: {', '.join(sorted(cells))})")
  w = cells[name]
  configs = {c["name"]: c for c in bench["configs"]}
  config = load_json(root / configs[w["config"]]["file"])
  traffic = load_json(root / "portbench" / "traffic" / f"{w['traffic']}.json")
  limits = load_json(root / "portbench" / "limits" / f"{name}.json")
  metrics = {
      kind: [Metric(m["name"], m["unit"], load_reader(root, m["name"]))
             for m in bench[kind] if _for_cell(m, name)]
      for kind in ("end_to_end", "per_layer")}
  generator = load_generator(root, traffic.get("generator", "circle"))
  return Cell(name, int(w["chips"]), config, traffic, generator,
              {k: float(v) for k, v in limits["limits"].items()},
              metrics["end_to_end"], metrics["per_layer"])
