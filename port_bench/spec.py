"""Finding a cell, its configuration, its traffic mix and the per-layer
metrics by name, from files alone.

- ``cells/<cell>.json``: {"config", "traffic", "chips", "why", "check"}:
  the configuration and traffic mix by name, and the correctness check's
  sample size and limits;
- ``configs/<config>.json``: the circuit, its source and its cuts; its
  ``circuit`` names the family module ``circuits/<circuit>.py``, which
  builds it, runs its jobs and checks them;
- ``traffic/<traffic>.json``: the mix the generator reads;
- ``metrics/<metric>.py``: one per-layer metric, a module with ``LAYER``,
  ``UNIT``, ``BETTER``, ``SOURCE``, ``MOVES``, ``ROUTES`` (the solver
  routes of the cells it reads in) and ``read(trace)``.

Adding a cell, a configuration, a mix, a circuit family or a metric is
adding its file.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _load(kind: str, name: str, root: Path) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    return json.loads(path.read_text())


@dataclass(frozen=True)
class Cell:
    name: str
    cell: dict
    config: dict
    traffic: dict


def cell(name: str, root: Path = ROOT) -> Cell:
    c = _load("cells", name, root)
    return Cell(name=name, cell=c, config=_load("configs", c["config"], root),
                traffic=_load("traffic", c["traffic"], root))


def names(kind: str, root: Path = ROOT):
    """Every name of a kind of file ('cells', 'configs', 'traffic',
    'metrics', 'circuits'), sorted."""
    ext = ".py" if kind in ("metrics", "circuits") else ".json"
    return sorted(p.stem for p in (root / kind).glob(f"*{ext}")
                  if not p.stem.startswith("_"))


def _module(kind: str, name: str, root: Path):
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str, root: Path = ROOT):
    """The reader ``metrics/<name>.py`` as a module of this package's
    ``metrics`` (so that it can import the yardstick beside it)."""
    return _module("metrics", name, root)


def metrics(root: Path = ROOT):
    """{name: module} of every per-layer metric reader."""
    return {n: metric(n, root) for n in names("metrics", root)}


def family(c: Cell, root: Path = ROOT):
    """The circuit family module ``circuits/<circuit>.py`` of a cell's
    configuration, as a module of this package's ``circuits``."""
    return _module("circuits", c.config.get("circuit", ""), root)


def metrics_for(c: Cell, root: Path = ROOT):
    """The readers that apply to a cell: those of its solver route."""
    route = c.traffic["solver"]
    return {n: m for n, m in metrics(root).items() if route in m.ROUTES}
