"""Finding a cell's parts by name: ``BENCHMARK.json`` at the checkout's
root, ``portbench/held_back.json`` for the cells it leaves out, and the
data files and modules under ``portbench/``."""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def read_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (a name may hold dots,
    as metric names do)."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # configs/<config>.json, with its name
    traffic: dict         # traffic/<traffic>.json, with its name
    workload: dict        # workloads/<cell>.json
    end_to_end: list      # BENCHMARK.json metric entries of this cell
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: str | None = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json, or else of held_back.json,
    with its files and the metrics of the file that names it."""
    have = []
    for bench in (read_json(bench_path
                            or os.path.join(ROOT, "BENCHMARK.json")),
                  read_json(BENCH_DIR, "held_back.json")):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name in cells:
            return cell_of(cells[name], bench)
        have += sorted(cells)
    raise KeyError(f"no workload {name!r} in BENCHMARK.json or "
                   f"held_back.json (have {have})")


def cell_of(w: dict, bench: dict) -> Cell:
    """A cell from its BENCHMARK.json entry ``w`` and the metrics of
    ``bench`` that apply to it."""
    name = w["name"]
    config = {"name": w["config"],
              **read_json(BENCH_DIR, "configs", w["config"] + ".json")}
    traffic = {"name": w["traffic"],
               **read_json(BENCH_DIR, "traffic", w["traffic"] + ".json")}
    workload = read_json(BENCH_DIR, "workloads", name + ".json")
    return Cell(name, int(w["chips"]), config, traffic, workload,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def kernel_groups() -> dict[str, list[str]]:
    """Every ``kernels/*.json`` file's patterns, merged by group."""
    kdir = os.path.join(BENCH_DIR, "kernels")
    groups: dict[str, list[str]] = {}
    for fname in sorted(os.listdir(kdir)):
        if fname.endswith(".json"):
            spec = read_json(kdir, fname)
            groups.setdefault(spec["group"], []).extend(spec["patterns"])
    return groups
