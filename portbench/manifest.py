"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration, whose file is
`configs[].file`, and a traffic mix, `portbench/traffic/<traffic>.json`.
The traffic file names its entry, `portbench/drivers/<entry>.py`. Each
metric is read by `portbench/metrics/<metric name>.py`. Adding a cell,
a configuration, a traffic mix, an entry or a metric adds files and
manifest entries; no file here changes.

An entry's driver brings `Entry(scene_text, asset_dir, traffic, seed,
device)`, with `setup`, `request`, `install_spans`, `lanes`, `launches`
and `close`, and `check(cell, text, adir, seed, outputs, device)`, the
comparison that decides `correct`: it compares the kept outputs with
the plain reference and returns one dict an output, holding the numbers
that the traffic's `limits` name.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def load_module(path: str, name: str):
    """Import the file at `path` as module `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """portbench/metrics/<name>.py's `read`."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    mod = load_module(path, "portbench_metric_" + name.replace(".", "_"))
    return mod.read


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One cell of the manifest with its configuration, traffic mix, entry
    driver and the metrics it reports (end to end, per layer)."""

    def __init__(self, name: str, root: str = ROOT):
        self.root = root
        man = load_manifest(root)
        self.name = name
        self.spec = _by_name(man["workloads"], name, "workload")
        cfg = _by_name(man["configs"], self.spec["config"], "config")
        with open(os.path.join(root, cfg["file"])) as f:
            self.config = json.load(f)
        bench = os.path.join(root, "portbench")
        with open(os.path.join(bench, "traffic",
                               self.spec["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        self.driver_path = os.path.join(bench, "drivers",
                                        self.traffic["entry"] + ".py")
        self.end_to_end = [m for m in man["end_to_end"]
                           if applies(m, name)]
        self.per_layer = [m for m in man["per_layer"] if applies(m, name)]
        self.chips = int(self.spec["chips"])

    def driver(self):
        """The entry's driver module; one without `Entry` or `check` is
        refused."""
        mod = load_module(self.driver_path,
                          "portbench_driver_" + self.traffic["entry"])
        missing = [k for k in ("Entry", "check")
                   if not callable(getattr(mod, k, None))]
        if missing:
            raise ImportError(f"{self.driver_path}: an entry driver defines "
                              f"Entry and check; it lacks {missing}")
        return mod
