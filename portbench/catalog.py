"""Finds what BENCHMARK.json names, by name, as files of their own:

- a cell: an entry of BENCHMARK.json's `workloads`;
- a configuration: configs/<name>.json, whose `kind` names the module
  databases/<kind>.py that makes its genomes;
- a traffic mix: traffic/<name>.json, whose `kind` names its generator,
  generators/<kind>.py, and whose `entry` names the timed entry,
  entries/<entry>.py;
- a per-layer metric: metrics/<name>.py, a reader with read(run); an
  end-to-end metric: endtoend/<name>.py, the same.

A later cell, mix, configuration or metric is a new file and a new
entry of BENCHMARK.json; no file here needs an edit for it.
"""

import importlib.util
import json
import os

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)          # the checkout


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return _json(root, "BENCHMARK.json")


def cell(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name):
    return _json(PKG, "configs", f"{name}.json")


def traffic(name):
    return _json(PKG, "traffic", f"{name}.json")


def _module(folder, name):
    path = os.path.join(PKG, folder, f"{name}.py")
    if not os.path.exists(path):
        raise KeyError(f"no {folder}/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{folder}.{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def database_kind(kind):
    return _module("databases", kind)


def generator(kind):
    return _module("generators", kind)


def entry(name):
    return _module("entries", name)


def metric_reader(name):
    return _module("metrics", name)


def endtoend_reader(name):
    return _module("endtoend", name)


def cell_metrics(bench, cell_name, trace):
    """The metrics a run of the cell reports: with trace the per-layer
    ones, else the end-to-end ones, each where its `workloads` (if any)
    lists the cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]
