"""The benchmark harness: reads ``BENCHMARK.json``, finds a cell's files by
name, runs the cell's driver once and prints its result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in files of its own, found by the name in ``BENCHMARK.json``:

- ``configs/<config>.json``: sizes, ``source``, ``reduced``, ``assumed``
  and ``driver``, the module under ``drivers/`` that sets up and drives
  that kind of entry;
- ``traffic/<traffic>.json``: the mix's parameters and the limits of the
  numbers that decide ``correct``;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(rec)`` →
  a number, or None when the traced run holds nothing for it.

A driver is a class ``Driver(ctx)`` with ``setup()``, ``steps(n)`` (the
program's first steps, through the window's own call), ``window(seconds,
trace)``, ``release()``, ``initial()`` (the parameters before the steps)
and ``reference(n, precision)``; see ``drivers/kmeans_stream.py``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
import sys
import time
from pathlib import Path

from portbench import compare

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
#: top-level module names that may not be loaded in a measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "harp_tpu")


class ManifestError(ValueError):
    """``BENCHMARK.json`` or a file it names breaks the contract."""


def _line(text, what) -> None:
    if not isinstance(text, str) or not 1 <= len(text) <= 200 \
            or "\n" in text or "\t" in text:
        raise ManifestError(f"{what}: 1 to 200 characters on one line")


def _name(x, what) -> None:
    if not isinstance(x, str) or not NAME.match(x):
        raise ManifestError(f"{what} {x!r}: a name is a letter, digit or _ "
                            "then up to 63 of letters, digits, _ . -")


def validate(m: dict) -> dict:
    """Check the manifest's names, units and cross-references."""
    for key in ("command", "paths", "run_seconds", "configs", "workloads",
                "end_to_end", "per_layer"):
        if key not in m:
            raise ManifestError(f"BENCHMARK.json lacks {key!r}")
    configs = {}
    for c in m["configs"]:
        _name(c["name"], "config name")
        for r in c["reduced"]:
            _name(r, "reduced key")
        _line(c["why"], f"config {c['name']} why")
        _line(c["source"], f"config {c['name']} source")
        configs[c["name"]] = c
    cells = {}
    for w in m["workloads"]:
        _name(w["name"], "workload name")
        _name(w["traffic"], "traffic name")
        _line(w["why"], f"workload {w['name']} why")
        if w["config"] not in configs:
            raise ManifestError(f"workload {w['name']}: no config "
                                f"{w['config']!r}")
        if w["chips"] not in (1, 4):
            raise ManifestError(f"workload {w['name']}: chips is 1 or 4")
        cells[w["name"]] = w
    metrics = {}
    for kind in ("end_to_end", "per_layer"):
        for x in m[kind]:
            _name(x["name"], f"{kind} metric name")
            if x["name"] in metrics:
                raise ManifestError(f"metric {x['name']} named twice")
            if not isinstance(x["unit"], str) or not UNIT.match(x["unit"]):
                raise ManifestError(f"metric {x['name']}: unit {x['unit']!r}"
                                    " is 1 to 16 of letters, digits, _ / % . -")
            if x["better"] not in ("lower", "higher"):
                raise ManifestError(f"metric {x['name']}: better is lower "
                                    "or higher")
            allowed = SOURCES_E2E if kind == "end_to_end" else SOURCES
            if x["source"] not in allowed:
                raise ManifestError(f"metric {x['name']}: source "
                                    f"{x['source']!r}")
            for c in x.get("workloads", []):
                if c not in cells:
                    raise ManifestError(f"metric {x['name']}: no workload "
                                        f"{c!r}")
            metrics[x["name"]] = x
    e2e = {x["name"] for x in m["end_to_end"]}
    for x in m["per_layer"]:
        _line(x["layer"], f"metric {x['name']} layer")
        if x["moves"] not in e2e:
            raise ManifestError(f"metric {x['name']} moves {x['moves']!r}, "
                                "no end-to-end metric")
    if len(cells) != len(m["workloads"]) or \
            len(configs) != len(m["configs"]):
        raise ManifestError("a workload or config is named twice")
    return m


def load_manifest(root: Path = ROOT) -> dict:
    return validate(json.loads((root / "BENCHMARK.json").read_text()))


def cell_metrics(m: dict, cell: str) -> tuple[list, list]:
    """The end-to-end and per-layer metrics this cell reports."""
    e2e = [x for x in m["end_to_end"]
           if "workloads" not in x or cell in x["workloads"]]
    names = {x["name"] for x in e2e}

    def listed(x):
        if "workloads" in x:
            return cell in x["workloads"]
        return x["moves"] in names

    return e2e, [x for x in m["per_layer"] if listed(x)]


def _load_json(path: Path) -> dict:
    if not path.exists():
        raise ManifestError(f"missing {path}")
    return json.loads(path.read_text())


def load_reader(root: Path, metric: str):
    """``metrics/<metric>.py``'s ``read`` function."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    if not path.exists():
        raise ManifestError(f"per-layer metric {metric} has no reader "
                            f"{path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_driver(name: str):
    _name(name, "driver")
    return importlib.import_module(f"portbench.drivers.{name}").Driver


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's files, the run's arguments and the
    process's start on the host clock."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    device: object
    t_start: float

    def log(self, msg: str) -> None:
        print(f"[portbench {self.cell['name']}] {msg}", file=sys.stderr,
              flush=True)


def resolve(m: dict, root: Path, workload: str) -> tuple[dict, dict, dict]:
    cells = {w["name"]: w for w in m["workloads"]}
    if workload not in cells:
        raise ManifestError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = next(c for c in m["configs"] if c["name"] == cell["config"])
    config = _load_json(root / cfg_entry["file"])
    traffic = _load_json(root / "portbench" / "traffic"
                         / f"{cell['traffic']}.json")
    return cell, config, traffic


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that a measured process may not
    hold, compared whole (``harp_tpu_torch`` is not ``harp_tpu``)."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def device_info(device, chips: int) -> dict:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": chips}
    return {"platform": device.type, "kind": device.type, "count": chips}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: Path = ROOT, device="cuda", overrides: dict | None = None,
             t_start: float | None = None) -> dict:
    """One run of one cell → the result dict (the line's keys, with
    ``checks`` last).  ``overrides`` replace config and traffic entries
    (the CPU tests' small sizes)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    m = load_manifest(root)
    cell, config, traffic = resolve(m, root, workload)
    overrides = overrides or {}
    config = {**config, **overrides.get("config", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    e2e, layer = cell_metrics(m, workload)
    readers = {x["name"]: load_reader(root, x["name"]) for x in layer} \
        if trace else {}
    ctx = Context(cell, config, traffic, int(seed), torch.device(device),
                  t_start)
    drv = load_driver(config["driver"])(ctx)
    drv.setup()
    steps = traffic["checked_steps"]
    prog = drv.steps(steps)
    setup_s = time.perf_counter() - t_start
    out = drv.window(seconds, trace)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"portbench: the measured process holds {bad}")
    out["e2e"]["setup_s"] = setup_s
    drv.release()
    t_ref = time.perf_counter()
    ref = drv.reference(steps, traffic["precision"])
    ctx.log(f"window {out['attempted']} epochs; the reference took "
            f"{time.perf_counter() - t_ref:.1f} s")
    values = compare.numbers(drv.initial(), prog, ref)
    ok, checks = compare.judge(values, traffic["limits"])
    if trace:
        rec = out["record"]
        got = {name: read(rec) for name, read in readers.items()}
        metrics = {x["name"]: {"value": got[x["name"]], "unit": x["unit"]}
                   for x in layer if got[x["name"]] is not None}
    else:
        missing = [x["name"] for x in e2e if x["name"] not in out["e2e"]]
        if missing:
            raise RuntimeError(f"the driver measured no {missing}")
        metrics = {x["name"]: {"value": out["e2e"][x["name"]],
                               "unit": x["unit"]} for x in e2e}
    dev = device_info(ctx.device, cell["chips"])
    dev["memory_peak_bytes"] = out["memory_peak_bytes"]
    result = {"correct": ok, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = out["record"]["trace"]["busy_s"]
        dev["window_s"] = out["record"]["trace"]["window_s"]
        result["breakdown"] = out["breakdown"]
    for name, c in checks.items():
        ctx.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    result["checks"] = checks
    return result
