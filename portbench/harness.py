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
and ``reference(n, precision)``; see ``drivers/kmeans_stream.py``.  A
driver that defines ``numbers(initial, steps, reference)`` supplies the
numbers that decide ``correct`` itself (``drivers/lda.py``); every other
driver's are ``compare.numbers``'.  Each driver module also names
``LIMITS``, the numbers its ``correct`` is decided by, and ``FAMILY``, the
kind of entry whose metrics its cells may report (``kmeans``, ``mfsgd``,
``lda``): the benchmark's tests check a cell by them, never by its name.

**A cell of more than one card** (``chips`` > 1; ``world.py``).  The
measuring process is rank 0 on ``cuda:0``: it keeps its host clock, its
start and its profiler.  It spawns ranks 1 to n − 1, each on ``cuda:r``,
and all join one ``torch.distributed`` group over a ``file://`` rendezvous
in a temporary directory (NCCL on cards, gloo on the CPU), within
``world.TIMEOUT_S`` seconds, the limit of any one collective too.  Every
rank builds the same driver, with ``Context.rank`` and ``Context.world``,
and runs the same sequence: ``setup``, ``steps``, ``window``, ``release``,
``reference``, ``numbers``.  A count a driver takes from the host clock
goes through ``ctx.agree(n)``, rank 0's value on every rank, so that the
ranks' collectives match.  Rank 0 alone judges and prints; every rank
profiles its own card in a traced run.  The per-layer metrics read rank
0's record, so a ``device_trace`` metric reads rank 0's card; the line's
``busy_s`` and ``window_s`` are the means over the ranks' slices, and
``memory_peak_bytes`` the fullest card's peak.  Each worker reports its
peak, its slice and the forbidden modules it holds; a forbidden module on
any rank fails the run.  A rank that raises or dies fails the run with its
traceback on standard error within ``world.FAIL_S`` seconds; the group is
then torn down and every worker ended.  A cell of one card takes the path
it always took: no process is spawned and no group is made.
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
    """What a driver gets: the cell's files, the run's arguments, the
    process's start on the host clock, and its rank in a world of
    ``world`` processes (one a card)."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    device: object
    t_start: float
    rank: int = 0
    world: int = 1

    def log(self, msg: str) -> None:
        who = self.cell["name"] + (f" rank {self.rank}" if self.world > 1
                                   else "")
        print(f"[portbench {who}] {msg}", file=sys.stderr, flush=True)

    def agree(self, n: int) -> int:
        """Rank 0's ``n`` on every rank (a broadcast; ``n`` itself on one
        card): a count taken from the host clock, so that every rank runs
        as many collectives."""
        if self.world == 1:
            return n
        import torch
        import torch.distributed as dist

        t = torch.tensor([n], dtype=torch.int64, device=self.device)
        dist.broadcast(t, 0)
        return int(t.item())


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


def cell_files(m: dict, root: Path, workload: str,
               overrides: dict | None = None) -> tuple[dict, dict, dict]:
    """:func:`resolve`, with ``overrides``' config and traffic entries laid
    over the configuration and the mix."""
    cell, config, traffic = resolve(m, root, workload)
    overrides = overrides or {}
    return (cell, {**config, **overrides.get("config", {})},
            {**traffic, **overrides.get("traffic", {})})


def drive(ctx: Context, seconds: float, trace: bool) -> tuple[dict, dict]:
    """One rank's run: set-up and the checked steps, the window, release,
    the reference and the numbers → (the window's output with
    ``setup_s``, the numbers that decide ``correct``)."""
    drv = load_driver(ctx.config["driver"])(ctx)
    drv.setup()
    steps = ctx.traffic["checked_steps"]
    prog = drv.steps(steps)
    setup_s = time.perf_counter() - ctx.t_start
    out = drv.window(seconds, trace)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"portbench: the measured process holds {bad}")
    out["e2e"]["setup_s"] = setup_s
    drv.release()
    t_ref = time.perf_counter()
    ref = drv.reference(steps, ctx.traffic["precision"])
    ctx.log(f"window {out['attempted']} epochs; the reference took "
            f"{time.perf_counter() - t_ref:.1f} s")
    numbers = getattr(drv, "numbers", compare.numbers)
    return out, numbers(drv.initial(), prog, ref)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: Path = ROOT, device="cuda", overrides: dict | None = None,
             t_start: float | None = None) -> dict:
    """One run of one cell → the result dict (the line's keys, with
    ``checks`` last).  ``overrides`` replace config and traffic entries
    (the CPU tests' small sizes).  A cell of more than one card runs as a
    process world (module docstring)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    m = load_manifest(root)
    cell, config, traffic = cell_files(m, root, workload, overrides)
    e2e, layer = cell_metrics(m, workload)
    readers = {x["name"]: load_reader(root, x["name"]) for x in layer} \
        if trace else {}
    ctx = Context(cell, config, traffic, int(seed), torch.device(device),
                  t_start, world=cell["chips"])
    if cell["chips"] == 1:
        out, values = drive(ctx, seconds, trace)
    else:
        from portbench import world

        out, values = world.run(ctx, seconds, trace, root=root,
                                overrides=overrides)
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
        # a world's: the means over its ranks' slices
        sliced = out.get("world_slice", out["record"]["trace"])
        dev["busy_s"] = sliced["busy_s"]
        dev["window_s"] = sliced["window_s"]
        result["breakdown"] = out["breakdown"]
    for name, c in checks.items():
        ctx.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    result["checks"] = checks
    return result
