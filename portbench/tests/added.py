"""Cells added by files alone, in a copy of the benchmark: the tests' and
the card proof's scratch manifests.

    python -m portbench.tests.added <dst> [--size-gb G] [--chips N]

copies ``BENCHMARK.json``, ``portbench/`` and the program into ``<dst>``
and appends the world smoke's cell there (``WORLD_CELL``, on ``N``
cards, moving ``G`` GB a hop): ``python3 <dst>/portbench/run.py
--workload world_smoke.ring --seed <n> --seconds <s> --trace <0|1>`` then
runs it on the cards."""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

WORLD_CELL = "world_smoke.ring"
WORLD_CONFIG = {"name": "world-smoke", "driver": "world_smoke",
                "elements": 4096, "size_gb": 0.5}
WORLD_TRAFFIC = {"checked_steps": 2, "precision": "exact", "step_hops": 8,
                 "trace_hops": 4,
                 "limits": {"allreduce_mismatch": 0, "rotate_mismatch": 0,
                            "hop_mismatch": 0}}
#: the world smoke at a size a CPU test run holds
WORLD_SMALL = {"config": {"elements": 256, "size_gb": 0.0004}}


def copy(dst: Path, program: bool = False) -> dict:
    """``BENCHMARK.json`` and ``portbench/`` (and the program) into
    ``dst``; returns the manifest."""
    ignore = shutil.ignore_patterns("__pycache__")
    shutil.copytree(ROOT / "portbench", dst / "portbench", ignore=ignore)
    if program:
        shutil.copytree(ROOT / "harp_tpu_torch", dst / "harp_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__",
                                                      "_build"))
    shutil.copy(ROOT / "BENCHMARK.json", dst)
    return json.loads((dst / "BENCHMARK.json").read_text())


def add_cell(root: Path, m: dict, name: str, config: dict, traffic: str,
             traffic_body: dict, chips: int, small: dict | None = None
             ) -> dict:
    """Write the cell's files under ``root`` and append its entries to
    ``m`` (a configuration already in ``m`` is reused)."""
    pb = root / "portbench"
    if config["name"] not in {c["name"] for c in m["configs"]}:
        rel = f"portbench/configs/{config['name']}.json"
        (root / rel).write_text(json.dumps(config))
        m["configs"].append({"name": config["name"],
                             "source": "a test configuration", "file": rel,
                             "reduced": [], "why": "a test"})
    (pb / "traffic" / f"{traffic}.json").write_text(json.dumps(traffic_body))
    if small is not None:
        (pb / "small" / f"{name}.json").write_text(json.dumps(small))
    m["workloads"].append({"name": name, "config": config["name"],
                           "traffic": traffic, "chips": chips,
                           "why": "a test"})
    return m


def add_world_cell(root: Path, m: dict, chips: int, size_gb: float,
                   name: str = WORLD_CELL) -> dict:
    """The world smoke's cell, with its own end-to-end metrics."""
    add_cell(root, m, name, {**WORLD_CONFIG, "size_gb": size_gb},
             "ring_hop", WORLD_TRAFFIC, chips, WORLD_SMALL)
    m["end_to_end"][:0] = [
        {"name": "ring_hop_ms", "unit": "ms", "better": "lower",
         "bound": 0.05, "source": "host_clock", "workloads": [name]},
        {"name": "ring_hop_gb_per_s", "unit": "GB/s", "better": "higher",
         "bound": 0.05, "source": "host_clock", "workloads": [name]}]
    return m


def write(root: Path, m: dict) -> None:
    (root / "BENCHMARK.json").write_text(json.dumps(m, indent=1))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("dst", type=Path)
    p.add_argument("--size-gb", type=float, default=WORLD_CONFIG["size_gb"])
    p.add_argument("--chips", type=int, default=4)
    args = p.parse_args(argv)
    args.dst.mkdir(parents=True, exist_ok=True)
    m = copy(args.dst, program=True)
    write(args.dst, add_world_cell(args.dst, m, args.chips, args.size_gb))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
