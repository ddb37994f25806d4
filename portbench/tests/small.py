"""Each cell at a size a CPU test run holds: the same drivers, references
and readers, with the configuration's and the mix's sizes cut.

A cell's cut is ``portbench/small/<cell>.json``: ``config`` and
``traffic`` entries laid over its files (``harness.run_cell``'s
``overrides``), and a ``why`` where the sizes need one.  A new cell brings
its CPU dry run as one new file there."""

from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def load(root: Path = ROOT) -> dict:
    """Every cell's cut under ``root``, by cell name."""
    return {p.name[:-len(".json")]: json.loads(p.read_text())
            for p in sorted((root / "portbench" / "small").glob("*.json"))}


SMALL = load()
KMEANS = SMALL["kmeans_stream.int8.n1e9"]
MFSGD = SMALL["mfsgd.ml20m.zipf"]
LDA = SMALL["lda.enwiki1m.zipf"]
