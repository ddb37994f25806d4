"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  The last line on standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last: each
number compared with its limit); the same checks are the last lines on
standard error.  Exits non-zero, printing no result, when there is no CUDA
card (or fewer than the cell asks for), when the program is not in this
checkout, or when the process holds JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _fail(msg: str, code: int = 2) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # build and kernel caches at fixed paths inside the checkout
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench import harness

    m = harness.load_manifest(ROOT)
    cell = next((w for w in m["workloads"] if w["name"] == args.workload),
                None)
    if cell is None:
        _fail(f"no workload {args.workload!r} in BENCHMARK.json")
    if not torch.cuda.is_available():
        _fail("no CUDA device: this benchmark measures the card only")
    if torch.cuda.device_count() < cell["chips"]:
        _fail(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present")
    try:
        import harp_tpu_torch
    except ImportError as e:
        _fail(f"the program is not in this checkout ({e})")
    if not Path(harp_tpu_torch.__file__).resolve().is_relative_to(ROOT):
        _fail(f"harp_tpu_torch comes from {harp_tpu_torch.__file__}, not "
              f"from this checkout")
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), root=ROOT, device="cuda:0",
                              t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        _fail(f"the process holds {bad} once the window has closed", 3)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
