"""Launcher: ``python -m harp_tpu_torch <app> [app args...]``.

    python -m harp_tpu_torch kmeans --bench --quantize int8
    python -m harp_tpu_torch kmeans --n 4096 --d 16 --k 8 --device cpu
    python -m harp_tpu_torch --list
"""

from __future__ import annotations

import sys
from importlib import import_module

APPS = {
    "kmeans": ("harp_tpu_torch.models.kmeans",
               "KMeans Lloyd iterations (allreduce)"),
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "--list"):
        print(__doc__)
        for name, (_, desc) in APPS.items():
            print(f"  {name:10s} {desc}")
        return 0
    app, rest = argv[0], argv[1:]
    if app not in APPS:
        print(f"unknown app {app!r}; known: {', '.join(APPS)}",
              file=sys.stderr)
        return 2
    return import_module(APPS[app][0]).main(rest) or 0


if __name__ == "__main__":
    sys.exit(main())
