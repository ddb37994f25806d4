"""Launcher: ``python -m harp_tpu_torch <app> [app args...]``.

    python -m harp_tpu_torch kmeans --bench --quantize int8
    python -m harp_tpu_torch kmeans --n 4096 --d 16 --k 8 --device cpu
    python -m harp_tpu_torch kmeans-stream --n 1000000000 --quantize int8
    python -m harp_tpu_torch kmeans-stream --n 65536 --d 16 --k 8 --device cpu
    python -m harp_tpu_torch mfsgd --algo pallas --epochs 3
    python -m harp_tpu_torch mfsgd --users 2000 --items 500 --nnz 50000 --device cpu
    python -m harp_tpu_torch lda --algo pallas
    python -m harp_tpu_torch lda --docs 96 --vocab 64 --topics 8 --d-tile 16 --w-tile 16 --entry-cap 64 --algo pallas --device cpu
    python -m harp_tpu_torch lda --algo pushpull
    python -m harp_tpu_torch lda --algo pushpull --docs 96 --vocab 64 --topics 8 --device cpu
    python -m harp_tpu_torch rf --hist-algo pallas
    python -m harp_tpu_torch rf --n 2000 --features 8 --trees 4 --depth 3 --hist-algo pallas --device cpu
    python -m harp_tpu_torch svm --algo pallas
    python -m harp_tpu_torch svm --n 2000 --d 16 --algo pallas --device cpu
    python -m harp_tpu_torch wdamds --algo pallas
    python -m harp_tpu_torch wdamds --n 128 --algo pallas --device cpu
    python -m harp_tpu_torch subgraph --vertices 1000000 --avg-degree 8 --max-degree 16 --graph powerlaw
    python -m harp_tpu_torch subgraph --vertices 2000 --template u5-tree --device cpu
    python -m harp_tpu_torch mlp --train
    python -m harp_tpu_torch mlp --n 2048 --batch 512 --steps 5 --device cpu
    python -m harp_tpu_torch ccd
    python -m harp_tpu_torch ccd --nnz 50000 --rank 8 --device cpu
    python -m harp_tpu_torch stats pca
    python -m harp_tpu_torch stats als --n 20000 --device cpu
    python -m harp_tpu_torch bench --max-mb 256
    python -m harp_tpu_torch bench --device cpu
    python -m harp_tpu_torch serve kmeans --bench
    python -m harp_tpu_torch serve kmeans --bench --device cpu
    python -m harp_tpu_torch serve kmeans --ckpt DIR --device cpu [--tcp 0]
    python -m harp_tpu_torch trace run.jsonl [--perfetto trace.json]
    python -m harp_tpu_torch memory run.jsonl [--json]
    python -m harp_tpu_torch report --telemetry run.jsonl [--metrics m.jsonl]
    python -m harp_tpu_torch timeline run.jsonl [--perfetto trace.json]
    python -m harp_tpu_torch health run.jsonl [--json]
    python -m harp_tpu_torch profile --all --json
    python -m harp_tpu_torch profile kmeans --device cpu
    python -m harp_tpu_torch plan --device cpu [--topology h100_4x8] [--json]
    python -m harp_tpu_torch predict [--json | --top 5 | --grade]
    python -m harp_tpu_torch health --grade-model [--repo DIR]
    python -m harp_tpu_torch lint --device cpu [--json] [--layer ast]
    python -m harp_tpu_torch --list
"""

from __future__ import annotations

import sys
from importlib import import_module

APPS = {
    "kmeans": ("harp_tpu_torch.models.kmeans",
               "KMeans Lloyd iterations (allreduce)"),
    "kmeans-stream": ("harp_tpu_torch.models.kmeans_stream",
                      "streaming (blocked-epoch) KMeans, the 1B-point path"),
    "mfsgd": ("harp_tpu_torch.models.mfsgd",
              "MF-SGD with model rotation (rotate)"),
    "lda": ("harp_tpu_torch.models.lda",
            "LDA-CGS: model rotation, or push/pull of a row-sharded table"),
    "rf": ("harp_tpu_torch.models.rf",
           "Random Forest, level-wise histograms (allgather)"),
    "svm": ("harp_tpu_torch.models.svm",
            "linear SVM with a support-vector exchange (reshard)"),
    "wdamds": ("harp_tpu_torch.models.wdamds",
               "WDA-MDS by SMACOF (reshard + stress allreduce)"),
    "subgraph": ("harp_tpu_torch.models.subgraph",
                 "subgraph counting by color coding (allgather a DP level)"),
    "mlp": ("harp_tpu_torch.models.mlp",
            "MLP, data-parallel gradient allreduce (or ZeRO-1, or TP)"),
    "ccd": ("harp_tpu_torch.models.ccd",
            "CCD++ matrix factorization (a column allreduce)"),
    "stats": ("harp_tpu_torch.models.stats",
              "classic analytics: moments, cov, PCA, NB, regression, QR, "
              "SVD, ALS"),
    "bench": ("harp_tpu_torch.benchmark",
              "collective micro-benchmarks (edu.iu.benchmark)"),
    "serve": ("harp_tpu_torch.serve.server",
              "resident-model inference server (JSONL over stdio or TCP)"),
    "trace": ("harp_tpu_torch.utils.reqtrace",
              "request timeline: validate/summarize a telemetry export"),
    "memory": ("harp_tpu_torch.utils.memrec",
               "device-memory ledger: validate/summarize an export"),
    "report": ("harp_tpu_torch.report",
               "run report: merge a telemetry export (+ metrics JSONL)"),
    "timeline": ("harp_tpu_torch.utils.steptrace",
                 "superstep timeline: validate/summarize an export"),
    "health": ("harp_tpu_torch.health.cli",
               "health sentinel, offline: summarize an export's findings"),
    "profile": ("harp_tpu_torch.profile.cli",
                "wall attribution: one driver run per app, op → bucket"),
    "plan": ("harp_tpu_torch.plan.cli",
             "collective planner over the drivers' CommLedger sheets"),
    "predict": ("harp_tpu_torch.perfmodel.cli",
                "offline cost model on the H100, graded against its rows"),
    "lint": ("harp_tpu_torch.analysis.cli",
             "harplint: AST lints, thread graph, kernels, wire audit"),
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
