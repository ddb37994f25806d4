"""The rules the port lives by: it never imports JAX or harp_tpu, its
entry points run on the card unless asked for the CPU, and nothing is
built or launched when a module is imported."""

import ast
import pathlib
import re
import shutil
import subprocess
import sys
import tomllib

import numpy as np
import pytest
import torch

import harp_tpu_torch as HT
from harp_tpu_torch import benchmark as BM
from harp_tpu_torch import mapper as MP
from harp_tpu_torch.elastic import apps as EA
from harp_tpu_torch.examples import kmeans_app as XK
from harp_tpu_torch.examples import longctx_layer as LC
from harp_tpu_torch.examples import mfsgd_app as XM
from harp_tpu_torch.examples import pipeline_moe_app as XP
from harp_tpu_torch.examples import streaming_kmeans_app as XS
from harp_tpu_torch.models import kmeans as KM
from harp_tpu_torch.models import ccd as CD
from harp_tpu_torch.models import kmeans_stream as KS
from harp_tpu_torch.models import lda as LD
from harp_tpu_torch.models import mfsgd as MF
from harp_tpu_torch.models import mlp as ML
from harp_tpu_torch.models import rf as RF
from harp_tpu_torch.models import stats as ST
from harp_tpu_torch.models import subgraph as SG
from harp_tpu_torch.models import svm as SV
from harp_tpu_torch.models import wdamds as WD
from harp_tpu_torch.native import datasource as DS
from harp_tpu_torch.ops import build
from harp_tpu_torch.parallel import mesh as M
from harp_tpu_torch.parallel import pipeline as PP
from harp_tpu_torch.perfmodel import cli as PRC
from harp_tpu_torch.perfmodel import measure as MS
from harp_tpu_torch.plan import cli as PC
from harp_tpu_torch.plan import planner as PL
from harp_tpu_torch.profile import attribution as PA
from harp_tpu_torch.profile import cli as PF
from harp_tpu_torch.serve import bench as SB
from harp_tpu_torch.serve import server as SR

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "harp_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "torch_apps_world.py",
    REPO / "tests" / "torch_world.py",
    REPO / "tests" / "torch_plane_world.py"]
FORBIDDEN = {"jax", "jaxlib", "harp_tpu", "orbax", "ml_dtypes"}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_file_imports_neither_jax_nor_harp_tpu(path):
    assert not FORBIDDEN & set(_imported_roots(path))


def test_no_port_file_imports_orbax():
    """The port's checkpoints are its own format: orbax is a JAX library,
    and no port file (the new checkpoint and fault modules included)
    imports it."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"harp_tpu_torch/utils/checkpoint.py",
            "harp_tpu_torch/utils/fault.py",
            "harp_tpu_torch/models/stats.py"} <= names
    for path in PORT_FILES:
        assert "orbax" not in set(_imported_roots(path)), path


def _port_modules():
    mods = []
    for p in sorted((REPO / "harp_tpu_torch").rglob("*.py")):
        parts = p.relative_to(REPO).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_importing_the_whole_port_loads_no_jax():
    mods = _port_modules()
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'harp_tpu'))\n"
            "assert not bad, bad\n"
            "from harp_tpu_torch.native import build as NB\n"
            "assert NB._LIB is None and not NB._TRIED\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 10 and "harp_tpu_torch.ops.kmeans_kernel" in mods
    assert {"harp_tpu_torch.ops.mfsgd_kernel", "harp_tpu_torch.models.mfsgd",
            "harp_tpu_torch.parallel.rotate", "harp_tpu_torch.ops.lda_kernel",
            "harp_tpu_torch.models.lda", "harp_tpu_torch.ops.svm_kernel",
            "harp_tpu_torch.models.svm", "harp_tpu_torch.ops.wdamds_kernel",
            "harp_tpu_torch.models.wdamds", "harp_tpu_torch.ops.rf_kernel",
            "harp_tpu_torch.models.rf",
            "harp_tpu_torch.models.stats", "harp_tpu_torch.parallel.dispatch",
            "harp_tpu_torch.ops.flash_attention",
            "harp_tpu_torch.ops.ring_attention",
            "harp_tpu_torch.ops.a2a_attention", "harp_tpu_torch.ops.rope",
            "harp_tpu_torch.ops.moe",
            "harp_tpu_torch.examples.longctx_layer",
            "harp_tpu_torch.ingest", "harp_tpu_torch.fileformat",
            "harp_tpu_torch.models.kmeans_stream",
            "harp_tpu_torch.native.build",
            "harp_tpu_torch.native.datasource", "harp_tpu_torch.table",
            "harp_tpu_torch.benchmark", "harp_tpu_torch.models.subgraph",
            "harp_tpu_torch.models.mlp", "harp_tpu_torch.models.ccd",
            "harp_tpu_torch.utils.checkpoint",
            "harp_tpu_torch.utils.fault",
            "harp_tpu_torch.parallel.pipeline", "harp_tpu_torch.serve",
            "harp_tpu_torch.serve.batcher", "harp_tpu_torch.serve.engines",
            "harp_tpu_torch.serve.cache", "harp_tpu_torch.serve.server",
            "harp_tpu_torch.serve.bench", "harp_tpu_torch.serve.transport",
            "harp_tpu_torch.utils.flightrec", "harp_tpu_torch.utils.reqtrace",
            "harp_tpu_torch.utils.perfetto", "harp_tpu_torch.utils.memrec",
            "harp_tpu_torch.health", "harp_tpu_torch.health.sentinel",
            "harp_tpu_torch.health.cli", "harp_tpu_torch.report",
            "harp_tpu_torch.utils.steptrace", "harp_tpu_torch.utils.skew",
            "harp_tpu_torch.schedule", "harp_tpu_torch.mapper",
            "harp_tpu_torch.elastic", "harp_tpu_torch.elastic.ledger",
            "harp_tpu_torch.elastic.rebalance", "harp_tpu_torch.elastic.move",
            "harp_tpu_torch.elastic.apps", "harp_tpu_torch.utils.config",
            "harp_tpu_torch.utils.check", "harp_tpu_torch.utils.roofline",
            "harp_tpu_torch.ops.kernel_registry",
            "harp_tpu_torch.utils.profiling",
            "harp_tpu_torch.analysis.drivers", "harp_tpu_torch.profile",
            "harp_tpu_torch.profile.attribution",
            "harp_tpu_torch.profile.cli", "harp_tpu_torch.perfmodel",
            "harp_tpu_torch.perfmodel.model",
            "harp_tpu_torch.perfmodel.grade",
            "harp_tpu_torch.perfmodel.cli",
            "harp_tpu_torch.perfmodel.measure", "harp_tpu_torch.plan",
            "harp_tpu_torch.plan.topology", "harp_tpu_torch.plan.planner",
            "harp_tpu_torch.plan.cli", "harp_tpu_torch.health.grade",
            "harp_tpu_torch.examples.kmeans_app",
            "harp_tpu_torch.examples.mfsgd_app",
            "harp_tpu_torch.examples.pipeline_moe_app",
            "harp_tpu_torch.examples.streaming_kmeans_app"} <= set(mods)
    assert not build.BUILD_LOG  # importing built nothing


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")


def test_worker_mesh_without_a_device_raises_without_cuda():
    _no_card()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.WorkerMesh()
    assert M.WorkerMesh("cpu").device == torch.device("cpu")


_X = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
_U = np.arange(16, dtype=np.int32) % 4
#: every stats app, called with no device and no mesh
STATS_APPS = {
    "moments": lambda: ST.moments(_X),
    "covariance": lambda: ST.covariance(_X),
    "pca": lambda: ST.pca(_X),
    "naive_bayes": lambda: ST.naive_bayes_fit(np.abs(_X), _U, 4),
    "linear_regression": lambda: ST.linear_regression(_X, _X[:, 0]),
    "ridge_regression": lambda: ST.ridge_regression(_X, _X[:, 0]),
    "tsqr": lambda: ST.tsqr(_X),
    "svd": lambda: ST.svd(_X),
    "als": lambda: ST.als(_U, _U, _X[:, 0], 4, 4, rank=2, iters=1),
}


@pytest.mark.parametrize("entry", ["fit", "benchmark", "cli", "mfsgd-MFSGD",
                                   "mfsgd-benchmark", "mfsgd-cli", "lda-LDA",
                                   "lda-benchmark", "lda-cli", "rf-fit",
                                   "rf-benchmark", "rf-cli", "svm-fit",
                                   "svm-benchmark", "svm-cli", "wdamds-mds",
                                   "wdamds-benchmark", "wdamds-cli",
                                   "longctx-main", "stream-fit",
                                   "stream-local", "stream-files",
                                   "stream-benchmark", "stream-ingest",
                                   "stream-cli", "lda-pushpull-LDA",
                                   "lda-pushpull-benchmark",
                                   "lda-pushpull-cli", "kmeans-hier",
                                   "bench-cli", "subgraph-count",
                                   "subgraph-benchmark", "subgraph-cli",
                                   "mlp-MLPTrainer", "mlp-TPMLPTrainer",
                                   "mlp-mesh_2d", "mlp-benchmark", "mlp-cli",
                                   "mlp-cli-train", "ccd-CCD",
                                   "ccd-benchmark", "ccd-cli",
                                   *(f"stats-{a}" for a in STATS_APPS),
                                   "stats-cli", "wdamds-weights",
                                   "svm-fit_sparse", "kmeans-ckpt",
                                   "serve-Server", "serve-benchmark",
                                   "serve-benchmark_sustained", "serve-cli",
                                   "serve-cli-ckpt", "pipeline_forward",
                                   "pipeline_loss_and_grads",
                                   "mapper-CollectiveApp.run",
                                   "mfsgd_elastic_fit", "lda_elastic_fit",
                                   "kmeans_stream_elastic_fit",
                                   "profile-cli", "profile-capture",
                                   "plan-cli", "plan-ledger_sheet",
                                   "plan-program", "measure-cli",
                                   "app-kmeans", "app-mfsgd",
                                   "app-pipeline_moe",
                                   "app-streaming_kmeans",
                                   "lda-benchmark-pack_cache",
                                   "mfsgd-MFSGD-carry_w",
                                   "mfsgd-benchmark-carry_w",
                                   "api-current_mesh", "api-run_app"])
def test_entry_points_without_a_device_raise_without_cuda(entry, tmp_path):
    _no_card()
    pts = np.zeros((16, 4), np.float32)
    with M.use_mesh(None), pytest.raises(RuntimeError, match="CUDA"):
        if entry.startswith("stats-") and entry != "stats-cli":
            STATS_APPS[entry.removeprefix("stats-")]()
        elif entry == "stats-cli":
            ST.main(["cov", "--n", "16", "--d", "4"])
        elif entry == "wdamds-weights":
            WD.mds(np.zeros((8, 8), np.float32), weights=np.ones((8, 8)))
        elif entry == "svm-fit_sparse":
            SV.SVM().fit_sparse(np.zeros((4, 1), np.int32),
                                np.ones((4, 1), np.float32),
                                np.ones((4, 1), np.float32),
                                np.ones(4, np.float32), 2)
        elif entry == "kmeans-ckpt":
            KM.fit(pts, k=2, iters=1, ckpt_dir=str(tmp_path / "c"))
        elif entry == "serve-Server":
            SR.Server("kmeans", {"centroids": pts[:2]})
        elif entry == "serve-benchmark":
            SB.benchmark(n_requests=1, state_shape={"k": 2, "d": 4})
        elif entry == "serve-benchmark_sustained":
            SB.benchmark_sustained(n_requests=2,
                                   state_shape={"k": 2, "d": 4})
        elif entry == "serve-cli":
            SR.main(["kmeans", "--bench", "--requests", "1"])
        elif entry == "serve-cli-ckpt":
            SR.main(["kmeans", "--ckpt", str(tmp_path / "none")])
        elif entry == "mapper-CollectiveApp.run":
            MP.CollectiveApp().run()
        elif entry == "mfsgd_elastic_fit":
            EA.mfsgd_elastic_fit(np.zeros(4, np.int64), np.zeros(4, np.int64),
                                 np.ones(4, np.float32), n_users=16,
                                 n_items=8)
        elif entry == "lda_elastic_fit":
            EA.lda_elastic_fit(np.zeros(4, np.int64), np.zeros(4, np.int64),
                               n_docs=16, vocab_size=8)
        elif entry == "kmeans_stream_elastic_fit":
            EA.kmeans_stream_elastic_fit(pts, k=2)
        elif entry.startswith("app-"):
            app = {"app-kmeans": XK, "app-mfsgd": XM,
                   "app-pipeline_moe": XP,
                   "app-streaming_kmeans": XS}[entry]
            app.main(["--workdir", str(tmp_path)]
                     if app is XS else [])
        elif entry == "lda-benchmark-pack_cache":
            LD.benchmark(n_docs=16, vocab_size=8, n_topics=4,
                         tokens_per_doc=2, epochs=1,
                         pack_cache=str(tmp_path / "packs"))
        elif entry == "mfsgd-MFSGD-carry_w":
            MF.MFSGD(16, 8, MF.MFSGDConfig(rank=4, algo="dense",
                                           carry_w=True))
        elif entry == "mfsgd-benchmark-carry_w":
            MF.benchmark(n_users=16, n_items=8, nnz=32, rank=4, epochs=1,
                         carry_w=True)
        elif entry == "api-current_mesh":
            HT.current_mesh()
        elif entry == "api-run_app":
            HT.run_app(HT.CollectiveApp)
        elif entry == "plan-cli":
            PC.main(["kmeans.fit"])
        elif entry == "plan-ledger_sheet":
            PL.ledger_sheet("kmeans.fit")
        elif entry == "plan-program":
            PL.plan_program("kmeans.fit")
        elif entry == "measure-cli":
            MS.main(["--overheads", "--out", str(tmp_path / "ev.jsonl")])
        elif entry == "profile-cli":
            PF.main(["kmeans"])
        elif entry == "profile-capture":
            PA.capture("kmeans", reps=1)
        elif entry == "pipeline_forward":
            PP.pipeline_forward(lambda p, h: h, {}, np.zeros((1, 2, 4)))
        elif entry == "pipeline_loss_and_grads":
            PP.pipeline_loss_and_grads(lambda p, h: h * p["a"],
                                       lambda o, t: o.sum(),
                                       {"a": np.ones(4, np.float32)},
                                       np.zeros((1, 2, 4), np.float32),
                                       np.zeros((1, 2, 4), np.float32))
        elif entry == "fit":
            KM.fit(pts, k=2, iters=1)
        elif entry == "benchmark":
            KM.benchmark(n=16, d=4, k=2, iters=1)
        elif entry == "cli":
            KM.main(["--n", "16", "--d", "4", "--k", "2", "--iters", "1"])
        elif entry == "mfsgd-MFSGD":
            MF.MFSGD(16, 8, MF.MFSGDConfig(rank=4))
        elif entry == "mfsgd-benchmark":
            MF.benchmark(n_users=16, n_items=8, nnz=32, rank=4, epochs=1)
        elif entry == "lda-LDA":
            LD.LDA(16, 8, LD.LDAConfig(n_topics=4))
        elif entry == "lda-benchmark":
            LD.benchmark(n_docs=16, vocab_size=8, n_topics=4,
                         tokens_per_doc=2, epochs=1, algo="pallas")
        elif entry == "rf-fit":
            RF.RandomForest(RF.RFConfig(n_trees=2, max_depth=1)).fit(
                pts, np.zeros(16, np.int32))
        elif entry == "rf-benchmark":
            RF.benchmark(n=16, f=4, n_trees=2, max_depth=1)
        elif entry == "rf-cli":
            RF.main(["--n", "16", "--features", "4", "--trees", "2",
                     "--depth", "1"])
        elif entry == "svm-fit":
            SV.SVM().fit(pts, np.ones(16, np.float32))
        elif entry == "svm-benchmark":
            SV.benchmark(n=16, d=4)
        elif entry == "svm-cli":
            SV.main(["--n", "16", "--d", "4"])
        elif entry == "wdamds-mds":
            WD.mds(np.zeros((8, 8), np.float32))
        elif entry == "wdamds-benchmark":
            WD.benchmark(n=8)
        elif entry == "wdamds-cli":
            WD.main(["--n", "8"])
        elif entry == "longctx-main":
            LC.main(["--seq", "16", "--steps", "1"])
        elif entry == "stream-fit":
            KS.fit_streaming(pts, k=2, iters=1)
        elif entry == "stream-local":
            KS.fit_streaming_local(pts, k=2, iters=1)
        elif entry == "stream-files":
            KS.fit_streaming_files(["points.npy"], k=2, iters=1)
        elif entry == "stream-benchmark":
            KS.benchmark_streaming(n=16, d=4, k=2, iters=1)
        elif entry == "stream-ingest":
            KS.benchmark_ingest(pts, k=2, iters=1)
        elif entry == "stream-cli":
            KS.main(["--n", "16", "--d", "4", "--k", "2", "--iters", "1"])
        elif entry == "lda-cli":
            LD.main(["--docs", "16", "--vocab", "8", "--topics", "4",
                     "--tokens-per-doc", "2", "--epochs", "1"])
        elif entry == "lda-pushpull-LDA":
            LD.LDA(16, 8, LD.LDAConfig(n_topics=4, algo="pushpull"))
        elif entry == "lda-pushpull-benchmark":
            LD.benchmark(n_docs=16, vocab_size=8, n_topics=4,
                         tokens_per_doc=2, epochs=1, algo="pushpull")
        elif entry == "lda-pushpull-cli":
            LD.main(["--docs", "16", "--vocab", "8", "--topics", "4",
                     "--tokens-per-doc", "2", "--epochs", "1", "--algo",
                     "pushpull"])
        elif entry == "kmeans-hier":
            KM.fit(pts, k=2, iters=1, psum_schedule="hier")
        elif entry == "bench-cli":
            BM.main(["--verbs", "allreduce", "--max-mb", "1"])
        elif entry == "subgraph-count":
            SG.count_template([(0, 1), (1, 2)], 3,
                              SG.SubgraphConfig(template="u3-path"))
        elif entry == "subgraph-benchmark":
            SG.benchmark(n_vertices=16, avg_degree=2, template="u3-path")
        elif entry == "subgraph-cli":
            SG.main(["--vertices", "16", "--avg-degree", "2", "--template",
                     "u3-path"])
        elif entry == "mlp-MLPTrainer":
            ML.MLPTrainer(ML.MLPConfig(sizes=(4, 8, 2)))
        elif entry == "mlp-TPMLPTrainer":
            ML.TPMLPTrainer(ML.MLPConfig(sizes=(4, 8, 2)))
        elif entry == "mlp-mesh_2d":
            M.mesh_2d(1, 1)
        elif entry == "mlp-benchmark":
            ML.benchmark(n=16, batch=8, steps=1,
                         cfg=ML.MLPConfig(sizes=(784, 8, 10)))
        elif entry == "mlp-cli":
            ML.main(["--n", "16", "--batch", "8", "--steps", "1"])
        elif entry == "mlp-cli-train":
            ML.main(["--n", "16", "--batch", "8", "--train"])
        elif entry == "ccd-CCD":
            CD.CCD(16, 8, CD.CCDConfig(rank=4))
        elif entry == "ccd-benchmark":
            CD.benchmark(n_users=16, n_items=8, nnz=32, rank=4, epochs=1)
        elif entry == "ccd-cli":
            CD.main(["--nnz", "32", "--rank", "4", "--epochs", "1"])
        else:
            MF.main(["--users", "16", "--items", "8", "--nnz", "32",
                     "--rank", "4", "--epochs", "1"])


def test_mesh_and_device_must_agree():
    with pytest.raises(ValueError, match="disagrees"):
        KM.fit(np.zeros((8, 2), np.float32), k=2, iters=1,
               mesh=M.WorkerMesh("cpu"), device="meta")


def test_build_needs_nvcc_and_names_it(tmp_path, monkeypatch):
    if shutil.which("nvcc"):
        pytest.skip("nvcc is present here; the card's tests build for real")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "b")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(["kmeans_partials"])


def test_library_names_follow_the_source_hash():
    assert build.sources() == ["flash_attention", "kmeans_partials",
                               "kmeans_partials_int8",
                               "kmeans_quantize_int8", "lda_cgs_entry",
                               "mfsgd_tile_update",
                               "rf_hist_bins", "svm_pegasos_grad",
                               "wdamds_smacof_bx"]
    a = build.library_path("kmeans_partials")
    b = build.library_path("kmeans_partials_int8")
    assert a.parent == b.parent == build.BUILD_DIR and a != b
    assert a == build.library_path("kmeans_partials")  # stable
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)


def test_library_names_hash_only_the_headers_a_source_includes(tmp_path,
                                                              monkeypatch):
    """An edited header renames (so rebuilds) the libraries whose sources
    include it, directly or through another header, and no other."""
    for name in build.sources():
        want = (["kmeans_tiles.cuh"] if name.startswith("kmeans_partials")
                else [])
        assert [h.name for h in
                build.headers(build.CSRC / f"{name}.cu")] == want
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "a.cu").write_text('#include "outer.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text('#include <cuda_runtime.h>\nint b;\n')
    (tmp_path / "outer.cuh").write_text('  #  include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("// v1\n")
    (tmp_path / "other.cuh").write_text("// v1\n")
    assert build.headers(tmp_path / "a.cu") == [tmp_path / "outer.cuh",
                                                tmp_path / "inner.cuh"]
    assert build.headers(tmp_path / "b.cu") == []
    a, b = build.library_path("a"), build.library_path("b")
    (tmp_path / "other.cuh").write_text("// v2\n")
    assert (build.library_path("a"), build.library_path("b")) == (a, b)
    (tmp_path / "inner.cuh").write_text("// v2\n")
    assert build.library_path("a") != a and build.library_path("b") == b


def test_kernel_sources_ship_as_package_data_and_builds_are_ignored():
    cfg = tomllib.loads((REPO / "pyproject.toml").read_text())
    data = cfg["tool"]["setuptools"]["package-data"]["harp_tpu_torch"]
    assert "csrc/*.cu" in data and "csrc/*.cuh" in data
    native = cfg["tool"]["setuptools"]["package-data"]["harp_tpu_torch.native"]
    assert native == ["*.cpp"]
    assert (REPO / "harp_tpu_torch" / "native" / "loader.cpp").is_file()
    assert "torch" in cfg["project"]["optional-dependencies"]
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert "harp_tpu_torch/_build/" in ignored
    assert "chiprun_out/" in ignored


def _queue1_items() -> dict[int, str]:
    """ROADMAP.md's Queue 1, item number -> the item's text."""
    text = (REPO / "ROADMAP.md").read_text()
    queue = text[text.index("### Queue 1"):text.index("### Queue 2")]
    parts = re.split(r"\n(\d)\. \*\*", queue)
    return {int(parts[i]): parts[i + 1] for i in range(1, len(parts), 2)}


def test_queue1_keeps_its_nine_items():
    """ROADMAP.md's Queue 1 keeps items 1-9 (the rules pin the numbers);
    item 4's two leftovers, ``pack_cache`` and ``carry_w``, are done."""
    items = _queue1_items()
    assert sorted(items) == list(range(1, 10))
    assert "done" in items[4]
    assert "pack_cache" in items[4] and "carry_w" in items[4]


def _raised_texts(path):
    """The string constants inside each ``raise`` of a file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Raise) and node.exc is not None:
            for sub in ast.walk(node.exc):
                if isinstance(sub, ast.Constant) and isinstance(sub.value,
                                                                str):
                    yield sub.value


def test_no_port_module_raises_a_not_ported_message():
    """Every part of the reference is ported or recorded as not ported in
    ROADMAP.md with its reason: no module of the port (nor chip_smoke.py)
    raises a "not ported yet" message or keeps one in a string."""
    hits = []
    for path in PORT_FILES[:-3]:
        for text in _raised_texts(path):
            if "not ported" in text.lower():
                hits.append((path.name, text))
        tree = ast.parse(path.read_text())
        hits += [(path.name, n.value) for n in ast.walk(tree)
                 if isinstance(n, ast.Constant) and isinstance(n.value, str)
                 and "not ported yet" in n.value.lower()]
    assert hits == []
    # the two options that raised so far now run
    assert MF.MFSGDConfig(algo="dense", carry_w=True).carry_w
    assert "pack_cache" in LD.benchmark.__code__.co_varnames


def test_predict_makes_no_tensor_on_any_device(capsys):
    """``predict`` prices offline: in every mode it makes no tensor, on
    the card or the CPU (a torch-function mode sees every factory call and
    op), and it needs no card."""
    from torch.overrides import TorchFunctionMode

    made = []

    class Watch(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor):
                made.append(getattr(func, "__name__", str(func)))
            return out

    with Watch():
        for argv in ([], ["--json"], ["--top", "3"], ["--grade"],
                     ["--topology", "h100_4x8", "--json"]):
            PRC.main(argv + ["--repo", str(REPO)])
    capsys.readouterr()
    assert made == []


#: names of the reference's TPU evidence and rates, which no port module
#: and not chip_smoke.py may name
TPU_EVIDENCE_NAMES = ("V5E", "BENCH_local", "BENCH_r0", "SWEEP_pallas",
                      "FLIP_DECISIONS", "PROFILE_attrib")


@pytest.mark.parametrize("path", PORT_FILES[:-2],
                         ids=[str(p.relative_to(REPO))
                              for p in PORT_FILES[:-2]])
def test_no_port_file_names_tpu_evidence(path):
    text = path.read_text()
    assert not [n for n in TPU_EVIDENCE_NAMES if n in text], path
