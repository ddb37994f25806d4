"""The port's public API against harp_tpu's: the same names in
``harp_tpu_torch``, ``harp_tpu_torch.parallel`` and
``harp_tpu_torch.utils`` as in the reference's three ``__all__``s, each the
object its port module defines; importing the package touches no CUDA and
starts no thread; and a Harp-style app written against those names alone
gives numpy's answers on one worker and on a spawned gloo world of four.

No reference name is left out as JAX-only: every one has its port.  As
in the reference, ``parallel.rotate`` is the ``rotate`` module, not the
verb its ``__all__`` lists: the submodule, imported after the verbs,
takes the package's name (the port's own tests import it as a module);
the verb is ``collective.rotate``.
"""

import importlib
import subprocess
import sys

import numpy as np
import pytest

import harp_tpu
import harp_tpu.parallel
import harp_tpu.utils
import harp_tpu_torch
import harp_tpu_torch.parallel
import harp_tpu_torch.utils
from torch_apps_world import (WORLD, api_expected, run_api_cases, run_world,
                              time_limit)

PACKAGES = {"": (harp_tpu, harp_tpu_torch),
            "parallel": (harp_tpu.parallel, harp_tpu_torch.parallel),
            "utils": (harp_tpu.utils, harp_tpu_torch.utils)}

#: reference names with no port, each with its reason in CHANGES.md: none
JAX_ONLY: set = set()

_MESH = "harp_tpu_torch.parallel.mesh"
_COLL = "harp_tpu_torch.parallel.collective"
#: the port module that defines each exported name
SOURCE = {
    "": {**dict.fromkeys(("WorkerMesh", "current_mesh", "set_mesh",
                          "init_distributed"), _MESH),
         "Combiner": _COLL,
         **dict.fromkeys(("KVTable", "Int2IntKVTable", "Int2LongKVTable",
                          "Int2FloatKVTable", "Int2DoubleKVTable",
                          "Long2IntKVTable", "Long2DoubleKVTable",
                          "kv_allreduce", "combine_by_key",
                          "regroup_by_key", "Table", "Partition"),
                         "harp_tpu_torch.table"),
         **dict.fromkeys(("CollectiveApp", "KeyValReader", "run_app"),
                         "harp_tpu_torch.mapper"),
         **dict.fromkeys(("StaticScheduler", "DynamicScheduler", "Task"),
                         "harp_tpu_torch.schedule")},
    "parallel": {**dict.fromkeys(("WorkerMesh", "current_mesh", "set_mesh",
                                  "init_distributed", "mesh_2d"), _MESH),
                 **dict.fromkeys(("pipeline_forward",
                                  "pipeline_loss_and_grads"),
                                 "harp_tpu_torch.parallel.pipeline"),
                 **dict.fromkeys(("resident_chunk_index", "rotate_pipeline"),
                                 "harp_tpu_torch.parallel.rotate"),
                 **dict.fromkeys(("Combiner", "ShardSpec", "allreduce",
                                  "allreduce_hier", "allgather",
                                  "match_reshard_rules", "reshard",
                                  "reshard_reference", "broadcast", "reduce",
                                  "regroup", "regroup_quantized",
                                  "rotate_quantized", "push", "pull",
                                  "barrier"), _COLL)},
    "utils": dict.fromkeys(("device_sync", "Timer"),
                           "harp_tpu_torch.utils.timing"),
}
EXPORTS = [(pkg, name) for pkg, (_, port) in PACKAGES.items()
           for name in port.__all__]


@pytest.mark.parametrize("pkg", list(PACKAGES), ids=lambda p: p or "root")
def test_all_covers_the_reference(pkg):
    ref, port = PACKAGES[pkg]
    assert set(ref.__all__) - JAX_ONLY <= set(port.__all__)
    assert len(port.__all__) == len(set(port.__all__))
    for name in port.__all__:
        assert hasattr(port, name), name


@pytest.mark.parametrize("pkg,name", EXPORTS,
                         ids=[f"{p or 'root'}-{n}" for p, n in EXPORTS])
def test_each_name_is_its_port_module_object(pkg, name):
    port = PACKAGES[pkg][1]
    obj = getattr(port, name)
    if name == "__version__":
        assert obj == harp_tpu.__version__
        return
    if name == "collective":
        assert obj is importlib.import_module(_COLL)
        return
    if (pkg, name) == ("parallel", "rotate"):  # module docstring
        rot = "harp_tpu_torch.parallel.rotate"
        assert obj is importlib.import_module(rot)
        assert isinstance(PACKAGES[pkg][0].rotate, type(sys))
        return
    src = SOURCE[pkg][name]
    assert obj is getattr(importlib.import_module(src), name)
    assert obj.__module__ == src  # defined there, not re-exported
    # the same kind of object as the reference's name
    ref = getattr(PACKAGES[pkg][0], name)
    assert isinstance(obj, type) == isinstance(ref, type)
    assert callable(obj) == callable(ref)


def test_parallel_rotate_is_its_module_as_in_the_reference():
    import harp_tpu_torch.parallel.rotate as rot
    from harp_tpu_torch.parallel import collective, rotate, rotate_pipeline

    assert rotate is rot and rotate_pipeline is rot.rotate_pipeline
    assert collective.rotate.__module__ == _COLL
    assert harp_tpu.parallel.rotate.__name__ == "harp_tpu.parallel.rotate"


_IMPORT_CHECK = """
import sys, threading
import torch
calls = []
for name in ("init", "_lazy_init", "is_available", "device_count",
             "current_device", "set_device", "synchronize",
             "get_device_name", "get_device_properties"):
    orig = getattr(torch.cuda, name)
    def spy(*a, _n=name, _o=orig, **k):
        calls.append(_n)
        return _o(*a, **k)
    setattr(torch.cuda, name, spy)
n_threads = threading.active_count()
import harp_tpu_torch
from harp_tpu_torch import (CollectiveApp, Combiner, run_app, WorkerMesh,
                            Table, StaticScheduler)
import harp_tpu_torch.parallel, harp_tpu_torch.utils
assert calls == [], calls
assert not torch.cuda.is_initialized()
assert threading.active_count() == n_threads, threading.enumerate()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "harp_tpu"))
assert not bad, bad
print("clean")
"""


def test_import_touches_no_cuda_and_starts_no_thread(tmp_path):
    import os

    with time_limit(120):
        out = subprocess.run([sys.executable, "-c", _IMPORT_CHECK],
                             cwd=str(tmp_path), capture_output=True,
                             text=True, timeout=110,
                             env={**os.environ,
                                  "PYTHONPATH": str(harp_tpu_torch.__path__[
                                      0].rsplit("/", 1)[0]),
                                  "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def _check_api(got: dict, rank: int, world: int) -> None:
    want = api_expected(rank, world)
    app = got["app"]
    assert set(app) == set(want) - {"timer"}
    for k, v in app.items():
        if k == "kv":
            assert all(np.array_equal(a, b) for a, b in zip(v, want[k]))
            assert v[1].dtype == np.float64  # Int2Double's values
        elif k == "kv_regroup":
            np.testing.assert_array_equal(v[0], want[k][0])
            assert v[1] == want[k][1]
        else:
            np.testing.assert_array_equal(np.asarray(v), np.asarray(want[k]),
                                          err_msg=k)
    assert got["current_mesh"] == (rank, world)
    assert got["static"] == got["dynamic"] == [i * i for i in range(10)]
    assert got["timer"] == want["timer"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(run_api_cases, tmp_path_factory.mktemp("api"),
                     timeout=120.0)


def test_public_api_app_on_one_worker():
    with time_limit(60):
        _check_api(run_api_cases(0, 1), 0, 1)


@pytest.mark.parametrize("rank", range(WORLD))
def test_public_api_app_on_four_workers(world, rank):
    with time_limit(60):
        _check_api(world[rank], rank, WORLD)


def test_children_never_import_jax(world):
    assert not any(w["_jax_imported"] for w in world)
