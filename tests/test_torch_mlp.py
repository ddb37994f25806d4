"""The port's MLP trainers against harp_tpu's, on the same data and state.

Every DP case (sgd, momentum and adam × the f32, bf16 and int8 gradient
wires × replicated or ZeRO-1 optimizer state, and bf16 activations) starts
from the reference's params and optimizer state after two warm steps,
carried over by ``convert.mlp_params_from_numpy``, and takes five
``train_batch`` steps on one worker (in this process, against a one-device
mesh) and on four (a spawned gloo world, against a four-device mesh).

Tolerances:

- f32 activations on the f32 wire: losses, accuracies and params within
  rtol 1e-5 / atol 1e-6 (f32 summation order: the gradient sums and the
  reductions add in another order).  On one worker a narrow wire rounds
  the same values on both sides, so this holds for it too.
- Otherwise the params are held to a fraction of the largest distance a
  param moved over the five steps, and the losses to a relative bound:
  - int8 wire on four workers: a contribution whose f32 value sits at a
    rounding boundary may land one int8 step (1/127 of its leaf's |max|)
    apart, so 1/127; losses rtol 1e-5.
  - bf16 wire on four workers: the sum accumulates in bf16, one rounding
    of 2^-9 an addition, so (nw − 1) · 2^-9; losses rtol 2^-8.
  - bf16 activations (``half_precision``): the packages round the bf16
    products and their gradients in different places, and a batch sum of
    bf16 products that cancel carries more than one bf16 step of its own
    size, so 2^-5 (measured: at most 1.0e-2); losses rtol 2^-7 (two bf16
    steps).
  - adam divides by sqrt(nu), which turns the bf16 noise of a tiny
    gradient into a full-size step, so under either bf16 only its losses
    are held.
"""

import jax
import numpy as np
import pytest
import torch

from harp_tpu.models import mlp as JM
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu.parallel.mesh import mesh_2d as j_mesh_2d
from harp_tpu_torch import convert
from harp_tpu_torch.models import mlp as M
from harp_tpu_torch.parallel import mesh as PM
from harp_tpu_torch.utils import telemetry
from torch_world import (MLP_CASES, MLP_SIZES, MLP_STEPS, WORLD,
                         mlp_config_kwargs, mlp_data, run_mlp_cases,
                         run_world)

WARM = 2


def _np_params(params):
    return [{k: np.asarray(v).copy() for k, v in p.items()} for p in params]


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a).copy(), tree)


def ref_state(tr) -> dict:
    """The reference trainer's params and optax state as numpy, in the
    layout ``convert.mlp_params_from_numpy`` takes."""
    inner = tr.opt_state[0]
    if hasattr(inner, "trace"):
        opt = {"trace": _np_tree(inner.trace)}
    elif hasattr(inner, "mu"):
        opt = {"count": np.asarray(inner.count), "mu": _np_tree(inner.mu),
               "nu": _np_tree(inner.nu)}
    else:
        opt = {}
    return {"params": _np_params(tr.params), "opt_state": opt}


def _reference_run(jm, kw):
    """(state after WARM steps, then MLP_STEPS more: history, params and
    the final state)."""
    x, y = mlp_data()
    tr = JM.MLPTrainer(JM.MLPConfig(**mlp_config_kwargs(kw)), jm, seed=0)
    for _ in range(WARM):
        tr.train_batch(x, y)
    start = ref_state(tr)
    hist = [tr.train_batch(x, y) for _ in range(MLP_STEPS)]
    return start, {"hist": hist, **ref_state(tr)}


def _flat(params) -> np.ndarray:
    return np.concatenate([np.asarray(p[k]).ravel() for p in params
                           for k in sorted(p)])


@pytest.fixture(scope="module")
def jmesh1():
    return JaxMesh(jax.devices()[:1])


@pytest.fixture(scope="module")
def jmesh4():
    return JaxMesh(jax.devices()[:WORLD])


@pytest.fixture(scope="module")
def fit_params(jmesh1):
    tr = JM.MLPTrainer(JM.MLPConfig(**mlp_config_kwargs({})), jmesh1,
                       seed=0)
    return _np_params(tr.params)


@pytest.fixture(scope="module")
def ref4(jmesh4):
    return {cid: _reference_run(jmesh4, kw) for cid, kw in MLP_CASES}


@pytest.fixture(scope="module")
def world(tmp_path_factory, ref4, fit_params):
    states = {cid: ref4[cid][0] for cid, _ in MLP_CASES}
    return run_world(run_mlp_cases, tmp_path_factory.mktemp("mlp"), states,
                     fit_params)


def _check_case(got, ref, kw, n_workers, start):
    hl, hr = np.asarray(got["hist"]), np.asarray(ref["hist"])
    gp, rp = _flat(got["params"]), _flat(ref["params"])
    moved = np.abs(rp - _flat(start["params"])).max()
    wire = kw.get("grad_wire", "f32") if n_workers > 1 else "f32"
    if kw.get("half_precision"):
        loss_rtol, frac = 2 ** -7, 2 ** -5
    elif wire == "bf16":
        loss_rtol, frac = 2 ** -8, (n_workers - 1) * 2 ** -9
    elif wire == "int8":
        loss_rtol, frac = 1e-5, 1 / 127
    else:
        np.testing.assert_allclose(hl, hr, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gp, rp, rtol=1e-5, atol=1e-6)
        return
    np.testing.assert_allclose(hl[:, 0], hr[:, 0], rtol=loss_rtol)
    if wire == "int8" or kw["optimizer"] != "adam":
        assert np.abs(gp - rp).max() <= frac * moved


# ---- one worker ------------------------------------------------------------------

@pytest.mark.parametrize("cid,kw", MLP_CASES, ids=[c for c, _ in MLP_CASES])
def test_one_worker_steps_match_reference(jmesh1, cid, kw):
    start, ref = _reference_run(jmesh1, kw)
    x, y = mlp_data()
    tr = M.MLPTrainer(M.MLPConfig(**mlp_config_kwargs(kw)), device="cpu",
                      state=convert.mlp_params_from_numpy(start, "cpu"))
    hist = [tr.train_batch(x, y) for _ in range(MLP_STEPS)]
    got = {"hist": hist, "params": [{k: v.numpy() for k, v in p.items()}
                                    for p in tr.params]}
    _check_case(got, ref, kw, 1, start)
    assert all(p[k].dtype == torch.float32 for p in tr.params for k in p)


# ---- four workers ---------------------------------------------------------------

@pytest.mark.parametrize("cid,kw", MLP_CASES, ids=[c for c, _ in MLP_CASES])
def test_four_workers_steps_match_reference(world, ref4, cid, kw):
    start, ref = ref4[cid]
    for w in world:
        _check_case(w[cid], ref, kw, WORLD, start)
        # every worker holds the same replicated params
        np.testing.assert_array_equal(_flat(w[cid]["params"]),
                                      _flat(world[0][cid]["params"]))


@pytest.mark.parametrize("cid", ["sgd-f32-dp", "adam-f32-zero1"])
def test_four_workers_equal_one_worker_on_the_full_batch(world, ref4, cid):
    """The averaged gradient of four 16-row shards is the full 64-row
    batch's (the reference's DP-equals-full-batch test, tolerance rtol
    2e-5 / atol 1e-6 as there)."""
    kw = dict(MLP_CASES)[cid]
    x, y = mlp_data()
    tr = M.MLPTrainer(M.MLPConfig(**mlp_config_kwargs(kw)), device="cpu",
                      state=convert.mlp_params_from_numpy(
                          {"params": ref4[cid][0]["params"]}, "cpu"))
    hist = [tr.train_batch(x, y) for _ in range(MLP_STEPS)]
    got = world[0][f"full-{cid}"]
    np.testing.assert_allclose(got["hist"], hist, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(_flat(got["params"]), _flat(
        [{k: v.numpy() for k, v in p.items()} for p in tr.params]),
        rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_zero1_state_is_sharded_like_the_reference(world, ref4, opt):
    """Each worker keeps its [L] slice of the optimizer state; the slices
    laid end to end are the reference's [nw·L] sharded state."""
    cid = f"{opt}-f32-zero1"
    L = world[0]["zero1_len"]
    keys = ["trace"] if opt == "momentum" else ["mu", "nu"]
    for key in keys:
        slices = [w[cid]["opt_state"][key] for w in world]
        assert all(len(s) == 1 and s[0].shape == (L,) for s in slices)
        whole = np.concatenate([s[0] for s in slices])
        np.testing.assert_allclose(whole, ref4[cid][1]["opt_state"][key],
                                   rtol=1e-5, atol=1e-7)
    if opt == "adam":
        assert all(int(w[cid]["opt_state"]["count"]) == WARM + MLP_STEPS
                   for w in world)


def test_ledger_sheets_per_step(world):
    """Bytes a worker puts on the wire a step, from the parameter count P
    and the slice length L: the replicated f32 wire one AVG allreduce of
    the gradients, loss and acc; bf16/int8 the quantized allreduce at the
    wire's width plus the exact loss/acc (int8 also its stacked |max|);
    ZeRO-1 a push of [nw·L] and a pull of [L]."""
    P = M.param_count(M.MLPConfig(sizes=MLP_SIZES))
    L = world[0]["zero1_len"]
    n_leaves = 2 * (len(MLP_SIZES) - 1)
    for w in world:
        led = {(r["verb"], r["wire_dtype"]): r
               for r in w["sgd-f32-dp"]["ledger"]["verbs"]}
        assert led[("allreduce", None)]["payload_bytes"] == MLP_STEPS * (
            4 * P + 8)
        led = {(r["verb"], r["wire_dtype"]): r
               for r in w["sgd-int8-dp"]["ledger"]["verbs"]}
        assert led[("allreduce_quantized", "int8")]["payload_bytes"] == (
            MLP_STEPS * P)
        led = {(r["verb"], r["combiner"]): r
               for r in w["sgd-int8-zero1"]["ledger"]["verbs"]}
        assert led[("allreduce", "max")]["payload_bytes"] == (
            MLP_STEPS * 4 * n_leaves)
        assert led[("push", "add")]["payload_bytes"] == MLP_STEPS * 4 * (
            WORLD * L)
        assert led[("pull", None)]["payload_bytes"] == MLP_STEPS * 4 * L
        led = {(r["verb"], r["wire_dtype"]): r
               for r in w["adam-bf16-zero1"]["ledger"]["verbs"]}
        assert led[("push_quantized", "bfloat16")]["payload_bytes"] == (
            MLP_STEPS * 2 * WORLD * L)


@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_four_workers_fit_resident_and_fit_match_reference(world, jmesh4,
                                                           opt):
    """fit_resident with one batch an epoch (the order is then trivial),
    and fit through the ingest pipeline (numpy's batch order in both)."""
    x, y = mlp_data()
    cfg = JM.MLPConfig(**mlp_config_kwargs({"optimizer": opt}))
    ref = JM.MLPTrainer(cfg, jmesh4, seed=0)
    ref.load_resident(x, y, batch_size=len(x))
    hist = ref.fit_resident(epochs=4)
    for w in world:
        got = w[f"resident-{opt}"]
        np.testing.assert_allclose(got["hist"], hist, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_flat(got["params"]), _flat(ref.params),
                                   rtol=1e-5, atol=1e-6)
    ref = JM.MLPTrainer(cfg, jmesh4, seed=0)
    hist = ref.fit(x, y, batch_size=16, epochs=2)
    for w in world:
        got = w[f"fit-{opt}"]
        np.testing.assert_allclose(got["hist"], hist, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_flat(got["params"]), _flat(ref.params),
                                   rtol=1e-5, atol=1e-6)


def test_tp_2x2_matches_reference_and_the_dp_trainer(world):
    """The port's TP trainer on a 2 x 2 layout against the reference's on
    mesh_2d(2, 2) and the port's own DP trainer on four workers, the same
    params and three steps: within the reference's own TP-vs-DP tolerance
    (rtol 2e-4 / atol 2e-5, tests/test_mlp.py)."""
    x, y = mlp_data()
    cfg = JM.MLPConfig(**mlp_config_kwargs({"optimizer": "momentum"}))
    tp = JM.TPMLPTrainer(cfg, j_mesh_2d(2, 2), seed=0)
    hist = [tp.train_batch(x, y) for _ in range(3)]
    for w in world:
        got = w["tp"]
        # layer 0 column-parallel, layer 1 row-parallel
        assert got["local_w0"] == (MLP_SIZES[0], MLP_SIZES[1] // 2)
        assert got["local_w1"] == (MLP_SIZES[1] // 2, MLP_SIZES[2])
        np.testing.assert_allclose(got["hist"], hist, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(_flat(got["params"]), _flat(tp.params),
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got["hist"], got["dp_hist"], rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(_flat(got["params"]),
                                   _flat(got["dp_params"]), rtol=2e-4,
                                   atol=2e-5)


def test_tp_default_mesh_and_validations(world):
    for w in world:
        assert w["tp_default"]["shape"] == (1, 4)
        assert np.isfinite(w["tp_default"]["loss"])
        err = w["errors"]
        assert "divisible by the model axis" in err["divisible"]
        assert "batch size" in err["batch"]
        assert "needs 16 devices" in err["mesh"]
        assert w["zero1_len"] == M.zero1_shard_len(
            M.MLPConfig(sizes=MLP_SIZES), WORLD)


def test_children_never_import_jax(world):
    assert not any(w["_jax_imported"] for w in world)


# ---- one process: TP on 1 x 1, the reference's contract tests ------------------

def test_tp_one_by_one_equals_dp(jmesh1):
    x, y = mlp_data()
    cfg = M.MLPConfig(**mlp_config_kwargs({"optimizer": "adam"}))
    dp = M.MLPTrainer(cfg, device="cpu", seed=3)
    state = {"params": [{k: v.clone() for k, v in p.items()}
                        for p in dp.params]}
    tp = M.TPMLPTrainer(cfg, PM.mesh_2d(1, 1, "cpu"), state=state)
    for _ in range(3):
        a, b = dp.train_batch(x, y), tp.train_batch(x, y)
    np.testing.assert_allclose(a, b, rtol=1e-6)
    full = tp.full_params()
    np.testing.assert_allclose(
        _flat(full), _flat([{k: v.numpy() for k, v in p.items()}
                            for p in dp.params]), rtol=1e-6, atol=1e-7)
    # the default mesh on one process is 1 x 1
    assert (M.TPMLPTrainer(cfg, device="cpu").mesh.n_model, ) == (1,)


def test_mesh_2d_lays_out_one_process():
    m = PM.mesh_2d(1, 1, "cpu")
    assert (m.n_data, m.n_model, m.data_index, m.model_index) == (1, 1, 0, 0)
    with pytest.raises(ValueError, match="needs 4 devices"):
        PM.mesh_2d(2, 2, "cpu")


def test_validations_match_reference():
    with pytest.raises(ValueError, match="unknown optimizer"):
        M.MLPTrainer(M.MLPConfig(optimizer="lion"), device="cpu")
    with pytest.raises(ValueError, match="grad_wire"):
        M.MLPConfig(sizes=(16, 32, 4), grad_wire="fp4")
    with pytest.raises(ValueError, match="DP-only"):
        M.TPMLPTrainer(M.MLPConfig(sizes=(16, 32, 4), grad_wire="int8"),
                       device="cpu")
    with pytest.raises(ValueError, match="DP-only"):
        M.TPMLPTrainer(M.MLPConfig(optimizer="adam", zero1=True),
                       device="cpu")
    tr = M.MLPTrainer(M.MLPConfig(sizes=(16, 32, 4)), device="cpu")
    with pytest.raises(RuntimeError, match="load_resident"):
        tr.fit_resident(epochs=1)
    with pytest.raises(ValueError, match="do not fit sizes"):
        M.MLPTrainer(M.MLPConfig(sizes=(16, 8, 4)), device="cpu",
                     state={"params": tr.params})
    # fit_ckpt is ported: fault without a checkpoint directory is refused
    with pytest.raises(ValueError, match="ckpt_dir"):
        tr.fit_ckpt(*mlp_data(), 2, None, fault=object())


def test_reshuffle_contract():
    """Different seeds reshuffle; a fresh trainer repeats a run; each call
    advances the shuffle seed (the reference's three contract tests)."""
    x, y = JM.synthetic_mnist(n=256, d=16, classes=4, seed=3)
    cfg = M.MLPConfig(sizes=(16, 32, 4), lr=0.05)
    hists = []
    for seed in (0, 1):
        tr = M.MLPTrainer(cfg, device="cpu", seed=0)
        tr.load_resident(x, y, batch_size=32, seed=0)
        hists.append(tr.fit_resident(epochs=3, seed=seed))
    assert hists[0] != hists[1]
    tr = M.MLPTrainer(cfg, device="cpu", seed=0)
    tr.load_resident(x, y, batch_size=32, seed=0)
    h1, h2 = tr.fit_resident(epochs=2), tr.fit_resident(epochs=2)
    tr2 = M.MLPTrainer(cfg, device="cpu", seed=0)
    tr2.load_resident(x, y, batch_size=32, seed=0)
    assert tr2.fit_resident(epochs=2) == h1
    assert tr._shuffle_counter == 4 and tr2._shuffle_counter == 2
    assert h2 != h1


def test_load_resident_trims_as_the_reference_does(jmesh1):
    x, y = JM.synthetic_mnist(n=300, d=16, classes=4, seed=3)
    ref = JM.MLPTrainer(JM.MLPConfig(sizes=(16, 32, 4)), jmesh1, seed=0)
    tr = M.MLPTrainer(M.MLPConfig(sizes=(16, 32, 4)), device="cpu")
    assert tr.load_resident(x, y, batch_size=64, seed=4) == (
        ref.load_resident(x, y, batch_size=64, seed=4)) == 256
    np.testing.assert_array_equal(tr._resident[0].numpy(),
                                  np.asarray(ref._resident[0]))
    assert tr._resident[2:] == ref._resident[2:]


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_training_converges(opt):
    cfg = M.MLPConfig(sizes=(32, 64, 8), lr=0.05 if opt != "adam" else 0.005,
                      optimizer=opt)
    x, y = JM.synthetic_mnist(n=2048, d=32, classes=8, seed=0, noise=0.35)
    tr = M.MLPTrainer(cfg, device="cpu", seed=0)
    hist = tr.fit(x, y, batch_size=256, epochs=3)
    first = np.mean([h[0] for h in hist[:4]])
    last = np.mean([h[0] for h in hist[-4:]])
    assert last < 0.6 * first, (opt, first, last)
    assert tr.accuracy(x, y) > 0.8


def test_zero1_fit_resident_converges():
    x, y = JM.synthetic_mnist(n=512, d=32, classes=4, seed=1)
    tr = M.MLPTrainer(M.MLPConfig(sizes=(32, 64, 4), optimizer="adam",
                                  zero1=True), device="cpu", seed=0)
    tr.load_resident(x, y, batch_size=128)
    stats = tr.fit_resident(epochs=6)
    assert stats[-1][0] < stats[0][0] and stats[-1][1] > 0.8


def test_predict_matches_reference(jmesh1):
    x, _ = mlp_data()
    ref = JM.MLPTrainer(JM.MLPConfig(**mlp_config_kwargs({})), jmesh1, seed=0)
    state = convert.mlp_params_from_numpy({"params": _np_params(ref.params)},
                                          "cpu")
    tr = M.MLPTrainer(M.MLPConfig(**mlp_config_kwargs({})), device="cpu",
                      state=state)
    np.testing.assert_allclose(tr.predict(x), ref.predict(x), rtol=1e-5,
                               atol=1e-5)


def test_convert_checks_layers_and_takes_zero1_vectors():
    with pytest.raises(ValueError, match="fan_out"):
        convert.mlp_params_from_numpy(
            {"params": [{"w": np.zeros((4, 3)), "b": np.zeros(4)}]}, "cpu")
    params = [{"w": np.ones((4, 3), np.float32), "b": np.zeros(3, np.float32)}]
    out = convert.mlp_params_from_numpy(
        {"params": params, "opt_state": {"count": np.int32(3),
                                         "mu": np.arange(16.0),
                                         "nu": [{"w": np.ones((4, 3)),
                                                 "b": np.zeros(3)}]}}, "cpu")
    assert int(out["opt_state"]["count"]) == 3
    assert [t.shape for t in out["opt_state"]["mu"]] == [(16,)]
    assert [t.shape for t in out["opt_state"]["nu"]] == [(3,), (4, 3)]


def test_benchmark_and_cli_rows(capsys):
    with telemetry.scope():
        out = M.benchmark(n=256, batch=64, steps=2, device="cpu",
                          cfg=M.MLPConfig(sizes=(784, 32, 10)))
    assert {"samples_per_sec", "samples_per_sec_hostloop", "steps_per_sec",
            "loss", "acc", "train_acc", "grad_wire", "batch",
            "num_workers", "half_precision"} <= set(out)
    assert np.isfinite(out["loss"]) and out["num_workers"] == 1
    M.main(["--n", "512", "--batch", "128", "--train", "--device", "cpu"])
    row = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"mlp_fit_cli"' in row and '"backend": "cpu"' in row
