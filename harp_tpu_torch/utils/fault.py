"""Failure handling: the port of ``harp_tpu.utils.fault``.

Harp leaves failure to YARN: a dead container fails the task and YARN
retries the whole job from scratch, with no fault injection of its own.
The port keeps that model (fail fast, then restart) and restarts from the
latest checkpoint (:mod:`harp_tpu_torch.utils.checkpoint`) instead of from
iteration 0, with an injector that makes the recovery path testable.

- :func:`run_with_recovery` is the retry loop; :func:`fit_epochs` puts a
  model's epoch loop on it, and :func:`factor_state_io` and
  :func:`check_restored_shapes` are the restore contract the models share.
- :class:`FaultInjector` fails chosen iterations (``fail_at``, each once)
  and the ``ckpt_write`` site on a seeded schedule.  The site is observed
  through :func:`observe_ckpt_writes`, a small hook that
  :meth:`CheckpointManager.save` calls just before its rename.

Not ported yet (ROADMAP.md, Queue 1, item 8): the ``dispatch``, ``h2d`` and
``readback`` sites, which observe the flight recorder (``flightrec``), and
the superstep spans (``steptrace``) around :func:`fit_epochs`' epochs.
Scheduling one of those sites raises ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Any, Callable, Collection

import numpy as np
import torch

log = logging.getLogger("harp_tpu_torch")

#: the injection sites, in the order an epoch loop meets them
SITES = ("dispatch", "h2d", "readback", "ckpt_write")
#: the sites that need the flight recorder
_FLIGHTREC_SITES = ("dispatch", "h2d", "readback")

_CKPT_WRITE_OBSERVERS: list = []


@contextlib.contextmanager
def observe_ckpt_writes(fn: Callable[[str], None]):
    """Call ``fn(path)`` at every checkpoint write within the block, just
    before the write's rename; an exception from ``fn`` aborts the save."""
    _CKPT_WRITE_OBSERVERS.append(fn)
    try:
        yield
    finally:
        _CKPT_WRITE_OBSERVERS.remove(fn)


def notify_ckpt_write(path: str) -> None:
    for fn in list(_CKPT_WRITE_OBSERVERS):
        fn(path)


def _shape(v) -> tuple:
    return tuple(v.shape) if hasattr(v, "shape") else np.shape(v)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def check_restored_shapes(named_pairs) -> None:
    """Refuse a checkpoint whose array shapes differ from the live model's.

    ``named_pairs``: ``(name, restored, live)`` nests.  A mismatched
    restore would not fail loudly (a slice past the end clamps), so every
    ``fit`` checks before it installs a restored state."""
    for name, restored, live in named_pairs:
        got = [_shape(v) for v in _leaves(restored)]
        want = [_shape(v) for v in _leaves(live)]
        if got != want:
            raise ValueError(
                f"checkpoint shapes {name}{got} do not match this model's "
                f"{name}{want} — was the checkpoint written with a different "
                "algo/tile/size config? (refusing to resume)")


def to_host(tree):
    """A host copy of a state nest: tensors and arrays become numpy copies
    (bfloat16 tensors CPU tensor copies), so later in-place training
    cannot reach it."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().to("cpu", copy=True)
        return t if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


def to_device(x, device, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``device``: a tensor moves (a no-op where it
    already is), a host array is copied first, so the tensor never
    aliases it."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, copy=True))
    return x.to(device=device, dtype=dtype or x.dtype)


def factor_state_io(obj, fields: dict):
    """(get_state, set_state) for a model whose checkpoint state is named
    tensor attributes (MF-SGD, CCD++).

    ``fields``: ``{attr_name: placer}``, where ``placer(np_array)`` puts a
    restored host array where the model keeps it; live tensors from the
    step-to-step flow are installed as they are."""

    def get_state():
        return {k: getattr(obj, k) for k in fields}

    def set_state(state):
        check_restored_shapes(
            [(k, state[k], getattr(obj, k)) for k in fields])
        if isinstance(state[next(iter(fields))], torch.Tensor):
            for k in fields:
                setattr(obj, k, state[k])
        else:
            for k, place in fields.items():
                setattr(obj, k, place(state[k]))

    return get_state, set_state


class WorkerFailure(RuntimeError):
    """A worker died mid-job (Harp: a container failure surfaced by YARN)."""


class InjectedFault(WorkerFailure):
    """A :class:`FaultInjector`-scheduled transient failure, with the site
    and the 1-based event ordinal at which it fired."""

    def __init__(self, site: str, ordinal: int):
        super().__init__(f"injected {site} fault (event #{ordinal})")
        self.site = site
        self.ordinal = ordinal


class PermanentWorkerLoss(WorkerFailure):
    """A :class:`FaultInjector`-scheduled permanent loss of a worker.

    Not a subclass of :class:`InjectedFault`, so a transient retry never
    swallows it: :func:`run_with_recovery` re-raises it at once unless an
    ``on_permanent`` handler takes it."""

    def __init__(self, site: str, ordinal: int, worker: int):
        super().__init__(f"injected permanent loss of worker {worker} "
                         f"({site} event #{ordinal})")
        self.site = site
        self.ordinal = ordinal
        self.worker = worker


def _spec_fires(spec, ordinal: int, rng: np.random.Generator) -> bool:
    """A site schedule is a probability (a seeded Bernoulli draw an event)
    or a collection of 1-based event ordinals."""
    if spec is None:
        return False
    if isinstance(spec, (int, float)) and not isinstance(spec, bool):
        return bool(rng.random() < spec)
    return ordinal in spec


class FaultInjector:
    """Fail or delay chosen iterations and sites on a seeded schedule.

    - **Iterations**: each ``fail_at`` iteration raises
      :class:`WorkerFailure` from :meth:`check` (which
      :func:`run_with_recovery` calls before every step) once; a
      restarted run that passes it again goes on.
    - **Sites**: ``fail=``/``delay=``/``permanent=`` map a site to a
      probability or to 1-based event ordinals.  Inside :meth:`arm` a due
      ``ckpt_write`` event raises :class:`InjectedFault` (``fail``), sleeps
      ``delay_s`` (``delay``) or raises :class:`PermanentWorkerLoss` for
      ``lost_worker`` once (``permanent``).  ``max_faults`` bounds the
      injected failures.  One seeded generator draws every probability in
      event order, so a schedule replays exactly.

    The ``dispatch``, ``h2d`` and ``readback`` sites raise
    ``NotImplementedError``: they wait for the flight recorder."""

    def __init__(self, fail_at: tuple[int, ...] = (), *, seed: int = 0,
                 fail: dict[str, float | Collection[int]] | None = None,
                 delay: dict[str, float | Collection[int]] | None = None,
                 delay_s: float = 0.001, max_faults: int | None = None,
                 permanent: dict[str, float | Collection[int]] | None = None,
                 lost_worker: int | None = None):
        self.pending = set(fail_at)
        self.fired: list[int] = []
        for sched in (fail, delay, permanent):
            for site in sched or ():
                if site not in SITES:
                    raise ValueError(
                        f"unknown fault site {site!r} (sites: {SITES})")
                if site in _FLIGHTREC_SITES:
                    raise NotImplementedError(
                        f"fault site {site!r} observes the flight recorder "
                        "(utils/flightrec.py), which is not ported yet "
                        "(ROADMAP.md, Queue 1, item 8)")
        self.fail = dict(fail or {})
        self.delay = dict(delay or {})
        self.permanent = dict(permanent or {})
        if self.permanent and lost_worker is None:
            raise ValueError(
                "permanent= names the schedule but not the casualty: "
                "pass lost_worker=<worker index>")
        self.lost_worker = lost_worker
        self.permanent_fired = False
        self.delay_s = float(delay_s)
        self.max_faults = max_faults
        self._rng = np.random.default_rng(seed)
        self.seen = {s: 0 for s in SITES}
        self.injected = {s: 0 for s in SITES}
        self.delayed = {s: 0 for s in SITES}
        self.events: list[tuple[str, int]] = []  # (site, ordinal) fired

    def check(self, iteration: int) -> None:
        if iteration in self.pending:
            self.pending.discard(iteration)
            self.fired.append(iteration)
            raise WorkerFailure(f"injected fault at iteration {iteration}")

    def on_event(self, site: str) -> None:
        """One observed event at ``site``; raises or sleeps when due."""
        self.seen[site] += 1
        n = self.seen[site]
        if _spec_fires(self.delay.get(site), n, self._rng):
            self.delayed[site] += 1
            time.sleep(self.delay_s)
        if (not self.permanent_fired
                and _spec_fires(self.permanent.get(site), n, self._rng)):
            # not bounded by max_faults, and fires once: the worker is gone
            self.permanent_fired = True
            self.injected[site] += 1
            self.events.append((site, n))
            raise PermanentWorkerLoss(site, n, self.lost_worker)
        if (self.max_faults is not None
                and sum(self.injected.values()) >= self.max_faults):
            return
        if _spec_fires(self.fail.get(site), n, self._rng):
            self.injected[site] += 1
            self.events.append((site, n))
            raise InjectedFault(site, n)

    @contextlib.contextmanager
    def arm(self):
        """Observe the scheduled sites within the block (an unscheduled
        site is not observed at all)."""
        with contextlib.ExitStack() as stack:
            if any("ckpt_write" in s for s in (self.fail, self.delay,
                                               self.permanent)):
                stack.enter_context(observe_ckpt_writes(
                    lambda path: self.on_event("ckpt_write")))
            yield self

    def counters(self) -> dict:
        return {"seen": dict(self.seen), "injected": dict(self.injected),
                "delayed": dict(self.delayed)}


def resolve_resume(ckpt_dir: str | None, resume: bool) -> int | None:
    """The CLIs' ``--resume`` contract: it requires ``--ckpt-dir`` and at
    least one checkpoint there, so a mistyped directory fails loudly
    instead of training afresh.  Returns the step resumed from (None
    without ``--resume``); raises SystemExit otherwise."""
    if not resume:
        return None
    if not ckpt_dir:
        raise SystemExit(
            "--resume requires --ckpt-dir (it names the run to resume)")
    from harp_tpu_torch.utils.checkpoint import CheckpointManager

    latest = CheckpointManager(ckpt_dir).latest_step()
    if latest is None:
        raise SystemExit(
            f"--resume: no checkpoints under {ckpt_dir} — nothing to "
            "resume from (drop --resume to start a fresh run there)")
    return latest


def fit_epochs(
    train_one: Callable[[], Any],
    get_state: Callable[[], Any],
    set_state: Callable[[Any], None],
    epochs: int,
    ckpt_dir: str | None = None,
    *,
    ckpt_every: int = 5,
    max_restarts: int = 3,
    fault: "FaultInjector | None" = None,
    phase: str = "fit",
) -> None:
    """The epoch loop of the models' ``fit``, with optional checkpoints.

    ``get_state`` returns the model's state nest (live tensors);
    ``set_state`` installs one that may be a host restore (numpy) or live
    tensors.  The contract:

    - a crash before the first checkpoint restarts from the state at this
      call's entry (a host copy), never from the crash-time state;
    - a resume with no epochs left still installs the restored state;
    - ``fault`` without ``ckpt_dir`` is refused rather than ignored.

    ``phase`` names the run's telemetry span."""
    from harp_tpu_torch.utils import telemetry

    if ckpt_dir is None:
        if fault is not None:
            raise ValueError(
                "fault injection requires ckpt_dir (recovery restarts from "
                "checkpoints; without one the injector would be silently "
                "ignored)")
        with telemetry.span(phase, epochs=epochs):
            for _ in range(epochs):
                train_one()
        return

    from harp_tpu_torch.utils.checkpoint import CheckpointManager

    mgr = CheckpointManager(ckpt_dir)
    # the entry state, for a crash before the first checkpoint; with a
    # checkpoint on disk every restart restores from there instead
    init = None if mgr.latest_step() is not None else to_host(get_state())

    def step(i, state):
        set_state(state)
        train_one()
        return get_state()

    with telemetry.span(phase, epochs=epochs):
        final = run_with_recovery(lambda: init, step, epochs, mgr,
                                  ckpt_every=ckpt_every,
                                  max_restarts=max_restarts, fault=fault)
    set_state(final)


def run_with_recovery(
    make_state: Callable[[], Any],
    step: Callable[[int, Any], Any],
    n_iters: int,
    ckpt,
    *,
    ckpt_every: int = 10,
    max_restarts: int = 3,
    fault: FaultInjector | None = None,
    on_permanent: Callable[[PermanentWorkerLoss], None] | None = None,
) -> Any:
    """Fail fast, restart from the last checkpoint: YARN's retry loop.

    Runs ``state = step(i, state)`` for ``i`` in ``[0, n_iters)``, saving
    through ``ckpt`` (a :class:`~harp_tpu_torch.utils.checkpoint.
    CheckpointManager`) every ``ckpt_every`` iterations and after the
    last.  On an exception the run restarts from the latest checkpoint,
    or from ``make_state()`` if there is none, up to ``max_restarts``
    times, then re-raises.  A :class:`PermanentWorkerLoss` re-raises at
    once unless ``on_permanent`` takes it (and does not count against
    ``max_restarts``)."""
    restarts = 0
    while True:
        if ckpt.latest_step() is None:
            start, state = 0, make_state()
        else:
            start, state = ckpt.restore()
            start += 1
        try:
            for i in range(start, n_iters):
                if fault is not None:
                    fault.check(i)
                state = step(i, state)
                if (i + 1) % ckpt_every == 0 or i == n_iters - 1:
                    ckpt.save(i, state)
            return state
        except PermanentWorkerLoss as e:
            if on_permanent is None:
                raise
            log.warning("permanent loss of worker %s (%s); resuming from "
                        "step %s", e.worker, e, ckpt.latest_step())
            on_permanent(e)
        except Exception as e:  # noqa: BLE001 - the whole point
            restarts += 1
            if restarts > max_restarts:
                log.error("job failed after %d restarts: %s", max_restarts, e)
                raise
            log.warning("worker failure (%s); restart %d/%d from step %s",
                        e, restarts, max_restarts, ckpt.latest_step())
