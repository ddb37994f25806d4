"""Runtime twin of the threads lint layer: thread-ownership assertions, the
port of ``harp_tpu.utils.threadguard``.

HL401-HL405 show at lint time that no forbidden thread root can *reach* a
device-touching call or an unlocked spine mutator
(:mod:`harp_tpu_torch.analysis.threadgraph`).  This module checks the same
contract at run time: when armed, every flight-recorder observer site
(dispatch, H2D, readback, checkpoint write) and every mutator of a spine the
static layer could NOT verify as internally locked asserts that the current
thread's name matches no forbidden pattern, and raises
:class:`ThreadOwnershipError` if it does.

The ownership map is generated from the static layer
(:func:`~harp_tpu_torch.analysis.threadgraph.ownership_map`): the forbidden
patterns are the name patterns of the named non-owner roots the graph
found, and the spines wrapped are exactly those whose mutators the graph
could not verify as locked.  The port's scheduler workers are device owners
(the schedule plane's design), so their names are not forbidden.

Disarmed, this module installs nothing: no observer callbacks, no wrapped
mutators.  Armed, each guarded site costs one sweep of thread-name
patterns.

Usage::

    with threadguard.armed():          # raising, for tests
        run_serve_plane()
    assert threadguard.stats()["checks"] > 0   # non-vacuous
"""

from __future__ import annotations

import contextlib
import fnmatch
import functools
import importlib
import threading
import types
from typing import Any


class ThreadOwnershipError(AssertionError):
    """A device-touching op or an unlocked-spine mutation ran on a thread
    the static thread-root graph forbids (HL401/HL403 at run time)."""


class _Guard:
    def __init__(self) -> None:
        self.patterns: tuple[str, ...] = ()
        self.checks = 0
        self.violations: list[str] = []
        self._installed: list[tuple[list, Any]] = []      # (registry, cb)
        self._wrapped: list[tuple[Any, str, Any]] = []    # (obj, attr, orig)
        self.active = False

    def check(self, what: str) -> None:
        self.checks += 1
        name = threading.current_thread().name
        for pat in self.patterns:
            if fnmatch.fnmatch(name, pat):
                msg = (f"{what} on forbidden thread {name!r} (matches "
                       f"ownership pattern {pat!r}): this thread root does "
                       "not own the device on its plane; route the op "
                       "through the designated owner (see harp_tpu_torch/"
                       "analysis/threadgraph.py)")
                self.violations.append(msg)
                raise ThreadOwnershipError(msg)


_guard = _Guard()


def arm(omap: dict | None = None) -> None:
    """Install the ownership assertions.  ``omap`` defaults to the map
    generated from the static layer; pass one only in a test that
    sabotages it on purpose."""
    if _guard.active:
        return
    if omap is None:
        from harp_tpu_torch.analysis import threadgraph

        omap = threadgraph.ownership_map()
    _guard.patterns = tuple(omap.get("forbidden_thread_patterns", ()))
    _guard.checks = 0
    _guard.violations = []
    from harp_tpu_torch.utils import flightrec

    sites = (
        (flightrec._DISPATCH_OBSERVERS,
         lambda label: _guard.check(f"dispatch {label!r}")),
        (flightrec._READBACK_OBSERVERS,
         lambda x: _guard.check("readback")),
        (flightrec._H2D_OBSERVERS,
         lambda nbytes, site: _guard.check(f"h2d staging ({site})")),
        (flightrec._CKPT_WRITE_OBSERVERS,
         lambda path: _guard.check("ckpt write")),
    )
    for registry, cb in sites:
        registry.append(cb)
        _guard._installed.append((registry, cb))
    # spines the static layer could NOT verify as locked get their
    # mutators wrapped; verified-locked spines are left as they are
    for sp_name, sp in sorted(omap.get("spines", {}).items()):
        if sp.get("locked"):
            continue
        mod = importlib.import_module(sp["module"])
        target = getattr(mod, sp["obj"]) if sp.get("obj") else mod
        for mut in sp["mutators"]:
            orig = getattr(target, mut)

            def wrapper(*a, __orig=orig, __what=f"{sp_name}.{mut}", **kw):
                _guard.check(f"spine mutation {__what}")
                return __orig(*a, **kw)

            functools.update_wrapper(wrapper, orig)
            setattr(target, mut, wrapper)
            _guard._wrapped.append((target, mut, orig))
    _guard.active = True


def disarm() -> None:
    """Remove everything :func:`arm` installed, restoring the exact
    original callables."""
    for registry, cb in _guard._installed:
        if cb in registry:
            registry.remove(cb)
    _guard._installed.clear()
    for target, attr, orig in reversed(_guard._wrapped):
        if isinstance(target, types.ModuleType):
            setattr(target, attr, orig)
        else:   # a bound method: the class's shows through again
            delattr(target, attr)
    _guard._wrapped.clear()
    _guard.patterns = ()
    _guard.active = False


@contextlib.contextmanager
def armed(omap: dict | None = None):
    """``with threadguard.armed(): ...``: arm for the block, always disarm
    on exit."""
    arm(omap)
    try:
        yield _guard
    finally:
        disarm()


def stats() -> dict:
    """How many ownership checks ran (non-vacuity evidence)."""
    return {"active": _guard.active, "checks": _guard.checks,
            "patterns": list(_guard.patterns),
            "violations": list(_guard.violations)}
