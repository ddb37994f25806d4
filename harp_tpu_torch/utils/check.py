"""Runtime checking: the port of ``harp_tpu.utils.check``.

The reference compiles ``checkify``'s NaN/inf, out-of-bounds-index and
user checks into a jitted step.  The port runs eagerly, so there is
nothing to compile a check into: :func:`checked_jit` calls the function
and then checks its outputs on the host, and :func:`assert_finite` checks
a nest of tensors where it is called.

What the wrapper sees, and what it cannot:

- **Outputs.**  Every floating tensor of the output is checked for NaN
  and inf, one reduction a leaf and one readback a call; the error names
  ``nan`` or ``inf`` and the leaf's path.
- **Indices.**  An out-of-range index raises torch's own ``IndexError``
  on the CPU, at the operation that indexes.  On the card it is a
  device-side assert instead, which poisons the CUDA context: every later
  call in the process fails, so validate indices that come from outside
  on the host.
- **Not seen:** a NaN or inf in an intermediate that does not reach an
  output, and anything inside K1-K8 (a hand-written kernel checks its
  arguments' shapes and dtypes in its wrapper, never the values it
  reads or writes).
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch


class CheckError(RuntimeError):
    """A check of :func:`checked_jit` or :func:`assert_finite` tripped."""


def _leaves_with_path(tree: Any, path: str = ""):
    """(path, leaf) of a tensor nest, the path in ``keystr`` style
    (``['key']`` for a dict, ``[i]`` for a sequence)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from _leaves_with_path(x, f"{path}[{i}]")
    else:
        yield path, tree


def _floating(tree: Any) -> list[tuple[str, torch.Tensor]]:
    return [(p, x) for p, x in _leaves_with_path(tree)
            if isinstance(x, torch.Tensor)
            and (x.is_floating_point() or x.is_complex())]


def _first_bad(leaves: list[tuple[str, torch.Tensor]]):
    """The first leaf holding a NaN or inf, and which (None when every
    leaf is finite): one readback when they all are."""
    if not leaves:
        return None
    ok = torch.stack([torch.isfinite(x).all() for _, x in leaves])
    if bool(ok.all()):
        return None
    for (path, x), good in zip(leaves, ok.tolist()):
        if not good:
            return path, "nan" if bool(torch.isnan(x).any()) else "inf"
    return None


def checked_jit(fn: Callable) -> Callable:
    """``fn`` with its outputs checked for NaN and inf after each call.

    Returns a callable with ``fn``'s signature that raises
    :class:`CheckError` (a message naming ``nan`` or ``inf``) when a
    floating output leaf is not finite, and otherwise returns what ``fn``
    returned, untouched.  Debug and test runs pay the check; hot loops
    call the raw ``fn``.
    """

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        bad = _first_bad(_floating(out))
        if bad is not None:
            path, what = bad
            raise CheckError(f"{what} in the output{path} of "
                             f"{getattr(fn, '__name__', fn)!s}")
        return out

    return wrapper


def assert_finite(tree: Any, name: str = "value") -> None:
    """Every floating leaf of ``tree`` finite, else :class:`CheckError`
    naming ``name`` and the leaf's path."""
    bad = _first_bad(_floating(tree))
    if bad is not None:
        path, what = bad
        raise CheckError(f"{name}{path} has non-finite values ({what})")
