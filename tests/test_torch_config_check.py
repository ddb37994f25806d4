"""``harp_tpu_torch.utils.config`` and ``harp_tpu_torch.utils.check``
against harp_tpu's.

- ``parse_into`` builds the reference's config from the same argv, field
  for field (the reference's ``test_aux.py`` cases, run through both).
- ``checked_jit`` and ``assert_finite``: the reference's four cases
  (``test_fault.py``: a clean call, ``log(-1)/-1``, ``x[9]`` on four
  elements, ``assert_finite`` inside the function) give the same outcome
  in both packages and match the same message patterns; a clean call
  returns exactly what the bare call returns.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.utils import check as JC
from harp_tpu.utils import config as JCFG
from harp_tpu_torch.utils import check as C
from harp_tpu_torch.utils import config as CFG
from torch_world import time_limit


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(60):
        yield


@dataclasses.dataclass
class Cfg:
    k: int = 100
    lr: float = 0.1
    name: str = "x"
    verbose: bool = False


@dataclasses.dataclass
class Sizes:
    sizes: tuple = (8, 16, 2)


@pytest.mark.parametrize("cls,argv,overrides,want", [
    (Cfg, ["--k", "7", "--lr", "0.5", "--verbose"], {},
     Cfg(k=7, lr=0.5, name="x", verbose=True)),
    (Cfg, [], {"k": 9}, Cfg(k=9)),
    (Cfg, ["--no-verbose", "--name", "y"], {"verbose": True},
     Cfg(name="y", verbose=False)),
    (Sizes, ["--sizes", "4,8"], {}, Sizes(sizes=(4, 8))),
    (Sizes, ["--sizes", "1 2 3"], {}, Sizes(sizes=(1, 2, 3))),
    (Sizes, [], {}, Sizes()),
], ids=["flags", "override", "bool-off", "tuple-comma", "tuple-space",
        "tuple-default"])
def test_parse_into_builds_the_references_config(cls, argv, overrides, want):
    ours = CFG.parse_into(cls, argv, **overrides)
    theirs = JCFG.parse_into(cls, argv, **overrides)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours == want
    assert type(ours.sizes if cls is Sizes else ours.k) is type(
        theirs.sizes if cls is Sizes else theirs.k)


def test_parse_into_refuses_what_is_not_a_dataclass():
    with pytest.raises(TypeError, match="dataclass"):
        CFG.parse_into(dict, [])


def _cases(lib):
    """The reference's four checked_jit cases, written for ``lib`` (jnp or
    torch): (function, arguments)."""
    def prog(x):
        (JC if lib is jnp else C).assert_finite({"x": x}, "model")
        return x * 2

    arr = jnp.asarray if lib is jnp else torch.tensor
    return {
        "clean": (lambda x: lib.sqrt(x).sum(), (arr(np.ones(4, np.float32)),)),
        "nan": (lambda x: lib.log(x) / x, (arr(np.float32(-1.0)),)),
        "oob": (lambda x, i: x[i], (arr(np.arange(4, dtype=np.float32)),
                                    arr(np.int32(9)))),
        "user": (prog, (arr(np.array([1.0, np.inf, 3.0], np.float32)),)),
        "user-clean": (prog, (arr(np.ones(3, np.float32)),)),
    }


PATTERNS = {"nan": "nan", "oob": "out-of-bounds|index", "user": "model"}


@pytest.mark.parametrize("case", ["clean", "nan", "oob", "user",
                                  "user-clean"])
def test_checked_jit_matches_the_reference(case):
    fn, args = _cases(torch)[case]
    jfn, jargs = _cases(jnp)[case]
    if case in PATTERNS:
        with pytest.raises(Exception, match=PATTERNS[case]):
            JC.checked_jit(jfn)(*jargs)
        with pytest.raises(Exception, match=PATTERNS[case]):
            C.checked_jit(fn)(*args)
        return
    ours = C.checked_jit(fn)(*args)
    theirs = JC.checked_jit(jfn)(*jargs)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert torch.equal(ours, fn(*args))  # the bare call's result, exactly


def test_checked_jit_names_nan_or_inf_and_the_leaf():
    def two(x):
        return {"a": x + 1, "b": (x, 1.0 / x)}

    f = C.checked_jit(two)
    out = f(torch.ones(3))
    assert torch.equal(out["b"][1], torch.ones(3))
    with pytest.raises(C.CheckError, match=r"inf in the output\['b'\]\[1\]"):
        f(torch.tensor([1.0, 0.0]))
    with pytest.raises(C.CheckError, match=r"nan in the output\['a'\]"):
        f(torch.tensor([float("nan")]))
    # integer outputs are not floats: nothing to check
    assert C.checked_jit(lambda: torch.arange(3))().tolist() == [0, 1, 2]


def test_assert_finite_paths_are_the_references_keystr():
    tree = {"w": [torch.ones(2), torch.tensor([1.0, float("inf")])]}
    with pytest.raises(C.CheckError,
                       match=r"^params\['w'\]\[1\] has non-finite values"):
        C.assert_finite(tree, "params")
    C.assert_finite({"w": [torch.ones(2)], "step": torch.tensor(3)}, "p")
