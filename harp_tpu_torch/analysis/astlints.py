"""Layer ``ast``: source lints over the port's files (pure ``ast``).

Each checker encodes one rule of :mod:`harp_tpu_torch.analysis.rules`.
Everything here is static text analysis: the port lints in about a second
and imports nothing of what it reads.

Scoping is per rule: raw ``torch.distributed`` data calls are legal inside
the verb layer (``parallel/collective.py`` and ``parallel/rotate.py``);
group and rank queries (``get_rank``, ``new_group``, ``barrier``) move no
data and stay legal everywhere.  Intentional exceptions elsewhere go in
``analysis/allowlist.toml`` with a reviewed reason, never in code.
"""

from __future__ import annotations

import ast
import os
import re

from harp_tpu_torch.analysis import Violation

#: the data-moving ``torch.distributed`` calls the verb layer wraps
RAW_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "all_gather_single", "all_to_all",
    "all_to_all_single", "broadcast", "broadcast_object_list",
    "reduce_scatter", "reduce_scatter_tensor", "reduce_scatter_single",
    "send", "recv", "isend", "irecv", "batch_isend_irecv", "reduce",
    "gather", "gather_object", "scatter", "scatter_object_list",
})

#: names the ``torch.distributed`` module goes by in the port
_DIST_MODULES = ("dist", "torch.distributed", "distributed")

# files where each rule does not apply (repo-relative, forward slashes)
HL001_EXEMPT = ("harp_tpu_torch/parallel/collective.py",
                "harp_tpu_torch/parallel/rotate.py")
HL005_SCOPE = ("harp_tpu_torch/", "chip_smoke.py")

#: global-RNG draws of numpy's legacy module-level state
_NP_GLOBAL_DRAWS = frozenset({
    "seed", "rand", "randn", "randint", "random", "random_sample",
    "random_integers", "ranf", "sample", "choice", "permutation",
    "shuffle", "normal", "uniform", "standard_normal", "exponential",
    "poisson", "binomial", "multinomial", "gamma", "beta", "dirichlet",
    "gumbel", "laplace", "logistic", "lognormal", "zipf", "bytes",
})

#: torch draws that take the global generator unless given ``generator=``
_TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "normal", "bernoulli", "multinomial", "poisson",
})

#: calls whose wrapping makes a host-to-device copy counted
_COUNTED_H2D = frozenset({"shard_array", "shard_array_local", "record_h2d",
                          "put_input"})

#: classes whose H2D copies are the counted staging path
_H2D_CLASSES = frozenset({"StagingRing"})

# a measured time or rate: "0.05 ms", "12.5 µs", "3.2 GB/s", "1.1M ups/s",
# "2.9× faster".  The number must start a token, so "p99 ms" stays quiet;
# "ms" and "us" must end one, so "msg" and "use" do too.
_PERF_RE = re.compile(
    r"(?<![\w.])\d[\d,.]*\s*(?:ms|µs|us)\b"
    r"|(?<![\w.])\d[\d,.]*\s*[kKMGT]?\s*(?:B|GB|MB|TB|iter|iters|tok|"
    r"tokens|ups|updates|points?|pts|rows|req|requests|launch(?:es)?)"
    r"\s*/\s*s\b"
    r"|(?<![\w.])\d[\d.]*\s*×\s*(?:faster|slower|speedup|vs\b)")
_DATE_RE = re.compile(r"20\d\d-\d\d-\d\d")
_CARD_RE = re.compile(r"\bH100\b")
_WATTS_RE = re.compile(r"\b\d+(?:\.\d+)?\s*W\b")


def _attr_chain(node: ast.AST) -> str:
    """Dotted name of an Attribute/Name chain ("dist.all_reduce"), or ""."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _subtree_mentions_numpy(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Name) and n.id in ("np", "numpy")
               for n in ast.walk(node))


def _kw(call: ast.Call, name: str) -> ast.AST | None:
    return next((k.value for k in call.keywords if k.arg == name), None)


def _is_cpu(node: ast.AST | None) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


class _Linter:
    def __init__(self, relpath: str, text: str):
        self.relpath = relpath.replace(os.sep, "/")
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=relpath)
        self.parents: dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.violations: list[Violation] = []

    # -- helpers -----------------------------------------------------------
    def _src(self, node: ast.AST) -> str:
        ln = getattr(node, "lineno", 0)
        return self.lines[ln - 1] if 0 < ln <= len(self.lines) else ""

    def _emit(self, rule: str, node: ast.AST, msg: str) -> None:
        self.violations.append(Violation(
            rule, self.relpath, getattr(node, "lineno", 0), msg,
            self._src(node)))

    def _ancestors(self, node: ast.AST):
        n = self.parents.get(node)
        while n is not None:
            yield n
            n = self.parents.get(n)

    def _in_call_to(self, node: ast.AST, names: frozenset[str]) -> bool:
        """Is ``node`` inside a Call whose callee's last dotted component
        is in ``names``?"""
        for anc in self._ancestors(node):
            if isinstance(anc, ast.Call):
                chain = _attr_chain(anc.func)
                if chain and chain.split(".")[-1] in names:
                    return True
        return False

    def _counted_scope(self, node: ast.AST) -> bool:
        """Is ``node`` in a counted H2D path: a ``shard_array`` function, a
        StagingRing method, or a function that calls ``record_h2d``?"""
        for anc in self._ancestors(node):
            if isinstance(anc, ast.ClassDef) and anc.name in _H2D_CLASSES:
                return True
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if anc.name in _COUNTED_H2D:
                    return True
                for n in ast.walk(anc):
                    if (isinstance(n, ast.Call) and _attr_chain(n.func)
                            .split(".")[-1] == "record_h2d"):
                        return True
        return False

    def _to_device(self, call: ast.Call) -> bool:
        """Does ``call`` put its result on a device: a non-"cpu"
        ``device=``, or an immediate ``.to(...)``/``.cuda()``?"""
        dev = _kw(call, "device")
        if dev is not None and not _is_cpu(dev):
            return True
        parent = self.parents.get(call)
        if (isinstance(parent, ast.Attribute) and parent.value is call
                and parent.attr in ("to", "cuda")):
            outer = self.parents.get(parent)
            if isinstance(outer, ast.Call) and outer.func is parent:
                args = list(outer.args) + [k.value for k in outer.keywords
                                           if k.arg == "device"]
                return parent.attr == "cuda" or not (
                    args and all(_is_cpu(a) for a in args[:1]))
        return False

    def _scoped(self, prefixes) -> bool:
        return any(self.relpath.startswith(p) for p in prefixes)

    # -- the rules ---------------------------------------------------------
    def run(self) -> list[Violation]:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                self._check_call(node)
        if self._scoped(HL005_SCOPE):
            self._check_docstrings()
        return self.violations

    def _check_call(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func)
        if not chain:
            return
        head, _, last = chain.rpartition(".")

        if (last in RAW_COLLECTIVES and head in _DIST_MODULES
                and self.relpath not in HL001_EXEMPT):
            self._emit("HL001", node,
                       f"raw torch.distributed.{last} outside the verb "
                       "layer: route it through harp_tpu_torch.parallel."
                       "collective so the CommLedger sees its bytes")

        if head in ("np.random", "numpy.random") and \
                last in _NP_GLOBAL_DRAWS:
            self._emit("HL002", node,
                       f"np.random.{last} draws from numpy's global state: "
                       "use an explicit np.random.default_rng(seed)")
        elif chain == "torch.manual_seed":
            self._emit("HL002", node,
                       "torch.manual_seed reseeds the global generator "
                       "every caller shares: pass a torch.Generator")
        elif (head == "torch" and last in _TORCH_DRAWS
              and _kw(node, "generator") is None):
            self._emit("HL002", node,
                       f"torch.{last} without generator= draws from the "
                       "global generator: pass an explicit torch.Generator")

        if (chain in ("torch.tensor", "torch.as_tensor")
                and node.args and _subtree_mentions_numpy(node.args[0])
                and self._to_device(node)
                and not self._in_call_to(node, _COUNTED_H2D)
                and not self._counted_scope(node)):
            self._emit("HL003", node,
                       f"{chain} of host numpy onto a device is a "
                       "synchronous, pageable, uncounted H2D copy: place "
                       "it through mesh.shard_array, the StagingRing or a "
                       "path that calls flightrec.record_h2d")

    def _check_docstrings(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, (ast.Module, ast.ClassDef,
                                     ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            doc = ast.get_docstring(node, clean=False)
            if not doc or not _PERF_RE.search(doc):
                continue
            missing = []
            if not _DATE_RE.search(doc):
                missing.append("date (YYYY-MM-DD)")
            if not _CARD_RE.search(doc):
                missing.append("card (H100)")
            if not _WATTS_RE.search(doc):
                missing.append("power limit (e.g. 700 W)")
            if missing:
                name = getattr(node, "name", "<module>")
                self._emit("HL005", node.body[0],
                           f"docstring of {name} carries a perf number but "
                           f"no {', '.join(missing)}: every measured "
                           "number carries its date, card and power limit")


def lint_source(relpath: str, text: str) -> list[Violation]:
    """Lint one file's source; ``relpath`` decides rule scoping."""
    try:
        return _Linter(relpath, text).run()
    except SyntaxError as e:
        return [Violation("HL000", relpath, e.lineno or 0,
                          f"unparseable Python: {e.msg}")]


#: the default scan set: the port and its card script (tests are golden
#: code and lint their own fixtures)
DEFAULT_ROOTS = ("harp_tpu_torch", "chip_smoke.py")


def iter_python_files(repo: str, roots=DEFAULT_ROOTS):
    for root in roots:
        p = os.path.join(repo, root)
        if os.path.isfile(p):
            yield root
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in ("__pycache__", "_build"))
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        yield os.path.relpath(os.path.join(dirpath, fn),
                                              repo).replace(os.sep, "/")


def lint_paths(repo: str, relpaths=None) -> list[Violation]:
    """Lint ``relpaths`` (default: the whole default scan set)."""
    out: list[Violation] = []
    for rel in (relpaths if relpaths is not None
                else iter_python_files(repo)):
        with open(os.path.join(repo, rel), encoding="utf-8") as fh:
            out.extend(lint_source(rel, fh.read()))
    return out
