"""Layer ``threads``: the host-concurrency audit (HL401-HL405) over the
thread-root graph, the port of ``harp_tpu.analysis.threadgraph``.

The serve, ingest, schedule, timing, fault and bench planes each hand-roll a
host threading model documented in comments ("the dispatcher thread owns
the launches", "the event loop owns every socket", "stat writes take
self._lock").  This module turns each comment into a checked invariant.
The analysis is pure ``ast`` over each **plane** (module group sharing a
threading model, :data:`PLANES`), copied from the reference: per plane it
discovers every **thread root**

- ``main``: the residual root, everything no other root reaches;
- ``thread:<target>``: each ``threading.Thread(target=...)``;
- ``timer:<target>``: each ``threading.Timer(...)``;
- ``pool:<name>``: each ``ThreadPoolExecutor`` submit site (by the pool
  variable, carrying its ``thread_name_prefix``);
- ``eventloop``: every ``async def`` and every callback handed to
  ``call_soon_threadsafe``; a ``Thread`` whose target wraps
  ``asyncio.run`` gives its ``name=`` to this root,

computes each root's reachable call set by name-based call resolution
within the plane (an over-approximation by design), and checks:

- **HL401**: a device-touching call reachable from a root that is not
  one of the plane's device owners.  The device vocabulary is the port's:
  ``torch.cuda.*`` (streams, events, ``synchronize``), ``.cpu()``,
  ``.item()``, ``.numpy()``, ``.cuda()``, ``record_stream``, a graph's
  ``replay``, ``flightrec.readback``, ``device_sync``, ``shard_array``
  and a dispatch through the serve ``_exec`` table.
- **HL402**: a blocking call (a device sync or readback, ``recv``, a
  zero-arg ``Queue.get``, an unbounded ``join``/``result``/``wait``,
  ``time.sleep``) reachable from the event loop and not awaited.
- **HL403**: shared state written from two or more roots (or from a
  multi-instance root: a pool, or threads made in a loop) with no common
  lock on the write path.  A telemetry spine (:data:`SPINES`) written
  from several roots is clean only if its own mutators are verified to
  take a lock (the spine's module is parsed);
  :mod:`harp_tpu_torch.utils.threadguard` wraps exactly the spines that
  fail that check.
- **HL404**: a ``with <lock>:`` whose body reaches a device-touching call.
- **HL405**: a thread started with neither ``daemon=True`` nor a bounded
  ``join(timeout)``.

:func:`ownership_map` exports the graph's runtime face (each plane's
device owners, the forbidden thread-name patterns of its named non-owner
roots, the spine lock verdicts), which threadguard arms.  Per-plane
graphs are cached on (path, mtime, size), so ``lint --changed``
re-analyzes only planes whose files changed.
"""

from __future__ import annotations

import ast
import dataclasses
import os

from harp_tpu_torch.analysis import Violation

# ---------------------------------------------------------------------------
# Vocabulary
# ---------------------------------------------------------------------------

#: call-chain tails that touch the device: placements, readbacks, syncs,
#: stream marks and graph replays.
DEVICE_TOUCH_FUNCS = frozenset({
    "shard_array", "shard_array_local", "device_sync", "readback",
    "cpu", "item", "numpy", "cuda", "record_stream", "replay",
})

#: dotted-chain prefixes that are the device by construction: streams,
#: events, synchronize, memory queries.
DEVICE_PREFIXES = ("torch.cuda.",)

#: attributes holding tracked-executable tables — ``self._exec[rung](...)``
#: is a dispatch (the serve plane's AOT ladder).
DISPATCH_TABLE_ATTRS = frozenset({"_exec"})

#: method tails that block their thread when called unbounded.  ``get``
#: is special-cased (zero-arg only: ``d.get(key)`` is a dict read);
#: any positional arg or a ``timeout=`` keyword is a bounded wait and
#: therefore exempt everywhere.
BLOCKING_SUFFIXES = frozenset({"join", "result", "recv", "accept",
                               "acquire", "wait"})

#: in-place mutator method tails that count as a write to their
#: receiver (the shared-state half of HL403).  ``put``/``get`` are NOT
#: here: ``queue.Queue``/``asyncio.Queue`` are the sanctioned
#: internally-locked cross-thread channels.
MUTATOR_METHODS = frozenset({"append", "extend", "insert", "add",
                             "update", "setdefault", "appendleft",
                             "remove", "discard", "popleft"})


@dataclasses.dataclass(frozen=True)
class PlaneSpec:
    """One plane: modules sharing a threading model, and the thread roots
    allowed to touch the device."""

    name: str
    modules: tuple[str, ...]       # repo-relative paths
    device_owners: tuple[str, ...]  # root ids allowed to touch the device


#: the audited planes.  ``main`` owns the device everywhere (drivers and
#: tests run on it); a plane adds the worker roots designed to launch.
PLANES: tuple[PlaneSpec, ...] = (
    PlaneSpec("serve",
              ("harp_tpu_torch/serve/transport.py",
               "harp_tpu_torch/serve/server.py"),
              ("main", "thread:_dispatch_loop")),
    # the read and prep pools touch no device: the prep's StagingRing.host
    # waits on the previous copy's event (outside this plane, in the
    # model's prep), and the H2D copy itself (StagingRing.ship) runs on
    # the consumer, main
    PlaneSpec("ingest", ("harp_tpu_torch/ingest.py",), ("main",)),
    # a difference of design from the reference, whose schedule plane has
    # main as its only owner: the port's scheduler workers launch CUDA
    # work on a stream of their own, ordered against the caller's stream
    # both ways by _Streams.mark/take/give (schedule.py), so the worker
    # roots (harp-sched-static-*, harp-sched-dyn-*) are owners here
    PlaneSpec("schedule", ("harp_tpu_torch/schedule.py",),
              ("main", "thread:worker")),
    PlaneSpec("timing", ("harp_tpu_torch/utils/timing.py",), ("main",)),
    PlaneSpec("fault", ("harp_tpu_torch/utils/fault.py",), ("main",)),
    # the port's bench modules: the verb sweep and the serve benchmark
    PlaneSpec("bench", ("harp_tpu_torch/benchmark.py",
                        "harp_tpu_torch/serve/bench.py"), ("main",)),
)


@dataclasses.dataclass(frozen=True)
class SpineSpec:
    """One telemetry spine: where it lives, how plane code mutates it,
    and how the runtime twin reaches its singleton."""

    name: str
    module: str                    # repo-relative source path
    cls: str | None                # class owning the mutators (None = module fns)
    mutators: tuple[str, ...]      # mutator function/method names
    chains: tuple[str, ...]        # call-chain suffixes that hit them
    import_path: str               # runtime import path
    obj: str | None                # module attr holding the singleton


SPINES: tuple[SpineSpec, ...] = (
    SpineSpec("reqtrace", "harp_tpu_torch/utils/reqtrace.py", "ReqTracer",
              ("begin", "event", "end", "mark"),
              ("reqtrace.arrive", "reqtrace.tracer.begin",
               "reqtrace.tracer.event", "reqtrace.tracer.end",
               "reqtrace.tracer.mark", "tracer.begin", "tracer.event",
               "tracer.end"),
              "harp_tpu_torch.utils.reqtrace", "tracer"),
    SpineSpec("comm_ledger", "harp_tpu_torch/utils/telemetry.py", "CommLedger",
              ("record",),
              ("telemetry.record_comm", "record_comm", "ledger.record"),
              "harp_tpu_torch.utils.telemetry", "ledger"),
    SpineSpec("span_tracer", "harp_tpu_torch/utils/telemetry.py", "SpanTracer",
              ("span",),
              ("telemetry.span", "tracer.span", "span"),
              "harp_tpu_torch.utils.telemetry", "tracer"),
    SpineSpec("flightrec", "harp_tpu_torch/utils/flightrec.py", None,
              ("record_h2d", "record_readback", "record_bucket"),
              ("flightrec.record_h2d", "flightrec.record_readback",
               "flightrec.record_bucket"),
              "harp_tpu_torch.utils.flightrec", None),
)


# ---------------------------------------------------------------------------
# AST plumbing
# ---------------------------------------------------------------------------

def _attr_chain(node: ast.AST) -> str:
    """Dotted name of an Attribute/Name chain ("self._inq.put"), or ""."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _chain_matches(chain: str, suffix: str) -> bool:
    return chain == suffix or chain.endswith("." + suffix)


def _name_pattern(node: ast.AST | None) -> str | None:
    """An fnmatch pattern for a thread-name expression: constants stay
    verbatim, f-string holes become ``*`` (``f"{tag}-read"`` → ``*-read``)."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        out = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                out.append(v.value)
            else:
                out.append("*")
        return "".join(out) or None
    return None


def _kw(call: ast.Call, name: str) -> ast.AST | None:
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


@dataclasses.dataclass
class _Site:
    relpath: str
    line: int
    source: str
    desc: str
    locks: frozenset[str] = frozenset()


@dataclasses.dataclass
class _FuncInfo:
    name: str
    qualname: str
    relpath: str
    node: ast.AST                      # FunctionDef / AsyncFunctionDef / Lambda
    is_async: bool
    # populated by _scan
    calls: list[tuple[str, ast.Call, frozenset, bool]] = \
        dataclasses.field(default_factory=list)  # (chain, node, locks, awaited)
    device_sites: list[_Site] = dataclasses.field(default_factory=list)
    blocking_sites: list[_Site] = dataclasses.field(default_factory=list)
    spine_sites: dict[str, list[_Site]] = dataclasses.field(
        default_factory=dict)
    writes: list[tuple[str, _Site, bool]] = dataclasses.field(
        default_factory=list)          # (key, site, in_init)
    lock_regions: list[tuple[str, ast.With, frozenset]] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class _Root:
    id: str
    kind: str                          # main|thread|timer|pool|eventloop
    entries: list[str] = dataclasses.field(default_factory=list)
    # several constructions can share one root id (StaticScheduler and
    # DynamicScheduler both start `worker` targets) — keep EVERY name
    # pattern: the runtime map must forbid all of them
    name_patterns: set[str] = dataclasses.field(default_factory=set)
    multi_instance: bool = False
    decl_site: _Site | None = None


def _is_lock_chain(chain: str) -> bool:
    last = chain.split(".")[-1].lower()
    return "lock" in last


class _PlaneGraph:
    """The per-plane static analysis: functions, roots, reachability."""

    def __init__(self, spec: PlaneSpec, sources: dict[str, str]):
        self.spec = spec
        self.sources = sources
        self.violations: list[Violation] = []
        self.funcs: list[_FuncInfo] = []
        self.by_name: dict[str, list[_FuncInfo]] = {}
        self.class_init: dict[str, str] = {}   # class name -> __init__ name
        self.roots: dict[str, _Root] = {}
        self._touches_device: dict[int, bool] = {}
        self._locals_cache: dict[int, set[str]] = {}
        for rel, text in sorted(sources.items()):
            try:
                tree = ast.parse(text, filename=rel)
            except SyntaxError as e:
                self.violations.append(Violation(
                    "HL000", rel, e.lineno or 0,
                    f"unparseable source: {e.msg}"))
                continue
            self._index(rel, text.splitlines(), tree)
        self._discover_roots()
        self._reach_cache: dict[str, set[int]] = {}

    # -- indexing -----------------------------------------------------------

    def _index(self, rel: str, lines: list[str], tree: ast.Module) -> None:
        def src(node: ast.AST) -> str:
            ln = getattr(node, "lineno", 0)
            return lines[ln - 1].strip() if 0 < ln <= len(lines) else ""

        def add_func(node, qual):
            fi = _FuncInfo(name=getattr(node, "name", "<lambda>"),
                           qualname=qual, relpath=rel, node=node,
                           is_async=isinstance(node, ast.AsyncFunctionDef))
            self.funcs.append(fi)
            self.by_name.setdefault(fi.name, []).append(fi)
            self._scan(fi, src)
            return fi

        def walk_defs(node, prefix):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    add_func(child, f"{prefix}{child.name}")
                    walk_defs(child, f"{prefix}{child.name}.")
                elif isinstance(child, ast.ClassDef):
                    self.class_init[child.name] = "__init__"
                    walk_defs(child, f"{prefix}{child.name}.")
                else:
                    walk_defs(child, prefix)

        walk_defs(tree, f"{rel}::")

    def _scan(self, fi: _FuncInfo, src) -> None:
        """One pass over ``fi``'s own body (nested defs excluded — they
        are functions of their own), tracking the lexical lock stack."""
        node = fi.node
        in_init = fi.name == "__init__"
        local_names = self._func_locals(fi)

        def site(n, desc, locks):
            return _Site(fi.relpath, getattr(n, "lineno", 0), src(n), desc,
                         locks)

        def visit(n, locks: frozenset, awaited: bool = False):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                return
            if isinstance(n, ast.With):
                lock_names = frozenset(
                    _attr_chain(item.context_expr.func
                                if isinstance(item.context_expr, ast.Call)
                                else item.context_expr).split(".")[-1]
                    for item in n.items
                    if _is_lock_chain(
                        _attr_chain(item.context_expr.func
                                    if isinstance(item.context_expr, ast.Call)
                                    else item.context_expr)))
                if lock_names:
                    for ln in lock_names:
                        fi.lock_regions.append((ln, n, locks))
                    inner = locks | lock_names
                    for item in n.items:
                        visit(item.context_expr, locks)
                    for stmt in n.body:
                        visit(stmt, inner)
                    return
            if isinstance(n, ast.Await):
                visit(n.value, locks, awaited=True)
                return
            if isinstance(n, ast.Call):
                self._scan_call(fi, n, locks, awaited, site)
                for ch in ast.iter_child_nodes(n):
                    if ch is not n.func:
                        visit(ch, locks)
                # still record nested calls inside the func expression
                if isinstance(n.func, ast.Call):
                    visit(n.func, locks)
                return
            if isinstance(n, (ast.Assign, ast.AugAssign)):
                targets = (n.targets if isinstance(n, ast.Assign)
                           else [n.target])
                for t in targets:
                    if isinstance(t, ast.Attribute):
                        fi.writes.append((t.attr, site(t, f"write to "
                                                       f".{t.attr}", locks),
                                          in_init))
                    elif (isinstance(t, ast.Subscript)
                          and isinstance(t.value, ast.Name)
                          and t.value.id not in local_names):
                        fi.writes.append((f"closure:{t.value.id}",
                                          site(t, f"item write to closure "
                                               f"var {t.value.id!r}", locks),
                                          in_init))
                visit(n.value, locks)
                return
            for ch in ast.iter_child_nodes(n):
                visit(ch, locks)

        for stmt in (node.body if not isinstance(node, ast.Lambda)
                     else [node.body]):
            visit(stmt, frozenset())

        self._local_names = local_names  # last-scanned (debug aid)

    def _scan_call(self, fi: _FuncInfo, call: ast.Call, locks: frozenset,
                   awaited: bool, site) -> None:
        chain = _attr_chain(call.func)
        # dispatch through a tracked-executable table: self._exec[r](...)
        if isinstance(call.func, ast.Subscript):
            base = _attr_chain(call.func.value)
            if base.split(".")[-1] in DISPATCH_TABLE_ATTRS:
                fi.device_sites.append(site(call, "tracked dispatch through "
                                         f"{base}[...]", locks))
            return
        if not chain:
            # a method of a call's result: out.detach().cpu() reads back
            # (pool.submit(chained_prep(rf)) is scanned by its caller)
            if (isinstance(call.func, ast.Attribute)
                    and call.func.attr in DEVICE_TOUCH_FUNCS):
                fi.device_sites.append(site(
                    call, f"device-touching call .{call.func.attr}()",
                    locks))
                if not awaited:
                    fi.blocking_sites.append(site(
                        call, f"device round trip .{call.func.attr}() "
                        "blocks its thread", locks))
            return
        last = chain.split(".")[-1]
        fi.calls.append((chain, call, locks, awaited))
        # device-touching?
        if (last in DEVICE_TOUCH_FUNCS
                or any(chain.startswith(p) for p in DEVICE_PREFIXES)):
            fi.device_sites.append(site(call,
                                        f"device-touching call {chain}()",
                                        locks))
            if not awaited:
                fi.blocking_sites.append(site(
                    call, f"device round trip {chain}() blocks its thread",
                    locks))
        # blocking?
        elif not awaited:
            has_bound = (bool(call.args)
                         or _kw(call, "timeout") is not None)
            if last == "get" and not call.args and not call.keywords:
                fi.blocking_sites.append(site(
                    call, f"unbounded {chain}() — a zero-arg Queue.get "
                    "blocks forever", locks))
            elif last in BLOCKING_SUFFIXES and not has_bound:
                fi.blocking_sites.append(site(
                    call, f"unbounded {chain}() blocks its thread", locks))
            elif chain == "time.sleep":
                fi.blocking_sites.append(site(
                    call, "time.sleep() inside a coroutine stalls the "
                    "whole loop — use asyncio.sleep", locks))
        # spine mutator?
        for sp in SPINES:
            if any(_chain_matches(chain, c) for c in sp.chains):
                fi.spine_sites.setdefault(sp.name, []).append(
                    site(call, f"{sp.name} spine write via {chain}()",
                         locks))
        # in-place mutator on a shared receiver
        if last in MUTATOR_METHODS:
            recv = chain.rsplit(".", 1)[0]
            parts = recv.split(".")
            if len(parts) == 1:
                if recv not in self._func_locals(fi):
                    fi.writes.append((f"closure:{recv}",
                                      site(call, f"mutating call "
                                           f"{chain}() on closure var",
                                           locks),
                                      fi.name == "__init__"))
            else:
                fi.writes.append((parts[-1],
                                  site(call, f"mutating call {chain}()",
                                       locks),
                                  fi.name == "__init__"))

    def _func_locals(self, fi: _FuncInfo) -> set[str]:
        """Names bound inside ``fi`` (params + every assignment form) —
        a write to anything NOT in this set is closure/global state."""
        cached = self._locals_cache.get(id(fi))
        if cached is not None:
            return cached
        node = fi.node
        out: set[str] = {a.arg for a in node.args.args}
        out.update(a.arg for a in node.args.kwonlyargs)
        out.update(a.arg for a in getattr(node.args, "posonlyargs", []))
        if node.args.vararg:
            out.add(node.args.vararg.arg)
        if node.args.kwarg:
            out.add(node.args.kwarg.arg)
        nonlocals: set[str] = set()

        def names_in(tgt):
            # binding targets only: a subscript/attribute store
            # (results[i] = x) does NOT bind the receiver name
            if isinstance(tgt, ast.Name):
                out.add(tgt.id)
            elif isinstance(tgt, (ast.Tuple, ast.List)):
                for el in tgt.elts:
                    names_in(el)
            elif isinstance(tgt, ast.Starred):
                names_in(tgt.value)

        for ch in ast.walk(node):
            if isinstance(ch, (ast.Nonlocal, ast.Global)):
                nonlocals.update(ch.names)
            elif isinstance(ch, ast.Assign):
                for t in ch.targets:
                    names_in(t)
            elif isinstance(ch, (ast.AnnAssign, ast.AugAssign,
                                 ast.NamedExpr)):
                names_in(ch.target)
            elif isinstance(ch, (ast.For, ast.AsyncFor, ast.comprehension)):
                names_in(ch.target)
            elif isinstance(ch, (ast.With, ast.AsyncWith)):
                for item in ch.items:
                    if item.optional_vars is not None:
                        names_in(item.optional_vars)
            elif isinstance(ch, ast.ExceptHandler) and ch.name:
                out.add(ch.name)
        res = out - nonlocals
        self._locals_cache[id(fi)] = res
        return res

    # -- roots --------------------------------------------------------------

    def _discover_roots(self) -> None:
        ev_entries: list[str] = [f.name for f in self.funcs if f.is_async]
        ev_name: str | None = None
        # receivers that hold a ThreadPoolExecutor: construction targets
        # (self._read_pool = ThreadPoolExecutor(...)) — a `.submit` on
        # anything else (e.g. runner.submit, a plain method) is NOT a
        # pool root; names containing pool/executor also count, covering
        # locals unpacked from a factory (read_pool, prep_pool = ...)
        self._executor_vars: set[str] = set()
        for fi in self.funcs:
            for n in ast.walk(fi.node):
                if not isinstance(n, ast.Assign):
                    continue
                has_pool = any(
                    isinstance(sub, ast.Call)
                    and _attr_chain(sub.func).split(".")[-1]
                    == "ThreadPoolExecutor"
                    for sub in ast.walk(n.value))
                if has_pool:
                    for t in n.targets:
                        if isinstance(t, ast.Attribute):
                            self._executor_vars.add(t.attr)
                        elif isinstance(t, ast.Name):
                            self._executor_vars.add(t.id)
        for fi in self.funcs:
            for chain, call, locks, _aw in fi.calls:
                last = chain.split(".")[-1]
                if last == "Thread" and "hread" in chain.split(".")[-1]:
                    self._thread_root(fi, call, "thread")
                elif last == "Timer" and _chain_matches(chain,
                                                        "threading.Timer"):
                    self._thread_root(fi, call, "timer")
                elif last == "submit" and len(chain.split(".")) > 1:
                    recv = chain.rsplit(".", 1)[0].split(".")[-1]
                    if (recv in self._executor_vars
                            or "pool" in recv.lower()
                            or "executor" in recv.lower()):
                        self._pool_root(fi, call, chain)
                elif last == "call_soon_threadsafe" and call.args:
                    tgt = self._target_names(call.args[0])
                    ev_entries.extend(tgt)
        # a Thread whose target wraps asyncio.run donates its name to
        # the eventloop root (the loop runs ON that thread)
        for rid, root in list(self.roots.items()):
            if root.kind == "thread" and root.entries == ["<asyncio.run>"]:
                ev_name = ev_name or (min(root.name_patterns)
                                      if root.name_patterns else None)
                del self.roots[rid]
        if ev_entries:
            self.roots["eventloop"] = _Root(
                "eventloop", "eventloop", entries=sorted(set(ev_entries)),
                name_patterns={ev_name} if ev_name else set())
        self.roots.setdefault("main", _Root("main", "main"))

    def _target_names(self, node: ast.AST) -> list[str]:
        """Entry function names for a thread/task target expression."""
        if isinstance(node, ast.Lambda):
            # lambda: asyncio.run(self._run()) → the coroutine; else the
            # functions the lambda body calls
            for n in ast.walk(node.body):
                if (isinstance(n, ast.Call)
                        and _chain_matches(_attr_chain(n.func),
                                           "asyncio.run")):
                    return ["<asyncio.run>"]
            return [_attr_chain(n.func).split(".")[-1]
                    for n in ast.walk(node.body)
                    if isinstance(n, ast.Call) and _attr_chain(n.func)]
        chain = _attr_chain(node)
        if chain:
            return [chain.split(".")[-1]]
        return []

    def _in_loop_or_comp(self, fi: _FuncInfo, call: ast.Call) -> bool:
        for n in ast.walk(fi.node):
            if isinstance(n, (ast.ListComp, ast.GeneratorExp, ast.For,
                              ast.While)):
                for sub in ast.walk(n):
                    if sub is call:
                        return True
        return False

    def _thread_root(self, fi: _FuncInfo, call: ast.Call,
                     kind: str) -> None:
        target = _kw(call, "target")
        if target is None and kind == "timer" and len(call.args) >= 2:
            target = call.args[1]
        entries = self._target_names(target) if target is not None else []
        name_pat = _name_pattern(_kw(call, "name"))
        # a later `t.name = "..."` in the same function also names it
        if name_pat is None:
            for n in ast.walk(fi.node):
                if (isinstance(n, ast.Assign) and len(n.targets) == 1
                        and isinstance(n.targets[0], ast.Attribute)
                        and n.targets[0].attr == "name"):
                    name_pat = _name_pattern(n.value)
        ent = entries[0] if entries else f"@{fi.qualname}:{call.lineno}"
        rid = f"{kind}:{ent}"
        src = self.sources.get(fi.relpath, "").splitlines()
        line = src[call.lineno - 1].strip() if call.lineno <= len(src) else ""
        decl = _Site(fi.relpath, call.lineno, line,
                     f"{kind} root {rid}")
        root = self.roots.setdefault(rid, _Root(rid, kind,
                                                decl_site=decl))
        root.entries = sorted(set(root.entries) | set(entries))
        if name_pat:
            root.name_patterns.add(name_pat)
        if self._in_loop_or_comp(fi, call):
            root.multi_instance = True
        # HL405: daemon flag or bounded join
        self._check_hl405(fi, call, kind, decl)

    def _check_hl405(self, fi: _FuncInfo, call: ast.Call, kind: str,
                     decl: _Site) -> None:
        d = _kw(call, "daemon")
        if isinstance(d, ast.Constant) and d.value is True:
            return
        for n in ast.walk(fi.node):
            # X.daemon = True after construction
            if (isinstance(n, ast.Assign)
                    and any(isinstance(t, ast.Attribute)
                            and t.attr == "daemon" for t in n.targets)
                    and isinstance(n.value, ast.Constant)
                    and n.value.value is True):
                return
            # bounded join anywhere in the constructing module scope
            if (isinstance(n, ast.Call)
                    and _attr_chain(n.func).split(".")[-1] == "join"
                    and (n.args or _kw(n, "timeout") is not None)):
                return
        self.violations.append(Violation(
            "HL405", decl.relpath, decl.line,
            f"{kind} started with neither daemon=True nor a bounded "
            "join(timeout) on a shutdown path — a forgotten non-daemon "
            "thread hangs process exit (typically inside a collective or "
            "a device wait)",
            decl.source))

    def _pool_root(self, fi: _FuncInfo, call: ast.Call,
                   chain: str) -> None:
        recv = chain.rsplit(".", 1)[0].split(".")[-1]
        norm = recv.lstrip("_").removesuffix("_pool").removesuffix("pool") \
            .strip("_") or recv
        if not call.args:
            return
        entries = self._target_names(call.args[0])
        if isinstance(call.args[0], ast.Call):
            # pool.submit(chained_prep(rf)): the factory's nested defs run
            fac = _attr_chain(call.args[0].func).split(".")[-1]
            entries = [fac]
            for f in self.by_name.get(fac, []):
                for ch in ast.walk(f.node):
                    if isinstance(ch, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                        entries.append(ch.name)
        if not entries:
            return
        rid = f"pool:{norm}"
        # the pool's thread_name_prefix (from its construction, matched
        # by the normalized variable name) → "prefix*" runtime pattern
        name_pat = None
        for f in self.funcs:
            for c2, call2, _locks2, _aw2 in f.calls:
                if c2.split(".")[-1] == "ThreadPoolExecutor":
                    pref = _name_pattern(_kw(call2, "thread_name_prefix"))
                    tgt = None
                    for n in ast.walk(f.node):
                        if (isinstance(n, ast.Assign)
                                and any(isinstance(t, ast.Attribute)
                                        for t in n.targets)):
                            for sub in ast.walk(n.value):
                                if sub is call2:
                                    t0 = n.targets[0]
                                    if isinstance(t0, ast.Attribute):
                                        tgt = t0.attr
                    if pref and tgt is not None:
                        tnorm = (tgt.lstrip("_").removesuffix("_pool")
                                 .removesuffix("pool").strip("_") or tgt)
                        if tnorm == norm:
                            name_pat = pref + "*"
        src = self.sources.get(fi.relpath, "").splitlines()
        line = (src[call.lineno - 1].strip()
                if call.lineno <= len(src) else "")
        decl = _Site(fi.relpath, call.lineno, line, f"pool root {rid}")
        root = self.roots.setdefault(
            rid, _Root(rid, "pool", multi_instance=True, decl_site=decl))
        root.entries = sorted(set(root.entries) | set(entries))
        if name_pat:
            root.name_patterns.add(name_pat)

    # -- reachability -------------------------------------------------------

    def reach(self, rid: str) -> set[int]:
        """ids of _FuncInfo reachable from root ``rid`` (main = residual:
        every function no other root reaches)."""
        if rid in self._reach_cache:
            return self._reach_cache[rid]
        if rid == "main":
            others: set[int] = set()
            for other in self.roots:
                if other != "main":
                    others |= self.reach(other)
            out = {id(f) for f in self.funcs} - others
            self._reach_cache[rid] = out
            return out
        root = self.roots[rid]
        seen: set[int] = set()
        frontier: list[_FuncInfo] = []
        for name in root.entries:
            frontier.extend(self.by_name.get(name, []))
        while frontier:
            fi = frontier.pop()
            if id(fi) in seen:
                continue
            seen.add(id(fi))
            for chain, call, _locks, awaited in fi.calls:
                last = chain.split(".")[-1]
                cands = list(self.by_name.get(last, []))
                if awaited:
                    # an awaited call targets a coroutine — a sync plane
                    # method sharing the name (ContinuousRunner.drain vs
                    # asyncio's writer.drain()) is NOT the callee
                    cands = [c for c in cands if c.is_async]
                if last in self.class_init or chain in self.class_init:
                    cls = last if last in self.class_init else chain
                    cands.extend(f for f in self.by_name.get("__init__", [])
                                 if f.qualname.startswith(f"{f.relpath}::")
                                 and f".{cls}." in "." + f.qualname
                                 .split("::", 1)[1] + ".")
                frontier.extend(c for c in cands if id(c) not in seen)
        self._reach_cache[rid] = seen
        return seen

    def roots_of(self, fi: _FuncInfo) -> list[str]:
        out = [rid for rid in self.roots
               if rid != "main" and id(fi) in self.reach(rid)]
        return out or ["main"]

    def funcs_in(self, ids: set[int]) -> list[_FuncInfo]:
        return [f for f in self.funcs if id(f) in ids]


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------

def _check_hl401(g: _PlaneGraph) -> None:
    owners = set(g.spec.device_owners)
    for rid, root in sorted(g.roots.items()):
        if rid in owners:
            continue
        for fi in g.funcs_in(g.reach(rid)):
            for s in fi.device_sites:
                g.violations.append(Violation(
                    "HL401", s.relpath, s.line,
                    f"[{g.spec.name}] {s.desc} reachable from thread root "
                    f"{rid!r}: only {sorted(owners)} may touch the device "
                    "on this plane (route the work through the designated "
                    "owner, e.g. the dispatcher queue)", s.source))


def _check_hl402(g: _PlaneGraph) -> None:
    if "eventloop" not in g.roots:
        return
    for fi in g.funcs_in(g.reach("eventloop")):
        for s in fi.blocking_sites:
            g.violations.append(Violation(
                "HL402", s.relpath, s.line,
                f"[{g.spec.name}] {s.desc} — reachable from the event "
                "loop: every socket the loop owns freezes for the "
                "duration (await it, bound it, or move it to the "
                "dispatcher thread)", s.source))


def _check_hl403(g: _PlaneGraph,
                 spine_locked: dict[str, bool]) -> None:
    # spines first: multi-root writers are clean ONLY if the spine's own
    # mutators are verified internally locked
    spine_writers: dict[str, dict[str, list[_Site]]] = {}
    for fi in g.funcs:
        for sp_name, sites in fi.spine_sites.items():
            for rid in g.roots_of(fi):
                spine_writers.setdefault(sp_name, {}).setdefault(
                    rid, []).extend(sites)
    for sp_name, by_root in sorted(spine_writers.items()):
        multi = (len(by_root) > 1
                 or any(g.roots[r].multi_instance for r in by_root))
        if not multi or spine_locked.get(sp_name, False):
            continue
        first = min((s for ss in by_root.values() for s in ss),
                    key=lambda s: (s.relpath, s.line))
        g.violations.append(Violation(
            "HL403", first.relpath, first.line,
            f"[{g.spec.name}] telemetry spine {sp_name!r} written from "
            f"roots {sorted(by_root)} but its mutators are not "
            "internally locked — the single-writer contract is broken "
            "(add a lock inside the spine's mutators, or route all "
            "writes through one root)", first.source))
    # plain shared state: attr / closure keys
    writers: dict[str, dict[str, list[_Site]]] = {}
    for fi in g.funcs:
        for key, s, in_init in fi.writes:
            if in_init:
                continue  # construction happens-before any thread start
            for rid in g.roots_of(fi):
                writers.setdefault(key, {}).setdefault(rid, []).append(s)
    for key, by_root in sorted(writers.items()):
        multi = (len(by_root) > 1
                 or any(g.roots[r].multi_instance for r in by_root))
        if not multi:
            continue
        lock_sets = [s.locks for ss in by_root.values() for s in ss]
        if lock_sets and frozenset.intersection(*lock_sets):
            continue  # every write path shares a lock
        first = min((s for ss in by_root.values() for s in ss),
                    key=lambda s: (s.relpath, s.line))
        which = (f"roots {sorted(by_root)}" if len(by_root) > 1
                 else f"multi-instance root {next(iter(by_root))!r}")
        g.violations.append(Violation(
            "HL403", first.relpath, first.line,
            f"[{g.spec.name}] shared state {key!r} written from {which} "
            "with no common lock on the write path — take one lock "
            "around every write, or confine the state to one root",
            first.source))


def _check_hl404(g: _PlaneGraph) -> None:
    # transitive within-plane: does a function touch the device itself or via
    # plane-resolvable calls?
    touches: dict[int, bool] = {}

    def fn_touches(fi: _FuncInfo, stack: set[int]) -> bool:
        if id(fi) in touches:
            return touches[id(fi)]
        if id(fi) in stack:
            return False
        stack.add(id(fi))
        out = bool(fi.device_sites)
        if not out:
            for chain, call, _locks, awaited in fi.calls:
                last = chain.split(".")[-1]
                cands = g.by_name.get(last, [])
                if awaited:
                    cands = [c for c in cands if c.is_async]
                if any(fn_touches(c, stack) for c in cands):
                    out = True
                    break
        touches[id(fi)] = out
        return out

    for fi in g.funcs:
        for lock_name, with_node, _outer in fi.lock_regions:
            for n in ast.walk(with_node):
                if n is with_node:
                    continue
                if isinstance(n, ast.Call):
                    chain = _attr_chain(n.func)
                    direct = ((isinstance(n.func, ast.Subscript)
                               and _attr_chain(n.func.value).split(".")[-1]
                               in DISPATCH_TABLE_ATTRS)
                              # out.detach().cpu(): a call's method
                              or (not chain
                                  and isinstance(n.func, ast.Attribute)
                                  and n.func.attr in DEVICE_TOUCH_FUNCS))
                    last = chain.split(".")[-1] if chain else ""
                    via = (last in DEVICE_TOUCH_FUNCS
                           or any(chain.startswith(p)
                                  for p in DEVICE_PREFIXES)
                           or any(fn_touches(c, set())
                                  for c in g.by_name.get(last, [])))
                    if direct or via:
                        src = g.sources.get(fi.relpath, "").splitlines()
                        line = getattr(n, "lineno", 0)
                        text = (src[line - 1].strip()
                                if 0 < line <= len(src) else "")
                        g.violations.append(Violation(
                            "HL404", fi.relpath, line,
                            f"[{g.spec.name}] dispatch/readback reachable "
                            f"while holding {lock_name!r}: every other "
                            "thread wanting the lock waits for the card "
                            "(release the lock before touching the "
                            "device)", text))


# ---------------------------------------------------------------------------
# Spine lock verification
# ---------------------------------------------------------------------------

def _spine_locked_from_source(spec: SpineSpec, text: str) -> bool:
    """True iff every mutator of ``spec`` guards its body with a lock
    (``with self._lock`` / any attr whose name contains "lock")."""
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return False
    bodies: list[ast.AST] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == spec.cls:
            for ch in node.body:
                if (isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and ch.name in spec.mutators):
                    bodies.append(ch)
        elif (spec.cls is None
              and isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
              and node.name in spec.mutators
              and isinstance(tree, ast.Module) and node in tree.body):
            bodies.append(node)
    if len(bodies) < len(spec.mutators):
        return False
    for fn in bodies:
        locked = False
        for n in ast.walk(fn):
            if isinstance(n, ast.With):
                for item in n.items:
                    ctx = (item.context_expr.func
                           if isinstance(item.context_expr, ast.Call)
                           else item.context_expr)
                    if _is_lock_chain(_attr_chain(ctx)):
                        locked = True
        if not locked:
            return False
    return True


def spine_lock_verdicts(repo: str) -> dict[str, bool]:
    out: dict[str, bool] = {}
    for sp in SPINES:
        path = os.path.join(repo, sp.module)
        try:
            with open(path, encoding="utf-8") as fh:
                out[sp.name] = _spine_locked_from_source(sp, fh.read())
        except OSError:
            out[sp.name] = False
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

#: plane name -> (cache key, built graph); keyed on (path, mtime, size)
#: so ``lint --changed`` and repeated in-process runs (tier-1 calls the
#: CLI many times) re-analyze only planes whose files changed.
_CACHE: dict[str, tuple[tuple, _PlaneGraph]] = {}


def _plane_key(repo: str, spec: PlaneSpec) -> tuple:
    out = []
    for rel in spec.modules:
        path = os.path.join(repo, rel)
        try:
            st = os.stat(path)
            out.append((rel, st.st_mtime_ns, st.st_size))
        except OSError:
            out.append((rel, 0, 0))
    return tuple(out)


def _plane_graph(repo: str, spec: PlaneSpec) -> _PlaneGraph:
    key = _plane_key(repo, spec)
    hit = _CACHE.get(spec.name)
    if hit is not None and hit[0] == key:
        return hit[1]
    sources: dict[str, str] = {}
    for rel in spec.modules:
        path = os.path.join(repo, rel)
        if os.path.exists(path):
            with open(path, encoding="utf-8") as fh:
                sources[rel] = fh.read()
    g = _analyze(spec, sources, spine_lock_verdicts(repo))
    _CACHE[spec.name] = (key, g)
    return g


def _analyze(spec: PlaneSpec, sources: dict[str, str],
             spine_locked: dict[str, bool]) -> _PlaneGraph:
    g = _PlaneGraph(spec, sources)
    _check_hl401(g)
    _check_hl402(g)
    _check_hl403(g, spine_locked)
    _check_hl404(g)
    return g


def analyze_sources(spec: PlaneSpec, sources: dict[str, str],
                    spine_locked: dict[str, bool] | None = None
                    ) -> list[Violation]:
    """Fixture entry: analyze in-memory sources as one plane (the
    sabotaged-twin tests drive every rule through this)."""
    return _analyze(spec, sources, spine_locked or {}).violations


def planes_for_paths(relpaths) -> list[str]:
    """Plane names owning any of ``relpaths`` — the ``lint --changed``
    scope (a spine module change re-runs every plane: the lock verdicts
    feed all of them)."""
    rels = {p.replace(os.sep, "/") for p in relpaths}
    spine_mods = {sp.module for sp in SPINES}
    if rels & spine_mods:
        return [p.name for p in PLANES]
    return [p.name for p in PLANES if rels & set(p.modules)]


def analyze_repo(repo: str, only: list[str] | None = None
                 ) -> list[Violation]:
    """Run the threads layer over the repo's planes (all, or the ``only``
    subset for ``--changed`` runs)."""
    out: list[Violation] = []
    for spec in PLANES:
        if only is not None and spec.name not in only:
            continue
        out.extend(_plane_graph(repo, spec).violations)
    return out


def ownership_map(repo: str | None = None) -> dict:
    """The runtime twin's contract, generated from the static graph:
    per-plane device owners, the forbidden thread-name patterns (named
    non-owner roots), and the spine lock verdicts.  threadguard arms
    exactly this, so the runtime map cannot drift from the graph."""
    if repo is None:
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    planes: dict[str, dict] = {}
    forbidden: set[str] = set()
    for spec in PLANES:
        g = _plane_graph(repo, spec)
        pats = sorted({p for rid, root in g.roots.items()
                       if rid not in spec.device_owners
                       for p in root.name_patterns})
        planes[spec.name] = {
            "device_owners": sorted(spec.device_owners),
            "roots": sorted(g.roots),
            "forbidden_thread_patterns": pats,
        }
        forbidden.update(pats)
    verdicts = spine_lock_verdicts(repo)
    spines = {sp.name: {"locked": bool(verdicts.get(sp.name)),
                        "module": sp.import_path, "obj": sp.obj,
                        "mutators": list(sp.mutators)}
              for sp in SPINES}
    return {"planes": planes,
            "forbidden_thread_patterns": sorted(forbidden),
            "spines": spines}
