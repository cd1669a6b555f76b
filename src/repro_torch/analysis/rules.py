"""The port's AST rule pack.

Port of `repro.analysis.rules`. Six rules apply to any Python and are
the reference's, unchanged in behaviour: `np-index-dtype`,
`driver-thread-affinity` (its marker is
`repro_torch.concurrency.driver_thread_only`), `telemetry-eager-format`,
`mutable-default`, `broad-except-pass` and `wallclock-ban`. Each of the
reference's four JAX rules has a torch counterpart under an id of its
own, guarding the same bug class in its torch form:

    prng-key-reuse        -> global-rng         (draws off the global stream)
    traced-python-branch  -> host-sync-in-cell  (host reads in a tracked cell)
    numpy-in-jit          -> numpy-in-cell      (host numpy in a tracked cell)
    jit-donate-pool       -> track-donate-pool  (a seat cell that keeps its pool)

A "cell" is a function handed to `probe.track(name, fn, ...)`
(`obs.torchprobe`), the port's counterpart of a jitted function: the
three cell rules share one resolver of `.track(...)` call sites
(`tracked_sites`) that follows an inline lambda, a def of that name in
the enclosing scopes or the module, a name or module alias bound by an
import, a method of the enclosing class (and of its bases), and a
factory's returned function, through `functools.partial` and
`self._cell(...)`-style wrappers. A site it cannot resolve unambiguously
(a method of an instance of unknown type, such as
`self.model.decode_step`) is skipped, not guessed: like the reference's
rules, these trade generality for a near-zero false-positive rate on
this codebase.

Each rule is an object with `rule_id` / `summary` / `incident` and a
`check(ctx, info) -> list[Finding]`; cross-file rules also implement
`prepare(ctx)` (run once over the whole file set before any check).
The shared rules' incidents are the reference's, which CHANGES.md
records; the torch rules' name the reference rule each stands for.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Optional

# dotted-name helpers (the reference's) -------------------------------------------------------


def dotted(node) -> str:
    """'jax.random.normal' for an Attribute/Name chain, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def terminal_name(node) -> str:
    """Last identifier of a Name/Attribute ('scatter_pages' for
    `seating.scatter_pages`), '' otherwise."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def iter_scopes(tree):
    """Yield (scope_node, body_stmts) for the module and every
    function def, at any nesting depth."""
    yield tree, tree.body
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node, node.body


def walk_scope(stmts):
    """Walk every node under `stmts` without descending into nested
    function/class defs (those get their own scope)."""
    stack = list(stmts)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            stack.append(child)


# ---------------------------------------------------------------------------
# np-index-dtype — the `mark_urgent([])` class
# ---------------------------------------------------------------------------

_NP_CTORS = ("np.asarray", "np.array", "numpy.asarray", "numpy.array")
_INDEX_CONSUMERS = (
    "np.nonzero", "np.flatnonzero", "np.argwhere", "np.where",
    "numpy.nonzero", "numpy.flatnonzero", "numpy.argwhere", "numpy.where",
)
_BITOPS = (ast.BitOr, ast.BitAnd, ast.BitXor)


def _unpinned_np_call(node):
    """The np.asarray/np.array Call node if it has no dtype pin."""
    if (isinstance(node, ast.Call) and dotted(node.func) in _NP_CTORS
            and len(node.args) == 1
            and not any(k.arg == "dtype" for k in node.keywords)):
        return node
    return None


class NpIndexDtypeRule:
    rule_id = "np-index-dtype"
    summary = ("dtype-unpinned np.asarray/np.array result used as an "
               "index or boolean mask")
    incident = ("`mark_urgent([])` — an empty Python list becomes "
                "float64, crashing integer indexing only on the "
                "empty-input path")

    def check(self, ctx, info):
        findings = []
        flagged = set()

        def flag(call_node, how):
            if id(call_node) in flagged:
                return
            flagged.add(id(call_node))
            findings.append(info.finding(
                self.rule_id, call_node,
                f"{ast.unparse(call_node.func)}(...) without an explicit "
                f"dtype is {how}; an empty input defaults to float64 "
                f"(pin dtype=bool / np.intp)",
            ))

        for _scope, body in iter_scopes(info.tree):
            tracked = {}
            for node in walk_scope(body):
                if (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)):
                    call = _unpinned_np_call(node.value)
                    if call is not None:
                        tracked[node.targets[0].id] = call

            def resolve(expr):
                call = _unpinned_np_call(expr)
                if call is not None:
                    return call
                if isinstance(expr, ast.Name):
                    return tracked.get(expr.id)
                return None

            for node in walk_scope(body):
                if isinstance(node, ast.Subscript):
                    idx = node.slice
                    parts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
                    for p in parts:
                        call = resolve(p)
                        if call is not None:
                            flag(call, "used as a subscript index")
                elif isinstance(node, ast.BinOp) and isinstance(
                        node.op, _BITOPS):
                    for p in (node.left, node.right):
                        call = resolve(p)
                        if call is not None:
                            flag(call, "combined with a bitwise mask op")
                elif isinstance(node, ast.UnaryOp) and isinstance(
                        node.op, ast.Invert):
                    call = resolve(node.operand)
                    if call is not None:
                        flag(call, "inverted as a boolean mask")
                elif (isinstance(node, ast.Call)
                      and dotted(node.func) in _INDEX_CONSUMERS):
                    for p in node.args:
                        call = resolve(p)
                        if call is not None:
                            flag(call, "fed to an index-producing "
                                       "numpy reduction")
        return findings


# ---------------------------------------------------------------------------
# global-rng — the torch form of prng-key-reuse
# ---------------------------------------------------------------------------

_TORCH_SAMPLERS = {
    f"torch.{name}" for name in (
        "rand", "randn", "randint", "randperm", "normal", "bernoulli",
        "multinomial", "rand_like", "randn_like", "randint_like",
    )
}
_INPLACE_SAMPLERS = {
    "uniform_", "normal_", "bernoulli_", "random_", "exponential_",
}


class GlobalRngRule:
    rule_id = "global-rng"
    summary = ("torch sampler without generator= (or torch.manual_seed): "
               "a draw from the process-wide RNG stream")
    incident = ("stands for prng-key-reuse: a draw from the global stream "
                "correlates 'independent' samples through call order, "
                "the silent correlation that rule guards; the port's "
                "ground rule is an explicit torch.Generator for every "
                "draw (ROADMAP ground rules)")

    def check(self, ctx, info):
        findings = []
        for node in ast.walk(info.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            if name == "torch.manual_seed":
                findings.append(info.finding(
                    self.rule_id, node,
                    "torch.manual_seed(...) reseeds the process-wide "
                    "stream every later unseeded draw reads; seed a "
                    "torch.Generator and pass it as generator=",
                ))
                continue
            sampler = name in _TORCH_SAMPLERS or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _INPLACE_SAMPLERS)
            if sampler and not any(k.arg == "generator"
                                   for k in node.keywords):
                findings.append(info.finding(
                    self.rule_id, node,
                    f"`{ast.unparse(node.func)}(...)` draws from the "
                    f"global RNG stream; pass generator= (a seeded "
                    f"torch.Generator)",
                ))
        return findings


# ---------------------------------------------------------------------------
# tracked cells — the `.track(name, fn, ...)` sites and what `fn` resolves to
# ---------------------------------------------------------------------------

_POOL_FUNCS = {"scatter_slots", "scatter_pages"}
_CELL_WRAPPERS = {"_cell"}  # one-argument wrappers that run their argument
_PARTIAL = ("functools.partial", "partial")
_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)
_MAX_DEPTH = 8


@dataclasses.dataclass
class Target:
    """One function a tracked cell may run: its def or lambda `node` in
    the file `info`, or (node None) only a pool-function `name`."""

    info: object
    node: Optional[ast.AST]
    name: str = ""


@dataclasses.dataclass
class TrackSite:
    """One `.track(name, fn, ...)` call in `info`; `targets` is what `fn`
    resolves to, None where it does not resolve unambiguously."""

    info: object
    call: ast.Call
    targets: Optional[list]

    @property
    def cell(self) -> str:
        arg = self.call.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value
        return ast.unparse(arg)


def _is_track(node) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "track" and len(node.args) >= 2)


def _first_param(fn) -> str:
    a = fn.args
    params = a.posonlyargs + a.args
    return params[0].arg if params else ""


_NESTED = _DEFS + (ast.ClassDef, ast.Lambda, ast.ListComp, ast.SetComp,
                  ast.DictComp, ast.GeneratorExp)


def _scope_bindings(stmts, name):
    """(defs, classes, assigned values, other) binding `name` in one
    scope's statements, nested scopes not: `values` holds the right
    sides of plain `name = value` statements, `other` is True if a loop,
    an unpacking or a `with` binds it too."""
    defs, classes, values, stores = [], [], [], 0
    stack = list(stmts)
    while stack:
        node = stack.pop()
        if isinstance(node, _NESTED):
            if isinstance(node, _DEFS) and node.name == name:
                defs.append(node)
            elif isinstance(node, ast.ClassDef) and node.name == name:
                classes.append(node)
            continue
        if (isinstance(node, ast.Name) and node.id == name
                and isinstance(node.ctx, ast.Store)):
            stores += 1
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == name):
            values.append(node.value)
        stack.extend(ast.iter_child_nodes(node))
    return defs, classes, values, stores > len(values)


class _Index:
    """What the resolver needs of the scanned files: each file's parents,
    import bindings and `.track(...)` calls, and the files by dotted
    module name."""

    def __init__(self, files):
        self.modules = {}
        self.parents = {}
        self.imports = {}
        self.tracks = []
        for info in files:
            parts = Path(info.rel).with_suffix("").parts
            if parts and parts[-1] == "__init__":
                parts = parts[:-1]
            for i in range(len(parts)):
                self.modules.setdefault(".".join(parts[i:]), []).append(info)
            parents, imports, tracks = {}, {}, []
            stack = [info.tree]
            while stack:  # one walk a file: ast.walk would be a second
                node = stack.pop()
                for child in ast.iter_child_nodes(node):
                    parents[child] = node
                    stack.append(child)
                if isinstance(node, ast.Import):
                    for a in node.names:
                        if a.asname:
                            self._bind(imports, a.asname, ("module", a.name))
                elif isinstance(node, ast.ImportFrom) and not node.level:
                    for a in node.names:
                        self._bind(imports, a.asname or a.name,
                                   ("from", node.module, a.name))
                elif _is_track(node):
                    tracks.append(node)
            tracks.sort(key=lambda n: (n.lineno, n.col_offset))
            self.tracks.extend((info, node) for node in tracks)
            self.parents[id(info)] = parents
            self.imports[id(info)] = imports

    @staticmethod
    def _bind(imports, alias, what):
        # an alias bound to two different things is ambiguous
        imports[alias] = what if imports.get(alias, what) == what else None

    def module(self, name):
        infos = self.modules.get(name) or []
        return infos[0] if len(infos) == 1 else None

    def scopes(self, info, node):
        """The function scopes enclosing `node`, innermost first."""
        parents = self.parents[id(info)]
        out = []
        node = parents.get(node)
        while node is not None:
            if isinstance(node, _DEFS + (ast.Lambda,)):
                out.append(node)
            node = parents.get(node)
        return out

    def enclosing_class(self, info, node):
        """The class whose method encloses `node`, if any."""
        parents = self.parents[id(info)]
        node = parents.get(node)
        while node is not None:
            parent = parents.get(node)
            if isinstance(node, _DEFS) and isinstance(parent, ast.ClassDef):
                return parent
            node = parent
        return None

    # -- name lookup -------------------------------------------------------

    def lookup(self, info, node, name, depth):
        """What `name`, read at `node` in `info`, binds: a list of
        `Target`s or (info, ClassDef) / ("module", info) tuples in a
        one-item list; None when it does not resolve."""
        for scope in self.scopes(info, node):
            a = scope.args
            if name in {p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs
                                        + [a.vararg, a.kwarg]) if p}:
                return None  # a parameter: any function at all
            if isinstance(scope, ast.Lambda):
                continue
            found = self._in_scope(info, scope.body, name, depth)
            if found is not None:
                return found or None
        found = self._in_scope(info, info.tree.body, name, depth)
        if found is not None:
            return found or None
        bound = self.imports[id(info)].get(name)
        if bound is None:
            return None
        if bound[0] == "module":
            mod = self.module(bound[1])
            return [("module", mod)] if mod is not None else None
        _kind, mod_name, attr = bound
        sub = self.module(f"{mod_name}.{attr}")
        if sub is not None:
            return [("module", sub)]
        mod = self.module(mod_name)
        return self.member(mod, attr, depth) if mod is not None else None

    def _in_scope(self, info, stmts, name, depth):
        """None if `name` is not bound in these statements; [] if it is
        bound ambiguously; else what it binds."""
        defs, classes, values, other = _scope_bindings(stmts, name)
        if len(defs) + len(classes) > 1 or other:
            return []
        if defs:
            return [Target(info, defs[0])]
        if classes:
            return [(info, classes[0])]
        if len(values) == 1:
            return resolve(self, info, values[0], depth + 1) or []
        return [] if values else None

    def member(self, mod_info, attr, depth):
        """A module-level def or class `attr` of the file `mod_info`."""
        found = self._in_scope(mod_info, mod_info.tree.body, attr, depth)
        return found or None

    def method(self, info, cls, attr, depth):
        """`attr` of class `cls` in `info`, or of its bases in turn."""
        if depth > _MAX_DEPTH:
            return None
        defs = _scope_bindings(cls.body, attr)[0]
        if len(defs) == 1:
            return [Target(info, defs[0])]
        if defs:
            return None
        for base in cls.bases:
            if not isinstance(base, ast.Name):
                continue
            bound = self.lookup(info, cls, base.id, depth + 1)
            if (bound and len(bound) == 1 and isinstance(bound[0], tuple)
                    and isinstance(bound[0][1], ast.ClassDef)):
                found = self.method(bound[0][0], bound[0][1], attr,
                                    depth + 1)
                if found is not None:
                    return found
        return None


def _returns(info, fn):
    """The value expressions a def returns (a lambda: its body), each
    with its file; None if there is none. Nested scopes' returns are
    theirs, not the def's."""
    if isinstance(fn, ast.Lambda):
        return [(info, fn.body)]
    out, stack = [], list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, _NESTED):
            continue
        if isinstance(node, ast.Return) and node.value is not None:
            out.append((info, node.value))
        stack.extend(ast.iter_child_nodes(node))
    return out or None


def _factory_returns(index, info, call, depth):
    """(file, expression) of every value the function `call` calls can
    return; None if the callee does not resolve to defs."""
    callees = resolve(index, info, call.func, depth + 1)
    if not callees:
        return None
    out = []
    for t in callees:
        if not isinstance(t, Target) or t.node is None:
            return None
        rets = _returns(t.info, t.node)
        if rets is None:
            return None
        out.extend(rets)
    return out


def _name_only(expr):
    name = terminal_name(expr)
    return [Target(None, None, name)] if name in _POOL_FUNCS else None


def resolve(index, info, expr, depth=0):
    """The functions `expr` (read in `info`) evaluates to, as `Target`s;
    None where that is not known unambiguously."""
    if depth > _MAX_DEPTH:
        return None
    if isinstance(expr, ast.Lambda):
        return [Target(info, expr)]
    if isinstance(expr, ast.Name):
        found = index.lookup(info, expr, expr.id, depth)
        if found and all(isinstance(t, Target) for t in found):
            return found
        return _name_only(expr)
    if isinstance(expr, ast.Attribute):
        found = None
        base = expr.value
        if isinstance(base, ast.Name) and base.id == "self":
            cls = index.enclosing_class(info, expr)
            if cls is not None:
                found = index.method(info, cls, expr.attr, depth + 1)
        elif isinstance(base, ast.Name):
            bound = index.lookup(info, expr, base.id, depth + 1)
            if bound and len(bound) == 1 and isinstance(bound[0], tuple) \
                    and bound[0][0] == "module":
                found = index.member(bound[0][1], expr.attr, depth + 1)
        if found and all(isinstance(t, Target) for t in found):
            return found
        return _name_only(expr)
    if isinstance(expr, ast.Call):
        if dotted(expr.func) in _PARTIAL and expr.args:
            return resolve(index, info, expr.args[0], depth + 1)
        if terminal_name(expr.func) in _CELL_WRAPPERS and len(expr.args) == 1:
            return resolve(index, info, expr.args[0], depth + 1)
        rets = _factory_returns(index, info, expr, depth)
        return _resolve_all(index, rets, depth)
    if (isinstance(expr, ast.Subscript) and isinstance(expr.value, ast.Call)
            and isinstance(expr.slice, ast.Constant)
            and isinstance(expr.slice.value, int)):
        rets = _factory_returns(index, info, expr.value, depth)
        k = expr.slice.value
        if rets is None or not all(
                isinstance(v, ast.Tuple) and -len(v.elts) <= k < len(v.elts)
                for _i, v in rets):
            return None
        return _resolve_all(index, [(i, v.elts[k]) for i, v in rets], depth)
    return None


def _resolve_all(index, exprs, depth):
    if not exprs:
        return None
    out, seen = [], set()
    for i, v in exprs:
        found = resolve(index, i, v, depth + 1)
        if found is None:
            return None
        for t in found:
            key = id(t.node) if t.node is not None else t.name
            if key not in seen:
                seen.add(key)
                out.append(t)
    return out


def tracked_sites(ctx) -> list:
    """Every `.track(name, fn, ...)` site of the scan with what its `fn`
    resolves to; computed once a scan and kept on `ctx`."""
    if ctx.tracked is None:
        index = _Index(ctx.files)
        ctx.tracked = [
            TrackSite(info, node, resolve(index, info, node.args[1]))
            for info, node in index.tracks
        ]
    return ctx.tracked


def cell_bodies(ctx, info) -> list:
    """(cell name, def or lambda) for every resolved cell function that
    lives in `info`, each function once."""
    out, seen = [], set()
    for site in tracked_sites(ctx):
        for t in site.targets or ():
            if t.node is not None and t.info is info and id(t.node) not in seen:
                seen.add(id(t.node))
                out.append((site.cell, t.node))
    return out


def _fn_label(fn) -> str:
    return fn.name if isinstance(fn, _DEFS) else "<lambda>"


# ---------------------------------------------------------------------------
# host-sync-in-cell — the torch form of traced-python-branch
# ---------------------------------------------------------------------------

_HOST_READS = {"item", "tolist", "numpy", "cpu"}
_REDUCTIONS = {"any", "all"}


def _is_cpu(node) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


class HostSyncInCellRule:
    rule_id = "host-sync-in-cell"
    summary = ("host read inside a tracked cell (.item() / .tolist() / "
               ".numpy() / .cpu() / .to('cpu'), or a Python if/while on "
               ".any() / .all()): a device-to-host sync every call")
    incident = ("stands for traced-python-branch: the reads the card's "
                "cell audit flags (the port's serve and stream cells once "
                "held such reads, repaired by hand), which the CPU's "
                "audit cannot see because a host read of a CPU tensor "
                "is no sync")

    def prepare(self, ctx):
        tracked_sites(ctx)

    def check(self, ctx, info):
        findings = []
        for cell, fn in cell_bodies(ctx, info):
            for sub in ast.walk(fn):
                what = self._host_read(sub)
                if what:
                    findings.append(info.finding(
                        self.rule_id, sub,
                        f"{what} inside tracked cell `{cell}` "
                        f"(`{_fn_label(fn)}`) reads the device on the "
                        f"host every call; keep the value on the device",
                    ))
                elif isinstance(sub, (ast.If, ast.While)):
                    red = self._reduction(sub.test)
                    if red:
                        kw = "while" if isinstance(sub, ast.While) else "if"
                        findings.append(info.finding(
                            self.rule_id, sub,
                            f"Python `{kw}` on `.{red}()` inside tracked "
                            f"cell `{cell}` (`{_fn_label(fn)}`) syncs the "
                            f"host on a device value; use torch.where or "
                            f"decide outside the cell",
                        ))
        return findings

    @staticmethod
    def _host_read(node) -> str:
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            return ""
        attr = node.func.attr
        if attr in _HOST_READS and not node.args:
            return f"`.{attr}()`"
        if attr == "to" and (
                (node.args and _is_cpu(node.args[0]))
                or any(k.arg == "device" and _is_cpu(k.value)
                       for k in node.keywords)):
            return "`.to(\"cpu\")`"
        return ""

    @staticmethod
    def _reduction(test) -> str:
        for node in ast.walk(test):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _REDUCTIONS
                    and dotted(node.func.value) not in ("np", "numpy")):
                return node.func.attr
        return ""


# ---------------------------------------------------------------------------
# track-donate-pool — the torch form of jit-donate-pool
# ---------------------------------------------------------------------------


def _pool_target(t) -> str:
    if t.node is None:
        return t.name
    if isinstance(t.node, _DEFS) and t.node.name in _POOL_FUNCS:
        return t.node.name
    if _first_param(t.node) == "pool":
        return _fn_label(t.node)
    return ""


class TrackDonatePoolRule:
    rule_id = "track-donate-pool"
    summary = ("pool-mutating function tracked without donate= (the cell "
               "audit cannot hold the seat to updating its pool in place)")
    incident = ("stands for jit-donate-pool: the serve.seat cells declare "
                "donate=(0,) so the audit holds the paged admission to "
                "writing the pool in place instead of copying it")

    def prepare(self, ctx):
        tracked_sites(ctx)

    def check(self, ctx, info):
        findings = []
        for site in tracked_sites(ctx):
            if site.info is not info or not site.targets:
                continue
            if any(k.arg == "donate" for k in site.call.keywords):
                continue
            pools = [p for p in map(_pool_target, site.targets) if p]
            if pools:
                findings.append(info.finding(
                    self.rule_id, site.call,
                    f"track({site.cell!r}, ...) runs {pools[0]}, which "
                    f"mutates its pool argument, but declares no donate= "
                    f"— the audit cannot hold it to an in-place update",
                ))
        return findings


# ---------------------------------------------------------------------------
# driver-thread-affinity — the frontend single-driver-thread invariant
# ---------------------------------------------------------------------------


class DriverThreadAffinityRule:
    rule_id = "driver-thread-affinity"
    summary = ("@driver_thread_only method called from code inside an "
               "async def (event-loop thread)")
    incident = ("the frontend's engines are single-threaded by "
                "contract — exactly one driver thread may touch "
                "Engine/MicroBatchScheduler state; async handlers must "
                "go through the inbox")

    def prepare(self, ctx):
        for info in ctx.files:
            for node in ast.walk(info.tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    for dec in node.decorator_list:
                        d = dec.func if isinstance(dec, ast.Call) else dec
                        if terminal_name(d) == "driver_thread_only":
                            ctx.driver_methods.add(node.name)

    def check(self, ctx, info):
        if not ctx.driver_methods:
            return []
        findings = []
        for node in ast.walk(info.tree):
            if not isinstance(node, ast.AsyncFunctionDef):
                continue
            containers = self._container_locals(node)
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in ctx.driver_methods
                        and self._receiver_base(sub.func)
                        not in containers):
                    findings.append(info.finding(
                        self.rule_id, sub,
                        f"`.{sub.func.attr}(...)` is "
                        f"@driver_thread_only but is called inside "
                        f"async `{node.name}` (event-loop thread); "
                        f"post through the driver inbox instead",
                    ))
        return findings

    @staticmethod
    def _receiver_base(attr):
        node = attr.value
        while isinstance(node, ast.Attribute):
            node = node.value
        return node.id if isinstance(node, ast.Name) else None

    @staticmethod
    def _container_locals(fn) -> set:
        """Locals bound to plain containers (`x = []`, `x = list()`):
        their `.extend`/`.submit` etc. are builtin methods sharing a
        marked name, not driver-thread surfaces."""
        out = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            v = node.value
            is_container = isinstance(
                v, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                    ast.DictComp, ast.SetComp)
            ) or (
                isinstance(v, ast.Call)
                and isinstance(v.func, ast.Name)
                and v.func.id in ("list", "dict", "set", "deque")
            )
            if is_container:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
        return out


# ---------------------------------------------------------------------------
# telemetry-eager-format — the disabled-path nanosecond budget
# ---------------------------------------------------------------------------

_EMIT_ATTRS = {"counter", "gauge", "histogram", "span", "instant"}


class TelemetryEagerFormatRule:
    rule_id = "telemetry-eager-format"
    summary = ("string formatting evaluated on a telemetry emission "
               "path even when telemetry is disabled")
    incident = ("disabled emission must cost nanoseconds "
                "(tests/test_obs.py asserts the stream loop's <3% "
                "budget); an f-string metric name formats "
                "unconditionally")

    def check(self, ctx, info):
        findings = []
        self._visit(info, info.tree.body, False, findings)
        return findings

    def _visit(self, info, stmts, guarded, findings):
        for st in stmts:
            g = guarded
            if isinstance(st, ast.If) and self._enabled_guard(st.test):
                self._scan_expr(info, st.test, guarded, findings)
                self._visit(info, st.body, True, findings)
                self._visit(info, st.orelse, guarded, findings)
                continue
            for child in ast.iter_child_nodes(st):
                if isinstance(child, (ast.stmt,)):
                    continue
                self._scan_expr(info, child, g, findings)
            body_fields = [
                getattr(st, f) for f in ("body", "orelse", "finalbody")
                if getattr(st, f, None)
            ]
            for body in body_fields:
                self._visit(info, body, g, findings)
            for h in getattr(st, "handlers", []) or []:
                self._visit(info, h.body, g, findings)

    @staticmethod
    def _enabled_guard(test) -> bool:
        for node in ast.walk(test):
            if isinstance(node, ast.Attribute) and node.attr == "enabled":
                return True
            if isinstance(node, ast.Name) and node.id == "enabled":
                return True
        return False

    def _scan_expr(self, info, expr, guarded, findings):
        if guarded or expr is None:
            return
        for node in ast.walk(expr):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _EMIT_ATTRS):
                continue
            for arg in list(node.args) + [k.value for k in node.keywords]:
                if self._formats(arg):
                    findings.append(info.finding(
                        self.rule_id, node,
                        f"`.{node.func.attr}(...)` argument does "
                        f"string formatting unconditionally; guard "
                        f"with `if tel.enabled:` or precompute the "
                        f"name",
                    ))
                    break

    @staticmethod
    def _formats(arg) -> bool:
        if isinstance(arg, ast.JoinedStr) and any(
                isinstance(v, ast.FormattedValue) for v in arg.values):
            return True
        if isinstance(arg, ast.BinOp) and isinstance(
                arg.op, (ast.Mod, ast.Add)):
            return any(
                isinstance(s, ast.Constant) and isinstance(s.value, str)
                for s in (arg.left, arg.right)
            )
        if (isinstance(arg, ast.Call)
                and isinstance(arg.func, ast.Attribute)
                and arg.func.attr == "format"):
            return True
        return False


# ---------------------------------------------------------------------------
# numpy-in-cell — the torch form of numpy-in-jit
# ---------------------------------------------------------------------------


class NumpyInCellRule:
    rule_id = "numpy-in-cell"
    summary = ("host numpy call inside a tracked cell (a host round trip "
               "or a value frozen on the host)")
    incident = ("stands for numpy-in-jit: the port's classify and vote "
                "cells stay on the device end to end; np.* inside a cell "
                "moves a device value to the host or computes on a copy")

    def prepare(self, ctx):
        tracked_sites(ctx)

    def check(self, ctx, info):
        findings = []
        for cell, fn in cell_bodies(ctx, info):
            for sub in ast.walk(fn):
                if (isinstance(sub, ast.Call)
                        and dotted(sub.func).split(".")[0]
                        in ("np", "numpy")):
                    findings.append(info.finding(
                        self.rule_id, sub,
                        f"`{ast.unparse(sub.func)}(...)` inside tracked "
                        f"cell `{cell}` (`{_fn_label(fn)}`); use torch "
                        f"on the device",
                    ))
        return findings


# ---------------------------------------------------------------------------
# mutable-default
# ---------------------------------------------------------------------------


class MutableDefaultRule:
    rule_id = "mutable-default"
    summary = "mutable default argument shared across calls"
    incident = ("lineage tags accumulate per call — a shared "
                "default dict would bleed tags across requests")

    def check(self, ctx, info):
        findings = []
        for node in ast.walk(info.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            for default in list(node.args.defaults) + [
                    d for d in node.args.kw_defaults if d is not None]:
                mutable = isinstance(
                    default, (ast.List, ast.Dict, ast.Set)
                ) or (
                    isinstance(default, ast.Call)
                    and isinstance(default.func, ast.Name)
                    and default.func.id in ("list", "dict", "set")
                )
                if mutable:
                    findings.append(info.finding(
                        self.rule_id, default,
                        f"mutable default in `{node.name}(...)` is "
                        f"shared across calls; default to None and "
                        f"allocate inside",
                    ))
        return findings


# ---------------------------------------------------------------------------
# broad-except-pass
# ---------------------------------------------------------------------------


class BroadExceptPassRule:
    rule_id = "broad-except-pass"
    summary = "bare/broad except that swallows the error with pass"
    incident = ("serve/stream errors must surface as typed "
                "rejections or driver-thread faults; a swallowed "
                "exception is a silent SLO breach")

    def check(self, ctx, info):
        findings = []
        for node in ast.walk(info.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            broad = node.type is None or dotted(node.type) in (
                "Exception", "BaseException",
            )
            silent = all(
                isinstance(st, ast.Pass)
                or (isinstance(st, ast.Expr)
                    and isinstance(st.value, ast.Constant))
                for st in node.body
            )
            if broad and silent:
                findings.append(info.finding(
                    self.rule_id, node,
                    "broad except swallows the error; at minimum "
                    "count it on a telemetry counter or narrow the "
                    "type",
                ))
        return findings


# ---------------------------------------------------------------------------
# wallclock-in-measurement
# ---------------------------------------------------------------------------


class WallclockRule:
    rule_id = "wallclock-ban"
    summary = ("time.time() in library code (NTP-steppable; use "
               "perf_counter/monotonic, or pragma for metadata)")
    incident = ("latency accounting is perf_counter end to end "
                "so coordinated-omission math can't be skewed by "
                "clock steps")

    def check(self, ctx, info):
        findings = []
        for node in ast.walk(info.tree):
            if (isinstance(node, ast.Call)
                    and dotted(node.func) == "time.time"):
                findings.append(info.finding(
                    self.rule_id, node,
                    "time.time() is wall clock; measurement code must "
                    "use time.perf_counter()/monotonic() (metadata "
                    "timestamps: suppress with a pragma)",
                ))
        return findings


RULES = (
    NpIndexDtypeRule(),
    GlobalRngRule(),
    HostSyncInCellRule(),
    TrackDonatePoolRule(),
    DriverThreadAffinityRule(),
    TelemetryEagerFormatRule(),
    NumpyInCellRule(),
    MutableDefaultRule(),
    BroadExceptPassRule(),
    WallclockRule(),
)
