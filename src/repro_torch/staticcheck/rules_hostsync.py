"""Host syncs, generators and float64 on the port's hot path.

The reference's tracer rules (`repro.staticcheck.rules_tracer`) guard
JAX's silent failures inside ``jax.jit``.  The port has no tracer; its
silent failure is a wait: a value read back to the host in the chunk
loop stalls the queue of launches, and the card idles while the host
catches up.  The rules here:

  * RPT101 — a host sync on the hot path (the reference's RPR101, RPR103
    and RPR105 in one rule): ``.item()`` / ``.tolist()`` / ``.cpu()`` /
    ``.numpy()``, ``int()`` / ``float()`` / ``bool()`` of a tensor,
    ``if`` / ``while`` / ``assert`` / ``not`` on a tensor,
    ``nonzero`` / ``argwhere`` / ``unique`` / ``masked_select`` /
    one-argument ``torch.where``, indexing by a boolean tensor,
    ``torch.equal`` / ``allclose``, ``torch.cuda.synchronize()``, numpy on a
    tensor, and a blocking host-to-device copy (``torch.tensor(...,
    device=...)``);
  * RPT102 — generator discipline (the reference's RPR102, key reuse):
    every random op in the package takes ``generator=``, nothing seeds
    the global generator, and no two generators of one function are
    seeded from the same expression (nor one, inside a loop, from an
    expression that does not change with the loop);
  * RPT104 — a hard-coded float64 on the hot path that does not follow
    the input's dtype (the reference's RPR104).

**The hot path.**  Its roots are the streaming engine's chunk loop (a
``for c_idx in ...`` loop, `core/simulator.py`), every function of
`_segment.py` (the segment sums of every training step through a
gather) and every function of the kernels' ``ops.py`` / ``kernel.py``
(the launch wrappers every device path goes through).  From there it
follows every reference to a package function, resolved through the
importing module's aliases (``fleet_ops.fleet_scan`` ->
`kernels/fleet_scan/ops.py`), nested functions by scope, methods by
name where one package class defines them, the methods of an
``autograd.Function`` the code applies, and callables passed in a
parameter that the hot code calls (the engine's ``draws(c_idx)`` ->
the nested ``draws`` of `simulate_fork_join_batch` ->
`chunk_random_draws` / `chunk_side_draws`).  In the function that holds
the chunk loop only the loop is hot: set-up before it and the epilogue
after it run once.
"""

from __future__ import annotations

import ast
import fnmatch
import functools
from typing import Iterator, Optional

from repro_torch.staticcheck.analysis import (
    BOOL,
    HOST,
    PKG_DIR,
    PKG_REL,
    Finding,
    FunctionInfo,
    Module,
    PackageIndex,
    TensorInterp,
    is_tensor,
    kw,
    resolve_call,
)
from repro_torch.staticcheck.registry import rule

__all__ = ["HOT_LOOP_TARGET", "HOT_MODULES", "HotPath", "hot_path",
           "sync_reason"]

HOT_LOOP_TARGET = "c_idx"
HOT_MODULES = (f"{PKG_REL}/_segment.py", f"{PKG_REL}/kernels/*/ops.py",
               f"{PKG_REL}/kernels/*/kernel.py")
_SRC = [f"{PKG_REL}/*.py"]

# method names too common to resolve by name to a package class's method
_COMMON_METHODS = {
    "to", "map", "get", "items", "keys", "values", "append", "extend",
    "pop", "update", "add", "format", "join", "split", "replace", "copy",
    "sum", "max", "min", "mean", "reshape", "view", "expand", "clone",
    "load", "call", "apply", "run", "read", "write", "close", "index",
    "count", "sort", "item", "tolist", "float", "int", "bool", "cpu",
    "cuda", "numpy", "contiguous", "detach", "forward", "backward",
    "shape", "device", "dtype", "ndim", "p", "hit", "batch"}


# --------------------------------------------------------------------------
# The hot path
# --------------------------------------------------------------------------

def _own_nodes(node: ast.AST) -> list[ast.AST]:
    """Every node under ``node``, not entering nested defs and classes
    (walked once a node: kept on it)."""
    own = getattr(node, "_own_nodes", None)
    if own is None:
        own, stack = [], list(ast.iter_child_nodes(node))
        while stack:
            sub = stack.pop()
            own.append(sub)
            if not isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                    ast.ClassDef)):
                stack.extend(ast.iter_child_nodes(sub))
        node._own_nodes = own
    return own


def _params(fn: ast.AST) -> list[str]:
    a = fn.args
    return [x.arg for x in list(a.posonlyargs) + list(a.args)]


class HotPath:
    """The hot units of the package: (function, region) pairs, the region
    being the whole body or the chunk loop."""

    def __init__(self, index: PackageIndex,
                 only: Optional[str] = None):
        """``only``: a module name; the hot path of that module alone
        (a new module no other module imports: its roots and what it
        reaches of itself are all the package's hot path adds)."""
        self.index = index
        self.only = only
        # function qualname -> regions (None: the whole body)
        self.units: dict[str, list[Optional[ast.AST]]] = {}
        self.loops: list[tuple[FunctionInfo, ast.For]] = []
        self._callsites: Optional[dict[str, list]] = None
        work: list[tuple[FunctionInfo, Optional[ast.AST]]] = []
        for info in index.functions.values():
            if only is not None and info.mod.name != only:
                continue
            if any(fnmatch.fnmatch(info.mod.rel, pat)
                   for pat in HOT_MODULES):
                work.append((info, None))
            for sub in _own_nodes(info.node):
                if (isinstance(sub, ast.For)
                        and isinstance(sub.target, ast.Name)
                        and sub.target.id == HOT_LOOP_TARGET):
                    self.loops.append((info, sub))
                    work.append((info, sub))
        self._close(work)

    def _add(self, info: FunctionInfo, region: Optional[ast.AST], work
             ) -> None:
        if self.only is not None and info.mod.name != self.only:
            return
        regions = self.units.setdefault(info.qualname, [])
        if None in regions or region in regions:
            return
        if region is None:
            regions.clear()
        regions.append(region)
        work.append((info, region))

    def _close(self, work) -> None:
        pending = list(work)
        work.clear()
        for info, region in pending:
            self._add(info, region, work)
        called_params: dict[str, set[str]] = {}
        while work:
            info, region = work.pop()
            mod, fn = info.mod, info.node
            nodes = (_own_nodes(fn) if region is None
                     else [region, *_own_nodes(region)])
            params = set(_params(fn))
            for sub in nodes:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if isinstance(sub, ast.Call) and isinstance(
                        sub.func, ast.Name) and sub.func.id in params:
                    called_params.setdefault(info.qualname, set()).add(
                        sub.func.id)
                if isinstance(sub, (ast.Name, ast.Attribute)) and \
                        isinstance(getattr(sub, "ctx", None), ast.Load):
                    self._reach(info, mod, sub, work)
            for p in called_params.get(info.qualname, ()):
                for cinfo, target in self._bound(info, p):
                    self._add(cinfo, target, work)

    def _reach(self, info, mod, node, work) -> None:
        idx = self.index
        qn = idx.resolve_name(info, mod, node)
        if qn in idx.functions:
            self._add(idx.functions[qn], None, work)
            return
        if qn in idx.classes:
            cmod, cls = idx.classes[qn]
            if any(ast.unparse(b).endswith("Function") for b in cls.bases):
                for sub in cls.body:
                    f = idx.functions.get(f"{qn}.{getattr(sub, 'name', '')}")
                    if f is not None:
                        self._add(f, None, work)
            return
        if (isinstance(node, ast.Attribute) and node.attr
                not in _COMMON_METHODS and mod.qualname(node) is not None
                and not mod.qualname(node).startswith(("torch.", "numpy.",
                                                       "math."))):
            owners = idx.methods_by_name.get(node.attr, [])
            if 0 < len(owners) <= 3:
                for owner in owners:
                    self._add(idx.functions[owner], None, work)

    def _bound(self, info: FunctionInfo, param: str):
        """The callables bound to ``param`` of ``info`` at its call sites:
        (function, None) for a named function, (caller, lambda) for a
        lambda."""
        if self._callsites is None:
            self._callsites = {}
            for cinfo in self.index.functions.values():
                if self.only is not None and cinfo.mod.name != self.only:
                    continue
                for sub in _own_nodes(cinfo.node):
                    if isinstance(sub, ast.Call):
                        qn = self.index.resolve_name(cinfo, cinfo.mod,
                                                     sub.func)
                        if qn is not None:
                            self._callsites.setdefault(qn, []).append(
                                (cinfo, sub))
        pos = _params(info.node).index(param) if param in _params(
            info.node) else None
        for cinfo, call in self._callsites.get(info.qualname, []):
            arg = kw(call, param)
            if arg is None and pos is not None and pos < len(call.args):
                arg = call.args[pos]
            if isinstance(arg, ast.Lambda):
                yield cinfo, arg
            elif arg is not None:
                qn = self.index.resolve_name(cinfo, cinfo.mod, arg)
                if qn in self.index.functions:
                    yield self.index.functions[qn], None

    def regions_in(self, mod: Module
                   ) -> Iterator[tuple[FunctionInfo, Optional[ast.AST]]]:
        for qn, regions in self.units.items():
            info = self.index.functions[qn]
            if info.mod.rel == mod.rel:
                for region in regions:
                    yield info, region

    def interp(self, info: FunctionInfo) -> TensorInterp:
        """The tensor interpreter of ``info``, seeded with the final
        environment of its enclosing function (its closure)."""
        seed = None
        if info.parent is not None:
            parent = self.interp(info.parent)
            parent.run(lambda *_: None)
            seed = parent.env
        return TensorInterp(info.mod, info.node,
                            self.index.return_kind(info), seed)


def hot_path(mod: Optional[Module] = None) -> HotPath:
    """The package's hot path; with ``mod`` a seeded copy of one of its
    modules (or a new one), the hot path of the package with it."""
    base = PackageIndex.load()
    if mod is None or (mod.name in base.modules
                       and base.modules[mod.name].text == mod.text):
        return _hot_path(None, None)
    if mod.name not in base.modules:
        return HotPath(PackageIndex.load(override=mod), only=mod.name)
    return _hot_path(mod.rel, mod.text)


@functools.lru_cache(maxsize=8)
def _hot_path(rel: Optional[str], text: Optional[str]) -> HotPath:
    """The base hot path, or that of a seeded copy of a package module
    (built once a text: each rule of the family asks for it)."""
    if rel is None:
        return HotPath(PackageIndex.load())
    return HotPath(PackageIndex.load(override=Module(
        PKG_DIR.parent.parent / rel, rel, text)))


def _in_region(node: ast.AST, region: Optional[ast.AST]) -> bool:
    if region is None:
        return True
    line = getattr(node, "lineno", None)
    return line is not None and region.lineno <= line <= region.end_lineno


def _hot_walk(mod: Module, on_node) -> None:
    hp = hot_path(mod)
    for info, region in hp.regions_in(mod):
        interp = hp.interp(info)
        interp.run(lambda node, it, region=region, fn=info.node:
                   on_node(node, it, fn) if _in_region(node, region)
                   else None)


def _dedupe(findings: list[Finding]) -> list[Finding]:
    seen: set[tuple[str, int]] = set()
    out = []
    for f in sorted(findings, key=lambda f: (f.line, f.col)):
        if (f.rule_id, f.line) not in seen:
            seen.add((f.rule_id, f.line))
            out.append(f)
    return out


# --------------------------------------------------------------------------
# RPT101: host syncs
# --------------------------------------------------------------------------

_SYNC_METHODS = {
    "item": "`.item()` copies a value to the host",
    "tolist": "`.tolist()` copies a tensor to the host",
    "cpu": "`.cpu()` copies a tensor to the host",
    "numpy": "`.numpy()` reads a tensor on the host",
    "nonzero": "`.nonzero()` sizes its output from the data",
    "argwhere": "`.argwhere()` sizes its output from the data",
    "unique": "`.unique()` sizes its output from the data",
    "unique_consecutive": "`.unique_consecutive()` sizes its output from "
                          "the data",
    "masked_select": "`.masked_select()` sizes its output from the data",
    "equal": "`.equal()` returns a Python bool",
    "synchronize": "`.synchronize()` waits for the device",
}
_SYNC_FUNCS = {
    "torch.nonzero": "`torch.nonzero` sizes its output from the data",
    "torch.argwhere": "`torch.argwhere` sizes its output from the data",
    "torch.unique": "`torch.unique` sizes its output from the data",
    "torch.unique_consecutive": "`torch.unique_consecutive` sizes its "
                                "output from the data",
    "torch.masked_select": "`torch.masked_select` sizes its output from "
                           "the data",
    "torch.equal": "`torch.equal` returns a Python bool",
    "torch.allclose": "`torch.allclose` returns a Python bool",
    "torch.is_nonzero": "`torch.is_nonzero` returns a Python bool",
    "torch.bincount": "`torch.bincount` sizes its output from the data",
    "torch.cuda.synchronize": "`torch.cuda.synchronize()` waits for the "
                              "device",
}
_H2D = ("torch.tensor", "torch.as_tensor", "torch.from_numpy")


def _is_cpu(mod: Module, node: Optional[ast.AST]) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and mod.qualname(node.func) == \
            "torch.device" and node.args:
        return _is_cpu(mod, node.args[0])
    return False


def _host_data(mod: Module, it: TensorInterp, node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Tuple, ast.ListComp, ast.Constant)):
        return True
    if isinstance(node, ast.Call):
        qn = resolve_call(mod, node) or ""
        if qn.startswith("numpy."):
            return True
    return it.value(node) == HOST


def sync_reason(node: ast.AST, it: TensorInterp) -> Optional[str]:
    """Why ``node`` waits for the device, or None."""
    mod = it.mod
    if isinstance(node, ast.Call):
        qn = resolve_call(mod, node)
        if qn in _SYNC_FUNCS:
            return _SYNC_FUNCS[qn]
        if qn == "torch.where" and len(node.args) == 1 and not node.keywords:
            return "one-argument `torch.where` sizes its output from the data"
        if qn == "torch.repeat_interleave" and kw(
                node, "output_size") is None and len(node.args) >= 2 and \
                is_tensor(it.value(node.args[1])):
            return ("`torch.repeat_interleave` without output_size sizes its "
                    "output from the data")
        if qn in ("int", "float", "bool", "complex") and node.args and \
                is_tensor(it.value(node.args[0])):
            return f"`{qn}()` of a tensor copies it to the host"
        if qn is not None and qn.startswith("numpy.") and any(
                is_tensor(it.value(a)) for a in node.args):
            return f"`{qn}` on a tensor reads it on the host"
        if qn in _H2D:
            dev = kw(node, "device")
            if dev is not None and not _is_cpu(mod, dev) and node.args and (
                    qn != "torch.as_tensor"
                    or _host_data(mod, it, node.args[0])):
                return (f"`{qn}` of host data on a device: a blocking "
                        "host-to-device copy")
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr in _SYNC_METHODS and not (qn or "").startswith(
                    ("torch.", "numpy.")):
                return _SYNC_METHODS[f.attr]
            if f.attr == "repeat_interleave" and kw(
                    node, "output_size") is None and node.args and \
                    is_tensor(it.value(node.args[0])):
                return ("`.repeat_interleave()` without output_size sizes "
                        "its output from the data")
            if f.attr in ("to", "cuda") and isinstance(f.value, ast.Call) \
                    and resolve_call(mod, f.value) in _H2D \
                    and kw(f.value, "device") is None:
                moved = [a for a in list(node.args) + [
                    k.value for k in node.keywords if k.arg == "device"]
                    if not (mod.qualname(a) or "").startswith("torch.")
                    or mod.qualname(a) == "torch.device"]
                if f.attr == "cuda" or any(not _is_cpu(mod, a)
                                           for a in moved):
                    return ("a tensor built on the host and moved to the "
                            "device: a blocking host-to-device copy")
        return None
    if isinstance(node, (ast.If, ast.While)) and is_tensor(
            it.value(node.test)):
        kind = "while" if isinstance(node, ast.While) else "if"
        return f"`{kind}` on a tensor reads it on the host"
    if isinstance(node, ast.IfExp) and is_tensor(it.value(node.test)):
        return "a conditional expression on a tensor reads it on the host"
    if isinstance(node, ast.Assert) and is_tensor(it.value(node.test)):
        return "`assert` on a tensor reads it on the host"
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not) and \
            is_tensor(it.value(node.operand)):
        return "`not` on a tensor reads it on the host"
    if isinstance(node, ast.BoolOp) and any(
            is_tensor(it.value(v)) for v in node.values[:-1]):
        return "`and` / `or` on a tensor reads it on the host"
    if isinstance(node, ast.Subscript):
        idx = node.slice
        elts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
        if any(it.value(e) == BOOL for e in elts):
            return ("indexing by a boolean tensor sizes its result from "
                    "the data")
    return None


@rule("RPT101", "no-host-sync-on-hot-path", "hostsync",
      "a host sync on the hot path (the chunk loop and what it calls, "
      "_segment.py, the kernels' ops/kernel wrappers): .item()/.tolist()/"
      ".cpu(), int()/float()/bool() of a tensor, if/while on a tensor, "
      "nonzero/unique/masked_select, boolean-mask indexing, "
      "torch.cuda.synchronize(), numpy on a tensor, a blocking "
      "host-to-device copy",
      scope=_SRC)
def check_host_sync(mod: Module) -> Iterator[Finding]:
    findings: list[Finding] = []

    def on_node(node, it, fn):
        why = sync_reason(node, it)
        if why is not None:
            findings.append(mod.finding(
                "RPT101", node, f"{why} on the hot path (in `{fn.name}`)"))

    _hot_walk(mod, on_node)
    yield from _dedupe(findings)


# --------------------------------------------------------------------------
# RPT104: float64 on the hot path
# --------------------------------------------------------------------------

_DTYPE_ATTRS = {"dtype", "float64", "float32", "double", "bfloat16",
                "float16", "half"}


def _mentions_dtype(node: ast.AST) -> bool:
    """A test that reads a dtype (``x.dtype``, ``dt == torch.float64``)."""
    return any(isinstance(s, ast.Attribute) and s.attr in _DTYPE_ATTRS
               for s in ast.walk(node))


def _follows_input(node: ast.AST, parents: dict) -> bool:
    """A float64 chosen by the input's dtype: inside a comparison, a
    dtype table's key, or an arm of a conditional on a ``.dtype``."""
    child, cur = node, parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.Compare):
            return True
        if isinstance(cur, ast.Dict) and child in cur.keys:
            return True
        if isinstance(cur, (ast.IfExp, ast.If)) and child is not cur.test \
                and _mentions_dtype(cur.test):
            return True
        child, cur = cur, parents.get(cur)
    return False


@rule("RPT104", "no-f64-on-hot-path", "hostsync",
      "a hard-coded float64 (torch.float64 / .double() / 'float64') on "
      "the hot path that does not follow the input's dtype",
      scope=_SRC)
def check_f64(mod: Module) -> Iterator[Finding]:
    findings: list[Finding] = []
    parents_of: dict[int, dict] = {}

    def on_node(node, it, fn):
        if id(fn) not in parents_of:
            parents_of[id(fn)] = {c: p for p in ast.walk(fn)
                                  for c in ast.iter_child_nodes(p)}
        hit = (isinstance(node, ast.Attribute) and mod.qualname(node) in
               ("torch.float64", "torch.double")) or (
            isinstance(node, ast.Constant) and node.value == "float64") or (
            isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
            and node.func.attr == "double" and not node.args)
        if hit and not _follows_input(node, parents_of[id(fn)]):
            findings.append(mod.finding(
                "RPT104", node, "float64 fixed on the hot path (in "
                f"`{fn.name}`); follow the input's dtype"))

    _hot_walk(mod, on_node)
    yield from _dedupe(findings)


# --------------------------------------------------------------------------
# RPT102: generator discipline
# --------------------------------------------------------------------------

_RANDOM_FUNCS = {f"torch.{n}" for n in (
    "rand", "randn", "randint", "randperm", "bernoulli", "multinomial",
    "normal", "poisson", "rand_like", "randn_like", "randint_like")}
_RANDOM_METHODS = {"exponential_", "uniform_", "normal_", "random_",
                   "bernoulli_", "geometric_", "cauchy_", "log_normal_",
                   "multinomial"}
_GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
                 "torch.cuda.manual_seed_all", "torch.random.manual_seed",
                 "numpy.random.seed"}
_NUMPY_GLOBAL = {f"numpy.random.{n}" for n in (
    "rand", "randn", "randint", "random", "uniform", "normal",
    "exponential", "choice", "permutation", "shuffle", "poisson")}


def _is_generator(mod: Module, node: ast.AST, gens: set[str]) -> bool:
    if isinstance(node, ast.Name):
        return node.id in gens
    return isinstance(node, ast.Call) and mod.qualname(
        node.func) == "torch.Generator"


def _loop_names(loop: ast.AST) -> set[str]:
    names = set()
    for sub in ast.walk(loop):
        if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Store):
            names.add(sub.id)
    return names


@rule("RPT102", "generator-discipline", "hostsync",
      "every random op takes generator= (no global RNG, no global seed); "
      "no two torch.Generators of one function are seeded from the same "
      "expression, nor one inside a loop from an expression the loop "
      "does not change",
      scope=_SRC)
def check_generators(mod: Module) -> Iterator[Finding]:
    for node in mod.nodes:
        if not isinstance(node, ast.Call):
            continue
        qn = resolve_call(mod, node)
        f = node.func
        is_method = (isinstance(f, ast.Attribute)
                     and f.attr in _RANDOM_METHODS
                     and not (qn or "").startswith(("numpy.", "random.")))
        if (qn in _RANDOM_FUNCS or is_method) and kw(node,
                                                      "generator") is None:
            name = qn if qn in _RANDOM_FUNCS else f".{f.attr}()"
            yield mod.finding(
                "RPT102", node, f"`{name}` draws from the global generator; "
                "pass generator= (a torch.Generator seeded from the run's "
                "seed)")
        elif qn in _GLOBAL_SEEDS or qn in _NUMPY_GLOBAL:
            yield mod.finding(
                "RPT102", node, f"`{qn}` uses the global generator; seed a "
                "torch.Generator (numpy: default_rng) and pass it")
    for fn in [n for n in mod.nodes
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        gens: set[str] = set()
        seen: dict[str, int] = {}
        loops = [n for n in _own_nodes(fn)
                 if isinstance(n, (ast.For, ast.While))]
        for sub in sorted((n for n in _own_nodes(fn)
                           if isinstance(n, (ast.Assign, ast.Call))),
                          key=lambda n: (n.lineno, n.col_offset)):
            if isinstance(sub, ast.Assign):
                if _is_generator(mod, sub.value, set()):
                    gens.update(t.id for t in sub.targets
                                if isinstance(t, ast.Name))
                continue
            f = sub.func
            if not (isinstance(f, ast.Attribute) and f.attr == "manual_seed"
                    and sub.args and _is_generator(mod, f.value, gens)):
                continue
            seed = sub.args[0]
            key = ast.dump(seed)
            if key in seen:
                yield mod.finding(
                    "RPT102", sub, "a second torch.Generator seeded from "
                    f"`{ast.unparse(seed)}` (as at line {seen[key]}) in "
                    f"`{fn.name}`: the two streams are equal; mix a salt "
                    "into the seed")
            else:
                seen[key] = sub.lineno
            for loop in loops:
                if any(s is sub for s in ast.walk(loop)):
                    used = {n.id for n in ast.walk(seed)
                            if isinstance(n, ast.Name)}
                    if not used & _loop_names(loop):
                        yield mod.finding(
                            "RPT102", sub, "a torch.Generator seeded inside "
                            f"a loop from `{ast.unparse(seed)}`, which the "
                            "loop does not change: every iteration draws "
                            "the same stream; mix the loop index into the "
                            "seed")
                    break
