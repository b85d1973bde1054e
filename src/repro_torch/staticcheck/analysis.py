"""Shared machinery of the port's checker: files, suppressions, tensors.

Three layers, used by every rule module:

  * **Module / SourceText** — a parsed Python file with its import-alias
    table (so a rule asks "does this call resolve to ``torch.nonzero``?"
    whatever the file named it), or the text of a CUDA source.
  * **Suppressions** — ``# staticcheck-torch: disable=RPT101 (reason)``
    on the flagged line (``// staticcheck-torch: ...`` in a CUDA
    source).  The marker is not the reference checker's
    (``# staticcheck: disable=RPR...``), so neither checker reads the
    other's; a line that both flag carries both comments.  A marker with
    no ID is itself a finding (RPT000).
  * **Tensor kinds** — a small forward interpreter over one function
    body with the kinds HOST < UNKNOWN < TENSOR < BOOL (a boolean
    tensor).  Values of ``torch.*`` calls, of tensor methods, of
    parameters annotated ``Tensor`` and of package functions annotated
    ``-> Tensor`` are tensors; shapes, dtypes, devices and numbers are
    host values.  TENSOR only ever comes from such a source, so an
    unresolvable value (UNKNOWN) never makes a rule fire.

The package index (`PackageIndex`) parses the port once and resolves
calls through its imports; `rules_hostsync` builds the hot path on it.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import io
import pathlib
import re
import tokenize
from typing import Callable, Iterator, Optional, Union

__all__ = ["BOOL", "Finding", "HOST", "Module", "PKG_DIR", "PackageIndex",
           "SourceText", "TENSOR", "TensorInterp", "UNKNOWN", "load_source",
           "resolve_call"]

PREFIX_IDS = "RPT"
_SUPPRESS_RE = re.compile(
    r"(?:#|//)\s*staticcheck-torch:\s*disable"
    r"(?:=(?P<ids>[A-Za-z]+[0-9]+(?:\s*,\s*[A-Za-z]+[0-9]+)*))?")

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent   # repro_torch/
PKG_NAME = PKG_DIR.name
PKG_REL = f"src/{PKG_NAME}"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: rule ID + location + message."""

    rule_id: str
    path: str          # repo-relative posix path
    line: int
    col: int
    message: str
    suppressed: bool = False

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule_id} {self.message}{tag}")


def _suppressions(comments: Iterator[tuple[int, str]]
                  ) -> tuple[dict[int, set[str]], list[tuple[int, str]]]:
    table: dict[int, set[str]] = {}
    bad: list[tuple[int, str]] = []
    for lineno, text in comments:
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        if not m.group("ids"):
            bad.append((lineno, "suppression without a rule ID"))
            continue
        table.setdefault(lineno, set()).update(
            s.strip() for s in m.group("ids").split(","))
    return table, bad


class _Suppressible:
    suppressions: dict[int, set[str]]

    def is_suppressed(self, rule_id: str, line: int) -> bool:
        return rule_id in self.suppressions.get(line, set())

    def finding(self, rule_id: str, node_or_line, message: str,
                col: int = 0) -> Finding:
        if isinstance(node_or_line, int):
            line = node_or_line
        else:
            line, col = node_or_line.lineno, node_or_line.col_offset
        return Finding(rule_id, self.rel, line, col, message)


def module_name(rel_posix: str) -> Optional[str]:
    """``src/repro_torch/core/x.py`` -> ``repro_torch.core.x``."""
    if not (rel_posix.startswith("src/") and rel_posix.endswith(".py")):
        return None
    parts = rel_posix[len("src/"):-len(".py")].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class Module(_Suppressible):
    """A parsed Python file + import aliases + suppression table."""

    def __init__(self, path: Union[str, pathlib.Path], rel_posix: str,
                 text: Optional[str] = None):
        self.path = pathlib.Path(path)
        self.rel = rel_posix
        self.text = self.path.read_text() if text is None else text
        self.tree = ast.parse(self.text, filename=str(self.path))
        self.name = module_name(rel_posix)
        self.aliases = _import_aliases(self.tree, self.name,
                                       rel_posix.endswith("__init__.py"))
        self.suppressions, self.bad_suppressions = _suppressions(
            _comments(self.text))

    @functools.cached_property
    def nodes(self) -> list[ast.AST]:
        """Every node of the tree (``ast.walk`` order), walked once."""
        return list(ast.walk(self.tree))

    def qualname(self, node: ast.AST) -> Optional[str]:
        """Resolve a Name/Attribute chain to a full dotted path, or None."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(self.aliases.get(node.id, node.id))
        return ".".join(reversed(parts))


class SourceText(_Suppressible):
    """A CUDA source: its text, comment-free text and suppressions."""

    def __init__(self, path: Union[str, pathlib.Path], rel_posix: str,
                 text: Optional[str] = None):
        self.path = pathlib.Path(path)
        self.rel = rel_posix
        self.text = self.path.read_text() if text is None else text
        self.code = strip_c_comments(self.text)
        self.suppressions, self.bad_suppressions = _suppressions(
            (i + 1, line) for i, line in enumerate(self.text.splitlines())
            if "//" in line)


def strip_c_comments(text: str) -> str:
    """The text with // and /* */ comments blanked, offsets (and so line
    numbers) kept; string literals are left alone."""
    out = list(text)
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == '"':
            j = i + 1
            while j < n and text[j] != '"':
                j += 2 if text[j] == "\\" else 1
            i = j + 1
        elif text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            out[i:j] = " " * (j - i)
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out[i:j] = [ch if ch == "\n" else " " for ch in text[i:j]]
            i = j
        else:
            i += 1
    return "".join(out)


def load_source(path: pathlib.Path, rel_posix: str,
                text: Optional[str] = None) -> Union[Module, SourceText]:
    if rel_posix.endswith((".cu", ".cuh")):
        return SourceText(path, rel_posix, text)
    indexed = _base_modules().get(module_name(rel_posix) or "")
    if indexed is not None and indexed.rel == rel_posix and (
            text is None or text == indexed.text):
        return indexed           # parsed once already, for the index
    return Module(path, rel_posix, text)


def _comments(text: str) -> Iterator[tuple[int, str]]:
    """Real COMMENT tokens only: a docstring that shows the suppression
    syntax is not a suppression."""
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(text).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return
    for tok in tokens:
        if tok.type == tokenize.COMMENT:
            yield tok.start[0], tok.string


def _import_aliases(tree: ast.Module, name: Optional[str],
                    is_package: bool) -> dict[str, str]:
    """Local name -> fully dotted module/symbol path."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            base = node.module
            if node.level:
                if name is None:
                    continue
                pkg = name.split(".")
                if not is_package:
                    pkg = pkg[:-1]
                pkg = pkg[:len(pkg) - (node.level - 1)]
                base = ".".join(pkg + ([node.module] if node.module
                                       else []))
            if not base:
                continue
            for a in node.names:
                aliases[a.asname or a.name] = f"{base}.{a.name}"
    return aliases


def resolve_call(mod: Module, node: ast.Call) -> Optional[str]:
    """Fully qualified name of a call's callee, or None."""
    return mod.qualname(node.func)


def kw(node: ast.Call, name: str) -> Optional[ast.expr]:
    for k in node.keywords:
        if k.arg == name:
            return k.value
    return None


# --------------------------------------------------------------------------
# Tensor kinds
# --------------------------------------------------------------------------

HOST, UNKNOWN, TENSOR, BOOL = 0, 1, 2, 3


def is_tensor(kind: int) -> bool:
    return kind >= TENSOR


def join(*kinds: int) -> int:
    return max(kinds) if kinds else HOST


# attributes that are host values whatever the tensor
_HOST_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
               "requires_grad", "is_leaf", "names", "itemsize", "nbytes",
               "is_sparse", "is_quantized", "is_meta"}
# tensor methods whose result lives on the host
_HOST_METHODS = {"item", "tolist", "numel", "dim", "ndimension", "size",
                 "stride", "element_size", "data_ptr", "is_contiguous",
                 "nelement", "get_device", "storage_offset",
                 "is_floating_point", "is_complex", "numpy", "cpu",
                 "untyped_storage", "is_pinned", "is_shared", "equal"}
_BOOL_METHODS = {"bool", "any", "all", "eq", "ne", "lt", "le", "gt", "ge",
                 "isnan", "isinf", "isfinite", "logical_not", "logical_and",
                 "logical_or", "logical_xor", "isclose", "signbit",
                 "isneginf", "isposinf", "greater", "less", "not_equal",
                 "greater_equal", "less_equal", "isin"}
_BOOL_FUNCS = {f"torch.{n}" for n in _BOOL_METHODS - {"bool"}}
# methods that keep a boolean tensor boolean
_SHAPE_METHODS = {"clone", "contiguous", "expand", "expand_as", "reshape",
                  "view", "flatten", "squeeze", "unsqueeze", "transpose",
                  "permute", "repeat", "flip", "roll", "detach", "narrow",
                  "select", "index_select", "gather", "unbind", "split",
                  "chunk", "movedim", "t"}
# torch names that are not tensor-valued (and so are host values)
_TORCH_HOST = {"torch.device", "torch.Size", "torch.finfo", "torch.iinfo",
               "torch.Generator", "torch.get_default_dtype",
               "torch.is_tensor", "torch.is_floating_point", "torch.numel",
               "torch.broadcast_shapes", "torch.promote_types",
               "torch.result_type", "torch.is_grad_enabled",
               "torch.no_grad", "torch.enable_grad", "torch.inference_mode",
               "torch.set_grad_enabled", "torch.dtype", "torch.equal",
               "torch.allclose", "torch.is_nonzero", "torch.manual_seed",
               "torch.compile", "torch.get_device"}
_TORCH_HOST_PREFIXES = ("torch.cuda.", "torch.backends.", "torch.autograd.",
                        "torch.library.", "torch.profiler.",
                        "torch.distributed.", "torch.utils.", "torch.jit.",
                        "torch.testing.", "torch.func.", "torch.fx.",
                        "torch._")
_PY_HOST = {"int", "float", "bool", "len", "str", "range", "isinstance",
            "repr", "round", "abs", "enumerate", "zip", "tuple", "list",
            "sorted", "hash", "id", "type", "callable", "getattr",
            "hasattr"}


def _tensor_annotation(ann: Optional[ast.AST]) -> int:
    if ann is None:
        return UNKNOWN
    text = ast.unparse(ann).replace(" ", "")
    if text.strip("'\"") in ("Tensor", "torch.Tensor", "Optional[Tensor]",
                             "Optional[torch.Tensor]", "Tensor|None"):
        return TENSOR
    if text.strip("'\"") in ("int", "float", "bool", "str"):
        return HOST
    return UNKNOWN


def return_kind(fn: ast.FunctionDef) -> int:
    """Kind of a package function's value, from its return annotation:
    ``Tensor`` and tuples of tensors are TENSOR, numbers HOST."""
    ann = fn.returns
    if ann is None:
        return UNKNOWN
    text = ast.unparse(ann).replace(" ", "").strip("'\"")
    if text in ("int", "float", "bool", "str", "None"):
        return HOST
    if text in ("Tensor", "torch.Tensor"):
        return TENSOR
    inner = re.fullmatch(r"(?:tuple|Tuple)\[(.*)\]", text)
    if inner and all(p in ("Tensor", "torch.Tensor")
                     for p in inner.group(1).split(",")):
        return TENSOR
    return UNKNOWN


class TensorInterp:
    """Forward abstract interpretation of one function body.

    Statement-ordered; ``if`` arms run in forked environments and join.
    The walk calls ``on_node(node, interp)`` for every expression node
    and statement it meets, in order, with the environment as it is
    there; rules hook that.  Nested functions are not entered (the hot
    path analyses each function it reaches on its own, seeded with the
    enclosing function's final environment).
    """

    def __init__(self, mod: Module, fn: ast.AST,
                 ret_kind: Callable[[ast.AST], int] = lambda f: UNKNOWN,
                 seed: Optional[dict[str, int]] = None):
        self.mod = mod
        self.fn = fn
        self.ret_kind = ret_kind
        self.env: dict[str, int] = dict(seed or {})
        args = fn.args
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            self.env[a.arg] = (HOST if a.arg in ("self", "cls")
                               else _tensor_annotation(a.annotation))
        for a in (args.vararg, args.kwarg):
            if a is not None:
                self.env[a.arg] = UNKNOWN

    # -- abstract evaluation ----------------------------------------------

    def value(self, node: Optional[ast.AST]) -> int:
        if node is None or isinstance(node, (ast.Constant, ast.JoinedStr)):
            return HOST
        if isinstance(node, ast.Name):
            return self.env.get(node.id, UNKNOWN)
        if isinstance(node, ast.Attribute):
            if node.attr in _HOST_ATTRS:
                return HOST
            base = self.value(node.value)
            if is_tensor(base):
                return (base if node.attr in ("T", "mT", "H", "data")
                        else TENSOR)
            qn = self.mod.qualname(node)
            if qn is not None and qn.startswith("torch."):
                return HOST          # dtypes and other module constants
            return UNKNOWN
        if isinstance(node, ast.Subscript):
            return self.value(node.value)      # x.shape[0] is host, x[i] not
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return join(*[self.value(e) for e in node.elts])
        if isinstance(node, ast.Starred):
            return self.value(node.value)
        if isinstance(node, ast.BinOp):
            lv, rv = self.value(node.left), self.value(node.right)
            if is_tensor(lv) or is_tensor(rv):
                if (isinstance(node.op, (ast.BitAnd, ast.BitOr, ast.BitXor))
                        and BOOL in (lv, rv)
                        and all(k in (BOOL, HOST) for k in (lv, rv))):
                    return BOOL
                return TENSOR
            return HOST if lv == rv == HOST else UNKNOWN
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.Not):
                return HOST
            return self.value(node.operand)
        if isinstance(node, ast.BoolOp):
            return join(*[self.value(v) for v in node.values])
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return HOST
            kinds = [self.value(node.left)] + [self.value(c)
                                               for c in node.comparators]
            if any(is_tensor(k) for k in kinds):
                return BOOL
            return HOST if all(k == HOST for k in kinds) else UNKNOWN
        if isinstance(node, ast.IfExp):
            return join(self.value(node.body), self.value(node.orelse))
        if isinstance(node, ast.Call):
            return self._call_value(node)
        return UNKNOWN

    def _call_value(self, node: ast.Call) -> int:
        qn = resolve_call(self.mod, node)
        if qn in _PY_HOST:
            return HOST
        if qn in ("min", "max"):
            return join(*[self.value(a) for a in node.args])
        if qn is not None and qn.startswith("torch."):
            if (qn in _TORCH_HOST or qn.startswith(_TORCH_HOST_PREFIXES)
                    or qn.split(".")[-1][:1].isupper()):
                return HOST
            dt = kw(node, "dtype")
            if qn in _BOOL_FUNCS or (dt is not None and self.mod.qualname(
                    dt) == "torch.bool"):
                return BOOL
            return TENSOR
        if isinstance(node.func, ast.Attribute):
            recv = self.value(node.func.value)
            meth = node.func.attr
            if is_tensor(recv):
                if meth in _HOST_METHODS:
                    return HOST
                if meth in _BOOL_METHODS:
                    return BOOL
                if meth == "to" and any(
                        self.mod.qualname(a) == "torch.bool"
                        for a in list(node.args) + [k.value for k in
                                                    node.keywords]):
                    return BOOL
                if recv == BOOL and meth in _SHAPE_METHODS:
                    return BOOL
                return TENSOR
        return self.ret_kind(node.func)

    # -- statement walk ----------------------------------------------------

    def run(self, on_node: Callable[[ast.AST, "TensorInterp"], None]
            ) -> None:
        self._on = on_node
        self._block(self.fn.body)

    def _visit(self, node: Optional[ast.AST]) -> None:
        """Report ``node`` and every sub-expression, outer first; lambdas
        are entered (their parameters unknown), nested defs are not."""
        if node is None:
            return
        stack = [node]
        while stack:
            sub = stack.pop()
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                continue
            self._on(sub, self)
            stack.extend(reversed(list(ast.iter_child_nodes(sub))))

    def _assign(self, target: ast.AST, val: int) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = val
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._assign(e.value if isinstance(e, ast.Starred) else e,
                             val)

    def _block(self, stmts) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                self.env[stmt.name] = UNKNOWN
                continue
            if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                self._visit(stmt)
                val = self.value(stmt.value)
                if isinstance(stmt, ast.Assign):
                    for t in stmt.targets:
                        self._assign(t, val)
                elif isinstance(stmt, ast.AugAssign):
                    self._assign(stmt.target,
                                 join(self.value(stmt.target), val))
                elif stmt.value is not None:
                    self._assign(stmt.target, val)
            elif isinstance(stmt, ast.If):
                self._on(stmt, self)
                self._visit(stmt.test)
                saved = dict(self.env)
                self._block(stmt.body)
                after = self.env
                self.env = saved
                self._block(stmt.orelse)
                for k in set(after) | set(self.env):
                    self.env[k] = join(after.get(k, UNKNOWN),
                                       self.env.get(k, UNKNOWN))
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._on(stmt, self)
                self._visit(stmt.iter)
                it = self.value(stmt.iter)
                self._assign(stmt.target, TENSOR if is_tensor(it) else
                             (HOST if it == HOST else UNKNOWN))
                self._block(stmt.body)
                self._block(stmt.body)      # loop-carried kinds
                self._block(stmt.orelse)
            elif isinstance(stmt, ast.While):
                self._on(stmt, self)
                self._visit(stmt.test)
                self._block(stmt.body)
                self._block(stmt.body)
                self._block(stmt.orelse)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    self._visit(item.context_expr)
                    if item.optional_vars is not None:
                        self._assign(item.optional_vars, UNKNOWN)
                self._block(stmt.body)
            elif isinstance(stmt, ast.Try):
                self._block(stmt.body)
                for h in stmt.handlers:
                    self._block(h.body)
                self._block(stmt.orelse)
                self._block(stmt.finalbody)
            else:
                self._visit(stmt)


# --------------------------------------------------------------------------
# The package index: every module of the port, calls resolved by import
# --------------------------------------------------------------------------

@dataclasses.dataclass
class FunctionInfo:
    """One function of the package: its module, node, and scope chain."""

    qualname: str
    mod: Module
    node: ast.AST                    # FunctionDef / AsyncFunctionDef
    parent: Optional["FunctionInfo"] = None      # enclosing function


class PackageIndex:
    """The port's modules, parsed once, with one module's text replaced
    where a caller checks a seeded copy of it."""

    def __init__(self, modules: dict[str, Module]):
        self.modules = modules
        self.functions: dict[str, FunctionInfo] = {}
        self.classes: dict[str, tuple[Module, ast.ClassDef]] = {}
        self.methods_by_name: dict[str, list[str]] = {}
        for mod in modules.values():
            self._index(mod, mod.tree, mod.name, None, None)

    def with_module(self, mod: Module) -> "PackageIndex":
        """A copy of this index with ``mod`` in place of its namesake
        (or added): only ``mod`` is indexed anew."""
        new = object.__new__(PackageIndex)
        new.modules = dict(self.modules, **{mod.name: mod})
        new.functions = {k: v for k, v in self.functions.items()
                         if v.mod.name != mod.name}
        new.classes = {k: v for k, v in self.classes.items()
                       if v[0].name != mod.name}
        new.methods_by_name = {
            k: [q for q in v if q in new.functions]
            for k, v in self.methods_by_name.items()}
        new._index(mod, mod.tree, mod.name, None, None)
        return new

    @classmethod
    def load(cls, override: Optional[Module] = None) -> "PackageIndex":
        """The package's index, with ``override`` in place of its module
        (or added); without one, built once a process."""
        if override is None or override.name is None \
                or override.name.split(".")[0] != PKG_NAME:
            return _base_index()
        return _base_index().with_module(override)

    def _index(self, mod, node, prefix, parent, cls_qn) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{prefix}.{child.name}"
                info = FunctionInfo(qn, mod, child, parent)
                self.functions[qn] = info
                if cls_qn is not None:
                    self.methods_by_name.setdefault(child.name,
                                                    []).append(qn)
                self._index(mod, child, qn, info, None)
            elif isinstance(child, ast.ClassDef):
                qn = f"{prefix}.{child.name}"
                self.classes[qn] = (mod, child)
                self._index(mod, child, qn, parent, qn)
            elif not isinstance(child, ast.Lambda):
                self._index(mod, child, prefix, parent, cls_qn)

    def lookup(self, qn: str) -> Optional[str]:
        """A dotted name -> a package function's qualname, following
        re-exports (``from x import f`` in a package ``__init__``)."""
        for _ in range(4):
            if qn in self.functions or qn in self.classes:
                return qn
            head, _, leaf = qn.rpartition(".")
            mod = self.modules.get(head)
            if mod is None or leaf not in mod.aliases:
                return None
            qn = mod.aliases[leaf]
        return None

    def resolve_name(self, info: Optional[FunctionInfo], mod: Module,
                     node: ast.AST) -> Optional[str]:
        """A Name/Attribute used in ``info``'s body -> the qualname of the
        package function or class it denotes, or None."""
        if isinstance(node, ast.Name):
            scope = info
            while scope is not None:          # nested defs, innermost first
                qn = f"{scope.qualname}.{node.id}"
                if qn in self.functions:
                    return qn
                scope = scope.parent
            if mod.name is not None:
                qn = f"{mod.name}.{node.id}"
                if qn in self.functions or qn in self.classes:
                    return qn
        qn = mod.qualname(node)
        if qn is None or not qn.startswith(PKG_NAME + "."):
            return None
        return self.lookup(qn)

    def return_kind(self, info: FunctionInfo) -> Callable[[ast.AST], int]:
        """The kind of a call's value in ``info``'s body, by its callee's
        return annotation (a package function's, through scope and
        imports)."""
        def kind(func: ast.AST) -> int:
            qn = self.resolve_name(info, info.mod, func)
            if qn in self.functions:
                return return_kind(self.functions[qn].node)
            return UNKNOWN
        return kind


@functools.cache
def _base_modules() -> dict[str, Module]:
    """Every module of the installed package, parsed once a process."""
    mods = {}
    for path in sorted(PKG_DIR.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        rel = f"{PKG_REL}/{path.relative_to(PKG_DIR).as_posix()}"
        try:
            mod = Module(path, rel)
        except SyntaxError:
            continue
        mods[mod.name] = mod
    return mods


@functools.cache
def _base_index() -> PackageIndex:
    return PackageIndex(dict(_base_modules()))
