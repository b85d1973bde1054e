"""CUDA kernel rules: how the port builds, binds and launches kernels.

Each hand-written kernel is a CUDA C++ source with a plain C interface
(``kernels/<pkg>/csrc/<name>.cu``), built by ``nvcc`` into a shared
library and called through ctypes (`repro_torch.kernels._cuda`).  What
goes wrong there throws nowhere near the mistake, or not at all:

  * RPT201 — a library loaded or built another way than
    `kernels._cuda.CudaLibrary` skips its flags (``NVCC_FLAGS``:
    ``sm_90a``), its build cache and its error check (the reference's
    RPR201, compiler params through the compat shim);
  * RPT202 — a ctypes ``argtypes`` list that disagrees with its
    ``extern "C"`` signature does not raise: it passes garbage to the
    card (the reference's RPR202, index-map arity).  For every
    ``CudaLibrary(source, {name: argtypes})`` the function must be an
    ``extern "C"`` function of the source, with the list's arity and
    types (``void*`` <-> ``c_void_p``, ``int64_t`` <-> ``c_int64``,
    ``const int64_t*`` <-> ``POINTER(c_int64)``, ``int`` <-> ``c_int``,
    ``float`` / ``double`` <-> ``c_float`` / ``c_double``); the list is
    evaluated from the AST (``[_P] * 6 + [_I, _I, _P]``, module
    constants, a dict comprehension over entry names);
  * RPT203 — a launch grid (a ``dim3`` or the first ``<<<...>>>``
    argument) built by a plain integer division drops the last partial
    block; the ceiling forms ``(a + b - 1) / b`` or a ``cdiv`` helper
    are what is wanted (the reference's RPR203);
  * RPT204 — every public function of a ``kernels/*/ops.py`` that
    launches through its ``kernel`` module takes ``impl=``, resolves it
    through ``_cuda.resolve_impl`` and reaches its plain version in
    ``ref.py``: the CPU path the tests run (the reference's RPR204,
    interpret plumbing).
"""

from __future__ import annotations

import ast
import ctypes
import pathlib
import re
from typing import Any, Iterator, Optional

from repro_torch.staticcheck.analysis import (
    PKG_REL,
    Finding,
    Module,
    SourceText,
    kw,
    resolve_call,
    strip_c_comments,
)
from repro_torch.staticcheck.registry import rule

__all__ = ["c_signatures", "ctype_of", "library_bindings"]

_CUDA_PY = f"{PKG_REL}/kernels/_cuda.py"

# --------------------------------------------------------------------------
# RPT201: kernels only through CudaLibrary
# --------------------------------------------------------------------------

_LOADERS = {"ctypes.CDLL", "ctypes.PyDLL", "ctypes.cdll.LoadLibrary",
            "ctypes.CDLL.LoadLibrary", "torch.ops.load_library"}
_SUBPROCESS = {"subprocess.run", "subprocess.Popen", "subprocess.call",
               "subprocess.check_call", "subprocess.check_output",
               "os.system"}


@rule("RPT201", "kernels-via-cuda-library", "cuda",
      "CUDA code is built and loaded only by kernels._cuda.CudaLibrary "
      "(NVCC_FLAGS, its build cache, its launch check): no ctypes.CDLL, "
      "torch.utils.cpp_extension or nvcc subprocess elsewhere",
      scope=[f"{PKG_REL}/*.py", "chip_smoke.py"], exclude=[_CUDA_PY])
def check_build_route(mod: Module) -> Iterator[Finding]:
    for node in mod.nodes:
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
                "torch.utils.cpp_extension"):
            yield mod.finding("RPT201", node, "import of torch.utils."
                              "cpp_extension; build through CudaLibrary")
            continue
        if not isinstance(node, ast.Call):
            continue
        qn = resolve_call(mod, node) or ""
        if qn in _LOADERS:
            yield mod.finding("RPT201", node, f"`{qn}` loads a library "
                              "outside kernels._cuda.CudaLibrary")
        elif qn.startswith("torch.utils.cpp_extension."):
            yield mod.finding("RPT201", node, f"`{qn}` builds outside "
                              "kernels._cuda.CudaLibrary (NVCC_FLAGS)")
        elif qn in _SUBPROCESS and any(
                isinstance(s, ast.Constant) and isinstance(s.value, str)
                and "nvcc" in s.value
                or isinstance(s, ast.Call) and (resolve_call(mod, s) or ""
                                                ).endswith("_nvcc")
                for a in node.args for s in ast.walk(a)):
            yield mod.finding("RPT201", node, "nvcc run outside kernels."
                              "_cuda.CudaLibrary (NVCC_FLAGS, build cache)")


# --------------------------------------------------------------------------
# RPT202: argtypes against the extern "C" signatures
# --------------------------------------------------------------------------

_C_TYPES = {
    "void*": "c_void_p", "cudaStream_t": "c_void_p", "char*": "c_char_p",
    "int64_t": "c_int64", "longlong": "c_longlong", "long": "c_long",
    "int": "c_int", "int32_t": "c_int32", "uint32_t": "c_uint32",
    "uint64_t": "c_uint64", "size_t": "c_size_t", "float": "c_float",
    "double": "c_double", "bool": "c_bool", "unsigned": "c_uint",
}


def ctype_of(c_param: str) -> str:
    """A C parameter declaration -> the ctypes spelling it needs
    (``const int64_t* plan`` -> ``POINTER(c_int64)``)."""
    text = re.sub(r"\b(const|volatile|restrict|__restrict__)\b", " ",
                  c_param)
    text = re.sub(r"\s+", " ", text).strip()
    m = re.fullmatch(r"(.*?)([A-Za-z_]\w*)?\s*(\[\s*\])?", text)
    base = (m.group(1) if m and m.group(2) and m.group(1).strip()
            else text).replace(" ", "")
    if m and m.group(3):
        base += "*"
    stars = len(base) - len(base.rstrip("*"))
    core = base.rstrip("*")
    if core == "longlong" or core == "unsignedlonglong":
        core = "longlong"
    if stars == 1 and core in ("void",):
        return "c_void_p"
    if stars == 0:
        return _C_TYPES.get(core, f"?{core}")
    if stars == 1 and core + "*" in _C_TYPES:
        return _C_TYPES[core + "*"]
    inner = _C_TYPES.get(core, f"?{core}")
    return f"POINTER({inner})" if stars == 1 else f"?{base}"


def c_signatures(text: str) -> dict[str, list[str]]:
    """``extern "C"`` functions of a CUDA source -> their parameters'
    ctypes spellings (both ``extern "C" int f(...)`` and ``extern "C" {
    ... }`` blocks)."""
    code = strip_c_comments(text)
    spans = []
    for m in re.finditer(r'extern\s+"C"\s*(\{)?', code):
        if m.group(1):
            depth, i = 1, m.end()
            while i < len(code) and depth:
                depth += {"{": 1, "}": -1}.get(code[i], 0)
                i += 1
            spans.append((m.end(), i - 1))
        else:
            end = code.find("{", m.end())
            spans.append((m.end(), end if end >= 0 else len(code)))
    sigs: dict[str, list[str]] = {}
    for start, end in spans:
        chunk = code[start:end]
        for fm in re.finditer(r"\b([A-Za-z_]\w*)\s*\(", chunk):
            head = chunk[:fm.start()].rstrip().rsplit("\n", 1)[-1]
            if not re.search(r"(^|[\s*;}])(int|void|cudaError_t|int64_t|"
                             r"float|double)\s*\*?\s*$", head):
                continue
            depth, i = 1, fm.end()
            while i < len(chunk) and depth:
                depth += {"(": 1, ")": -1}.get(chunk[i], 0)
                i += 1
            params = chunk[fm.end():i - 1].strip()
            after = chunk[i:i + 40].lstrip()
            if not after.startswith(("{", ";")) and after:
                continue
            plist = [] if params in ("", "void") else [
                p.strip() for p in params.split(",")]
            sigs[fm.group(1)] = [ctype_of(p) for p in plist]
    return sigs


class _Eval:
    """Evaluates the module-level expressions a declaration uses."""

    def __init__(self, mod: Module):
        self.mod = mod
        self.env: dict[str, Any] = {}
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                try:
                    self.env[stmt.targets[0].id] = self.eval(stmt.value)
                except (ValueError, KeyError, TypeError, OSError):
                    pass

    def eval(self, node: ast.AST, local: Optional[dict] = None) -> Any:
        local = local or {}
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            if node.id in local:
                return local[node.id]
            if node.id in self.env:
                return self.env[node.id]
            if node.id == "__file__":
                return self.mod.path
            raise KeyError(node.id)
        if isinstance(node, (ast.List, ast.Tuple)):
            vals = [self.eval(e, local) for e in node.elts]
            return vals if isinstance(node, ast.List) else tuple(vals)
        if isinstance(node, ast.BinOp):
            a, b = self.eval(node.left, local), self.eval(node.right, local)
            if isinstance(node.op, ast.Add):
                return a + b
            if isinstance(node.op, ast.Mult):
                return a * b
            if isinstance(node.op, ast.Div):
                return pathlib.Path(a) / b
            raise ValueError("operator")
        if isinstance(node, ast.Attribute):
            qn = self.mod.qualname(node)
            if qn is not None and qn.startswith("ctypes."):
                return qn[len("ctypes."):]
            base = self.eval(node.value, local)
            if isinstance(base, pathlib.PurePath) and node.attr == "parent":
                return base.parent
            raise ValueError(node.attr)
        if isinstance(node, ast.Call):
            qn = resolve_call(self.mod, node) or ""
            if qn == "ctypes.POINTER":
                return f"POINTER({self.eval(node.args[0], local)})"
            if qn == "pathlib.Path" and node.args:
                return pathlib.Path(self.eval(node.args[0], local))
            if isinstance(node.func, ast.Attribute) and node.func.attr in (
                    "resolve", "absolute") and not node.args:
                return pathlib.Path(self.eval(node.func.value, local))
            raise ValueError(qn)
        if isinstance(node, ast.Dict):
            return {self.eval(k, local): self.eval(v, local)
                    for k, v in zip(node.keys, node.values)}
        if isinstance(node, ast.DictComp) and len(node.generators) == 1:
            gen = node.generators[0]
            if not isinstance(gen.target, ast.Name) or gen.ifs:
                raise ValueError("comprehension")
            out = {}
            for item in self.eval(gen.iter, local):
                inner = dict(local, **{gen.target.id: item})
                out[self.eval(node.key, inner)] = self.eval(node.value,
                                                            inner)
            return out
        raise ValueError(type(node).__name__)


def library_bindings(mod: Module
                     ) -> Iterator[tuple[ast.Call, Any, Any, str]]:
    """(call, source path or None, entries dict or None, error) for every
    ``CudaLibrary(...)`` of ``mod``."""
    ev = None
    for node in mod.nodes:
        if not (isinstance(node, ast.Call) and (resolve_call(mod, node) or ""
                                                ).endswith("CudaLibrary")):
            continue
        ev = ev or _Eval(mod)
        src_node = node.args[0] if node.args else kw(node, "source")
        ent_node = node.args[1] if len(node.args) > 1 else kw(node,
                                                              "entries")
        try:
            source = ev.eval(src_node)
            entries = ev.eval(ent_node)
        except (ValueError, KeyError, TypeError) as exc:
            yield node, None, None, f"{type(exc).__name__}: {exc}"
            continue
        yield node, source, entries, ""


@rule("RPT202", "binding-signature", "cuda",
      "every CudaLibrary entry names an extern \"C\" function of its "
      "source, and its ctypes argtypes have that function's arity and "
      "types (a mismatch passes garbage to the card)",
      scope=[f"{PKG_REL}/*.py"], exclude=[_CUDA_PY])
def check_bindings(mod: Module) -> Iterator[Finding]:
    for node, source, entries, err in library_bindings(mod):
        if err:
            yield mod.finding("RPT202", node, "CudaLibrary declaration not "
                              f"statically evaluable ({err}); spell the "
                              "source path and argtypes from module "
                              "constants")
            continue
        path = pathlib.Path(source)
        if not path.exists():
            yield mod.finding("RPT202", node, f"source {path.name} not "
                              "found beside the module")
            continue
        sigs = c_signatures(path.read_text())
        for name, argtypes in entries.items():
            got = [str(t) for t in argtypes]
            if name not in sigs:
                yield mod.finding("RPT202", node, f"`{name}` is not an "
                                  f"extern \"C\" function of {path.name}")
                continue
            want = sigs[name]
            if len(got) != len(want):
                yield mod.finding(
                    "RPT202", node, f"`{name}`: {len(got)} argtypes, but "
                    f"{path.name} declares {len(want)} parameters")
                continue
            for i, (g, w) in enumerate(zip(got, want)):
                if g != w and not _same_width(g, w):
                    yield mod.finding(
                        "RPT202", node, f"`{name}` argument {i}: argtypes "
                        f"says {g}, {path.name} declares {w}")
                    break


def _same_width(a: str, b: str) -> bool:
    """ctypes spellings that are one type on this platform (c_int64 and
    c_longlong; c_long is 64-bit on Linux)."""
    same = {"c_int64", "c_longlong", "c_long"}
    if a in same and b in same:
        return ctypes.sizeof(getattr(ctypes, a)) == ctypes.sizeof(
            getattr(ctypes, b))
    return False


# --------------------------------------------------------------------------
# RPT203: launch grids by ceiling division
# --------------------------------------------------------------------------

def _split_args(text: str) -> list[str]:
    out, depth, cur = [], 0, ""
    for c in text:
        if c in "([{":
            depth += 1
        elif c in ")]}":
            depth -= 1
        if c == "," and depth == 0:
            out.append(cur)
            cur = ""
        else:
            cur += c
    if cur.strip():
        out.append(cur)
    return [a.strip() for a in out]


def _balanced(text: str, start: int, open_: str, close: str) -> int:
    depth, i = 0, start
    while i < len(text):
        if text[i] == open_:
            depth += 1
        elif text[i] == close:
            depth -= 1
            if depth == 0:
                return i
        i += 1
    return len(text)


def _floor_divisions(expr: str) -> list[str]:
    """The divisions of a C expression that are not ceiling forms."""
    bad = []
    for m in re.finditer(r"(?<![/*])/(?![/*=])", expr):
        left = expr[:m.start()].rstrip()
        if left.endswith(")"):
            depth, i = 0, len(left) - 1
            while i >= 0:
                depth += {")": 1, "(": -1}.get(left[i], 0)
                if depth == 0:
                    break
                i -= 1
            group = left[i:]
            if re.search(r"-\s*1\s*\)$", group):
                continue
            plus = re.search(r"\+\s*(\d+)\s*\)$", group)
            div = re.match(r"\s*(\d+)\b", expr[m.end():])
            if plus and div and int(plus.group(1)) == int(div.group(1)) - 1:
                continue             # (n + 127) / 128
        bad.append(expr[max(0, m.start() - 30):m.end() + 20].strip())
    return bad


_CAST = re.compile(r"^(?:static_cast<[^>]*>|\([A-Za-z_ ]+\))\s*\((.*)\)$",
                   re.S)


def _grid_dims(code: str) -> Iterator[tuple[int, str]]:
    """(offset, expression) of every launch grid dimension."""
    for m in re.finditer(r"\bdim3\s+\w+\s*([({])|\bdim3\s*\(", code):
        open_ = m.group(1) or "("
        start = m.end() - 1
        end = _balanced(code, start, open_, ")" if open_ == "(" else "}")
        for a in _split_args(code[start + 1:end]):
            yield m.start(), a
    for m in re.finditer(r"<<<", code):
        end = code.find(">>>", m.end())
        args = _split_args(code[m.end():end])
        # a dim3, named or built in place, is checked where it is built
        if args and not args[0].startswith("dim3") and not re.fullmatch(
                r"[A-Za-z_]\w*", args[0]):
            yield m.start(), args[0]


def _unwrap(expr: str) -> str:
    expr = expr.strip()
    while True:
        m = _CAST.match(expr)
        if not m:
            return expr
        expr = m.group(1).strip()


@rule("RPT203", "grid-ceiling-division", "cuda",
      "a launch grid dimension built with a plain integer division drops "
      "the last partial block; use (a + b - 1) / b or a cdiv helper",
      scope=[f"{PKG_REL}/kernels/*.cu"])
def check_grid_division(src: SourceText) -> Iterator[Finding]:
    code = src.code
    for offset, dim in _grid_dims(code):
        expr = _unwrap(dim)
        exprs = [expr]
        ident = re.findall(r"[A-Za-z_]\w*", expr)
        if re.fullmatch(r"[\w\s<>?:=!]+", expr) and ident:
            # a variable (or a clamp of one): check its definition once
            for name in set(ident):
                defs = list(re.finditer(
                    rf"\b{name}\s*=\s*([^;]+);", code[:offset]))
                if defs:
                    exprs.append(defs[-1].group(1))
        for e in exprs:
            for bad in _floor_divisions(e):
                line = code.count("\n", 0, offset) + 1
                yield src.finding(
                    "RPT203", line, f"launch grid uses a floor division "
                    f"(`{bad}`); a partial block would be dropped: use "
                    "(a + b - 1) / b")


# --------------------------------------------------------------------------
# RPT204: impl= plumbing of the kernels' ops
# --------------------------------------------------------------------------

def _module_funcs(mod: Module) -> dict[str, ast.FunctionDef]:
    return {n.name: n for n in mod.tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _reach(mod: Module, fn: ast.FunctionDef, funcs: dict, pred) -> bool:
    """Whether ``pred(node)`` holds for a node of ``fn`` or of a module
    function it names, transitively."""
    seen, stack = set(), [fn]
    while stack:
        f = stack.pop()
        if f.name in seen:
            continue
        seen.add(f.name)
        for node in ast.walk(f):
            if pred(node):
                return True
            if isinstance(node, ast.Name) and node.id in funcs:
                stack.append(funcs[node.id])
    return False


def _sibling(mod: Module, name: str) -> Optional[str]:
    """Dotted name of the ops module's sibling ``name`` (kernel, ref) as
    the module imports it, or None."""
    if mod.name is None:
        return None
    pkg = mod.name.rsplit(".", 1)[0]
    return f"{pkg}.{name}"


@rule("RPT204", "impl-plumbing", "cuda",
      "every public function of kernels/*/ops.py that launches through its "
      "kernel module takes impl=, resolves it through _cuda.resolve_impl "
      "and reaches its plain version in ref.py (the CPU path)",
      scope=[f"{PKG_REL}/kernels/*/ops.py"])
def check_impl_plumbing(mod: Module) -> Iterator[Finding]:
    funcs = _module_funcs(mod)
    kernel_mod, ref_mod = _sibling(mod, "kernel"), _sibling(mod, "ref")
    ref_path = mod.path.with_name("ref.py")
    ref_names = None
    if ref_path.exists():
        ref_names = {n.name for n in ast.parse(ref_path.read_text()).body
                     if isinstance(n, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))}

    kernel_path = mod.path.with_name("kernel.py")
    kernel_funcs = None
    if kernel_path.exists():
        kernel_funcs = {n.name for n in ast.parse(kernel_path.read_text(
        )).body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}

    def launches(node):
        qn = mod.qualname(node) if isinstance(node, ast.Attribute) else None
        if qn is None or not qn.startswith(f"{kernel_mod}."):
            return False
        leaf = qn.rsplit(".", 1)[-1]
        return (leaf in kernel_funcs if kernel_funcs is not None
                else leaf.endswith("_cuda"))

    def resolves(node):
        return isinstance(node, ast.Call) and (
            mod.qualname(node.func) or "").endswith("_cuda.resolve_impl")

    def plain(node):
        qn = mod.qualname(node) if isinstance(node, ast.Attribute) else None
        return qn is not None and qn.startswith(f"{ref_mod}.") and (
            ref_names is None or qn.rsplit(".", 1)[-1] in ref_names)

    for name, fn in funcs.items():
        if name.startswith("_") or not _reach(mod, fn, funcs, launches):
            continue
        args = fn.args
        if "impl" not in {a.arg for a in args.args + args.kwonlyargs}:
            yield mod.finding("RPT204", fn, f"`{name}` launches a kernel "
                              "but takes no impl= (the CPU path cannot be "
                              "chosen)")
        elif not _reach(mod, fn, funcs, resolves):
            yield mod.finding("RPT204", fn, f"`{name}` does not resolve "
                              "impl through _cuda.resolve_impl")
        elif not _reach(mod, fn, funcs, plain):
            yield mod.finding("RPT204", fn, f"`{name}` reaches no plain "
                              "version in ref.py (the CPU path)")
