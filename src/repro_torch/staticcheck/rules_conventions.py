"""Convention rules: the port's standing conventions, as AST checks.

The reference's convention rules (`repro.staticcheck.rules_conventions`,
RPR001-RPR007) on the port's names and files:

  * RPT001 — the port imports neither JAX nor the reference package
    (the static twin of `tests/test_torch_import_surface.py`); it takes
    the band of the reference's RPR001, whose subject (the JAX version
    shims of ``compat.py``) the port does not have;
  * RPT002 — no bespoke arrival-gap synthesis (a cumulative sum of
    exponential draws) outside the sanctioned arrival modules;
  * RPT003 — no raw arrays fed to the calibration fitters (trace
    ingestion goes through ``TraceRecord``);
  * RPT004 — no hand-wired multi-``simulate_fork_join`` replica models
    (replication goes through ``cluster=ClusterSpec(r=...)``);
  * RPT005 — measurement taps go through the observability layer:
    ``telemetry=`` takes a ``TelemetrySpec``, a ``Timeline`` is engine
    output, never hand-built;
  * RPT006 — topology goes through ``cluster=ClusterSpec(...)``: no
    loose ``r=`` / ``routing=`` / ``result_cache=`` / ``replica_impl=``
    keywords on the entry points;
  * RPT007 — faults go through ``ClusterSpec(fault=FaultSpec(...))``:
    no raw literal on ``fault=`` and no hand-threaded ``fault_scan`` /
    ``fault_init``.

Names are matched by their last component, as the reference matches
them, so a rule fires whichever package a snippet imports from.  The
scopes are the reference's, mapped onto the port's files: its
``src/**`` is ``src/repro_torch/**``, its tests and examples are
``tests/test_torch_*.py``, ``examples/torch_*.py`` and
``chip_smoke.py``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.staticcheck.analysis import (
    PKG_REL,
    Finding,
    Module,
    kw,
    resolve_call,
)
from repro_torch.staticcheck.registry import rule

__all__ = ["ARRIVAL_SANCTIONED", "SRC", "TESTS_EXAMPLES"]

SRC = [f"{PKG_REL}/*.py"]
TESTS_EXAMPLES = ["tests/test_torch_*.py", "examples/torch_*.py",
                  "chip_smoke.py"]

# --------------------------------------------------------------------------
# RPT001: no JAX, no reference package
# --------------------------------------------------------------------------

_FORBIDDEN_ROOTS = ("jax", "jaxlib", "repro")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in _FORBIDDEN_ROOTS


@rule("RPT001", "no-jax-or-reference-import", "convention",
      "the port (src/repro_torch/**) and chip_smoke.py import neither jax "
      "nor the reference package repro: the card's machine has no JAX",
      scope=SRC + ["chip_smoke.py"])
def check_imports(mod: Module) -> Iterator[Finding]:
    for node in mod.nodes:
        names: list[str] = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            names = [node.module]
        elif isinstance(node, ast.Call) and resolve_call(mod, node) in (
                "importlib.import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            names = [node.args[0].value]
        for name in names:
            if _forbidden(name):
                yield mod.finding(
                    "RPT001", node, f"import of `{name}`: the port imports "
                    "neither jax nor the reference package (keep a copy of "
                    "what it needs)")


# --------------------------------------------------------------------------
# RPT002: ArrivalProcess convention
# --------------------------------------------------------------------------

# the abstraction itself, the Sec 4.2 workload statistics, the load
# generator and the calibration trace sampler (the reference's
# _ARRIVAL_SANCTIONED, in the port)
ARRIVAL_SANCTIONED = (
    f"{PKG_REL}/core/arrivals.py",
    f"{PKG_REL}/core/workload.py",
    f"{PKG_REL}/workloadgen/loadgen.py",
    f"{PKG_REL}/calibrate/measure.py",
)
_EXP_DRAWS = {"jax.random.exponential", "numpy.random.exponential"}
_CUMSUMS = {"torch.cumsum", "jax.numpy.cumsum", "numpy.cumsum",
            "jnp.cumsum"}


def _exp_draw(mod: Module, node: ast.AST, tainted: set[str]) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            qn = resolve_call(mod, sub) or ""
            f = sub.func
            if qn in _EXP_DRAWS or (isinstance(f, ast.Attribute) and (
                    f.attr == "exponential_" or (
                        f.attr == "exponential"
                        and not qn.startswith("torch.")))):
                return True
        if isinstance(sub, ast.Name) and sub.id in tainted:
            return True
    return False


@rule("RPT002", "arrivals-via-arrival-process", "convention",
      "bespoke arrival-gap synthesis (a cumulative sum of exponential "
      "draws) outside the sanctioned arrival modules; express load shapes "
      "as ArrivalProcess constructors",
      scope=SRC, exclude=list(ARRIVAL_SANCTIONED))
def check_bespoke_arrivals(mod: Module) -> Iterator[Finding]:
    for fn in [n for n in mod.nodes
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        tainted: set[str] = set()
        for stmt in fn.body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Assign) and _exp_draw(
                        mod, sub.value, tainted):
                    for t in sub.targets:
                        tainted.update(n.id for n in ast.walk(t)
                                       if isinstance(n, ast.Name))
                if not isinstance(sub, ast.Call):
                    continue
                qn = resolve_call(mod, sub)
                f = sub.func
                if qn in _CUMSUMS and sub.args:
                    src = sub.args[0]
                elif isinstance(f, ast.Attribute) and f.attr == "cumsum" \
                        and qn not in _CUMSUMS:
                    src = f.value
                else:
                    continue
                if _exp_draw(mod, src, tainted):
                    yield mod.finding(
                        "RPT002", sub, "bespoke arrival synthesis (cumsum "
                        "of exponential gaps); construct a repro_torch."
                        "core.arrivals.ArrivalProcess instead")


# --------------------------------------------------------------------------
# RPT003: TraceRecord convention
# --------------------------------------------------------------------------

_FITTER_NAMES = {"fit_moments", "calibrate", "refine", "window_stats",
                 "window_plan", "calibrate_and_validate", "validate"}
_FITTER_MODULES = ("fit.", "measure.", "validate.")
_RAW_ARRAY_FACTORIES = {
    f"{ns}.{fn}" for ns in ("torch", "numpy", "jax.numpy")
    for fn in ("asarray", "array", "stack", "concatenate", "tensor",
               "as_tensor", "cat", "from_numpy")}


def _is_fitter_call(mod: Module, node: ast.Call) -> bool:
    qn = resolve_call(mod, node)
    if qn is None:
        return False
    leaf = qn.rsplit(".", 1)[-1]
    if leaf not in _FITTER_NAMES:
        return False
    return ("calibrate" in qn or qn.startswith(_FITTER_MODULES)
            or qn == leaf and leaf in mod.aliases)


def _is_raw_array(mod: Module, node: ast.AST) -> bool:
    if isinstance(node, ast.Call):
        return resolve_call(mod, node) in _RAW_ARRAY_FACTORIES
    if isinstance(node, (ast.List, ast.Tuple)):
        return any(_is_raw_array(mod, e) for e in node.elts) or all(
            isinstance(e, ast.Constant) for e in node.elts) and bool(
                node.elts)
    return False


@rule("RPT003", "traces-are-trace-records", "convention",
      "raw arrays passed to calibration fitters; construct a "
      "repro_torch.calibrate.measure.TraceRecord (or a list of them)",
      scope=SRC + TESTS_EXAMPLES)
def check_raw_trace_arrays(mod: Module) -> Iterator[Finding]:
    for node in mod.nodes:
        if not (isinstance(node, ast.Call) and _is_fitter_call(mod, node)):
            continue
        first = node.args[0] if node.args else None
        for k in node.keywords:
            if k.arg in ("traces", "trace"):
                first = k.value
        if first is not None and _is_raw_array(mod, first):
            yield mod.finding(
                "RPT003", node, "raw array fed to a calibration fitter; "
                "trace ingestion goes through TraceRecord")


# --------------------------------------------------------------------------
# RPT004: replica topology through the dispatcher
# --------------------------------------------------------------------------

_SIM_ENTRY_LEAVES = {"simulate_fork_join", "simulate_fork_join_batch"}
_REPLICA_NAMES = {"r", "replicas", "n_replicas", "n_rep", "num_replicas"}


@rule("RPT004", "replicas-via-dispatcher", "convention",
      "hand-wired replica modelling around simulate_fork_join; pass "
      "cluster=ClusterSpec(r=..., routing=...) instead",
      scope=SRC)
def check_handwired_replicas(mod: Module) -> Iterator[Finding]:
    looped = {id(sub) for n in mod.nodes
              if isinstance(n, (ast.For, ast.While)) for sub in ast.walk(n)}

    def in_loop(call: ast.Call) -> bool:
        return id(call) in looped

    for node in mod.nodes:
        if not isinstance(node, ast.Call):
            continue
        qn = resolve_call(mod, node)
        if qn is None or qn.rsplit(".", 1)[-1] not in _SIM_ENTRY_LEAVES:
            continue
        has_topology = bool({"r", "cluster"}
                            & {k.arg for k in node.keywords})
        if not has_topology and in_loop(node):
            yield mod.finding(
                "RPT004", node, "simulate_fork_join called in a loop "
                "without a replica topology; repeated single-replica runs "
                "assume perfect splitting: pass cluster=ClusterSpec(r=..., "
                "routing=...)")
            continue
        for arg in list(node.args[:2]) + [
                k.value for k in node.keywords if k.arg == "lam"]:
            if (isinstance(arg, ast.BinOp) and isinstance(arg.op, ast.Div)
                    and isinstance(arg.right, ast.Name)
                    and arg.right.id in _REPLICA_NAMES
                    and not has_topology):
                yield mod.finding(
                    "RPT004", node, f"arrival rate divided by "
                    f"`{arg.right.id}` by hand; pass the TOTAL rate with "
                    "cluster=ClusterSpec(r=...) so routing imbalance is "
                    "modelled")


# --------------------------------------------------------------------------
# RPT005: telemetry through the observability layer
# --------------------------------------------------------------------------

_TELEMETRY_ENTRY_LEAVES = {"simulate_fork_join", "simulate_fork_join_batch",
                           "sweep_simulated"}


@rule("RPT005", "telemetry-via-spec", "convention",
      "telemetry= takes a repro_torch.obs.TelemetrySpec (or None), and a "
      "Timeline is engine output, never hand-built",
      scope=SRC + ["examples/torch_*.py"])
def check_telemetry_spec(mod: Module) -> Iterator[Finding]:
    for node in mod.nodes:
        if not isinstance(node, ast.Call):
            continue
        qn = resolve_call(mod, node)
        leaf = qn.rsplit(".", 1)[-1] if qn else None
        if leaf == "Timeline":
            yield mod.finding(
                "RPT005", node, "Timeline constructed by hand; timelines "
                "are engine output: pass telemetry=TelemetrySpec(...) to "
                "the simulator, or use timeline_from_trace")
            continue
        if leaf not in _TELEMETRY_ENTRY_LEAVES:
            continue
        v = kw(node, "telemetry")
        if v is None or (isinstance(v, ast.Constant) and v.value is None):
            continue
        if isinstance(v, (ast.Constant, ast.Tuple, ast.List, ast.Dict)):
            yield mod.finding(
                "RPT005", node, "raw literal passed as telemetry=; "
                "construct a repro_torch.obs.TelemetrySpec")


# --------------------------------------------------------------------------
# RPT006: topology through ClusterSpec
# --------------------------------------------------------------------------

_CLUSTER_LOOSE = {
    "simulate_fork_join": {"r", "routing", "result_cache", "replica_impl"},
    "simulate_fork_join_batch": {"r", "routing", "result_cache",
                                 "replica_impl"},
    "sweep_simulated": {"routing", "replica_impl"},
    "plan_capacity": {"routing", "result_cache"},
    "validate": {"replicas", "routing", "result_cache"},
}


@rule("RPT006", "topology-via-cluster-spec", "convention",
      "loose topology keywords (r=/routing=/result_cache=/replica_impl=/"
      "replicas=) on the entry points; put them on "
      "cluster=ClusterSpec(...)",
      scope=SRC + TESTS_EXAMPLES, exclude=[f"{PKG_REL}/core/cluster.py"])
def check_cluster_spec(mod: Module) -> Iterator[Finding]:
    for node in mod.nodes:
        if not isinstance(node, ast.Call):
            continue
        qn = resolve_call(mod, node)
        leaf = qn.rsplit(".", 1)[-1] if qn else None
        loose = _CLUSTER_LOOSE.get(leaf)
        bad = sorted((loose or set()) & {k.arg for k in node.keywords})
        if bad:
            yield mod.finding(
                "RPT006", node, f"loose keyword(s) {', '.join(bad)} on "
                f"{leaf}(); put them on cluster=ClusterSpec(...)")


# --------------------------------------------------------------------------
# RPT007: faults through FaultSpec
# --------------------------------------------------------------------------

_FAULT_PRIMITIVES = {"fault_scan", "fault_init"}


@rule("RPT007", "faults-via-fault-spec", "convention",
      "fault injection goes through cluster=ClusterSpec(fault=FaultSpec("
      "...)): raw literals on fault= and hand-threaded fault_scan/"
      "fault_init recurrences bypass the validated spec",
      scope=SRC + TESTS_EXAMPLES,
      exclude=[f"{PKG_REL}/core/faults.py", "tests/test_torch_faults.py"])
def check_fault_spec(mod: Module) -> Iterator[Finding]:
    for node in mod.nodes:
        if not isinstance(node, ast.Call):
            continue
        qn = resolve_call(mod, node)
        leaf = qn.rsplit(".", 1)[-1] if qn else None
        if leaf in _FAULT_PRIMITIVES:
            yield mod.finding(
                "RPT007", node, f"direct {leaf}() call hand-threads the "
                "outage recurrence; describe the faults as ClusterSpec("
                "fault=FaultSpec(...)) and let the engine drive it")
            continue
        if leaf != "ClusterSpec":
            continue
        v = kw(node, "fault")
        if v is None:
            continue
        literal = isinstance(v, (ast.Dict, ast.List, ast.Tuple, ast.Set))
        literal = literal or (isinstance(v, ast.Constant)
                              and v.value is not None)
        if literal:
            yield mod.finding(
                "RPT007", node, "raw literal on ClusterSpec(fault=...); "
                "build a FaultSpec(...) so outage windows and quorum knobs "
                "are validated in one place")
