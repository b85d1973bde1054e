"""repro_torch.staticcheck: rule-based static analysis for the port.

Five rule families over one registry (`repro_torch.staticcheck.registry`),
IDs ``RPT###`` in the reference checker's bands:

  * convention rules (RPT001-099) — no JAX or reference import, and the
    reference's conventions (ArrivalProcess, TraceRecord, ClusterSpec,
    TelemetrySpec, FaultSpec) on the port's names;
  * host-sync rules (RPT101-199) — a host sync, the global generator or a
    fixed float64 on the hot path (the chunk loop and what it calls);
  * CUDA rules (RPT201-299) — builds through ``CudaLibrary``, ctypes
    bindings against the ``extern "C"`` signatures, launch grids by
    ceiling division, ``impl=`` plumbing of the kernels' ops;
  * the shape contract (RPT301) — the entry points' output dtypes and
    shapes against ``shape_contract.json``.

Run ``python -m repro_torch.staticcheck src/repro_torch tests examples
chip_smoke.py`` (or the ``repro-torch-staticcheck`` console script).
Suppress one line with ``# staticcheck-torch: disable=RPT101 (reason)``;
a marker without an ID is itself a finding.  The reference checker
(`repro.staticcheck`) keeps its own marker and IDs: a line both flag
carries both comments.
"""

from repro_torch.staticcheck import contract as _contract  # registers RPT301
from repro_torch.staticcheck import rules_conventions as _rc  # noqa: F401
from repro_torch.staticcheck import rules_cuda as _rcu  # noqa: F401
from repro_torch.staticcheck import rules_hostsync as _rh  # noqa: F401
from repro_torch.staticcheck.analysis import Finding, Module
from repro_torch.staticcheck.cli import check_source, main, run
from repro_torch.staticcheck.registry import RULES, Rule, rules_for_path

__all__ = [
    "Finding",
    "Module",
    "RULES",
    "Rule",
    "check_source",
    "main",
    "run",
    "rules_for_path",
]
