"""The port's rule registry: stable IDs, metadata, scoping.

Every rule of `repro_torch.staticcheck` registers here with a stable
``RPT###`` ID.  The CLI (`repro_torch.staticcheck.cli`), the tests
(`tests/test_torch_staticcheck.py`) and the README rule table read THIS
table, so a suppression (``# staticcheck-torch: disable=RPT101``) can
never name a phantom ID.

The IDs keep the reference checker's bands (`repro.staticcheck`, whose
IDs are ``RPR###``); the prefix and the suppression marker differ, so
neither checker reads the other's suppressions:

  * ``RPT000``           framework (suppression hygiene)
  * ``RPT001``-``RPT099`` repo conventions, on the port's names
  * ``RPT101``-``RPT199`` host syncs, generators and float64 on the hot
    path (the reference's tracer band)
  * ``RPT201``-``RPT299`` CUDA kernels: builds, bindings, grids, impl=
    (the reference's Pallas band)
  * ``RPT301``-``RPT399`` the entry points' shape contract
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Callable, Iterator, Optional, Sequence

__all__ = ["FAMILIES", "PREFIX", "RULES", "Rule", "register_datarule",
           "rule", "rules_for_path"]

PREFIX = "RPT"
FAMILIES = ("framework", "convention", "hostsync", "cuda", "contract")
BANDS = {"framework": (0, 0), "convention": (1, 99), "hostsync": (101, 199),
         "cuda": (201, 299), "contract": (301, 399)}


@dataclasses.dataclass(frozen=True)
class Rule:
    """One registered rule.

    ``scope`` holds fnmatch patterns over the repo-relative posix path
    (``*`` crosses ``/``); a file is checked by the rule iff it matches
    an include pattern and no pattern of ``exclude``.  ``check`` takes an
    `repro_torch.staticcheck.analysis.Module` (a Python file) or a
    `SourceText` (a CUDA source) and yields `Finding`s; the contract has
    ``check=None`` (it runs in the harness, not per file).
    """

    id: str
    name: str
    family: str
    description: str
    scope: tuple[str, ...]
    exclude: tuple[str, ...] = ()
    check: Optional[Callable[..., Iterator]] = None

    def applies_to(self, rel_posix: str) -> bool:
        if not any(fnmatch.fnmatch(rel_posix, pat) for pat in self.scope):
            return False
        return not any(fnmatch.fnmatch(rel_posix, pat)
                       for pat in self.exclude)


RULES: dict[str, Rule] = {}


def _register(r: Rule) -> Rule:
    if r.family not in FAMILIES:
        raise ValueError(f"unknown rule family {r.family!r}")
    if r.id in RULES:
        raise ValueError(f"duplicate rule id {r.id}")
    lo, hi = BANDS[r.family]
    if not (r.id.startswith(PREFIX) and lo <= int(r.id[3:]) <= hi):
        raise ValueError(f"{r.id} is outside the {r.family} band")
    RULES[r.id] = r
    return r


def rule(id: str, name: str, family: str, description: str,
         scope: Sequence[str], exclude: Sequence[str] = ()):
    """Register a checker function under a stable rule ID."""
    def deco(fn):
        _register(Rule(id=id, name=name, family=family,
                       description=description, scope=tuple(scope),
                       exclude=tuple(exclude), check=fn))
        return fn

    return deco


def register_datarule(id: str, name: str, family: str, description: str,
                      scope: Sequence[str] = ()) -> Rule:
    """Register a rule with no per-file checker (the contract)."""
    return _register(Rule(id=id, name=name, family=family,
                          description=description, scope=tuple(scope)))


def rules_for_path(rel_posix: str) -> list[Rule]:
    return [r for r in RULES.values()
            if r.check is not None and r.applies_to(rel_posix)]


# emitted by the CLI (`cli.check_source`) for a suppression without a
# rule ID, an unknown rule ID, and a file that does not parse
register_datarule(
    "RPT000", "suppression-hygiene", "framework",
    "a `# staticcheck-torch: disable=` comment must name registered RPT "
    "rule IDs; every checked file must parse")
