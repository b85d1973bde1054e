"""Command line: collect files, run rules, report, gate.

Usage (from the repository's root):

    python -m repro_torch.staticcheck src/repro_torch tests examples chip_smoke.py
    python -m repro_torch.staticcheck --format json src/repro_torch
    python -m repro_torch.staticcheck --list-rules
    python -m repro_torch.staticcheck --update-contract

Exit codes: 0 = clean, 1 = unsuppressed findings, 2 = usage error.
A directory contributes its ``.py`` files and its CUDA sources
(``.cu``); the reference's checker (`repro.staticcheck`) walks the same
tree with its own rules and marker.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Iterable, Optional, Sequence

from repro_torch.staticcheck.analysis import (
    PKG_DIR,
    PREFIX_IDS,
    Finding,
    load_source,
)
from repro_torch.staticcheck.registry import FAMILIES, RULES, rules_for_path

__all__ = ["DEFAULT_TARGETS", "ROOT", "check_file", "check_source",
           "collect_files", "list_rules", "main", "run"]

_SKIP_DIRS = {"__pycache__", ".git", ".venv", "build", "dist", "_build"}
_SUFFIXES = (".py", ".cu")
ROOT = PKG_DIR.parent.parent          # the checkout (src/repro_torch/..)
DEFAULT_TARGETS = ("src/repro_torch", "tests", "examples", "chip_smoke.py")


def check_source(text: str, rel_posix: str,
                 path: Optional[pathlib.Path] = None) -> list[Finding]:
    """Run every applicable rule over one source string.

    ``rel_posix`` decides the rules' scopes (tests pass synthetic paths
    like ``src/repro_torch/core/x.py``).  Suppressed findings are kept
    (marked), so reporters can count them; RPT000 covers malformed
    suppressions and files that do not parse.
    """
    try:
        src = load_source(path or ROOT / rel_posix, rel_posix, text=text)
    except SyntaxError as e:
        return [Finding("RPT000", rel_posix, e.lineno or 1, 0,
                        f"could not parse: {e.msg}")]
    findings: list[Finding] = []
    for lineno, msg in src.bad_suppressions:
        findings.append(Finding("RPT000", rel_posix, lineno, 0, msg))
    for lineno, ids in src.suppressions.items():
        for rid in sorted(ids):
            if rid not in RULES:
                findings.append(Finding(
                    "RPT000", rel_posix, lineno, 0,
                    f"suppression references unknown rule ID {rid}"
                    + ("" if rid.startswith(PREFIX_IDS) else
                       " (the port's IDs are RPT###; the reference's "
                       "RPR### go behind its own marker)")))
    for r in rules_for_path(rel_posix):
        for f in r.check(src):
            if src.is_suppressed(f.rule_id, f.line):
                f = Finding(f.rule_id, f.path, f.line, f.col, f.message,
                            suppressed=True)
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule_id))
    return findings


def check_file(path: pathlib.Path, root: pathlib.Path) -> list[Finding]:
    try:
        rel = path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        rel = path.as_posix()
    return check_source(path.read_text(), rel, path=path)


def collect_files(targets: Sequence[str],
                  root: pathlib.Path) -> list[pathlib.Path]:
    files: list[pathlib.Path] = []
    for t in targets:
        p = (root / t) if not pathlib.Path(t).is_absolute() else \
            pathlib.Path(t)
        if p.is_file():
            files.append(p)
        elif p.is_dir():
            files.extend(
                f for f in sorted(p.rglob("*"))
                if f.suffix in _SUFFIXES and f.is_file()
                and not _SKIP_DIRS.intersection(f.relative_to(p).parts))
        else:
            raise FileNotFoundError(t)
    return files


def run(targets: Sequence[str],
        root: pathlib.Path = ROOT) -> list[Finding]:
    findings: list[Finding] = []
    for f in collect_files(targets, root):
        findings.extend(check_file(f, root))
    return findings


# --------------------------------------------------------------------------
# Reporters
# --------------------------------------------------------------------------

def report_text(findings: Iterable[Finding], out=sys.stdout) -> None:
    findings = list(findings)
    active = [f for f in findings if not f.suppressed]
    for f in active:
        print(f.render(), file=out)
    n_sup = sum(1 for f in findings if f.suppressed)
    print(f"staticcheck-torch: {len(active)} finding(s), {n_sup} "
          f"suppressed, {len(RULES)} rule(s)", file=out)


def report_json(findings: Iterable[Finding], out=sys.stdout) -> None:
    findings = list(findings)
    payload = {
        "findings": [
            {"rule": f.rule_id, "path": f.path, "line": f.line,
             "col": f.col, "message": f.message,
             "suppressed": f.suppressed}
            for f in findings],
        "counts": {
            "active": sum(1 for f in findings if not f.suppressed),
            "suppressed": sum(1 for f in findings if f.suppressed),
        },
    }
    json.dump(payload, out, indent=2, sort_keys=True)
    print(file=out)


def list_rules(out=sys.stdout) -> None:
    for family in FAMILIES:
        for rid in sorted(r for r in RULES if RULES[r].family == family):
            r = RULES[rid]
            print(f"{rid}  [{r.family:<10}]  {r.name}", file=out)
            print(f"        {r.description}", file=out)


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    import repro_torch.staticcheck  # noqa: F401  (registers every rule)
    ap = argparse.ArgumentParser(
        prog="repro-torch-staticcheck",
        description="AST checks for the PyTorch / CUDA port (conventions, "
                    "host syncs on the hot path, CUDA bindings and grids, "
                    "the entry points' shape contract)")
    ap.add_argument("targets", nargs="*", default=list(DEFAULT_TARGETS),
                    help="files/directories to check (default: "
                         + " ".join(DEFAULT_TARGETS) + ")")
    ap.add_argument("--root", default=".",
                    help="repo root that scoping globs are relative to")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule registry and exit")
    ap.add_argument("--no-contract", action="store_true",
                    help="skip the shape contract (pure AST, no torch)")
    ap.add_argument("--update-contract", action="store_true",
                    help="re-snapshot shape_contract.json and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        list_rules()
        return 0

    # imported lazily: the contract runs the entry points through torch
    if args.update_contract:
        from repro_torch.staticcheck import contract
        contract.save()
        print(f"wrote {contract.CONTRACT_PATH}")
        return 0

    root = pathlib.Path(args.root)
    try:
        findings = run(args.targets or list(DEFAULT_TARGETS), root)
    except FileNotFoundError as e:
        print(f"staticcheck-torch: no such target: {e}", file=sys.stderr)
        return 2

    if not args.no_contract:
        from repro_torch.staticcheck import contract
        findings.extend(contract.check())

    reporter = report_json if args.format == "json" else report_text
    reporter(findings)
    return 1 if any(not f.suppressed for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())
