"""Tests for the port's checker, `repro_torch.staticcheck`.

Mirrors tests/test_staticcheck.py wherever a rule has a counterpart: for
each rule a seeded snippet that is flagged, the same line suppressed with
the port's marker, and clean code the rule must not flag; suppression
hygiene; the CLI's exit codes and ``--list-rules``; the shape contract
against a seeded regression, a removed probe and a missing file.  Beyond
the reference's: the binding rule on seeded wrong arity and type and on
the real libraries, the host-sync rule's hot path (reached through calls,
a callback and the segment sums, not before or after the chunk loop),
the convention rules held against the reference's own checker on the
same snippets, and the port's contract against the reference's.
"""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys

import pytest

import repro.staticcheck as ref_sc
import repro_torch.staticcheck as sc
from repro_torch.staticcheck import contract
from repro_torch.staticcheck.registry import BANDS
from repro_torch.staticcheck.rules_hostsync import hot_path

ROOT = pathlib.Path(__file__).resolve().parent.parent
MARK = "# staticcheck-torch: disable="
SRC = "src/repro_torch/core/x.py"


def ids_of(src: str, rel: str = SRC) -> list[str]:
    return [f.rule_id for f in sc.check_source(src, rel)
            if not f.suppressed]


def assert_triple(rule: str, rel: str, bad: str, clean: str) -> None:
    """Positive hit, suppressed hit, clean code: the per-rule contract."""
    hits = sc.check_source(bad, rel)
    assert any(f.rule_id == rule and not f.suppressed for f in hits), (
        f"{rule} did not fire:\n{bad}\n{[f.render() for f in hits]}")
    flagged = sorted({f.line for f in hits if f.rule_id == rule})
    lines = bad.splitlines()
    comment = "//" if rel.endswith(".cu") else "#"
    for line in flagged:
        lines[line - 1] += f"  {comment} staticcheck-torch: disable={rule}"
    suppressed = sc.check_source("\n".join(lines) + "\n", rel)
    assert all(f.suppressed for f in suppressed if f.rule_id == rule), (
        f"{rule} suppression did not take")
    assert not any(f.rule_id == rule for f in sc.check_source(clean, rel)), (
        f"{rule} false-fired on clean code:\n{clean}\n"
        + "\n".join(f.render() for f in sc.check_source(clean, rel)))


# --------------------------------------------------------------------------
# framework: RPT000, the registry, the CLI
# --------------------------------------------------------------------------

# reference rules the port has no rule of its own number for, with why
# (ROADMAP.md, Standing differences of slice 17, says the same)
NO_COUNTERPART = {
    "RPR103": "merged into RPT101: numpy on a tensor is a host sync",
    "RPR105": "merged into RPT101: int()/float()/bool() of a tensor is a "
              "host sync",
}


def test_rule_ids_are_stable_and_banded():
    for rid, rule in sc.RULES.items():
        assert rid == rule.id and rid.startswith("RPT")
        lo, hi = BANDS[rule.family]
        assert lo <= int(rid[3:]) <= hi, f"{rid} outside {rule.family} band"
    fams = {r.family for r in sc.RULES.values()}
    assert fams == {"framework", "convention", "hostsync", "cuda",
                    "contract"}


@pytest.mark.parametrize("ref_id", sorted(ref_sc.RULES))
def test_every_reference_rule_is_mapped(ref_id):
    roadmap = (ROOT / "ROADMAP.md").read_text()
    if ref_id in NO_COUNTERPART:
        assert f"RPT{ref_id[3:]}" not in sc.RULES
        assert ref_id in roadmap, f"{ref_id} not in ROADMAP's differences"
    else:
        assert f"RPT{ref_id[3:]}" in sc.RULES, f"{ref_id} has no RPT twin"


def test_bare_suppression_is_a_finding():
    assert "RPT000" in ids_of("x = 1  # staticcheck-torch: disable\n")
    assert "RPT000" in ids_of("x = 1  # staticcheck-torch: disable=(why)\n")


@pytest.mark.parametrize("rid", ["RPT999", "RPR101"])
def test_unknown_rule_id_suppression_is_a_finding(rid):
    assert "RPT000" in ids_of(f"x = 1  {MARK}{rid} (why)\n")


def test_markers_do_not_cross():
    """The port reads only its marker, the reference only its own; a line
    both flag carries both comments."""
    src = ("from repro_torch.obs.timeline import Timeline\n"
           "t = Timeline(count=1)  # staticcheck: disable=RPR005  (x)\n")
    assert "RPT005" in ids_of(src)
    src2 = src.replace("  (x)", f"  (x)  {MARK}RPT005 (y)")
    assert "RPT005" not in ids_of(src2)
    ref = [f.rule_id for f in ref_sc.check_source(src2, SRC)
           if not f.suppressed]
    assert ref == []            # RPT005 behind the port's marker: unseen
    port_only = src.replace("# staticcheck: disable=RPR005", f"{MARK}RPT005")
    assert [f.rule_id for f in ref_sc.check_source(port_only, SRC)
            if not f.suppressed] == ["RPR005"]


def test_docstring_mention_is_not_a_suppression():
    src = '"""Use # staticcheck-torch: disable=RPT0xx on the line."""\n'
    assert ids_of(src) == []


def test_syntax_error_reports_not_raises():
    assert "RPT000" in ids_of("def f(:\n")


def _cli(*args, cwd=None, env_home=None):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.staticcheck", *args],
        capture_output=True, text=True, cwd=cwd,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(env_home or cwd or ROOT)})


def test_cli_module_runs_and_gates(tmp_path):
    bad = tmp_path / "src" / "repro_torch" / "core"
    bad.mkdir(parents=True)
    (bad / "x.py").write_text("import jax\n")
    (bad / "y.py").write_text("import jax  # staticcheck-torch: disable="
                              "RPT001 (a seeded exception)\n")
    proc = _cli("src", "--root", str(tmp_path), "--no-contract",
                "--format", "json", env_home=tmp_path)
    assert proc.returncode == 1, proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["counts"] == {"active": 1, "suppressed": 1}
    assert payload["findings"][0]["rule"] == "RPT001"
    (bad / "x.py").write_text("import torch\n")
    proc = _cli("src", "--root", str(tmp_path), "--no-contract",
                env_home=tmp_path)
    assert proc.returncode == 0, proc.stdout
    assert "0 finding(s), 1 suppressed" in proc.stdout


def test_cli_usage_error(tmp_path):
    proc = _cli("nope", "--root", str(tmp_path), "--no-contract",
                env_home=tmp_path)
    assert proc.returncode == 2


def test_cli_list_rules():
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    for rid, r in sc.RULES.items():
        assert re.search(rf"{rid}\s+\[{r.family}\s*\]", proc.stdout), rid


# --------------------------------------------------------------------------
# convention rules
# --------------------------------------------------------------------------

CONVENTION_CASES = {
    "RPT001": (SRC, "import jax.numpy as jnp\n",
               "import torch\nimport repro_torch.core\n"),
    "RPT001-from": (SRC, "from repro.core import simulator\n",
                    "from repro_torch.core import simulator\n"),
    "RPT001-dynamic": ("chip_smoke.py",
                       "import importlib\nm = importlib.import_module("
                       "'repro.core')\n",
                       "import importlib\nm = importlib.import_module("
                       "'repro_torch.core')\n"),
    "RPT002": (SRC,
               "import torch\n"
               "def arr(gen, lam, n):\n"
               "    gaps = torch.empty(n).exponential_(generator=gen) / lam\n"
               "    return torch.cumsum(gaps, 0)\n",
               "from repro_torch.core.arrivals import ArrivalProcess\n"
               "def arr(lam):\n"
               "    return ArrivalProcess.stationary(lam, device='cpu')\n"),
    "RPT003": (SRC,
               "import torch\n"
               "from repro_torch.calibrate.fit import fit_moments\n"
               "params = fit_moments(torch.stack([a, b]))\n",
               "from repro_torch.calibrate.fit import fit_moments\n"
               "from repro_torch.calibrate.measure import TraceRecord\n"
               "def f(tr: TraceRecord):\n"
               "    return fit_moments(tr)\n"),
    "RPT004": (SRC,
               "from repro_torch.core.simulator import simulate_fork_join\n"
               "def f(lam, n, params, n_replicas):\n"
               "    return [simulate_fork_join(i, lam / n_replicas, n,\n"
               "                               params)\n"
               "            for i in range(n_replicas)] + [\n"
               "        simulate_fork_join(0, lam / n_replicas, n, params)]\n",
               "from repro_torch.core.cluster import ClusterSpec\n"
               "from repro_torch.core.simulator import simulate_fork_join\n"
               "def f(lam, n, params, n_rep):\n"
               "    return simulate_fork_join(0, lam, n, params,\n"
               "        cluster=ClusterSpec(r=n_rep))\n"),
    "RPT005": (SRC,
               "from repro_torch.core.simulator import simulate_fork_join\n"
               "def f(params):\n"
               "    return simulate_fork_join(0, 50.0, 256, params,\n"
               "                              telemetry=64)\n",
               "from repro_torch.core.simulator import simulate_fork_join\n"
               "from repro_torch.obs import TelemetrySpec\n"
               "def f(params, spec):\n"
               "    return [simulate_fork_join(0, 50.0, 256, params,\n"
               "                               telemetry=t)\n"
               "            for t in (TelemetrySpec(), None, spec)]\n"),
    "RPT005-timeline": (
        "examples/torch_x.py",
        "from repro_torch.obs import Timeline\n"
        "def f(xs):\n"
        "    return Timeline(bin_seconds=xs, count=xs)\n",
        "def f(trace):\n"
        "    return trace.to_timeline()\n"),
    "RPT006": ("tests/test_torch_x.py",
               "from repro_torch.core.simulator import simulate_fork_join\n"
               "def f(params):\n"
               "    return simulate_fork_join(0, 50.0, 256, params,\n"
               "                              r=3, routing='jsq')\n",
               "from repro_torch.core.cluster import ClusterSpec\n"
               "from repro_torch.core.simulator import simulate_fork_join\n"
               "def f(params):\n"
               "    return simulate_fork_join(\n"
               "        0, 50.0, 256, params,\n"
               "        cluster=ClusterSpec(r=3, routing='jsq'))\n"),
    "RPT007": (SRC,
               "from repro_torch.core.cluster import ClusterSpec\n"
               "spec = ClusterSpec(r=3, fault=((0, 5.0, 10.0),))\n",
               "from repro_torch.core.cluster import ClusterSpec\n"
               "from repro_torch.core.faults import FaultSpec\n"
               "ft = FaultSpec(mtbf_seconds=30.0)\n"
               "a = ClusterSpec(r=2, fault=None)\n"
               "b = ClusterSpec(r=2, fault=ft)\n"),
    "RPT007-scan": ("examples/torch_x.py",
                    "from repro_torch.core.faults import fault_init\n"
                    "def masks(spec):\n"
                    "    return fault_init(spec, 2, 4, device='cpu')\n",
                    "from repro_torch.core.cluster import ClusterSpec\n"
                    "def f(spec):\n"
                    "    return ClusterSpec(r=3, fault=spec)\n"),
}


@pytest.mark.parametrize("case", sorted(CONVENTION_CASES))
def test_convention_rules(case):
    rel, bad, clean = CONVENTION_CASES[case]
    assert_triple(case.split("-")[0], rel, bad, clean)


def test_convention_scopes():
    R = sc.RULES
    assert R["RPT001"].applies_to("chip_smoke.py")
    assert not R["RPT001"].applies_to("tests/test_torch_simulator.py")
    assert not R["RPT002"].applies_to("src/repro_torch/core/arrivals.py")
    assert not R["RPT002"].applies_to("src/repro_torch/calibrate/measure.py")
    assert not R["RPT002"].applies_to("tests/test_torch_simulator.py")
    assert R["RPT006"].applies_to("tests/test_torch_replication.py")
    assert R["RPT006"].applies_to("examples/torch_whatif_sweep.py")
    assert not R["RPT006"].applies_to("src/repro_torch/core/cluster.py")
    assert not R["RPT006"].applies_to("tests/test_replication.py")
    assert not R["RPT007"].applies_to("src/repro_torch/core/faults.py")
    assert not R["RPT007"].applies_to("tests/test_torch_faults.py")
    # the engine drives the recurrence through a suppression at its one
    # call site, not a file-wide exclusion
    assert R["RPT007"].applies_to("src/repro_torch/core/simulator.py")
    assert R["RPT005"].applies_to("src/repro_torch/obs/timeline.py")


# port vs reference: the same snippets through both checkers; the
# reference matches names by their last component, so snippets in the
# port's names are the reference rule's own cases
PARITY = [
    ("RPR002", "import numpy as np\n"
               "def arr(lam, n):\n"
               "    gaps = np.random.exponential(1.0 / lam, n)\n"
               "    return np.cumsum(gaps)\n"),
    ("RPR002", "import numpy as np\n"
               "def arr(lam, n):\n"
               "    return np.cumsum(np.full(n, 1.0 / lam))\n"),
    ("RPR003", "import numpy as np\n"
               "from repro_torch.calibrate.fit import fit_moments\n"
               "params = fit_moments(np.stack([a, b]))\n"),
    ("RPR003", "from repro_torch.calibrate.fit import fit_moments\n"
               "params = fit_moments(trace_record)\n"),
    ("RPR004", "from repro_torch.core.simulator import simulate_fork_join\n"
               "def f(lam, params, n_replicas):\n"
               "    outs = []\n"
               "    for i in range(n_replicas):\n"
               "        outs.append(simulate_fork_join(i, lam, 256, params))\n"
               "    return outs\n"),
    ("RPR004", "from repro_torch.core.simulator import simulate_fork_join\n"
               "def f(lam, params, r):\n"
               "    return simulate_fork_join(0, lam / r, 256, params)\n"),
    ("RPR004", "from repro_torch.core.cluster import ClusterSpec\n"
               "from repro_torch.core.simulator import simulate_fork_join\n"
               "def f(lam, params, r):\n"
               "    return simulate_fork_join(0, lam, 256, params,\n"
               "                              cluster=ClusterSpec(r=r))\n"),
    ("RPR005", "from repro_torch.core.simulator import simulate_fork_join\n"
               "x = simulate_fork_join(0, 1.0, 8, p, telemetry=(8, 0.3))\n"),
    ("RPR005", "from repro_torch.obs.timeline import Timeline\n"
               "t = Timeline(count=c)\n"),
    ("RPR005", "from repro_torch.obs import TelemetrySpec\n"
               "from repro_torch.core.simulator import simulate_fork_join\n"
               "x = simulate_fork_join(0, 1.0, 8, p,\n"
               "                       telemetry=TelemetrySpec(n_bins=8))\n"),
    ("RPR006", "from repro_torch.core.capacity import plan_capacity\n"
               "x = plan_capacity(p, 100.0, 0.3, routing='jsq')\n"),
    ("RPR006", "from repro_torch.core.sweep import sweep_simulated\n"
               "x = sweep_simulated(grid, 0, replica_impl='masked')\n"),
    ("RPR006", "from repro_torch.core.sweep import sweep_simulated\n"
               "x = sweep_simulated(grid, 0, cluster=c)\n"),
    ("RPR007", "from repro_torch.core.faults import fault_scan\n"
               "m = fault_scan(spec, 4, carry, t, gaps)\n"),
    ("RPR007", "from repro_torch.core.cluster import ClusterSpec\n"
               "c = ClusterSpec(r=2, fault={'mtbf': 3.0})\n"),
    ("RPR007", "from repro_torch.core.cluster import ClusterSpec\n"
               "c = ClusterSpec(r=2, fault=None)\n"),
]


@pytest.mark.parametrize("ref_id,src", PARITY,
                         ids=[f"{r}-{i}" for i, (r, _) in enumerate(PARITY)])
def test_conventions_agree_with_reference(ref_id, src):
    port_id = "RPT" + ref_id[3:]
    ref_hit = any(f.rule_id == ref_id and not f.suppressed
                  for f in ref_sc.check_source(src, SRC))
    port_hit = port_id in ids_of(src)
    assert ref_hit == port_hit, (ref_id, ref_hit, port_hit)


# --------------------------------------------------------------------------
# host-sync rules
# --------------------------------------------------------------------------

_LOOP = ("import numpy as np\n"
         "import torch\n"
         "from torch import Tensor\n"
         "def engine(x: Tensor, n_chunks: int):\n"
         "    total = torch.zeros(())\n"
         "    for c_idx in range(n_chunks):\n"
         "{body}"
         "    return total\n")

SYNC_CASES = {
    "item": "        total = total + x.sum().item()\n",
    "tolist": "        total = total + sum(x.tolist())\n",
    "cpu": "        total = total + x.cpu().sum()\n",
    "int": "        total = total + int(x.max())\n",
    "float": "        total = total + float(torch.amax(x))\n",
    "if": "        if x.sum() > 0:\n            total = total + 1\n",
    "while": "        while (x > 0).any():\n            x = x - 1\n",
    "not": "        total = total + (not x.any())\n",
    "nonzero": "        total = total + torch.nonzero(x).sum()\n",
    "nonzero-method": "        total = total + x.nonzero().sum()\n",
    "unique": "        total = total + torch.unique(x).sum()\n",
    "masked_select": "        total = total + x.masked_select(x > 0).sum()\n",
    "where-1": "        total = total + torch.where(x > 0)[0].sum()\n",
    "bool-mask": "        total = total + x[x > 0].sum()\n",
    "bool-mask-tuple": "        m = torch.isfinite(x)\n"
                       "        total = total + x[:, m].sum()\n",
    "synchronize": "        torch.cuda.synchronize()\n",
    "numpy": "        total = total + np.sum(x)\n",
    "h2d": "        total = total + torch.tensor([1.0, 2.0],"
           " device=x.device).sum()\n",
    "h2d-to": "        total = total + torch.tensor([1.0]).to(x.device).sum()\n",
    "equal": "        total = total + torch.equal(x, x)\n",
}


@pytest.mark.parametrize("case", sorted(SYNC_CASES))
def test_rpt101_flags_each_sync(case):
    bad = _LOOP.format(body=SYNC_CASES[case])
    clean = _LOOP.format(body="        total = total + x.sum()\n")
    assert_triple("RPT101", SRC, bad, clean)


CLEAN_LOOP_CASES = {
    "shape": "        total = total + x.shape[0] + int(x.shape[-1])\n",
    "is-none": "        if x is None:\n            break\n",
    "host-int": "        total = total + int(n_chunks * 0.5)\n",
    "where-3": "        total = total + torch.where(x > 0, x, 0.0).sum()\n",
    "long-index": "        i = torch.argmax(x)\n        total = total + x[i]\n",
    "full": "        total = total + torch.full((2,), float(n_chunks)).sum()\n",
    "as-tensor-of-tensor": "        t = torch.as_tensor(x, device=x.device)\n"
                           "        total = total + t.sum()\n",
    "cpu-tensor": "        t = torch.tensor([1.0, 2.0])\n"
                  "        total = total + t.sum()\n",
}


@pytest.mark.parametrize("case", sorted(CLEAN_LOOP_CASES))
def test_rpt101_clean_in_loop(case):
    assert "RPT101" not in ids_of(_LOOP.format(body=CLEAN_LOOP_CASES[case]))


def test_rpt101_only_the_loop_is_hot():
    src = ("import torch\n"
           "from torch import Tensor\n"
           "def engine(x: Tensor, n_chunks: int):\n"
           "    n = int(x.max())\n"
           "    for c_idx in range(n_chunks):\n"
           "        x = x + 1\n"
           "    return x.sum().item() + n\n")
    assert "RPT101" not in ids_of(src)


def test_rpt101_follows_calls_and_callbacks():
    src = ("import torch\n"
           "from torch import Tensor\n"
           "def helper(x: Tensor) -> Tensor:\n"
           "    return x * float(x.max())\n"
           "def cold(x: Tensor):\n"
           "    return x.sum().item()\n"
           "def make_draws(x: Tensor):\n"
           "    def draws(c: int):\n"
           "        return x[x > c]\n"
           "    return engine(draws, 4)\n"
           "def engine(draws, n_chunks: int):\n"
           "    for c_idx in range(n_chunks):\n"
           "        y = helper(draws(c_idx))\n"
           "    return y\n")
    lines = {f.line for f in sc.check_source(src, SRC)
             if f.rule_id == "RPT101"}
    assert lines == {4, 9}          # helper and the callback, not `cold`


def test_rpt101_reads_return_annotations():
    src = ("import torch\n"
           "from torch import Tensor\n"
           "def scale(x) -> Tensor:\n"
           "    return x * 2\n"
           "def engine(x, n_chunks: int):\n"
           "    for c_idx in range(n_chunks):\n"
           "        y = scale(x)\n"
           "        if y.sum() > 0:\n"
           "            x = y\n"
           "    return x\n")
    assert {f.line for f in sc.check_source(src, SRC)
            if f.rule_id == "RPT101"} == {8}
    assert "RPT101" not in ids_of(src.replace(" -> Tensor", ""))


def test_hot_path_reaches_the_engine():
    hot = set(hot_path().units)
    for qn in ("core.simulator.fcfs_completion_times",
               "core.simulator._fcfs_segmented",
               "core.simulator._routing_assign",
               "core.simulator._compact",
               "core.simulator.chunk_random_draws",
               "core.simulator.chunk_side_draws",
               "core.simulator._simulate_stream.quorum_join",
               "core.arrivals.ArrivalProcess.rate_at",
               "obs.timeline.segment_sums",
               "kernels.fleet_scan.ops.fleet_scan",
               "kernels.jsq_route.ops.jsq_route",
               "kernels.maxplus_scan.ops.maxplus_segment_scan",
               "kernels.maxplus_scan.kernel.maxplus_scan_cuda",
               "_segment._run_sums"):
        assert f"repro_torch.{qn}" in hot, qn
    # the engine itself: the chunk loop, not its set-up; host work
    # around the loop (the sweep's dispatch, the dashboard) is not hot
    assert hot_path().units["repro_torch.core.simulator._simulate_stream"] \
        != [None]
    assert not [qn for qn in hot if qn.startswith((
        "repro_torch.core.sweep.sweep_", "repro_torch.obs.report."))]
    assert "repro_torch.core.simulator.simulate_fork_join_batch" not in hot
    assert "repro_torch.core.simulator.simulate_fork_join_batch.draws" in hot


@pytest.fixture(scope="module")
def tree_findings():
    return sc.run(["src/repro_torch", "tests", "examples", "chip_smoke.py"],
                  ROOT)


def test_host_syncs_of_the_port_are_the_deliberate_ones(tree_findings):
    """RPT101 over the port reports the segment sums' two reads and the
    host-input helper's copy, all suppressed with a reason, and nothing
    else on the hot path."""
    found = [f for f in tree_findings if f.rule_id == "RPT101"]
    sites = {(f.path.rsplit("/", 1)[-1], f.line) for f in found}
    seg = (ROOT / "src/repro_torch/_segment.py").read_text().splitlines()
    want = {("_segment.py", i + 1) for i, line in enumerate(seg)
            if "disable=RPT101" in line}
    assert len(want) == 2 and want <= sites
    assert all(f.suppressed for f in found)
    assert {s for s in sites if s[0] != "_segment.py"} == {("_tensor.py", 64)}
    for f in found:
        line = (ROOT / f.path).read_text().splitlines()[f.line - 1]
        assert re.search(r"disable=RPT101 \(.+\)", line), line


def _seeded(rel: str, anchor: str, insert: str) -> str:
    text = (ROOT / rel).read_text()
    assert text.count(anchor) == 1, anchor
    return text.replace(anchor, anchor + insert)


SIM = "src/repro_torch/core/simulator.py"


@pytest.mark.parametrize("where,anchor,insert,hot", [
    ("loop", "        gidx = col + c_idx * chunk\n",
     "        _probe = float(last_arrival.sum())\n", True),
    ("reached", "    order = torch.argsort(assign, dim=-1, stable=True)\n",
     "    _probe = order.max().item()\n", True),
    ("draws", "    kc = _mix(seed, chunk_idx)\n",
     "    _probe = bool(torch.zeros(1).any())\n", True),
    ("before-loop", "    col = torch.arange(chunk, device=device)\n",
     "    _probe = int(col.max())\n", False),
])
def test_rpt101_on_the_real_engine(where, anchor, insert, hot):
    text = _seeded(SIM, anchor, insert)
    line = text[:text.index(insert)].count("\n") + 1
    flagged = {f.line for f in sc.check_source(text, SIM)
               if f.rule_id == "RPT101" and not f.suppressed}
    assert (line in flagged) == hot, (where, flagged)


def test_rpt102_generator_discipline():
    assert_triple(
        "RPT102", SRC,
        bad=("import torch\n"
             "def draws(n):\n"
             "    return torch.rand(n) + torch.empty(n).exponential_()\n"),
        clean=("import torch\n"
               "def draws(n, seed):\n"
               "    g = torch.Generator(device='cpu')\n"
               "    g.manual_seed(seed)\n"
               "    return torch.rand(n, generator=g)\n"))


@pytest.mark.parametrize("bad", [
    "import torch\ntorch.manual_seed(0)\n",
    "import numpy as np\nx = np.random.exponential(1.0, 8)\n",
    ("import torch\n"
     "def two(seed, n):\n"
     "    a = torch.Generator(device='cpu')\n"
     "    a.manual_seed(seed + 1)\n"
     "    b = torch.Generator(device='cpu').manual_seed(seed + 1)\n"
     "    return a, b\n"),
    ("import torch\n"
     "def loop(seed, n):\n"
     "    out = []\n"
     "    for i in range(n):\n"
     "        g = torch.Generator(device='cpu')\n"
     "        g.manual_seed(seed)\n"
     "        out.append(torch.rand(1, generator=g))\n"
     "    return out\n"),
])
def test_rpt102_cases(bad):
    assert "RPT102" in ids_of(bad)


def test_rpt102_salted_streams_are_clean():
    src = ("import torch\n"
           "def salted(seed, n):\n"
           "    out = []\n"
           "    for i in range(n):\n"
           "        g = torch.Generator(device='cpu')\n"
           "        g.manual_seed(mix(seed, i))\n"
           "        h = torch.Generator(device='cpu')\n"
           "        h.manual_seed(mix(seed, i, 1))\n"
           "        out.append(torch.rand(1, generator=g)\n"
           "                   + torch.rand(1, generator=h))\n"
           "    return out\n")
    assert "RPT102" not in ids_of(src)


def test_rpt104_f64_on_the_hot_path():
    assert_triple(
        "RPT104", SRC,
        bad=_LOOP.format(body="        total = total + x.double().sum()\n"),
        clean=_LOOP.format(
            body="        acc = torch.float64 if x.dtype == torch.float64"
                 " else torch.float32\n"
                 "        total = total + x.to(acc).sum()\n"))


# --------------------------------------------------------------------------
# CUDA rules
# --------------------------------------------------------------------------

def test_rpt201_build_route():
    assert_triple(
        "RPT201", "src/repro_torch/kernels/foo/kernel.py",
        bad=("import ctypes\n"
             "lib = ctypes.CDLL('libfoo.so')\n"),
        clean=("from repro_torch.kernels._cuda import CudaLibrary\n"
               "LIB = CudaLibrary(SRC, {})\n"))
    assert "RPT201" in ids_of(
        "import subprocess\nsubprocess.run(['nvcc', '-o', 'x', 'x.cu'])\n",
        "src/repro_torch/kernels/foo/kernel.py")
    assert "RPT201" in ids_of(
        "from torch.utils.cpp_extension import load\n", "chip_smoke.py")
    assert not sc.RULES["RPT201"].applies_to("src/repro_torch/kernels/_cuda.py")


MP_KERNEL = "src/repro_torch/kernels/maxplus_scan/kernel.py"


@pytest.mark.parametrize("old,new,what", [
    ("[_P] * 6 + [_I, _I, _P]", "[_P] * 5 + [_I, _I, _P]", "argtypes"),
    ("[_P] * 6 + [_I, _I, _P]", "[_P] * 6 + [_I, ctypes.c_int, _P]",
     "argument 7"),
    ("[_P] * 6 + [_I, _I, _P]", "[_P] * 6 + [_I, _P, _P]", "argument 7"),
    ('"maxplus_scan_f32", "maxplus_scan_f64"',
     '"maxplus_scan_f32", "maxplus_scan_f16"', "not an extern"),
])
def test_rpt202_seeded_bindings(old, new, what):
    text = (ROOT / MP_KERNEL).read_text()
    assert old in text
    found = [f for f in sc.check_source(text.replace(old, new), MP_KERNEL)
             if f.rule_id == "RPT202"]
    assert found and what in found[0].message, [f.render() for f in found]


def test_rpt202_real_libraries_are_clean():
    from repro_torch.staticcheck.rules_cuda import library_bindings
    mods = sorted((ROOT / "src/repro_torch/kernels").rglob("*.py"))
    entries = 0
    libs = 0
    for path in mods:
        rel = path.relative_to(ROOT).as_posix()
        text = path.read_text()
        if "CudaLibrary(" not in text or rel.endswith("_cuda.py"):
            continue
        assert [f.render() for f in sc.check_source(text, rel)
                if f.rule_id == "RPT202"] == []
        mod = sc.Module(path, rel)
        for _, source, ent, err in library_bindings(mod):
            assert not err and pathlib.Path(source).exists()
            libs += 1
            entries += len(ent)
    # nine kernel libraries and the Hopper tile check, 19 entry points
    assert (libs, entries) == (10, 19)


def test_c_signature_parser():
    from repro_torch.staticcheck.rules_cuda import c_signatures
    sigs = c_signatures(
        'extern "C" {\n'
        'int f(const void* a, int64_t n, const int64_t* plan,'
        ' const double* x, int k, float s, void* stream);\n'
        '}\n'
        '// extern "C" int g(int x);\n'
        'extern "C" int h(void) { return 0; }\n')
    assert sigs == {"f": ["c_void_p", "c_int64", "POINTER(c_int64)",
                          "POINTER(c_double)", "c_int", "c_float",
                          "c_void_p"], "h": []}


CU = "src/repro_torch/kernels/foo/csrc/foo.cu"


@pytest.mark.parametrize("bad,clean", [
    ("void go(int n, void* s) {\n"
     "  const dim3 grid(static_cast<unsigned>(n / 128));\n"
     "  k<<<grid, 128, 0, s>>>(n);\n}\n",
     "void go(int n, void* s) {\n"
     "  const dim3 grid(static_cast<unsigned>((n + 127) / 128));\n"
     "  k<<<grid, 128, 0, s>>>(n);\n}\n"),
    ("void go(int n, void* s) {\n"
     "  const int64_t blocks = n / kRows;\n"
     "  k<<<static_cast<unsigned>(blocks), 32, 0, s>>>(n);\n}\n",
     "void go(int n, void* s) {\n"
     "  const int64_t blocks = (n + kRows - 1) / kRows;  // ceil\n"
     "  k<<<static_cast<unsigned>(blocks), 32, 0, s>>>(n);\n}\n"),
    ("void go(int n, void* s) {\n"
     "  k<<<dim3(n / 32, 2), 32, 0, s>>>(n);\n}\n",
     "void go(int n, void* s) {\n"
     "  k<<<dim3(cdiv(n, 32), 2), 32, 0, s>>>(n);\n}\n"),
])
def test_rpt203_grid_divisibility(bad, clean):
    assert_triple("RPT203", CU, bad, clean)


def test_rpt203_real_sources_are_clean():
    for path in sorted((ROOT / "src/repro_torch/kernels").rglob("*.cu")):
        rel = path.relative_to(ROOT).as_posix()
        assert [f.render() for f in sc.check_source(path.read_text(), rel)
                if f.rule_id == "RPT203"] == []


OPS = "src/repro_torch/kernels/foo/ops.py"


@pytest.mark.parametrize("bad", [
    ("from repro_torch.kernels.foo import kernel, ref\n"
     "def op(x):\n"
     "    return kernel.op_cuda(x)\n"),
    ("from repro_torch.kernels.foo import kernel, ref\n"
     "def op(x, *, impl='auto'):\n"
     "    if impl == 'torch':\n"
     "        return ref.op_ref(x)\n"
     "    return kernel.op_cuda(x)\n"),
    ("from repro_torch.kernels._cuda import resolve_impl\n"
     "from repro_torch.kernels.foo import kernel, ref\n"
     "def op(x, *, impl='auto'):\n"
     "    resolve_impl(impl, x.device)\n"
     "    return kernel.op_cuda(x)\n"),
])
def test_rpt204_impl_plumbing(bad):
    clean = ("from repro_torch.kernels._cuda import resolve_impl\n"
             "from repro_torch.kernels.foo import kernel, ref\n"
             "def launch_count():\n"
             "    return kernel.launches\n"
             "def _plain(x):\n"
             "    return ref.op_ref(x)\n"
             "def op(x, *, impl='auto'):\n"
             "    path = resolve_impl(impl, x.device)\n"
             "    fwd = kernel.op_cuda if path == 'cuda' else _plain\n"
             "    return fwd(x)\n")
    assert_triple("RPT204", OPS, bad, clean)


# --------------------------------------------------------------------------
# the shape contract (RPT301)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def live_snapshot():
    modes: dict = {}
    live = contract.snapshot(modes=modes)
    return live, modes


def test_contract_matches_committed(live_snapshot):
    live, modes = live_snapshot
    findings = contract.check(live=live)
    assert not findings, "\n".join(f.render() for f in findings)
    assert contract.load()["modes"] == modes
    assert modes["sweep_analytical"] == "fake"


def test_contract_catches_seeded_shape_regression(tmp_path, live_snapshot):
    doc = json.loads(contract.CONTRACT_PATH.read_text())
    probe = doc["probes"]["simulate_fork_join_batch"]
    probe[".hist"] = "float32[3,2,256]"
    probe[".sum_response"] = "float64[3]"
    seeded = tmp_path / "shape_contract.json"
    seeded.write_text(json.dumps(doc))
    findings = contract.check(seeded, live=live_snapshot[0])
    assert len(findings) == 2
    assert all(f.rule_id == "RPT301" for f in findings)
    messages = " ".join(f.message for f in findings)
    assert "float64[3]" in messages and "float32[3,2,256]" in messages


def test_contract_catches_removed_probe(tmp_path, live_snapshot):
    doc = json.loads(contract.CONTRACT_PATH.read_text())
    doc["probes"]["simulate_fork_join"][".p99"] = "float32[]"
    doc["probes"]["gone"] = {".x": "float32[]"}
    seeded = tmp_path / "shape_contract.json"
    seeded.write_text(json.dumps(doc))
    messages = [f.message for f in contract.check(seeded,
                                                  live=live_snapshot[0])]
    assert any("disappeared" in m for m in messages)
    assert any("no longer registered" in m for m in messages)


def test_contract_missing_file_is_a_finding(tmp_path):
    findings = contract.check(tmp_path / "nope.json", live={})
    assert findings and findings[0].rule_id == "RPT301"


# where the port's specs differ from the reference's (weak-type marks
# dropped), with why
CONTRACT_DIFFERENCES = {
    ("fit.calibrate", ".params.p"): (
        "int32[]", "py:int",
        "the port's fit keeps the server count a Python int (a shape); the "
        "reference's traced fit returns it as a weakly typed int32 array"),
}


def test_contract_equals_the_reference():
    ref = json.loads((ROOT / "src/repro/staticcheck/shape_contract.json")
                     .read_text())["probes"]
    port = contract.load()["probes"]
    assert set(ref) == set(port)
    diffs = {}
    for probe in ref:
        want = {k: v.rstrip("~") for k, v in ref[probe].items()}
        assert set(want) == set(port[probe]), probe
        for leaf in want:
            if want[leaf] != port[probe][leaf]:
                diffs[(probe, leaf)] = (want[leaf], port[probe][leaf])
    assert diffs == {k: v[:2] for k, v in CONTRACT_DIFFERENCES.items()}


# --------------------------------------------------------------------------
# the tree
# --------------------------------------------------------------------------

def test_tree_is_clean(tree_findings):
    findings = tree_findings
    active = [f for f in findings if not f.suppressed]
    assert not active, (
        "findings (fix them, or suppress a deliberate exception with "
        "`# staticcheck-torch: disable=<RULE> (reason)`):\n"
        + "\n".join(f.render() for f in active))
    # every deliberate exception carries a reason
    for f in findings:
        line = (ROOT / f.path).read_text().splitlines()[f.line - 1]
        assert re.search(rf"staticcheck-torch: disable=[A-Z0-9, ]*"
                         rf"{f.rule_id}[A-Z0-9, ]* \(.+\)", line), line
