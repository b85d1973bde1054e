"""Shape-contract harness: the entry points' outputs against a snapshot.

The reference pins its public API with ``jax.eval_shape``
(`repro.staticcheck.contract`): every entry point traced on abstract
inputs, its output pytree's dtypes, shapes and weak-type flags compared
with a committed ``shape_contract.json``.  Here the same probes, at the
reference's small sizes, run the port's entry points and record each
output leaf's ``dtype[shape]`` (``py:<type>`` for a host value) in this
package's ``shape_contract.json``.  A silent shape or dtype regression (a
float64 promotion, a dropped scenario axis, a field that vanished) then
fails as a one-line diff.

How a probe runs: under ``torch._subclasses.fake_tensor.FakeTensorMode``
where its path traces (shapes and dtypes propagate, no value is
computed), concretely otherwise, at the probe's small size.  Only
`sweep_analytical` traces: the simulator draws from seeded
``torch.Generator``s, which FakeTensorMode does not take
(``exponential_(generator=)`` has no fake implementation), and the
calibration fit, the planner and the simulated sweep read values on the
host (a data-dependent ``.item()`` under fake tensors raises).
`snapshot` records the mode of each (``modes`` in the JSON); on a CUDA
device every probe runs concretely, through the kernels, and must give
the CPU's specs.

When an API change is deliberate, regenerate the file with

    python -m repro_torch.staticcheck --update-contract

and review the JSON diff like any other change.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Callable, Optional

from repro_torch.staticcheck.analysis import Finding
from repro_torch.staticcheck.registry import register_datarule

__all__ = ["CONTRACT_PATH", "CONTRACT_REL", "FAKE_PROBES", "check", "load",
           "probes", "save", "snapshot", "tree_specs"]

CONTRACT_PATH = pathlib.Path(__file__).with_name("shape_contract.json")
CONTRACT_REL = "src/repro_torch/staticcheck/shape_contract.json"

register_datarule(
    "RPT301", "shape-contract", "contract",
    "entry-point output dtypes/shapes must match the committed "
    "shape_contract.json (regenerate with --update-contract when the "
    "change is intentional)")


def _spec(leaf: Any) -> str:
    """'float32[3,256]' for a tensor, 'py:int' for a host value."""
    dtype = getattr(leaf, "dtype", None)
    if dtype is None or not hasattr(leaf, "shape"):
        return f"py:{type(leaf).__name__}"
    shape = ",".join(str(int(d)) for d in leaf.shape)
    return f"{str(dtype).removeprefix('torch.')}[{shape}]"


def tree_specs(out: Any, path: str = "") -> dict[str, str]:
    """{leaf path: spec}, paths spelled as JAX's ``keystr`` spells them
    (``.field`` of a dataclass, ``['key']`` of a dict); None fields are
    empty subtrees, as they are in a JAX pytree."""
    if out is None:
        return {}
    if dataclasses.is_dataclass(out) and not isinstance(out, type):
        specs: dict[str, str] = {}
        for f in dataclasses.fields(out):
            specs.update(tree_specs(getattr(out, f.name),
                                    f"{path}.{f.name}"))
        return specs
    if isinstance(out, dict):
        specs = {}
        for k in sorted(out):
            specs.update(tree_specs(out[k], f"{path}[{k!r}]"))
        return specs
    if isinstance(out, (tuple, list)):
        specs = {}
        for i, v in enumerate(out):
            specs.update(tree_specs(v, f"{path}[{i}]"))
        return specs
    return {path: _spec(out)}


# --------------------------------------------------------------------------
# Probes (the reference's set, at its sizes)
# --------------------------------------------------------------------------

def probes(device: str = "cpu") -> dict[str, Callable[[], dict[str, str]]]:
    import torch

    from repro_torch.calibrate import fit, measure
    from repro_torch.core import capacity, simulator, sweep
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.queueing import ServerParams
    from repro_torch.launch.elastic import AutoscalePolicy
    from repro_torch.obs.timeline import TelemetrySpec

    params = ServerParams(p=4, s_broker=0.004, s_hit=0.0125, s_miss=0.05,
                          s_disk=0.04, hit=0.5)

    def sim(lam, **kw):
        return simulator.simulate_fork_join(0, lam, 256, params,
                                            chunk_size=128, device=device,
                                            **kw)

    def p_sim():
        return tree_specs(sim(50.0, tap_size=8))

    def p_sim_replicated():
        return tree_specs(sim(120.0, cluster=ClusterSpec(
            r=3, routing="jsq", result_cache=(0.3, 0.001))))

    def p_sim_telemetry():
        return tree_specs(sim(120.0, cluster=ClusterSpec(r=2),
                              telemetry=TelemetrySpec(n_bins=8,
                                                      slo_seconds=0.7)))

    def p_sim_autoscale():
        pol = AutoscalePolicy(min_r=1, max_r=3,
                              decision_interval_seconds=0.25)
        return tree_specs(sim(120.0, cluster=ClusterSpec(
            routing="jsq", autoscale=pol), telemetry=TelemetrySpec(
                n_bins=8)))

    def p_sim_fault():
        ft = FaultSpec(outages=((0, 1.0, 3.0),), mtbf_seconds=30.0,
                       degraded=((1, 2.0),), broker_timeout_seconds=0.4,
                       quorum_k=3, hedge_after_seconds=0.3)
        return tree_specs(sim(120.0, cluster=ClusterSpec(r=3, fault=ft),
                              telemetry=TelemetrySpec(n_bins=8)))

    def p_sim_batch():
        lam = torch.tensor([40.0, 60.0, 80.0], device=device)
        batch = ServerParams(**{
            f.name: (4 if f.name == "p" else torch.full(
                (3,), float(getattr(params, f.name)), device=device))
            for f in dataclasses.fields(ServerParams)})
        return tree_specs(simulator.simulate_fork_join_batch(
            0, lam, batch, 256, p=4, chunk_size=128, device=device))

    def grid():
        return sweep.SweepGrid.build(
            lam=[40.0, 60.0], p=[4.0], cpu=[1.0, 2.0], disk=[1.0],
            r=[1.0, 2.0], base=params, device=device)

    # a SweepResult / SimSweepResult carries its grid; the probes return
    # their array fields as a dict, as the reference's do
    def p_sweep_analytical():
        res = sweep.sweep_analytical(grid())
        return tree_specs({"response_lower": res.response_lower,
                           "response_upper": res.response_upper,
                           "utilization": res.utilization})

    def p_sweep_simulated():
        res = sweep.sweep_simulated(grid(), 0, n_queries=256,
                                    chunk_size=128, tap_size=4)
        return tree_specs({"stats": res.stats})

    def p_calibrate():
        n, p = 128, 4
        gen = torch.Generator(device=device)
        gen.manual_seed(301)

        def u(*shape):
            return torch.rand(shape, generator=gen, device=device)
        hit = (u(n, p) < 0.5).float()
        disk = (1.0 - hit) * 0.04 * (0.5 + u(n, p))
        busy = hit * 0.0125 * (0.5 + u(n, p)) + (1.0 - hit) * 0.05 * (
            0.5 + u(n, p)) + disk
        tr = measure.TraceRecord(
            arrival=torch.cumsum(0.05 + 0.1 * u(n), 0),
            response=0.1 + 0.1 * u(n), broker_busy=0.004 * (0.5 + u(n)),
            server_busy=busy, server_hit=hit, server_disk=disk)
        return tree_specs(fit.calibrate(tr, n_windows=4, n_iters=2))

    def p_plan_capacity():
        plan = capacity.plan_capacity(params, 200.0, 0.5, simulate=False,
                                      device=device)
        return {f".{f}": _spec(getattr(plan, f))
                for f in sorted(vars(plan))}

    return {
        "simulate_fork_join": p_sim,
        "simulate_fork_join[r=3,cache]": p_sim_replicated,
        "simulate_fork_join[telemetry]": p_sim_telemetry,
        "simulate_fork_join[autoscale]": p_sim_autoscale,
        "simulate_fork_join[fault]": p_sim_fault,
        "simulate_fork_join_batch": p_sim_batch,
        "sweep_analytical": p_sweep_analytical,
        "sweep_simulated": p_sweep_simulated,
        "fit.calibrate": p_calibrate,
        "plan_capacity": p_plan_capacity,
    }


# the probes whose paths trace under FakeTensorMode on the CPU (the rest
# read values on the host and run concretely); `snapshot` checks this
FAKE_PROBES: tuple[str, ...] = ("sweep_analytical",)


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def snapshot(device: str = "cpu", *, modes: Optional[dict] = None
             ) -> dict[str, dict[str, str]]:
    """Run every probe; {probe name: {leaf path: spec}}.  On the CPU the
    probes in `FAKE_PROBES` run under FakeTensorMode and the others
    concretely; on a CUDA device all run concretely.  ``modes``, if
    given, receives each probe's mode."""
    out = {}
    for name, probe in sorted(probes(device).items()):
        fake = device == "cpu" and name in FAKE_PROBES
        if fake:
            with _fake_mode():
                out[name] = probe()
        else:
            out[name] = probe()
        if modes is not None:
            modes[name] = "fake" if fake else "concrete"
    return out


def load(path: pathlib.Path = CONTRACT_PATH) -> dict:
    return json.loads(path.read_text())


def save(path: pathlib.Path = CONTRACT_PATH) -> None:
    modes: dict[str, str] = {}
    live = snapshot(modes=modes)
    path.write_text(json.dumps({"modes": modes, "probes": live}, indent=2,
                               sort_keys=True) + "\n")


def check(path: pathlib.Path = CONTRACT_PATH,
          live: Optional[dict] = None) -> list[Finding]:
    """Diff the live snapshot against the committed contract.

    ``live`` lets callers reuse one snapshot across several comparisons.
    """
    if not path.exists():
        return [Finding("RPT301", CONTRACT_REL, 1, 0,
                        "shape contract file missing; run `python -m "
                        "repro_torch.staticcheck --update-contract`")]
    committed = load(path).get("probes", {})
    live = snapshot() if live is None else live
    findings: list[Finding] = []

    def diff(probe: str, want: dict, got: dict) -> None:
        for leaf in sorted(set(want) | set(got)):
            w, g = want.get(leaf), got.get(leaf)
            if w == g:
                continue
            if w is None:
                msg = f"new output leaf `{probe}{leaf}` = {g}"
            elif g is None:
                msg = f"output leaf `{probe}{leaf}` ({w}) disappeared"
            else:
                msg = (f"`{probe}{leaf}` changed: contract says {w}, the "
                       f"probe gives {g}")
            findings.append(Finding(
                "RPT301", CONTRACT_REL, 1, 0,
                msg + "; if intentional, regenerate with --update-contract"))

    for probe in sorted(set(committed) | set(live)):
        if probe not in live:
            findings.append(Finding(
                "RPT301", CONTRACT_REL, 1, 0,
                f"probe `{probe}` is in the contract but no longer "
                "registered"))
        elif probe not in committed:
            findings.append(Finding(
                "RPT301", CONTRACT_REL, 1, 0,
                f"probe `{probe}` has no committed contract entry"))
        else:
            diff(probe, committed[probe], live[probe])
    return findings
