"""Render the §Roofline table and the §Dry-run summary from the JSON
records.

PyTorch port of `repro.roofline.report`.  Two consumers share this
module:

* the dry-run records (``<out>/<arch>__<shape>__<mesh>.json``, written by
  `repro_torch.launch.dryrun`): the §Roofline table over (arch, shape,
  mesh) cells and the summary of the largest per-device footprints;
* :func:`kernel_roofline`: `repro_torch.obs.profile.ProfileRecord`s (the
  port's (max, +) kernel stack) placed on a machine's roofline:
  compute_s = flops / peak_flops, memory_s = bytes / HBM bandwidth,
  bound = the slower engine.  The default machine is
  `repro_torch.core.planner.H100_SXM`.

    python -m repro_torch.roofline.report DRYRUN_DIR [DRYRUN_DIR ...]

prints the summary and the single-pod table of the records found.
"""

from __future__ import annotations

import glob
import json
import os

__all__ = ["load_records", "roofline_table", "kernel_roofline",
           "dryrun_summary"]


def load_records(*dirs) -> dict:
    """(arch, shape, mesh) -> record, over every ``*.json`` of ``dirs``."""
    recs = {}
    for d in dirs:
        for f in sorted(glob.glob(os.path.join(d, "*.json"))):
            with open(f) as fh:
                r = json.load(fh)
            recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def _peak_gb(r) -> float:
    return (r["memory_analysis"]["argument_bytes"]
            + r["memory_analysis"]["temp_bytes"]) / 2**30


def roofline_table(recs, mesh: str = "single") -> str:
    rows = [r for r in recs.values() if r["mesh"] == mesh]
    out = ["| arch | shape | compute_s | memory_s | collective_s | bound |"
           " MODEL/HLO | peak GB/dev | sentence |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | "
            f"{r['bound']} | {min(r['useful_flops_ratio'], 9.99):.2f} | "
            f"{_peak_gb(r):.1f} | {_advice(r)} |")
    return "\n".join(out)


def _advice(r) -> str:
    b = r["bound"]
    if b == "collective":
        return ("cut bytes on the join path (sharding/all-to-all) or "
                "overlap with compute")
    if b == "memory":
        return ("raise arithmetic intensity: fuse, cut remat re-reads, "
                "larger per-chip tiles")
    return "compute-bound: already near the tensor-core roofline; check MODEL/HLO"


def kernel_roofline(records, hw=None) -> str:
    """Place ProfileRecords on ``hw``'s roofline (default `H100_SXM`);
    return the table.

    ``records`` are `repro_torch.obs.profile.ProfileRecord`s or their
    ``to_json()`` dicts.  For each, compute_s = flops / peak_flops and
    memory_s = bytes_accessed / hbm_bandwidth; the larger term names the
    bound, and ``balance`` compares the record's arithmetic intensity to
    the machine's ridge point (flops/byte at which both engines tie).
    """
    from repro_torch.core.planner import H100_SXM, RooflineTerms
    from repro_torch.obs.profile import ProfileRecord

    hw = H100_SXM if hw is None else hw
    ridge = hw.peak_flops / hw.hbm_bandwidth
    out = [f"| kernel | compute_s | memory_s | bound | F/B "
           f"| ridge {ridge:.0f} | peak MiB |",
           "|---|---|---|---|---|---|---|"]
    for rec in records:
        r = (ProfileRecord.from_json(rec) if isinstance(rec, dict)
             else rec)
        terms = RooflineTerms(
            compute_s=r.flops / hw.peak_flops,
            memory_s=r.bytes_accessed / hw.hbm_bandwidth,
            collective_s=0.0)
        ai = r.arithmetic_intensity
        out.append(
            f"| {r.name} | {terms.compute_s:.3e} | {terms.memory_s:.3e} "
            f"| {terms.bound} | {ai:.2f} | {ai / ridge:.1%} of ridge "
            f"| {r.peak_bytes / 2**20:.1f} |")
    return "\n".join(out)


def dryrun_summary(recs) -> str:
    single = [r for r in recs.values() if r["mesh"] == "single"]
    multi = [r for r in recs.values() if r["mesh"] == "multi"]
    out = [f"single-pod cells compiled: {len(single)}/40",
           f"multi-pod cells compiled:  {len(multi)}/40"]
    worst = sorted(single, key=lambda r: -_peak_gb(r))[:5]
    out.append("largest per-device footprints (args+temp):")
    for r in worst:
        out.append(f"  {r['arch']} x {r['shape']}: {_peak_gb(r):.1f} GB")
    return "\n".join(out)


def main(argv: list) -> int:
    if not argv:
        raise SystemExit("usage: python -m repro_torch.roofline.report "
                         "DRYRUN_DIR [DRYRUN_DIR ...]")
    recs = load_records(*argv)
    if not recs:
        raise SystemExit(f"no dry-run records in {argv}")
    print(dryrun_summary(recs))
    print()
    print(roofline_table(recs))
    return 0


if __name__ == "__main__":
    import sys
    raise SystemExit(main(sys.argv[1:]))
