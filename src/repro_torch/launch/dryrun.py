"""Dry run of the production meshes: trace every (architecture x input
shape) cell's step on stand-ins, and record its roofline terms.

PyTorch port of `repro.launch.dryrun`.  The reference lowers and
compiles each cell for 256 or 512 fake XLA devices and reads the
executable's cost and memory analysis.  Here each cell's arguments are
``meta`` stand-ins laid out on `mesh.make_production_mesh(devices=
["meta"] * n)` (`launch.specs`), and the step runs once on fake CPU
tensors (``FakeTensorMode``: shapes and dtypes, no values, no
allocation) under ``FlopCounterMode`` and a dispatch mode that tallies
bytes.  The trace is of the whole (global) step and does not depend on
the mesh, so each cell is traced once and its counts serve both meshes.
Nothing runs on a device: the dry run needs no card.

Each record carries the reference's keys (`roofline.analysis
.CellRoofline.to_json`, plus ``lower_s``, ``compile_s`` (the trace's
seconds) and ``notes``) and two more:

* ``counted`` — figures counted: ``flops_global`` (``FlopCounterMode``
  over the operators it has formulas for, forward and backward; the
  steps run with ``impl="cuda"``, the path the card runs, each
  hand-written kernel a custom operator with a fake and a FLOP formula:
  flash and decode attention and the CIN layer count their products,
  the embedding bag, like the plain gathers and sums it replaces, 0),
  and the per-device ``argument_bytes`` and ``output_bytes`` (the
  stand-ins' shard shapes);
* ``estimated`` — figures estimated: ``bytes_global`` (every non-view
  operator's input and output bytes, a kernel's as one operator; eager
  PyTorch runs each operator from memory to memory, so this is what the
  step moves if no cache holds an operand between operators),
  ``temp_bytes`` (the trace's high-water mark of bytes made by
  operators and not yet freed, less the outputs, divided by the devices
  that split the cell's activations: its batch, sequence, head, edge or
  candidate axes) and ``collective_bytes_global`` (the rules' estimate,
  `roofline.analysis.estimate_collectives`).

Per-device FLOPs are ``flops_global / n_chips``; ``notes`` names every
logical axis the rules leave unsharded, whose compute is replicated and
which that division hides.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun

A cell that fails is reported and counted, and the process exits 1.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Optional

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.registry import all_cells, get_arch
from repro_torch.launch.mesh import (DeviceMesh, make_mesh,
                                    make_production_mesh)
from repro_torch.launch.sharding import mesh_axis_size, shard_shape
from repro_torch.launch.specs import (CellBuild, argument_bytes, build_cell,
                                      gnn_cell_dims, stand_ins)
from repro_torch.roofline.analysis import (estimate_collectives,
                                           roofline_from_trace)

__all__ = ["Trace", "trace_cell", "cell_trace", "run_cell", "main"]

COUNTED = ("flops_global", "argument_bytes", "output_bytes")
ESTIMATED = ("bytes_global", "temp_bytes", "collective_bytes_global")

# the logical axes a family's activations are split over
_ACTIVATION_AXES = {"train": ("batch", "seq", "heads", "ffn"),
                    "prefill": ("batch", "seq", "heads", "ffn"),
                    "decode": ("batch", "kv_seq", "heads", "ffn"),
                    "graph": ("edges",),
                    "recsys_train": ("batch",),
                    "recsys_serve": ("batch",),
                    "recsys_retrieval": ("cand",)}


@dataclasses.dataclass(frozen=True)
class Trace:
    """One traced step, global (unsharded) figures.

    ``outputs`` lists the step's output tensors in leaf order: the index
    of the argument leaf an output is (an update in place), or None and
    its (shape, element size) for a new tensor."""

    flops: float
    bytes_accessed: float
    temp_bytes: float
    outputs: tuple
    seconds: float


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


# gathers read the rows they gather, not their whole table (the first
# argument): the gathered rows of a plain gather are its output; the
# embedding bag's are one row an id
_GATHERS = {
    torch.ops.aten.embedding.default: lambda args, out: _nbytes(out),
    torch.ops.aten.index.Tensor: lambda args, out: _nbytes(out),
    torch.ops.aten.index_select.default: lambda args, out: _nbytes(out),
    torch.ops.repro_torch.embedding_bag.default: lambda args, out: (
        args[1].numel() * args[0].shape[1] * args[0].element_size()),
}


class _Bytes(TorchDispatchMode):
    """Tallies, over the operators dispatched under it, the bytes each
    non-view operator that returns a tensor reads and writes (a gather
    the rows it gathers, `_GATHERS`), and the high-water mark of the
    storages operators made that are still alive (a storage is counted
    once, from the operator that made it, until its tensor is freed).
    An operator that returns no tensor (``x.device``, a size) moves
    nothing."""

    def __init__(self):
        super().__init__()
        self.moved = 0.0
        self.live = 0.0
        self.peak = 0.0

    def _free(self, n: float):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if func.is_view or not outs:
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        seen = {id(t) for t in ins}
        self.moved += sum(_nbytes(t) for t in ins)
        if func in _GATHERS:
            self.moved += _GATHERS[func](args, outs[0]) - _nbytes(args[0])
        for t in outs:
            self.moved += _nbytes(t)
            if id(t) in seen or t._base is not None:
                continue
            seen.add(id(t))
            n = float(t.untyped_storage().nbytes())
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, n)
        return out


def _fake_tree(tree: Any, mode, fake: dict) -> Any:
    """``tree`` with every stand-in replaced by a fake CPU tensor of
    ``mode`` of its shape, dtype and ``requires_grad`` (a module is copied
    and its parameters replaced); ``fake`` maps each stand-in's id to its
    fake."""
    def make(t: torch.Tensor) -> torch.Tensor:
        with mode:
            f = torch.empty(t.shape, dtype=t.dtype, device="cpu")
        if t.requires_grad:
            f.requires_grad_(True)
        fake[id(t)] = f
        return f

    if isinstance(tree, torch.Tensor):
        return make(tree)
    if isinstance(tree, nn.Module):
        params = list(tree.parameters())
        module = copy.deepcopy(tree)
        for orig, (mod, name) in zip(params, _param_slots(module)):
            p = nn.Parameter(make(orig),
                             requires_grad=mod._parameters[name].requires_grad)
            mod._parameters[name] = fake[id(orig)] = p
        return module
    if isinstance(tree, dict):
        return {k: _fake_tree(v, mode, fake) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_fake_tree(v, mode, fake) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fake_tree(v, mode, fake) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _fake_tree(getattr(tree, f.name), mode, fake)
            for f in dataclasses.fields(tree)})
    return tree


def _param_slots(module: nn.Module) -> list:
    """(owning module, name) of each parameter, in ``parameters()``
    order."""
    slots, seen = [], set()
    for mod in module.modules():
        for name, p in mod._parameters.items():
            if p is not None and id(p) not in seen:
                seen.add(id(p))
                slots.append((mod, name))
    return slots


def trace_cell(build: CellBuild) -> Trace:
    """Run ``build.fn`` once on fake tensors: FLOPs, bytes moved and the
    live-bytes high-water mark of the global step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.perf_counter()
    mode = FakeTensorMode()
    fake: dict = {}
    args = _fake_tree(build.args, mode, fake)
    index = {id(fake[id(t)]): i for i, t in enumerate(stand_ins(build.args))}
    counter = FlopCounterMode(display=False)
    tally = _Bytes()
    with mode, counter, tally:
        out = build.fn(*args)
    outputs, new_bytes = [], 0.0
    for t in stand_ins(out):
        if id(t) in index:
            outputs.append((index[id(t)], None))
        else:
            outputs.append((None, (tuple(t.shape), t.element_size())))
            new_bytes += t.numel() * t.element_size()
    temp = max(tally.peak - new_bytes, 0.0)
    return Trace(flops=float(counter.get_total_flops()),
                 bytes_accessed=tally.moved, temp_bytes=temp,
                 outputs=tuple(outputs),
                 seconds=time.perf_counter() - t0)


def cell_trace(arch_id: str, shape_name: str) -> Trace:
    """The trace of one cell's step, which serves every mesh: the cell
    built on a (1, 1) mesh of ``meta`` (the step does not depend on the
    layout)."""
    spec = get_arch(arch_id)
    shape = next(s for s in spec.shapes if s.name == shape_name)
    mesh = make_mesh((1, 1), ("data", "model"), devices=["meta"])
    return trace_cell(build_cell(spec, shape, mesh, False))


def _output_bytes(build: CellBuild, trace: Trace, mesh: DeviceMesh) -> float:
    """Per-device bytes of the step's outputs: an argument updated in
    place by its stand-in's shard shape, a new tensor by ``out_specs``."""
    leaves = list(stand_ins(build.args))
    new = [o for i, o in trace.outputs if i is None]
    if len(new) != len(build.out_specs):
        raise ValueError(f"the step made {len(new)} new outputs but the "
                         f"cell gives {len(build.out_specs)} out_specs")
    total = 0.0
    for i, _ in trace.outputs:
        if i is not None:
            total += math.prod(leaves[i].shard_shape) \
                * leaves[i].element_size()
    for (shape, item), spec in zip(new, build.out_specs):
        total += math.prod(shard_shape(shape, spec, mesh)) * item
    return float(total)


def _activation_shards(kind: str, rules: dict, mesh: DeviceMesh) -> int:
    axes = set()
    for name in _ACTIVATION_AXES[kind]:
        binding = rules.get(name)
        if binding is not None:
            axes.update((binding,) if isinstance(binding, str) else binding)
    return mesh_axis_size(mesh, tuple(sorted(axes))) if axes else 1


def _unsharded(rules: dict) -> str:
    names = sorted(k for k, v in rules.items() if v is None)
    return ("unsharded logical axes (compute replicated over the mesh, "
            "hidden by flops_global / n_chips): " + ", ".join(names))


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[str] = None, verbose: bool = True, *,
             mesh: Optional[DeviceMesh] = None,
             trace: Optional[Trace] = None,
             spec: Optional[ArchSpec] = None) -> dict:
    """The record of one cell on the production mesh (or on ``mesh``,
    named by its shape, e.g. "1x1"), from ``trace`` or a new trace of
    the cell; written to ``out_dir`` when given.  ``spec`` stands in for
    the registry's entry of ``arch_id`` (a reduced config)."""
    spec = get_arch(arch_id) if spec is None else spec
    shape = next(s for s in spec.shapes if s.name == shape_name)
    if mesh is None:
        n = 512 if multi_pod else 256
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    devices=["meta"] * n)
        mesh_name = "multi" if multi_pod else "single"
    else:
        mesh_name = "x".join(str(s) for s in mesh.shape)
    n_chips = mesh.size

    build = build_cell(spec, shape, mesh, multi_pod)
    if trace is None:
        trace = trace_cell(build)
    args_b = argument_bytes(build.args)
    out_b = _output_bytes(build, trace, mesh)
    temp_b = float(math.ceil(trace.temp_bytes / _activation_shards(
        shape.kind, build.rules, mesh)))
    params = list(stand_ins(build.args[0]))
    coll = estimate_collectives(
        spec, shape, build.rules, mesh, params,
        gnn_cell_dims(shape) if spec.family == "gnn" else None)
    cell = roofline_from_trace(
        arch=arch_id, shape=shape_name, mesh_name=mesh_name,
        n_chips=n_chips, flops_global=trace.flops,
        bytes_global=trace.bytes_accessed, collectives=coll,
        memory_analysis={"argument_bytes": args_b, "output_bytes": out_b,
                         "temp_bytes": temp_b,
                         "peak_bytes": args_b + out_b + temp_b},
        model_flops=build.model_flops, counted=COUNTED, estimated=ESTIMATED)
    rec = cell.to_json()
    rec["lower_s"] = 0.0
    rec["compile_s"] = trace.seconds
    rec["notes"] = "; ".join(x for x in (build.notes,
                                         _unsharded(build.rules)) if x)
    if verbose:
        print(f"[{arch_id} x {shape_name} x {mesh_name}] traced "
              f"{trace.seconds:.1f}s; memory/dev: args "
              f"{args_b / 2**30:.3f} GiB, out {out_b / 2**30:.3f} GiB, "
              f"temp {temp_b / 2**30:.3f} GiB (estimated)")
        print(f"  flops/dev={cell.flops_global / n_chips:.3e}"
              f" bytes/dev={cell.bytes_global / n_chips:.3e}"
              f" coll_bytes/dev={cell.collective_bytes_global / n_chips:.3e}")
        print(f"  terms: compute={cell.terms.compute_s:.4e}s "
              f"memory={cell.terms.memory_s:.4e}s "
              f"collective={cell.terms.collective_s:.4e}s "
              f"bound={cell.bound} useful={cell.useful_flops_ratio:.3f}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir, f"{arch_id}__{shape_name}__{mesh_name}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Dry-run (arch x shape) cells on the production meshes")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells whose JSON already exists")
    args = ap.parse_args(argv)

    if args.all:
        cells = all_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for arch_id, shape_name in cells:
        trace = None
        for multi_pod in meshes:
            mesh_name = "multi" if multi_pod else "single"
            path = os.path.join(
                args.out, f"{arch_id}__{shape_name}__{mesh_name}.json")
            if args.skip_done and os.path.exists(path):
                print(f"skip {arch_id} x {shape_name} x {mesh_name}")
                continue
            try:
                if trace is None:
                    trace = cell_trace(arch_id, shape_name)
                run_cell(arch_id, shape_name, multi_pod, out_dir=args.out,
                         trace=trace)
            except Exception as e:  # noqa: BLE001 — report and continue
                failures.append((arch_id, shape_name, mesh_name, repr(e)))
                print(f"FAILED {arch_id} x {shape_name} x {mesh_name}: {e}")
                traceback.print_exc()

    print(f"\n{'=' * 60}\ndry-run complete;"
          f" {len(failures)} failures" + (":" if failures else ""))
    for f in failures:
        print("  ", *f)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
