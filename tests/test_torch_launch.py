"""The port's `launch/` dry-run surface against the reference's.

* `configs.registry.all_cells`, both `lm_rules`, `gnn_rules`,
  `recsys_rules` and `spec` equal the reference's on every cell;
* `gnn_cell_dims`, `gnn_model_flops`, `recsys_model_flops` and 6 N D
  (`LMConfig.n_active_params`) equal the reference's exactly;
* on the reference's reduced LM cell and (2, 4) mesh
  (`tests/test_sharding.py::test_dryrun_single_cell_small_devices`),
  every argument's shard shape equals the reference's
  ``NamedSharding.shard_shape``, leaf for leaf (one child Python with 8
  virtual JAX devices), and `dryrun.run_cell` gives a record with the
  reference's keys, finite terms and a bound;
* on four full-size cells of the (16, 16) production mesh (xDeepFM
  train_batch, MIND retrieval_cand, DimeNet ogb_products, Qwen3-8B
  decode_32k; one child with 256 virtual JAX devices, the reference's
  cells built by ``jax.eval_shape``), every parameter and moment's shape
  and shard shape by path, every other argument's, and the summed
  per-device argument bytes equal the reference's;
* `make_production_mesh` on repeated ``meta`` devices, and the
  ``_segment`` operator, bit-equal to its body on real tensors and
  traceable under ``FakeTensorMode``;
* the four kernels the dry run traces, as custom operators: their fakes'
  shapes and their FLOP formulas under ``impl="cuda"`` on fake tensors,
  nothing launched, and a raise on real CPU tensors; the byte tally
  counting no metadata query and a gather's rows, not its table.
"""

import json
import math
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.configs import registry as j_registry
from repro.launch import sharding as j_sharding
from repro.launch import specs as j_specs
from repro_torch import _segment
from repro_torch.configs import registry as t_registry
from repro_torch.configs.base import ArchSpec, LMConfig, ShapeSpec
from repro_torch.interop import _ref_place
from repro_torch.launch import dryrun, sharding, specs
from repro_torch.launch.mesh import make_mesh, make_production_mesh

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REF_KEYS = ("arch", "shape", "mesh", "n_chips", "flops_global",
            "bytes_global", "collective_bytes_global", "compute_s",
            "memory_s", "collective_s", "bound", "model_flops",
            "useful_flops_ratio", "memory_analysis", "collectives",
            "lower_s", "compile_s", "notes")


def _cells(family=None):
    for a, s in t_registry.all_cells():
        t_spec, j_spec = t_registry.get_arch(a), j_registry.get_arch(a)
        if family is None or t_spec.family == family:
            t_shape = next(x for x in t_spec.shapes if x.name == s)
            j_shape = next(x for x in j_spec.shapes if x.name == s)
            yield t_spec, j_spec, t_shape, j_shape


def test_all_cells_equal_reference():
    assert t_registry.all_cells() == j_registry.all_cells()
    assert len(t_registry.all_cells()) == 40


@pytest.mark.parametrize("multi_pod", [False, True])
def test_rule_tables_equal_reference(multi_pod):
    n = 0
    for t_spec, j_spec, t_shape, j_shape in _cells():
        if t_spec.family == "lm":
            assert specs.lm_rules(t_spec.config, t_shape, multi_pod) == \
                j_specs.lm_rules(j_spec.config, j_shape, multi_pod)
            n += 1
    assert n == 20
    for seq in (False, True):
        assert sharding.lm_rules(multi_pod, seq_sharded_decode=seq) == \
            j_sharding.lm_rules(multi_pod, seq_sharded_decode=seq)
    for rep in (False, True):
        assert sharding.gnn_rules(multi_pod, replicate_nodes=rep) == \
            j_sharding.gnn_rules(multi_pod, replicate_nodes=rep)
    assert sharding.recsys_rules(multi_pod) == \
        j_sharding.recsys_rules(multi_pod)


def test_model_flops_equal_reference():
    for t_spec, j_spec, t_shape, j_shape in _cells("gnn"):
        dims = specs.gnn_cell_dims(t_shape)
        assert dims == j_specs.gnn_cell_dims(j_shape)
        for train in (True, False):
            assert specs.gnn_model_flops(t_spec.config, dims, train) == \
                j_specs.gnn_model_flops(j_spec.config, dims, train)
    for t_spec, j_spec, t_shape, _ in _cells("recsys"):
        b = (specs.RETRIEVAL_CAND_PADDED
             if t_shape.name == "retrieval_cand" else t_shape["batch"])
        for train in (True, False):
            assert specs.recsys_model_flops(t_spec.config, b, train) == \
                j_specs.recsys_model_flops(j_spec.config, b, train)
    assert specs.RETRIEVAL_CAND_PADDED == j_specs.RETRIEVAL_CAND_PADDED
    for t_spec, j_spec, t_shape, _ in _cells("lm"):
        tokens = t_shape["global_batch"] * t_shape["seq_len"]
        assert 6.0 * t_spec.config.n_active_params * tokens == \
            6.0 * j_spec.config.n_active_params * tokens


def test_spec_equals_reference():
    names = ("batch", "seq", None, "heads", "kv_seq", "unknown")
    assert sharding.spec(*names) == (None,) * len(names)
    for rules in (j_sharding.lm_rules(False), j_sharding.lm_rules(True),
                  j_sharding.recsys_rules(True),
                  j_sharding.gnn_rules(False)):
        with sharding.sharding_rules(rules), \
                j_sharding.sharding_rules(rules):
            assert sharding.spec(*names) == tuple(j_sharding.spec(*names))
            assert sharding.current_rules() is rules
    assert sharding.current_rules() is None
    x = torch.ones(2, 3)
    assert sharding.constrain(x, "batch", "embed") is x
    with sharding.sharding_rules(j_sharding.lm_rules(False)):
        assert sharding.constrain(x, "batch", "embed") is x
        with pytest.raises(ValueError, match="rank 2"):
            sharding.constrain(x, "batch", "seq", "embed")


def test_production_mesh_and_shard_shape():
    mesh = make_production_mesh(devices=["meta"] * 256)
    assert mesh.shape == (16, 16) and mesh.axis_names == ("data", "model")
    multi = make_production_mesh(multi_pod=True, devices=["meta"] * 512)
    assert multi.shape == (2, 16, 16)
    assert multi.axis_names == ("pod", "data", "model")
    with pytest.raises(ValueError, match="512"):
        make_production_mesh(multi_pod=True, devices=["meta"] * 256)
    assert sharding.shard_shape((100, 7, 33), (("pod", "data"), None,
                                               "model"), multi) == \
        (4, 7, 3)
    with pytest.raises(ValueError, match="pod"):
        sharding.shard_shape((4,), ("pod",), mesh)


# the reference's reduced LM cell (tests/test_sharding.py:124)
_SMALL = dict(n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128,
              vocab_size=512, d_head=8, vocab_pad_multiple=64)

_CHILD = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from repro import compat
    from repro.configs.base import ArchSpec, LMConfig, ShapeSpec
    from repro.launch import specs as SP

    cfg = LMConfig(name="t", **json.loads(os.environ["SMALL_CFG"]))
    spec = ArchSpec(arch_id="t", family="lm", config=cfg, smoke_config=cfg,
                    shapes=(ShapeSpec("train", "train",
                            dict(seq_len=128, global_batch=8)),))
    mesh = compat.make_mesh((2, 4), ("data", "model"))
    build = SP.build_lm_cell(spec, spec.shapes[0], mesh, False)
    params, opt, tokens, labels = build.args
    out = {}

    def put(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                           for p in path)
            out[prefix + key] = [list(leaf.shape),
                                 list(leaf.sharding.shard_shape(leaf.shape))]
    put("params/", params)
    put("m/", opt.m)
    put("v/", opt.v)
    for name, leaf in (("step", opt.step), ("tokens", tokens),
                       ("labels", labels)):
        put(name, leaf)
    print("LEAVES", json.dumps(out))
""")


def _small_spec():
    cfg = LMConfig(name="t", **_SMALL)
    return ArchSpec(arch_id="t", family="lm", config=cfg, smoke_config=cfg,
                    shapes=(ShapeSpec("train", "train",
                                      dict(seq_len=128, global_batch=8)),))


def _small_mesh():
    return make_mesh((2, 4), ("data", "model"), devices=["meta"] * 8)


def test_dryrun_small_cell_shard_shapes_equal_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               SMALL_CFG=json.dumps(_SMALL))
    r = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    ref = json.loads(next(line for line in r.stdout.splitlines()
                          if line.startswith("LEAVES"))[len("LEAVES "):])

    spec = _small_spec()
    build = specs.build_lm_cell(spec, spec.shapes[0], _small_mesh(), False)
    model, state, batch = build.args
    opt = state["opt"]
    seen = set()

    def check(key, t, layer, transpose):
        shape, shard = ref[key]
        if layer is not None:
            assert shard[0] == shape[0] == spec.config.n_layers, key
            shape, shard = shape[1:], shard[1:]
        if transpose:
            shape, shard = shape[::-1], shard[::-1]
        assert tuple(t.shape) == tuple(shape), key
        assert tuple(t.shard_shape) == tuple(shard), key
        seen.add(key)

    n_sharded = 0
    for name, p in model.named_parameters():
        path, layer, transpose = _ref_place(name)
        key = "/".join(path)
        check("params/" + key, p, layer, transpose)
        check("m/" + key, opt.m[name], layer, transpose)
        check("v/" + key, opt.v[name], layer, transpose)
        n_sharded += p.shard_shape != tuple(p.shape)
    check("step", opt.step, None, False)
    check("tokens", batch["tokens"], None, False)
    check("labels", batch["labels"], None, False)
    assert seen == set(ref)
    assert n_sharded > 0


# full-size cells of each family on the (16, 16) production mesh
# (tests/test_sharding.py builds none at this size; the reference builds
# them with jax.eval_shape, no compile)
_FULL = (("xdeepfm", "train_batch"), ("mind", "retrieval_cand"),
         ("dimenet", "ogb_products"), ("qwen3-8b", "decode_32k"))

_FULL_CHILD = textwrap.dedent("""
    import os, json, math
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
    import jax
    from repro.configs.registry import get_arch
    from repro.launch import specs as SP
    from repro.launch.mesh import make_production_mesh

    mesh = make_production_mesh()
    cells = {}
    for arch, name in json.loads(os.environ["FULL_CELLS"]):
        spec = get_arch(arch)
        shape = next(s for s in spec.shapes if s.name == name)
        build = SP.build_cell(spec, shape, mesh, False)
        leaves = jax.tree_util.tree_flatten_with_path(build.args)[0]
        out, rest, nbytes = {}, [], 0
        for path, leaf in leaves:
            if not hasattr(leaf, "sharding"):
                continue
            shard = leaf.sharding.shard_shape(leaf.shape)
            item = leaf.dtype.itemsize
            nbytes += math.prod(shard) * item
            keys = [str(getattr(p, "key", getattr(p, "idx",
                                                  getattr(p, "name", p))))
                    for p in path]
            entry = [list(leaf.shape), list(shard), item]
            # args[0] the parameters; a training step's args[1] AdamW's
            # (step, m, v)
            if keys[0] == "0":
                out["params/" + "/".join(keys[1:])] = entry
            elif keys[0] == "1" and keys[1:2] in (["m"], ["v"]):
                out[keys[1] + "/" + "/".join(keys[2:])] = entry
            else:
                rest.append(entry)
        cells[arch + "/" + name] = dict(named=out, rest=sorted(rest),
                                        bytes=nbytes)
    print("CELLS", json.dumps(cells))
""")


def _port_leaves(spec, build) -> tuple[dict, list, float]:
    """The port's stand-ins keyed as the child keys the reference's:
    parameters and moments by the reference's paths (an LM's by
    `interop`'s map, layer 0's tensor standing for the stacked one),
    every other leaf in a sorted list of (shape, shard shape, element
    size); and the per-device argument bytes."""
    from repro_torch.train.optimizer import named_tensors
    params, *rest = build.args
    opt = rest[0]["opt"] if isinstance(rest[0], dict) and "opt" in rest[0] \
        else None
    out, seen = {}, set()

    def entry(t, layer, transpose):
        shape, shard = list(t.shape), list(t.shard_shape)
        if transpose:
            shape, shard = shape[::-1], shard[::-1]
        if layer is not None:
            n = spec.config.n_layers
            shape, shard = [n] + shape, [n] + shard
        return [shape, shard, t.element_size()]

    for name, t in named_tensors(params).items():
        layer, transpose, key = None, False, name
        if isinstance(params, torch.nn.Module):
            path, layer, transpose = _ref_place(name)
            key = "/".join(path)
        group = [("params", t)] + ([("m", opt.m[name]), ("v", opt.v[name])]
                                   if opt is not None else [])
        for which, x in group:
            seen.add(id(x))
            if not layer:
                out[f"{which}/{key}"] = entry(x, layer, transpose)
    others = sorted([list(t.shape), list(t.shard_shape), t.element_size()]
                    for t in specs.stand_ins(build.args) if id(t) not in seen)
    return out, others, specs.argument_bytes(build.args)


def test_full_cells_shard_shapes_equal_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               FULL_CELLS=json.dumps(_FULL))
    r = subprocess.run([sys.executable, "-c", _FULL_CHILD], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    ref = json.loads(next(line for line in r.stdout.splitlines()
                          if line.startswith("CELLS"))[len("CELLS "):])
    mesh = make_production_mesh(devices=["meta"] * 256)
    for arch, name in _FULL:
        spec = t_registry.get_arch(arch)
        shape = next(x for x in spec.shapes if x.name == name)
        build = specs.build_cell(spec, shape, mesh, False)
        named, rest, nbytes = _port_leaves(spec, build)
        want = ref[f"{arch}/{name}"]
        assert named == want["named"], arch
        rest_want = want["rest"]
        if spec.family == "lm" and shape.kind == "decode":
            # the reference's cache length is an int32 scalar argument,
            # the port's a Python int
            rest_want = [e for e in rest_want if e != [[], [], 4]]
            assert len(rest_want) == len(want["rest"]) - 1
            nbytes += 4
        assert rest == rest_want, arch
        assert nbytes == want["bytes"], arch


def test_run_cell_small_cell_record():
    rec = dryrun.run_cell("t", "train", False, verbose=False,
                          mesh=_small_mesh(), spec=_small_spec())
    for key in REF_KEYS + ("counted", "estimated"):
        assert key in rec, key
    assert rec["mesh"] == "2x4" and rec["n_chips"] == 8
    assert rec["bound"] in ("compute", "memory", "collective")
    for key in ("flops_global", "bytes_global", "collective_bytes_global",
                "compute_s", "memory_s", "collective_s"):
        assert math.isfinite(rec[key]) and rec[key] > 0, key
    mem = rec["memory_analysis"]
    build = specs.build_lm_cell(_small_spec(), _small_spec().shapes[0],
                                _small_mesh(), False)
    assert mem["argument_bytes"] == specs.argument_bytes(build.args)
    assert mem["temp_bytes"] > 0 and mem["output_bytes"] > 0
    assert set(rec["counted"]) == {"flops_global", "argument_bytes",
                                   "output_bytes"}
    assert set(rec["estimated"]) == {"bytes_global", "temp_bytes",
                                     "collective_bytes_global"}
    # 6 N D against the trace: attention and rematerialisation on top
    assert 1.0 < 1.0 / rec["useful_flops_ratio"] < 3.0


@pytest.mark.parametrize("name", ["flash", "decode", "bag", "cin"])
def test_kernel_operators_fake_and_flop_formulas(name):
    """The dry run's kernels as custom operators: under ``FakeTensorMode``
    ``impl="cuda"`` gives the output's shape and dtype and counts the
    kernel's FLOPs by formula, launching nothing; on real CPU tensors it
    raises (no fallback)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.cin_fuse import ops as cin_ops
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    bf = torch.bfloat16

    def make():
        if name == "flash":       # causal pairs: 100 * 101 / 2 a head
            q = torch.empty(2, 100, 4, 64, dtype=bf)
            k = torch.empty(2, 100, 2, 64, dtype=bf)
            return (flash_ops, lambda impl: flash_ops.flash_attention(
                q, k, k, impl=impl), (2, 100, 4, 64),
                4 * 2 * 4 * 64 * 5050)
        if name == "decode":      # positions 0..99 of 300
            q = torch.empty(2, 1, 4, 64, dtype=bf)
            k = torch.empty(2, 300, 2, 64, dtype=bf)
            return (decode_ops, lambda impl: decode_ops.decode_attention(
                q, k, k, 99, impl=impl), (2, 1, 4, 64), 4 * 2 * 4 * 64 * 100)
        if name == "bag":         # gathers and sums: no FLOP formula
            table = torch.empty(50, 16, dtype=bf)
            ids = torch.zeros(8, 3, 4, dtype=torch.int32)
            mask = torch.ones(8, 3, 4, dtype=torch.bool)
            return (bag_ops, lambda impl: bag_ops.embedding_bag(
                table, ids, mask, impl=impl), (8, 3, 16), 0)
        xk = torch.empty(8, 3, 16, dtype=bf)
        x0 = torch.empty(8, 5, 16, dtype=bf)
        w = torch.empty(15, 7, dtype=bf)
        return (cin_ops, lambda impl: cin_ops.cin_layer(xk, x0, w,
                                                        impl=impl),
                (8, 7, 16), 2 * 8 * 16 * 3 * 5 * 7)

    ops, _, _, _ = make()
    ops.reset_counts()
    with FakeTensorMode():
        _, call, shape, flops = make()
        with FlopCounterMode(display=False) as counter:
            out = call("cuda")
    assert tuple(out.shape) == shape and out.dtype == bf
    assert counter.get_total_flops() == flops
    assert ops.launch_count() == 0 and ops.plain_count() == 0
    _, call, _, _ = make()
    with pytest.raises(ValueError, match="CUDA"):
        call("cuda")


def test_byte_tally_skips_metadata_and_counts_gathered_rows():
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode()
    with mode:
        table = torch.empty(1000, 8)
        ids = torch.zeros(5, dtype=torch.int64)
    tally = dryrun._Bytes()
    with mode, tally:
        _ = table.device, table.shape[0]
        rows = table[ids]
    # the index reads the 5 rows it gathers and the ids, and writes them
    assert tally.moved == 5 * 8 * 4 + 5 * 8 + 5 * 8 * 4
    assert rows.shape == (5, 8)


def test_segment_operator_bit_equal_and_traceable():
    from torch._subclasses.fake_tensor import FakeTensorMode
    body = _segment._run_sums._init_fn
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        g = torch.Generator().manual_seed(7)
        data = torch.randn(3000, 5, generator=g).to(dtype)
        ids = torch.randint(-2, 70, (3000,), generator=g)
        got = _segment._run_sums(data, ids, 64)
        want = body(data, ids, 64)
        assert got.dtype == want.dtype and torch.equal(got, want)
    with FakeTensorMode():
        table = torch.empty(40, 6, requires_grad=True)
        ids = torch.zeros(500, dtype=torch.int64)
        out = _segment.segment_sum(_segment.gather_rows(table, ids), ids,
                                   40)
        out.sum().backward()
        assert out.shape == (40, 6) and table.grad.shape == (40, 6)
