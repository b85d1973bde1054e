"""The port's `roofline/` against the reference's.

* `report.kernel_roofline` renders the port's `profile_kernels` records
  on `H100_SXM`, identically from records and from their dicts (mirrors
  `tests/test_obs.py::test_profile_kernels_and_roofline_table`), and
  equals the reference's table on the same records and machine;
* `load_records`, `roofline_table` and `dryrun_summary` on two
  hand-written records equal the reference's;
* the rule-based collective estimate gives the hand-computed bytes on a
  small LM prefill and a small recommender's training step;
* ``examples/torch_plan_llm_serving.py`` plans from the records.
"""

import importlib.util
import json
import os

import pytest

from repro.core import planner as j_planner
from repro.roofline import report as j_report
from repro_torch.configs.base import (ArchSpec, LMConfig, RecsysConfig,
                                      ShapeSpec)
from repro_torch.core.planner import H100_SXM
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import stand_ins
from repro_torch.obs import profile as obs_profile
from repro_torch.roofline import analysis, report

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh():
    return make_mesh((2, 4), ("data", "model"), devices=["meta"] * 8)


def test_profile_kernels_and_roofline_table():
    recs = obs_profile.profile_kernels(rows=8, cols=256, n_runs=0,
                                       device="cpu")
    names = {r.name for r in recs}
    assert names == {"maxplus_scan", "maxplus_segment_scan"}
    table = report.kernel_roofline(recs)
    for name in names:
        assert name in table
    assert "memory" in table or "compute" in table
    assert f"ridge {H100_SXM.peak_flops / H100_SXM.hbm_bandwidth:.0f}" \
        in table
    assert report.kernel_roofline([r.to_json() for r in recs]) == table
    hw = j_planner.HardwareSpec(**{
        f: getattr(H100_SXM, f) for f in ("name", "peak_flops",
                                          "hbm_bandwidth", "ici_bandwidth",
                                          "vmem_bytes", "hbm_bytes")})
    assert j_report.kernel_roofline([r.to_json() for r in recs], hw) == table


def _record(arch, shape, mesh, compute, memory, coll, args_b, temp_b):
    terms = {"compute": compute, "memory": memory, "collective": coll}
    return {"arch": arch, "shape": shape, "mesh": mesh, "n_chips": 256,
            "flops_global": 1e15, "bytes_global": 1e12,
            "collective_bytes_global": 1e10, "compute_s": compute,
            "memory_s": memory, "collective_s": coll,
            "bound": max(terms, key=terms.get), "model_flops": 8e14,
            "useful_flops_ratio": 0.8,
            "memory_analysis": {"argument_bytes": args_b,
                                "output_bytes": 0.0, "temp_bytes": temp_b,
                                "peak_bytes": args_b + temp_b},
            "collectives": {}, "counted": [], "estimated": []}


@pytest.fixture
def record_dir(tmp_path):
    recs = [_record("qwen3-8b", "decode_32k", "single", 1e-3, 4e-3, 2e-3,
                    3 * 2**30, 2**30),
            _record("xdeepfm", "serve_p99", "single", 1e-6, 2e-6, 0.0,
                    2**30, 0.0)]
    for r in recs:
        with open(tmp_path / f"{r['arch']}__{r['shape']}__single.json",
                  "w") as f:
            json.dump(r, f)
    return tmp_path


def test_tables_from_records_equal_reference(record_dir):
    recs = report.load_records(str(record_dir))
    assert recs == j_report.load_records(str(record_dir))
    assert set(recs) == {("qwen3-8b", "decode_32k", "single"),
                         ("xdeepfm", "serve_p99", "single")}
    summary = report.dryrun_summary(recs)
    assert summary == j_report.dryrun_summary(recs)
    assert "qwen3-8b x decode_32k: 4.0 GB" in summary
    table = report.roofline_table(recs)
    assert table.count("\n") == 3 and "| memory |" in table
    assert table.replace("tensor-core", "MXU") == \
        j_report.roofline_table(recs)


def test_plan_llm_serving_example(record_dir, capsys):
    path = os.path.join(_ROOT, "examples", "torch_plan_llm_serving.py")
    spec = importlib.util.spec_from_file_location("plan_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--dryrun-dir", str(record_dir), "--device",
                     "cpu"]) == 0
    out = capsys.readouterr().out
    assert "qwen3-8b" in out and "xdeepfm" in out
    assert "2 serving cells planned" in out


def test_lm_collective_estimate_by_hand():
    # tp = 16 divides 16 heads and d_ff 32: heads and the FFN on "model"
    cfg = LMConfig(name="t", n_layers=2, d_model=64, n_heads=16,
                   n_kv_heads=2, d_ff=32, vocab_size=512, d_head=4,
                   vocab_pad_multiple=64)
    shape = ShapeSpec("prefill", "prefill", dict(seq_len=128,
                                                 global_batch=8))
    arch = ArchSpec("t", "lm", cfg, cfg, (shape,))
    build = specs.build_cell(arch, shape, _mesh(), False)
    got = analysis.estimate_collectives(arch, shape, build.rules, _mesh(),
                                        stand_ins(build.args[0]))
    # act = 4 sequences a device x 128 x 64 x 2 B = 65,536 B; per layer an
    # all-reduce for the heads and one for the FFN over 4 devices
    # (2 x 3/4 x act each); the embedding's all-gather (3/4 x act)
    assert got.bytes_by_kind == {"all-reduce": 4 * 98_304.0,
                                 "all-gather": 49_152.0}
    assert got.count_by_kind == {"all-reduce": 4, "all-gather": 1}


def test_recsys_collective_estimate_by_hand():
    cfg = RecsysConfig(name="t", interaction="fm", n_sparse=2, embed_dim=4,
                       field_vocabs=(10, 20), mlp=(8,))
    shape = ShapeSpec("train_batch", "recsys_train", dict(batch=64))
    arch = ArchSpec("t", "recsys", cfg, cfg, (shape,))
    build = specs.build_cell(arch, shape, _mesh(), False)
    got = analysis.estimate_collectives(arch, shape, build.rules, _mesh(),
                                        stand_ins(build.args[0]))
    # rows padded to 2,048 and split 4 ways: table (512, 4) and wide
    # (512, 1) in bfloat16, 4,096 + 1,024 B; the MLP (8, 8), (8,), (8, 1),
    # (1,) replicated, 128 + 16 + 16 + 2 B.  Gradients all-reduced over
    # the 2 data shards: 2 x 1/2 x 5,282 B over 6 tensors.  The pooled
    # embeddings, 32 samples x 2 fields x (4 + 1) x 2 B = 640 B,
    # all-reduced over 4 row shards: 2 x 3/4 x 640 B.
    assert got.bytes_by_kind == {"all-reduce": 5_282.0 + 960.0}
    assert got.count_by_kind == {"all-reduce": 7}
    rec = analysis.roofline_from_trace(
        arch="t", shape="train_batch", mesh_name="2x4", n_chips=8,
        flops_global=8e9, bytes_global=4e9, collectives=got,
        memory_analysis={}, model_flops=4e9)
    assert rec.collective_bytes_global == 8 * 6_242.0
    assert rec.terms.collective_s == 6_242.0 / H100_SXM.ici_bandwidth
    assert rec.useful_flops_ratio == 0.5
    assert rec.to_json()["collectives"] == {"all-reduce_bytes": 6_242.0,
                                            "all-reduce_count": 7.0}
