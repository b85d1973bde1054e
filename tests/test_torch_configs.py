"""The port's LM and GNN configs and registry held against
`repro.configs` (the recsys configs: tests/test_torch_recsys.py and
test_torch_mind.py).  The port lists all ten of the reference's ids."""

import dataclasses

import pytest

from repro.configs import base as j_base
from repro.configs import registry as j_registry
from repro_torch.configs import base as t_base
from repro_torch.configs import registry as t_registry

PORTED = ("qwen3-1.7b", "qwen3-8b", "command-r-plus-104b",
          "qwen3-moe-30b-a3b", "granite-moe-3b-a800m")
RECSYS_PORTED = ("deepfm", "xdeepfm", "autoint", "mind")
GNN_PORTED = ("dimenet",)


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("which", ["config", "smoke_config"])
def test_config_fields_and_derived_sizes_equal(arch, which):
    port = getattr(t_registry.get_arch(arch), which)
    ref = getattr(j_registry.get_arch(arch), which)
    fields = dataclasses.asdict(port)
    # every field the port has is the reference's (attn_chunk, training's
    # attention, among them); the reference adds only the knobs of how
    # JAX traces its loops
    assert fields == {k: v for k, v in dataclasses.asdict(ref).items()
                      if k in fields}
    assert set(dataclasses.asdict(ref)) - set(fields) == {
        "scan_layers", "scan_unroll", "unroll_attn"}
    for prop in ("vocab_padded", "n_params", "n_active_params"):
        assert getattr(port, prop) == getattr(ref, prop), prop


@pytest.mark.parametrize("arch", GNN_PORTED)
@pytest.mark.parametrize("which", ["config", "smoke_config"])
def test_gnn_config_fields_equal(arch, which):
    port = getattr(t_registry.get_arch(arch), which)
    ref = getattr(j_registry.get_arch(arch), which)
    assert type(port).__name__ == type(ref).__name__ == "GNNConfig"
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("arch", PORTED + GNN_PORTED)
def test_spec_fields_equal(arch):
    port, ref = t_registry.get_arch(arch), j_registry.get_arch(arch)
    for f in ("arch_id", "family", "source", "notes"):
        assert getattr(port, f) == getattr(ref, f)
    assert ([(s.name, s.kind, s.dims) for s in port.shapes]
            == [(s.name, s.kind, s.dims) for s in ref.shapes])


def test_qwen3_8b_sizes():
    cfg = t_registry.get_arch("qwen3-8b").config
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff) == (36, 4096, 32, 8, 128, 12288)
    assert cfg.vocab_padded == 153_600
    assert cfg.n_params == 8_190_722_048          # ~16.4 GB in bfloat16


@pytest.mark.parametrize("kw", [
    dict(tie_embeddings=True),
    dict(moe=("MoESpec", dict(n_experts=8, top_k=2, d_expert=96))),
    dict(vocab_pad_multiple=128, vocab_size=1000),
])
def test_properties_of_variants_equal(kw):
    def build(mod):
        extra = {k: (getattr(mod, v[0])(**v[1]) if isinstance(v, tuple)
                     else v) for k, v in kw.items()}
        return mod.LMConfig(**{"name": "v", "n_layers": 3, "d_model": 64,
                               "n_heads": 4, "n_kv_heads": 2, "d_ff": 192,
                               "vocab_size": 512, "d_head": 16, **extra})
    port, ref = build(t_base), build(j_base)
    for prop in ("vocab_padded", "n_params", "n_active_params"):
        assert getattr(port, prop) == getattr(ref, prop), prop


def test_moe_padding_equal():
    assert (dataclasses.asdict(t_base.MoESpec(30, 2, 8).padded(8))
            == dataclasses.asdict(j_base.MoESpec(30, 2, 8).padded(8)))


def test_registry_lists_only_what_the_port_runs():
    ported = PORTED + RECSYS_PORTED + GNN_PORTED
    assert t_registry.list_archs() == j_registry.list_archs()
    assert t_registry.list_archs() == sorted(ported)
    assert set(t_registry.list_archs()) <= set(j_registry.list_archs())
    for arch in sorted(set(j_registry.list_archs()) - set(ported)):
        with pytest.raises(KeyError, match="unknown arch"):
            t_registry.get_arch(arch)
    with pytest.raises(KeyError):
        t_registry.get_arch("nope")
