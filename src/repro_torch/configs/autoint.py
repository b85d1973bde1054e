"""autoint [arXiv:1810.11921]."""
from repro_torch.configs.base import ArchSpec, RecsysConfig, RECSYS_SHAPES
from repro_torch.configs.recsys_common import CRITEO_39, SMOKE_FIELDS_6

FULL = RecsysConfig(
    name="autoint", interaction="self-attn", n_sparse=39, embed_dim=16,
    field_vocabs=CRITEO_39, n_attn_layers=3, n_heads=2, d_attn=32)

SMOKE = RecsysConfig(
    name="autoint-smoke", interaction="self-attn", n_sparse=6, embed_dim=8,
    field_vocabs=SMOKE_FIELDS_6, n_attn_layers=2, n_heads=2, d_attn=8,
    dtype="float32")

SPEC = ArchSpec(
    arch_id="autoint", family="recsys", config=FULL, smoke_config=SMOKE,
    shapes=RECSYS_SHAPES, source="arXiv:1810.11921",
    notes="3 self-attn layers, 2 heads, d_attn=32")
