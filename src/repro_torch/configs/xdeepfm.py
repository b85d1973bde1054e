"""xdeepfm [arXiv:1803.05170]."""
from repro_torch.configs.base import ArchSpec, RecsysConfig, RECSYS_SHAPES
from repro_torch.configs.recsys_common import CRITEO_39, SMOKE_FIELDS_6

FULL = RecsysConfig(
    name="xdeepfm", interaction="cin", n_sparse=39, embed_dim=10,
    field_vocabs=CRITEO_39, mlp=(400, 400), cin_layers=(200, 200, 200))

SMOKE = RecsysConfig(
    name="xdeepfm-smoke", interaction="cin", n_sparse=6, embed_dim=8,
    field_vocabs=SMOKE_FIELDS_6, mlp=(32,), cin_layers=(16, 16),
    dtype="float32")

SPEC = ArchSpec(
    arch_id="xdeepfm", family="recsys", config=FULL, smoke_config=SMOKE,
    shapes=RECSYS_SHAPES, source="arXiv:1803.05170",
    notes="CIN 200-200-200 + MLP 400-400")
