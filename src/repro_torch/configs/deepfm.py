"""deepfm [arXiv:1703.04247]."""
from repro_torch.configs.base import ArchSpec, RecsysConfig, RECSYS_SHAPES
from repro_torch.configs.recsys_common import CRITEO_39, SMOKE_FIELDS_6

FULL = RecsysConfig(
    name="deepfm", interaction="fm", n_sparse=39, embed_dim=10,
    field_vocabs=CRITEO_39, mlp=(400, 400, 400))

SMOKE = RecsysConfig(
    name="deepfm-smoke", interaction="fm", n_sparse=6, embed_dim=8,
    field_vocabs=SMOKE_FIELDS_6, mlp=(32, 32), dtype="float32")

SPEC = ArchSpec(
    arch_id="deepfm", family="recsys", config=FULL, smoke_config=SMOKE,
    shapes=RECSYS_SHAPES, source="arXiv:1703.04247",
    notes="FM + deep MLP 400-400-400")
