"""mind [arXiv:1904.08030]."""
from repro_torch.configs.base import ArchSpec, RecsysConfig, RECSYS_SHAPES

FULL = RecsysConfig(
    name="mind", interaction="multi-interest", embed_dim=64, n_interests=4,
    capsule_iters=3, hist_len=50, item_vocab=1_000_000, field_vocabs=())

SMOKE = RecsysConfig(
    name="mind-smoke", interaction="multi-interest", embed_dim=16,
    n_interests=3, capsule_iters=3, hist_len=10, item_vocab=256,
    field_vocabs=(), dtype="float32")

SPEC = ArchSpec(
    arch_id="mind", family="recsys", config=FULL, smoke_config=SMOKE,
    shapes=RECSYS_SHAPES, source="arXiv:1904.08030",
    notes="4 interest capsules, 3 routing iters; retrieval over 1M items")
