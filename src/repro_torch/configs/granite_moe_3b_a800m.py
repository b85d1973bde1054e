"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES, MoESpec

# 24 heads => d_head = 1536/24 = 64; the 40 experts are padded to 48
# (a multiple of 16), the padding masked out of the router.
FULL = LMConfig(
    name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
    n_kv_heads=8, d_ff=512, vocab_size=49155, d_head=64,
    moe=MoESpec(n_experts=40, top_k=8, d_expert=512).padded(16))

SMOKE = LMConfig(
    name="granite-moe-smoke", n_layers=2, d_model=48, n_heads=6, n_kv_heads=2,
    d_ff=64, vocab_size=512, d_head=8, dtype="float32", vocab_pad_multiple=64,
    moe=MoESpec(n_experts=5, top_k=2, d_expert=64).padded(2))

SPEC = ArchSpec(
    arch_id="granite-moe-3b-a800m", family="lm", config=FULL,
    smoke_config=SMOKE, shapes=LM_SHAPES,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    notes="40 experts (padded to 48) top-8, GQA kv=8")
