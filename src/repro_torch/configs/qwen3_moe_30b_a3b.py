"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES, MoESpec

FULL = LMConfig(
    name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32,
    n_kv_heads=4, d_ff=768, vocab_size=151936, d_head=128, qk_norm=True,
    moe=MoESpec(n_experts=128, top_k=8, d_expert=768).padded(16))

SMOKE = LMConfig(
    name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab_size=512, d_head=16, qk_norm=True, dtype="float32",
    vocab_pad_multiple=64,
    moe=MoESpec(n_experts=8, top_k=2, d_expert=96).padded(4))

SPEC = ArchSpec(
    arch_id="qwen3-moe-30b-a3b", family="lm", config=FULL, smoke_config=SMOKE,
    shapes=LM_SHAPES, source="hf:Qwen/Qwen3-30B-A3B",
    notes="128 experts top-8, GQA kv=4, qk_norm")
