"""qwen3-8b [hf:Qwen/Qwen3-8B]."""
from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES

FULL = LMConfig(
    name="qwen3-8b", n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab_size=151936, d_head=128, qk_norm=True)

SMOKE = LMConfig(
    name="qwen3-8b-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=192, vocab_size=512, d_head=16, qk_norm=True, dtype="float32",
    vocab_pad_multiple=64)

SPEC = ArchSpec(
    arch_id="qwen3-8b", family="lm", config=FULL, smoke_config=SMOKE,
    shapes=LM_SHAPES, source="hf:Qwen/Qwen3-8B",
    notes="dense, qk_norm, GQA kv=8")
