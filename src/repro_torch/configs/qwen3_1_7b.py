"""qwen3-1.7b [hf:Qwen/Qwen3-8B family].

As the reference has it: untied embeddings, where Qwen3-1.7B's published
config ties them (ROADMAP queue 3).
"""
from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES

FULL = LMConfig(
    name="qwen3-1.7b", n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=6144, vocab_size=151936, d_head=128, qk_norm=True)

SMOKE = LMConfig(
    name="qwen3-1.7b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512, d_head=16, qk_norm=True, dtype="float32",
    vocab_pad_multiple=64)

SPEC = ArchSpec(
    arch_id="qwen3-1.7b", family="lm", config=FULL, smoke_config=SMOKE,
    shapes=LM_SHAPES, source="hf:Qwen/Qwen3-8B",
    notes="dense, qk_norm, GQA kv=8")
