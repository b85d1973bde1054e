"""command-r-plus-104b [hf:CohereForAI/c4ai-command-r-v01; unverified]."""
from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES

FULL = LMConfig(
    name="command-r-plus-104b", n_layers=64, d_model=12288, n_heads=96,
    n_kv_heads=8, d_ff=33792, vocab_size=256000, d_head=128)

SMOKE = LMConfig(
    name="command-r-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=160, vocab_size=512, d_head=8, dtype="float32", vocab_pad_multiple=64)

SPEC = ArchSpec(
    arch_id="command-r-plus-104b", family="lm", config=FULL,
    smoke_config=SMOKE, shapes=LM_SHAPES,
    source="hf:CohereForAI/c4ai-command-r-v01",
    notes="dense 104B, GQA kv=8, no bias")
