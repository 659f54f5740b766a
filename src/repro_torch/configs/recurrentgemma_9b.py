"""recurrentgemma-9b [hybrid] — [arXiv:2402.19427] (Griffin).
38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000; RG-LRU + local
attention in a 1:2 pattern (2 recurrent blocks : 1 local-attn block),
local window 2048."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid", num_layers=38,
        d_model=4096, num_heads=16, num_kv_heads=1, head_dim=256,
        d_ff=12288, vocab_size=256000, mlp_variant="geglu",
        block_pattern=("rglru", "rglru", "attn"), attn_window=2048,
        rglru_d_state=4096, tie_embeddings=True,
        lora_targets=("q", "v", "wx", "wy"),
        citation="arXiv:2402.19427")
