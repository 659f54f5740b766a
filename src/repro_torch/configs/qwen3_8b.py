"""qwen3-8b [dense] — [hf:Qwen/Qwen3-8B].
36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936; qk_norm."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b", family="dense", num_layers=36, d_model=4096,
        num_heads=32, num_kv_heads=8, head_dim=128, d_ff=12288,
        vocab_size=151936, qk_norm=True, rope_theta=1_000_000.0,
        tie_embeddings=False, citation="hf:Qwen/Qwen3-8B")
