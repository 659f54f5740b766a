"""stablelm-1.6b [dense] — [hf:stabilityai/stablelm-2-1_6b].
24L d_model=2048 32H (kv=32) d_ff=5632 vocab=100352; LayerNorm."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b", family="dense", num_layers=24, d_model=2048,
        num_heads=32, num_kv_heads=32, head_dim=64, d_ff=5632,
        vocab_size=100352, norm="layernorm", tie_embeddings=False,
        citation="hf:stabilityai/stablelm-2-1_6b")
