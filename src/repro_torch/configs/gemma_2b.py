"""gemma-2b [dense] — [arXiv:2403.08295].
18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000; GeGLU, head_dim=256.
``sliding_window=True`` gives the Gemma-2-family variant (window=4096)."""
from repro_torch.configs.base import ModelConfig


def config(*, sliding_window: bool = False) -> ModelConfig:
    return ModelConfig(
        name="gemma-2b", family="dense", num_layers=18, d_model=2048,
        num_heads=8, num_kv_heads=1, head_dim=256, d_ff=16384,
        vocab_size=256000, mlp_variant="geglu", tie_embeddings=True,
        attn_window=4096 if sliding_window else None,
        citation="arXiv:2403.08295")
