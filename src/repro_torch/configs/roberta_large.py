"""roberta-large [encoder] — the paper's GLUE model [arXiv:1907.11692].
24L d_model=1024 16H d_ff=4096 vocab=50265; encoder-only (bidirectional
forward, MLM loss).  Serving decodes it as a causal decoder, as the JAX
package's serve CLI does."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="roberta-large", family="encoder", num_layers=24, d_model=1024,
        num_heads=16, num_kv_heads=16, head_dim=64, d_ff=4096,
        vocab_size=50265, norm="layernorm", mlp_variant="gelu",
        tie_embeddings=True, citation="arXiv:1907.11692 (paper's GLUE model)")
