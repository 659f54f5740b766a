"""llama2-7b [dense] — the paper's own primary model [arXiv:2307.09288].
32L d_model=4096 32H (MHA kv=32) d_ff=11008 vocab=32000."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama2-7b", family="dense", num_layers=32, d_model=4096,
        num_heads=32, num_kv_heads=32, head_dim=128, d_ff=11008,
        vocab_size=32000, tie_embeddings=False,
        citation="arXiv:2307.09288 (paper's primary model)")
