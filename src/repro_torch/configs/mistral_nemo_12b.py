"""mistral-nemo-12b [dense] — [hf:mistralai/Mistral-Nemo-Base-2407].
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, 128k ctx; the
heads' width (32 x 128 = 4096) is not d_model.
``sliding_window=True`` gives the Mistral-family variant (window=4096)."""
from repro_torch.configs.base import ModelConfig


def config(*, sliding_window: bool = False) -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b", family="dense", num_layers=40, d_model=5120,
        num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336,
        vocab_size=131072, rope_theta=1_000_000.0, tie_embeddings=False,
        mlp_variant="swiglu", attn_window=4096 if sliding_window else None,
        citation="hf:mistralai/Mistral-Nemo-Base-2407")
