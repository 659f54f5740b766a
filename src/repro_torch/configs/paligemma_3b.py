"""paligemma-3b [vlm] — [arXiv:2407.07726].
18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216; SigLIP + gemma.
Vision frontend is a stub: the batch carries 256 precomputed SigLIP patch
embeddings (``batch["patches"]``); this config is the gemma decoder that
consumes them."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b", family="vlm", num_layers=18, d_model=2048,
        num_heads=8, num_kv_heads=1, head_dim=256, d_ff=16384,
        vocab_size=257216, mlp_variant="geglu", tie_embeddings=True,
        num_patches=256, citation="arXiv:2407.07726")
