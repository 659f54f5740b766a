"""granite-moe-1b-a400m [moe] — [hf:ibm-granite/granite-3.0-1b-a400m-base].
24L d_model=1024 16H (GQA kv=8) d_ff_expert=512, 32 experts top-8,
vocab=49155."""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe", num_layers=24,
        d_model=1024, num_heads=16, num_kv_heads=8, head_dim=64, d_ff=512,
        vocab_size=49155, tie_embeddings=True,
        moe=MoEConfig(num_experts=32, top_k=8, num_shared_experts=0,
                      d_ff_expert=512, d_ff_shared=0),
        citation="hf:ibm-granite/granite-3.0-1b-a400m-base")
