"""qwen2-moe-a2.7b [moe] — [hf:Qwen/Qwen1.5-MoE-A2.7B].
24L d_model=2048 16H (kv=16) d_ff_expert=1408, 60 routed experts top-4 +
4 shared experts (shared hidden 4*1408=5632), vocab=151936.
Experts padded 60->64 for 16-way expert parallelism (router masks the pads)."""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe", num_layers=24, d_model=2048,
        num_heads=16, num_kv_heads=16, head_dim=128, d_ff=1408,
        vocab_size=151936, tie_embeddings=False,
        moe=MoEConfig(num_experts=60, top_k=4, num_shared_experts=4,
                      d_ff_expert=1408, d_ff_shared=5632),
        citation="hf:Qwen/Qwen1.5-MoE-A2.7B")
