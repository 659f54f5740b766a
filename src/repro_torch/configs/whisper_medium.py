"""whisper-medium [audio] — [arXiv:2212.04356].
24L (enc) + 24L (dec) d_model=1024 16H d_ff=4096 vocab=51865; enc-dec with
conv/mel frontend STUBBED: the encoder takes 1500 precomputed frame
embeddings (the conv2 output length for 30s audio)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="audio", num_layers=24, d_model=1024,
        num_heads=16, num_kv_heads=16, head_dim=64, d_ff=4096,
        vocab_size=51865, norm="layernorm", mlp_variant="gelu",
        block_pattern=("xattn",), encoder_layers=24, encoder_frames=1500,
        encoder_d_model=1024, tie_embeddings=True,
        lora_targets=("q", "v"), citation="arXiv:2212.04356")
