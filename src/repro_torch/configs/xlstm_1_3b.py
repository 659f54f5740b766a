"""xlstm-1.3b [ssm] — [arXiv:2405.04517].
48L d_model=2048 4H d_ff=0 vocab=50304; alternating mLSTM (matrix memory,
chunkwise-parallel training form) and sLSTM (scalar memory, sequential scan)
blocks.  Constant-size state -> runs long_500k natively."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="ssm", num_layers=48, d_model=2048,
        num_heads=4, num_kv_heads=4, head_dim=512, d_ff=0,
        vocab_size=50304, block_pattern=("mlstm", "slstm"),
        tie_embeddings=True, lora_targets=("q", "v"),
        citation="arXiv:2405.04517")
