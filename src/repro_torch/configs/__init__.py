"""Architecture registry: ``get_config("<id>")`` / ``--arch <id>``.

Lists the JAX package's architectures, every one of which the port runs.
``NOT_YET_PORTED`` names the JAX package's architectures the port does not
run yet (none); ``get_config`` raises :class:`NotImplementedError` for
them."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (FederatedConfig, LoRAConfig,
                                      ModelConfig, MoEConfig, OptimizerConfig)

ARCHS = {
    "gemma-2b": "gemma_2b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "llama2-7b": "llama2_7b",
    "qwen3-8b": "qwen3_8b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "stablelm-1.6b": "stablelm_1_6b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "xlstm-1.3b": "xlstm_1_3b",
    "whisper-medium": "whisper_medium",
    "paligemma-3b": "paligemma_3b",
    "roberta-large": "roberta_large",
}

# the JAX package's other architectures (repro/configs/__init__.py)
NOT_YET_PORTED = ()


def get_config(arch: str, **kwargs) -> ModelConfig:
    if arch in NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch '{arch}' is not yet ported to repro_torch; ported: "
            f"{sorted(ARCHS)}")
    if arch not in ARCHS:
        raise ValueError(f"unknown arch '{arch}'; options: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.config(**kwargs)


__all__ = ["ARCHS", "NOT_YET_PORTED", "FederatedConfig", "LoRAConfig",
           "ModelConfig", "MoEConfig", "OptimizerConfig", "get_config"]
