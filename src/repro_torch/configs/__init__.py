"""Architecture registry: ``get_config("<id>")`` / ``--arch <id>``.

Lists only the architectures the port can run.  The JAX package's other
architectures raise :class:`NotImplementedError` until their slice lands."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (FederatedConfig, LoRAConfig,
                                      ModelConfig, MoEConfig, OptimizerConfig)

ARCHS = {
    "gemma-2b": "gemma_2b",
}

# the JAX package's other architectures (repro/configs/__init__.py)
NOT_YET_PORTED = (
    "mistral-nemo-12b", "paligemma-3b", "recurrentgemma-9b",
    "whisper-medium", "xlstm-1.3b", "qwen3-8b", "qwen2-moe-a2.7b",
    "granite-moe-1b-a400m", "stablelm-1.6b", "llama2-7b", "roberta-large",
)


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
