"""Architecture registry: ``get_config("<id>")`` / ``--arch <id>``.

Lists the JAX package's architectures, every one of which the port runs.
``NOT_YET_PORTED`` names the JAX package's architectures the port does not
run yet (none); ``get_config`` raises :class:`NotImplementedError` for
them.

The dry-run's registry is the JAX package's: ``ASSIGNED`` (the ten
assigned architectures, in the JAX package's order), the ``long_500k``
policy ``LONG_CONTEXT_OK`` (a sub-quadratic requirement: native, the
family's sliding-window variant, or None = skipped), ``NO_DECODE``,
``config_for_shape`` and ``supports_shape``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, FederatedConfig,
                                      InputShape, LoRAConfig, ModelConfig,
                                      MoEConfig, OptimizerConfig)

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

# the ten assigned architectures, in the JAX registry's order (this dict's
# order differs)
ASSIGNED = ("mistral-nemo-12b", "paligemma-3b", "recurrentgemma-9b",
            "gemma-2b", "whisper-medium", "xlstm-1.3b", "qwen3-8b",
            "qwen2-moe-a2.7b", "granite-moe-1b-a400m", "stablelm-1.6b")

# long_500k policy: native sub-quadratic or the family's sliding-window
# variant; None = skipped (pure full attention / encoder-decoder)
LONG_CONTEXT_OK = {
    "mistral-nemo-12b": "sliding_window",
    "gemma-2b": "sliding_window",
    "recurrentgemma-9b": "native",
    "xlstm-1.3b": "native",
    "paligemma-3b": None,
    "whisper-medium": None,
    "qwen3-8b": None,
    "qwen2-moe-a2.7b": None,
    "granite-moe-1b-a400m": None,
    "stablelm-1.6b": None,
    "llama2-7b": None,
    "roberta-large": None,
}

# encoder-only archs have no decode step at all
NO_DECODE = ("roberta-large",)


def get_config(arch: str, **kwargs) -> ModelConfig:
    if arch in NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch '{arch}' is not yet ported to repro_torch; ported: "
            f"{sorted(ARCHS)}")
    if arch not in ARCHS:
        raise ValueError(f"unknown arch '{arch}'; options: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.config(**kwargs)


def config_for_shape(arch: str, shape_name: str) -> ModelConfig:
    """The config variant for an input shape: ``long_500k`` takes the
    sliding-window variant of the dense archs whose policy says so."""
    if (shape_name == "long_500k"
            and LONG_CONTEXT_OK.get(arch) == "sliding_window"):
        return get_config(arch, sliding_window=True)
    return get_config(arch)


def supports_shape(arch: str, shape_name: str) -> bool:
    shape = INPUT_SHAPES[shape_name]
    if shape.kind == "decode" and arch in NO_DECODE:
        return False
    if shape_name == "long_500k":
        return LONG_CONTEXT_OK.get(arch) is not None
    return True


__all__ = ["ARCHS", "ASSIGNED", "INPUT_SHAPES", "LONG_CONTEXT_OK",
           "NOT_YET_PORTED", "NO_DECODE", "FederatedConfig", "InputShape",
           "LoRAConfig", "ModelConfig", "MoEConfig", "OptimizerConfig",
           "config_for_shape", "get_config", "supports_shape"]
