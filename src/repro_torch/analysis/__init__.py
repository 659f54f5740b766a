"""Static analysis and runtime guards for the port.

The port of ``repro/analysis``:

* ``repro_torch.analysis.lint``: an AST lint pass with the rules of JAX's
  that have a torch meaning (R1 global RNG draws, R5 unchecked id gathers,
  R7 shadowed numpy / torch imports; ``rules.py`` says why R2-R4 and R6
  have none).  Run it as ``python -m repro_torch.analysis lint``.
* ``repro_torch.analysis.sanitizers`` / ``stability_check`` /
  ``hostcheck``: runtime guards (:class:`RecompileGuard`,
  ``no_implicit_transfers`` / ``guard_transfers`` over
  ``torch.cuda.set_sync_debug_mode``), the collapse sentinel, and the
  host-boundary id check.

Attribute access is lazy, as in JAX, so the linter imports neither torch
nor numpy.
"""
from __future__ import annotations

_EXPORTS = {
    "Finding": "repro_torch.analysis.lint",
    "lint_paths": "repro_torch.analysis.lint",
    "check_adapter_ids": "repro_torch.analysis.hostcheck",
    "RecompileError": "repro_torch.analysis.sanitizers",
    "RecompileGuard": "repro_torch.analysis.sanitizers",
    "TransferGuardError": "repro_torch.analysis.sanitizers",
    "guard_transfers": "repro_torch.analysis.sanitizers",
    "no_implicit_transfers": "repro_torch.analysis.sanitizers",
    "ScalingCollapseError": "repro_torch.analysis.stability_check",
    "StabilityReport": "repro_torch.analysis.stability_check",
    "assert_stabilized": "repro_torch.analysis.stability_check",
    "predicted_scale": "repro_torch.analysis.stability_check",
    "scaling_flatness": "repro_torch.analysis.stability_check",
    "stability_report": "repro_torch.analysis.stability_check",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'repro_torch.analysis' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)
