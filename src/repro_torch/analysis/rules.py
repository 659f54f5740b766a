"""Lint rules R1, R5 and R7: the rules of ``repro/analysis/rules.py`` that
have a torch meaning.

Each rule is a generator ``rule(info: ModuleInfo) -> Iterator[(rule_id,
lineno, message)]``.

- **R1, draws from global RNG state.**  JAX's R1 flags host RNG and the
  wall clock inside traced code, where they freeze into the compiled
  program.  The port traces nothing, but its own rule is the same
  discipline: every draw comes from an explicit ``torch.Generator`` (or a
  numpy ``Generator``), never from a global stream whose state another
  caller moves.  So R1 flags ``torch.rand`` / ``randn`` / ``randint`` /
  ``randperm`` / ``multinomial`` / ``normal`` / ``bernoulli`` (and the
  in-place ``Tensor`` draws) without ``generator=``, numpy's legacy
  ``np.random.*`` (all but ``default_rng``, ``Generator`` and the bit
  generators), and the stdlib ``random`` module.
- **R5, id gathers with no id check in scope.**  JAX clamps an
  out-of-range gather index; on CUDA the port's index is a device-side
  assert that kills the context.  A gather by an ``ids``-like name needs a
  ``check_*ids*`` call (``analysis/hostcheck.check_adapter_ids``) in its
  function.
- **R7, shadowed numpy / torch imports.**  A function-local import of
  numpy or torch when the module imports it at the top gives the file two
  bindings for one library; so does a function-local ``from ... import``
  that rebinds a module-level name, or an assignment to a module-level
  numpy / torch alias.

No torch analogue, so not carried:
- **R2** (``jax.jit`` built per step): the port compiles nothing; its
  engines are eager Python loops.
- **R3** (hashable pytree aux): the port's trees are nested dicts, with no
  treedef and no aux.
- **R4** (host coercion without a tracer guard): the port has no tracers;
  a numpy coercion of a CUDA tensor raises at once.
- **R6** (Pallas tiling and VMEM): the port's kernels check their launch
  limits in their wrappers (``kernels/*.py``) at every call.
"""
from __future__ import annotations

import ast
import re
from typing import Iterator

from repro_torch.analysis.astutil import ModuleInfo, call_name

Emit = Iterator[tuple[str, int, str]]

# ---------------------------------------------------------------------------
# R1: draws from global RNG state
# ---------------------------------------------------------------------------

_R1_TORCH = {"rand", "randn", "randint", "randperm", "multinomial",
             "normal", "bernoulli", "poisson", "rand_like", "randn_like",
             "randint_like"}
_R1_INPLACE = {"normal_", "uniform_", "bernoulli_", "random_",
               "exponential_", "geometric_", "cauchy_", "log_normal_"}
_R1_NUMPY_OK = {"default_rng", "Generator", "SeedSequence", "BitGenerator",
                "PCG64", "PCG64DXSM", "Philox", "SFC64", "MT19937"}


def _has_generator(node: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in node.keywords) or any(
        kw.arg is None for kw in node.keywords)        # **kwargs may hold it


def rule_r1_global_rng(info: ModuleInfo) -> Emit:
    """No draw from a global RNG stream: thread an explicit
    ``torch.Generator`` (``generator=``) or a numpy ``Generator``."""
    for node in ast.walk(info.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        bad = None
        if name:
            full = info.resolve(name)
            parts = full.split(".")
            if (len(parts) == 2 and parts[0] == "torch"
                    and parts[1] in _R1_TORCH and not _has_generator(node)):
                bad = f"`{name}` without `generator=`"
            elif (len(parts) >= 3 and parts[:2] == ["numpy", "random"]
                  and parts[2] not in _R1_NUMPY_OK):
                bad = f"legacy `{name}` (numpy's global RandomState)"
            elif parts[0] == "random" and len(parts) >= 2 and (
                    info.module_alias_of(name.split(".")[0], "random")):
                bad = f"`{name}` (the stdlib random module's global state)"
        if bad is None and isinstance(node.func, ast.Attribute) and \
                node.func.attr in _R1_INPLACE and not _has_generator(node):
            bad = f"in-place draw `.{node.func.attr}(...)` without `generator=`"
        if bad:
            yield ("R1", node.lineno,
                   f"{bad} draws from global RNG state, which any other "
                   "caller moves; pass an explicit torch.Generator "
                   "(or use a numpy Generator)")


# ---------------------------------------------------------------------------
# R5: id gathers need an id check in scope
# ---------------------------------------------------------------------------

_ID_NAME = re.compile(r"^(adapter_)?ids?(_arr)?$|^tenant_ids?$|^gather_ids$")
_GATHERS = ("index_select", "gather", "take", "take_along_dim", "embedding")


def _id_gathers(info: ModuleInfo) -> Iterator[tuple[ast.AST, str]]:
    for node in ast.walk(info.tree):
        if isinstance(node, ast.Subscript):
            idx = node.slice
            if isinstance(idx, ast.Name) and _ID_NAME.match(idx.id):
                yield node, f"subscript gather on `{idx.id}`"
        elif isinstance(node, ast.Call):
            name = call_name(node) or ""
            if name.split(".")[-1] in _GATHERS:
                for arg in list(node.args) + [kw.value for kw in
                                              node.keywords]:
                    if isinstance(arg, ast.Name) and _ID_NAME.match(arg.id):
                        yield node, f"`{name}` gather on `{arg.id}`"
                        break


def rule_r5_unchecked_gather(info: ModuleInfo) -> Emit:
    """Gathers by id arrays sit behind a host-boundary id check."""
    for node, what in _id_gathers(info):
        fn = info.enclosing_function(node)
        while isinstance(fn, ast.Lambda):
            fn = info.enclosing_function(fn)
        scope = ast.walk(fn) if fn is not None else ast.walk(info.tree)
        checked = any(
            isinstance(sub, ast.Call)
            and "check" in (call_name(sub) or "").split(".")[-1]
            and "ids" in (call_name(sub) or "").split(".")[-1]
            for sub in scope)
        if not checked:
            yield ("R5", node.lineno,
                   f"{what} with no id check in scope: an out-of-range id "
                   "is a device-side assert on CUDA (it kills the "
                   "context) and an IndexError deep in a layer on the CPU; "
                   "check the ids at the host boundary "
                   "(check_adapter_ids)")


# ---------------------------------------------------------------------------
# R7: shadowed / function-local numpy + torch imports
# ---------------------------------------------------------------------------

_R7_MODULES = ("numpy", "torch")


def rule_r7_shadowed_import(info: ModuleInfo) -> Emit:
    """No second binding of numpy / torch inside a function: a local
    ``import numpy as _np`` where the module imports numpy, or any local
    import or assignment that rebinds a module-level numpy / torch name.
    A local ``import torch.distributed as dist`` (a submodule under a
    name of its own) binds nothing the module has, and passes."""
    roots = {t.split(".")[0] for t in info.imports.values()}
    for node in ast.walk(info.tree):
        if info.enclosing_function(node) is None:
            continue
        if isinstance(node, ast.Import):
            for alias in node.names:
                root = alias.name.split(".")[0]
                bound = alias.asname or root
                if root in _R7_MODULES and (
                        bound in info.imports
                        or (alias.name == root and root in roots)):
                    yield ("R7", node.lineno,
                           f"function-local `import {alias.name}` gives the "
                           f"module a second binding of {alias.name}; use "
                           "the top-level import")
        elif isinstance(node, ast.ImportFrom):
            root = (node.module or "").split(".")[0]
            if root not in _R7_MODULES:
                continue
            for alias in node.names:
                bound = alias.asname or alias.name
                if bound in info.imports:
                    yield ("R7", node.lineno,
                           f"function-local `from {node.module} import "
                           f"{alias.name}` shadows the module-level "
                           f"`{bound}`; use the top-level name")
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name) and target.id in info.imports:
                    mod = info.imports[target.id].split(".")[0]
                    if mod in _R7_MODULES:
                        yield ("R7", node.lineno,
                               f"`{target.id}` rebinds the module-level "
                               f"{info.imports[target.id]} import inside a "
                               "function; pick another local name")


RULES = [rule_r1_global_rng, rule_r5_unchecked_gather,
         rule_r7_shadowed_import]
