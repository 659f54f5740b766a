"""Shared AST plumbing for the lint rules.

The port of ``repro/analysis/astutil.py``'s walker: pure stdlib ``ast``, so
the linter runs with neither torch nor numpy installed and never imports
the modules it checks.  JAX's traced-context marking and constant folding
serve its jit / scan and Pallas rules, which have no torch analogue
(``rules.py``), and are not carried.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field


def dotted_name(node: ast.AST) -> str | None:
    """``torch.cuda.synchronize`` for an Attribute / Name chain, else
    None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> str | None:
    """The dotted name a call targets (``functools.partial(f, ...)``
    reports ``f``)."""
    name = dotted_name(node.func)
    if name is not None:
        return name
    if isinstance(node.func, ast.Call):
        inner = dotted_name(node.func.func)
        if inner in ("functools.partial", "partial") and node.func.args:
            return dotted_name(node.func.args[0])
    return None


FuncNode = ast.FunctionDef | ast.AsyncFunctionDef | ast.Lambda


@dataclass
class ModuleInfo:
    """One parsed module plus the facts every rule needs."""

    path: str
    source: str
    tree: ast.Module
    parents: dict[ast.AST, ast.AST] = field(default_factory=dict)
    # alias -> full name, for module-level imports ("np" -> "numpy",
    # "DTensor" -> "torch.distributed.tensor.DTensor")
    imports: dict[str, str] = field(default_factory=dict)

    @classmethod
    def parse(cls, path: str, source: str) -> "ModuleInfo":
        tree = ast.parse(source, filename=path)
        info = cls(path=path, source=source, tree=tree)
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                info.parents[child] = parent
        for node in tree.body:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    info.imports[alias.asname or alias.name.split(".")[0]] = (
                        alias.name)
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    info.imports[alias.asname or alias.name] = (
                        f"{node.module}.{alias.name}")
        return info

    def enclosing_function(self, node: ast.AST) -> FuncNode | None:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return cur
            cur = self.parents.get(cur)
        return None

    def resolve(self, name: str) -> str:
        """A dotted name with its first part replaced by what the module
        imported under it (``np.random.rand`` -> ``numpy.random.rand``)."""
        head, _, rest = name.partition(".")
        target = self.imports.get(head, head)
        return f"{target}.{rest}" if rest else target

    def module_alias_of(self, name: str, module: str) -> bool:
        """True if a module-level import binds ``name`` to ``module`` (or
        a submodule, or a name imported from it)."""
        target = self.imports.get(name)
        return target is not None and (
            target == module or target.startswith(module + "."))
