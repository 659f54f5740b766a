"""Runtime sanitizers: recompile detection and implicit-transfer guards.

The port of ``repro/analysis/sanitizers.py``, with its names.

:class:`RecompileGuard` keeps JAX's two modes and semantics:

* ``watch(name, fn)``: snapshot ``fn``'s executable-cache size now (use
  after warmup); :meth:`check` raises if any watched cache grew.
* ``wrap(name, fn)``: a proxy that records each call's signature (leaf
  shapes and dtypes, static values; :func:`repro_torch.tree.tree_flatten`
  gives the leaves and the treedef).  Cache growth on a signature seen
  before is a true recompile; growth on a new one is a first compile,
  unless one leaf signature keeps arriving with fresh treedefs
  (``max_treedef_variants``): the churn of a per-call object in the tree.

A cache is read through a ``_cache_size()`` probe.  The port's engines are
eager and compile nothing, so they have none: as in JAX, "callables
without a cache probe are watchable no-ops", and wrap mode only records
their signatures.  Anything that grows a cache later (a captured CUDA
graph per signature) is watched by giving it the probe.

``no_implicit_transfers`` / ``guard_transfers`` stand for JAX's
``transfer_guard("disallow")``.  On CUDA a region runs under
``torch.cuda.set_sync_debug_mode("error")``, which raises on an operation
that waits for the device (a device-to-host copy, ``.item()``,
``nonzero``, a copy from pageable host memory): each is a host stall on a
path the host drives.  That mode does not see an operand that was never
put on the device, so ``guard_transfers`` also rejects a numpy leaf, or a
tensor on another device, among a call's arguments; that check runs on
the CPU too.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from repro_torch.tree import tree_flatten


class RecompileError(RuntimeError):
    """A function compiled again for a signature it already served."""


class TransferGuardError(RuntimeError):
    """An implicit host<->device transfer fired inside a guarded region."""


def _cache_size(fn) -> int | None:
    """Executable-cache size of ``fn``, or None if it exposes no
    ``_cache_size()`` probe (plain callables are watchable no-ops)."""
    probe = getattr(fn, "_cache_size", None)
    if probe is None:
        return None
    try:
        return int(probe())
    except Exception:                                   # noqa: BLE001
        return None


def _describe_leaf(leaf) -> tuple:
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is not None and dtype is not None:
        return ("aval", tuple(shape), str(dtype))
    try:
        hash(leaf)
    except TypeError:
        return ("obj", type(leaf).__name__)
    return ("val", type(leaf).__name__, leaf)


def _signature(args, kwargs):
    """(aval_sig, full_sig): shapes, dtypes and static values, which
    should decide compilation; and the same with the treedef."""
    leaves, treedef = tree_flatten((args, kwargs))
    aval_sig = tuple(_describe_leaf(leaf) for leaf in leaves)
    return aval_sig, (aval_sig, treedef)


def _render_sig(aval_sig) -> str:
    parts = []
    for entry in aval_sig[:12]:
        if entry[0] == "aval":
            _, shape, dtype = entry
            parts.append(f"{dtype}[{','.join(map(str, shape))}]")
        else:
            parts.append(repr(entry[-1]))
    if len(aval_sig) > 12:
        parts.append(f"... +{len(aval_sig) - 12} more")
    return ", ".join(parts)


class _GuardedFn:
    """Callable proxy: attribute access passes through, so cache-size
    probes keep working on wrapped engines."""

    def __init__(self, guard: "RecompileGuard", name: str, fn,
                 cache_probe=None):
        self._guard = guard
        self._name = name
        self._fn = fn
        self._probe = cache_probe if cache_probe is not None else fn

    def __call__(self, *args, **kwargs):
        before = _cache_size(self._probe)
        out = self._fn(*args, **kwargs)
        after = _cache_size(self._probe)
        self._guard._record_call(self._name, args, kwargs, before, after)
        return out

    def __getattr__(self, item):
        return getattr(self._fn, item)

    def __repr__(self):
        return f"<RecompileGuard wrap of {self._name}: {self._fn!r}>"


class RecompileGuard:
    """Detect unexpected executable-cache growth.

    Watch mode, after warmup::

        guard = RecompileGuard()
        guard.watch("step", step)
        ...                               # the guarded section
        guard.check()                     # raises RecompileError on growth

    Wrap mode, per call::

        step = guard.wrap("decode_step", step)
        step(params, tokens)              # raises at the offending call

    As a context manager, ``__enter__`` snapshots every watched baseline
    and ``__exit__`` runs :meth:`check`."""

    def __init__(self, *, max_treedef_variants: int = 4):
        self._watched: dict[str, tuple[object, int | None]] = {}
        self._seen_full: dict[str, set] = {}
        self._aval_treedefs: dict[str, dict[tuple, set]] = {}
        self.max_treedef_variants = max_treedef_variants
        self.events: list[str] = []

    def watch(self, name: str, fn) -> None:
        """Snapshot ``fn``'s cache size now; later growth fails check().
        Callables without a cache probe are recorded as no-ops."""
        self._watched[name] = (fn, _cache_size(fn))

    def check(self) -> None:
        grew = []
        for name, (fn, baseline) in self._watched.items():
            current = _cache_size(fn)
            if baseline is not None and current is not None \
                    and current > baseline:
                grew.append(f"{name}: executable cache {baseline} -> "
                            f"{current}")
        if grew:
            raise RecompileError(
                "unexpected recompilation after warmup: " + "; ".join(grew)
                + ". Every shape / static combination must be warmed "
                "before the guarded section.")

    def wrap(self, name: str, fn, *, cache_probe=None) -> _GuardedFn:
        """A guarded proxy for ``fn``; ``cache_probe`` names the object
        whose cache to read when ``fn`` dispatches to an inner one."""
        return _GuardedFn(self, name, fn, cache_probe)

    def _record_call(self, name, args, kwargs, before, after) -> None:
        aval_sig, full_sig = _signature(args, kwargs)
        seen = self._seen_full.setdefault(name, set())
        treedefs = self._aval_treedefs.setdefault(name, {})
        grew = before is not None and after is not None and after > before
        if grew and full_sig in seen:
            raise RecompileError(
                f"RecompileGuard[{name}]: recompiled on a previously-served "
                f"signature (cache {before} -> {after}); offending avals: "
                f"{_render_sig(aval_sig)}.  Something unstable (a static "
                "argument's identity, the tree's structure) is defeating "
                "the cache.")
        variants = treedefs.setdefault(aval_sig, set())
        variants.add(full_sig)
        if grew and len(variants) > self.max_treedef_variants:
            raise RecompileError(
                f"RecompileGuard[{name}]: {len(variants)} distinct treedefs "
                f"for identical avals ({_render_sig(aval_sig)}), cache "
                f"{before} -> {after}.  A per-call object in the argument "
                "tree churns its structure and grows the cache without "
                "bound.")
        if grew:
            self.events.append(
                f"{name}: first compile for {_render_sig(aval_sig)}")
        seen.add(full_sig)

    def __enter__(self) -> "RecompileGuard":
        self._watched = {name: (fn, _cache_size(fn))
                         for name, (fn, _) in self._watched.items()}
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.check()


# ------------------------------------------------------------ transfer guard

@contextlib.contextmanager
def no_implicit_transfers():
    """A region in which an operation that waits for the device is an
    error (on CUDA: ``torch.cuda.set_sync_debug_mode("error")``; the
    previous mode comes back on exit, an exception's too).  On a host with
    no CUDA the region guards nothing by itself: :func:`guard_transfers`'
    operand check is what runs there."""
    if not torch.cuda.is_available():
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    except RuntimeError as exc:
        if "synchroniz" in str(exc).lower():
            raise TransferGuardError(
                f"a host<->device synchronization inside a guarded engine "
                f"region: {exc}.  Keep the host boundary's reads and "
                "uploads out of the region.") from exc
        raise
    finally:
        torch.cuda.set_sync_debug_mode(before)


def _check_operands(name, args, kwargs, device):
    """Raise TransferGuardError for a numpy leaf, or a tensor on another
    device than ``device`` (the first tensor's, when None), among the
    call's arguments."""
    leaves, _ = tree_flatten((args, kwargs))
    for leaf in leaves:
        if isinstance(leaf, np.ndarray):
            raise TransferGuardError(
                f"{name}: a numpy operand {leaf.dtype}{list(leaf.shape)} "
                "would be uploaded on every call; put it on the device "
                "once at the host boundary.")
        if isinstance(leaf, torch.Tensor):
            if device is None:
                device = leaf.device
            want = torch.device(device)
            if leaf.device.type != want.type or (
                    want.index is not None and leaf.device.index != want.index):
                raise TransferGuardError(
                    f"{name}: an operand on {leaf.device} in a call on "
                    f"{device}; move it once at the host boundary.")


def guard_transfers(fn, *, device=None):
    """Wrap an engine so every call checks its operands (no numpy leaf, no
    tensor off ``device``) and runs under :func:`no_implicit_transfers`."""
    name = getattr(fn, "__name__", type(fn).__name__)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        _check_operands(name, args, kwargs, device)
        with no_implicit_transfers():
            return fn(*args, **kwargs)

    wrapper.__transfer_guarded__ = True
    return wrapper
