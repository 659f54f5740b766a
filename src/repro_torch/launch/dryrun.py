"""Multi-pod dry-run: trace every (arch x input-shape x mesh) combination of
the port's own train, prefill and decode steps at full width on the
production meshes, with no devices, and record per-device FLOPs, bytes,
collectives and memory for the roofline (``launch/hillclimb.py``).  The
port of ``repro/launch/dryrun.py``.

Usage (any host; it allocates nothing and needs no card):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
      --shape train_4k [--multi-pod] [--rank 64] \\
      [--out EXPERIMENTS/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all

How it traces.  A fake process group (``launch/mesh.start_fake_group``)
makes this process rank 0 of the 256- or 512-rank world, and the 16x16 /
2x16x16 DeviceMesh is built over it.  Every tensor is a ``meta`` tensor
(shapes and dtypes, no data), placed by the port's ``rules.*_sharding`` as
a DTensor whose local shard is a :class:`_Local`: a wrapper whose every op
is counted at the local shapes, after DTensor has chosen and issued its
redistributions.  A dispatch mode counts the ops on plain tensors (the
positions, the masks, the client stacks the trainer gathers).  The step
runs eagerly, layer by layer, as it would on a card, on the plain tier
(``"tier": "plain"``: a meta tensor has no data for a kernel, so
``kernels/dispatch`` takes the plain versions, as the JAX dry-run lowers
its reference tier).

What a record holds, per device (rank 0 stands for every device: the
rules shard a dim evenly or replicate it; where a dim does not divide its
axes it replicates, and every device does the whole of that work; the
production meshes give one client to each client slot, so every device
trains one client, over the whole client stacks the trainer keeps on
each):

  flops            the FLOPs of the device's local work: torch's
                   ``FlopCounterMode`` formulas (matmuls, convolutions,
                   attention) applied to each op's local operands
  bytes_accessed   the sum of local input and output bytes of every
                   dispatched aten op that is not a view: unfused, every
                   intermediate read and written once per op
  collective_bytes, collective_counts
                   JAX's five keys and its result-size convention: an
                   all-gather counts its gathered output, an all-reduce
                   its tensor, a reduce-scatter its scattered output;
                   DTensor's functional collectives and the direct
                   ``torch.distributed`` calls (``MeshRun.gather_clients``)
                   alike
  argument_size_in_bytes, output_size_in_bytes
                   the local shards of the step's arguments and results
                   (the decode step updates its cache in place, so the
                   cache counts in both)
  temp_size_in_bytes
                   the peak of live bytes over the trace less the
                   arguments, tracked by storage (a view adds nothing)
                   with weakref finalizers: what the caching allocator's
                   ``max_memory_allocated`` sees above the arguments
  trace_s          the trace's wall time, in place of JAX's lower / compile

No calibration pass: XLA's cost analysis counts a scanned loop's body
once, so the JAX dry-run compiles two unrolled variants to correct its
counts; the eager trace runs every layer, so its counts are whole.

The MoE layer's prefill and decode records count the whole batch's MoE
work on every device of the "pod" / "data" axes: capacity and
position-in-expert run over the whole batch, which each of those devices
gathers (``models/moe.moe_apply``), and the expert buffers shard their
expert dim over "model" only, as JAX constrains them
(``repro/models/moe.py``: ``ex_in`` and ``ex_out`` to ``("model", None,
None)``).  So the flat MoE terms do not shrink with the batch axes,
where a dense layer's do.  Under ``moe_grouped`` each device dispatches
only its own rows (``models/moe._grouped_on_rows``), as JAX shards the
groups over the batch axes, and those terms shrink with them.

Training records trace ``apply_stack``'s default remat: the backward
recomputes each repeat unit, so they count its FLOPs twice and keep
only the units' inputs alive between forward and backward.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (ASSIGNED, INPUT_SHAPES, LoRAConfig,
                                 OptimizerConfig, config_for_shape,
                                 supports_shape)
from repro_torch.core.federated import MeshRun, make_round_body
from repro_torch.core.lora import AdapterSet, init_lora
from repro_torch.launch.mesh import (mesh_from_spec, num_clients,
                                     parse_spec, start_fake_group)
from repro_torch.models.api import build_model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.sharding import rules
from repro_torch.sharding.opts import set_opts
from repro_torch.sharding.specs import replicating, use_mesh
from repro_torch.tree import tree_map

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# collective op name (c10d and functional) -> JAX's key; a broadcast or a
# point-to-point copy is what XLA lowers as a collective-permute
_COLL_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}

# metadata queries, not work (FlopCounterMode skips the same set)
_QUERIES = {torch.ops.aten.is_contiguous.default,
            torch.ops.aten.is_contiguous.memory_format,
            torch.ops.aten.is_strides_like_format.default,
            torch.ops.aten.is_non_overlapping_and_dense.default,
            torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
            torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
            torch.ops.aten.storage_offset.default,
            torch.ops.aten.sym_storage_offset.default,
            torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
            torch.ops.aten.dim.default, torch.ops.prim.layout.default}

_TRACE = None          # the _Trace a _Local counts into while one runs


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


_OP_INFO = {}   # op -> (is a view, collective kind, has a decomposition)


def _op_info(func):
    info = _OP_INFO.get(func)
    if info is None:
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)
        kind = (None if func.namespace == "aten" else
                _COLL_KIND.get(func._schema.name.split("::")[-1]))
        composite = torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
        info = _OP_INFO[func] = (view, kind, composite)
    return info


def _flat(tree):
    """The leaves of an op's arguments or results: nested lists, tuples
    and dict values (an op's pytrees hold no other containers)."""
    if isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _flat(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _flat(x)
    else:
        yield tree


def _map(fn, tree):
    """``fn`` over the leaves of an op's arguments or results."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


class _Trace:
    """Counters of one trace: FLOPs, bytes, collectives, and live bytes by
    storage (each tensor a tracked storage's owner until its finalizer
    runs)."""

    def __init__(self):
        self.flops = 0
        self.bytes_accessed = 0
        self.coll_bytes = {c: 0 for c in COLLECTIVES}
        self.coll_counts = {c: 0 for c in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._owners = {}             # storage key -> live owning tensors
        self._size = {}               # storage key -> bytes
        self._seen = set()            # ids of the tracked tensors alive

    # ------------------------------------------------------------ memory
    @staticmethod
    def _key(t):
        return t.untyped_storage()._cdata

    def hold(self, t) -> int:
        """Count ``t``'s storage live for the whole trace (an argument);
        returns the bytes it adds (0 for a storage already held)."""
        key = self._key(t)
        if key in self._owners:
            self._owners[key] += 1
            return 0
        n = t.untyped_storage().nbytes()
        self._owners[key], self._size[key] = 1, n
        self.live += n
        self.peak = max(self.peak, self.live)
        return n

    def _track(self, t):
        if id(t) in self._seen:
            return
        self._seen.add(id(t))
        self.hold(t)
        weakref.finalize(t, self._release, self._key(t), id(t))

    def _release(self, key, ident):
        self._seen.discard(ident)
        self._owners[key] -= 1
        if not self._owners[key]:
            del self._owners[key]
            self.live -= self._size.pop(key)

    # ------------------------------------------------------------ counting
    def _count(self, func, args, kwargs, out):
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        view, kind, _ = _op_info(func)
        if kind is not None:
            moved = out if func.namespace.endswith("functional") else args[0]
            self.coll_bytes[kind] += sum(
                _nbytes(t) for t in _flat(moved)
                if isinstance(t, torch.Tensor))
            self.coll_counts[kind] += 1
        elif func.namespace == "aten" and not view:
            self.bytes_accessed += sum(
                _nbytes(t) for t in _flat((args, kwargs, out))
                if isinstance(t, torch.Tensor))
        for t in _flat(out):
            if isinstance(t, torch.Tensor):
                self._track(t)

    def run(self, func, args, kwargs, mode=None):
        """Run ``func`` on plain tensors (``mode`` set: the dispatch mode's
        op) or on :class:`_Local` shards (unwrapped here, the result
        rewrapped), counting it at the shapes it runs on."""
        local = mode is None
        if func in _QUERIES:
            return func(*_unwrap(args), **_unwrap(kwargs))
        if _op_info(func)[2]:
            # as FlopCounterMode: count a composite op by its parts
            if local:
                r = func.decompose(*args, **kwargs)
            else:
                with mode:
                    r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        inner_a, inner_k = _unwrap(args), _unwrap(kwargs)
        out = func(*inner_a, **inner_k)
        self._count(func, inner_a, inner_k, out)
        if not local:
            return out
        ins = {id(a._inner): a for a in _flat((args, kwargs))
               if isinstance(a, _Local)}
        return _map(lambda t: (ins[id(t)] if id(t) in ins else _Local(t))
                    if isinstance(t, torch.Tensor) else t, out)


def _unwrap(tree):
    return _map(lambda t: t._inner if isinstance(t, _Local) else t, tree)


class _Local(torch.Tensor):
    """A DTensor's local shard on ``meta``: every op on it is counted (by
    the running :class:`_Trace`) at the local shapes."""

    @staticmethod
    def __new__(cls, inner):
        return torch.Tensor._make_wrapper_subclass(
            cls, inner.size(), strides=inner.stride(),
            storage_offset=inner.storage_offset(), dtype=inner.dtype,
            device=inner.device, requires_grad=False)

    def __init__(self, inner):
        self._inner = inner

    def __repr__(self):
        return f"_Local({tuple(self.shape)}, {self.dtype})"

    __torch_function__ = torch._C._disabled_torch_function_impl

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(isinstance(a, DTensor) for a in _flat((args, kwargs))):
            # a shard that left its DTensor (``to_local``) meeting one:
            # DTensor's dispatch takes it as replicated, and its local op
            # comes back here
            return NotImplemented
        if _TRACE is None:
            out = func(*_unwrap(args), **_unwrap(kwargs))
            return _map(lambda t: _Local(t) if isinstance(
                t, torch.Tensor) else t, out)
        return _TRACE.run(func, args, kwargs)


class _CountMode(TorchDispatchMode):
    """Counts the ops on plain tensors; an op on a DTensor or a
    :class:`_Local` passes through, to be counted on the local shards."""

    def __init__(self, trace):
        super().__init__()
        self.trace = trace

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(isinstance(a, (DTensor, _Local))
               for a in _flat((args, kwargs))):
            return func(*args, **kwargs)
        return self.trace.run(func, args, kwargs, mode=self)


class _MetaInit(TorchDispatchMode):
    """Factory calls land on ``meta`` (a random draw's generator dropped):
    a full-width model's parameters as shapes, with no memory."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = torch.device("meta")
        if "generator" in kwargs:
            kwargs["generator"] = None
        return func(*args, **kwargs)


# ------------------------------------------------------------ arguments

def _leaves(tree):
    """Tensor leaves of a nested argument (dicts, lists, tuples, an
    AdapterSet's A/B tree and rank mask)."""
    if isinstance(tree, AdapterSet):
        return _leaves(tree.lora) + _leaves(tree.rank_mask)
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _local(t):
    """A leaf's local shard as a plain tensor."""
    if isinstance(t, DTensor):
        t = t.to_local()
    return t._inner if isinstance(t, _Local) else t


def argument_bytes(args) -> int:
    """This device's bytes of a step's arguments: the storages of the
    local shards, each counted once (``argument_size_in_bytes``)."""
    return _storage_bytes(_local(t) for t in _leaves(args))


def _storage_bytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


def _place(tree, placements, mesh):
    """Meta leaves as DTensors on ``mesh`` by ``placements`` (a tree of
    the rules' placements), each local shard a :class:`_Local`; with no
    mesh (or one device) the leaves stay plain."""
    if mesh is None:
        return tree

    def one(t, pl):
        if t.ndim == 0:
            return t
        d = distribute_tensor(t, mesh, pl, src_data_rank=None)
        return DTensor.from_local(_Local(d.to_local()), mesh, pl,
                                  run_check=False)
    return tree_map(one, tree, placements)


def _init(model, device, seed: int):
    """(params, generator): drawn from ``seed`` on a real device, shapes
    only on ``meta``."""
    dev = torch.device(device)
    if dev.type == "meta":
        with _MetaInit():
            return model.init(torch.Generator(), device="meta"), None
    gen = torch.Generator(device=dev).manual_seed(seed)
    return model.init(gen, device=dev), gen


def _build(arch: str, shape_name: str, mesh, rank: int, alpha: float, *,
           shape=None, config=None, device="meta", seed: int = 0):
    """The step and its arguments: returns (fn, args, kind).

    As the JAX dry-run builds them, in bf16 (``dtype`` and
    ``param_dtype``): ``train`` is one round of the real engine's round
    body (``core/federated.make_round_body``, fedsa, SGD at lr 5e-3, a
    ``MeshRun`` on ``mesh``) over the client-stacked adapters (rank,
    alpha, sfedlora, ``cfg.lora_targets``), one client on each client slot
    of the mesh and one local step of (N, 1, per-client batch, seq) tokens
    (or the family's batch dict); ``prefill`` is ``model.forward`` to the
    logits; ``decode`` is ``model.decode_step`` over a cache of
    ``seq_len`` positions.  On ``device="meta"`` the arguments are shapes,
    placed by ``rules.params_sharding`` (the base on the model sub-mesh
    for train, on the whole mesh for prefill / decode),
    ``rules.inputs_sharding`` and ``rules.cache_sharding``; the train
    step's client stacks (adapters, optimizer state, batches) stay plain
    and whole on every device, as ``FederatedTrainer(mesh=)`` holds them
    (each device trains its block of clients and all-gathers the rest),
    not client-sharded as JAX's ``lora_spec`` / ``input_spec`` place
    them.  On a real device (one device, ``mesh`` of one) they are drawn
    from ``seed``, with the same shapes.  ``shape``
    overrides ``INPUT_SHAPES[shape_name]`` (the config variant still
    follows ``shape_name``), ``config`` the config itself (a caller that
    sizes the model: a reduced one in the tests)."""
    shape = shape or INPUT_SHAPES[shape_name]
    cfg = config or config_for_shape(arch, shape_name)
    cfg = dataclasses.replace(cfg, dtype="bfloat16", param_dtype="bfloat16")
    model = build_model(cfg)
    meta = torch.device(device).type == "meta"
    mesh = mesh if mesh is not None and mesh.size() > 1 else None
    params, gen = _init(model, device, seed)

    def draw_ints(spec, high):
        if meta:
            return spec
        return torch.randint(0, high, tuple(spec.shape), generator=gen,
                             device=device, dtype=spec.dtype)

    def real(spec):
        """A batch leaf: token ids below the vocabulary, or N(0, 1)
        features (frames, patches)."""
        if spec.dtype == torch.int32:
            return draw_ints(spec, cfg.vocab_size)
        if meta:
            return spec
        return torch.randn(tuple(spec.shape), generator=gen, device=device,
                           dtype=torch.float32).to(spec.dtype)

    if shape.kind == "train":
        run = MeshRun(mesh) if mesh is not None else None
        n = num_clients(mesh) if mesh is not None else 1
        opt_cfg = OptimizerConfig(name="sgd", lr=5e-3)
        lcfg = LoRAConfig(rank=rank, alpha=alpha, scaling="sfedlora",
                          targets=cfg.lora_targets)
        body = make_round_body(model, strategy="fedsa", opt_cfg=opt_cfg,
                               mesh_run=run)
        if meta:
            with _MetaInit():
                l1 = init_lora(params, torch.Generator(), lcfg)
        else:
            l1 = init_lora(params, gen, lcfg)
        opt1 = make_optimizer(opt_cfg)[0](l1)

        def stack(x):
            return x.expand((n,) + tuple(x.shape)).clone()
        lora, opt = tree_map(stack, l1), tree_map(stack, opt1)
        spec = model.input_specs(shape, n_clients=n)
        # (N, local_steps=1, per-client batch, ...)
        batch = {k: real(torch.empty((v.shape[0], 1) + tuple(v.shape[1:]),
                                     dtype=v.dtype, device="meta"))
                 for k, v in spec.items()}
        if mesh is not None:
            base_mesh = run.model_mesh
            if base_mesh is not None:
                params = _place(params, rules.params_sharding(
                    params, base_mesh), base_mesh)
        adapters = AdapterSet.from_config(lcfg, n_clients=n, lora=lora)
        tokens = batch if cfg.family in ("vlm", "audio") else batch["tokens"]

        def train_step(base, adapters, opt_N, batches):
            return body(base, adapters, opt_N, batches, 0)
        return train_step, (params, adapters, opt, tokens), "train"

    if shape.kind == "prefill":
        batch = {k: real(v) for k, v in model.input_specs(shape).items()}
        if mesh is not None:
            params = _place(params, rules.params_sharding(params, mesh), mesh)
            batch = _place(batch, rules.inputs_sharding(batch, mesh), mesh)

        def prefill(params, batch):
            logits, _ = model.forward(params, batch)
            return logits
        return prefill, (params, batch), "prefill"

    spec = model.input_specs(shape)
    token, pos = draw_ints(spec["token"], cfg.vocab_size), spec["pos"]
    cache = spec["cache"]
    if not meta:
        cache = model.init_cache(shape.global_batch, shape.seq_len,
                                 dtype=torch.bfloat16, device=device)
        pos = torch.full(tuple(pos.shape), shape.seq_len // 2,
                         dtype=pos.dtype, device=device)
    if mesh is not None:
        params = _place(params, rules.params_sharding(params, mesh), mesh)
        cache = _place(cache, rules.cache_sharding(cache, mesh), mesh)
        token = _place({"t": token}, rules.inputs_sharding(
            {"t": token}, mesh), mesh)["t"]
        pos = _place({"t": pos}, rules.inputs_sharding({"t": pos}, mesh),
                     mesh)["t"]

    def serve_step(params, cache, token, pos):
        return model.decode_step(params, cache, token, pos)
    return serve_step, (params, cache, token, pos), "decode"


def trace(fn, args, kind: str, mesh=None) -> dict:
    """Run ``fn(*args)`` once on its meta arguments under the counters;
    returns the record's counts (see the module docstring).  ``mesh``
    gives the in-model ``constrain`` calls their mesh."""
    global _TRACE
    tr = _Trace()
    arg_bytes = sum(tr.hold(_local(t)) for t in _leaves(args))
    prev, _TRACE = _TRACE, tr
    t0 = time.monotonic()
    try:
        with contextlib.ExitStack() as scope:
            if mesh is not None:
                scope.enter_context(use_mesh(mesh))
                scope.enter_context(replicating())
            scope.enter_context(torch.enable_grad() if kind == "train"
                                else torch.no_grad())
            with _CountMode(tr):
                out = fn(*args)
        trace_s = time.monotonic() - t0
        peak = tr.peak
        outs = [_local(t) for t in _leaves(out)]
    finally:
        _TRACE = prev
    return {"trace_s": round(trace_s, 2), "tier": "plain",
            "flops": tr.flops, "bytes_accessed": tr.bytes_accessed,
            "collective_bytes": tr.coll_bytes,
            "collective_counts": tr.coll_counts,
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": _storage_bytes(outs),
            "temp_size_in_bytes": peak - arg_bytes}


def run_one(arch: str, shape_name: str, *, multi_pod: bool, rank: int = 64,
            alpha: float = 8.0, verbose: bool = True, mesh=None, shape=None,
            config=None):
    """Start the fake group at the mesh's size, build the step on meta
    arguments placed on the production mesh, trace it once as rank 0, and
    return the record.  ``mesh`` (a spec, e.g. ``"2x2"``) replaces the
    production mesh, ``shape`` / ``config`` the input shape and the model
    config (see :func:`_build`)."""
    spec = mesh or ("multipod" if multi_pod else "pod")
    dims, _ = parse_spec(spec)
    start_fake_group(math.prod(dims))
    mesh = mesh_from_spec(spec, "cpu")
    fn, args, kind = _build(arch, shape_name, mesh, rank, alpha,
                            shape=shape, config=config)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(str(d) for d in dims),
           "devices": mesh.size(), "kind": kind,
           **trace(fn, args, kind, mesh)}
    if verbose:
        print(json.dumps(rec))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--rank", type=int, default=64)
    ap.add_argument("--out", default="EXPERIMENTS/dryrun_torch")
    ap.add_argument("--opts", default="", help="comma-separated "
                    "beyond-paper opts (sharding/opts.py)")
    args = ap.parse_args(argv)

    if args.opts:
        set_opts([o for o in args.opts.split(",") if o])

    os.makedirs(args.out, exist_ok=True)
    combos = []
    if args.all:
        for arch in ASSIGNED:
            for shape in INPUT_SHAPES:
                for mp in (False, True):
                    combos.append((arch, shape, mp))
    else:
        combos.append((args.arch, args.shape, args.multi_pod))

    for arch, shape, mp in combos:
        tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"SKIP(done) {tag}")
            continue
        if not supports_shape(arch, shape):
            rec = {"arch": arch, "shape": shape,
                   "mesh": "2x16x16" if mp else "16x16",
                   "skipped": "full-attention arch: long_500k requires "
                              "sub-quadratic attention (DESIGN.md §5)"}
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            print(f"SKIP(policy) {tag}")
            continue
        t0 = time.monotonic()
        try:
            rec = run_one(arch, shape, multi_pod=mp, rank=args.rank)
        except Exception as e:
            rec = {"arch": arch, "shape": shape,
                   "mesh": "2x16x16" if mp else "16x16", "error": str(e),
                   "trace": traceback.format_exc()[-2000:]}
            print(f"FAIL {tag}: {e}")
        rec["wall_s"] = round(time.monotonic() - t0, 2)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
