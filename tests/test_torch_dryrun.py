"""The port's dry-run (``repro_torch.launch.dryrun``) and hillclimb against
the JAX package's registry, shapes and partition rules, with no compile:
the JAX side is ``jax.eval_shape`` and rule calls on a ``FakeMesh`` only.

  registry     supports_shape, config_for_shape (every field),
               LONG_CONTEXT_OK, NO_DECODE and ASSIGNED equal JAX's
  input specs  every leaf of ``Model.input_specs`` (the decode cache too),
               by path, has JAX's shape and dtype, at full width
  arguments    a record's per-device argument bytes equal the sum over
               JAX's leaves of numel x itemsize / (the mesh axes JAX's
               specs name), at full width on the 16x16 pod and reduced on
               2x2; the train step's client stacks whole, as the port's
               trainer holds them
  counters     collective bytes by JAX's result-size convention, local
               FLOPs of a sharded and a replicated matmul, the memory
               tracker's peak, and the trace's FLOPs against
               ``FlopCounterMode`` on a real CPU run, exactly
  families     one reduced model of each family traces train, prefill and
               decode on fake 2x2 and 1x4 meshes
  CLI          records, skips by policy with JAX's message, hillclimb terms
"""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs                          # noqa: E402
from repro.configs import base as jbase                        # noqa: E402
from repro.core.lora import init_lora as jinit_lora            # noqa: E402
from repro.models import api as japi                           # noqa: E402
from repro.sharding import rules as jrules                     # noqa: E402
from repro_torch import configs as tconfigs                    # noqa: E402
from repro_torch.configs import InputShape                     # noqa: E402
from repro_torch.launch import dryrun, hillclimb               # noqa: E402
from repro_torch.launch import mesh as tmesh                   # noqa: E402
from repro_torch.models import api as tapi                     # noqa: E402

SHAPES = tuple(jconfigs.INPUT_SHAPES)
# one arch of every family at one repeat of its block pattern (the hybrid
# and the xLSTM: every block kind once)
FAMILY_ARCHS = {"gemma-2b": 1, "qwen2-moe-a2.7b": 1, "recurrentgemma-9b": 3,
                "xlstm-1.3b": 2, "whisper-medium": 1, "paligemma-3b": 1,
                "roberta-large": 1}
RECORD_KEYS = ("flops", "bytes_accessed", "collective_bytes",
               "collective_counts", "argument_size_in_bytes",
               "output_size_in_bytes", "temp_size_in_bytes", "trace_s")
JAX_SKIP = ("full-attention arch: long_500k requires sub-quadratic "
            "attention (DESIGN.md §5)")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops gain nothing from more torch threads; the fake process
    group the traces start is torn down after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


class FakeMesh:
    """What JAX's rules read of a mesh (``tests/test_dryrun_units.py``)."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


POD = FakeMesh({"data": 16, "model": 16})


def _keys(path):
    return tuple(str(getattr(k, "key", getattr(k, "name", k))) for k in path)


def _jax_bytes(tree, spec_fn, mesh):
    """Per device: sum of numel x itemsize / (the axes the spec names)."""
    total = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = spec_fn(_keys(path), tuple(leaf.shape), mesh)
        div = 1
        for entry in spec:
            for name in ((entry,) if isinstance(entry, str) else entry or ()):
                div *= mesh.shape[name]
        n = math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize
        assert n % div == 0
        total += n // div
    return total


def _jax_args_bytes(arch, shape_name, mesh, *, cfg=None, shape=None,
                    rank=64):
    """JAX's dry-run arguments (``repro/launch/dryrun._build``) of one
    step, per device, from eval_shape and the rules; the train step's PRNG
    key and round index have no counterpart in the port's round (it takes
    a Python round index and no key) and are left out.  The train step's
    client stacks (adapters, optimizer state, batches) count whole: the
    port's trainer keeps them on every device, where JAX's ``lora_spec`` /
    ``chunked_input_spec`` split the clients."""
    shape = shape or jconfigs.INPUT_SHAPES[shape_name]
    cfg = cfg or jconfigs.config_for_shape(arch, shape_name)
    cfg = dataclasses.replace(cfg, dtype="bfloat16", param_dtype="bfloat16")
    model = japi.build_model(cfg)
    params = jax.eval_shape(lambda: model.init(jax.random.key(0)))
    total = _jax_bytes(params, jrules.param_spec, mesh)
    if shape.kind == "train":
        n = math.prod(mesh.shape[a] for a in ("pod", "data")
                      if a in mesh.shape)
        lcfg = jbase.LoRAConfig(rank=rank, alpha=8.0, scaling="sfedlora",
                                targets=cfg.lora_targets)
        lora = jax.eval_shape(lambda: jax.tree.map(
            lambda x: jax.numpy.broadcast_to(x, (n,) + x.shape),
            jinit_lora(model.init(jax.random.key(0)), jax.random.key(1),
                       lcfg)))
        opt = {"t": jax.ShapeDtypeStruct((n,), jax.numpy.int32)}
        batch = {k: jax.ShapeDtypeStruct((1, v.shape[0], 1) + v.shape[1:],
                                         v.dtype)
                 for k, v in model.input_specs(shape, n_clients=n).items()}

        def whole(p, s, m):
            return ()
        return (total + _jax_bytes(lora, whole, mesh)
                + _jax_bytes(opt, whole, mesh)
                + _jax_bytes(batch, whole, mesh))
    spec = model.input_specs(shape)

    def ispec(p, s, m):
        return jrules.input_spec(p, s, m, client_dim=False)
    return (total + _jax_bytes(spec["cache"], jrules.cache_spec, mesh)
            + _jax_bytes(spec["token"], ispec, mesh)
            + _jax_bytes(spec["pos"], ispec, mesh))


# ---------------------------------------------------------------- registry

def test_registry_equals_jax():
    assert tconfigs.ASSIGNED == jconfigs.ASSIGNED
    assert tconfigs.LONG_CONTEXT_OK == jconfigs.LONG_CONTEXT_OK
    assert tuple(tconfigs.NO_DECODE) == tuple(jconfigs.NO_DECODE)
    assert {k: dataclasses.asdict(v)
            for k, v in tconfigs.INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.INPUT_SHAPES.items()}
    for arch in jconfigs.ARCHS:
        for name in SHAPES:
            assert tconfigs.supports_shape(arch, name) == \
                jconfigs.supports_shape(arch, name), (arch, name)
            got = dataclasses.asdict(tconfigs.config_for_shape(arch, name))
            want = dataclasses.asdict(jconfigs.config_for_shape(arch, name))
            assert got == {k: want[k] for k in got}, (arch, name)


# -------------------------------------------------------------- input specs

def _by_path(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _by_path(
            tree[k], prefix + (str(k),)).items()}
    return {prefix: tree}


@pytest.mark.parametrize("arch", jconfigs.ASSIGNED)
def test_input_specs_equal_jax(arch):
    """Every leaf of every supported shape, the decode cache included, at
    full width: JAX's shape and dtype, by path (train with the pod's 16
    client slots and without)."""
    for name in SHAPES:
        if not jconfigs.supports_shape(arch, name):
            continue
        shape = jconfigs.INPUT_SHAPES[name]
        jm = japi.build_model(jconfigs.config_for_shape(arch, name))
        tm = tapi.build_model(tconfigs.config_for_shape(arch, name))
        for kw in ([{"n_clients": 16}, {}] if shape.kind == "train"
                   else [{}]):
            want = {_keys(p): leaf for p, leaf in
                    jax.tree_util.tree_flatten_with_path(
                        jm.input_specs(shape, **kw))[0]}
            got = _by_path(tm.input_specs(
                tconfigs.INPUT_SHAPES[name], **kw))
            assert set(got) == set(want), (arch, name)
            for path, leaf in got.items():
                assert leaf.device.type == "meta"
                assert tuple(leaf.shape) == tuple(want[path].shape), path
                assert str(leaf.dtype).split(".")[-1] == str(
                    want[path].dtype), path


# ----------------------------------------------------------------- arguments

@pytest.mark.parametrize("arch", ["gemma-2b", "qwen2-moe-a2.7b"])
def test_argument_bytes_equal_jax_rules_on_the_pod(arch):
    """Full width on 16x16: the train and decode steps' arguments as
    ``_build`` places them (``argument_bytes``, the sum a record's
    ``argument_size_in_bytes`` takes: gemma-2b's decode record is held to
    it too), against JAX's specs."""
    tmesh.start_fake_group(256)
    mesh = tmesh.make_production_mesh()
    for name in ("train_4k", "decode_32k"):
        _, args, kind = dryrun._build(arch, name, mesh, 64, 8.0)
        assert kind == jconfigs.INPUT_SHAPES[name].kind
        want = _jax_args_bytes(arch, name, POD)
        assert dryrun.argument_bytes(args) == want, name
    if arch == "gemma-2b":
        rec = dryrun.run_one(arch, "decode_32k", multi_pod=False,
                             verbose=False)
        assert rec["argument_size_in_bytes"] == want


def test_argument_bytes_reduced_on_2x2():
    cfg = jconfigs.get_config("gemma-2b").reduced(d_model=64,
                                                  vocab_size=256)
    fake = FakeMesh({"data": 2, "model": 2})
    for name, shape in (("train_4k", InputShape("t", 16, 4, "train")),
                        ("decode_32k", InputShape("d", 16, 4, "decode"))):
        rec = dryrun.run_one("gemma-2b", name, multi_pod=False,
                             verbose=False, mesh="2x2", shape=shape,
                             config=tconfigs.get_config("gemma-2b").reduced(
                                 d_model=64, vocab_size=256), rank=8)
        assert rec["argument_size_in_bytes"] == _jax_args_bytes(
            "gemma-2b", name, fake, cfg=cfg, shape=shape, rank=8), name


# ------------------------------------------------------------------ counters

def _fake_mesh(spec):
    dims, _ = tmesh.parse_spec(spec)
    tmesh.start_fake_group(math.prod(dims))
    return tmesh.mesh_from_spec(spec, "cpu")


def _dt(mesh, local_shape, placements, dtype=torch.float32):
    from torch.distributed.tensor import DTensor
    local = dryrun._Local(torch.empty(local_shape, dtype=dtype,
                                      device="meta"))
    return DTensor.from_local(local, mesh, placements, run_check=False)


def test_collective_bytes_follow_jax_convention():
    """An all-gather to bf16 (4, 1024) counts its result, 8192 bytes; an
    all-reduce of f32 [512] its tensor, 2048 (``tests/test_dryrun_units.py``
    holds JAX's parser to the same numbers)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = _fake_mesh("4")
    ag = _dt(mesh, (1, 1024), [Shard(0)], torch.bfloat16)
    ar = _dt(mesh, (512,), [Partial()])

    def step(x, y):
        return (x.redistribute(mesh, [Replicate()]),
                y.redistribute(mesh, [Replicate()]))
    rec = dryrun.trace(step, (ag, ar), "decode", mesh)
    assert rec["collective_bytes"] == {
        "all-gather": 8192, "all-reduce": 2048, "reduce-scatter": 0,
        "all-to-all": 0, "collective-permute": 0}
    assert rec["collective_counts"]["all-gather"] == 1
    assert rec["collective_counts"]["all-reduce"] == 1


def test_flops_are_local():
    """A column-parallel matmul on 1x4 counts a quarter of the global
    FLOPs per device; a replicated one counts all of them."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _fake_mesh("1x4")
    m, k, n = 64, 128, 256
    full = 2 * m * k * n
    x = _dt(mesh, (m, k), [Replicate(), Replicate()])
    w_col = _dt(mesh, (k, n // 4), [Replicate(), Shard(1)])
    w_rep = _dt(mesh, (k, n), [Replicate(), Replicate()])
    assert dryrun.trace(torch.matmul, (x, w_col), "decode",
                        mesh)["flops"] == full // 4
    assert dryrun.trace(torch.matmul, (x, w_rep), "decode",
                        mesh)["flops"] == full


def test_memory_tracker_peak_of_a_chain():
    """((x @ w1) @ w2) @ w3 on plain meta tensors: each product lives
    until the next is made, the last is the output, so the peak above the
    arguments is max(y1 + y2, y2 + y3)."""
    m = 8
    x = torch.empty(m, 16, device="meta")
    w1 = torch.empty(16, 300, device="meta")
    w2 = torch.empty(300, 40, device="meta")
    w3 = torch.empty(40, 500, device="meta")
    rec = dryrun.trace(lambda a, b, c, d: ((a @ b) @ c) @ d,
                       (x, w1, w2, w3), "decode")
    y1, y2, y3 = (4 * m * n for n in (300, 40, 500))
    assert rec["temp_size_in_bytes"] == max(y1 + y2, y2 + y3)
    assert rec["output_size_in_bytes"] == y3
    assert rec["argument_size_in_bytes"] == 4 * (
        m * 16 + 16 * 300 + 300 * 40 + 40 * 500)
    assert rec["flops"] == 2 * m * (16 * 300 + 300 * 40 + 40 * 500)


def test_replicating_is_reentrant():
    """``specs.replicating`` sets DTensor's private implicit-replication
    flag: the flag must exist in this torch, and a nested use must leave
    an outer ``implicit_replication`` (the trainer's ``MeshRun.scope``)
    or ``replicating`` (the dry-run's trace) switched on."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.sharding.specs import replicating
    disp = DTensor._op_dispatcher
    assert hasattr(disp, "_allow_implicit_replication")
    assert not disp._allow_implicit_replication
    for outer in (implicit_replication, replicating):
        with outer():
            with replicating():
                assert disp._allow_implicit_replication
            assert disp._allow_implicit_replication
        assert not disp._allow_implicit_replication


@pytest.mark.parametrize("name,shape", [
    ("train_4k", InputShape("t", 32, 2, "train")),
    ("decode_32k", InputShape("d", 16, 2, "decode"))])
def test_trace_flops_equal_a_real_run(name, shape):
    """1x1: the dry-run's count of one reduced dense round (and of a
    decode step) equals FlopCounterMode's count of the same step run for
    real on CPU tensors, exactly."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = tconfigs.get_config("gemma-2b").reduced(d_model=64,
                                                  vocab_size=256)
    mesh = _fake_mesh("1x1")
    fn, args, kind = dryrun._build("gemma-2b", name, mesh, 8, 8.0,
                                   shape=shape, config=cfg)
    rec = dryrun.trace(fn, args, kind, mesh)
    fn, args, _ = dryrun._build("gemma-2b", name, mesh, 8, 8.0, shape=shape,
                                config=cfg, device="cpu")
    grad = torch.enable_grad() if kind == "train" else torch.no_grad()
    with grad, FlopCounterMode(display=False) as fc:
        fn(*args)
    assert rec["flops"] == fc.get_total_flops() > 0


def _grouped_moe_flops(spec):
    """The per-device FLOPs of one reduced qwen2-moe layer under
    ``moe_grouped`` on a fake ``spec`` mesh: the expert stacks placed by
    the port's rules, x's 4 batch rows split over the batch axes."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models import moe as tmoe
    from repro_torch.sharding import opts, rules
    mesh = _fake_mesh(spec)
    cfg = tconfigs.get_config("qwen2-moe-a2.7b").reduced(d_model=64,
                                                         vocab_size=256)
    p = tmoe.moe_params(cfg, torch.Generator().manual_seed(0))
    tree = {"stack": {"repeat": {"p0": {"moe": {
        k: v[None] for k, v in p.items()}}}}}
    pl = rules.params_sharding(tree, mesh)["stack"]["repeat"]["p0"]["moe"]

    def placed(shape, placements):
        local = list(shape)
        for i, q in enumerate(placements):
            if q.is_shard():
                local[q.dim] //= mesh.size(i)
        return _dt(mesh, tuple(local), placements)
    params = {k: placed(v.shape, [Shard(q.dim - 1) if q.is_shard() else q
                                  for q in pl[k]]) for k, v in p.items()}
    x = placed((4, 16, 64), [Shard(0) if n in ("pod", "data")
                             else Replicate() for n in mesh.mesh_dim_names])
    opts.set_opts(["moe_grouped"])
    try:
        return dryrun.trace(lambda pp, xx: tmoe.moe_apply(cfg, pp, xx),
                            (params, x), "decode", mesh)["flops"]
    finally:
        opts.reset()


def test_grouped_moe_flops_halve_with_the_batch_axis():
    """Under ``moe_grouped`` each device dispatches only its own batch
    rows (JAX splits the grouped buffers over the batch axes), so doubling
    "data" from 1x2 to 2x2 halves a device's MoE FLOPs exactly."""
    one = _grouped_moe_flops("1x2")
    two = _grouped_moe_flops("2x2")
    assert one > 0 and one == 2 * two


# ------------------------------------------------------------------ families

@pytest.mark.parametrize("spec", ["2x2", "1x4"])
def test_every_family_traces(spec):
    shapes = {"train_4k": InputShape("t", 16, 2, "train"),
              "prefill_32k": InputShape("p", 16, 4, "prefill"),
              "decode_32k": InputShape("d", 16, 4, "decode")}
    for arch, layers in FAMILY_ARCHS.items():
        cfg = tconfigs.get_config(arch).reduced(
            num_layers=layers, d_model=64, vocab_size=256)
        for name, shape in shapes.items():
            rec = dryrun.run_one(arch, name, multi_pod=False, verbose=False,
                                 mesh=spec, shape=shape, config=cfg, rank=8)
            assert rec["mesh"] == spec and rec["tier"] == "plain"
            assert rec["kind"] == shape.kind
            for key in RECORD_KEYS:
                assert key in rec, (arch, name, key)
            assert rec["flops"] > 0 and rec["argument_size_in_bytes"] > 0
            assert set(rec["collective_bytes"]) == set(dryrun.COLLECTIVES)


def test_switches_trace_on_a_model_axis(monkeypatch):
    """The hillclimb's variants: a reduced round on 1x4 traces under
    ``expand_kv`` with the chunked CE (whose chunk sums are plain tensors
    on a model axis) and under ``remat_dots``.  The default round remats
    each repeat unit whole, so its backward recomputes the unit's every
    FLOP; ``remat_dots`` keeps the projections' products and recomputes
    fewer; with no remat nothing is recomputed."""
    import functools

    from repro_torch.models import transformer as ttransformer
    from repro_torch.sharding import opts
    cfg = tconfigs.get_config("gemma-2b").reduced(num_layers=1, d_model=64,
                                                  vocab_size=256)

    def record():
        return dryrun.run_one("gemma-2b", "train_4k", multi_pod=False,
                              verbose=False, mesh="1x4", config=cfg, rank=8,
                              shape=InputShape("t", 16, 1, "train"))
    base = record()
    for names in (("expand_kv", "chunked_ce"), ("remat_dots",)):
        opts.set_opts(names)
        try:
            rec = record()
        finally:
            opts.reset()
        assert rec["argument_size_in_bytes"] == \
            base["argument_size_in_bytes"], names
        if names == ("remat_dots",):
            dots = rec["flops"]
        else:
            assert rec["flops"] >= base["flops"] > 0, names
    monkeypatch.setattr(tapi, "apply_stack", functools.partial(
        ttransformer.apply_stack, remat=False))
    kept = record()
    assert 0 < kept["flops"] < dots < base["flops"]


# ----------------------------------------------------------------------- CLI

def test_cli_records_and_skips_by_policy(tmp_path, capsys):
    out = str(tmp_path)
    for arch, shape in (("roberta-large", "decode_32k"),
                        ("qwen3-8b", "long_500k")):
        dryrun.main(["--arch", arch, "--shape", shape, "--out", out])
        assert f"SKIP(policy) {arch}__{shape}__sp" in capsys.readouterr().out
        with open(tmp_path / f"{arch}__{shape}__sp.json") as f:
            assert json.load(f) == {"arch": arch, "shape": shape,
                                    "mesh": "16x16", "skipped": JAX_SKIP}
    dryrun.main(["--arch", "gemma-2b", "--shape", "long_500k", "--out", out])
    with open(tmp_path / "gemma-2b__long_500k__sp.json") as f:
        rec = json.load(f)
    assert "error" not in rec, rec.get("trace")
    assert rec["tier"] == "plain" and rec["devices"] == 256
    for key in RECORD_KEYS:
        assert key in rec
    dryrun.main(["--arch", "gemma-2b", "--shape", "long_500k", "--out", out])
    assert "SKIP(done) gemma-2b__long_500k__sp" in capsys.readouterr().out


def test_hillclimb_terms_use_the_h100_constants():
    rec = {"flops": 989e12, "bytes_accessed": 6.7e12,
           "collective_bytes": {"all-gather": 300e9, "all-reduce": 150e9},
           "temp_size_in_bytes": 2.5e9}
    assert hillclimb.terms(rec) == pytest.approx(
        {"compute_s": 1.0, "memory_s": 2.0, "collective_s": 1.0,
         "temp_gb": 2.5})
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.HBM_BW, tmesh.NVLINK_BW) == (
        989e12, 3.35e12, 450e9)
