"""``repro_torch.sharding.rules`` / ``specs`` and ``launch/mesh`` against the
JAX package's, with no process group: the rules read axis names and sizes
only, so both packages' rules take the same
:class:`~repro_torch.launch.mesh.MeshShape`.

Every leaf of every arch's full-size parameter tree (JAX's
``jax.eval_shape`` tree) gets JAX's ``param_spec`` on the 16x16 pod, the
2x16x16 multi-pod, 4x2 and 1x8, with ``embed_dshard`` off and on; LoRA,
cache (with and without ``cache_seq_shard``) and input specs are compared
the same way on reduced trees.  Exact equality: a spec is names, not
numbers."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch.distributed.tensor import Replicate, Shard            # noqa: E402

from repro import configs as jconfigs                          # noqa: E402
from repro.configs import base as jbase                        # noqa: E402
from repro.core import lora as jlora                           # noqa: E402
from repro.launch import mesh as jmesh                         # noqa: E402
from repro.models import api as japi                           # noqa: E402
from repro.sharding import opts as jopts                       # noqa: E402
from repro.sharding import rules as jrules                     # noqa: E402
from repro_torch import configs as tconfigs                    # noqa: E402
from repro_torch.core.lora import init_lora                    # noqa: E402
from repro_torch.configs.base import LoRAConfig                # noqa: E402
from repro_torch.launch import mesh as tmesh                   # noqa: E402
from repro_torch.models import api as tapi                     # noqa: E402
from repro_torch.models import transformer as ttransformer     # noqa: E402
from repro_torch.sharding import opts as topts                 # noqa: E402
from repro_torch.sharding import rules as trules               # noqa: E402
from repro_torch.sharding import specs as tspecs               # noqa: E402

MESHES = {spec: tmesh.mesh_shape(spec)
          for spec in ("pod", "multipod", "4x2", "1x8")}
ARCHS = sorted(jconfigs.ARCHS)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops gain nothing from more torch threads, and the suite's
    parallel workers (and the spawned ranks) share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_opts():
    yield
    jopts.reset()
    topts.reset()


def _set(name, on):
    jopts.set_opts([name], on)
    topts.set_opts([name], on)


def _jax_specs(tree, mesh, fn):
    """JAX's spec function over a tree, as tuples (the walk of JAX's
    ``tree_specs``, without a device mesh behind it)."""
    return trules.tree_specs(tree, mesh, lambda p, s, m: tuple(fn(p, s, m)))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


def _assert_same_specs(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert got.keys() == want.keys()
    diff = {p: (got[p], want[p]) for p in got if got[p] != want[p]}
    assert not diff, diff


@pytest.fixture(scope="module")
def full_trees():
    return {a: jax.eval_shape(japi.build_model(jconfigs.get_config(a)).init,
                              jax.random.key(0)) for a in ARCHS}


@pytest.mark.parametrize("embed_dshard", [False, True])
@pytest.mark.parametrize("spec", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(full_trees, arch, spec, embed_dshard):
    _set("embed_dshard", embed_dshard)
    tree, mesh = full_trees[arch], MESHES[spec]
    got = trules.tree_specs(tree, mesh, trules.param_spec)
    _assert_same_specs(got, _jax_specs(tree, mesh, jrules.param_spec))
    sharded = [s for _, s in _flat(got) if any(e is not None for e in s)]
    assert sharded, "no leaf of the base shards"


@pytest.fixture(scope="module")
def reduced():
    """Per arch: the reduced JAX model, params and one client's LoRA."""
    out = {}
    for a in ARCHS:
        cfg = jconfigs.get_config(a).reduced()
        m = japi.build_model(cfg)
        params = jax.eval_shape(m.init, jax.random.key(0))
        lora = jax.eval_shape(
            lambda p, cfg=cfg: jlora.init_lora(
                p, jax.random.key(1), jbase.LoRAConfig(rank=8),
                targets=cfg.lora_targets), params)
        out[a] = (cfg, m, lora)
    return out


def _stacked(tree, n):
    return jax.tree.map(
        lambda x: jax.ShapeDtypeStruct((n,) + x.shape, x.dtype), tree)


@pytest.mark.parametrize("spec", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_lora_specs_match_jax(reduced, arch, spec):
    """Client-stacked (N = 1, 4, 16, 32) and single-client trees."""
    cfg, _, lora = reduced[arch]
    mesh = MESHES[spec]
    for n in (1, 4, 16, 32):
        tree = _stacked(lora, n)
        _assert_same_specs(
            trules.tree_specs(tree, mesh, lambda p, s, m: trules.lora_spec(
                p, s, m, client_dim=True)),
            _jax_specs(tree, mesh, lambda p, s, m: jrules.lora_spec(
                p, s, m, client_dim=True)))
    _assert_same_specs(
        trules.tree_specs(lora, mesh, lambda p, s, m: trules.lora_spec(
            p, s, m, client_dim=False)),
        _jax_specs(lora, mesh, lambda p, s, m: jrules.lora_spec(
            p, s, m, client_dim=False)))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_lora_tree_has_jax_paths(reduced, arch):
    """The port's own ``init_lora`` tree, which its trainer places, has the
    paths (and so the specs) of JAX's."""
    tcfg = tconfigs.get_config(arch).reduced()
    tparams = tapi.build_model(tcfg).init(torch.Generator().manual_seed(0),
                                          "cpu")
    tlora = init_lora(tparams, torch.Generator().manual_seed(1),
                      LoRAConfig(rank=8), targets=tcfg.lora_targets)
    lora = reduced[arch][2]
    for mesh in MESHES.values():
        _assert_same_specs(
            trules.tree_specs(tlora, mesh, lambda p, s, m: trules.lora_spec(
                p, s, m, client_dim=False)),
            _jax_specs(lora, mesh, lambda p, s, m: jrules.lora_spec(
                p, s, m, client_dim=False)))


@pytest.mark.parametrize("cache_seq_shard", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_jax(reduced, arch, cache_seq_shard):
    """Decode caches at batch 1, 4 and 32 (below, at and above the client
    axes' sizes), on every mesh."""
    _set("cache_seq_shard", cache_seq_shard)
    _, m, _ = reduced[arch]
    for batch in (1, 4, 32):
        cache = jax.eval_shape(lambda b=batch: m.init_cache(b, 64))
        for mesh in MESHES.values():
            _assert_same_specs(
                trules.tree_specs(cache, mesh, trules.cache_spec),
                _jax_specs(cache, mesh, jrules.cache_spec))


@pytest.mark.parametrize("spec", list(MESHES))
def test_input_specs_match_jax(spec):
    mesh = MESHES[spec]
    shapes = [(8, 128), (3, 128), (16, 2, 4, 64), (32, 1, 2, 16),
              (5, 2, 2, 16)]
    for client_dim in (False, True):
        for shape in shapes:
            assert trules.input_spec((), shape, mesh,
                                     client_dim=client_dim) == tuple(
                jrules.input_spec((), shape, mesh, client_dim=client_dim))
    for shape in [(2, 16, 2, 4, 64), (3, 32, 1, 2, 16), (1, 5, 2, 2, 16)]:
        assert trules.chunked_input_spec(("tokens",), shape, mesh) == tuple(
            jrules.chunked_input_spec(("tokens",), shape, mesh))
    batch = {"tokens": np.zeros((16, 2, 4, 64), np.int32),
             "frames": np.zeros((16, 2, 4, 8, 32), np.float32)}
    got = trules.inputs_sharding(batch, mesh, client_dim=True)
    for k, v in batch.items():
        assert got[k] == trules.placements(
            jrules.input_spec((k,), v.shape, mesh, client_dim=True), mesh)


def test_placements_of_specs():
    """Each mesh dim shards the tensor dim that names it (pod-major for
    ("pod", "data")); names the mesh lacks are ignored."""
    multi = MESHES["multipod"]
    assert trules.placements((("pod", "data"), None, "model"), multi) == (
        Shard(0), Shard(0), Shard(2))
    assert trules.placements((None, "model"), MESHES["4x2"]) == (
        Replicate(), Shard(1))
    model_only = tmesh.MeshShape(("model",), (2,))
    assert trules.placements((("pod", "data"), "model", None),
                             model_only) == (Shard(1),)
    assert trules.placements((None, None), model_only) == (Replicate(),)
    # client blocks, pod-major
    assert trules.block_of(32, ("pod", "data"), multi,
                           {"pod": 1, "data": 3, "model": 0}) == (19, 20)
    assert trules.block_of(8, "data", MESHES["4x2"],
                           {"data": 2, "model": 1}) == (4, 6)
    assert trules.block_of(8, None, MESHES["4x2"],
                           {"data": 2, "model": 1}) == (0, 8)


@pytest.mark.parametrize("spec", ["", "none", "4x2", "2x16x16", "8", "pod",
                                  "multipod"])
def test_mesh_specs_match_jax(spec):
    """The spec grammar, axis names, client axes and client slots of
    ``launch/mesh.py`` are JAX's."""
    got = tmesh.mesh_shape(spec)
    if spec in ("", "none"):
        assert got is None and jmesh.mesh_from_spec(spec) is None
        return
    named = {"pod": (16, 16), "multipod": (2, 16, 16)}
    dims = named[spec] if spec in named else tuple(
        int(d) for d in spec.split("x"))
    assert got.sizes == dims
    assert got.axis_names == {1: ("data",), 2: ("data", "model"),
                              3: ("pod", "data", "model")}[len(dims)]
    want_clients = int(np.prod(dims[:-1])) if len(dims) > 1 else dims[0]
    assert jmesh.client_axes(got) == tmesh.client_axes(got)
    assert tmesh.num_clients(got) == jmesh.num_clients(got) == want_clients


def test_mesh_from_spec_needs_a_group_of_its_size():
    with pytest.raises(ValueError, match="expected 1-3"):
        tmesh.parse_spec("1x2x3x4")
    assert tmesh.mesh_from_spec("none") is None
    if torch.distributed.is_initialized():
        pytest.fail("a process group leaked into this worker")
    with pytest.raises(RuntimeError, match="default process group"):
        tmesh.mesh_from_spec("2x2", "cpu")


def test_constrain_is_the_identity_off_a_mesh_and_on_plain_tensors():
    x = torch.randn(2, 8, 4, 16)
    spec = (("pod", "data"), None, "model", None)
    assert tspecs.constrain(x, spec) is x
    assert tspecs.current_mesh() is None
    with tspecs.use_mesh(MESHES["4x2"]) as m:
        assert tspecs.current_mesh() is m
        assert tspecs.constrain(x, spec) is x
    assert tspecs.current_mesh() is None


# ---------------------------------------------------------------- switches

@pytest.mark.parametrize("name", sorted(jopts.OPTS))
def test_set_opts_accepts_every_switch(name):
    """Every switch of the JAX package is set in the port too, alongside
    the others, and reset clears it."""
    jopts.set_opts([name])
    topts.set_opts(["chunked_ce", name])
    assert topts.enabled(name) and topts.enabled("chunked_ce")
    assert set(topts.PORTED) == set(jopts.OPTS)
    topts.reset()
    assert not any(topts.OPTS.values())


def _loss_and_grads(arch, gen_seed=0, remat=True):
    from repro_torch.core.lora import AdapterSet
    from repro_torch.kernels import dispatch
    from repro_torch.tree import tree_leaves, tree_map
    cfg = tconfigs.get_config(arch).reduced(d_model=64, vocab_size=256)
    m = tapi.build_model(cfg)
    g = torch.Generator().manual_seed(gen_seed)
    params = m.init(g, "cpu")
    lora = tree_map(lambda x: x + 0.02 * torch.randn(x.shape, generator=g),
                    init_lora(params, g, LoRAConfig(rank=8),
                              targets=cfg.lora_targets))
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=g)
    leaves = tree_map(lambda x: x.requires_grad_(True), lora)
    dispatch.reset_stats()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "apply_stack", functools.partial(
            ttransformer.apply_stack, remat=remat))
        loss, _ = m.loss(params, {"tokens": toks},
                         adapters=AdapterSet(lora=leaves, gamma=2.0))
        fwd = dispatch.stats["lora_matmul"]
        grads = torch.autograd.grad(loss, tree_leaves(leaves))
    return loss.detach(), grads, fwd, dispatch.stats["lora_matmul"]


@pytest.mark.parametrize("arch", ["gemma-2b", "llama2-7b", "roberta-large"])
def test_switches_leave_results_unchanged_off_a_mesh(arch):
    """Off a mesh: with no remat (``apply_stack(remat=False)``) each
    adapted projection runs once; the default remat of every repeat unit
    and ``remat_dots`` recompute every unit's projections in the backward
    (the adapted projections run twice) and give the same loss and
    gradients bit for bit; ``seq_parallel_residual`` and
    ``seq_parallel_attn`` are the identity; ``expand_kv`` gives the same
    loss bit for bit and the same gradients but for the order in which
    the repeated heads' K/V gradients are summed (gemma-2b's MQA: one KV
    head for four; within 1e-6 x max |grad|)."""
    loss, grads, fwd, total = _loss_and_grads(arch, remat=False)
    assert total == fwd
    for name in (None, "remat_dots", "seq_parallel_residual",
                 "seq_parallel_attn", "expand_kv"):
        topts.set_opts([name] if name else [])
        got_loss, got, got_fwd, got_total = _loss_and_grads(arch)
        topts.reset()
        assert torch.equal(got_loss, loss), name
        assert got_fwd == fwd
        assert got_total == 2 * fwd, name
        for a, b in zip(got, grads, strict=True):
            if name == "expand_kv":
                torch.testing.assert_close(
                    a, b, rtol=0, atol=1e-6 * float(b.abs().max()))
            else:
                assert torch.equal(a, b), name
