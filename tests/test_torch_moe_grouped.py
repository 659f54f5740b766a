"""The grouped MoE dispatch (``moe_grouped``: ``models/moe.
moe_apply_grouped``) against the JAX package's ``_moe_apply_grouped`` on
the CPU, qwen2-moe and granite-moe reduced, at a capacity factor that
makes full experts drop tokens.

Tolerances: the forward and its input gradient within rtol 1e-5 / atol
1e-6 (fp32 on both sides; the router's einsum and the expert matmuls sum
in another order, and a dropped token is dropped on both sides because
the routing is compared first and must be equal); one federated round of
the trainer within the port's trajectory bound 1e-4 x max(1, |ref|)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jconfigs                          # noqa: E402
from repro.configs import base as jbase                        # noqa: E402
from repro.core import federated as jfed                       # noqa: E402
from repro.data import synthetic as jsyn                       # noqa: E402
from repro.models import api as japi                           # noqa: E402
from repro.models import moe as jmoe                           # noqa: E402
from repro.sharding import opts as jopts                       # noqa: E402
from repro_torch import configs as tconfigs                    # noqa: E402
from repro_torch.configs import base as tbase                  # noqa: E402
from repro_torch.core import federated as tfed                 # noqa: E402
from repro_torch.data import synthetic as tsyn                 # noqa: E402
from repro_torch.models import api as tapi                     # noqa: E402
from repro_torch.models import moe as tmoe                     # noqa: E402
from repro_torch.sharding import opts as topts                 # noqa: E402
from repro_torch.tree import tree_leaves                        # noqa: E402

ARCHS = ("qwen2-moe-a2.7b", "granite-moe-1b-a400m")
TRAJ_RTOL = 1e-4
CAPACITY = 0.5          # per-row capacity 8 slots for 16 x 2 assignments


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


def _cfgs(arch, cf=CAPACITY):
    def cut(c):
        return dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=cf))
    return (cut(jconfigs.get_config(arch).reduced(d_model=64,
                                                  vocab_size=256)),
            cut(tconfigs.get_config(arch).reduced(d_model=64,
                                                  vocab_size=256)))


def _moe_inputs(jcfg, seed):
    params = jmoe.moe_params(jcfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 16, jcfg.d_model)).astype(np.float32)
    return params, x


def _torch(params):
    return {k: torch.from_numpy(np.asarray(v).copy())
            for k, v in params.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_dispatch_matches_jax(arch):
    """Routing, output, aux loss and the input gradient equal JAX's
    grouped dispatch, with tokens dropped per row."""
    jcfg, tcfg = _cfgs(arch)
    params, x = _moe_inputs(jcfg, 3)
    grouped = jax.jit(lambda p, v: jmoe._moe_apply_grouped(jcfg, p, v))
    jout, jaux = grouped(params, jnp.asarray(x))
    r = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    jgx = jax.jit(jax.grad(lambda v: jnp.sum(grouped(params, v)[0] * r)))(
        jnp.asarray(x))
    tp = _torch(params)
    tx = torch.from_numpy(x).requires_grad_(True)
    b, s, d = x.shape
    _, _, top_i = tmoe.route(tcfg, tp, tx.detach().reshape(b * s, d))
    _, jtop = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x).reshape(b * s, d) @ params["router"], -1),
        jcfg.moe.top_k)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jtop))
    topts.set_opts(["moe_grouped"])
    out, aux = tmoe.moe_apply(tcfg, tp, tx)
    gx, = torch.autograd.grad((out * torch.from_numpy(r)).sum(), tx)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-6)
    # full experts dropped tokens: each row routes 32 assignments to 4
    # experts of 8 slots
    per_row = torch.nn.functional.one_hot(top_i.reshape(b, s * 2), 4).sum(1)
    assert int(per_row.max()) > tmoe.capacity(tcfg, s)


@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_differs_from_flat_only_where_capacity_drops(arch):
    """The grouped and flat dispatches agree where no expert overflows
    (a large capacity) and differ where capacity drops tokens; a replayed
    routing (``top_i=``) gives the grouped path's own result bit for bit."""
    for cf, same in ((8.0, True), (CAPACITY, False)):
        _, tcfg = _cfgs(arch, cf)
        params, x = _moe_inputs(_cfgs(arch, cf)[0], 5)
        tp, tx = _torch(params), torch.from_numpy(x)
        flat, faux = tmoe.moe_apply(tcfg, tp, tx)
        topts.set_opts(["moe_grouped"])
        grouped, gaux = tmoe.moe_apply(tcfg, tp, tx)
        b, s, d = x.shape
        _, _, top_i = tmoe.route(tcfg, tp, tx.reshape(b * s, d))
        replay, _ = tmoe.moe_apply(tcfg, tp, tx, top_i=top_i)
        topts.reset()
        assert torch.equal(replay, grouped)
        assert torch.equal(faux, gaux)       # the aux loss reads routing only
        diff = float((grouped - flat).abs().max())
        if same:
            assert diff <= 1e-5
        else:
            assert diff > 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_training_round_matches_jax(arch):
    """One federated round (4 clients, 2 local steps) with ``moe_grouped``
    on in both packages: the JAX trainer's loss, grad-norm and adapters
    within TRAJ_RTOL."""
    jcfg, tcfg = _cfgs(arch)
    jopts.set_opts(["moe_grouped"])
    topts.set_opts(["moe_grouped"])
    jm = japi.build_model(jcfg)
    params = jm.init(jax.random.key(0))
    kw = dict(seq_len=16, batch_per_client=2, seed=0)
    lcfg = dict(rank=8, alpha=8.0, scaling="sfedlora",
                targets=jcfg.lora_targets)
    fcfg = dict(num_clients=4, local_steps=2, aggregation="fedsa")
    jtr = jfed.FederatedTrainer(
        jm, jsyn.FederatedDataset(jcfg.vocab_size, 4, **kw),
        lora_cfg=jbase.LoRAConfig(**lcfg),
        fed_cfg=jbase.FederatedConfig(**fcfg),
        opt_cfg=jbase.OptimizerConfig(name="sgd", lr=0.5), seed=0,
        base_params=params)
    ttr = tfed.FederatedTrainer(
        tapi.build_model(tcfg), tsyn.FederatedDataset(tcfg.vocab_size, 4,
                                                      **kw),
        lora_cfg=tbase.LoRAConfig(**lcfg),
        fed_cfg=tbase.FederatedConfig(**fcfg),
        opt_cfg=tbase.OptimizerConfig(name="sgd", lr=0.5), seed=0,
        base_params=jax.tree.map(np.asarray, params),
        lora_init=jax.tree.map(lambda x: np.asarray(x[0]), jtr.lora),
        device="cpu")
    jtr.run(1)
    ttr.run(1)
    (jh,), (th,) = jtr.history, ttr.history
    for key in ("loss", "grad_norm"):
        assert abs(th[key] - jh[key]) <= TRAJ_RTOL * max(1.0, abs(jh[key]))
    for got, want in zip(tree_leaves(ttr.lora), jax.tree.leaves(jtr.lora),
                         strict=True):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=TRAJ_RTOL * max(1.0, float(np.abs(want).max())))
