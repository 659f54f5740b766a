"""Training the RG-LRU hybrid (recurrentgemma) in repro_torch against the JAX
package on the CPU, and the hybrid over a packed int8 / int4 base.

  * ``RGLRUScan``, the differentiable scan (#15 forward, its hand-written
    backward on the card; here their plain versions): its forward equals
    ``rglru_scan_plain``, its backward autograd through the plain loop
    written out here, and ``jax`` gradients of ``ref.rglru_scan_ref`` (the
    sequential reference) and of ``models.rglru.rglru_scan``
    (``associative_scan``), with and without an initial state; strided and
    expanded cotangents, inputs without a gradient, and the tier kept from
    the forward to the backward.
  * The reduced hybrid's loss and LoRA gradients at q, v, wx and wy against
    ``jax.value_and_grad`` of the JAX model.
  * ``FederatedTrainer`` on the reduced hybrid against the JAX trainer, 3
    rounds: fedsa + sfedlora under SGD and AdamW, RoLoRA, mixed ranks
    (4, 8), and over int8 and int4 bases packed to the same bytes.
  * Checkpoints both ways, and a resumed round bit for bit.
  * Greedy and scheduled tokens of the packed hybrid against the JAX
    package's.

Inputs are drawn with numpy from a seed; JAX-drawn weights are carried
across with ``params_from_numpy``.  Tolerances, with their reason: fp32 on
both sides, the sums taken in another order (the JAX model scans with
``associative_scan``, a log-depth order, the port sequentially), so 1e-4
relative (trajectories: 1e-4 x max(1, |ref|), as in
``tests/test_torch_train.py``).  The Function against autograd through the
same loop: 1e-6.  In bf16 the backward reads the stored (bf16-rounded)
h_{t-1} where autograd and JAX read the fp32 carry, so da may sit one bf16
step (2^-7 of |ref|) away.  No kernel launches on the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.checkpoint import io as jio                         # noqa: E402
from repro.configs import base as jbase                        # noqa: E402
from repro.core import federated as jfed                       # noqa: E402
from repro.core import lora as jlora                           # noqa: E402
from repro.core import quant as jquant                         # noqa: E402
from repro.data import synthetic as jsyn                       # noqa: E402
from repro.kernels import ref as jref                          # noqa: E402
from repro.launch import serve as jserve                       # noqa: E402
from repro.models import api as japi                           # noqa: E402
from repro.models import rglru as jrglru                       # noqa: E402
from repro_torch.checkpoint import io as tio                   # noqa: E402
from repro_torch.configs import base as tbase                  # noqa: E402
from repro_torch.core import federated as tfed                 # noqa: E402
from repro_torch.core import lora as tlora                     # noqa: E402
from repro_torch.core import quant as tquant                   # noqa: E402
from repro_torch.data import synthetic as tsyn                 # noqa: E402
from repro_torch.kernels import (bgmv, dispatch, lora_matmul,  # noqa: E402
                                 paged_attention)
from repro_torch.kernels import rglru_scan as tscan            # noqa: E402
from repro_torch.launch import serve as tserve                 # noqa: E402
from repro_torch.models import api as tapi                     # noqa: E402
from repro_torch.models import rglru as trglru                 # noqa: E402
from repro_torch.tree import tree_leaves                       # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its small ops gain nothing
    from more, and the suite's parallel workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-4)
LOOP_TOL = dict(rtol=1e-6, atol=1e-6)
BF16_STEP = 2 ** -7
TRAJ_RTOL = 1e-4
ROUNDS = 3
GROUP = 32
TRIPLE = (("rglru", "rglru", "attn"), 5)   # one repeat + (rglru, rglru) tail
PAIR = (("attn", "rglru"), 4)              # two repeats, no tail
KERNEL_MODULES = (bgmv, lora_matmul, paged_attention, tscan)


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """Every test starts with the launch counts at 0 and, on the CPU, ends
    with them there: no kernel runs here."""
    for mod in KERNEL_MODULES:
        mod.reset_launches()
    yield
    for mod in KERNEL_MODULES:
        assert not any(mod.launches.values()), (mod.__name__, mod.launches)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------- the scan Function

SCAN_SHAPES = [(2, 16, 64), (3, 7, 5), (2, 1, 64)]
SCAN_IDS = ["2x16x64", "ragged-3x7x5", "s=1"]


def _scan_inputs(shape, seed):
    """a in [0.5, 0.999], b, the cotangent g and an initial state h0."""
    rng = np.random.default_rng(seed)
    bt, _, d = shape
    return (rng.uniform(0.5, 0.999, shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal((bt, d)).astype(np.float32))


def _leaves(dtype, *arrs):
    return [torch.from_numpy(x).to(dtype).requires_grad_(True) for x in arrs]


def _loop(a, b):
    """The plain loop written out (fp32 carry, h in a's dtype), for
    autograd to differentiate."""
    af, bf = a.float(), b.float()
    h = torch.zeros_like(af[:, 0])
    out = []
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        out.append(h)
    return torch.stack(out, 1).to(a.dtype)


def _assert_close_bf16(got, want):
    got, want = got.float(), torch.as_tensor(np.asarray(want, np.float32))
    assert bool(((got - want).abs() <= BF16_STEP * want.abs() + 1e-6).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=SCAN_IDS)
def test_scan_function_forward_equals_plain(shape, dtype):
    dt = getattr(torch, dtype)
    a, b, _, _ = _scan_inputs(shape, seed=sum(shape))
    ta, tb = _leaves(dt, a, b)
    h = tscan.RGLRUScan.apply(ta, tb)
    assert h.dtype == dt and h.grad_fn is not None
    assert torch.equal(h.detach(), tscan.rglru_scan_plain(ta.detach(),
                                                          tb.detach()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=SCAN_IDS)
def test_scan_function_backward_matches_autograd_of_the_loop(shape, dtype):
    dt = getattr(torch, dtype)
    a, b, g, _ = _scan_inputs(shape, seed=1 + sum(shape))
    tg = torch.from_numpy(g).to(dt)
    ta, tb = _leaves(dt, a, b)
    tscan.RGLRUScan.apply(ta, tb).backward(tg)
    la, lb = _leaves(dt, a, b)
    _loop(la, lb).backward(tg)
    assert ta.grad.dtype == tb.grad.dtype == dt
    # db_t = dh_t: one chain of the same products and sums on both sides
    torch.testing.assert_close(tb.grad.float(), lb.grad.float(), **LOOP_TOL)
    if dtype == "float32":
        torch.testing.assert_close(ta.grad, la.grad, **LOOP_TOL)
    else:
        _assert_close_bf16(ta.grad, la.grad.float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=SCAN_IDS)
def test_scan_function_backward_matches_jax(shape, dtype):
    """The Function's gradients against jax.vjp of the sequential
    reference and (fp32) of the JAX model's associative scan."""
    dt = getattr(torch, dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    a, b, g, _ = _scan_inputs(shape, seed=2 + sum(shape))
    ta, tb = _leaves(dt, a, b)
    tscan.RGLRUScan.apply(ta, tb).backward(torch.from_numpy(g).to(dt))
    refs = [jref.rglru_scan_ref] + ([jrglru.rglru_scan]
                                    if dtype == "float32" else [])
    for fn in refs:
        _, vjp = jax.vjp(fn, jnp.asarray(a, jdt), jnp.asarray(b, jdt))
        da, db = (np.asarray(x, np.float32)
                  for x in vjp(jnp.asarray(g, jdt)))
        if dtype == "float32":
            np.testing.assert_allclose(ta.grad.numpy(), da, **TOL)
            np.testing.assert_allclose(tb.grad.numpy(), db, **TOL)
        else:
            _assert_close_bf16(ta.grad, da)
            _assert_close_bf16(tb.grad, db)


@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=SCAN_IDS)
def test_model_scan_with_initial_state_matches_jax(shape):
    """``models.rglru.rglru_scan`` with h0 (folded into b[:, 0] outside the
    Function): gradients of a, b and h0 against both JAX scans."""
    a, b, g, h0 = _scan_inputs(shape, seed=3 + sum(shape))
    ta, tb, th0 = _leaves(torch.float32, a, b, h0)
    trglru.rglru_scan(ta, tb, th0).backward(torch.from_numpy(g))
    for fn in (jref.rglru_scan_ref, jrglru.rglru_scan):
        want, vjp = jax.vjp(fn, *map(jnp.asarray, (a, b, h0)))
        np.testing.assert_allclose(
            trglru.rglru_scan(*(torch.from_numpy(x) for x in (a, b, h0)))
            .numpy(), np.asarray(want), **TOL)
        for got, w in zip((ta.grad, tb.grad, th0.grad),
                          vjp(jnp.asarray(g))):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("form", ["transposed", "expanded", "last-step"])
def test_scan_function_takes_a_cotangent_that_is_not_contiguous(form):
    """A strided g (a transposed buffer), an expanded one (the gradient of
    a sum) and the gradient of ``h[:, -1]``: each equals the same
    cotangent handed over contiguous."""
    a, b, g, _ = _scan_inputs((3, 9, 12), seed=7)
    ta, tb = _leaves(torch.float32, a, b)
    h = tscan.RGLRUScan.apply(ta, tb)
    if form == "transposed":
        g_nc = torch.from_numpy(g).transpose(1, 2).contiguous().transpose(1, 2)
        assert not g_nc.is_contiguous()
        h.backward(g_nc)
        g_c = torch.from_numpy(g)
    elif form == "expanded":
        h.sum().backward()
        g_c = torch.ones(3, 9, 12)
    else:
        h[:, -1].sum().backward()
        g_c = torch.zeros(3, 9, 12)
        g_c[:, -1] = 1.0
    da, db = tscan.rglru_scan_bwd_plain(ta.detach(), h.detach(), g_c)
    assert torch.equal(ta.grad, da) and torch.equal(tb.grad, db)


@pytest.mark.parametrize("needs", ["a", "b", "neither"])
def test_scan_function_honours_needs_input_grad(needs, monkeypatch):
    """With the kernel tier forced (on CPU tensors each wrapper runs its
    plain version), the backward is asked only for the gradients autograd
    needs, returns None for the others, and runs nothing when no input
    needs one."""
    calls = []
    orig = tscan.rglru_scan_bwd
    monkeypatch.setattr(dispatch, "_use_kernel", lambda x: True)
    monkeypatch.setattr(tscan, "rglru_scan_bwd",
                        lambda *a: calls.append(1) or orig(*a))
    a, b, g, _ = _scan_inputs((2, 6, 8), seed=9)
    ta = torch.from_numpy(a).requires_grad_(needs == "a")
    tb = torch.from_numpy(b).requires_grad_(needs == "b")
    h = tscan.RGLRUScan.apply(ta, tb)
    if needs == "neither":
        assert h.grad_fn is None and not calls
        return
    h.backward(torch.from_numpy(g))
    da, db = tscan.rglru_scan_bwd_plain(ta.detach(), h.detach(),
                                        torch.from_numpy(g))
    want, other = ((ta, da), tb) if needs == "a" else ((tb, db), ta)
    assert torch.equal(want[0].grad, want[1]) and other.grad is None
    assert len(calls) == 1


@pytest.mark.parametrize("forward_plain", [True, False])
def test_scan_function_keeps_the_forwards_tier(forward_plain, monkeypatch):
    """The tier is chosen once, in the forward, and kept for the backward:
    a forward under ``plain_tier()`` takes the plain backward outside it,
    and a kernel-tier forward the kernel's backward inside it."""
    calls = {"rglru_scan": 0, "rglru_scan_bwd": 0}

    def counted(name):
        orig = getattr(tscan, name)

        def fn(*args):
            calls[name] += 1
            return orig(*args)
        return fn

    monkeypatch.setattr(dispatch, "_use_kernel",
                        lambda x: not dispatch._plain.get())
    for name in calls:
        monkeypatch.setattr(tscan, name, counted(name))
    a, b, g, _ = _scan_inputs((2, 5, 4), seed=11)
    ta, tb = _leaves(torch.float32, a, b)
    if forward_plain:
        with dispatch.plain_tier():
            h = tscan.RGLRUScan.apply(ta, tb)
        h.backward(torch.from_numpy(g))
        assert calls == {"rglru_scan": 0, "rglru_scan_bwd": 0}
    else:
        h = tscan.RGLRUScan.apply(ta, tb)
        with dispatch.plain_tier():
            h.backward(torch.from_numpy(g))
        assert calls == {"rglru_scan": 1, "rglru_scan_bwd": 1}


def test_scan_backward_wrapper_checks_its_operands():
    a = torch.rand(2, 3, 4)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tscan.rglru_scan_bwd(a.to("meta"), a.to("meta"), a.to("meta"))
    assert [t.shape for t in tscan.rglru_scan_bwd(a, a, a)] == [a.shape] * 2


# ----------------------------------------------------- the hybrid's loss

def _cfgs(pattern, num_layers, **kw):
    base = dict(name="hybrid", family="hybrid", num_layers=num_layers,
                d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
                d_ff=128, vocab_size=96, mlp_variant="geglu",
                block_pattern=pattern, attn_window=8, rglru_d_state=64,
                lora_targets=("q", "v", "wx", "wy"))
    base.update(kw)
    return jbase.ModelConfig(**base), tbase.ModelConfig(**base)


@pytest.fixture(scope="module")
def hybrid():
    """(jax config, port config, jax model, jax params) of a reduced
    hybrid, keyed by (pattern, layers)."""
    out = {}

    def get(pattern, num_layers):
        key = (pattern, num_layers)
        if key not in out:
            jcfg, tcfg = _cfgs(pattern, num_layers)
            jm = japi.build_model(jcfg)
            out[key] = (jcfg, tcfg, jm, jm.init(jax.random.key(0)))
        return out[key]
    return get


@pytest.mark.parametrize("layout", [TRIPLE, PAIR], ids=["triple", "pair"])
def test_hybrid_loss_and_lora_grads_match_jax(hybrid, layout):
    jcfg, tcfg, jm, jparams = hybrid(*layout)
    tm = tapi.build_model(tcfg)
    tparams = tio.params_from_numpy(_np(jparams), "cpu")
    rng = np.random.default_rng(3)
    lcfg = jbase.LoRAConfig(rank=4, targets=jcfg.lora_targets)
    lora = jlora.init_lora(jparams, jax.random.key(1), lcfg)
    # nonzero B, so the gradients of A are not zero
    lora = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
        x.shape).astype(np.float32), lora)
    toks = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    gamma = 2.0

    def jloss(l):
        return jm.loss(jparams, {"tokens": jnp.asarray(toks)},
                       adapters=jlora.AdapterSet(lora=l, gamma=gamma))[0]

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, lora))
    leaves = tio.params_from_numpy(lora, "cpu")
    for t in tree_leaves(leaves):
        t.requires_grad_(True)
    dispatch.reset_stats()
    tl, _ = tm.loss(tparams, {"tokens": torch.from_numpy(toks)},
                    adapters=tlora.AdapterSet(lora=leaves, gamma=gamma))
    # q, v in the attention layers and wx, wy in the RG-LRU ones
    assert dispatch.stats["lora_matmul"] == 2 * tcfg.num_layers
    grads = torch.autograd.grad(tl, tree_leaves(leaves))
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    names = set()
    for got, want in zip(grads, jax.tree.leaves(jg)):
        want = np.asarray(want)
        assert float(np.abs(want).max()) > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * float(
                                       np.abs(want).max()))
    for path in _paths(leaves):
        names.add(path[-2])
    assert names == {"q", "v", "wx", "wy"}


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    else:
        yield path


# --------------------------------------------------- the trainer vs JAX

def _trainers(hybrid, *, strategy="fedsa", scaling="sfedlora",
              optimizer="sgd", ranks=None, mode=None, n=2):
    """The JAX and the port trainer on the reduced hybrid (TRIPLE), from
    the JAX trainer's adapter draw, over the JAX-drawn base or (``mode``)
    that base packed by both packages to the same bytes."""
    jcfg, tcfg, jm, jparams = hybrid(*TRIPLE)
    jbase_params = jparams
    tbase_params = tio.params_from_numpy(_np(jparams), "cpu")
    if mode is not None:
        jbase_params = jquant.quantize_tree(jparams, mode, GROUP)
        tbase_params = tquant.quantize_tree(tbase_params, mode, GROUP)
        for t, j in zip(tree_leaves(tbase_params),
                        jax.tree.leaves(jbase_params)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    lcfg = dict(rank=max(ranks) if ranks else 8, ranks=ranks, alpha=8.0,
                scaling=scaling, targets=jcfg.lora_targets)
    fcfg = dict(num_clients=n, local_steps=2, aggregation=strategy)
    # SGD at lr 0.2: at 0.5 the hybrid's loss rises by round 3 and the
    # run amplifies fp32 rounding (5e-7 after round 1) some 30x a round
    ocfg = dict(name=optimizer, lr=0.2 if optimizer == "sgd" else 0.01)
    ds_kw = dict(seq_len=16, batch_per_client=2, seed=0)
    jtr = jfed.FederatedTrainer(
        jm, jsyn.FederatedDataset(jcfg.vocab_size, n, **ds_kw),
        lora_cfg=jbase.LoRAConfig(**lcfg),
        fed_cfg=jbase.FederatedConfig(**fcfg),
        opt_cfg=jbase.OptimizerConfig(**ocfg), seed=0,
        base_params=jbase_params)
    full = ranks.index(max(ranks)) if ranks else 0
    lora1 = jax.tree.map(lambda x: np.asarray(x[full]), jtr.lora)
    ttr = tfed.FederatedTrainer(
        tapi.build_model(tcfg),
        tsyn.FederatedDataset(tcfg.vocab_size, n, **ds_kw),
        lora_cfg=tbase.LoRAConfig(**lcfg),
        fed_cfg=tbase.FederatedConfig(**fcfg),
        opt_cfg=tbase.OptimizerConfig(**ocfg), seed=0,
        base_params=tbase_params, lora_init=lora1, device="cpu")
    assert ttr.gamma == jtr.gamma
    return jtr, ttr


def _assert_same_run(jtr, ttr, rounds=ROUNDS):
    assert len(ttr.history) == len(jtr.history) == rounds
    for th, jh in zip(ttr.history, jtr.history):
        assert th["round"] == jh["round"]
        for key in ("loss", "grad_norm"):
            assert abs(th[key] - jh[key]) <= TRAJ_RTOL * max(
                1.0, abs(float(jh[key]))), (key, th, jh)
    for got, want in zip(tree_leaves(ttr.lora), jax.tree.leaves(jtr.lora)):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=TRAJ_RTOL * max(1.0, float(np.abs(want).max())))


TRAINER_CASES = {
    "fedsa-sfedlora-sgd": {},
    "fedsa-sfedlora-adamw": {"optimizer": "adamw"},
    "rolora-lora": {"strategy": "rolora", "scaling": "lora"},
    "mixed-ranks-4-8": {"ranks": (4, 8)},
    "int8": {"mode": "int8"},
    "int4": {"mode": "int4"},
}


@pytest.mark.parametrize("case", list(TRAINER_CASES))
def test_hybrid_trainer_trajectory_matches_jax(hybrid, case):
    jtr, ttr = _trainers(hybrid, **TRAINER_CASES[case])
    jtr.run(ROUNDS)
    dispatch.reset_stats()
    ttr.run(ROUNDS)
    # every adapted projection of every local step took the LoRA Function
    # (on the dequantized W over a packed base): q, v in the 1 attention
    # layer, wx, wy in the 4 RG-LRU layers; the backward recomputes the
    # repeat unit's 3 layers (the 2 tail layers run once)
    assert dispatch.stats["lora_matmul"] == 2 * (5 + 3) * 2 * 2 * ROUNDS
    assert dispatch.stats["quant"] == 0
    _assert_same_run(jtr, ttr)
    b_max = max(float(t.abs().max()) for t in tree_leaves(
        tlora.split_ab(ttr.lora)[1]))
    assert b_max > 0, "B stayed zero: no training happened"


# ---------------------------------------------------------- checkpoints

def test_port_checkpoint_of_the_hybrid_loads_in_jax(hybrid, tmp_path):
    """The hybrid adapter tree (q, v under the repeat's attention layer;
    wx, wy under its RG-LRU layers and the tail) in the JAX package's flat
    keys, with the optimizer state, round and data streams."""
    _, ttr = _trainers(hybrid, optimizer="adamw")
    ttr.run(1)
    path = str(tmp_path / "port.npz")
    ttr.save(path)
    base, lora, opt, rnd, key, data_state, _ = \
        jio.load_federated_state(path, full=True)
    assert rnd == 1 and key is None
    assert data_state == ttr.dataset.rng_state()
    assert set(lora["stack"]["tail"]["t0"]["rglru"]) == {"wx", "wy"}
    for tree, want in ((base, ttr.base), (lora, ttr.lora),
                       (opt, ttr.opt_state)):
        got = jax.tree.leaves(tree)
        assert len(got) == len(tree_leaves(want))
        for g, w in zip(got, tree_leaves(want)):
            np.testing.assert_array_equal(np.asarray(g), w.numpy())


def test_jax_checkpoint_of_the_hybrid_resumes_in_the_port(hybrid, tmp_path):
    jtr, ttr = _trainers(hybrid, optimizer="adamw")
    jtr.run(2)
    path = str(tmp_path / "jax.npz")
    jtr.save(path)
    ttr.restore(path)
    assert ttr.round_idx == 2
    jtr.run(1)
    ttr.run(1)
    assert ttr.history[-1]["round"] == jtr.history[-1]["round"] == 3
    for key in ("loss", "grad_norm"):
        assert abs(ttr.history[-1][key] - jtr.history[-1][key]) <= \
            TRAJ_RTOL * max(1.0, abs(float(jtr.history[-1][key])))
    for got, want in zip(tree_leaves(ttr.lora), jax.tree.leaves(jtr.lora)):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=TRAJ_RTOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("mode", [None, "int4"], ids=["fp32", "int4"])
def test_hybrid_resume_is_bit_exact(hybrid, tmp_path, mode):
    """Save after round 2, restore into a fresh trainer, run round 3: the
    trajectory, adapters and optimizer state equal a 3-round run's bit for
    bit."""
    _, ttr = _trainers(hybrid, mode=mode, optimizer="adamw")
    _, fresh = _trainers(hybrid, mode=mode, optimizer="adamw")
    ttr.run(2)
    path = str(tmp_path / "port.npz")
    ttr.save(path)
    ttr.run_round()
    fresh.restore(path)
    assert fresh.round_idx == 2
    fresh.run_round()
    assert fresh.history[-1] == ttr.history[-1]
    for t1, t2 in zip(tree_leaves(fresh.lora), tree_leaves(ttr.lora)):
        assert torch.equal(t1, t2)
    for t1, t2 in zip(tree_leaves(fresh.opt_state),
                      tree_leaves(ttr.opt_state)):
        assert torch.equal(t1, t2)


# --------------------------------------------- serving over a packed base

def _packed_serving(hybrid, mode, layout):
    """The JAX model over its packed base and the port's over the same
    bytes, and twin adapter banks of ranks 4 and 8 with nonzero B."""
    jcfg, tcfg, jm, jparams = hybrid(*layout)
    jq = jquant.quantize_tree(jparams, mode, GROUP)
    tq = tquant.quantize_tree(tio.params_from_numpy(_np(jparams), "cpu"),
                              mode, GROUP)
    rng = np.random.default_rng(5)
    jsets, tsets = [], []
    for i, r in enumerate((4, 8)):
        js = jlora.init_adapter_set(
            jparams, jax.random.key(30 + i),
            jbase.LoRAConfig(rank=r, alpha=8.0, targets=jcfg.lora_targets),
            n_clients=2)
        lora = jax.tree.map(lambda x: x + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32), _np(js.lora))
        jsets.append(dataclasses.replace(
            js, lora=jax.tree.map(jnp.asarray, lora)))
        tsets.append(tlora.AdapterSet(lora=tio.params_from_numpy(lora, "cpu"),
                                      gamma=js.gamma, rank=r, alpha=js.alpha))
    return (jm, jq, jlora.AdapterBank.from_sets(jsets),
            tapi.build_model(tcfg), tq, tlora.AdapterBank.from_sets(tsets))


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("layout", [TRIPLE, PAIR], ids=["triple", "pair"])
def test_packed_hybrid_greedy_tokens_match_jax(hybrid, mode, layout):
    jm, jq, jbank, tm, tq, tbank = _packed_serving(hybrid, mode, layout)
    prompt = np.random.default_rng(7).integers(0, 96, (2, 5)).astype(
        np.int32)
    ids = np.array([1, 0], np.int32)
    want = np.asarray(jserve.generate_banked(jm, jq, jbank, jnp.asarray(ids),
                                             jnp.asarray(prompt), 10, 15))
    got = tserve.generate_banked(tm, tq, tbank, ids,
                                 torch.from_numpy(prompt), 10, 15)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_packed_hybrid_scheduled_tokens_match_jax(hybrid, mode):
    """4 banked requests through 2 slots of the recurrentgemma pattern
    over a packed base: the port's scheduler emits the JAX scheduler's
    tokens."""
    jm, jq, jbank, tm, tq, tbank = _packed_serving(hybrid, mode, TRIPLE)
    prompts = np.random.default_rng(8).integers(0, 96, (4, 6)).astype(
        np.int32)
    ids = [0, 1, 1, 0]
    kw = dict(max_batch=2, block_size=4, chunk=4, max_len=15)
    jdone = jserve.serve_scheduled(
        jm, jq, [jserve.Request(rid=i, prompt=prompts[i], steps=9,
                                adapter_id=ids[i]) for i in range(4)],
        bank=jbank, wait=False, **kw)
    tdone = tserve.serve_scheduled(
        tm, tq, [tserve.Request(rid=i, prompt=prompts[i], steps=9,
                                adapter_id=ids[i]) for i in range(4)],
        bank=tbank, wait=False, **kw)
    np.testing.assert_array_equal(
        np.stack([np.asarray(r.tokens) for r in tdone]),
        np.stack([np.asarray(r.tokens) for r in jdone]))
