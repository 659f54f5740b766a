"""repro_torch's LoRA training over a packed (int8 / int4) frozen base against
the JAX package, on the CPU; and the trainer's save / resume.

  * ``LoRAMatmulQuant`` (#9 forward; #10, #7, #8 backward) and
    ``QuantMatmul`` (#11; #12) on their plain pieces against the JAX
    package's ``lora_matmul_quant_vjp`` / ``quant_matmul_vjp`` (Pallas in
    interpret mode): outputs and gradients.
  * A ragged k (int4 padding rows) against the fp Function over
    ``dequantize(W)``.
  * The route: with the kernel tier forced on CPU tensors (the card's
    wiring, each wrapper taking its plain version), one loss backward over a
    packed base reaches #9, #10, #7, #8, #11 and #12 and never #5 / #6.
  * ``FederatedTrainer`` over ``quantize_tree`` of one numpy fp base against
    the JAX trainer over the same bytes, 3 rounds; the train CLI's
    ``--quant`` starts from the fp run's adapters.
  * Save / resume: the port's resume is bit-exact; a JAX checkpoint resumes
    in the port; a port checkpoint loads in the JAX package.

Tolerances, with their reason: fp32 on both sides, the sums taken in another
order.  The Functions use the JAX package's own kernel bounds
(``tests/test_quant.py``: rtol 2e-5, atol 2e-4); the ragged case compares
two wirings of the same plain pieces over the same dequantized W (1e-6);
trajectories and adapters as ``tests/test_torch_train.py`` (1e-4)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jconfigs                          # noqa: E402
from repro.checkpoint import io as jio                         # noqa: E402
from repro.configs import base as jbase                        # noqa: E402
from repro.core import federated as jfed                       # noqa: E402
from repro.core import quant as jquant                         # noqa: E402
from repro.data import synthetic as jsyn                       # noqa: E402
from repro.kernels.lora_matmul import (lora_matmul_quant_vjp,  # noqa: E402
                                       quant_matmul_vjp)
from repro.models import api as japi                           # noqa: E402
from repro_torch import configs as tconfigs                    # noqa: E402
from repro_torch.checkpoint import io as tio                   # noqa: E402
from repro_torch.configs import base as tbase                  # noqa: E402
from repro_torch.core import federated as tfed                 # noqa: E402
from repro_torch.core import lora as tlora                     # noqa: E402
from repro_torch.core import quant as tquant                   # noqa: E402
from repro_torch.data import synthetic as tsyn                 # noqa: E402
from repro_torch.kernels import dispatch, lora_matmul          # noqa: E402
from repro_torch.launch import train as ttrain                 # noqa: E402
from repro_torch.models import api as tapi                     # noqa: E402
from repro_torch.tree import tree_leaves, tree_map             # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its small ops gain nothing
    from more, and the suite's parallel workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FN_TOL = dict(rtol=2e-5, atol=2e-4)


@pytest.fixture(autouse=True)
def _clean_counters():
    """The launch counts start at 0: the CPU-tier tests assert none."""
    lora_matmul.reset_launches()
RAGGED_TOL = dict(rtol=1e-6, atol=1e-6)
TRAJ_RTOL = 1e-4
ROUNDS = 3
GROUP = 64


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _operands(m, k, n, r, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32),
            (rng.standard_normal((r, k)) * 0.05).astype(np.float32),
            (rng.standard_normal((n, r)) * 0.05).astype(np.float32),
            rng.standard_normal((m, n)).astype(np.float32))


def _packed(w, bits):
    """One fp32 W packed by both packages: the JAX QuantizedLinear and the
    port's, whose bytes are asserted equal."""
    jq = jquant.quantize(jnp.asarray(w), bits, GROUP)
    tq = tquant.quantize(torch.from_numpy(w), bits, GROUP)
    np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    return jq, tq


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _lora_quant(tx, tq, ta, tb, gamma):
    return lora_matmul.LoRAMatmulQuant.apply(
        tx, tq.data, tq.scales, ta, tb, lora_matmul.packed_meta(tq), gamma,
        False)


def _requires_grad(*arrs):
    return [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrs]


# --------------------------------------------------- the Functions vs JAX

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n,r", [(64, 128, 64, 4), (64, 192, 128, 8)])
def test_lora_matmul_quant_matches_jax(bits, m, k, n, r):
    x, w, a, b, g = _operands(m, k, n, r, seed=bits + k)
    jq, tq = _packed(w, bits)
    gamma = 1.5
    y_want, vjp = jax.vjp(
        lambda x_, a_, b_: lora_matmul_quant_vjp(
            x_, jq.data, jq.scales, a_, b_, gamma, bits=bits, bm=64, bn=64,
            bk=64, interpret=True),
        *map(jnp.asarray, (x, a, b)))
    dx_want, da_want, db_want = vjp(jnp.asarray(g))
    tx, ta, tb = _requires_grad(x, a, b)
    y = _lora_quant(tx, tq, ta, tb, gamma)
    assert y.dtype == torch.float32 and y.grad_fn is not None
    y.backward(torch.from_numpy(g))
    _close(y, y_want, FN_TOL)
    _close(tx.grad, dx_want, FN_TOL)
    _close(ta.grad, da_want, FN_TOL)
    _close(tb.grad, db_want, FN_TOL)
    assert not any(lora_matmul.launches.values())


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_function_matches_jax(bits):
    x, w, _, _, g = _operands(64, 128, 64, 1, seed=20 + bits)
    jq, tq = _packed(w, bits)
    y_want, vjp = jax.vjp(
        lambda x_: quant_matmul_vjp(x_, jq.data, jq.scales, bits=bits, bm=64,
                                    bn=64, bk=64, interpret=True),
        jnp.asarray(x))
    (dx_want,) = vjp(jnp.asarray(g))
    (tx,) = _requires_grad(x)
    y = lora_matmul.QuantMatmul.apply(tx, tq.data, tq.scales,
                                      lora_matmul.packed_meta(tq), False)
    y.backward(torch.from_numpy(g))
    _close(y, y_want, FN_TOL)
    _close(tx.grad, dx_want, FN_TOL)


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_ragged_quant_functions_match_fp_over_dequantized_w(bits, w_dtype):
    """k = 100 with int4 groups of 64 (kq = 128: 28 padding rows), m, n and
    r that no tile divides, over a base packed from fp32 or bf16 weights:
    the packed Functions against the fp ones over ``dequantize(W)``."""
    x, w, a, b, g = _operands(37, 100, 30, 3, seed=5 + bits)
    tq = tquant.quantize(torch.from_numpy(w).to(getattr(torch, w_dtype)),
                         bits, GROUP)
    wf = tq.dequantize().float()
    tx, ta, tb = _requires_grad(x, a, b)
    y = _lora_quant(tx, tq, ta, tb, 1.3)
    y.backward(torch.from_numpy(g))
    rx, ra, rb = _requires_grad(x, a, b)
    y_ref = lora_matmul.LoRAMatmul.apply(rx, wf, ra, rb, 1.3, False)
    y_ref.backward(torch.from_numpy(g))
    for got, want in ((y, y_ref), (tx.grad, rx.grad), (ta.grad, ra.grad),
                      (tb.grad, rb.grad)):
        _close(got, want.detach().numpy(), RAGGED_TOL)
    (qx,) = _requires_grad(x)
    yq = lora_matmul.QuantMatmul.apply(qx, tq.data, tq.scales,
                                       lora_matmul.packed_meta(tq), False)
    yq.backward(torch.from_numpy(g))
    (fx,) = _requires_grad(x)
    (fx @ wf).backward(torch.from_numpy(g))
    _close(yq, (torch.from_numpy(x) @ wf).numpy(), RAGGED_TOL)
    _close(qx.grad, fx.grad.numpy(), RAGGED_TOL)


def test_packed_functions_refuse_trainable_scales():
    x, w, a, b, _ = _operands(8, 64, 16, 2, seed=1)
    tq = tquant.quantize(torch.from_numpy(w), 4, GROUP)
    scales = tq.scales.clone().requires_grad_(True)
    tx, ta, tb = (torch.from_numpy(t) for t in (x, a, b))
    meta = lora_matmul.packed_meta(tq)
    with pytest.raises(ValueError, match="frozen"):
        lora_matmul.LoRAMatmulQuant.apply(tx, tq.data, scales, ta, tb, meta,
                                          1.0, False)
    with pytest.raises(ValueError, match="frozen"):
        lora_matmul.QuantMatmul.apply(tx, tq.data, scales, meta, False)


# ------------------------------------------------------------- the route

@pytest.fixture(scope="module")
def small():
    """A narrow reduced gemma-2b (2 layers, d_model 64, vocab 256) and its
    JAX-drawn fp base."""
    jcfg = jconfigs.get_config("gemma-2b").reduced(d_model=64, vocab_size=256)
    tcfg = tconfigs.get_config("gemma-2b").reduced(d_model=64, vocab_size=256)
    jm = japi.build_model(jcfg)
    return jcfg, tcfg, jm, jm.init(jax.random.key(0))


def _nonzero_b(node, gen):
    if set(node) == {"a", "b"}:
        return {"a": node["a"],
                "b": torch.randn(node["b"].shape, generator=gen) * 0.05}
    return {k: _nonzero_b(v, gen) for k, v in node.items()}


PIECES = ("lora_fwd", "lora_bwd_dx", "lora_bwd_da", "lora_bwd_db",
          "lora_fwd_quant", "lora_bwd_dx_quant", "quant_matmul",
          "quant_matmul_dx")


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_loss_backward_over_packed_base_takes_the_packed_kernels(
        small, mode, monkeypatch):
    """With the kernel tier forced on CPU tensors, one ``Model.loss``
    backward reaches, per layer, #9, #10, #7 and #8 at q and v, #11 at k,
    o, w_gate, w_up and w_down, and #12 at the same five less layer 0's k
    (its input, the embedding, carries no gradient); #5 and #6 never.  The
    adapter gradients equal the CPU tier's, which dequantizes."""
    _, tcfg, _, jparams = small
    model = tapi.build_model(tcfg)
    base = tquant.quantize_tree(tio.params_from_numpy(_np(jparams), "cpu"),
                                mode, GROUP)
    gen = torch.Generator().manual_seed(1)
    lora = tlora.init_lora(base, gen, tbase.LoRAConfig(rank=4))
    lora = _nonzero_b(lora, gen)               # so that dA is not zero
    tokens = torch.randint(0, tcfg.vocab_size, (2, 12), generator=gen)

    def grads():
        tree = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                        lora)
        loss, _ = model.loss(base, {"tokens": tokens},
                             adapters=tlora.AdapterSet(lora=tree, gamma=2.0))
        loss.backward()
        return loss, [t.grad for t in tree_leaves(tree)]

    want_loss, want = grads()                  # the CPU tier
    calls = dict.fromkeys(PIECES, 0)
    for name in PIECES:
        def counted(*args, _orig=getattr(lora_matmul, name), _name=name):
            calls[_name] += 1
            return _orig(*args)
        monkeypatch.setattr(lora_matmul, name, counted)
    monkeypatch.setattr(dispatch, "_use_kernel", lambda x: True)
    loss, got = grads()
    n_layers = tcfg.num_layers
    # the forwards run twice: in the forward, and in the backward's
    # recompute of each repeat unit (one layer here), which stops once it
    # has what the backward needs, before the unit's last projection
    assert calls == {"lora_fwd": 0, "lora_bwd_dx": 0,
                     "lora_bwd_da": 2 * n_layers, "lora_bwd_db": 2 * n_layers,
                     "lora_fwd_quant": 2 * 2 * n_layers,
                     "lora_bwd_dx_quant": 2 * n_layers,
                     "quant_matmul": 5 * n_layers + 4 * n_layers,
                     "quant_matmul_dx": 5 * n_layers - 1}
    assert not any(lora_matmul.launches.values())      # CPU: no kernel
    assert float(loss.detach()) == pytest.approx(float(want_loss.detach()),
                                              rel=1e-6)
    assert any(float(g.abs().max()) > 0 for g in got)
    for g1, g2 in zip(got, want):
        np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-5,
                                   atol=1e-6)


# ------------------------------------------------- the trainer vs the JAX one

def _trainers(small, mode, *, n=3, participation=1.0, jax_base=None):
    """The JAX and the port trainer over one packed base (the port's bytes
    asserted equal to the JAX package's), from the same adapters."""
    jcfg, tcfg, jm, jparams = small
    jq = jquant.quantize_tree(jparams, mode, GROUP)
    tq = tquant.quantize_tree(tio.params_from_numpy(_np(jparams), "cpu"),
                              mode, GROUP)
    for t, j in zip(tree_leaves(tq), jax.tree.leaves(jq)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    lcfg = dict(rank=8, alpha=8.0, scaling="sfedlora")
    fcfg = dict(num_clients=n, local_steps=2, aggregation="fedsa",
                participation=participation)
    ocfg = dict(name="sgd", lr=0.5)
    ds_kw = dict(seq_len=16, batch_per_client=2, seed=0)
    jtr = jfed.FederatedTrainer(
        jm, jsyn.FederatedDataset(jcfg.vocab_size, n, **ds_kw),
        lora_cfg=jbase.LoRAConfig(**lcfg),
        fed_cfg=jbase.FederatedConfig(**fcfg),
        opt_cfg=jbase.OptimizerConfig(**ocfg), seed=0, base_params=jq)
    lora1 = jax.tree.map(lambda x: np.asarray(x[0]), jtr.lora)
    ttr = tfed.FederatedTrainer(
        tapi.build_model(tcfg),
        tsyn.FederatedDataset(tcfg.vocab_size, n, **ds_kw),
        lora_cfg=tbase.LoRAConfig(**lcfg),
        fed_cfg=tbase.FederatedConfig(**fcfg),
        opt_cfg=tbase.OptimizerConfig(**ocfg), seed=0, base_params=tq,
        lora_init=lora1, device="cpu")
    return jtr, ttr


def _assert_same_run(jtr, ttr, rounds=ROUNDS):
    assert len(ttr.history) == len(jtr.history) == rounds
    for th, jh in zip(ttr.history, jtr.history):
        assert th["round"] == jh["round"]
        for key in ("loss", "grad_norm"):
            assert abs(th[key] - jh[key]) <= TRAJ_RTOL * max(1.0,
                                                             abs(jh[key])), \
                (key, th, jh)
    for got, want in zip(tree_leaves(ttr.lora), jax.tree.leaves(jtr.lora)):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=TRAJ_RTOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_trainer_over_packed_base_matches_jax(small, mode):
    jtr, ttr = _trainers(small, mode)
    jtr.run(ROUNDS)
    dispatch.reset_stats()
    ttr.run(ROUNDS)
    # every adapted projection took the Function, on the dequantized W, in
    # the forward and in the backward's recompute
    assert dispatch.stats["lora_matmul"] == 2 * 2 * small[1].num_layers * 3 \
        * 2 * ROUNDS and dispatch.stats["quant"] == 0
    _assert_same_run(jtr, ttr)
    assert max(float(t.abs().max()) for t in tree_leaves(
        tlora.split_ab(ttr.lora)[1])) > 0, "B stayed zero"


# -------------------------------------------------------------------- CLI

CLI = ["--reduced", "--device", "cpu", "--seq", "16", "--clients", "2"]


def test_cli_quant_starts_from_the_fp_runs_adapters(monkeypatch, capsys):
    """``--quant int4`` trains over ``quantize_tree`` of the base the fp run
    draws, from the adapters the fp run starts from."""
    starts = []

    class Recording(tfed.FederatedTrainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            starts.append((self.base, [t.clone() for t in
                                       tree_leaves(self.lora)]))

    monkeypatch.setattr(ttrain, "FederatedTrainer", Recording)
    fp = ttrain.main(CLI + ["--rounds", "2"])
    q = ttrain.main(CLI + ["--rounds", "2", "--quant", "int4",
                           "--quant-group", "32"])
    out = capsys.readouterr().out.splitlines()
    assert any(line.startswith("# gemma-2b (reduced)") and
               line.endswith("quant=int4") for line in out)
    (fp_base, fp_lora), (q_base, q_lora) = starts
    assert tquant.tree_quant_mode(q_base) == "int4"
    want = tquant.quantize_tree(fp_base, "int4", 32)
    for t1, t2 in zip(tree_leaves(q_base), tree_leaves(want)):
        assert torch.equal(t1, t2)
    for t1, t2 in zip(q_lora, fp_lora):
        assert torch.equal(t1, t2)
    assert len(q.history) == 2 and all(np.isfinite(h["loss"])
                                       for h in q.history)
    assert q.history[0]["loss"] != fp.history[0]["loss"]


def test_cli_save_then_resume_continues_the_run(tmp_path, capsys):
    path = str(tmp_path / "ck.npz")
    full = ttrain.main(CLI + ["--rounds", "3", "--quant", "int8"])
    ttrain.main(CLI + ["--rounds", "2", "--quant", "int8", "--save", path])
    resumed = ttrain.main(CLI + ["--rounds", "1", "--quant", "int8",
                                 "--resume", path])
    out = capsys.readouterr().out
    assert f"# saved -> {path}" in out
    assert f"# resumed from {path} at round 2" in out
    assert resumed.history[-1] == full.history[-1]
    for t1, t2 in zip(tree_leaves(resumed.lora), tree_leaves(full.lora)):
        assert torch.equal(t1, t2)


@pytest.mark.parametrize("flag", [["--quant", "int8"], []],
                         ids=["int8", "none"])
def test_cli_resume_under_another_quant_raises(tmp_path, flag):
    """A checkpoint of an int4 base resumed under another --quant: the fp
    weights are gone, so it raises, as the JAX launcher does."""
    path = str(tmp_path / "ck4.npz")
    ttrain.main(CLI + ["--rounds", "1", "--quant", "int4", "--save", path])
    with pytest.raises(ValueError, match="--quant int4"):
        ttrain.main(CLI + ["--rounds", "1", "--resume", path, *flag])


# ---------------------------------------------------------- save / resume

@pytest.mark.parametrize("mode,participation", [("int4", 1.0),
                                                ("int8", 0.5)])
def test_resume_is_bit_exact(small, tmp_path, mode, participation):
    """Save after round 2, restore into a fresh trainer, run round 3: the
    trajectory and adapters equal the uninterrupted run's bit for bit
    (participation 0.5: the restored generator samples the same
    clients)."""
    _, ttr = _trainers(small, mode, n=4, participation=participation)
    _, fresh = _trainers(small, mode, n=4, participation=participation)
    ttr.run(2)
    path = str(tmp_path / "port.npz")
    ttr.save(path)
    ttr.run_round()
    fresh.restore(path)
    assert fresh.round_idx == 2 and fresh.history == []
    assert tquant.tree_quant_mode(fresh.base) == mode
    fresh.run_round()
    assert fresh.history[-1] == ttr.history[-1]
    for t1, t2 in zip(tree_leaves(fresh.lora), tree_leaves(ttr.lora)):
        assert torch.equal(t1, t2)
    for t1, t2 in zip(tree_leaves(fresh.opt_state),
                      tree_leaves(ttr.opt_state)):
        assert torch.equal(t1, t2)


def test_jax_checkpoint_resumes_in_the_port(small, tmp_path):
    """The JAX trainer saves after round 2 over an int4 base; the port
    restores the file (packed base, adapters, optimizer state, data
    streams) and its round 3 matches the JAX trainer's."""
    jtr, ttr = _trainers(small, "int4")
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
            TRAJ_RTOL * max(1.0, abs(jtr.history[-1][key]))
    for got, want in zip(tree_leaves(ttr.lora), jax.tree.leaves(jtr.lora)):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=TRAJ_RTOL * max(1.0, float(np.abs(want).max())))


def test_port_checkpoint_loads_in_jax(small, tmp_path):
    _, ttr = _trainers(small, "int8")
    ttr.run(1)
    path = str(tmp_path / "port.npz")
    ttr.save(path)
    base, lora, opt, rnd, key, data_state, extras = \
        jio.load_federated_state(path, full=True)
    assert rnd == 1 and key is None
    assert data_state == ttr.dataset.rng_state()
    assert extras["partition_state"] == ttr.dataset.partition_state()
    np.testing.assert_array_equal(extras["adapter_meta"]["gammas"],
                                  np.asarray(ttr.gammas, np.float32))
    assert str(extras["adapter_meta"]["scaling"]) == "sfedlora"
    assert jquant.tree_quant_mode(base) == "int8"
    for tree, want in ((base, ttr.base), (lora, ttr.lora),
                       (opt, ttr.opt_state)):
        got = jax.tree.leaves(tree)
        assert len(got) == len(tree_leaves(want))
        for g, w in zip(got, tree_leaves(want)):
            np.testing.assert_array_equal(np.asarray(g), w.numpy())


def test_jax_checkpoint_with_partial_participation_raises(small, tmp_path):
    """A JAX checkpoint carries a jax.random key, not the port's generator:
    below participation 1 the resumed rounds could not sample the clients
    the JAX run would, so restore refuses it."""
    jtr, ttr = _trainers(small, "int8", n=4, participation=0.5)
    path = str(tmp_path / "jax.npz")
    jtr.save(path)
    with pytest.raises(ValueError, match="jax.random key"):
        ttr.restore(path)


def test_restore_refuses_a_rank_mask(small, tmp_path):
    """A checkpoint of heterogeneous clients (a per-client rank mask)
    raises in a homogeneous trainer: the masks differ (no mask here, one in
    the file)."""
    _, ttr = _trainers(small, "int8")
    path = str(tmp_path / "mask.npz")
    tio.save_pytree(path, {"base": ttr.base, "lora": ttr.lora,
                           "opt": ttr.opt_state, "round": np.asarray(0),
                           "rank_mask": np.ones((3, 8), np.float32)})
    with pytest.raises(ValueError, match="rank mask"):
        ttr.restore(path)
