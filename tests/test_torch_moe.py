"""repro_torch's MoE family against the JAX package, on the CPU.

Four cases share one set of checks: the reduced qwen2-moe-a2.7b (4 experts
top-2, 1 shared expert), the reduced granite-moe-1b-a400m (4 experts
top-2, no shared expert), a 20-expert variant padded to 32, and a
``capacity_factor`` 0.5 variant in which JAX drops tokens (asserted).  The
weights are the JAX ``Model.init`` draw carried across with
``params_from_numpy``, the LoRA bank has nonzero B.

Each case first asserts that every layer routes every token to the same
top-k experts in both packages (an fp32 difference of 1e-6 may flip a
near-tie; the tests compare numbers only once routing is equal), then
holds within 1e-4: the logits, the router's aux loss, the loss and the
LoRA gradients; and exactly: the greedy tokens of ``generate_banked`` and
``serve_scheduled`` over an fp32, an int8 and an int4 base (over a packed
base only q / k / v / o are packed; the experts stay fp, as in JAX).
3-round federated trajectories (fedsa + sfedlora under SGD and AdamW,
RoLoRA, mixed ranks (4, 8)) hold within the 1e-4 of
``tests/test_torch_train.py``.

Tolerance, with its reason: fp32 on both sides, sums taken in another
order by XLA and by PyTorch's CPU kernels."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jconfigs                          # noqa: E402
from repro.configs import base as jbase                        # noqa: E402
from repro.core import federated as jfed                       # noqa: E402
from repro.core import lora as jlora                           # noqa: E402
from repro.core import quant as jquant                         # noqa: E402
from repro.data import synthetic as jsyn                       # noqa: E402
from repro.launch import serve as jserve                       # noqa: E402
from repro.models import api as japi                           # noqa: E402
from repro.models import transformer as jtransformer           # noqa: E402
from repro_torch import configs as tconfigs                    # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy        # noqa: E402
from repro_torch.configs import base as tbase                  # noqa: E402
from repro_torch.core import federated as tfed                 # noqa: E402
from repro_torch.core import lora as tlora                     # noqa: E402
from repro_torch.core import quant as tquant                   # noqa: E402
from repro_torch.data import synthetic as tsyn                 # noqa: E402
from repro_torch.launch import serve as tserve                 # noqa: E402
from repro_torch.models import api as tapi                     # noqa: E402
from repro_torch.models import moe as tmoe                     # noqa: E402
from repro_torch.models import transformer as ttransformer     # noqa: E402
from repro_torch.tree import tree_leaves                        # noqa: E402


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
TRAJ_RTOL = 1e-4
VOCAB = 256


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **TOL)


def _case_cfgs(case, d_model=128):
    """(jax config, port config) of one case, each package's own classes."""
    arch = {"qwen2-moe": "qwen2-moe-a2.7b",
            "granite-moe": "granite-moe-1b-a400m",
            "padded-experts": "qwen2-moe-a2.7b",
            "capacity-drop": "granite-moe-1b-a400m"}[case]
    moe_kw = {"padded-experts": dict(num_experts=20),
              "capacity-drop": dict(capacity_factor=0.5)}.get(case, {})
    out = []
    for cfgs in (jconfigs, tconfigs):
        cfg = cfgs.get_config(arch).reduced(d_model=d_model, vocab_size=VOCAB)
        out.append(dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_kw)))
    return tuple(out)


CASES = ["qwen2-moe", "granite-moe", "padded-experts", "capacity-drop"]


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, port model, port params, jax bank, port
    bank) of a case, built once."""
    out = {}

    def get(case):
        if case not in out:
            jcfg, tcfg = _case_cfgs(case)
            jm, tm = japi.build_model(jcfg), tapi.build_model(tcfg)
            jp = jm.init(jax.random.key(0))
            rng = np.random.default_rng(5)
            jsets, tsets = [], []
            for i, r in enumerate((4, 8)):
                js = jlora.init_adapter_set(jp, jax.random.key(30 + i),
                                            jbase.LoRAConfig(rank=r),
                                            n_clients=2)
                lora = jax.tree.map(lambda x: x + 0.05 * rng.standard_normal(
                    x.shape).astype(np.float32), _np(js.lora))
                jsets.append(dataclasses.replace(
                    js, lora=jax.tree.map(jnp.asarray, lora)))
                tsets.append(tlora.AdapterSet(
                    lora=params_from_numpy(lora, "cpu"), gamma=js.gamma,
                    rank=r, alpha=js.alpha))
            out[case] = (jm, jp, tm, params_from_numpy(_np(jp), "cpu"),
                         jlora.AdapterBank.from_sets(jsets),
                         tlora.AdapterBank.from_sets(tsets))
        return out[case]
    return get


def _tokens(b, s, seed=3):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, s)).astype(
        np.int32)


def _record_routing(monkeypatch):
    """Patch both packages' blocks to record every MoE call's top-k expert
    indices, layer by layer in stack order: (jax list, port list)."""
    jrec, trec = [], []
    jorig, torig = jtransformer.moe_apply, ttransformer.moe_apply

    def jwrap(cfg, params, x, adapters=None):
        xf = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
        probs = jax.nn.softmax(xf @ params["router"].astype(jnp.float32), -1)
        _, top_i = jax.lax.top_k(probs, cfg.moe.top_k)
        jax.debug.callback(lambda t: jrec.append(np.asarray(t)), top_i,
                           ordered=True)
        return jorig(cfg, params, x, adapters=adapters)

    def twrap(cfg, params, x, adapters=None):
        trec.append(tmoe.route(cfg, params,
                               x.reshape(-1, x.shape[-1]))[2].numpy())
        return torig(cfg, params, x, adapters=adapters)

    monkeypatch.setattr(jtransformer, "moe_apply", jwrap)
    monkeypatch.setattr(ttransformer, "moe_apply", twrap)
    return jrec, trec


# ------------------------------------------------------------------ pieces

def test_config_and_params_follow_the_jax_tree():
    for arch in ("qwen2-moe-a2.7b", "granite-moe-1b-a400m"):
        j = dataclasses.asdict(jconfigs.get_config(arch))
        t = dataclasses.asdict(tconfigs.get_config(arch))
        j.pop("use_pallas")
        assert j == t
        j = dataclasses.asdict(jconfigs.get_config(arch).reduced())
        t = dataclasses.asdict(tconfigs.get_config(arch).reduced())
        j.pop("use_pallas")
        assert j == t
    jcfg, tcfg = _case_cfgs("padded-experts")
    assert tmoe.padded_experts(tcfg.moe) == 32
    jp = jax.eval_shape(japi.build_model(jcfg).init, jax.random.key(0))
    tp = tapi.build_model(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    shapes = lambda tree: {k: (shapes(v) if isinstance(v, dict)  # noqa: E731
                               else tuple(v.shape)) for k, v in tree.items()}
    assert shapes(tp) == shapes(jp)


def test_given_top_i_replaces_the_routers_choice():
    """``moe_apply(top_i=)`` dispatches to the given experts, weighted by
    this router's probabilities: its own choice gives the same output bit
    for bit, another choice another output and aux."""
    cfg = _case_cfgs("padded-experts")[1]
    gen = torch.Generator().manual_seed(0)
    params = tmoe.moe_params(cfg, gen)
    x = torch.randn(2, 16, cfg.d_model, generator=gen)
    out, aux = tmoe.moe_apply(cfg, params, x)
    own = tmoe.route(cfg, params, x.reshape(32, -1))[2]
    again, aux2 = tmoe.moe_apply(cfg, params, x, top_i=own)
    assert torch.equal(out, again) and torch.equal(aux, aux2)
    other = (own + 1) % cfg.moe.num_experts
    moved, aux3 = tmoe.moe_apply(cfg, params, x, top_i=other)
    assert not torch.allclose(moved, out) and float(aux3) != float(aux)


@pytest.mark.parametrize("case", CASES)
def test_routing_logits_and_aux_match_jax(models, case, monkeypatch):
    jm, jp, tm, tp, _, _ = models(case)
    cfg = tm.cfg
    jrec, trec = _record_routing(monkeypatch)
    toks = _tokens(2, 24)
    want, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    jax.effects_barrier()
    got, taux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert len(jrec) == len(trec) == cfg.num_layers
    for layer, (j, t) in enumerate(zip(jrec, trec)):
        np.testing.assert_array_equal(t, j, err_msg=f"layer {layer}")
    _close(got, want)
    _close(taux, jaux)
    assert float(taux) > 0
    # capacity: count each expert's tokens against the slots it has
    t = toks.size
    cap = tmoe.capacity(cfg, t)
    per_expert = [np.bincount(top.reshape(-1), minlength=cfg.moe.num_experts)
                  for top in trec]
    dropped = sum(int(np.maximum(c - cap, 0).sum()) for c in per_expert)
    if case == "capacity-drop":
        assert dropped > 0, "capacity_factor 0.5 should drop tokens"


@pytest.mark.parametrize("case", CASES)
def test_loss_and_lora_grads_match_jax(models, case):
    """The aux loss joins the loss and its gradient, as JAX's
    ``value_and_grad`` takes it."""
    jm, jp, tm, tp, _, _ = models(case)
    rng = np.random.default_rng(3)
    lora = jlora.init_lora(jp, jax.random.key(1), jbase.LoRAConfig(rank=8))
    lora = jax.tree.map(lambda x: np.asarray(x) + 0.02 * rng.standard_normal(
        x.shape).astype(np.float32), lora)
    toks = _tokens(2, 24, seed=4)
    gamma = 2.0

    def jloss(ll):
        return jm.loss(jp, {"tokens": jnp.asarray(toks)},
                       adapters=jlora.AdapterSet(lora=ll, gamma=gamma))

    (jl, jparts), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, lora))
    leaves = params_from_numpy(lora, "cpu")
    for t in tree_leaves(leaves):
        t.requires_grad_(True)
    tl, parts = tm.loss(tp, {"tokens": torch.from_numpy(toks)},
                        adapters=tlora.AdapterSet(lora=leaves, gamma=gamma))
    _close(tl, jl)
    _close(parts["aux"], jparts["aux"])
    assert float(parts["aux"].detach()) > 0
    assert float((tl - parts["ce"]).detach()) == pytest.approx(
        float(parts["aux"].detach()), abs=1e-6)
    grads = torch.autograd.grad(tl, tree_leaves(leaves))
    for got, want in zip(grads, jax.tree.leaves(jg)):
        assert float(np.abs(np.asarray(want)).max()) > 0
        _close(got, want)


@pytest.mark.parametrize("mode", ["fp32", "int8", "int4"])
@pytest.mark.parametrize("case", CASES)
def test_greedy_and_scheduled_tokens_match_jax(models, case, mode):
    """generate_banked and serve_scheduled.  Capacity and position run
    over the whole flattened batch in both packages, idle slots included:
    the second request stops early, so its slot decodes idle beside the
    others."""
    jm, jp, tm, tp, jbank, tbank = models(case)
    if mode != "fp32":
        tp = tquant.quantize_tree(tp, mode, 32)
        jp = jquant.quantize_tree(jp, mode, 32)
        assert tquant.has_quantized(tp)
        assert not any(isinstance(v, tquant.QuantizedLinear) for v in
                       tp["stack"]["repeat"]["p0"]["moe"].values())
    prompts = _tokens(3, 6, seed=2)
    ids = np.asarray([1, 0, 1], np.int32)
    want = np.asarray(jserve.generate_banked(jm, jp, jbank, jnp.asarray(ids),
                                             jnp.asarray(prompts), 7, 13))
    got = tserve.generate_banked(tm, tp, tbank, ids,
                                 torch.from_numpy(prompts), 7, 13)
    np.testing.assert_array_equal(got.numpy(), want)
    kw = dict(max_batch=3, block_size=4, chunk=4)
    steps = (7, 3, 7)
    treqs = [tserve.Request(rid=i, prompt=prompts[i], steps=steps[i],
                            adapter_id=int(ids[i])) for i in range(3)]
    jreqs = [jserve.Request(rid=i, prompt=prompts[i], steps=steps[i],
                            adapter_id=int(ids[i])) for i in range(3)]
    tdone = tserve.serve_scheduled(tm, tp, treqs, bank=tbank, wait=False,
                                   **kw)
    jdone = jserve.serve_scheduled(jm, jp, jreqs, bank=jbank, wait=False,
                                   **kw)
    assert [r.tokens for r in tdone] == [r.tokens for r in jdone]


# ------------------------------------------------------------ trajectories

ROUNDS = 3
TRAJ = {"fedsa-sfedlora-sgd": dict(strategy="fedsa", scaling="sfedlora",
                                   opt="sgd", lr=0.5),
        "fedsa-sfedlora-adamw": dict(strategy="fedsa", scaling="sfedlora",
                                     opt="adamw", lr=0.01),
        "rolora": dict(strategy="rolora", scaling="lora", opt="sgd", lr=0.5),
        "mixed-ranks": dict(strategy="fedsa", scaling="sfedlora",
                            opt="sgd", lr=0.5, ranks=(4, 8))}


@pytest.fixture(scope="module")
def small():
    """A narrow reduced qwen2-moe (2 layers, d_model 64, 1 shared expert)
    and its JAX-drawn base."""
    jcfg, tcfg = _case_cfgs("qwen2-moe", d_model=64)
    jm = japi.build_model(jcfg)
    return jcfg, tcfg, jm, jm.init(jax.random.key(0))


@pytest.mark.parametrize("name", list(TRAJ))
def test_trajectory_matches_jax(small, name):
    jcfg, tcfg, jm, jparams = small
    spec = TRAJ[name]
    ranks = spec.get("ranks")
    n = len(ranks) if ranks else 3
    lcfg = dict(rank=max(ranks) if ranks else 8, alpha=8.0,
                scaling=spec["scaling"], ranks=ranks)
    fcfg = dict(num_clients=n, local_steps=2, aggregation=spec["strategy"])
    ocfg = dict(name=spec["opt"], lr=spec["lr"])
    ds_kw = dict(seq_len=16, batch_per_client=2, seed=0)
    jtr = jfed.FederatedTrainer(
        jm, jsyn.FederatedDataset(VOCAB, n, **ds_kw),
        lora_cfg=jbase.LoRAConfig(**lcfg),
        fed_cfg=jbase.FederatedConfig(**fcfg),
        opt_cfg=jbase.OptimizerConfig(**ocfg), seed=0, base_params=jparams)
    # the shared init, read off a client that holds every rank row
    full = int(np.argmax(ranks)) if ranks else 0
    lora1 = jax.tree.map(lambda x: np.asarray(x[full]), jtr.lora)
    ttr = tfed.FederatedTrainer(
        tapi.build_model(tcfg), tsyn.FederatedDataset(VOCAB, n, **ds_kw),
        lora_cfg=tbase.LoRAConfig(**lcfg),
        fed_cfg=tbase.FederatedConfig(**fcfg),
        opt_cfg=tbase.OptimizerConfig(**ocfg), seed=0,
        base_params=_np(jparams), lora_init=lora1, device="cpu")
    jtr.run(ROUNDS)
    ttr.run(ROUNDS)
    assert len(ttr.history) == len(jtr.history) == ROUNDS
    for th, jh in zip(ttr.history, jtr.history):
        for key in ("loss", "grad_norm"):
            assert abs(th[key] - jh[key]) <= TRAJ_RTOL * max(1.0,
                                                             abs(jh[key])), \
                (key, th, jh)
    for got, want in zip(tree_leaves(ttr.lora), jax.tree.leaves(jtr.lora)):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=TRAJ_RTOL * max(1.0, float(np.abs(want).max())))
    b_max = max(float(t.abs().max()) for t in tree_leaves(
        tlora.split_ab(ttr.lora)[1]))
    assert b_max > 0, "B stayed zero: no training happened"
