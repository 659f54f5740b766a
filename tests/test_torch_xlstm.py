"""repro_torch's xLSTM family (xlstm-1.3b) against the JAX package, on the
CPU.

The reduced xlstm-1.3b (d_model 64: 4 heads of 16, 4 sLSTM heads of 16,
vocab 256) at two depths: 2 layers (an mLSTM and an sLSTM, both under
"repeat") and 3 (the pair, then an mLSTM in the tail).  The weights are the
JAX ``Model.init`` draw carried across with ``params_from_numpy``; every
other input comes from a numpy seed.

Held within 1e-4 (relative to max(1, max|ref|)):
- the chunked mLSTM, output and carry, at s = 100, 256 and 300 (one chunk,
  exactly one, two with padding), from a fresh and from a carried state;
  its gradients at s = 300 (finite through the -inf band and the -1e30
  pads), also where the stabilizer's maxima tie;
- prefill's carry against s token-by-token decode steps, in the port alone
  and against JAX's prefill;
- the sLSTM: full sequence, prefill carry and decode, with and without a
  hand-built prepared ``z`` adapter (decode ignores it, as in JAX);
- the model's logits, loss and q / v LoRA gradients;
- 3-round trajectories: fedsa + sfedlora under SGD, and ranks (2, 4, 8)
  under flora (its adapters by B A product: the SVD's basis is free).
Exactly: the greedy tokens of ``generate`` and ``generate_banked``, the
scheduled tokens of ``serve_scheduled`` (slots recycled, a deadline);
``quantize_tree`` leaves the tree unchanged in both packages; checkpoints
cross both ways; and the CLIs run.

Tolerance, with its reason: fp32 on both sides, sums taken in another
order by XLA and by PyTorch's CPU kernels."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jconfigs                          # noqa: E402
from repro.checkpoint import io as jio                         # noqa: E402
from repro.configs import base as jbase                        # noqa: E402
from repro.core import federated as jfed                       # noqa: E402
from repro.core import lora as jlora                           # noqa: E402
from repro.core import quant as jquant                         # noqa: E402
from repro.data import synthetic as jsyn                       # noqa: E402
from repro.launch import serve as jserve                       # noqa: E402
from repro.models import api as japi                           # noqa: E402
from repro.models import xlstm as jx                           # noqa: E402
from repro_torch import configs as tconfigs                    # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy        # noqa: E402
from repro_torch.configs import base as tbase                  # noqa: E402
from repro_torch.core import federated as tfed                 # noqa: E402
from repro_torch.core import lora as tlora                     # noqa: E402
from repro_torch.core import quant as tquant                   # noqa: E402
from repro_torch.data import synthetic as tsyn                 # noqa: E402
from repro_torch.kernels import dispatch                       # noqa: E402
from repro_torch.launch import serve as tserve                 # noqa: E402
from repro_torch.launch import train as ttrain                 # noqa: E402
from repro_torch.models import api as tapi                     # noqa: E402
from repro_torch.models import transformer as ttransformer     # noqa: E402
from repro_torch.models import xlstm as tx                     # noqa: E402
from repro_torch.tree import tree_leaves                        # noqa: E402

TOL = 1e-4
VOCAB = 256
D = 64
LAYOUTS = {"2L": 2, "3L": 3}
ROUNDS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its many small ops (the sLSTM
    loop) gain nothing from more, and the suite's parallel workers share
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def _cfgs(num_layers):
    """(jax config, port config): each package's own reduced xlstm-1.3b."""
    return tuple(c.get_config("xlstm-1.3b").reduced(
        d_model=D, vocab_size=VOCAB, num_layers=num_layers)
        for c in (jconfigs, tconfigs))


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, port model, port params, jax sets, port
    sets, jax bank, port bank) of a layout, built once: two tenants of
    ranks 4 and 8 with nonzero B."""
    out = {}

    def get(layout):
        if layout not in out:
            jcfg, tcfg = _cfgs(LAYOUTS[layout])
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
            out[layout] = (jm, jp, tm, params_from_numpy(_np(jp), "cpu"),
                           jsets, tsets, jlora.AdapterBank.from_sets(jsets),
                           tlora.AdapterBank.from_sets(tsets))
        return out[layout]
    return get


def _tokens(b, s, seed=3):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, s)).astype(
        np.int32)


def _block(jp, kind):
    """The repeat's first layer of ``kind``, as numpy."""
    key = "p0" if kind == "mlstm" else "p1"
    return jax.tree.map(lambda a: np.asarray(a[0]),
                        jp["stack"]["repeat"][key][kind])


def _both(tree):
    """(jax tree, port tree) of a numpy tree (None stays None)."""
    if tree is None:
        return None, None
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


def _prepared(rng, names, r=4):
    """Prepared adapter nodes (gamma folded into B), d_model wide."""
    return {n: {"a": (0.2 * rng.standard_normal((r, D))).astype(np.float32),
                "b": (0.2 * rng.standard_normal((D, r))).astype(np.float32)}
            for n in names}


def _mlstm_carry(rng, b, cfg):
    h, hd = cfg.num_heads, cfg.head_dim
    return ((0.1 * rng.standard_normal((b, h, hd, hd))).astype(np.float32),
            (0.1 * rng.standard_normal((b, h, hd))).astype(np.float32),
            rng.standard_normal((b, h)).astype(np.float32))


# ------------------------------------------------------------------ pieces

def test_config_params_and_lora_follow_the_jax_tree(models):
    j = dataclasses.asdict(jconfigs.get_config("xlstm-1.3b"))
    t = dataclasses.asdict(tconfigs.get_config("xlstm-1.3b"))
    j.pop("use_pallas")
    assert j == t
    assert "xlstm-1.3b" in tconfigs.ARCHS
    assert "xlstm-1.3b" not in tconfigs.NOT_YET_PORTED
    jm, jp, tm, _, jsets, tsets, *_ = models("3L")
    shapes = lambda tree: {k: (shapes(v) if isinstance(v, dict)  # noqa: E731
                               else tuple(v.shape)) for k, v in tree.items()}
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert shapes(tp) == shapes(jax.eval_shape(jm.init, jax.random.key(0)))
    block = tp["stack"]["repeat"]["p0"]
    assert set(block) == {"ln1_scale", "mlstm"}            # no ln2, no MLP
    assert set(tp["stack"]["repeat"]["p1"]) == {"ln1_scale", "slstm"}
    assert set(tp["stack"]["tail"]["t0"]) == {"ln1_scale", "mlstm"}
    # the LoRA tree: q, v of the mLSTM under the repeat's lead dim and in
    # the tail, nothing for the sLSTM; from the config alone as well
    assert shapes(tsets[0].lora) == shapes(jsets[0].lora)
    from_cfg = tlora.lora_tree_for_model(
        tm, torch.Generator().manual_seed(0), tbase.LoRAConfig(rank=4),
        device="cpu")
    assert shapes(from_cfg) == shapes(jsets[0].lora)
    assert set(from_cfg["stack"]["repeat"]) == {"p0"}
    assert set(from_cfg["stack"]["repeat"]["p0"]["mlstm"]) == {"q", "v"}


@pytest.mark.parametrize("start", ["fresh", "carried"])
@pytest.mark.parametrize("s", [100, 256, 300])
def test_mlstm_chunked_form_matches_jax(models, s, start):
    jm, jp, tm, *_ = models("2L")
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, D)).astype(np.float32)
    jad, tad = _both(_prepared(rng, ("q", "v")))
    carry = _mlstm_carry(rng, 2, tm.cfg) if start == "carried" else None
    jp_, tp_ = _both(_block(jp, "mlstm"))
    want, wcarry = jx._mlstm_fullseq(
        jm.cfg, jp_, jnp.asarray(x), jad,
        carry0=None if carry is None else tuple(map(jnp.asarray, carry)))
    got, gcarry = tx._mlstm_fullseq(
        tm.cfg, tp_, torch.from_numpy(x), tad,
        carry0=None if carry is None else tuple(map(torch.from_numpy,
                                                    carry)))
    assert got.shape == (2, s, D)
    _close(got, want)
    for g, w in zip(gcarry, wcarry):
        _close(g, w)


@pytest.mark.parametrize("case", ["random", "ties"])
def test_mlstm_grads_across_padded_chunks_match_jax(models, case):
    """Gradients of x and of the q / v adapters through two chunks, the
    second padded (s = 300), finite and equal to JAX's.  "ties": w_f = 0
    and b_f = 200 make every forget gate exactly 1 (log_f = 0), repeated
    tokens give equal input gates, and a small q keeps the denominator on
    its exp(-m) floor, so the gradient runs through maxima that tie; jnp.max
    and jnp.maximum share it among the tied entries, as torch.amax and
    torch.maximum do."""
    jm, jp, tm, *_ = models("2L")
    rng = np.random.default_rng(11)
    s = 300
    p = _block(jp, "mlstm")
    x = rng.standard_normal((2, s, D)).astype(np.float32)
    if case == "ties":
        p = dict(p, w_f=np.zeros_like(p["w_f"]),
                 b_f=np.full_like(p["b_f"], 200.0), q=1e-3 * p["q"])
        x[:, 1::2] = x[:, 0::2]
    ad = _prepared(rng, ("q", "v"))
    w_out = rng.standard_normal((2, s, D)).astype(np.float32)
    w_c = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    jp_, tp_ = _both(p)

    def jloss(xx, aa):
        out, (c, n, m) = jx._mlstm_fullseq(jm.cfg, jp_, xx, aa)
        return (out * w_out).sum() + (c * w_c).sum() + n.sum()

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                         jax.tree.map(jnp.asarray, ad))
    tx_ = torch.from_numpy(x).requires_grad_(True)
    tad = params_from_numpy(ad, "cpu")
    for t in tree_leaves(tad):
        t.requires_grad_(True)
    out, (c, n, m) = tx._mlstm_fullseq(tm.cfg, tp_, tx_, tad)
    loss = ((out * torch.from_numpy(w_out)).sum()
            + (c * torch.from_numpy(w_c)).sum() + n.sum())
    grads = torch.autograd.grad(loss, [tx_] + tree_leaves(tad))
    wants = [jg[0]] + jax.tree.leaves(jg[1])
    for g, w in zip(grads, wants):
        assert torch.isfinite(g).all()
        assert float(np.abs(np.asarray(w)).max()) > 0
        _close(g, w)


@pytest.mark.parametrize("s", [100, 300])
def test_mlstm_prefill_carry_equals_decode_steps(models, s):
    """Prefill from a fresh cache leaves the state s decode steps leave,
    and its outputs are theirs (port alone); the prefill's carry and
    outputs equal JAX's prefill."""
    jm, jp, tm, *_ = models("2L")
    rng = np.random.default_rng(s + 1)
    x = rng.standard_normal((2, s, D)).astype(np.float32)
    jad, tad = _both(_prepared(rng, ("q", "v")))
    jp_, tp_ = _both(_block(jp, "mlstm"))
    cfg = tm.cfg
    pre, pcache = tx.mlstm_apply_prefill(
        cfg, tp_, torch.from_numpy(x),
        tx.mlstm_init_cache(cfg, 2, torch.float32, device="cpu"),
        adapters=tad)
    dcache = tx.mlstm_init_cache(cfg, 2, torch.float32, device="cpu")
    outs = []
    for t in range(s):
        y, dcache = tx.mlstm_apply_decode(cfg, tp_,
                                          torch.from_numpy(x[:, t:t + 1]),
                                          dcache, adapters=tad)
        outs.append(y)
    for key in ("C", "n", "m"):
        _close(pcache[key], dcache[key].numpy())
    _close(pre, torch.cat(outs, 1).numpy())
    want, wcache = jx.mlstm_apply_prefill(
        jm.cfg, jp_, jnp.asarray(x),
        jx.mlstm_init_cache(jm.cfg, 2, jnp.float32), None, jad)
    _close(pre, want)
    for key in ("C", "n", "m"):
        assert pcache[key].dtype == torch.float32
        _close(pcache[key], wcache[key])


@pytest.mark.parametrize("z", [False, True], ids=["plain", "z-adapter"])
def test_slstm_matches_jax(models, z):
    """Full sequence from a fresh state, prefill from a carried one, then a
    decode step; with a prepared ``z`` adapter the first two change and
    decode ignores it, in both packages."""
    jm, jp, tm, *_ = models("2L")
    rng = np.random.default_rng(21)
    s = 20
    x = rng.standard_normal((2, s + 1, D)).astype(np.float32)
    jad, tad = _both(_prepared(rng, ("z",)) if z else None)
    jp_, tp_ = _both(_block(jp, "slstm"))
    jcfg, tcfg = jm.cfg, tm.cfg
    want, wcarry = jx._slstm_fullseq(jcfg, jp_, jnp.asarray(x[:, :s]), jad)
    got, gcarry = tx._slstm_fullseq(tcfg, tp_, torch.from_numpy(x[:, :s]),
                                    tad)
    _close(got, want)
    for g, w in zip(gcarry, wcarry):
        _close(g, w)
    carry = {"h": 0.5 * rng.standard_normal((2, D)),
             "c": rng.standard_normal((2, D)),
             "n": 1.0 + rng.random((2, D)),
             "m": rng.standard_normal((2, D))}
    carry = {k: v.astype(np.float32) for k, v in carry.items()}
    want, wcache = jx.slstm_apply_prefill(
        jcfg, jp_, jnp.asarray(x[:, :s]),
        {k: jnp.asarray(v) for k, v in carry.items()}, None, jad)
    got, tcache = tx.slstm_apply_prefill(
        tcfg, tp_, torch.from_numpy(x[:, :s]),
        {k: torch.from_numpy(v.copy()) for k, v in carry.items()},
        adapters=tad)
    _close(got, want)
    for key in ("h", "c", "n", "m"):
        _close(tcache[key], wcache[key])
    want, wcache = jx.slstm_apply_decode(jcfg, jp_, jnp.asarray(x[:, s:]),
                                         wcache, s, jad)
    plain = {k: v.clone() for k, v in tcache.items()}
    got, tcache = tx.slstm_apply_decode(tcfg, tp_, torch.from_numpy(x[:, s:]),
                                        tcache, adapters=tad)
    _close(got, want)
    for key in ("h", "c", "n", "m"):
        _close(tcache[key], wcache[key])
    again, _ = tx.slstm_apply_decode(tcfg, tp_, torch.from_numpy(x[:, s:]),
                                     plain)
    assert torch.equal(again, got)
    if z:
        base, _ = tx._slstm_fullseq(tcfg, tp_, torch.from_numpy(x[:, :s]))
        assert not torch.allclose(base, tx._slstm_fullseq(
            tcfg, tp_, torch.from_numpy(x[:, :s]), tad)[0])


def test_fresh_caches_hold_the_stabilizer_states(models):
    """A fresh cache, and an admission view's per-slot state beside a
    used engine cache, hold m = -1e30, the sLSTM's n = 1e-6 and zeros, in
    fp32 whatever the activation dtype."""
    _, _, tm, *_ = models("3L")
    cache = tm.init_paged_cache(4, 2, 3, torch.bfloat16, device="cpu")
    for part in cache.values():
        for c in part.values():
            for leaf in tree_leaves(c):
                leaf.fill_(7.0)
    view = ttransformer.paged_prefill_view(tm.cfg, cache, 2, torch.bfloat16,
                                           device="cpu")
    for part, lead in (("repeat", (1, 2)), ("tail", (2,))):
        for c in view[part].values():
            for key, leaf in c.items():
                assert leaf.dtype == torch.float32
                assert tuple(leaf.shape[:len(lead)]) == lead
                want = {"m": -1e30, "n": 1e-6 if "h" in c else 0.0}.get(
                    key, 0.0)
                assert torch.all(leaf == torch.tensor(want)), key


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_logits_loss_and_lora_grads_match_jax(models, layout):
    jm, jp, tm, tp, *_ = models(layout)
    rng = np.random.default_rng(3)
    lora = jlora.init_lora(jp, jax.random.key(1), jbase.LoRAConfig(rank=8))
    lora = jax.tree.map(lambda x: np.asarray(x) + 0.02 * rng.standard_normal(
        x.shape).astype(np.float32), lora)
    toks = _tokens(2, 40, seed=4)
    gamma = 2.0
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)},
                         adapters=jlora.AdapterSet(
                             lora=jax.tree.map(jnp.asarray, lora),
                             gamma=gamma))

    def jloss(ll):
        return jm.loss(jp, {"tokens": jnp.asarray(toks)},
                       adapters=jlora.AdapterSet(lora=ll, gamma=gamma))[0]

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, lora))
    leaves = params_from_numpy(lora, "cpu")
    with torch.no_grad():
        got, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)},
                              adapters=tlora.AdapterSet(lora=leaves,
                                                        gamma=gamma))
    _close(got, want)
    assert float(aux) == 0.0
    for t in tree_leaves(leaves):
        t.requires_grad_(True)
    dispatch.reset_stats()
    tl, _ = tm.loss(tp, {"tokens": torch.from_numpy(toks)},
                    adapters=tlora.AdapterSet(lora=leaves, gamma=gamma))
    # q and v of every mLSTM layer took the LoRA matmul Function
    n_mlstm = (tm.cfg.num_layers + 1) // 2             # (mlstm, slstm)...
    assert dispatch.stats["lora_matmul"] == 2 * n_mlstm
    _close(tl, jl)
    grads = torch.autograd.grad(tl, tree_leaves(leaves))
    for g, w in zip(grads, jax.tree.leaves(jg)):
        assert float(np.abs(np.asarray(w)).max()) > 0
        _close(g, w)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_greedy_tokens_match_jax(models, layout):
    """``generate`` under one tenant's set and ``generate_banked`` over
    both tenants: the same tokens as the JAX package."""
    jm, jp, tm, tp, jsets, tsets, jbank, tbank = models(layout)
    prompts = _tokens(3, 6, seed=2)
    want = np.asarray(jserve.generate(jm, jp, jnp.asarray(prompts), 7, 13,
                                      jsets[1]))
    got = tserve.generate(tm, tp, torch.from_numpy(prompts), 7, 13,
                          tsets[1])
    np.testing.assert_array_equal(got.numpy(), want)
    ids = np.asarray([1, 0, 1], np.int32)
    want = np.asarray(jserve.generate_banked(jm, jp, jbank, jnp.asarray(ids),
                                             jnp.asarray(prompts), 7, 13))
    got = tserve.generate_banked(tm, tp, tbank, ids,
                                 torch.from_numpy(prompts), 7, 13)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scheduled_tokens_match_jax(models):
    """serve_scheduled on the 3-layer model: 5 requests through 2 slots,
    so admissions recycle slots whose state must start fresh, and a
    deadline cuts one request.  One JAX run; the port over the fp32 base
    and over the int8 and int4 "packed" bases (nothing packs) gives its
    tokens."""
    jm, jp, tm, tp, _, _, jbank, tbank = models("3L")
    prompts = _tokens(5, 6, seed=8)
    steps = (7, 3, 7, 5, 7)
    kw = dict(max_batch=2, block_size=4, chunk=4, wait=False)

    def reqs(mod):
        return [mod.Request(rid=i, prompt=prompts[i], steps=steps[i],
                            adapter_id=i % 2,
                            deadline_steps=4 if i == 2 else None)
                for i in range(5)]

    jdone = jserve.serve_scheduled(jm, jp, reqs(jserve), bank=jbank, **kw)
    want = [r.tokens for r in jdone]
    assert len(want[2]) == 4 and jdone[2].timed_out
    for mode in ("fp32", "int8", "int4"):
        base = tp if mode == "fp32" else tquant.quantize_tree(tp, mode, 32)
        tdone = tserve.serve_scheduled(tm, base, reqs(tserve), bank=tbank,
                                       **kw)
        assert [r.tokens for r in tdone] == want, mode
        assert tdone[2].timed_out


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_tree_leaves_the_xlstm_tree_unchanged(models, mode):
    """No xLSTM leaf is eligible (``ELIGIBLE`` lists neither block) and
    d_ff is 0: both packages return the tree as it was."""
    _, jp, _, tp, *_ = models("3L")
    jq = jquant.quantize_tree(jp, mode, 32)
    tq = tquant.quantize_tree(tp, mode, 32)
    assert not jquant.has_quantized(jq) and not tquant.has_quantized(tq)
    for g, w in zip(tree_leaves(tq), tree_leaves(tp)):
        assert torch.equal(g, w)
    for g, w in zip(jax.tree.leaves(jq), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ------------------------------------------------------------ trajectories

TRAJ = {"fedsa-sfedlora-sgd": dict(strategy="fedsa", ranks=None),
        "flora-ranks-2-4-8": dict(strategy="flora", ranks=(2, 4, 8))}


def _trainers(models, strategy="fedsa", ranks=None):
    jm, jp, tm, *_ = models("2L")
    n = 3
    lcfg = dict(rank=max(ranks) if ranks else 8, ranks=ranks, alpha=8.0,
                scaling="sfedlora")
    fcfg = dict(num_clients=n, local_steps=2, aggregation=strategy)
    ocfg = dict(name="sgd", lr=0.5)
    ds_kw = dict(seq_len=16, batch_per_client=2, seed=0)
    jtr = jfed.FederatedTrainer(
        jm, jsyn.FederatedDataset(VOCAB, n, **ds_kw),
        lora_cfg=jbase.LoRAConfig(**lcfg),
        fed_cfg=jbase.FederatedConfig(**fcfg),
        opt_cfg=jbase.OptimizerConfig(**ocfg), seed=0, base_params=jp)
    full = ranks.index(max(ranks)) if ranks else 0
    lora1 = jax.tree.map(lambda x: np.asarray(x[full]), jtr.lora)
    ttr = tfed.FederatedTrainer(
        tapi.build_model(tm.cfg), tsyn.FederatedDataset(VOCAB, n, **ds_kw),
        lora_cfg=tbase.LoRAConfig(**lcfg),
        fed_cfg=tbase.FederatedConfig(**fcfg),
        opt_cfg=tbase.OptimizerConfig(**ocfg), seed=0,
        base_params=_np(jp), lora_init=lora1, device="cpu")
    assert ttr.gamma == jtr.gamma
    return jtr, ttr


def _products(tree):
    """B A of every client and layer, in sorted-key order."""
    out = []

    def walk(node):
        if set(node) == {"a", "b"}:
            a, b = (np.asarray(x.numpy() if isinstance(x, torch.Tensor)
                               else x) for x in (node["a"], node["b"]))
            out.append(np.einsum("...or,...ri->...oi", b, a))
            return
        for k in sorted(node):
            walk(node[k])
    walk(tree)
    return out


def _assert_same_run(jtr, ttr, by_product=False, rounds=ROUNDS):
    assert len(ttr.history) == len(jtr.history) == rounds
    for th, jh in zip(ttr.history, jtr.history):
        for key in ("loss", "grad_norm"):
            assert abs(th[key] - jh[key]) <= TOL * max(
                1.0, abs(float(jh[key]))), (key, th, jh)
    pairs = (zip(_products(ttr.lora), _products(jtr.lora)) if by_product
             else zip(tree_leaves(ttr.lora), jax.tree.leaves(jtr.lora)))
    for got, want in pairs:
        _close(got, want)


@pytest.mark.parametrize("name", list(TRAJ))
def test_trajectory_matches_jax(models, name):
    jtr, ttr = _trainers(models, **TRAJ[name])
    jtr.run(ROUNDS)
    dispatch.reset_stats()
    ttr.run(ROUNDS)
    # q, v of the one mLSTM layer, per client local step, in the forward
    # and in the backward's recompute of the repeat unit
    assert dispatch.stats["lora_matmul"] == 2 * 2 * 3 * 2 * ROUNDS
    _assert_same_run(jtr, ttr, by_product=TRAJ[name]["strategy"] == "flora")
    b_max = max(float(t.abs().max()) for t in tree_leaves(
        tlora.split_ab(ttr.lora)[1]))
    assert b_max > 0, "B stayed zero: no training happened"


@pytest.mark.parametrize("name", list(TRAJ))
def test_first_round_matches_jax(models, name):
    """The same trajectory after one round, where the xLSTM has not yet
    amplified fp32 rounding: at lr 0.5 a round multiplies a difference in
    the adapters by 100-400 (JAX against itself from a start moved by one
    ulp: 1.7e-8, 6.6e-6, 3.4e-5 of B A after rounds 1-3), so the 3-round
    flora run above ends 2.4e-4 from JAX's, while the port departs from
    JAX by 1.0e-7 of B A after its first round (its server step alone, on
    JAX's own inputs, by at most 3.0e-7)."""
    jtr, ttr = _trainers(models, **TRAJ[name])
    jtr.run(1)
    ttr.run(1)
    _assert_same_run(jtr, ttr, by_product=TRAJ[name]["strategy"] == "flora",
                     rounds=1)


# ---------------------------------------------------------- checkpoints

def test_port_checkpoint_loads_in_jax(models, tmp_path):
    """The xLSTM base (the sLSTM's (nh, hd, hd) recurrences under the
    repeat's lead dim included), adapters and optimizer state in the JAX
    package's flat keys."""
    _, ttr = _trainers(models)
    ttr.run(1)
    path = str(tmp_path / "port.npz")
    ttr.save(path)
    base, lora, opt, rnd, _key, _data, _ = jio.load_federated_state(
        path, full=True)
    assert rnd == 1
    assert base["stack"]["repeat"]["p1"]["slstm"]["r_z"].shape == (1, 4, 16,
                                                                   16)
    assert set(lora["stack"]["repeat"]["p0"]["mlstm"]) == {"q", "v"}
    for tree, want in ((base, ttr.base), (lora, ttr.lora),
                       (opt, ttr.opt_state)):
        got = jax.tree.leaves(tree)
        assert len(got) == len(tree_leaves(want))
        for g, w in zip(got, tree_leaves(want)):
            np.testing.assert_array_equal(np.asarray(g), w.numpy())


def test_jax_checkpoint_resumes_in_the_port(models, tmp_path):
    jtr, ttr = _trainers(models)
    jtr.run(2)
    path = str(tmp_path / "jax.npz")
    jtr.save(path)
    ttr.restore(path)
    assert ttr.round_idx == 2
    for g, w in zip(tree_leaves(ttr.base), jax.tree.leaves(jtr.base)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    jtr.run(1)
    ttr.run(1)
    th, jh = ttr.history[-1], jtr.history[-1]
    assert th["round"] == jh["round"] == 3
    for key in ("loss", "grad_norm"):
        assert abs(th[key] - jh[key]) <= TOL * max(1.0, abs(float(jh[key])))
    for got, want in zip(tree_leaves(ttr.lora), jax.tree.leaves(jtr.lora)):
        _close(got, want)


# ------------------------------------------------------------------ CLIs

SERVE = ["--arch", "xlstm-1.3b", "--reduced", "--device", "cpu", "--steps",
         "3", "--batch", "2"]
TRAIN = ["--arch", "xlstm-1.3b", "--reduced", "--device", "cpu", "--seq",
         "8", "--batch-per-client", "1", "--local-steps", "1"]


@pytest.mark.parametrize("extra", [
    [], ["--quant", "int4", "--quant-group", "32"], ["--merge", "0"],
    ["--ranks", "4,8"],
    ["--arrival-trace", "poisson:50:5"],
    ["--arrival-trace", "poisson:50:5", "--quant", "int4", "--quant-group",
     "32", "--hot-slots", "2", "--deadline-steps", "2", "--max-batch", "2"],
], ids=["fixed", "int4", "merge", "ranks", "scheduled", "scheduled-int4"])
def test_serve_cli_runs_on_cpu(extra, capsys):
    out = tserve.main(SERVE + extra)
    text = capsys.readouterr().out
    if "--arrival-trace" in extra:
        assert len(out) == 5
        assert "# xlstm-1.3b scheduled serve: 5 requests" in text
    else:
        assert out.shape[0] == 2
        assert "# xlstm-1.3b" in text


@pytest.mark.parametrize("extra", [
    ["--rounds", "2"],
    ["--rounds", "2", "--quant", "int4", "--quant-group", "32"],
    ["--rounds", "2", "--clients", "3", "--ranks", "2,4,8", "--strategy",
     "flora"],
    ["--rounds", "2", "--data-mode", "device"],
    ["--rounds", "2", "--clients", "3", "--chunk-rounds", "1", "--buffer",
     "2", "--faults", "dropout=0.2,corrupt=0.1", "--watchdog", "1"],
], ids=["fedsa", "int4", "flora-ranks", "device-data", "faults"])
def test_train_cli_runs_on_cpu(extra, capsys):
    tr = ttrain.main(TRAIN + extra)
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "# final held-out perplexity: ")


def test_train_cli_save_then_resume(tmp_path, capsys):
    """Over an int4 "packed" base (nothing packs): a run saved after round
    1 and resumed for round 2 ends as a 2-round run does."""
    path = str(tmp_path / "ck.npz")
    quant = ["--quant", "int4", "--quant-group", "32"]
    full = ttrain.main(TRAIN + quant + ["--rounds", "2"])
    ttrain.main(TRAIN + quant + ["--rounds", "1", "--save", path])
    resumed = ttrain.main(TRAIN + quant + ["--rounds", "1", "--resume",
                                           path])
    assert resumed.history[-1] == full.history[-1]
