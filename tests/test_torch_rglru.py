"""repro_torch's RG-LRU block and the hybrid (recurrentgemma) model against
the JAX package on the CPU.

The JAX parameters (``rglru_params``, ``Model.init``) and adapter banks
with nonzero B are carried across as numpy arrays; every other input is
drawn with numpy.  The block's pieces, full-sequence pass, prefill and
decode steps, and the reduced hybrid model's logits agree with the JAX
reference tier within 1e-4 (fp32; the JAX model scans with
``associative_scan``, the port with kernel #15's sequential plain version,
so only the order of rounding differs); greedy tokens of ``generate``,
``generate_banked`` and ``serve_scheduled`` are identical.  Patterns: the
recurrentgemma pattern (rglru, rglru, attn) with a tail of two RG-LRU
blocks, and (attn, rglru).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jconfigs                          # noqa: E402
from repro.checkpoint import io as jio                         # noqa: E402
from repro.configs.base import LoRAConfig as JLoRAConfig       # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig     # noqa: E402
from repro.core import lora as jlora                           # noqa: E402
from repro.launch import serve as jserve                       # noqa: E402
from repro.models import api as japi                           # noqa: E402
from repro.models import rglru as jrglru                       # noqa: E402
from repro_torch import configs as tconfigs                    # noqa: E402
from repro_torch.checkpoint import io as tio                   # noqa: E402
from repro_torch.configs.base import (FederatedConfig,         # noqa: E402
                                      LoRAConfig, ModelConfig,
                                      OptimizerConfig)
from repro_torch.core import federated as tfed                 # noqa: E402
from repro_torch.core import lora as tlora                     # noqa: E402
from repro_torch.data.synthetic import FederatedDataset        # noqa: E402
from repro_torch.kernels import dispatch                       # noqa: E402
from repro_torch.kernels import rglru_scan as tscan            # noqa: E402
from repro_torch.launch import serve as tserve                 # noqa: E402
from repro_torch.models import api as tapi                     # noqa: E402
from repro_torch.models import rglru as trglru                 # noqa: E402
from repro_torch.models import transformer as ttf              # noqa: E402
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
TRIPLE = (("rglru", "rglru", "attn"), 5)   # one repeat + (rglru, rglru) tail
PAIR = (("attn", "rglru"), 4)              # two repeats, no tail


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _cfgs(pattern, num_layers, **kw):
    base = dict(name="hybrid", family="hybrid", num_layers=num_layers,
                d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
                d_ff=128, vocab_size=96, mlp_variant="geglu",
                block_pattern=pattern, attn_window=8, rglru_d_state=64,
                lora_targets=("q", "v", "wx", "wy"))
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def _banks(jm, jp, ranks=(4, 8)):
    """A JAX bank over q, v, wx, wy and the port's twin, B drawn nonzero."""
    rng = np.random.default_rng(5)
    jsets, tsets = [], []
    for i, r in enumerate(ranks):
        js = jlora.init_adapter_set(
            jp, jax.random.key(30 + i),
            JLoRAConfig(rank=r, alpha=8.0, targets=jm.cfg.lora_targets),
            n_clients=len(ranks))
        lora = jax.tree.map(lambda x: x + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32), _np(js.lora))
        jsets.append(dataclasses.replace(
            js, lora=jax.tree.map(jnp.asarray, lora)))
        tsets.append(tlora.AdapterSet(lora=tio.params_from_numpy(lora, "cpu"),
                                      gamma=js.gamma, rank=r, alpha=js.alpha))
    return (jlora.AdapterBank.from_sets(jsets),
            tlora.AdapterBank.from_sets(tsets))


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, port model, port params, jax bank, port
    bank) on one set of weights, keyed by (pattern, layers)."""
    out = {}

    def get(pattern, num_layers):
        key = (pattern, num_layers)
        if key not in out:
            jcfg, tcfg = _cfgs(pattern, num_layers)
            jm = japi.build_model(jcfg)
            jp = jm.init(jax.random.key(0))
            tm = tapi.build_model(tcfg)
            out[key] = (jm, jp, tm, tio.params_from_numpy(_np(jp), "cpu"),
                        *_banks(jm, jp))
        return out[key]
    return get


def _tokens(b, s, seed=3, vocab=96):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# ------------------------------------------------------------------ block

@pytest.fixture(scope="module")
def block():
    """JAX RG-LRU params, their port twin, and wx / wy adapters with
    nonzero B (prepared: gamma folded)."""
    jcfg, tcfg = _cfgs(*TRIPLE)
    jp = jrglru.rglru_params(jcfg, jax.random.key(1))
    rng = np.random.default_rng(2)
    ad = {name: {"a": (rng.standard_normal((4, 64)) * 0.05).astype(
                 np.float32),
                 "b": (rng.standard_normal((64, 4)) * 0.05).astype(
                     np.float32)} for name in ("wx", "wy")}
    return (jcfg, tcfg, jp, tio.params_from_numpy(_np(jp), "cpu"),
            jax.tree.map(jnp.asarray, ad), tio.params_from_numpy(ad, "cpu"))


def test_block_pieces_match_jax(block):
    _, _, jp, tp, _, _ = block
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    tail = rng.standard_normal((2, 3, 64)).astype(np.float32)
    jout, jtail = jrglru._causal_conv(jnp.asarray(x), jp["conv"],
                                      jnp.asarray(tail))
    tout, ttail = trglru._causal_conv(torch.from_numpy(x), tp["conv"],
                                      torch.from_numpy(tail))
    _close(tout, jout, rtol=1e-6, atol=1e-6)
    _close(ttail, jtail, rtol=0, atol=0)
    ja, jb = jrglru._gates(jp, jnp.asarray(x))
    ta, tb = trglru._gates(tp, torch.from_numpy(x))
    _close(ta, ja, rtol=1e-5, atol=1e-6)
    _close(tb, jb, rtol=1e-5, atol=1e-6)
    assert float(ta.min()) > 0 and float(ta.max()) < 1


@pytest.mark.parametrize("with_lora", [False, True])
def test_block_fullseq_prefill_decode_match_jax(block, with_lora):
    """Full sequence; then a prefill of 6 tokens and 3 decode steps, whose
    outputs and caches (h, conv tail) follow the JAX block's."""
    jcfg, tcfg, jp, tp, jad, tad = block
    jad, tad = (jad, tad) if with_lora else (None, None)
    x = np.random.default_rng(4).standard_normal((2, 9, 64)).astype(
        np.float32)
    _close(trglru.rglru_apply_fullseq(tcfg, tp, torch.from_numpy(x), tad),
           jrglru.rglru_apply_fullseq(jcfg, jp, jnp.asarray(x), jad))
    jc = jrglru.rglru_init_cache(jcfg, 2, jnp.float32)
    tc = trglru.rglru_init_cache(tcfg, 2, torch.float32, device="cpu")
    jy, jc = jrglru.rglru_apply_prefill(jcfg, jp, jnp.asarray(x[:, :6]), jc,
                                        None, jad)
    ty, tc = trglru.rglru_apply_prefill(tcfg, tp, torch.from_numpy(x[:, :6]),
                                        tc, adapters=tad)
    _close(ty, jy)
    for t in range(6, 9):
        jy, jc = jrglru.rglru_apply_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]),
                                           jc, t, jad)
        ty, tc = trglru.rglru_apply_decode(tcfg, tp,
                                           torch.from_numpy(x[:, t:t + 1]),
                                           tc, adapters=tad)
        _close(ty, jy)
        _close(tc["h"], jc["h"])
        _close(tc["conv_tail"], jc["conv_tail"])


def test_block_params_follow_the_jax_tree():
    jcfg, tcfg = _cfgs(*TRIPLE)
    jp = jrglru.rglru_params(jcfg, jax.random.key(0))
    tp = trglru.rglru_params(tcfg, torch.Generator().manual_seed(0),
                             lead=(3,))
    assert set(tp) == set(jp)
    for k in jp:
        assert tuple(tp[k].shape) == (3,) + tuple(jp[k].shape)
    a = torch.exp(-8.0 * torch.nn.functional.softplus(-tp["lam"]))
    assert 0.9 - 1e-6 <= float(a.min()) and float(a.max()) <= 0.999 + 1e-6


# ------------------------------------------------------------------ model

def test_config_matches_jax():
    j = dataclasses.asdict(jconfigs.get_config("recurrentgemma-9b"))
    t = dataclasses.asdict(tconfigs.get_config("recurrentgemma-9b"))
    j.pop("use_pallas")
    assert j == t
    j = dataclasses.asdict(jconfigs.get_config("recurrentgemma-9b").reduced())
    t = dataclasses.asdict(tconfigs.get_config("recurrentgemma-9b").reduced())
    j.pop("use_pallas")
    assert j == t
    assert ttf.stack_layout(38, t["block_pattern"]) == (12, ("rglru",
                                                              "rglru"))


@pytest.mark.parametrize("layout", [TRIPLE, PAIR], ids=["triple", "pair"])
@pytest.mark.parametrize("which", ["base", "lazy"])
def test_hybrid_forward_matches_jax(models, layout, which):
    jm, jp, tm, tp, jbank, tbank = models(*layout)
    toks = _tokens(2, 12)
    ids = np.array([1, 0], np.int32)
    jad, tad = ((None, None) if which == "base"
                else (jbank.requests(jnp.asarray(ids)), tbank.requests(ids)))
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, adapters=jad)
    got, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)},
                          adapters=tad)
    assert got.shape == (2, 12, tm.vocab_padded) and aux == 0.0
    _close(got, want)


@pytest.mark.parametrize("layout", [TRIPLE, PAIR], ids=["triple", "pair"])
def test_hybrid_prefill_and_decode_match_jax(models, layout):
    """A prefill (ring caches and RG-LRU state filled) and 4 decode steps
    past the 8-token window, banked."""
    jm, jp, tm, tp, jbank, tbank = models(*layout)
    ids = np.array([0, 1, 1], np.int32)
    jad, tad = jbank.requests(jnp.asarray(ids)), tbank.requests(ids)
    prompt = _tokens(3, 6, seed=5)
    want, jc = jm.prefill(jp, jm.init_cache(3, 12), jnp.asarray(prompt), jad)
    got, tc = tm.prefill(tp, tm.init_cache(3, 12, device="cpu"),
                         torch.from_numpy(prompt), tad)
    _close(got, want)
    for jl, tl in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        _close(tl, jl)
    steps = _tokens(3, 4, seed=6)
    for t in range(4):
        pos = np.full((3,), 6 + t, np.int32)
        want, jc = jm.decode_step(jp, jc, jnp.asarray(steps[:, t:t + 1]),
                                  jnp.asarray(pos), jad)
        got, tc = tm.decode_step(tp, tc, torch.from_numpy(steps[:, t:t + 1]),
                                 torch.from_numpy(pos).long(), tad)
        _close(got, want)


@pytest.mark.parametrize("layout", [TRIPLE, PAIR], ids=["triple", "pair"])
def test_hybrid_greedy_tokens_match_jax(models, layout):
    """generate (base) and generate_banked: the JAX engine's tokens, and
    the token-by-token host loop's."""
    jm, jp, tm, tp, jbank, tbank = models(*layout)
    prompt = _tokens(2, 5, seed=7)
    want = np.asarray(jserve.generate(jm, jp, jnp.asarray(prompt), 10, 15))
    got = tserve.generate(tm, tp, torch.from_numpy(prompt), 10, 15)
    np.testing.assert_array_equal(got.numpy(), want)
    ids = np.array([1, 0], np.int32)
    want = np.asarray(jserve.generate_banked(jm, jp, jbank, jnp.asarray(ids),
                                             jnp.asarray(prompt), 10, 15))
    got = tserve.generate_banked(tm, tp, tbank, ids,
                                 torch.from_numpy(prompt), 10, 15)
    np.testing.assert_array_equal(got.numpy(), want)
    host = tserve.generate_hostloop(tm, tp, torch.from_numpy(prompt), 10, 15,
                                    adapters=tbank.requests(ids))
    np.testing.assert_array_equal(host.numpy(), want)


def test_jax_checkpoint_of_the_hybrid_loads_and_computes_the_same(
        models, tmp_path):
    """A JAX ``Model.init`` tree of the reduced recurrentgemma-9b, saved by
    the JAX package, loads in the port (``load_pytree`` +
    ``params_from_numpy``) with every RG-LRU leaf and gives its logits."""
    jcfg = jconfigs.get_config("recurrentgemma-9b").reduced()
    tcfg = tconfigs.get_config("recurrentgemma-9b").reduced()
    jm, tm = japi.build_model(jcfg), tapi.build_model(tcfg)
    jp = jm.init(jax.random.key(4))
    path = str(tmp_path / "hybrid.npz")
    jio.save_pytree(path, jp)
    tp = tio.params_from_numpy(tio.load_pytree(path), "cpu")
    assert set(tp["stack"]["tail"]["t0"]["rglru"]) == {
        "wx", "wy", "conv", "w_a", "w_i", "lam", "w_out"}
    toks = _tokens(2, 10, vocab=jcfg.vocab_size)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    _close(got, want)


# ------------------------------------------------------------ scheduling

def _schedule(tm, tp, prompts, steps, ids, tbank, **kw):
    reqs = [tserve.Request(rid=i, prompt=prompts[i], steps=steps,
                           adapter_id=int(ids[i]))
            for i in range(len(prompts))]
    done = tserve.serve_scheduled(tm, tp, reqs, bank=tbank, wait=False, **kw)
    return np.stack([np.asarray(r.tokens) for r in done])


def test_scheduled_identity_recurrent_blocks(models):
    """Mirror of tests/test_paged.py::test_scheduled_identity_recurrent_
    blocks: per-slot RG-LRU state comes back fresh at admission and merges
    without disturbing the attention pools; the port's scheduled tokens
    equal its fixed-batch tokens and the JAX scheduler's."""
    jm, jp, tm, tp, _, _ = models(*PAIR)
    B, p, steps = 2, 6, 8
    prompts = _tokens(B, p, seed=2)
    kw = dict(max_batch=B, block_size=4, chunk=5, max_len=p + steps)
    sched = _schedule(tm, tp, prompts, steps, np.zeros(B, np.int32), None,
                      **kw)
    fixed = tserve.generate(tm, tp, torch.from_numpy(prompts), steps,
                            p + steps)[:, p:].numpy()
    np.testing.assert_array_equal(sched, fixed)
    jreqs = [jserve.Request(rid=i, prompt=prompts[i], steps=steps)
             for i in range(B)]
    jdone = jserve.serve_scheduled(jm, jp, jreqs, wait=False, **kw)
    np.testing.assert_array_equal(
        sched, np.stack([np.asarray(r.tokens) for r in jdone]))


def test_scheduled_churn_with_recurrent_state(models):
    """6 banked requests through 2 slots of the recurrentgemma pattern:
    three waves reuse slots whose RG-LRU state the previous wave left
    behind; each wave equals generate_banked on that wave alone."""
    _, _, tm, tp, _, tbank = models(*TRIPLE)
    N, p, steps, max_len = 6, 6, 9, 15
    prompts = _tokens(N, p, seed=8)
    ids = np.asarray([0, 1, 1, 0, 0, 1], np.int32)
    sched = _schedule(tm, tp, prompts, steps, ids, tbank, max_batch=2,
                      block_size=4, chunk=4, max_len=max_len)
    fixed = np.concatenate([tserve.generate_banked(
        tm, tp, tbank, ids[w:w + 2], torch.from_numpy(prompts[w:w + 2]),
        steps, max_len)[:, p:].numpy() for w in range(0, N, 2)])
    np.testing.assert_array_equal(sched, fixed)


def test_prefill_view_and_merge_touch_only_the_newcomers(models):
    """The admission view shares the engine pools (same tensors) and holds
    fresh per-slot state at the group size; the merge writes the
    newcomers' slots (axis 1 under the repeat, axis 0 in the tail) and
    leaves every other slot as it was."""
    _, _, tm, _, _, _ = models(*TRIPLE)
    cfg = tm.cfg
    cache = tm.init_paged_cache(5, 4, 3, device="cpu")
    for leaf in tree_leaves(cache):
        if leaf.is_floating_point():
            leaf.fill_(7.0)
    view = ttf.paged_prefill_view(cfg, cache, 2, torch.float32, device="cpu")
    assert view["repeat"]["p2"]["k_pool"] is cache["repeat"]["p2"]["k_pool"]
    assert tuple(view["repeat"]["p0"]["h"].shape) == (1, 2, 64)
    assert tuple(view["tail"]["t1"]["conv_tail"].shape) == (2, 3, 64)
    assert not view["tail"]["t0"]["h"].any()
    for leaf in tree_leaves(view):
        if leaf.dtype == torch.float32 and leaf.shape[-1] == 64 \
                and leaf.ndim <= 4:
            leaf.fill_(1.0)
    slots = torch.tensor([2, 0])
    merged = ttf.merge_paged_cache(cache, view, slots)
    h_rep, h_tail = merged["repeat"]["p1"]["h"], merged["tail"]["t0"]["h"]
    assert (h_rep[:, [0, 2]] == 1).all() and (h_rep[:, 1] == 7).all()
    assert (h_tail[[0, 2]] == 1).all() and (h_tail[1] == 7).all()
    assert merged["repeat"]["p2"]["k_pool"] is cache["repeat"]["p2"]["k_pool"]


def test_kernel_routes_on_cpu_count_the_scan_per_rglru_layer(models,
                                                             monkeypatch):
    """With the kernel routes taken (dispatch._use_kernel forced true; on
    CPU tensors each wrapper runs its plain version), a fixed-batch banked
    generation scans once per RG-LRU layer in the prefill and never in a
    decode step, and the adapted projections take the batched route at q,
    v, wx and wy: the counts chip_smoke.py holds on the card."""
    jm, jp, tm, tp, _, tbank = models(*TRIPLE)
    prompt = torch.from_numpy(_tokens(2, 5, seed=9))
    ids = np.array([0, 1], np.int32)
    want = tserve.generate_banked(tm, tp, tbank, ids, prompt, 4, 9)
    calls = []
    orig = tscan.rglru_scan
    monkeypatch.setattr(dispatch, "_use_kernel", lambda x: True)
    monkeypatch.setattr(tscan, "rglru_scan",
                        lambda *a: calls.append(1) or orig(*a))
    dispatch.reset_stats()
    got = tserve.generate_banked(tm, tp, tbank, ids, prompt, 4, 9)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    n_rglru, n_attn = 4, 1                 # (rglru, rglru, attn) + 2 tail
    assert len(calls) == n_rglru
    assert dispatch.stats["bgmv"] == 2 * (n_rglru + n_attn) * 4


@pytest.mark.parametrize("layout", [TRIPLE, PAIR], ids=["triple", "pair"])
def test_lora_tree_for_the_hybrid_matches_jax(models, layout):
    """The adapter tree from the config alone: q, v in the attention
    blocks, wx, wy in the RG-LRU blocks, repeats stacked, with the JAX
    package's shapes."""
    jm, _, tm, _, _, _ = models(*layout)
    lcfg = LoRAConfig(rank=4, targets=tm.cfg.lora_targets)
    got = tlora.lora_tree_for_model(tm, torch.Generator().manual_seed(0),
                                    lcfg, device="cpu")
    want = jlora.lora_tree_for_model(
        jm, jax.random.key(0), JLoRAConfig(rank=4,
                                           targets=jm.cfg.lora_targets))
    assert jax.tree.map(lambda x: tuple(x.shape), want) == _tree_shapes(got)
    assert tlora.num_lora_params(got) == jlora.num_lora_params(want)


def _tree_shapes(tree):
    return {k: (_tree_shapes(v) if isinstance(v, dict) else tuple(v.shape))
            for k, v in tree.items()}


def test_training_the_hybrid_is_not_yet_ported(models):
    """The trainer builds on the reduced hybrid (the name is older than
    the port of its training) and runs a round on the CPU: finite loss,
    LoRA at q, v, wx and wy, B no longer zero, no kernel launched."""
    _, _, tm, tp, _, _ = models(*PAIR)
    ds = FederatedDataset(96, 2, seq_len=8, batch_per_client=1)
    tscan.reset_launches()
    tr = tfed.FederatedTrainer(
        tm, ds, lora_cfg=LoRAConfig(rank=4, targets=tm.cfg.lora_targets),
        fed_cfg=FederatedConfig(num_clients=2),
        opt_cfg=OptimizerConfig(lr=0.5), base_params=tp, device="cpu")
    tr.run_round()
    assert len(tr.history) == 1 and np.isfinite(tr.history[0]["loss"])
    rep = tr.lora["stack"]["repeat"]
    assert set(rep["p0"]["attn"]) == {"q", "v"}
    assert set(rep["p1"]["rglru"]) == {"wx", "wy"}
    assert float(rep["p1"]["rglru"]["wx"]["b"].abs().max()) > 0
    assert not any(tscan.launches.values())
