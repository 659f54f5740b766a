"""repro_torch's paged KV pool and continuous-batching scheduler against the
JAX package, on the CPU.

  * BlockPool invariants (a seeded op-sequence sweep), the degenerate pool,
    double frees.
  * The paged fill + gather reproduces the ring layout element for element
    (overflow included), and writes the JAX package's pools.
  * ``paged_attention_plain`` (the plain version of kernel #13) matches the
    JAX oracle ``paged_attention_ref`` and the JAX Pallas kernel in
    interpret mode within 2e-5, over window x softcap, with staggered and
    wrapped fills.
  * Scheduled greedy tokens equal the port's fixed-batch tokens bit for
    bit (base, banked, sliding-window overflow, churn through 2 slots), and
    equal the JAX ``serve_scheduled`` tokens from the same weights.
  * Deadline eviction keeps an exact prefix; ``make_requests`` draws what
    the JAX package draws.
  * Kernel #13's split of the table over the card (``common.paged_split``)
    and its sub-block size (``sub_block``): the chunks cover the table's
    columns exactly, fill the SMs at the paths' shapes, and depend on the
    shapes and SM count alone; a torch emulation of the kernel's chunked
    (m, l, acc) and its fixed-order merge equals the plain version within
    1e-5; the wrapper hands its entry point that plan and a scratch.
"""
import inspect
import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import LoRAConfig as JLoRAConfig       # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig     # noqa: E402
from repro.core import lora as jlora                           # noqa: E402
from repro.kernels.paged_attention import paged_attention      # noqa: E402
from repro.kernels.ref import paged_attention_ref              # noqa: E402
from repro.launch import serve as jserve                       # noqa: E402
from repro.models import api as japi                           # noqa: E402
from repro.models import attention as jattn                    # noqa: E402
from repro_torch.checkpoint import io as tio                   # noqa: E402
from repro_torch.configs.base import LoRAConfig                # noqa: E402
from repro_torch.configs.base import ModelConfig               # noqa: E402
from repro_torch.core import lora as tlora                     # noqa: E402
from repro_torch.kernels import common, dispatch               # noqa: E402
from repro_torch.kernels import paged_attention as tpaged      # noqa: E402
from repro_torch.launch import serve as tserve                 # noqa: E402
from repro_torch.models import api as tapi                     # noqa: E402
from repro_torch.models import attention as tattn              # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its small ops gain nothing
    from more, and the suite's parallel workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 2e-5      # plain version vs the JAX oracle and interpret kernel: fp32


def _cfgs(**kw):
    base = dict(name="paged", family="dense", num_layers=2, d_model=32,
                num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64,
                vocab_size=64)
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """Both packages' models on one set of weights, keyed by config."""
    out = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in out:
            jcfg, tcfg = _cfgs(**kw)
            jm = japi.build_model(jcfg)
            jp = jm.init(jax.random.key(0))
            out[key] = (jm, jp, tapi.build_model(tcfg),
                        tio.params_from_numpy(_np(jp), "cpu"))
        return out[key]
    return get


def _banks(jm, jp, ranks=(4, 8)):
    """A JAX bank and the port's twin, B drawn nonzero with numpy."""
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


# ------------------------------------------------------------- BlockPool

def _check_pool_ops(num_blocks, ops):
    pool = tserve.BlockPool(num_blocks)
    held, capacity = [], num_blocks - 1
    for kind, arg in ops:
        outstanding = sum(len(h) for h in held)
        if kind == "alloc":
            got = pool.alloc(arg)
            if arg > capacity - outstanding:
                assert got is None
            else:
                assert got is not None and len(set(got)) == arg
                assert all(0 < b < num_blocks for b in got)
                assert not set(got) & {b for h in held for b in h}
                held.append(got)
        elif held:
            blocks = held.pop(arg % len(held))
            before = pool.available
            pool.free(blocks)
            assert pool.available == before + len(blocks)
            if blocks:
                with pytest.raises(ValueError):
                    pool.free(blocks)
                assert pool.available == before + len(blocks)
    assert pool.available == capacity - sum(len(h) for h in held)


@pytest.mark.parametrize("seed", range(4))
def test_block_pool_invariants(seed):
    rng = random.Random(seed)
    for _ in range(60):
        ops = [(rng.choice(["alloc", "free"]), rng.randint(0, 8))
               for _ in range(rng.randint(0, 60))]
        _check_pool_ops(rng.randint(2, 40), ops)


def test_block_pool_degenerate_and_double_free():
    with pytest.raises(ValueError):
        tserve.BlockPool(1)
    pool = tserve.BlockPool(8)
    got = pool.alloc(3)
    pool.free(got)
    with pytest.raises(ValueError, match="double free") as ei:
        pool.free(got)
    assert all(str(b) in str(ei.value) for b in got)
    b = pool.alloc(1)[0]
    with pytest.raises(ValueError):
        pool.free([b, b])                    # refused atomically
    assert pool.available == 6
    pool.free([b])


# ------------------------------------------------- ring vs paged layout

@pytest.mark.parametrize("seed,batch,mb,bs,extra", [
    (0, 1, 1, 1, 0), (1, 2, 3, 2, 0), (2, 3, 2, 4, 5), (3, 2, 4, 1, 12),
    (4, 1, 3, 4, 1)])
def test_ring_vs_paged_fill_layout(seed, batch, mb, bs, extra):
    """Prompt fill into the ring and into the pool: the paged gather is the
    ring element for element (extra > 0 overflows the ring), the null
    block stays empty, and the pools are the JAX package's."""
    jcfg, tcfg = _cfgs()
    size, s = mb * bs, mb * bs + extra
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((batch, s, 1, 16)).astype(np.float32)
    v = rng.standard_normal((batch, s, 1, 16)).astype(np.float32)
    positions = np.broadcast_to(np.arange(s)[None], (batch, s))
    table = np.arange(1, 1 + batch * mb, dtype=np.int32).reshape(batch, mb)
    tk, tv, tpos, ttab = (torch.from_numpy(np.array(a))
                          for a in (k, v, positions, table))
    ring = tattn.fill_kv_cache(
        tattn.init_kv_cache(tcfg, batch, size, torch.float32, device="cpu"),
        tk, tv, tpos)
    paged = tattn.fill_paged_kv_cache(
        tattn.init_paged_kv_cache(tcfg, 1 + batch * mb, bs, torch.float32,
                                  device="cpu"), tk, tv, tpos, ttab)
    kg, vg, pg = tattn.paged_gather(paged, ttab)
    assert torch.equal(ring["k"], kg) and torch.equal(ring["v"], vg)
    assert torch.equal(ring["pos"], pg)
    assert not (paged["pos_pool"][0] >= 0).any()
    jpaged = jattn.fill_paged_kv_cache(
        jattn.init_paged_kv_cache(jcfg, 1 + batch * mb, bs, jnp.float32),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(positions),
        jnp.asarray(table))
    for name in ("k_pool", "v_pool", "pos_pool"):
        np.testing.assert_array_equal(paged[name].numpy(),
                                      np.asarray(jpaged[name]))


# --------------------------------------------- kernel #13's plain version

@pytest.mark.parametrize("window,softcap", [(None, None), (6, None),
                                            (None, 30.0), (6, 30.0)])
def test_paged_attention_plain_matches_jax(window, softcap):
    """Staggered fill levels (half, full, wrapped) and an idle slot whose
    table points at the null block, as the scheduler leaves one."""
    b, h, kh, hd, bs, mb = 4, 4, 2, 16, 4, 3
    npool = 1 + 3 * mb
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k_pool = rng.standard_normal((npool, bs, kh, hd)).astype(np.float32)
    v_pool = rng.standard_normal((npool, bs, kh, hd)).astype(np.float32)
    table = np.zeros((b, mb), np.int32)
    table[:3] = np.arange(1, npool, dtype=np.int32).reshape(3, mb)
    pos_pool = np.full((npool, bs), -1, np.int32)
    vlen = mb * bs
    for i, filled in enumerate((vlen // 2, vlen, vlen + 3)):
        pos = np.arange(filled)
        vslot = pos % vlen
        pos_pool[table[i, vslot // bs], vslot % bs] = pos
    pos_pool[0, 0] = 5                         # the idle slot's own write
    qpos = np.asarray([vlen // 2 - 1, vlen - 1, vlen + 2, 5], np.int32)
    args = (q, k_pool, v_pool, pos_pool, table, qpos)
    got = tpaged.paged_attention_plain(
        *(torch.from_numpy(a) for a in args), window=window, softcap=softcap)
    ref = paged_attention_ref(*(jnp.asarray(a) for a in args),
                              window=window, softcap=softcap)
    kern = paged_attention(*(jnp.asarray(a) for a in args), window=window,
                           softcap=softcap, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=ATOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=ATOL,
                               atol=ATOL)
    # the wrapper takes the plain version on CPU tensors, and counts nothing
    tpaged.reset_launches()
    via = tpaged.paged_attention(*(torch.from_numpy(a) for a in args),
                                 window=window, softcap=softcap)
    assert torch.equal(via, got) and tpaged.launches["paged_attention"] == 0


# ------------------------------- kernel #13's split plan and chunked merge

# (b, kh, mb) of the timed shapes and their plan on a 132-SM card: (a) the
# gemma-2b scheduled path, (b) the hybrid's (the same table, 16 query
# heads), (c) a long context of 2048 positions
PAGED_PLANS = {"a": ((4, 1, 10), (10, 1)), "b": ((4, 1, 10), (10, 1)),
               "c": ((4, 1, 128), (32, 4))}


@pytest.mark.parametrize("b,kh,mb,sms", [
    (4, 1, 10, 132), (4, 1, 128, 132), (4, 1, 1, 132), (3, 2, 3, 132),
    (4, 1, 34, 132), (132, 1, 10, 132), (200, 2, 50, 132),
    (4, 1, 1000, 132), (1, 1, 7, 16), (4, 1, 10, 114), (66, 2, 3, 132)])
def test_paged_split_covers_the_table_once(b, kh, mb, sms):
    """Every chunk holds at least one column, together exactly the mb
    columns; b kh nsplit blocks stay within one wave of the SMs (nsplit 1
    once b kh fills them) and use more than half the chunks it allows."""
    nsplit, cols = common.paged_split(b, kh, mb, sms)
    assert cols >= 1 and (nsplit - 1) * cols < mb <= nsplit * cols
    if b * kh >= sms:
        assert nsplit == 1
    else:
        allowed = min(mb, sms // (b * kh))
        assert allowed / 2 < nsplit <= allowed


@pytest.mark.parametrize("shape", sorted(PAGED_PLANS))
def test_paged_split_fills_the_card_at_the_paths_shapes(shape):
    """(a) and (b): 10 chunks of one column, 40 blocks; (c): 32 chunks of
    4 columns, 128 blocks on 132 SMs."""
    (b, kh, mb), want = PAGED_PLANS[shape]
    assert common.paged_split(b, kh, mb, 132) == want


def test_paged_split_depends_on_shapes_and_sm_count_alone():
    """A plain function of (b, kh, mb, SM count), so the wrapper asks
    nothing of the device and a CUDA graph can capture it."""
    assert list(inspect.signature(common.paged_split).parameters) == [
        "b", "kh", "mb", "num_sms"]
    assert common.paged_split(4, 1, 128, 132) == common.paged_split(
        4, 1, 128, 132)
    assert common.paged_split(4, 1, 128, 66) != common.paged_split(
        4, 1, 128, 132)


@pytest.mark.parametrize("g,hd,bs,itemsize,want", [
    (8, 256, 16, 4, 16), (16, 256, 16, 4, 16), (16, 256, 16, 2, 16),
    (3, 80, 5, 4, 5), (8, 256, 32, 4, 16), (64, 256, 16, 4, 8),
    (1, 4096, 16, 4, 1), (64, 400, 16, 4, 1), (1, 6000, 16, 4, 0),
    (1, 20000, 16, 4, 0), (64, 2000, 16, 2, 0)])
def test_sub_block_fits_shared_memory(g, hd, bs, itemsize, want):
    """16 positions a sub-block (bs if fewer), halved only where a large
    head would not fit; 0 (refused by the wrapper's check) where even one
    position does not."""
    sub = tpaged.sub_block(g, hd, bs, itemsize)
    assert sub == want
    if sub:
        assert tpaged._smem(g, hd, sub, itemsize) <= tpaged._MAX_SMEM
    if sub and sub < min(16, bs):
        assert tpaged._smem(g, hd, 2 * sub, itemsize) > tpaged._MAX_SMEM


def _paged_operands(b, h, kh, hd, bs, mb, idle=0, seed=3):
    """chip_smoke._paged_case on the CPU: request i owns mb pool blocks
    filled to a staggered level (half, full, wrapped past the ring, one
    short of full); ``idle`` trailing slots point every table entry at the
    null block 0."""
    rng = np.random.default_rng(seed)
    live = b - idle
    npool = 1 + live * mb
    q = torch.from_numpy(rng.standard_normal((b, h, hd)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (npool, bs, kh, hd)).astype(np.float32)) for _ in range(2))
    table = torch.zeros(b, mb, dtype=torch.int32)
    table[:live] = torch.arange(1, npool, dtype=torch.int32).reshape(live, mb)
    pos_pool = torch.full((npool, bs), -1, dtype=torch.int32)
    vlen, qpos = mb * bs, []
    for i in range(live):
        filled = (vlen // 2, vlen, vlen + 3, vlen - 1)[i % 4]
        pos = torch.arange(filled)
        vslot = pos % vlen
        pos_pool[table[i, vslot // bs].long(), vslot % bs] = pos.int()
        qpos.append(filled - 1)
    pos_pool[0, 0] = 0                    # an idle slot's own write
    qpos = torch.tensor(qpos + [0] * idle, dtype=torch.int32)
    return q, kp, vp, pos_pool, table, qpos


def _split_emulation(q, k_pool, v_pool, pos_pool, table, qpos, *, window,
                     softcap, sms):
    """The kernel's arithmetic in torch: each (request, kv head, chunk) of
    common.paged_split's plan carries the running (m, l, acc) of the kv
    head's query heads over its columns, sub_block positions at a time (p
    = 0 where the score is NEG_INF); then a request's partials are merged
    in chunk order: m = max m_z, l = sum l_z e^(m_z - m), acc likewise, out
    = acc / max(l, 1e-30)."""
    b, h, hd = q.shape
    _, bs, kh, _ = k_pool.shape
    mb, g = table.shape[1], h // kh
    nsplit, cols = common.paged_split(b, kh, mb, sms)
    sub = tpaged.sub_block(g, hd, bs, 4)
    neg = tpaged.NEG_INF
    out = torch.empty(b, h, hd)
    for i in range(b):
        qp = int(qpos[i])
        for kv in range(kh):
            qg = q[i, kv * g:(kv + 1) * g].double()
            parts = []
            for z in range(nsplit):
                m = torch.full((g,), neg, dtype=torch.float64)
                l = torch.zeros(g, dtype=torch.float64)
                acc = torch.zeros(g, hd, dtype=torch.float64)
                for col in range(z * cols, min(mb, (z + 1) * cols)):
                    blk = int(table[i, col])
                    for o in range(0, bs, sub):
                        k = k_pool[blk, o:o + sub, kv].double()
                        v = v_pool[blk, o:o + sub, kv].double()
                        p = pos_pool[blk, o:o + sub]
                        s = qg @ k.T * hd ** -0.5
                        if softcap:
                            s = softcap * torch.tanh(s / softcap)
                        valid = (p >= 0) & (p <= qp)
                        if window is not None:
                            valid &= qp - p < window
                        s = torch.where(valid, s, torch.full_like(s, neg))
                        m_new = torch.maximum(m, s.max(-1).values)
                        pr = torch.where(s <= neg / 2, torch.zeros_like(s),
                                         torch.exp(s - m_new[:, None]))
                        corr = torch.exp(m - m_new)
                        l = l * corr + pr.sum(-1)
                        acc = acc * corr[:, None] + pr @ v
                        m = m_new
                parts.append((m, l, acc))
            mx = torch.stack([m for m, _, _ in parts]).max(0).values
            lsum = sum(l * torch.exp(m - mx) for m, l, _ in parts)
            a = sum(acc * torch.exp(m - mx)[:, None] for m, _, acc in parts)
            out[i, kv * g:(kv + 1) * g] = (
                a / lsum.clamp_min(1e-30)[:, None]).float()
    return out, parts


@pytest.mark.parametrize("shape,h,kh,hd,bs,idle,window,softcap", [
    ("a", 8, 1, 32, 16, 0, None, None),
    ("a", 8, 1, 32, 16, 1, 24, 30.0),      # idle slot; early chunks masked
    ("b", 16, 1, 32, 16, 0, 2048, None),
    ("c", 16, 1, 32, 16, 0, 2048, None),   # request 0: half its chunks empty
    ("c", 16, 1, 32, 16, 1, 100, None),    # most chunks outside the window
    ("a", 6, 2, 20, 5, 1, None, 50.0),     # two kv heads, bs 5
    ("a", 4, 1, 20, 32, 0, None, None),    # two sub-blocks a column
])
def test_chunked_merge_equals_plain(shape, h, kh, hd, bs, idle, window,
                                    softcap):
    """The kernel's split (m, l, acc) and fixed-order merge, emulated in
    torch at the plans of (a)-(c), equal the exact softmax of the plain
    version within 1e-5, with chunks that hold no attendable position and
    an idle slot on the null block."""
    (b, _, mb), (nsplit, _) = PAGED_PLANS[shape]
    args = _paged_operands(b, h, kh, hd, bs, mb, idle)
    got, _ = _split_emulation(*args, window=window, softcap=softcap,
                              sms=132)
    want = tpaged.paged_attention_plain(*args, window=window,
                                        softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert nsplit > 1


def test_chunked_merge_skips_empty_chunks():
    """A chunk with no attendable position carries (m, l, acc) = (NEG_INF,
    0, 0) and adds nothing to the merge."""
    args = _paged_operands(4, 16, 1, 32, 16, 128)
    _, parts = _split_emulation(*args, window=None, softcap=None, sms=132)
    m, l, acc = parts[-1]                  # request 3's last chunk: filled
    assert bool((m > tpaged.NEG_INF / 2).all())
    args = _paged_operands(1, 16, 1, 32, 16, 128)   # half filled
    _, parts = _split_emulation(*args, window=None, softcap=None, sms=132)
    m, l, acc = parts[-1]
    assert bool((m == tpaged.NEG_INF).all()) and not l.any() \
        and not acc.any()


class _RecordingLib:
    """Stands in for the kernel library: records each entry point's
    arguments and returns 0 (no error)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


@pytest.mark.parametrize("b,h,kh,hd,bs,mb,window", [
    (4, 8, 1, 256, 16, 10, None), (4, 16, 1, 256, 16, 128, 2048),
    (3, 6, 2, 80, 5, 3, 64), (140, 4, 1, 64, 16, 6, None),
    (4, 8, 1, 256, 16, 1, None)])
def test_paged_wrapper_launches_with_the_plan_and_scratch(
        monkeypatch, b, h, kh, hd, bs, mb, window):
    """The wrapper hands its entry point paged_split's plan on a 132-SM
    card, sub_block's size and, when the plan splits, a scratch for the
    (B, kh, nsplit, g, hd + 2) partials (a null pointer otherwise); then
    counts one launch."""
    from repro_torch.kernels import build
    lib = _RecordingLib()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(tpaged, "route", lambda t, _name: True)
    monkeypatch.setattr(tpaged, "num_sms", lambda device: 132)
    monkeypatch.setattr(tpaged, "stream", lambda t: None)
    made = {}
    real_empty = torch.empty

    def recording_empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        made[t.data_ptr()] = t
        return t
    monkeypatch.setattr(tpaged.torch, "empty", recording_empty)
    args = _paged_operands(b, h, kh, hd, bs, mb)
    tpaged.reset_launches()
    tpaged.paged_attention(*args, window=window)
    (entry, got), = lib.calls
    assert entry == "paged_attention_launch"
    nsplit, cols = common.paged_split(b, kh, mb, 132)
    sub = tpaged.sub_block(h // kh, hd, bs, 4)
    assert got[8:19] == (b, args[1].shape[0], h, kh, hd, bs, mb, nsplit, cols,
                         sub, window or 0)
    if nsplit > 1:
        assert made[got[7]].numel() >= b * h * nsplit * (hd + 2)
    else:
        assert got[7] is None
    assert tpaged.launches["paged_attention"] == 1


# ------------------------------------------------ scheduled vs fixed batch

def _prompts(n, p, vocab, seed=2):
    return np.random.default_rng(seed).integers(0, vocab, (n, p)).astype(
        np.int32)


def _schedule(tm, tp, prompts, steps, ids, tbank, **kw):
    reqs = [tserve.Request(rid=i, prompt=prompts[i], steps=steps,
                           adapter_id=int(ids[i]))
            for i in range(len(prompts))]
    done = tserve.serve_scheduled(tm, tp, reqs, bank=tbank, wait=False, **kw)
    return np.stack([np.asarray(r.tokens) for r in done])


def _fixed(tm, tp, prompts, steps, max_len, ids, tbank):
    pt = torch.from_numpy(prompts)
    if tbank is None:
        out = tserve.generate(tm, tp, pt, steps, max_len)
    else:
        out = tserve.generate_banked(tm, tp, tbank, ids, pt, steps, max_len)
    return out[:, prompts.shape[1]:].numpy()


@pytest.mark.parametrize("case", ["base", "banked", "window_overflow"])
def test_scheduled_matches_fixed_batch_and_jax(models, case):
    """All requests present at the start, uniform shapes: the port's
    scheduled tokens equal its fixed-batch tokens, and the JAX scheduler's
    tokens from the same weights, bank and prompts."""
    kw = {"attn_window": 6} if case == "window_overflow" else {}
    jm, jp, tm, tp = models(**kw)
    B, p, steps = 4, 8, 12
    sched_kw = dict(max_batch=B, block_size=4, chunk=5, max_len=p + steps)
    if case == "window_overflow":
        # max_len 8 < prompt + steps 17: both engines wrap their ring
        p, steps = 5, 12
        sched_kw.update(block_size=2, max_len=8)
    jbank, tbank = _banks(jm, jp) if case != "base" else (None, None)
    prompts = _prompts(B, p, 64)
    ids = np.arange(B, dtype=np.int32) % (2 if tbank else 1)
    sched = _schedule(tm, tp, prompts, steps, ids, tbank, **sched_kw)
    np.testing.assert_array_equal(
        sched, _fixed(tm, tp, prompts, steps, sched_kw["max_len"], ids,
                      tbank))
    jreqs = [jserve.Request(rid=i, prompt=prompts[i], steps=steps,
                            adapter_id=int(ids[i])) for i in range(B)]
    jdone = jserve.serve_scheduled(jm, jp, jreqs, bank=jbank, wait=False,
                                   **sched_kw)
    np.testing.assert_array_equal(
        sched, np.stack([np.asarray(r.tokens) for r in jdone]))


def test_scheduled_churn_matches_fixed_waves(models):
    """6 requests through 2 engine slots: three waves recycling freed slots
    and blocks; each wave equals the fixed engine run on that wave."""
    jm, jp, tm, tp = models()
    _, tbank = _banks(jm, jp)
    N, p, steps, max_len = 6, 6, 10, 16
    prompts = _prompts(N, p, 64, seed=3)
    ids = np.asarray([0, 1, 1, 0, 0, 1], np.int32)
    sched = _schedule(tm, tp, prompts, steps, ids, tbank, max_batch=2,
                      block_size=4, chunk=4, max_len=max_len)
    fixed = np.concatenate([
        _fixed(tm, tp, prompts[w:w + 2], steps, max_len, ids[w:w + 2], tbank)
        for w in range(0, N, 2)])
    np.testing.assert_array_equal(sched, fixed)


def test_scheduled_mixed_lengths_and_block_starvation(models):
    """Mixed prompt lengths and step counts, more requests than slots, and
    a pool of exactly one request's blocks: everyone completes with their
    token count, deterministically, and equals the fixed engine alone."""
    _, _, tm, tp = models()
    rng = np.random.default_rng(0)
    plens, steps = [4, 4, 6, 6, 4, 6, 4], [1, 5, 9, 3, 7, 2, 4]
    prompts = [rng.integers(0, 64, n).astype(np.int32) for n in plens]

    def run(**kw):
        reqs = [tserve.Request(rid=i, prompt=prompts[i], steps=steps[i])
                for i in range(7)]
        return tserve.serve_scheduled(tm, tp, reqs, wait=False, **kw)

    a = run(max_batch=3, block_size=4, chunk=4)
    b = run(max_batch=3, block_size=4, chunk=4)
    assert [len(r.tokens) for r in a] == steps
    assert [r.tokens for r in a] == [r.tokens for r in b]
    one = run(max_batch=1, block_size=4, chunk=2, max_len=16)
    for r in one:
        want = _fixed(tm, tp, prompts[r.rid][None], r.steps, 16, None, None)
        assert r.tokens == want[0].tolist()


def test_deadline_evicts_with_exact_prefix(models):
    _, _, tm, tp = models()
    prompt = _prompts(1, 6, 64, seed=5)[0]
    kw = dict(max_batch=2, block_size=4, chunk=4, max_len=40, wait=False)
    (full,) = tserve.serve_scheduled(
        tm, tp, [tserve.Request(rid=0, prompt=prompt, steps=32)], **kw)
    tserve.reset_timeout_meter()
    (cut,) = tserve.serve_scheduled(
        tm, tp, [tserve.Request(rid=0, prompt=prompt, steps=32,
                                deadline_steps=8)], **kw)
    assert cut.timed_out and not full.timed_out
    assert len(cut.tokens) == 8 and cut.tokens == full.tokens[:8]
    assert tserve.timeouts == 1


def test_make_requests_matches_jax():
    for trace, dl in (("poisson:50:8", None), ("poisson:3:5", 4)):
        got = tserve.make_requests(trace, prompt_len=5, steps=7, tenants=3,
                                   vocab=64, seed=4, deadline_steps=dl)
        want = jserve.make_requests(trace, prompt_len=5, steps=7, tenants=3,
                                    vocab=64, seed=4, deadline_steps=dl)
        for g, w in zip(got, want, strict=True):
            assert (g.rid, g.steps, g.adapter_id, g.arrival,
                    g.deadline_steps) == (w.rid, w.steps, w.adapter_id,
                                          w.arrival, w.deadline_steps)
            np.testing.assert_array_equal(g.prompt, w.prompt)
    with pytest.raises(ValueError, match="deadline_steps"):
        tserve.make_requests("poisson:5:2", prompt_len=3, steps=4, tenants=1,
                             vocab=64, deadline_steps=0)


def test_kernel_route_wiring_on_cpu(models, monkeypatch):
    """The scheduled path with the kernel routes taken (dispatch._use_kernel
    forced true; on CPU tensors each kernel wrapper runs its plain version):
    every decode step goes through paged_attention once per layer, and the
    tokens are the plain tier's."""
    jm, jp, tm, tp = models()
    _, tbank = _banks(jm, jp)
    prompts = _prompts(3, 6, 64, seed=7)
    ids = np.asarray([1, 0, 1], np.int32)
    kw = dict(max_batch=3, block_size=4, chunk=3)
    want = _schedule(tm, tp, prompts, 7, ids, tbank, **kw)
    calls = []
    orig = tattn.paged_attention
    monkeypatch.setattr(dispatch, "_use_kernel", lambda x: True)
    monkeypatch.setattr(tattn, "paged_attention",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    dispatch.reset_stats()
    got = _schedule(tm, tp, prompts, 7, ids, tbank, **kw)
    np.testing.assert_array_equal(got, want)
    n_steps = 2 * kw["chunk"]           # 1 prefill token + 2 chunks of 3
    assert len(calls) == dispatch.stats["paged"] == 2 * n_steps
    assert dispatch.stats["bgmv"] == 2 * 2 * (1 + n_steps)
