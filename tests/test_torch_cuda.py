"""Card-only tests of repro_torch's kernels (marker ``cuda``).

They import torch and numpy only, so they run where the card is and JAX is
not: ``python -m pytest -m cuda tests/test_torch_cuda.py``.  Without a CUDA
device each test skips.  Tolerance: |kernel - plain| <= 1e-4 x max(1,
max|plain|); both accumulate in fp32 (bf16 inputs are upcast exactly), only
the order of the sums differs.  A bf16 output (#13 over bf16 pools) may in
addition sit one bf16 rounding step (2^-7 of |plain|) away: both round fp32
values that differ in their last bits."""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.quant import quantize                   # noqa: E402
from repro_torch.kernels import bgmv, dispatch, lora_matmul    # noqa: E402
from repro_torch.kernels import flash_attention as fa          # noqa: E402
from repro_torch.kernels import ops                            # noqa: E402
from repro_torch.kernels import paged_attention as pa          # noqa: E402
from repro_torch.kernels import rglru_scan as rs               # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    for mod in (lora_matmul, bgmv, pa, rs, fa):
        mod.reset_launches()


def _operands(m, k, n, r, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((m, k)),
            rng.standard_normal((k, n)) * k ** -0.5,
            rng.standard_normal((r, k)) * 0.05,
            rng.standard_normal((n, r)) * 0.05,
            rng.standard_normal((m, n)))
    return [torch.from_numpy(a.astype(np.float32)).cuda().to(dtype)
            for a in arrs]


def _launches(**counts):
    """lora_matmul's launch counts: ``counts``, every other kernel 0."""
    return {k: counts.get(k, 0) for k in lora_matmul.launches}


def _assert_close(got, want, dtype=torch.float32):
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    got, want = got.float(), want.float()
    scale = max(1.0, float(want.abs().max()))
    bound = 1e-4 * scale
    if dtype == torch.bfloat16:
        bound = bound + 2 ** -7 * want.abs()
    assert bool(((got - want).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,r", [(512, 2048, 256, 64), (50, 70, 30, 3),
                                     (33, 65, 17, 1), (300, 1000, 4100, 8)])
def test_lora_kernels_match_plain(card, m, k, n, r, dtype):
    """#5-#8 against their plain versions; #5 twice, bit for bit (its split
    passes add their partial sums in a fixed order)."""
    lm = lora_matmul
    x, w, a, b, g = _operands(m, k, n, r, getattr(torch, dtype))
    y, p = lm.lora_fwd(x, w, a, b, 1.5)
    y2, p2 = lm.lora_fwd(x, w, a, b, 1.5)
    assert torch.equal(y, y2) and torch.equal(p, p2)
    y_want, p_want = lm.lora_fwd_plain(x, w, a, b, 1.5)
    dx, q = lm.lora_bwd_dx(g, w, a, b, 1.5)
    dx_want, q_want = lm.lora_bwd_dx_plain(g, w, a, b, 1.5)
    da = lm.lora_bwd_da(q_want, x, 1.5)
    db = lm.lora_bwd_db(g, p_want, 1.5)
    torch.cuda.synchronize()
    for got, want in ((y, y_want), (p, p_want), (dx, dx_want), (q, q_want),
                      (da, lm.lora_bwd_da_plain(q_want, x, 1.5)),
                      (db, lm.lora_bwd_db_plain(g, p_want, 1.5))):
        _assert_close(got, want)
    assert lm.launches == _launches(lora_fwd=2, lora_bwd_dx=1, lora_bwd_da=1,
                                    lora_bwd_db=1)


# bench-4l (benchmarks/common.py bench_config: d_model 128, 4 heads of 32
# with 2 kv heads, the paper's ranks up to 512) at 4 x 64 tokens: m = 256,
# k = 128, n = 128 (q) or 64 (v), r > k from 256 on
BENCH4L_SHAPES = [(256, 128, n, r) for n in (128, 64)
                  for r in (4, 64, 256, 512)]
# #7 / #8 beyond those: the training path's q and v (clusters of 7 and
# 16), m = 4096 (a CTA loops over 16-37 slabs), m = 10 (under one slab),
# ragged ni / nj (the scalar path), and 256 tiles of dA (c = 1: no cluster)
GRAD_SHAPES = BENCH4L_SHAPES + [
    (512, 2048, 2048, 64), (512, 2048, 256, 64), (4096, 2048, 256, 64),
    (10, 128, 64, 8), (50, 70, 30, 3), (33, 65, 17, 1), (512, 2048, 256, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,r", GRAD_SHAPES)
def test_lora_grads_match_plain_and_repeat(card, m, k, n, r, dtype):
    """#7 (dA = gamma q^T x) and #8 (dB = gamma g^T p), one cluster launch
    each, against their plain versions with fp32 and bf16 x and g; two
    calls equal bit for bit (the clusters add their partials in rank
    order)."""
    lm = lora_matmul
    x, _, _, _, g = _operands(m, k, n, r, getattr(torch, dtype), seed=r + 2)
    rng = np.random.default_rng(m + r)
    q, p = (torch.from_numpy(rng.standard_normal((m, r)).astype(np.float32))
            .cuda() for _ in range(2))
    da, da2 = lm.lora_bwd_da(q, x, 1.5), lm.lora_bwd_da(q, x, 1.5)
    db, db2 = lm.lora_bwd_db(g, p, 1.5), lm.lora_bwd_db(g, p, 1.5)
    torch.cuda.synchronize()
    assert torch.equal(da, da2) and torch.equal(db, db2)
    _assert_close(da, lm.lora_bwd_da_plain(q, x, 1.5))
    _assert_close(db, lm.lora_bwd_db_plain(g, p, 1.5))
    assert lm.launches == _launches(lora_bwd_da=2, lora_bwd_db=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,r", BENCH4L_SHAPES)
def test_bench4l_dense_rank_kernels_match_plain(card, m, k, n, r, dtype):
    """#5 and #6 at bench-4l's shapes, ranks above k included, against
    their plain versions (outputs and residuals); two calls equal bit for
    bit."""
    lm = lora_matmul
    x, w, a, b, g = _operands(m, k, n, r, getattr(torch, dtype), seed=r)
    got = lm.lora_fwd(x, w, a, b, 1.5) + lm.lora_bwd_dx(g, w, a, b, 1.5)
    again = lm.lora_fwd(x, w, a, b, 1.5) + lm.lora_bwd_dx(g, w, a, b, 1.5)
    want = (lm.lora_fwd_plain(x, w, a, b, 1.5)
            + lm.lora_bwd_dx_plain(g, w, a, b, 1.5))
    torch.cuda.synchronize()
    for gt, ag, wt in zip(got, again, want):
        assert torch.equal(gt, ag)
        _assert_close(gt, wt)
    assert lm.launches == _launches(lora_fwd=2, lora_bwd_dx=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n,r", BENCH4L_SHAPES)
def test_bench4l_packed_rank_kernels_match_plain(card, m, k, n, r, bits,
                                                 dtype):
    """#9 and #10 over an int8 / int4 (group 64) W at bench-4l's shapes,
    ranks above k included, against their plain versions (outputs and
    residuals); two calls equal bit for bit."""
    lm = lora_matmul
    x, _, a, b, g = _operands(m, k, n, r, getattr(torch, dtype), seed=r)
    wq = _packed(k, n, bits, seed=r + 1)
    got = (lm.lora_fwd_quant(x, wq, a, b, 1.5)
           + lm.lora_bwd_dx_quant(g, wq, a, b, 1.5))
    again = (lm.lora_fwd_quant(x, wq, a, b, 1.5)
             + lm.lora_bwd_dx_quant(g, wq, a, b, 1.5))
    want = (lm.lora_fwd_quant_plain(x, wq, a, b, 1.5)
            + lm.lora_bwd_dx_quant_plain(g, wq, a, b, 1.5))
    torch.cuda.synchronize()
    for gt, ag, wt in zip(got, again, want):
        assert torch.equal(gt, ag)
        _assert_close(gt, wt)
    assert lm.launches == _launches(lora_fwd_quant=2, lora_bwd_dx_quant=2)


@pytest.mark.cuda
def test_loss_gradients_reach_adapters(card):
    """The fault this slice repairs: a single adapter on the card used to go
    to the BGMV kernel, whose output has no grad_fn.  Now the loss's
    gradients reach A and B through #5-#8 and match the plain tier's."""
    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.lora import AdapterSet, init_lora
    from repro_torch.models.api import build_model
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config("gemma-2b").reduced()
    model = build_model(cfg)
    gen = torch.Generator("cuda").manual_seed(0)
    params = model.init(gen, "cuda")
    lora = init_lora(params, gen, LoRAConfig(rank=8))
    lora = tree_map(lambda t: t + 0.02 * torch.randn(
        t.shape, generator=gen, device="cuda"), lora)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                         device="cuda")
    grads = {}
    for plain in (False, True):
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), lora)
        lora_matmul.reset_launches()
        with dispatch.plain_tier() if plain else torch.enable_grad():
            loss, _ = model.loss(params, {"tokens": toks},
                                 adapters=AdapterSet(lora=leaves, gamma=2.0))
            grads[plain] = torch.autograd.grad(loss, tree_leaves(leaves))
        # the forward runs twice: once, and in the backward's recompute
        # of each repeat unit
        n = 0 if plain else 2 * cfg.num_layers
        assert lora_matmul.launches == _launches(
            lora_fwd=2 * n, lora_bwd_dx=n, lora_bwd_da=n, lora_bwd_db=n)
    for got, want in zip(grads[False], grads[True]):
        assert float(got.abs().max()) > 0
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-5)


@pytest.mark.cuda
def test_bgmv_raises_under_autograd(card):
    x, w, a, b, _ = _operands(4, 64, 32, 4, torch.float32)
    bank_a, bank_b = a[None].requires_grad_(True), b[None]
    with pytest.raises(RuntimeError, match="no backward"):
        bgmv.bgmv_matmul(x[None], w, bank_a, bank_b)
    with pytest.raises(RuntimeError, match="no backward"):
        bgmv.bgmv_gemv(x[:1], w, bank_a, bank_b)
    with torch.no_grad():
        bgmv.bgmv_matmul(x[None], w, bank_a, bank_b)
    assert bgmv.launches["bgmv_matmul"] == 1


# #13's shapes (b, h, kh, hd, bs, mb) and the split they plan on a 132-SM
# card (common.paged_split)
PAGED_CASES = [
    (4, 8, 1, 256, 16, 10),     # gemma-2b path: 10 chunks of 1 column
    (3, 6, 2, 80, 5, 3),        # ragged: bs 5, hd 80, two kv heads
    (4, 16, 1, 256, 16, 10),    # the hybrid's 16 query heads
    (4, 16, 1, 256, 16, 128),   # long context: 32 chunks of 4 columns
    (4, 8, 1, 256, 16, 1),      # one column: unsplit, no merge
    (4, 8, 1, 256, 32, 10),     # 2 sub-blocks a column
    (140, 4, 1, 64, 16, 6),     # b kh fills the card: unsplit
    (2, 3, 1, 70, 7, 9),        # hd off every vector multiple: element path
    (4, 32, 32, 128, 16, 10),   # llama2-7b: MHA, hd 128 (b kh fills the card)
    (4, 32, 8, 128, 16, 10),    # qwen3-8b: 4 query heads a kv head
    (4, 32, 32, 64, 16, 10),    # stablelm-1.6b: MHA, hd 64
    (4, 16, 16, 128, 16, 10),   # qwen2-moe-a2.7b: MHA, hd 128
    (4, 16, 8, 64, 16, 10),     # granite-moe-1b-a400m: 2 query heads a kv
    (4, 16, 16, 64, 16, 10),    # whisper-medium's decoder: MHA, hd 64
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,softcap", [(None, None), (5, 30.0),
                                            (2048, None)])
@pytest.mark.parametrize("b,h,kh,hd,bs,mb", PAGED_CASES)
def test_paged_attention_matches_plain(card, b, h, kh, hd, bs, mb, window,
                                       softcap, dtype):
    """#13 against its plain version over fp32 and bf16 pools: staggered
    and wrapped fills (some chunks with no attendable position), and one
    idle slot whose table row points at the null block 0; split and
    unsplit plans; two calls equal bit for bit."""
    rng = np.random.default_rng(1)
    npool = 1 + (b - 1) * mb
    q = torch.from_numpy(rng.standard_normal((b, h, hd)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (npool, bs, kh, hd)).astype(np.float32)) for _ in range(2))
    table = torch.zeros(b, mb, dtype=torch.int32)
    table[:b - 1] = torch.arange(1, npool, dtype=torch.int32).reshape(-1, mb)
    pos_pool = torch.full((npool, bs), -1, dtype=torch.int32)
    vlen, qpos = mb * bs, []
    for i in range(b - 1):
        filled = max(1, (vlen // 2, vlen, vlen + 3)[i % 3])
        pos = torch.arange(filled)
        vslot = pos % vlen
        pos_pool[table[i, vslot // bs].long(), vslot % bs] = pos.int()
        qpos.append(filled - 1)
    pos_pool[0, 0] = 7
    qpos = torch.tensor(qpos + [7], dtype=torch.int32)
    dt = getattr(torch, dtype)
    args = ([t.cuda().to(dt) for t in (q, kp, vp)]
            + [t.cuda() for t in (pos_pool, table, qpos)])
    got = pa.paged_attention(*args, window=window, softcap=softcap)
    again = pa.paged_attention(*args, window=window, softcap=softcap)
    want = pa.paged_attention_plain(*args, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_close(got, want, dt)
    assert pa.launches["paged_attention"] == 2


def _packed(k, n, bits, seed=0, group=64, wdtype="float32"):
    """A seeded W (k, n) packed int8 / int4 (``group``) from weights of
    ``wdtype``."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((k, n)) * k ** -0.5).astype(
        np.float32)).cuda()
    return quantize(w.to(getattr(torch, wdtype)), bits, group)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (512, 2048, 256),
                                   (5, 70, 50), (13, 70, 50)])
def test_quant_matmul_matches_plain(card, bits, m, k, n, dtype):
    """#11 against x @ dequantize(W), in its decode form (m <= 8) and its
    tile form, with fp32 and bf16 activations; k = 70 leaves int4 rows past
    k."""
    wq = _packed(k, n, bits)
    x = torch.randn(m, k, device="cuda").to(getattr(torch, dtype))
    got = lora_matmul.quant_matmul(x, wq)
    want = lora_matmul.quant_matmul_plain(x, wq)
    torch.cuda.synchronize()
    _assert_close(got, want)
    assert lora_matmul.launches["quant_matmul"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("s,k,n,r", [(1, 2048, 2048, 8), (128, 2048, 256, 8),
                                     (3, 70, 50, 9), (1, 70, 50, 9),
                                     (128, 4096, 4096, 8),
                                     (37, 1000, 4100, 64)])
@pytest.mark.parametrize("with_ids", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bgmv_quant_matches_plain(card, bits, s, k, n, r, with_ids, dtype):
    """#3 (s > 1) and #4 (s == 1) against their plain versions, with fp32
    and bf16 activations and adapters."""
    dt = getattr(torch, dtype)
    wq = _packed(k, n, bits, seed=2)
    x = torch.randn(4, s, k, device="cuda").to(dt)
    a = (torch.randn(3 if with_ids else 4, r, k, device="cuda") * 0.05).to(dt)
    b = (torch.randn(a.shape[0], n, r, device="cuda") * 0.05).to(dt)
    ids = (torch.tensor([2, 0, 1, 2], dtype=torch.int32, device="cuda")
           if with_ids else None)
    if s == 1:
        got = bgmv.bgmv_gemv_quant(x[:, 0].contiguous(), wq, a, b, ids)
        want = bgmv.bgmv_gemv_quant_plain(x[:, 0], wq, a, b, ids)
    else:
        got = bgmv.bgmv_matmul_quant(x, wq, a, b, ids)
        want = bgmv.bgmv_matmul_quant_plain(x, wq, a, b, ids)
    torch.cuda.synchronize()
    _assert_close(got, want)
    assert sum(bgmv.launches.values()) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n,r", [(512, 2048, 2048, 64),
                                     (512, 2048, 256, 64), (50, 100, 30, 3),
                                     (3, 100, 30, 3), (300, 1000, 4100, 1)])
def test_packed_training_kernels_match_plain(card, bits, m, k, n, r, dtype):
    """#9, #10 and #12 against their plain versions at the training path's
    q and v shapes, a ragged one (k = 100: an int4 W holds 128 rows, the
    last 28 masked) and at m = 3, with fp32 and bf16 activations."""
    lm = lora_matmul
    x, _, a, b, g = _operands(m, k, n, r, getattr(torch, dtype), seed=3)
    wq = _packed(k, n, bits, seed=4)
    y, p = lm.lora_fwd_quant(x, wq, a, b, 1.5)
    y_want, p_want = lm.lora_fwd_quant_plain(x, wq, a, b, 1.5)
    dx, q = lm.lora_bwd_dx_quant(g, wq, a, b, 1.5)
    dx_want, q_want = lm.lora_bwd_dx_quant_plain(g, wq, a, b, 1.5)
    dx0 = lm.quant_matmul_dx(g, wq)
    torch.cuda.synchronize()
    for got, want in ((y, y_want), (p, p_want), (dx, dx_want), (q, q_want),
                      (dx0, lm.quant_matmul_dx_plain(g, wq))):
        _assert_close(got, want)
    assert lm.launches == _launches(lora_fwd_quant=1, lora_bwd_dx_quant=1,
                                    quant_matmul_dx=1)


# #12 on the rank-fused forward tile, (m, k, n) and the split planned on a
# 132-SM card (common.dx_plan)
DX_CASES = [
    (512, 2048, 16384),    # w_up: 2 chunks
    (512, 16384, 2048),    # w_down: 512 tiles, unsplit
    (512, 2048, 256),      # k: 2 chunks of 8 slabs
    (300, 1000, 4100),     # m, k, n off every tile multiple; int4 kq 1024
    (37, 70, 50),          # n % 4 != 0: the element path; int4 kq 128
    (50, 100, 30),         # the same, odd again
]


@pytest.mark.cuda
@pytest.mark.parametrize("bf16w", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n", DX_CASES)
def test_quant_matmul_dx_matches_plain_and_repeats(card, m, k, n, bits, dtype,
                                                   bf16w):
    """#12 against g @ dequantize(W)^T over bases packed from fp32 and bf16
    weights, with fp32 and bf16 activations, split and unsplit; two calls
    equal bit for bit."""
    rng = np.random.default_rng(m + k + n)
    w = torch.from_numpy((rng.standard_normal((k, n)) * k ** -0.5).astype(
        np.float32)).cuda()
    wq = quantize(w.bfloat16() if bf16w else w, bits, 64)
    g = torch.from_numpy(rng.standard_normal((m, n)).astype(
        np.float32)).cuda().to(getattr(torch, dtype))
    got = lora_matmul.quant_matmul_dx(g, wq)
    again = lora_matmul.quant_matmul_dx(g, wq)
    want = lora_matmul.quant_matmul_dx_plain(g, wq)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_close(got, want)
    assert lora_matmul.launches == _launches(quant_matmul_dx=2)


# #11 (k, n): the vector paths (GEMV 16-byte loads, tile float4), the GEMV's
# 8-byte loads (n % 16 == 8), its byte loads with the tile's vector path
# (n % 8 == 4), and both scalar paths (odd n, k % 4 != 0); k = 4096 and
# 1000 split k into several chunks
QMM_SHAPES = [(2048, 2048), (4096, 264), (1000, 4100), (70, 51)]
# (bits, int4 group): groups below a slab take the tile's element path
QMM_PACKINGS = [(8, 64), (4, 8), (4, 16), (4, 32), (4, 64), (4, 128)]
# (activation dtype, weights the base was packed from)
QMM_TYPES = [("float32", "float32"), ("bfloat16", "float32"),
             ("float32", "bfloat16")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,wdtype", QMM_TYPES)
@pytest.mark.parametrize("bits,group", QMM_PACKINGS)
@pytest.mark.parametrize("k,n", QMM_SHAPES)
@pytest.mark.parametrize("m", [1, 3, 4, 8, 9, 512])
def test_quant_matmul_forms_match_plain_and_repeat(card, m, k, n, bits,
                                                   group, dtype, wdtype):
    """#11 in its packed GEMV form (m <= 8) and on the forward tile (m >
    8) against x @ dequantize(W), over int8 and int4 bases of every group
    size from 8 to 128, packed from fp32 or bf16 weights, with fp32 and
    bf16 activations; two calls equal bit for bit."""
    wq = _packed(k, n, bits, m + k + n + group, group, wdtype)
    x = torch.randn(m, k, device="cuda").to(getattr(torch, dtype))
    got = lora_matmul.quant_matmul(x, wq)
    again = lora_matmul.quant_matmul(x, wq)
    want = lora_matmul.quant_matmul_plain(x, wq)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_close(got, want)
    assert lora_matmul.launches == _launches(quant_matmul=2)


# #10 (m, k, n): the training path's q and v, m, k, n off every tile
# multiple, and the scalar path (n % 4 != 0)
LORA_DX_Q_SHAPES = [(512, 2048, 2048), (512, 2048, 256), (300, 1000, 4100),
                    (37, 70, 50), (50, 100, 30)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,wdtype", QMM_TYPES)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("r", [1, 8, 64])
@pytest.mark.parametrize("m,k,n", LORA_DX_Q_SHAPES)
def test_lora_bwd_dx_quant_matches_plain_and_repeats(card, m, k, n, r, bits,
                                                     dtype, wdtype):
    """#10 (the rank-fused dx: q = g B, then g dequant(W)^T + gamma q A)
    against its plain version, dx and q, over bases packed from fp32 and
    bf16 weights, with fp32 and bf16 activations; two calls equal bit for
    bit."""
    lm = lora_matmul
    _, _, a, b, g = _operands(m, k, n, r, getattr(torch, dtype), seed=r)
    wq = _packed(k, n, bits, m + r, wdtype=wdtype)
    dx, q = lm.lora_bwd_dx_quant(g, wq, a, b, 1.5)
    dx2, q2 = lm.lora_bwd_dx_quant(g, wq, a, b, 1.5)
    dx_want, q_want = lm.lora_bwd_dx_quant_plain(g, wq, a, b, 1.5)
    torch.cuda.synchronize()
    assert torch.equal(dx, dx2) and torch.equal(q, q2)
    _assert_close(dx, dx_want)
    _assert_close(q, q_want)
    assert lm.launches == _launches(lora_bwd_dx_quant=2)


# #6 (m, k, n, r): the training path's q and v (v splits both passes on a
# 132-SM card), a plan that splits both passes with m, k, n off every tile
# multiple, and k, n, r off multiples of 4 (the scalar path)
LORA_DX_SHAPES = [(512, 2048, 2048, 64), (512, 2048, 256, 64),
                  (300, 1000, 4100, 8), (50, 70, 30, 3), (33, 65, 17, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,r", LORA_DX_SHAPES)
def test_lora_bwd_dx_matches_plain_and_repeats(card, m, k, n, r, dtype):
    """#6 (the rank-fused dx over a dense W: q = g B, then g W^T + gamma q
    A) against its plain version, dx and q, with fp32 and bf16 operands;
    two calls equal bit for bit."""
    lm = lora_matmul
    _, w, a, b, g = _operands(m, k, n, r, getattr(torch, dtype), seed=r + 1)
    dx, q = lm.lora_bwd_dx(g, w, a, b, 1.5)
    dx2, q2 = lm.lora_bwd_dx(g, w, a, b, 1.5)
    dx_want, q_want = lm.lora_bwd_dx_plain(g, w, a, b, 1.5)
    torch.cuda.synchronize()
    assert torch.equal(dx, dx2) and torch.equal(q, q2)
    _assert_close(dx, dx_want)
    _assert_close(q, q_want)
    assert lm.launches == _launches(lora_bwd_dx=2)


# the rank-fused forward tile (#2, #3, #5, #9): (B, s, k, n, r, ranks of a
# mixed-rank bank) with m = B s rows; the planned split on a 132-SM card
FWD_CASES = [
    (4, 128, 2048, 256, 8, None),             # gemma-2b v: split 15 ways
    (4, 128, 4096, 4096, 8, None),            # recurrentgemma-9b q: unsplit
    (4, 128, 2048, 2048, 64, (4, 8, 16, 64)),  # mixed ranks: split 2 ways
    (3, 37, 1000, 4100, 8, (1, 8, 3)),        # m, k, n off every multiple
    (5, 29, 333, 250, 1, None),               # odd widths: element path
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,s,k,n,r,ranks", FWD_CASES)
def test_fwd_tile_kernels_match_plain_and_repeat(card, B, s, k, n, r, ranks,
                                                 dtype):
    """#2 (bank ids and ids=None), #3 (int8, int4 with kq > k where k is no
    multiple of 64), #5 and #9 against their plain versions, each called
    twice with results equal bit for bit."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(B * s + k)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).cuda().to(dt)
    x, w = arr(B, s, k), arr(k, n, scale=k ** -0.5)
    a, b = arr(B, r, k, scale=0.05), arr(B, n, r, scale=0.05)
    for t, rt in enumerate(ranks or ()):
        a[t, rt:] = 0
        b[t, :, rt:] = 0
    ids = torch.tensor([(2 * i + 1) % B for i in range(B)], dtype=torch.int32,
                       device="cuda")
    x2, a2, b2 = x.reshape(B * s, k), a[0].contiguous(), b[0].contiguous()
    wqs = {bits: _packed(k, n, bits, seed=5) for bits in (8, 4)}
    calls = {
        "bgmv_matmul ids": (lambda: bgmv.bgmv_matmul(x, w, a, b, ids),
                            lambda: bgmv.bgmv_matmul_plain(x, w, a, b, ids)),
        "bgmv_matmul none": (lambda: bgmv.bgmv_matmul(x, w, a, b),
                             lambda: bgmv.bgmv_matmul_plain(x, w, a, b)),
        "lora_fwd": (lambda: lora_matmul.lora_fwd(x2, w, a2, b2, 1.5),
                     lambda: lora_matmul.lora_fwd_plain(x2, w, a2, b2, 1.5)),
    }
    for bits, wq in wqs.items():
        calls[f"bgmv_matmul_quant int{bits}"] = (
            lambda wq=wq: bgmv.bgmv_matmul_quant(x, wq, a, b, ids),
            lambda wq=wq: bgmv.bgmv_matmul_quant_plain(x, wq, a, b, ids))
        calls[f"lora_fwd_quant int{bits}"] = (
            lambda wq=wq: lora_matmul.lora_fwd_quant(x2, wq, a2, b2, 1.5),
            lambda wq=wq: lora_matmul.lora_fwd_quant_plain(x2, wq, a2, b2,
                                                           1.5))
    for name, (kfn, pfn) in calls.items():
        got, again, want = kfn(), kfn(), pfn()
        torch.cuda.synchronize()
        got, again, want = ((t if isinstance(t, tuple) else (t,))
                            for t in (got, again, want))
        for g_, a_, w_ in zip(got, again, want):
            assert torch.equal(g_, a_), name
            _assert_close(g_, w_)
    assert bgmv.launches == {"bgmv_matmul": 4, "bgmv_gemv": 0,
                             "bgmv_matmul_quant": 4, "bgmv_gemv_quant": 0}
    assert lora_matmul.launches == _launches(lora_fwd=2, lora_fwd_quant=4)


# #1 / #4 on the decode GEMV: (k, n, r) of the paths' v and q, and a
# ragged shape (odd n, k no multiple of a slab); rows of x from one to past
# a block's 8 (two groups)
GEMV_SHAPES = [(2048, 256, 8), (2048, 2048, 8), (70, 50, 3)]
GEMV_ROWS = [1, 3, 4, 8, 11]
# (bits, weights the base was packed from)
GEMV_PACKINGS = [(8, "float32"), (4, "float32"), (8, "bfloat16"),
                 (4, "bfloat16")]


def _gemv_bank(nreq, k, n, r, dt, seed):
    """x (nreq, k) and a bank of nreq + 2 adapters A, B of ``dt``; the ids
    a shuffled draw over the bank, and the bank gathered per request (for
    ids=None)."""
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).cuda().to(dt)
    x = arr(nreq, k)
    a, b = arr(nreq + 2, r, k, scale=0.05), arr(nreq + 2, n, r, scale=0.05)
    ids = torch.from_numpy(rng.permutation(nreq + 2)[:nreq].astype(
        np.int32)).cuda()
    gathered = (a.index_select(0, ids.long()).contiguous(),
                b.index_select(0, ids.long()).contiguous())
    return x, (a, b, ids), (*gathered, None)


def _gemv_checks(kfn, pfn, x, w, banks):
    """kfn against pfn with bank ids and with ids=None, each called twice
    with results equal bit for bit."""
    for a, b, ids in banks:
        got, again = kfn(x, w, a, b, ids), kfn(x, w, a, b, ids)
        want = pfn(x, w, a, b, ids)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _assert_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n,r", GEMV_SHAPES)
@pytest.mark.parametrize("nreq", GEMV_ROWS)
def test_bgmv_gemv_matches_plain_and_repeats(card, nreq, k, n, r, dtype):
    """#1 over a dense W of x's type, fp32 and bf16, against its plain
    version with shuffled bank ids and ids=None; 1 to 11 rows of x."""
    dt = getattr(torch, dtype)
    x, bank, gathered = _gemv_bank(nreq, k, n, r, dt, nreq + k + n)
    w = (torch.randn(k, n, device="cuda") * k ** -0.5).to(dt)
    _gemv_checks(bgmv.bgmv_gemv, bgmv.bgmv_gemv_plain, x, w,
                 (bank, gathered))
    assert bgmv.launches == {"bgmv_matmul": 0, "bgmv_gemv": 4,
                             "bgmv_matmul_quant": 0, "bgmv_gemv_quant": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,wdtype", GEMV_PACKINGS)
@pytest.mark.parametrize("k,n,r", GEMV_SHAPES)
@pytest.mark.parametrize("nreq", GEMV_ROWS)
def test_bgmv_gemv_quant_matches_plain_and_repeats(card, nreq, k, n, r, bits,
                                                   wdtype, dtype):
    """#4 over int8 and int4 (group 64) bases packed from fp32 or bf16
    weights, with fp32 and bf16 x / A / B, against its plain version with
    shuffled bank ids and ids=None; 1 to 11 rows of x."""
    dt = getattr(torch, dtype)
    x, bank, gathered = _gemv_bank(nreq, k, n, r, dt, nreq + k + bits)
    wq = _packed(k, n, bits, seed=nreq + n, wdtype=wdtype)
    _gemv_checks(bgmv.bgmv_gemv_quant, bgmv.bgmv_gemv_quant_plain, x, wq,
                 (bank, gathered))
    assert bgmv.launches == {"bgmv_matmul": 0, "bgmv_gemv": 0,
                             "bgmv_matmul_quant": 0, "bgmv_gemv_quant": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_loss_gradients_over_packed_base_reach_adapters(card, mode):
    """Over a packed base the loss's gradients reach A and B through #9,
    #10, #7, #8, #11 and #12 and match the plain tier's, which
    dequantizes."""
    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.lora import AdapterSet, init_lora
    from repro_torch.core.quant import quantize_tree
    from repro_torch.models.api import build_model
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config("gemma-2b").reduced()
    model = build_model(cfg)
    gen = torch.Generator("cuda").manual_seed(0)
    params = model.init(gen, "cuda")
    lora = init_lora(params, gen, LoRAConfig(rank=8))
    lora = tree_map(lambda t: t + 0.02 * torch.randn(
        t.shape, generator=gen, device="cuda"), lora)
    base = quantize_tree(params, mode, 64)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                         device="cuda")
    grads = {}
    for plain in (False, True):
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), lora)
        lora_matmul.reset_launches()
        with dispatch.plain_tier() if plain else torch.enable_grad():
            loss, _ = model.loss(base, {"tokens": toks},
                                 adapters=AdapterSet(lora=leaves, gamma=2.0))
            grads[plain] = torch.autograd.grad(loss, tree_leaves(leaves))
        # the forwards run again in the backward's recompute of each
        # repeat unit (one layer), which stops before the unit's last
        # projection (w_down: nothing the backward needs comes after it)
        n = 0 if plain else 2 * cfg.num_layers
        u = 0 if plain else 5 * cfg.num_layers
        assert lora_matmul.launches == _launches(
            lora_fwd_quant=2 * n, lora_bwd_dx_quant=n, lora_bwd_da=n,
            lora_bwd_db=n, quant_matmul=u + u * 4 // 5,
            quant_matmul_dx=max(0, u - 1))
    for got, want in zip(grads[False], grads[True]):
        assert float(got.abs().max()) > 0
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_bf16_packed_base_through_the_six_packed_kernels(card, bits):
    """A base packed from bf16 weights dequantizes to each fp32 product
    rounded to bf16; #3, #4, #9, #10, #11 and #12 form the same elements
    and agree with their plain versions (fp32 activations)."""
    lm = lora_matmul
    k, n, r = 100, 48, 4
    wq = quantize(torch.randn(k, n, device="cuda", dtype=torch.bfloat16), bits,
                  64)
    x, _, a, b, g = _operands(24, k, n, r, torch.float32, seed=6)
    bank_a, bank_b = a[None].expand(4, r, k).contiguous(), \
        b[None].expand(4, n, r).contiguous()
    pairs = [(lm.lora_fwd_quant(x, wq, a, b, 1.5),
              lm.lora_fwd_quant_plain(x, wq, a, b, 1.5)),
             (lm.lora_bwd_dx_quant(g, wq, a, b, 1.5),
              lm.lora_bwd_dx_quant_plain(g, wq, a, b, 1.5)),
             (lm.quant_matmul(x, wq), lm.quant_matmul_plain(x, wq)),
             (lm.quant_matmul(x[:4], wq), lm.quant_matmul_plain(x[:4], wq)),
             (lm.quant_matmul_dx(g, wq), lm.quant_matmul_dx_plain(g, wq)),
             (bgmv.bgmv_matmul_quant(x.reshape(4, 6, k), wq, bank_a, bank_b),
              bgmv.bgmv_matmul_quant_plain(x.reshape(4, 6, k), wq, bank_a,
                                           bank_b)),
             (bgmv.bgmv_gemv_quant(x[:4], wq, bank_a, bank_b),
              bgmv.bgmv_gemv_quant_plain(x[:4], wq, bank_a, bank_b))]
    torch.cuda.synchronize()
    for got, want in pairs:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for gt, wt in zip(got, want):
            _assert_close(gt, wt)
    assert sum(lm.launches.values()) == 5
    assert sum(bgmv.launches.values()) == 2


@pytest.mark.cuda
def test_quant_kernels_raise_where_refused(card):
    """What stays refused: the quantized BGMV kernels under autograd (they
    have no backward), and a base packed from weights of a dtype whose
    rounding no loader forms (float16)."""
    wq = _packed(64, 32, 4)
    x = torch.randn(3, 64, device="cuda")
    a = torch.zeros(3, 4, 64, device="cuda", requires_grad=True)
    b = torch.zeros(3, 32, 4, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        bgmv.bgmv_gemv_quant(x, wq, a, b)
    with pytest.raises(RuntimeError, match="no backward"):
        bgmv.bgmv_matmul_quant(x[None], wq, a[:1], b[:1])
    wq16 = quantize(torch.randn(64, 32, device="cuda", dtype=torch.float16),
                    4, 64)
    a2, b2 = torch.zeros(4, 64, device="cuda"), torch.zeros(32, 4,
                                                             device="cuda")
    with torch.no_grad():
        for call in (lambda: lora_matmul.quant_matmul(x, wq16),
                     lambda: lora_matmul.quant_matmul_dx(x[:, :32], wq16),
                     lambda: lora_matmul.lora_fwd_quant(x, wq16, a2, b2, 1.0),
                     lambda: bgmv.bgmv_gemv_quant(x, wq16, a.detach(), b),
                     lambda: bgmv.bgmv_matmul_quant(x[None], wq16,
                                                    a.detach()[:1], b[:1])):
            with pytest.raises(TypeError, match="float16"):
                call()
    assert not any(lora_matmul.launches.values())


# ------------------------------------------------- #15 scan, #14 attention

def _cuda(*arrs, dtype="float32"):
    return [torch.from_numpy(np.asarray(a, np.float32)).cuda().to(
        getattr(torch, dtype)) for a in arrs]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bt,s,d", [(4, 128, 512), (2, 300, 96),
                                    (3, 100, 1000), (1, 1, 7)])
def test_rglru_scan_equals_plain(card, bt, s, d, dtype):
    """One rounded product and one rounded sum per step in both, an fp32
    carry, one rounding of each stored h_t: the kernel equals the plain
    version bit for bit."""
    rng = np.random.default_rng(bt * s + d)
    a, b = _cuda(rng.uniform(0.5, 0.999, (bt, s, d)),
                 rng.standard_normal((bt, s, d)), dtype=dtype)
    got, want = rs.rglru_scan(a, b), rs.rglru_scan_plain(a, b)
    torch.cuda.synchronize()
    assert got.dtype == a.dtype and torch.equal(got, want)
    assert rs.launches["rglru_scan"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,bkv,s,t,d,causal,window", [
    (4, 4, 256, 256, 64, True, None), (4, 2, 256, 256, 128, False, None),
    (2, 1, 512, 512, 256, True, 128), (4, 4, 128, 512, 64, False, None),
    (3, 1, 100, 70, 80, False, 16), (2, 2, 64, 64, 40, True, 5),
    # the kernel's 64-row query and 64-key tiles: s and t off their
    # multiples, windows inside one key tile, each head dim's capacity
    (2, 1, 200, 130, 256, True, 48), (4, 2, 90, 300, 128, False, None),
    (2, 2, 130, 130, 37, True, None), (8, 1, 512, 512, 256, True, None),
    (3, 3, 330, 330, 64, True, 33), (2, 1, 64, 500, 256, False, 60)])
def test_flash_attention_matches_plain(card, bh, bkv, s, t, d, causal,
                                       window, dtype):
    """Tolerances of tests/test_kernels.py: 2e-5 relative (fp32), 3e-2
    (bf16), with an absolute floor five times that.  A bf16 output is held
    to one bf16 step of |plain| (plus 1e-3) as well: both round fp32 values
    that differ in their last bits, and the floor alone would let zeros
    through where the outputs are small.  A second call equals the first
    bit for bit."""
    rng = np.random.default_rng(s + t + d)
    q, k, v = _cuda(rng.standard_normal((bh, s, d)),
                    rng.standard_normal((bkv, t, d)),
                    rng.standard_normal((bkv, t, d)), dtype=dtype)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    again = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    tol = 2e-5 if dtype == "float32" else 3e-2
    assert got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=5 * tol)
    if dtype == "bfloat16":
        diff = (got.float() - want.float()).abs()
        assert bool((diff <= 2 ** -7 * want.float().abs() + 1e-3).all())
    assert fa.launches["flash_attention"] == 2


@pytest.mark.cuda
def test_flash_mha_gqa_on_card(card):
    rng = np.random.default_rng(3)
    q, k, v = _cuda(rng.standard_normal((2, 256, 8, 64)),
                    rng.standard_normal((2, 256, 2, 64)),
                    rng.standard_normal((2, 256, 2, 64)))
    got = ops.flash_mha(q, k, v, causal=True, window=64)
    kx, vx = (x.repeat_interleave(4, dim=2) for x in (k, v))
    want = ops.flash_mha(q.cpu(), kx.cpu(), vx.cpu(), causal=True, window=64)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=1e-4)
    assert fa.launches["flash_attention"] == 1


@pytest.mark.cuda
def test_scan_and_attention_raise_under_autograd(card):
    a = torch.rand(1, 4, 8, device="cuda", requires_grad=True)
    q = torch.randn(1, 8, 16, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        rs.rglru_scan(a, torch.rand(1, 4, 8, device="cuda"))
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(q, q.detach(), q.detach())
    with torch.no_grad():
        rs.rglru_scan(a, a)
        fa.flash_attention(q, q, q)
    assert rs.launches["rglru_scan"] == fa.launches["flash_attention"] == 1


@pytest.mark.cuda
def test_hybrid_prefill_scans_once_per_rglru_layer(card):
    """A small recurrentgemma-pattern stack on the card: the prefill runs
    #15 once per RG-LRU layer and #2 at q, v, wx and wy; a decode step runs
    no scan; the logits equal the plain tier's within 1e-4."""
    from repro_torch.configs.base import LoRAConfig, ModelConfig
    from repro_torch.core.lora import AdapterBank, init_adapter_set
    from repro_torch.models.api import build_model
    cfg = ModelConfig(name="hybrid", family="hybrid", num_layers=5,
                      d_model=128, num_heads=4, num_kv_heads=1, head_dim=32,
                      d_ff=256, vocab_size=512, mlp_variant="geglu",
                      block_pattern=("rglru", "rglru", "attn"),
                      attn_window=16, rglru_d_state=128,
                      lora_targets=("q", "v", "wx", "wy"))
    model = build_model(cfg)
    gen = torch.Generator("cuda").manual_seed(0)
    params = model.init(gen, "cuda")
    bank = AdapterBank.from_sets([init_adapter_set(
        params, gen, LoRAConfig(rank=4, targets=cfg.lora_targets))] * 2)
    toks = torch.randint(0, 512, (2, 24), device="cuda", generator=gen)
    out = {}
    with torch.inference_mode():
        for plain in (False, True):
            for mod in (bgmv, rs):
                mod.reset_launches()
            with dispatch.plain_tier() if plain else torch.no_grad():
                cache = model.init_cache(2, 32, device="cuda")
                lg, cache = model.prefill(params, cache, toks[:, :20],
                                          bank.requests([1, 0]))
                lg2, _ = model.decode_step(
                    params, cache, toks[:, 20:21],
                    torch.full((2,), 20, device="cuda"),
                    bank.requests([1, 0]))
            out[plain] = (lg, lg2)
            n = 0 if plain else 1
            assert rs.launches["rglru_scan"] == 4 * n
            assert bgmv.launches["bgmv_matmul"] == 10 * n
            assert bgmv.launches["bgmv_gemv"] == 10 * n
    for got, want in zip(out[False], out[True]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------- the dense configs' widths

# #11 at llama2-7b's MLP: w_up (k 4096, n 11008 = 43 column blocks of 256)
# and w_down (k 11008: its decode GEMV's last chunk of k is short, 768 of
# 1024 rows on a 132-SM card; int4 holds 172 groups of 64 rows)
@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k,n", [(4096, 11008), (11008, 4096)])
@pytest.mark.parametrize("m", [1, 4, 8, 512])
def test_quant_matmul_at_llama_mlp_matches_plain_and_repeats(card, m, k, n,
                                                             bits):
    wq = _packed(k, n, bits, seed=m + k)
    x = torch.randn(m, k, device="cuda")
    got, again = lora_matmul.quant_matmul(x, wq), lora_matmul.quant_matmul(
        x, wq)
    want = lora_matmul.quant_matmul_plain(x, wq)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_close(got, want)
    assert lora_matmul.launches == _launches(quant_matmul=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,active", [(64, 64), (128, 128), (128, 16)])
def test_lora_kernels_at_llama_qv_match_plain_and_repeat(card, r, active,
                                                         dtype):
    """#5-#8 at llama2-7b's q and v (m = 4 x 128, k = n = 4096), rank 64
    and 128, and a client of rank 16 padded to 128 (rows of A and columns
    of B past 16 zero, as the heterogeneous trainer holds them): against
    their plain versions, each called twice with results equal bit for bit;
    the padded rows' gradients come out zero where the plain versions' do."""
    lm = lora_matmul
    x, w, a, b, g = _operands(512, 4096, 4096, r, getattr(torch, dtype),
                              seed=r + active)
    a[active:] = 0
    b[:, active:] = 0
    outs = {}
    for name, call in (
            ("fwd", lambda: lm.lora_fwd(x, w, a, b, 1.5)),
            ("dx", lambda: lm.lora_bwd_dx(g, w, a, b, 1.5))):
        got, again = call(), call()
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(got, again)), name
        outs[name] = got
    (y, p), (dx, q) = outs["fwd"], outs["dx"]
    y_want, p_want = lm.lora_fwd_plain(x, w, a, b, 1.5)
    dx_want, q_want = lm.lora_bwd_dx_plain(g, w, a, b, 1.5)
    da, da2 = lm.lora_bwd_da(q_want, x, 1.5), lm.lora_bwd_da(q_want, x, 1.5)
    db, db2 = lm.lora_bwd_db(g, p_want, 1.5), lm.lora_bwd_db(g, p_want, 1.5)
    torch.cuda.synchronize()
    assert torch.equal(da, da2) and torch.equal(db, db2)
    for got, want in ((y, y_want), (p, p_want), (dx, dx_want), (q, q_want),
                      (da, lm.lora_bwd_da_plain(q_want, x, 1.5)),
                      (db, lm.lora_bwd_db_plain(g, p_want, 1.5))):
        _assert_close(got, want)
    assert bool((p[:, active:] == 0).all())
    assert bool((q[:, active:] == 0).all())
    assert bool((da[active:] == 0).all()) and bool((db[:, active:] == 0).all())
    assert lm.launches == _launches(lora_fwd=2, lora_bwd_dx=2, lora_bwd_da=2,
                                    lora_bwd_db=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", [(5120, 4096), (5120, 1024), (4096, 4096)])
def test_bgmv_at_the_dense_configs_matches_plain_and_repeats(card, k, n,
                                                             dtype):
    """#1 (4 decode rows) and #2 (4 x 128 prefill rows) at mistral-nemo-12b's
    q (5120 -> 4096) and v (5120 -> 1024) and llama2-7b's q / v (4096 ->
    4096), rank 8, with bank ids and ids=None, each called twice with
    results equal bit for bit."""
    dt = getattr(torch, dtype)
    x, bank, gathered = _gemv_bank(4, k, n, 8, dt, k + n)
    w = (torch.randn(k, n, device="cuda") * k ** -0.5).to(dt)
    _gemv_checks(bgmv.bgmv_gemv, bgmv.bgmv_gemv_plain, x, w,
                 (bank, gathered))
    x3 = (torch.randn(4, 128, k, device="cuda")).to(dt)
    for a, b, ids in (bank, gathered):
        got, again = (bgmv.bgmv_matmul(x3, w, a, b, ids) for _ in range(2))
        want = bgmv.bgmv_matmul_plain(x3, w, a, b, ids)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _assert_close(got, want)
    assert bgmv.launches == {"bgmv_matmul": 4, "bgmv_gemv": 4,
                             "bgmv_matmul_quant": 0, "bgmv_gemv_quant": 0}


# --------------------------------- the RG-LRU hybrid's training widths

# #15's backward: the hybrid's training and prefill shape, the kernel
# bench's long sequence, a ragged shape and s = 1
SCAN_BWD_SHAPES = [(4, 128, 4096), (4, 2048, 256), (3, 100, 1000), (2, 1, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bt,s,d", SCAN_BWD_SHAPES)
def test_rglru_scan_bwd_equals_plain_and_repeats(card, bt, s, d, dtype):
    """One rounded product and one rounded sum per step of the reverse
    chain, one rounded product for da, an fp32 carry: the kernel equals the
    plain reverse loop bit for bit, and a second call the first."""
    rng = np.random.default_rng(bt * s + d + 1)
    a, b, g = _cuda(rng.uniform(0.5, 0.999, (bt, s, d)),
                    rng.standard_normal((bt, s, d)),
                    rng.standard_normal((bt, s, d)), dtype=dtype)
    h = rs.rglru_scan_plain(a, b)
    got, again = rs.rglru_scan_bwd(a, h, g), rs.rglru_scan_bwd(a, h, g)
    want = rs.rglru_scan_bwd_plain(a, h, g)
    torch.cuda.synchronize()
    for gt, ag, wt in zip(got, again, want):
        assert gt.dtype == a.dtype
        assert torch.equal(gt, ag) and torch.equal(gt, wt)
    assert rs.launches == {"rglru_scan": 0, "rglru_scan_bwd": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_scan_function_on_card_equals_plain_tier(card, dtype):
    """The differentiable scan on the card (#15 forward, its backward
    kernel) against the same Function under the plain tier, with an
    initial state folded in as the model folds it and a strided
    cotangent: h and the gradients of a, b and h0 bit for bit; the plain
    tier launches nothing."""
    from repro_torch.models.rglru import rglru_scan as model_scan
    rng = np.random.default_rng(4)
    a, b, h0, g = _cuda(rng.uniform(0.5, 0.999, (4, 128, 4096)),
                        rng.standard_normal((4, 128, 4096)),
                        rng.standard_normal((4, 4096)),
                        rng.standard_normal((4, 4096, 128)), dtype=dtype)
    g = g.transpose(1, 2)
    out = {}
    for plain in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in (a, b, h0)]
        with dispatch.plain_tier() if plain else torch.enable_grad():
            h = model_scan(*leaves)
            h.backward(g)
        out[plain] = [h.detach()] + [t.grad for t in leaves]
        if not plain:
            assert rs.launches == {"rglru_scan": 1, "rglru_scan_bwd": 1}
    torch.cuda.synchronize()
    assert rs.launches == {"rglru_scan": 1, "rglru_scan_bwd": 1}
    for got, want in zip(out[False], out[True]):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_packed_lora_kernels_at_hybrid_widths_match_plain(card, bits, dtype):
    """#9, #10, #7 and #8 at recurrentgemma-9b's wx / wy / q (m = 4 x 128,
    k = n = 4096, rank 64) over int8 and int4 (group 64) bases: against
    their plain versions, each called twice with results equal bit for
    bit."""
    lm = lora_matmul
    x, _, a, b, g = _operands(512, 4096, 4096, 64, getattr(torch, dtype),
                              seed=bits)
    wq = _packed(4096, 4096, bits, seed=40 + bits)
    for kfn, pfn, args in (
            (lm.lora_fwd_quant, lm.lora_fwd_quant_plain, (x, wq, a, b, 1.5)),
            (lm.lora_bwd_dx_quant, lm.lora_bwd_dx_quant_plain,
             (g, wq, a, b, 1.5))):
        got, again = kfn(*args), kfn(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(got, again))
        for gt, wt in zip(got, pfn(*args)):
            _assert_close(gt, wt)
    _, p = lm.lora_fwd_quant_plain(x, wq, a, b, 1.5)
    _, q = lm.lora_bwd_dx_quant_plain(g, wq, a, b, 1.5)
    da, da2 = lm.lora_bwd_da(q, x, 1.5), lm.lora_bwd_da(q, x, 1.5)
    db, db2 = lm.lora_bwd_db(g, p, 1.5), lm.lora_bwd_db(g, p, 1.5)
    torch.cuda.synchronize()
    assert torch.equal(da, da2) and torch.equal(db, db2)
    _assert_close(da, lm.lora_bwd_da_plain(q, x, 1.5))
    _assert_close(db, lm.lora_bwd_db_plain(g, p, 1.5))
    assert lm.launches == _launches(lora_fwd_quant=2, lora_bwd_dx_quant=2,
                                    lora_bwd_da=2, lora_bwd_db=2)


# #11 and #12 at recurrentgemma-9b's MLP: w_up / w_gate (k 4096, n 12288 =
# 48 column blocks of 256) and w_down (k 12288 = 192 int4 groups of 64)
@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k,n", [(4096, 12288), (12288, 4096)])
def test_packed_base_kernels_at_hybrid_mlp_match_plain(card, k, n, bits):
    """#11 at m = 4 (its packed GEMV) and 512 (the forward tile) and #12 at
    m = 512, over int8 and int4 bases: against their plain versions, each
    called twice with results equal bit for bit."""
    lm = lora_matmul
    wq = _packed(k, n, bits, seed=k + bits)
    for m in (4, 512):
        x = torch.randn(m, k, device="cuda")
        got, again = lm.quant_matmul(x, wq), lm.quant_matmul(x, wq)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _assert_close(got, lm.quant_matmul_plain(x, wq))
    g = torch.randn(512, n, device="cuda")
    got, again = lm.quant_matmul_dx(g, wq), lm.quant_matmul_dx(g, wq)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_close(got, lm.quant_matmul_dx_plain(g, wq))
    assert lm.launches == _launches(quant_matmul=4, quant_matmul_dx=2)


# --------------------------------------- the fault-tolerant engine on card

FT_MODEL = dict(name="ft-card", family="dense", num_layers=2, d_model=128,
                num_heads=2, num_kv_heads=1, head_dim=64, d_ff=256,
                vocab_size=256)


def _ft_trainer(**fed):
    from repro_torch.configs import base as tbase
    from repro_torch.core.federated import FederatedTrainer
    from repro_torch.data.synthetic import FederatedDataset
    from repro_torch.models.api import build_model
    model = build_model(tbase.ModelConfig(**FT_MODEL))
    n = 4
    return FederatedTrainer(
        model, FederatedDataset(256, n, seq_len=32, batch_per_client=2,
                                seed=0),
        lora_cfg=tbase.LoRAConfig(rank=8, alpha=8.0),
        fed_cfg=tbase.FederatedConfig(num_clients=n, local_steps=2,
                                      aggregation="fedsa", **fed),
        opt_cfg=tbase.OptimizerConfig(name="sgd", lr=0.05), seed=0,
        chunk_rounds=2, track_stability=True, device="cuda")


def _ft_state(tr):
    from repro_torch.tree import tree_leaves
    extra = tr.async_state if tr.async_state is not None else {}
    return tree_leaves({"l": tr.lora, "o": tr.opt_state, "x": extra})


@pytest.mark.cuda
def test_buffered_null_faults_equals_sync_on_kernel_tier(card):
    """Buffer 0 (no cap) and no faults on the card: the synchronous engine,
    bit for bit, through #5-#8."""
    sync = _ft_trainer()
    sync.run(4)
    n_sync = dict(lora_matmul.launches)
    lora_matmul.reset_launches()
    buf = _ft_trainer(buffer_size=0)
    buf.run(4)
    assert dict(lora_matmul.launches) == n_sync and n_sync["lora_fwd"] > 0
    for a, b in zip(_ft_state(sync), _ft_state(buf)):
        assert torch.equal(a, b)
    assert [h["loss"] for h in sync.history] == [h["loss"] for h in
                                                 buf.history]
    assert all(h["n_eff"] == 4.0 and h["gamma_scale"] == 1.0
               for h in buf.history)


FT_FAULTS = dict(dropout=0.2, straggle=0.3, corrupt=0.25)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["nan", "noise"])
def test_faulted_rounds_repeat_bit_for_bit(card, mode):
    from repro_torch.core.faults import FaultConfig
    faults = FaultConfig(**FT_FAULTS, corrupt_mode=mode)
    runs = []
    for _ in range(2):
        tr = _ft_trainer(buffer_size=0, faults=faults)
        tr.run(4)
        runs.append(tr)
    assert runs[0].history == runs[1].history
    for a, b in zip(_ft_state(runs[0]), _ft_state(runs[1])):
        assert torch.equal(a, b)
    assert all(bool(torch.isfinite(x).all()) for x in _ft_state(runs[0]))
    assert lora_matmul.launches["lora_fwd"] > 0


@pytest.mark.cuda
def test_faulted_kernel_tier_matches_plain_tier(card):
    """The same fault schedule (the round generators live on the card in
    both) on the kernel and the plain tier: the same delivered / rejected /
    stale counts, loss and grad-norm within 1e-3 relative."""
    from repro_torch.core.faults import FaultConfig
    faults = FaultConfig(**FT_FAULTS)
    kern = _ft_trainer(buffer_size=2, faults=faults)
    kern.run(4)
    assert lora_matmul.launches["lora_fwd"] > 0
    lora_matmul.reset_launches()
    with dispatch.plain_tier():
        plain = _ft_trainer(buffer_size=2, faults=faults)
        plain.run(4)
    assert not any(lora_matmul.launches.values())
    for hk, hp in zip(kern.history, plain.history):
        for key in ("delivered", "rejected", "stale"):
            assert hk[key] == hp[key]
        for key in ("loss", "grad_norm"):
            assert abs(hk[key] - hp[key]) <= 1e-3 * abs(hp[key])


# ------------------------------------------------ the MoE family's widths

# (k, n) of the adapted projections: granite-moe-1b-a400m's q (1024 ->
# 1024) and v (1024 -> 512), qwen2-moe-a2.7b's q = v (2048 -> 2048)
MOE_QV = [(1024, 1024), (1024, 512), (2048, 2048)]
# granite-moe-1b-a400m's packed q / k / v / o (k, n)
GRANITE_QKVO = [(1024, 1024), (1024, 512), (1024, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r", [8, 64])
@pytest.mark.parametrize("k,n", MOE_QV)
def test_bgmv_at_moe_shapes_matches_plain_and_repeats(card, k, n, r, dtype):
    """#1 (4 decode rows) and #2 (4 x 128 prefill rows) at the MoE archs'
    q and v, ranks 8 and 64, with bank ids and ids=None, each called twice
    with results equal bit for bit."""
    dt = getattr(torch, dtype)
    x, bank, gathered = _gemv_bank(4, k, n, r, dt, k + n + r)
    w = (torch.randn(k, n, device="cuda") * k ** -0.5).to(dt)
    _gemv_checks(bgmv.bgmv_gemv, bgmv.bgmv_gemv_plain, x, w,
                 (bank, gathered))
    x3 = (torch.randn(4, 128, k, device="cuda")).to(dt)
    for a, b, ids in (bank, gathered):
        got, again = (bgmv.bgmv_matmul(x3, w, a, b, ids) for _ in range(2))
        want = bgmv.bgmv_matmul_plain(x3, w, a, b, ids)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _assert_close(got, want)
    assert bgmv.launches == {"bgmv_matmul": 4, "bgmv_gemv": 4,
                             "bgmv_matmul_quant": 0, "bgmv_gemv_quant": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r", [8, 64])
@pytest.mark.parametrize("k,n", MOE_QV)
def test_lora_kernels_at_moe_shapes_match_plain_and_repeat(card, k, n, r,
                                                           dtype):
    """#5-#8 at the MoE archs' q and v (m = 4 x 128), ranks 8 and 64:
    against their plain versions, each called twice with results equal bit
    for bit."""
    lm = lora_matmul
    x, w, a, b, g = _operands(512, k, n, r, getattr(torch, dtype),
                              seed=k + n + r)
    got = {}
    for name, call in (("fwd", lambda: lm.lora_fwd(x, w, a, b, 1.5)),
                       ("dx", lambda: lm.lora_bwd_dx(g, w, a, b, 1.5))):
        first, again = call(), call()
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(first, again)), name
        got[name] = first
    (y, p), (dx, q) = got["fwd"], got["dx"]
    y_want, p_want = lm.lora_fwd_plain(x, w, a, b, 1.5)
    dx_want, q_want = lm.lora_bwd_dx_plain(g, w, a, b, 1.5)
    da, da2 = lm.lora_bwd_da(q_want, x, 1.5), lm.lora_bwd_da(q_want, x, 1.5)
    db, db2 = lm.lora_bwd_db(g, p_want, 1.5), lm.lora_bwd_db(g, p_want, 1.5)
    torch.cuda.synchronize()
    assert torch.equal(da, da2) and torch.equal(db, db2)
    for gt, want in ((y, y_want), (p, p_want), (dx, dx_want), (q, q_want),
                     (da, lm.lora_bwd_da_plain(q_want, x, 1.5)),
                     (db, lm.lora_bwd_db_plain(g, p_want, 1.5))):
        _assert_close(gt, want)
    assert lm.launches == _launches(lora_fwd=2, lora_bwd_dx=2, lora_bwd_da=2,
                                    lora_bwd_db=2)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k,n", sorted(set(GRANITE_QKVO)))
def test_packed_kernels_at_granite_widths_match_plain(card, k, n, bits):
    """Over granite-moe's int8 / int4 (group 64) q / k / v / o: #3 and #4
    (rank 8 bank), #9 and #10 (rank 64), #11 at m = 4 and 512 and #12 at
    m = 512, against their plain versions, each called twice with results
    equal bit for bit."""
    lm = lora_matmul
    wq = _packed(k, n, bits, seed=k + n + bits)
    x, bank, gathered = _gemv_bank(4, k, n, 8, torch.float32, k + n)
    _gemv_checks(bgmv.bgmv_gemv_quant, bgmv.bgmv_gemv_quant_plain, x, wq,
                 (bank, gathered))
    x3 = torch.randn(4, 128, k, device="cuda")
    for a, b, ids in (bank, gathered):
        got, again = (bgmv.bgmv_matmul_quant(x3, wq, a, b, ids)
                      for _ in range(2))
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _assert_close(got, bgmv.bgmv_matmul_quant_plain(x3, wq, a, b, ids))
    x2, _, a, b, g = _operands(512, k, n, 64, torch.float32, seed=bits)
    for kfn, pfn, args in (
            (lm.lora_fwd_quant, lm.lora_fwd_quant_plain, (x2, wq, a, b, 1.5)),
            (lm.lora_bwd_dx_quant, lm.lora_bwd_dx_quant_plain,
             (g, wq, a, b, 1.5))):
        got, again = kfn(*args), kfn(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(got, again))
        for gt, wt in zip(got, pfn(*args)):
            _assert_close(gt, wt)
    for m in (4, 512):
        xm = torch.randn(m, k, device="cuda")
        got, again = lm.quant_matmul(xm, wq), lm.quant_matmul(xm, wq)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _assert_close(got, lm.quant_matmul_plain(xm, wq))
    got, again = lm.quant_matmul_dx(g, wq), lm.quant_matmul_dx(g, wq)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_close(got, lm.quant_matmul_dx_plain(g, wq))
    assert bgmv.launches["bgmv_gemv_quant"] == 4
    assert bgmv.launches["bgmv_matmul_quant"] == 4
    assert lm.launches == _launches(lora_fwd_quant=2, lora_bwd_dx_quant=2,
                                    quant_matmul=4, quant_matmul_dx=2)


MOE_CARD = dict(name="moe-card", family="moe", num_layers=2, d_model=128,
                num_heads=2, num_kv_heads=1, head_dim=64, d_ff=64,
                vocab_size=256)


def _moe_cfg(**moe):
    from repro_torch.configs import base as tbase
    kw = dict(num_experts=20, top_k=4, num_shared_experts=1, d_ff_expert=64,
              d_ff_shared=128)
    kw.update(moe)
    return tbase.ModelConfig(**MOE_CARD, moe=tbase.MoEConfig(**kw))


@pytest.mark.cuda
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_apply_on_card_repeats_and_matches_cpu(card, cf):
    """The MoE MLP on the card (index_add dispatch, bmm experts, gather
    back): two calls and two backward passes bit for bit (the drop slot,
    whose atomics run in any order, is never read), and the CPU's output
    and input gradient within 1e-4."""
    from repro_torch.models import moe
    cfg = _moe_cfg(capacity_factor=cf)
    gen = torch.Generator().manual_seed(0)
    params = moe.moe_params(cfg, gen)
    x = torch.randn(4, 32, 128, generator=gen)
    g = torch.randn(4, 32, 128, generator=gen)
    out = {}
    for dev in ("cuda", "cuda", "cpu"):
        p = {k: v.to(dev) for k, v in params.items()}
        xd = x.to(dev).requires_grad_(True)
        y, aux = moe.moe_apply(cfg, p, xd)
        (y * g.to(dev)).sum().add(aux).backward()
        out.setdefault(dev, []).append((y.detach().cpu(), aux.detach().cpu(),
                                        xd.grad.cpu()))
    (y1, a1, g1), (y2, a2, g2) = out["cuda"]
    assert torch.equal(y1, y2) and torch.equal(a1, a2) and torch.equal(g1, g2)
    for got, want in zip(out["cuda"][0], out["cpu"][0]):
        _assert_close(got, want)


@pytest.mark.cuda
def test_device_data_draws_on_card_without_host_sync(card):
    """DeviceFederatedData on a CUDA generator: int32 tokens on the card in
    range, the same state giving the same tokens, and no host
    synchronisation while a round is drawn."""
    from repro_torch.data.synthetic import (DeviceFederatedData,
                                            FederatedDataset)
    ds = FederatedDataset(256, 16, seq_len=128, batch_per_client=4,
                          partition="dirichlet", seed=0)
    dd = DeviceFederatedData.from_host(ds, "cuda")
    gen = torch.Generator("cuda").manual_seed(3)
    state = gen.get_state()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks = dd.sample_round(gen, 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert toks.device.type == "cuda" and toks.dtype == torch.int32
    assert tuple(toks.shape) == (16, 2, 4, 128)
    assert 0 <= int(toks.min()) and int(toks.max()) < 256
    gen.set_state(state)
    assert torch.equal(dd.sample_round(gen, 2), toks)


# -------------------------------------------------------------- xLSTM

# model-level bounds, as chip_smoke.py's LOGIT_ATOL and TRAIN_RTOL: the
# tiers differ in the order of the adapted projections' sums, and the
# sLSTM's recurrence carries that difference through 128 steps
XLSTM_ATOL = 1e-3


def _xlstm_card(rank=8):
    """xlstm-1.3b at full width with one mLSTM and one sLSTM layer (seeded
    random weights on the card) and 4 SFed-LoRA tenants of ``rank``, A and
    B perturbed so that B is not zero."""
    import dataclasses
    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.lora import AdapterBank, init_adapter_set
    from repro_torch.models.api import build_model
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_config("xlstm-1.3b"), num_layers=2)
    model = build_model(cfg)
    gen = torch.Generator("cuda").manual_seed(0)
    params = model.init(gen, "cuda")
    sets = []
    for _ in range(4):
        s = init_adapter_set(params, gen, LoRAConfig(rank=rank, alpha=8.0),
                             n_clients=4)
        sets.append(dataclasses.replace(s, lora=tree_map(
            lambda t: t + 0.02 * torch.randn(t.shape, generator=gen,
                                             device="cuda"), s.lora)))
    return model, params, sets


def _tokens_on_card(shape, seed):
    return torch.randint(0, 50304, shape, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(seed))


def _close_to(got, want, atol):
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= atol * scale


@pytest.mark.cuda
def test_xlstm_serving_kernel_tier_matches_plain(card):
    """A 128-token prefill and 4 teacher-forced decode steps over a bank of
    4 tenants: 2 launches of #2 (q, v of the mLSTM) in the prefill and 2 of
    #1 a step on the kernel tier, none on the plain tier; logits within
    1e-3 and every cache leaf (fp32) within 1e-4 of the plain tier's."""
    from repro_torch.core.lora import AdapterBank
    model, params, sets = _xlstm_card()
    bank = AdapterBank.from_sets(sets)
    ids = torch.arange(4, device="cuda", dtype=torch.int32)
    prompt = _tokens_on_card((4, 128), 1)
    forced = _tokens_on_card((4, 4), 2)
    out = {}
    for plain in (False, True):
        bgmv.reset_launches()
        with torch.inference_mode(), (dispatch.plain_tier() if plain
                                      else contextlib.nullcontext()):
            adapters = bank.requests(ids)
            cache = model.init_cache(4, 132, device="cuda")
            lg, cache = model.prefill(params, cache, prompt, adapters,
                                      last_only=True)
            logits = [lg[:, -1]]
            for t in range(4):
                pos = torch.full((4,), 128 + t, device="cuda")
                lg, cache = model.decode_step(params, cache,
                                              forced[:, t:t + 1], pos,
                                              adapters)
                logits.append(lg[:, -1])
        torch.cuda.synchronize()
        launches = {k: v for k, v in bgmv.launches.items() if v}
        assert launches == ({} if plain else
                            {"bgmv_matmul": 2, "bgmv_gemv": 8}), launches
        out[plain] = (torch.stack(logits, 1), cache)
    (lk, ck), (lp, cp) = out[False], out[True]
    _close_to(lk, lp, XLSTM_ATOL)
    for key in ck["repeat"]:
        for leaf in ck["repeat"][key]:
            got, want = ck["repeat"][key][leaf], cp["repeat"][key][leaf]
            assert got.dtype == torch.float32
            _close_to(got, want, 1e-4)


@pytest.mark.cuda
def test_xlstm_lora_gradient_step_kernel_tier_matches_plain(card):
    """One LoRA gradient step (4 x 128 tokens, rank 64): #6-#8 launch twice
    each (q and v of the mLSTM) on the kernel tier, #5 four times (the
    backward recomputes the repeat unit), never on the plain tier; loss
    and the q / v gradients within 1e-3 of the plain tier's."""
    from repro_torch.core.lora import AdapterSet
    from repro_torch.tree import tree_leaves, tree_map
    model, params, sets = _xlstm_card(rank=64)
    toks = _tokens_on_card((4, 128), 3)
    out = {}
    for plain in (False, True):
        lora_matmul.reset_launches()
        leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                          sets[0].lora)
        ctx = dispatch.plain_tier() if plain else contextlib.nullcontext()
        with ctx:
            loss, _ = model.loss(params, {"tokens": toks},
                                 adapters=AdapterSet(lora=leaves,
                                                     gamma=sets[0].gamma))
            grads = torch.autograd.grad(loss, tree_leaves(leaves))
        torch.cuda.synchronize()
        assert lora_matmul.launches == _launches(
            **({} if plain else dict(lora_fwd=4, lora_bwd_dx=2,
                                     lora_bwd_da=2, lora_bwd_db=2)))
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        out[plain] = (loss.detach(), grads)
    (lk, gk), (lp, gp) = out[False], out[True]
    _close_to(lk, lp, XLSTM_ATOL)
    for got, want in zip(gk, gp):
        assert float(want.abs().max()) > 0
        _close_to(got, want, XLSTM_ATOL)


@pytest.mark.cuda
def test_xlstm_chunk_boundary_prefill_equals_prefill_then_decode(card):
    """A 300-token prefill (two chunks of 256, the second padded) leaves the
    cache a 256-token prefill and 44 decode steps leave, within 1e-4, on
    the kernel tier."""
    from repro_torch.core.lora import AdapterBank
    model, params, sets = _xlstm_card()
    bank = AdapterBank.from_sets(sets)
    ids = torch.arange(4, device="cuda", dtype=torch.int32)
    prompt = _tokens_on_card((4, 300), 4)
    with torch.inference_mode():
        adapters = bank.requests(ids)
        whole = model.init_cache(4, 300, device="cuda")
        model.prefill(params, whole, prompt, adapters, last_only=True)
        split = model.init_cache(4, 300, device="cuda")
        model.prefill(params, split, prompt[:, :256], adapters,
                      last_only=True)
        for t in range(256, 300):
            pos = torch.full((4,), t, device="cuda")
            model.decode_step(params, split, prompt[:, t:t + 1], pos,
                              adapters)
    torch.cuda.synchronize()
    for key in whole["repeat"]:
        for leaf in whole["repeat"][key]:
            _close_to(whole["repeat"][key][leaf], split["repeat"][key][leaf],
                      1e-4)


# ------------------------------------------------ whisper-medium's widths

# its MLP (1024 -> 4096, 4096 -> 1024), packed int8 / int4 (group 64), at a
# decode step's m = 4, a prefill's 4 x 128 and the encoder's 4 x 1500 frames
WHISPER_MLP = [(1024, 4096), (4096, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k,n", WHISPER_MLP)
@pytest.mark.parametrize("m", [4, 512, 6000])
def test_quant_matmul_at_whisper_mlp_matches_plain_and_repeats(card, m, k, n,
                                                               bits):
    """#11 at whisper-medium's MLP: its decode GEMV (m = 4) and its tile
    (m = 512, and m = 6000 as the encoder over a packed base runs it)."""
    wq = _packed(k, n, bits, seed=m + k)
    x = torch.randn(m, k, device="cuda")
    got, again = lora_matmul.quant_matmul(x, wq), lora_matmul.quant_matmul(
        x, wq)
    want = lora_matmul.quant_matmul_plain(x, wq)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_close(got, want)
    assert lora_matmul.launches == _launches(quant_matmul=2)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k,n", WHISPER_MLP)
def test_quantized_bgmv_at_whisper_mlp_matches_plain(card, k, n, bits):
    """#4 (decode rows) and #3 (4 x 128 rows) over whisper-medium's packed
    MLP widths with a rank 8 bank, materialized and lazy, twice each bit
    for bit."""
    wq = _packed(k, n, bits, seed=k + n + bits)
    x, bank, gathered = _gemv_bank(4, k, n, 8, torch.float32, k + n)
    _gemv_checks(bgmv.bgmv_gemv_quant, bgmv.bgmv_gemv_quant_plain, x, wq,
                 (bank, gathered))
    x3 = torch.randn(4, 128, k, device="cuda")
    for a, b, ids in (bank, gathered):
        got, again = (bgmv.bgmv_matmul_quant(x3, wq, a, b, ids)
                      for _ in range(2))
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _assert_close(got, bgmv.bgmv_matmul_quant_plain(x3, wq, a, b, ids))
    assert bgmv.launches["bgmv_gemv_quant"] == 4
    assert bgmv.launches["bgmv_matmul_quant"] == 4


def _whisper_card(rank=8):
    """whisper-medium at full width, 2 decoder and 2 encoder layers,
    seeded random weights, 4 SFed-LoRA sets with B at std 0.02 (every
    leaf)."""
    import dataclasses
    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.lora import init_adapter_set
    from repro_torch.models.api import build_model
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_config("whisper-medium"), num_layers=2,
                              encoder_layers=2)
    model = build_model(cfg)
    gen = torch.Generator("cuda").manual_seed(0)
    params = model.init(gen, "cuda")
    sets = []
    for _ in range(4):
        s = init_adapter_set(params, gen, LoRAConfig(rank=rank, alpha=8.0),
                             n_clients=4)
        sets.append(dataclasses.replace(s, lora=tree_map(
            lambda t: t + 0.02 * torch.randn(t.shape, generator=gen,
                                             device="cuda"), s.lora)))
    frames = torch.randn(4, cfg.encoder_frames, cfg.d_model, device="cuda",
                         generator=gen)
    return model, params, sets, frames


@pytest.mark.cuda
def test_whisper_serving_kernel_tier_matches_plain(card):
    """The encoder over 4 x 1500 frames, a 128-token prefill with its
    output and 4 teacher-forced decode steps over a bank of 4 tenants: 6
    launches of #2 (attn q, attn v, cross q of 2 layers) in the prefill
    and 6 of #1 a step on the kernel tier, none on the plain tier; logits
    and the cached cross K/V within 1e-4 of the plain tier's."""
    from repro_torch.core.lora import AdapterBank
    model, params, sets, frames = _whisper_card()
    bank = AdapterBank.from_sets(sets)
    ids = torch.arange(4, device="cuda", dtype=torch.int32)
    prompt = torch.randint(0, 51865, (4, 132), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    out = {}
    for plain in (False, True):
        bgmv.reset_launches()
        with torch.inference_mode(), (dispatch.plain_tier() if plain
                                      else contextlib.nullcontext()):
            adapters = bank.requests(ids)
            enc = model._encode(params, {"frames": frames})
            cache = model.init_cache(4, 132, device="cuda")
            lg, cache = model.prefill(params, cache, prompt[:, :128],
                                      adapters, enc_out=enc, last_only=True)
            logits = [lg[:, -1]]
            for t in range(128, 132):
                pos = torch.full((4,), t, device="cuda")
                lg, cache = model.decode_step(params, cache,
                                              prompt[:, t:t + 1], pos,
                                              adapters)
                logits.append(lg[:, -1])
        torch.cuda.synchronize()
        launches = {k: v for k, v in bgmv.launches.items() if v}
        assert launches == ({} if plain else
                            {"bgmv_matmul": 6, "bgmv_gemv": 24}), launches
        out[plain] = (torch.stack(logits, 1), cache["repeat"]["p0"])
    (lk, ck), (lp, cp) = out[False], out[True]
    _assert_close(lk, lp)
    for leaf in ("cross_k", "cross_v"):
        _assert_close(ck[leaf], cp[leaf])


@pytest.mark.cuda
def test_whisper_lora_gradient_step_kernel_tier_matches_plain(card):
    """One LoRA gradient step over 4 x 128 tokens and 4 x 1500 frames
    (rank 64): #6-#8 launch 6 times each, #5 12 (the backward recomputes
    each repeat unit) (attn q, attn v, cross q of 2
    layers) on the kernel tier, never on the plain tier; loss and the
    read leaves' gradients within 1e-4 of the plain tier's, the encoder's
    and cross v's none on either tier."""
    from repro_torch.core.lora import AdapterSet
    from repro_torch.tree import tree_leaves, tree_map
    model, params, sets, frames = _whisper_card(rank=64)
    toks = torch.randint(0, 51865, (4, 128), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(3))
    out = {}
    for plain in (False, True):
        lora_matmul.reset_launches()
        leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                          sets[0].lora)
        ctx = dispatch.plain_tier() if plain else contextlib.nullcontext()
        with ctx:
            loss, _ = model.loss(params, {"tokens": toks, "frames": frames},
                                 adapters=AdapterSet(lora=leaves,
                                                     gamma=sets[0].gamma))
            grads = torch.autograd.grad(loss, tree_leaves(leaves),
                                        allow_unused=True)
        torch.cuda.synchronize()
        assert lora_matmul.launches == _launches(
            **({} if plain else dict(lora_fwd=12, lora_bwd_dx=6,
                                     lora_bwd_da=6, lora_bwd_db=6)))
        out[plain] = (loss.detach(), grads)
    (lk, gk), (lp, gp) = out[False], out[True]
    _assert_close(lk, lp)
    # 4 encoder leaves (q, v: a, b) and cross v's a, b are never read
    assert sum(g is None for g in gk) == sum(g is None for g in gp) == 6
    for got, want in zip(gk, gp):
        assert (got is None) == (want is None)
        if want is not None:
            assert float(want.abs().max()) > 0
            _assert_close(got, want)


# ------------------------------------- paligemma-3b's and roberta-large's

def _card_model(arch, rank, **overrides):
    """``arch`` at full width, 2 layers, seeded random weights, 4 SFed-LoRA
    sets with B at std 0.02."""
    import dataclasses
    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.lora import init_adapter_set
    from repro_torch.models.api import build_model
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_config(arch), num_layers=2, **overrides)
    model = build_model(cfg)
    gen = torch.Generator("cuda").manual_seed(0)
    params = model.init(gen, "cuda")
    sets = []
    for _ in range(4):
        s = init_adapter_set(params, gen, LoRAConfig(rank=rank, alpha=8.0),
                             n_clients=4)
        sets.append(dataclasses.replace(s, lora=tree_map(
            lambda t: t + 0.02 * torch.randn(t.shape, generator=gen,
                                             device="cuda"), s.lora)))
    return model, params, sets, gen


def _lora_step(model, params, batch, aset):
    """(loss, LoRA gradients) of one local step."""
    from repro_torch.core.lora import AdapterSet
    from repro_torch.tree import tree_leaves, tree_map
    leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      aset.lora)
    loss, _ = model.loss(params, batch, adapters=AdapterSet(
        lora=leaves, gamma=aset.gamma))
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(leaves))


@pytest.mark.cuda
def test_paligemma_vision_prefix_kernel_tier_matches_plain(card):
    """The banked forward over 4 x (256 patches + 128 tokens) at
    paligemma-3b's widths (2 layers): 4 launches of #2 (q and v of 2
    layers, each over all 1536 rows) on the kernel tier, none on the plain
    tier; logits within 1e-4 of the plain tier's."""
    from repro_torch.core.lora import AdapterBank
    model, params, sets, gen = _card_model("paligemma-3b", 8)
    bank = AdapterBank.from_sets(sets)
    batch = {"tokens": torch.randint(0, 257216, (4, 128), device="cuda",
                                     generator=gen),
             "patches": torch.randn(4, 256, 1152, device="cuda",
                                    generator=gen)}
    out = {}
    for plain in (False, True):
        bgmv.reset_launches()
        with torch.inference_mode(), (dispatch.plain_tier() if plain
                                      else contextlib.nullcontext()):
            logits, _ = model.forward(params, batch, bank.requests(
                torch.arange(4, device="cuda", dtype=torch.int32)))
        torch.cuda.synchronize()
        launches = {k: v for k, v in bgmv.launches.items() if v}
        assert launches == ({} if plain else {"bgmv_matmul": 4}), launches
        out[plain] = logits[..., :257216]
    _assert_close(out[False], out[True])


@pytest.mark.cuda
@pytest.mark.parametrize("chunked", [False, True], ids=["plain_ce",
                                                        "chunked_ce"])
def test_paligemma_lora_gradient_step_kernel_tier_matches_plain(card,
                                                                chunked):
    """One LoRA gradient step (rank 64) over 4 x (256 patches + 600
    tokens) at paligemma-3b's widths (2 layers), with the chunked CE off
    or on (599 predicting positions: chunks of 512 and a ragged 87):
    #6-#8 launch 4 times each on the kernel tier, #5 8 (the backward
    recomputes each repeat unit), never on the plain
    tier; loss and gradients within 1e-4 of the plain tier's, and of the
    unchunked kernel tier's."""
    from repro_torch.sharding import opts
    model, params, sets, gen = _card_model("paligemma-3b", 64)
    batch = {"tokens": torch.randint(0, 257216, (4, 600), device="cuda",
                                     generator=gen),
             "patches": torch.randn(4, 256, 1152, device="cuda",
                                    generator=gen)}
    ref = _lora_step(model, params, batch, sets[0])
    out = {}
    for plain in (False, True):
        lora_matmul.reset_launches()
        if chunked:
            opts.set_opts(["chunked_ce"])
        try:
            with (dispatch.plain_tier() if plain
                  else contextlib.nullcontext()):
                out[plain] = _lora_step(model, params, batch, sets[0])
        finally:
            opts.reset()
        torch.cuda.synchronize()
        assert lora_matmul.launches == _launches(
            **({} if plain else dict(lora_fwd=8, lora_bwd_dx=4,
                                     lora_bwd_da=4, lora_bwd_db=4)))
    for got, want in ((out[False], out[True]), (out[False], ref)):
        _assert_close(got[0], want[0])
        for g, w in zip(got[1], want[1]):
            assert float(w.abs().max()) > 0
            _assert_close(g, w)


@pytest.mark.cuda
def test_roberta_mlm_step_kernel_tier_matches_plain_and_is_bidirectional(
        card):
    """roberta-large's widths (2 layers): one MLM LoRA gradient step (rank
    64) over 4 x 128 tokens launches #6-#8 4 times each on the kernel
    tier and #5 8 times (the backward recomputes each repeat unit), never
    on the plain tier, loss and gradients within 1e-4 of the
    plain tier's; on the kernel tier, changing the last token moves
    position 0's logits."""
    model, params, sets, gen = _card_model("roberta-large", 64)
    toks = torch.randint(0, 50265, (4, 128), device="cuda", generator=gen)
    out = {}
    for plain in (False, True):
        lora_matmul.reset_launches()
        with dispatch.plain_tier() if plain else contextlib.nullcontext():
            out[plain] = _lora_step(model, params, {"tokens": toks},
                                    sets[0])
        torch.cuda.synchronize()
        assert lora_matmul.launches == _launches(
            **({} if plain else dict(lora_fwd=8, lora_bwd_dx=4,
                                     lora_bwd_da=4, lora_bwd_db=4)))
    _assert_close(out[False][0], out[True][0])
    for g, w in zip(out[False][1], out[True][1]):
        _assert_close(g, w)
    other = toks.clone()
    other[:, -1] = (other[:, -1] + 1) % 50265
    with torch.inference_mode():
        a, _ = model.forward(params, {"tokens": toks}, sets[0])
        b, _ = model.forward(params, {"tokens": other}, sets[0])
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-3


# ------------------------------------------------------- training on a mesh

@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 128], ids=["q", "v"])
def test_lora_kernels_at_mesh_local_shapes_match_plain(card, n):
    """#5-#8 at a 1x2 mesh's local shards of gemma-2b's q and v (2048 ->
    1024 and 256 -> 128 columns, m = 512, r = 64): the shapes each device
    of a model axis of 2 runs, against their plain versions."""
    lm = lora_matmul
    x, w, a, b, g = _operands(512, 2048, n, 64, torch.float32, seed=n)
    y, p = lm.lora_fwd(x, w, a, b, 1.0)
    y_want, p_want = lm.lora_fwd_plain(x, w, a, b, 1.0)
    dx, q = lm.lora_bwd_dx(g, w, a, b, 1.0)
    dx_want, q_want = lm.lora_bwd_dx_plain(g, w, a, b, 1.0)
    da = lm.lora_bwd_da(q_want, x, 1.0)
    db = lm.lora_bwd_db(g, p_want, 1.0)
    torch.cuda.synchronize()
    for got, want in ((y, y_want), (p, p_want), (dx, dx_want), (q, q_want),
                      (da, lm.lora_bwd_da_plain(q_want, x, 1.0)),
                      (db, lm.lora_bwd_db_plain(g, p_want, 1.0))):
        _assert_close(got, want)
    assert lm.launches == _launches(lora_fwd=1, lora_bwd_dx=1,
                                    lora_bwd_da=1, lora_bwd_db=1)


@pytest.mark.cuda
def test_trainer_on_a_one_device_mesh_equals_no_mesh_on_card(card):
    """FederatedTrainer(mesh=) over a 1x1 mesh of a one-rank gloo group on
    the card: the same launches of #5-#8 and the same history, adapters
    and optimizer state bit for bit as without a mesh (2 layers of
    gemma-2b, 2 rounds)."""
    import socket
    import torch.distributed as dist
    from repro_torch.configs import (FederatedConfig, LoRAConfig,
                                     OptimizerConfig, get_config)
    from repro_torch.core.federated import FederatedTrainer
    from repro_torch.data.synthetic import FederatedDataset
    from repro_torch.launch.mesh import mesh_from_spec
    from repro_torch.models.api import build_model
    from repro_torch.tree import tree_leaves
    import dataclasses
    cfg = dataclasses.replace(get_config("gemma-2b"), num_layers=2)

    def run(mesh):
        tr = FederatedTrainer(
            build_model(cfg), FederatedDataset(cfg.vocab_size, 4, seq_len=64,
                                               batch_per_client=2, seed=0),
            lora_cfg=LoRAConfig(rank=64), fed_cfg=FederatedConfig(
                num_clients=4, local_steps=2, aggregation="fedsa"),
            opt_cfg=OptimizerConfig(name="sgd", lr=5e-3), seed=0,
            mesh=mesh, device="cuda")
        lora_matmul.reset_launches()
        tr.run(2)
        return tr, dict(lora_matmul.launches)

    ref, ref_launches = run(None)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        tr, launches = run(mesh_from_spec("1x1", "cuda"))
    finally:
        dist.destroy_process_group()
    assert launches == ref_launches == _launches(
        lora_fwd=128, lora_bwd_dx=64, lora_bwd_da=64, lora_bwd_db=64)
    assert tr.history == ref.history
    for a, b in zip(tree_leaves({"l": tr.lora, "o": tr.opt_state}),
                    tree_leaves({"l": ref.lora, "o": ref.opt_state})):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_grouped_moe_step_kernel_tier_matches_plain(card):
    """granite-moe's widths (2 layers) with the ``moe_grouped`` switch:
    one LoRA gradient step over 4 x 128 tokens launches #6-#8 4 times
    each on the kernel tier and #5 8 times (the backward recomputes each
    repeat unit), none on the plain tier, and gives the plain
    tier's loss and gradients within 1e-4 (the two tiers' routers pick
    the same experts at this seed; a flip would show as a large
    difference)."""
    from repro_torch.sharding import opts
    model, params, sets, gen = _card_model("granite-moe-1b-a400m", 64)
    toks = torch.randint(0, 49155, (4, 128), device="cuda", generator=gen)
    out = {}
    opts.set_opts(["moe_grouped"])
    try:
        for plain in (False, True):
            lora_matmul.reset_launches()
            with dispatch.plain_tier() if plain else contextlib.nullcontext():
                out[plain] = _lora_step(model, params, {"tokens": toks},
                                        sets[0])
            torch.cuda.synchronize()
            assert lora_matmul.launches == _launches(
                **({} if plain else dict(lora_fwd=8, lora_bwd_dx=4,
                                         lora_bwd_da=4, lora_bwd_db=4)))
    finally:
        opts.reset()
    _assert_close(out[False][0], out[True][0])
    for g, w in zip(out[False][1], out[True][1]):
        _assert_close(g, w)


# ------------------------------------------------------- the transfer guard

@pytest.mark.cuda
def test_no_implicit_transfers_raises_on_a_sync_and_restores_the_mode(card):
    """``no_implicit_transfers`` runs its region under
    ``set_sync_debug_mode("error")``: an ``.item()`` inside raises
    TransferGuardError, work that stays on the device passes, and the
    previous mode comes back after either."""
    from repro_torch.analysis.sanitizers import (TransferGuardError,
                                                 no_implicit_transfers)
    x = torch.arange(8.0, device="cuda")
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with no_implicit_transfers():
            y = (x * 2).sum()                  # stays on the device
        assert torch.cuda.get_sync_debug_mode() == 1
        with pytest.raises(TransferGuardError, match="synchroniz"):
            with no_implicit_transfers():
                (x * 2).sum().item()
        assert torch.cuda.get_sync_debug_mode() == 1
        assert float(y) == 56.0
    finally:
        torch.cuda.set_sync_debug_mode("default")
