"""Card-only tests of repro_torch's kernels (marker ``cuda``).

They import torch and numpy only, so they run where the card is and JAX is
not: ``python -m pytest -m cuda tests/test_torch_cuda.py``.  Without a CUDA
device each test skips.  Tolerance: |kernel - plain| <= 1e-4 x max(1,
max|plain|); both accumulate in fp32 (bf16 inputs are upcast exactly), only
the order of the sums differs.  A bf16 output (#13 over bf16 pools) may in
addition sit one bf16 rounding step (2^-7 of |plain|) away: both round fp32
values that differ in their last bits."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.quant import quantize                   # noqa: E402
from repro_torch.kernels import bgmv, dispatch, lora_matmul    # noqa: E402
from repro_torch.kernels import paged_attention as pa          # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    lora_matmul.reset_launches()
    bgmv.reset_launches()
    pa.reset_launches()


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
                                     (33, 65, 17, 1)])
def test_lora_kernels_match_plain(card, m, k, n, r, dtype):
    lm = lora_matmul
    x, w, a, b, g = _operands(m, k, n, r, getattr(torch, dtype))
    y, p = lm.lora_fwd(x, w, a, b, 1.5)
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
    assert lm.launches == _launches(lora_fwd=1, lora_bwd_dx=1, lora_bwd_da=1,
                                    lora_bwd_db=1)


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
        n = 0 if plain else 2 * cfg.num_layers
        assert lora_matmul.launches == _launches(
            lora_fwd=n, lora_bwd_dx=n, lora_bwd_da=n, lora_bwd_db=n)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,softcap", [(None, None), (5, 30.0)])
@pytest.mark.parametrize("b,h,kh,hd,bs,mb", [(4, 8, 1, 256, 16, 10),
                                             (3, 6, 2, 80, 5, 3)])
def test_paged_attention_matches_plain(card, b, h, kh, hd, bs, mb, window,
                                       softcap, dtype):
    """#13 against its plain version over fp32 and bf16 pools: staggered
    and wrapped fills, and one idle slot whose table row points at the
    null block 0."""
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
        filled = (vlen // 2, vlen, vlen + 3)[i % 3]
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
    want = pa.paged_attention_plain(*args, window=window, softcap=softcap)
    torch.cuda.synchronize()
    _assert_close(got, want, dt)
    assert pa.launches["paged_attention"] == 1


def _packed(k, n, bits, seed=0):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((k, n)) * k ** -0.5).astype(
        np.float32)).cuda()
    return quantize(w, bits, 64)


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
                                     (3, 70, 50, 9), (1, 70, 50, 9)])
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
                                     (3, 100, 30, 3)])
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
        n = 0 if plain else 2 * cfg.num_layers
        u = 0 if plain else 5 * cfg.num_layers
        assert lora_matmul.launches == _launches(
            lora_fwd_quant=n, lora_bwd_dx_quant=n, lora_bwd_da=n,
            lora_bwd_db=n, quant_matmul=u, quant_matmul_dx=max(0, u - 1))
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
