"""Card-only tests of repro_torch's training kernels (marker ``cuda``).

They import torch and numpy only, so they run where the card is and JAX is
not: ``python -m pytest -m cuda tests/test_torch_cuda.py``.  Without a CUDA
device each test skips.  Tolerance: |kernel - plain| <= 1e-4 x max(1,
max|plain|); both accumulate in fp32 (bf16 inputs are upcast exactly), only
the order of the sums differs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import bgmv, dispatch, lora_matmul    # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    lora_matmul.reset_launches()
    bgmv.reset_launches()


def _operands(m, k, n, r, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((m, k)),
            rng.standard_normal((k, n)) * k ** -0.5,
            rng.standard_normal((r, k)) * 0.05,
            rng.standard_normal((n, r)) * 0.05,
            rng.standard_normal((m, n)))
    return [torch.from_numpy(a.astype(np.float32)).cuda().to(dtype)
            for a in arrs]


def _assert_close(got, want):
    scale = max(1.0, float(want.abs().max()))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4 * scale


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
    assert lm.launches == {k_: 1 for k_ in lm.launches}


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
        assert lora_matmul.launches == {k: n for k in lora_matmul.launches}
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
