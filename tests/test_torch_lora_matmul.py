"""repro_torch's fused LoRA matmul (kernels #5-#8 and the LoRAMatmul
Function) against the JAX package's Pallas kernels in interpret mode.

On the CPU each piece runs its plain PyTorch version, wired exactly as the
card wires the kernels.  Tolerances are the JAX package's own for the
fused tier (``tests/test_dispatch.py``): forward rtol 2e-5 / atol 2e-4,
gradients rtol = atol = 1e-4 -- fp32 on both sides, the sums taken in
another order.  The kernels themselves run only on the card:
``tests/test_torch_cuda.py`` (marker ``cuda``) and ``chip_smoke.py`` hold
them against their plain versions there."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import dispatch as jdispatch                # noqa: E402
from repro.kernels import lora_matmul as jlm                   # noqa: E402
from repro_torch.kernels import bgmv, common, dispatch         # noqa: E402
from repro_torch.kernels import lora_matmul                    # noqa: E402

FWD_TOL = dict(rtol=2e-5, atol=2e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
NO_LORA_LAUNCHES = {"lora_fwd": 0, "lora_bwd_dx": 0, "lora_bwd_da": 0,
                    "lora_bwd_db": 0, "lora_fwd_quant": 0,
                    "lora_bwd_dx_quant": 0, "quant_matmul": 0,
                    "quant_matmul_dx": 0}
NO_BGMV_LAUNCHES = {"bgmv_matmul": 0, "bgmv_gemv": 0, "bgmv_matmul_quant": 0,
                    "bgmv_gemv_quant": 0}


@pytest.fixture(autouse=True)
def _clean_counters():
    lora_matmul.reset_launches()
    bgmv.reset_launches()
    dispatch.reset_stats()
    yield


def _operands(m, k, n, r, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    a = (rng.standard_normal((r, k)) * 0.05).astype(np.float32)
    b = (rng.standard_normal((n, r)) * 0.05).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    return x, w, a, b, g


def _t(*arrs):
    return [torch.from_numpy(np.array(x)) for x in arrs]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# ------------------------------------------- plain pieces vs Pallas kernels

@pytest.mark.parametrize("m,k,n,r", [(64, 64, 64, 8), (128, 128, 64, 4)])
def test_plain_pieces_match_pallas_kernels(m, k, n, r):
    """Each plain piece against the Pallas body it stands in for, run by its
    ``_*_call`` in interpret mode (block-divisible shapes, as those calls
    need)."""
    x, w, a, b, g = _operands(m, k, n, r, seed=1)
    gamma = 1.7
    kw = dict(bm=64, bn=64, bk=64, interpret=True)
    jx, jw, ja, jb, jg = map(jnp.asarray, (x, w, a, b, g))
    tx, tw, ta, tb, tg = _t(x, w, a, b, g)

    y_want, p_want = jlm._fwd_call(jx, jw, ja, jb, gamma, **kw)
    y, p = lora_matmul.lora_fwd_plain(tx, tw, ta, tb, gamma)
    _close(y, y_want, FWD_TOL)
    _close(p, p_want, FWD_TOL)
    y_scratch = jlm._fwd_call_scratch(jx, jw, ja, jb, gamma, **kw)
    _close(y, y_scratch, FWD_TOL)

    dx_want, q_want = jlm._bwd_dx_call(jg, jw, ja, jb, gamma, **kw)
    dx, q = lora_matmul.lora_bwd_dx_plain(tg, tw, ta, tb, gamma)
    _close(dx, dx_want, GRAD_TOL)
    _close(q, q_want, GRAD_TOL)

    da_want = jlm._bwd_da_call(q_want, jx, gamma, bm=64, bk=64,
                               interpret=True)
    _close(lora_matmul.lora_bwd_da_plain(q, tx, gamma), da_want, GRAD_TOL)
    db_want = jlm._bwd_db_call(jg, p_want, gamma, bm=64, bn=64,
                               interpret=True)
    _close(lora_matmul.lora_bwd_db_plain(tg, p, gamma), db_want, GRAD_TOL)


def _function_vs_jax(x, w, a, b, g, gamma, jax_fn):
    jx, jw, ja, jb, jg = map(jnp.asarray, (x, w, a, b, g))
    y_want, vjp = jax.vjp(lambda *t: jax_fn(*t, gamma), jx, jw, ja, jb)
    dx_want, _, da_want, db_want = vjp(jg)
    tx, tw, ta, tb, tg = _t(x, w, a, b, g)
    for t in (tx, ta, tb):
        t.requires_grad_(True)
    y = lora_matmul.LoRAMatmul.apply(tx, tw, ta, tb, gamma, False)
    assert y.dtype == torch.float32 and y.grad_fn is not None
    y.backward(tg)
    _close(y, y_want, FWD_TOL)
    _close(tx.grad, dx_want, GRAD_TOL)
    _close(ta.grad, da_want, GRAD_TOL)
    _close(tb.grad, db_want, GRAD_TOL)


@pytest.mark.parametrize("m,k,n,r", [(64, 64, 64, 8), (128, 256, 128, 16)])
def test_function_matches_lora_matmul_vjp(m, k, n, r):
    _function_vs_jax(*_operands(m, k, n, r, seed=7), 2.0,
                     lambda *t: jlm.lora_matmul_vjp(*t, bm=64, bn=64, bk=64,
                                                    interpret=True))


@pytest.mark.parametrize("m,k,n,r", [(50, 70, 30, 3), (100, 300, 130, 5),
                                     (33, 65, 17, 1)])
def test_function_matches_jax_on_ragged_shapes(m, k, n, r):
    """Shapes no block divides (and rank 1): the JAX package pads them to
    block multiples (``fused_lora_apply``); the port pads nothing."""
    _function_vs_jax(*_operands(m, k, n, r, seed=3), 1.3,
                     lambda *t: jdispatch.fused_lora_apply(*t,
                                                           interpret=True))


def test_function_gradcheck_float64():
    rng = np.random.default_rng(11)
    x, w, a, b = (torch.from_numpy(rng.standard_normal(s))
                  for s in ((5, 7), (7, 6), (3, 7), (6, 3)))
    for t in (x, a, b):
        t.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x_, a_, b_: lora_matmul.LoRAMatmul.apply(x_, w, a_, b_, 0.7,
                                                        False),
        (x, a, b))


def test_function_refuses_a_trainable_base():
    x, w, a, b, _ = _t(*_operands(8, 16, 8, 2))
    w.requires_grad_(True)
    a.requires_grad_(True)
    with pytest.raises(ValueError, match="never computes dW"):
        lora_matmul.LoRAMatmul.apply(x, w, a, b, 1.0, False)


def test_function_returns_dx_only_where_needed():
    x, w, a, b, g = _t(*_operands(8, 16, 8, 2))
    a.requires_grad_(True)
    b.requires_grad_(True)
    y = lora_matmul.LoRAMatmul.apply(x, w, a, b, 1.0, False)
    da, db = torch.autograd.grad(y, (a, b), g)
    assert da.shape == a.shape and db.shape == b.shape
    assert x.grad is None


# --------------------------------------------------------------- dispatch

def test_single_adapter_goes_through_the_function():
    """A 2-D adapter takes the LoRA matmul route (a grad_fn of the Function,
    its counter moves) and never the BGMV one."""
    x, w, a, b, _ = _operands(14, 48, 40, 6, seed=5)
    tl = {"a": torch.from_numpy(a).requires_grad_(True),
          "b": torch.from_numpy(b).requires_grad_(True)}
    y = dispatch.lora_linear(torch.from_numpy(x).reshape(2, 7, 48),
                             torch.from_numpy(w), tl, 1.5)
    assert y.shape == (2, 7, 40)
    fn = y.grad_fn.next_functions[0][0]          # under the reshape
    assert "LoRAMatmul" in type(fn).__name__
    assert dispatch.stats == {"bgmv": 0, "plain": 0, "lora_matmul": 1,
                              "quant": 0, "paged": 0}
    assert bgmv.launches == NO_BGMV_LAUNCHES
    want = jdispatch.lora_linear(jnp.asarray(x), jnp.asarray(w),
                                 {"a": jnp.asarray(a), "b": jnp.asarray(b)},
                                 1.5)
    _close(y.reshape(14, 40), want, FWD_TOL)
    y.sum().backward()
    assert float(tl["a"].grad.abs().sum()) > 0
    assert float(tl["b"].grad.abs().sum()) > 0


def test_kernel_route_wires_the_four_pieces(monkeypatch):
    """With the kernel tier forced on CPU tensors (the rehearsal of the card
    run), the Function calls the four kernel wrappers once each per
    projection and backward, and a no-grad call runs the forward piece
    alone."""
    calls = dict.fromkeys(("lora_fwd", "lora_bwd_dx", "lora_bwd_da",
                           "lora_bwd_db"), 0)
    for name in calls:
        orig = getattr(lora_matmul, name)

        def counted(*args, _orig=orig, _name=name):
            calls[_name] += 1
            return _orig(*args)
        monkeypatch.setattr(lora_matmul, name, counted)
    monkeypatch.setattr(dispatch, "_use_kernel", lambda x: True)
    x, w, a, b, _ = _t(*_operands(6, 16, 12, 4, seed=2))
    lora = {"a": a.requires_grad_(True), "b": b}
    dispatch.lora_linear(x, w, lora, 1.0).sum().backward()
    assert calls == {"lora_fwd": 1, "lora_bwd_dx": 1, "lora_bwd_da": 1,
                     "lora_bwd_db": 1}
    with torch.no_grad():
        dispatch.lora_linear(x, w, lora, 1.0)
    assert calls["lora_fwd"] == 2 and calls["lora_bwd_dx"] == 1
    # CPU: no kernel
    assert lora_matmul.launches == NO_LORA_LAUNCHES


def test_plain_tier_on_cpu_launches_nothing():
    x, w, a, b, _ = _t(*_operands(6, 16, 12, 4, seed=2))
    with torch.no_grad():
        y = dispatch.lora_linear(x, w, {"a": a, "b": b}, 2.0)
    want, _ = lora_matmul.lora_fwd_plain(x, w, a, b, 2.0)
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    assert lora_matmul.launches == NO_LORA_LAUNCHES


def test_bgmv_refuses_operands_that_need_grad():
    """The BGMV kernels have no backward: on the card their wrappers raise
    under autograd instead of returning an output without a grad_fn."""
    t = torch.zeros(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        common.forward_only("bgmv_matmul", torch.zeros(2), t)
    with torch.no_grad():
        common.forward_only("bgmv_matmul", torch.zeros(2), t)
    common.forward_only("bgmv_matmul", torch.zeros(2), t.detach())


# ------------------------------------------------------------ wrapper checks

@pytest.mark.parametrize("breakage,err", [
    (lambda o: o.__setitem__("w", o["w"].double()), TypeError),
    (lambda o: o.__setitem__("x", o["x"].t().contiguous().t()), ValueError),
    (lambda o: o.__setitem__("a", o["a"][:0]), ValueError),
    (lambda o: o.__setitem__("b", o["b"][None]), ValueError),
])
def test_wrapper_checks_reject_what_the_kernel_does_not_take(breakage, err):
    x, w, a, b, _ = _t(*_operands(6, 16, 12, 4))
    ops = {"x": x, "w": w, "a": a, "b": b}
    breakage(ops)
    with pytest.raises(err):
        lora_matmul._check("lora_fwd", ops)


def test_wrapper_checks_residuals_are_fp32():
    x, *_ = _t(*_operands(6, 16, 12, 4))
    with pytest.raises(TypeError, match="float32"):
        lora_matmul._check("lora_bwd_da", {"x": x.bfloat16()},
                           fp32={"q": torch.zeros(6, 4).bfloat16()})
    lora_matmul._check("lora_bwd_da", {"x": x.bfloat16()},
                       fp32={"q": torch.zeros(6, 4)})


@pytest.mark.parametrize("m, ni, nj, want", [
    (512, 64, 2048, (8, 64)),      # dA at gemma-2b's q: 32 tiles
    (512, 2048, 64, (8, 64)),      # dB at q
    (512, 256, 64, (32, 16)),      # dB at v: 4 tiles, one step per chunk
    (50, 3, 70, (4, 16)),          # ragged: the last chunk is short
    (10, 64, 64, (1, 16)),         # fewer rows than one step
    (4096, 2048, 2048, (1, 4096)),  # enough tiles: no split
])
def test_m_split_covers_m_in_whole_steps(monkeypatch, m, ni, nj, want):
    """#7 / #8 split their m loop into chunks of whole 16-row steps, about
    two blocks per SM (132 SMs here), none of them empty."""
    monkeypatch.setattr(lora_matmul, "num_sms", lambda device: 132)
    msplit, mchunk = lora_matmul._m_split(m, ni, nj, "cuda")
    assert (msplit, mchunk) == want
    assert mchunk % 16 == 0 and (msplit - 1) * mchunk < m <= msplit * mchunk
