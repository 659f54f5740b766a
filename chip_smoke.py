#!/usr/bin/env python3
"""Smoke check of the PyTorch / CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of the checkout

Phases, in order; any failure raises and the exit code is not 0:
  1. environment: the card's name and power limit (nvidia-smi), TF32 off
  2. build: the CUDA kernels from src/repro_torch/kernels/csrc (one nvcc
     per source, in parallel, sm_90a)
  3. kernels vs plain: each BGMV kernel against its plain PyTorch version at
     the gemma-2b q/v shapes, uniform and mixed-rank banks, decode and
     prefill, a ragged case, fp32 and bf16; then their times beside the
     plain version, torch.matmul of the base product and the card's bound
  4. serving path: repro_torch.launch.serve.generate_banked on gemma-2b at
     full width (fp32, seeded random weights, 4 SFed-LoRA tenants), with
     the kernel launch counts, a teacher-forced check against the plain
     tier on the card, ms/token and a profile
  5. LoRA matmul kernels vs plain: #5-#8 (forward, dx, dA, dB) against
     their plain versions at the training path's q/v shapes and a ragged
     one, fp32 and bf16; then their times beside the plain versions, one
     torch.matmul call each and the card's bound
  6. training path: repro_torch's FederatedTrainer on gemma-2b at full
     width (fp32, seeded random base, 4 clients, fedsa + sfedlora, rank
     64), 3 rounds and a held-out eval, with the launch counts of #5-#8,
     per-round loss and grad-norm, the same run on the plain tier, a
     second kernel-tier run that must repeat bit for bit, ms/round and a
     profile of one client local step
  7. paged and quantized kernels vs plain: #13 (paged attention) at the
     scheduled path's shapes, with window and softcap variants and a ragged
     case with an idle slot; #3, #4 (quantized BGMV) and #11 (packed GEMM)
     over int8 and int4 (group 64) gemma-2b projections at m = 4 and 512;
     then their times beside the plain versions, one PyTorch call each and
     the card's bound
  8. scheduled serving path: repro_torch.launch.serve.serve_scheduled on
     gemma-2b at full width over an fp32, an int8 and an int4 base (8
     requests, two waves through 4 slots, one deadline), with the launch
     counts of #13 and #1-#4, #11, the plain tier's tokens against
     generate_banked wave by wave, the kernel tier's against the plain
     tier's, ms per decode step and tokens/s; then a short run over a
     LiveAdapterBank of 2 hot slots
  9. packed training kernels vs plain: #9, #10 (the LoRA matmul forward
     and dx over a packed W) and #12 (the packed GEMM's dx) over int8 and
     int4 (group 64) gemma-2b projections at m = 512 and a ragged case,
     fp32 and bf16 activations; a base packed from bf16 weights through
     all six packed kernels (#3, #4, #9-#12); then the times of #9, #10 and
     #12 beside their plain versions, one torch.matmul on the dequantized
     W and the card's bound
 10. training path over a packed base: the FederatedTrainer of phase 6 over
     an int8 and an int4 base (#9, #10, #7, #8 at q and v; #11 and #12 at
     k, o and the MLP), with the launch counts, a bit-identical repeat,
     save / resume bit for bit, the plain tier, ms/round and (int4) a
     profile of one client local step
 11. result: a JSON line of per-kernel numbers, the nvidia-smi line, and
     the final {"ok": true, ...} line

Needs a CUDA device and nvcc; without them it exits non-zero and prints no
result.
"""
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import (FederatedConfig, LoRAConfig,  # noqa: E402
                                 OptimizerConfig, get_config)
from repro_torch.core import federated                      # noqa: E402
from repro_torch.core.aggregation import get_strategy       # noqa: E402
from repro_torch.core.lora import (AdapterBank, LiveAdapterBank,  # noqa: E402
                                   init_adapter_set, split_ab)
from repro_torch.core.quant import (quant_footprint, quantize,  # noqa: E402
                                    quantize_tree)
from repro_torch.data.synthetic import FederatedDataset     # noqa: E402
from repro_torch.kernels import (bgmv, build, dispatch,  # noqa: E402
                                 lora_matmul, paged_attention)
from repro_torch.launch import serve                        # noqa: E402
from repro_torch.models.api import build_model              # noqa: E402
from repro_torch.tree import tree_leaves                    # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20
KERNEL_RTOL = 1e-4             # fp32 accumulation in both; only the order
                               # of the sums differs (bf16 inputs are
                               # upcast exactly, so the same bound holds)
BF16_STEP = 2 ** -7            # a bf16 output (#13 over bf16 pools) may
                               # round one bf16 step of |plain| apart: both
                               # round fp32 values that differ in their
                               # last bits
LOGIT_ATOL = 1e-3              # teacher-forced logits, kernel vs plain tier
# training path: kernel-tier vs plain-tier per-round loss and grad-norm.
# Both run fp32 with the same data; only the order of the sums differs (the
# kernels' tiles vs cuBLAS), and 24 SGD steps through 18 layers carry that
# forward, so the bound is relative and well above fp32 rounding
TRAIN_RTOL = 1e-3
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"bgmv_gemv": "src/repro_torch/kernels/csrc/bgmv.cu",
           "bgmv_matmul": "src/repro_torch/kernels/csrc/bgmv.cu",
           "lora_fwd": "src/repro_torch/kernels/csrc/lora_matmul.cu",
           "lora_bwd_dx": "src/repro_torch/kernels/csrc/lora_matmul.cu",
           "lora_bwd_da": "src/repro_torch/kernels/csrc/lora_matmul.cu",
           "lora_bwd_db": "src/repro_torch/kernels/csrc/lora_matmul.cu",
           "paged_attention": CSRC + "paged_attention.cu",
           "bgmv_matmul_quant": CSRC + "bgmv.cu",
           "bgmv_gemv_quant": CSRC + "bgmv.cu",
           "quant_matmul": CSRC + "lora_matmul.cu",
           "lora_fwd_quant": CSRC + "lora_matmul.cu",
           "lora_bwd_dx_quant": CSRC + "lora_matmul.cu",
           "quant_matmul_dx": CSRC + "lora_matmul.cu"}
REPLACES = {"bgmv_gemv": "src/repro/kernels/bgmv.py:114",
            "bgmv_matmul": "src/repro/kernels/bgmv.py:59",
            "lora_fwd": "src/repro/kernels/lora_matmul.py:55",
            "lora_bwd_dx": "src/repro/kernels/lora_matmul.py:147",
            "lora_bwd_da": "src/repro/kernels/lora_matmul.py:201",
            "lora_bwd_db": "src/repro/kernels/lora_matmul.py:230",
            "paged_attention": "src/repro/kernels/paged_attention.py:45",
            "bgmv_matmul_quant": "src/repro/kernels/bgmv.py:224",
            "bgmv_gemv_quant": "src/repro/kernels/bgmv.py:251",
            "quant_matmul": "src/repro/kernels/lora_matmul.py:514",
            "lora_fwd_quant": "src/repro/kernels/lora_matmul.py:345",
            "lora_bwd_dx_quant": "src/repro/kernels/lora_matmul.py:414",
            "quant_matmul_dx": "src/repro/kernels/lora_matmul.py:544"}
# the row of each kernel's times that the kernels line reports
ROW = {"bgmv_gemv": "q", "bgmv_matmul": "q", "lora_fwd": "q",
       "lora_bwd_dx": "q", "lora_bwd_da": "q", "lora_bwd_db": "q",
       "paged_attention": "path", "bgmv_matmul_quant": "int4 q m=512",
       "bgmv_gemv_quant": "int4 q m=4", "quant_matmul": "int4 w_up m=4",
       "lora_fwd_quant": "int4 q", "lora_bwd_dx_quant": "int4 q",
       "quant_matmul_dx": "int4 w_up"}


def phase(name):
    print(f"\n== {name}", flush=True)


# ------------------------------------------------------------ 1. environment

def environment():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs only on a CUDA device")
    phase("environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"nvidia-smi: {smi}")
    print(f"device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")
    return smi, name


# ------------------------------------------------------------------ 2. build

def build_kernels():
    phase("build")
    t0 = time.monotonic()
    lib = build.build()
    build.load()
    print(f"built {lib.relative_to(ROOT)} in {time.monotonic() - t0:.1f} s")
    log = lib.with_suffix(".log")
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")


# ------------------------------------------------------ 3. kernels vs plain

def _bank(gen, B, s, k, n, K, ranks, dtype):
    """x, W, a zero-padded (mixed-rank) bank A/B, and request ids."""
    r = max(ranks)
    dev = "cuda"
    x = torch.randn(B, s, k, generator=gen, device=dev)
    w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
    a = torch.randn(K, r, k, generator=gen, device=dev) * 0.05
    b = torch.randn(K, n, r, generator=gen, device=dev) * 0.05
    for t, rt in enumerate(ranks):
        a[t, rt:] = 0.0
        b[t, :, rt:] = 0.0
    ids = torch.tensor([2, 0, 3, 1][:B], dtype=torch.int32, device=dev) % K
    return [t.to(dtype) for t in (x, w, a, b)] + [ids]


def check_kernels():
    phase("kernels vs plain (tolerance: |kernel - plain| <= "
          f"{KERNEL_RTOL} * max(1, max|plain|))")
    gen = torch.Generator("cuda").manual_seed(1)
    cases = []
    for proj, n in (("q", 2048), ("v", 256)):
        for bank_name, ranks in (("r8", (8,) * 4), ("mixed", (4, 8, 16, 64))):
            for s in (1, 128):
                cases.append((f"{proj} {bank_name}", 4, s, 2048, n, 4, ranks))
    cases += [("ragged", 4, 3, 70, 50, 3, (9, 9, 9)),
              ("ragged", 4, 1, 70, 50, 3, (9, 9, 9))]
    worst = {"bgmv_gemv": 0.0, "bgmv_matmul": 0.0}
    for label, B, s, k, n, K, ranks in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, a, b, ids = _bank(gen, B, s, k, n, K, ranks, dtype)
            for id_mode in ("ids", "none"):
                if id_mode == "none":       # the serving engine's layout
                    a_, b_ = (a.index_select(0, ids.long()).contiguous(),
                              b.index_select(0, ids.long()).contiguous())
                    ids_ = None
                else:
                    a_, b_, ids_ = a, b, ids
                if s == 1:
                    kern, x_ = "bgmv_gemv", x[:, 0].contiguous()
                    got = bgmv.bgmv_gemv(x_, w, a_, b_, ids_)
                    want = bgmv.bgmv_gemv_plain(x_, w, a_, b_, ids_)
                else:
                    kern = "bgmv_matmul"
                    got = bgmv.bgmv_matmul(x, w, a_, b_, ids_)
                    want = bgmv.bgmv_matmul_plain(x, w, a_, b_, ids_)
                torch.cuda.synchronize()
                assert got.shape == want.shape and got.dtype == torch.float32
                err = float((got - want).abs().max())
                scale = max(1.0, float(want.abs().max()))
                print(f"{kern:12s} {label:9s} s={s:<3d} k={k} n={n} "
                      f"ranks={ranks} {str(dtype)[6:]:8s} ids={id_mode:4s} "
                      f"max_abs_err={err:.3e} max_rel_err={err / scale:.3e}")
                if not err <= KERNEL_RTOL * scale:
                    raise AssertionError(f"{kern} {label} disagrees with its "
                                         f"plain version: {err} > "
                                         f"{KERNEL_RTOL * scale}")
                worst[kern] = max(worst[kern], err)
    print(f"launches in this phase (not the path's): {bgmv.launches}")
    return worst


def _graph_ms(fn, argsets, reps=5):
    """Device time of one call: calls over rotating argument sets captured
    in a CUDA graph, replayed ``reps`` times between CUDA events (the host's
    per-call overhead stays out of the number)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in argsets[:3]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for args in argsets:
            fn(*args)
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(argsets))


def _eager_ms(fn, argsets, reps=3):
    """Wall time of one eager call, host overhead included."""
    for args in argsets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        for args in argsets:
            fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (reps * len(argsets))


def time_kernels():
    """Times at the serving path's shapes (fp32, B=4 requests, rank 8,
    per-request adapters gathered: ids=None), W rotated over copies that
    together exceed L2 three times, as a decode step finds W cold."""
    phase("kernel times (fp32, B=4, r=8, W cold in L2)")
    gen = torch.Generator("cuda").manual_seed(2)
    rows = {}
    for kern, s in (("bgmv_gemv", 1), ("bgmv_matmul", 128)):
        for proj, n in (("q", 2048), ("v", 256)):
            B, k, r = 4, 2048, 8
            x, w, a, b, _ = _bank(gen, B, s, k, n, B, (r,) * B,
                                  torch.float32)
            copies = max(2, math.ceil(3 * L2_BYTES / w.nbytes))
            ws = [w.clone() for _ in range(copies)]
            xin = x[:, 0].contiguous() if s == 1 else x
            kfn = bgmv.bgmv_gemv if s == 1 else bgmv.bgmv_matmul
            pfn = bgmv.bgmv_gemv_plain if s == 1 else bgmv.bgmv_matmul_plain
            argsets = [(xin, wi, a, b) for wi in ws]
            x2 = x.reshape(B * s, k)
            ms = _graph_ms(kfn, argsets)
            plain_ms = _graph_ms(pfn, argsets)
            library_ms = _graph_ms(torch.matmul, [(x2, wi) for wi in ws])
            eager_ms = _eager_ms(kfn, argsets)
            m = B * s
            nbytes = (x.nbytes + w.nbytes + a.nbytes + b.nbytes
                      + m * n * 4)
            flops = 2 * m * k * n + 2 * m * r * (k + n)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / FP32_FLOP_PER_S * 1e3
            bound_ms = max(t_bytes, t_ops)
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=library_ms,
                       eager_ms=eager_ms)
            rows[(kern, proj)] = row
            print(f"{kern:12s} {proj} x({B},{s},{k}) W({k},{n}) r={r}: "
                  f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
                  f"torch.matmul (base product only) {library_ms * 1e3:.2f} "
                  f"us, bound {bound_ms * 1e3:.2f} us ({bound_by}; "
                  f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP), "
                  f"eager call with host overhead {eager_ms * 1e3:.2f} us")
    return rows


# ------------------------------------------------------------------- 4. path

def _nonzero_b(tree, gen, std):
    """B matrices drawn at ``std`` (init_lora zero-inits B, which would
    make every adapter a no-op)."""
    if isinstance(tree, dict):
        if set(tree) == {"a", "b"}:
            b = torch.randn(tree["b"].shape, generator=gen,
                            device=tree["b"].device) * std
            return {"a": tree["a"], "b": b.to(tree["b"].dtype)}
        return {k: _nonzero_b(v, gen, std) for k, v in tree.items()}
    return tree


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serving_model(cfg, device):
    """gemma-2b at full width with seeded random weights and 4 SFed-LoRA
    tenants (alpha 8, rank 8, B drawn at std 0.02), as run_path builds
    them."""
    model = build_model(cfg)
    gen = torch.Generator(device).manual_seed(0)
    params = model.init(gen, device)
    lcfg = LoRAConfig(rank=8, alpha=8.0, scaling="sfedlora",
                      targets=cfg.lora_targets)
    sets = []
    for _ in range(4):
        s = init_adapter_set(params, gen, lcfg, n_clients=4)
        sets.append(dataclasses.replace(s, lora=_nonzero_b(s.lora, gen, 0.02)))
    return model, params, AdapterBank.from_sets(sets)


def run_path(name, cfg, device, *, steps=32, plen=128):
    """generate_banked through the user's entry points.  ``cfg`` and
    ``device`` are arguments so the phase can be rehearsed on a CPU at a
    reduced size; the launch counts hold only on the card."""
    phase(f"path: generate_banked, {cfg.name} d_model {cfg.d_model}, fp32")
    t0 = time.monotonic()
    model, params, bank = serving_model(cfg, device)
    n_tenants = bank.size
    ids = torch.arange(n_tenants, device=device, dtype=torch.int32)
    prompt = torch.randint(0, cfg.vocab_size, (n_tenants, plen),
                           generator=torch.Generator(device).manual_seed(1),
                           device=device)
    max_len = plen + steps
    _sync(device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B parameters, {n_tenants} tenants "
          f"(gamma folded), init "
          f"{time.monotonic() - t0:.1f} s")

    # the counted run: counts to 0 just before, read just after
    _reset_launches()
    dispatch.reset_stats()
    seq = serve.generate_banked(model, params, bank, ids, prompt, steps,
                                max_len)
    _sync(device)
    launches = _launch_counts()
    n_adapted = len(cfg.lora_targets) * cfg.num_layers
    expect = dict.fromkeys(launches, 0)
    expect.update(bgmv_matmul=n_adapted, bgmv_gemv=n_adapted * (steps - 1))
    print(f"launches: {launches} (expected {expect}: {n_adapted} per "
          f"prefill, {n_adapted} per decode step); dispatch {dispatch.stats}")
    assert launches == expect, (launches, expect)
    assert tuple(seq.shape) == (n_tenants, plen + steps)
    new = seq[:, plen:]
    assert int(new.min()) >= 0 and int(new.max()) < cfg.vocab_size
    assert torch.equal(seq[:, :plen], prompt)

    # two tenants, one prompt: different logits (the LoRA is applied)
    two = prompt[:1].expand(2, plen).contiguous()
    lg2, _ = model.prefill(params, model.init_cache(2, plen, device=device),
                           two, bank.requests([0, 1]), last_only=True)
    diff = float((lg2[0] - lg2[1]).abs().max())
    print(f"tenants 0 and 1 on one prompt: max |logit difference| {diff:.4e}")
    assert diff > 1e-3, diff

    # teacher-forced: the kernel run's tokens through both tiers
    def forced(plain):
        out = []
        with torch.inference_mode():
            with (dispatch.plain_tier() if plain
                  else contextlib.nullcontext()):
                adapters = bank.gather(ids)
                cache = model.init_cache(n_tenants, max_len, device=device)
                lg, cache = model.prefill(params, cache, prompt, adapters,
                                          last_only=True)
                out.append(lg[:, -1])
                for t in range(plen, plen + steps - 1):
                    pos = torch.full((n_tenants,), t, device=device)
                    lg, cache = model.decode_step(params, cache,
                                                  seq[:, t:t + 1], pos,
                                                  adapters)
                    out.append(lg[:, -1])
        return torch.stack(out, 1)[..., :cfg.vocab_size]

    kern_logits, plain_logits = forced(False), forced(True)
    per_step = (kern_logits - plain_logits).abs().amax(dim=(0, 2))
    scale = float(plain_logits.abs().max())
    print(f"teacher-forced logits, kernel vs plain tier over {steps} steps: "
          f"max |diff| {float(per_step.max()):.3e} (per step max "
          f"{[f'{v:.1e}' for v in per_step.tolist()[:4]]}...), "
          f"max |logit| {scale:.3f}, tolerance {LOGIT_ATOL}")
    assert float(per_step.max()) <= LOGIT_ATOL
    assert torch.equal(kern_logits.argmax(-1), new), \
        "greedy tokens differ from the kernel tier's teacher-forced argmax"
    del kern_logits, plain_logits

    # ms/token: a whole generation, and decode alone as t(32) - t(1)
    def timed(n_steps):
        _sync(device)
        t = time.monotonic()
        serve.generate_banked(model, params, bank, ids, prompt, n_steps,
                              plen + n_steps)
        _sync(device)
        return time.monotonic() - t

    t1, t32 = timed(1), timed(steps)
    decode_ms = (t32 - t1) * 1e3 / (steps - 1)
    print(f"path on {name}: {t32 * 1e3 / steps:.2f} ms/token over a "
          f"{steps}-token generation (batch {n_tenants}, prompt {plen}); "
          f"prefill + first token {t1 * 1e3:.1f} ms; decode "
          f"{decode_ms:.2f} ms/step")
    if device.type == "cuda":
        where_time_goes(model, params, bank.gather(ids), prompt, seq)
    return launches


def _profiled(fn):
    """(host wall seconds, device events) of ``fn()`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]


def where_time_goes(model, params, adapters, prompt, seq, n_steps=4):
    """torch.profiler over one prefill and ``n_steps`` teacher-forced decode
    steps: host wall time, device busy time (kernels and copies on the
    card, one stream, no overlap) and the kernels that take it.  The
    profiler's own host overhead inflates the wall times here; the
    unprofiled ms/step is printed above."""
    phase(f"where the time goes (torch.profiler; 1 prefill, {n_steps} "
          "decode steps)")
    b, plen = prompt.shape
    dev = prompt.device
    state = {}

    def prefill():
        cache = model.init_cache(b, plen + n_steps, device=dev)
        _, state["cache"] = model.prefill(params, cache, prompt, adapters,
                                          last_only=True)

    def decode():
        for t in range(plen, plen + n_steps):
            pos = torch.full((b,), t, device=dev)
            model.decode_step(params, state["cache"], seq[:, t:t + 1], pos,
                              adapters)

    with torch.inference_mode():
        for label, fn, per in (("prefill", prefill, 1),
                               ("decode", decode, n_steps)):
            _print_profile(label, *_profiled(fn), per,
                           "prefill" if per == 1 else "step")


def _print_profile(label, wall, events, per, unit):
    """Host wall vs device busy time per ``unit`` (``per`` units in the
    profiled window) and the kernels that take the device time."""
    if not events:
        print(f"{label}: device time not measured (the profiler recorded no "
              "CUDA events)")
        return
    wall_ms = wall * 1e3 / per
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / per
    print(f"{label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.2f}, "
          f"{len(events) / per:.0f} device events per {unit}")
    by_name = {}
    for e in events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (n, us) in top:
        print(f"    {us / 1e3 / per:8.3f} ms  x{n / per:5.1f}  {name[:100]}")


# ------------------------------------------ 5. LoRA matmul kernels vs plain

LORA_KERNELS = ("lora_fwd", "lora_bwd_dx", "lora_bwd_da", "lora_bwd_db")
# the packed training path's adapted projections: #9, #10, #7, #8
QTRAIN_PATH_KERNELS = ("lora_fwd_quant", "lora_bwd_dx_quant", "lora_bwd_da",
                       "lora_bwd_db")
QTRAIN_KERNELS = ("lora_fwd_quant", "lora_bwd_dx_quant", "quant_matmul_dx")


def _lora_operands(gen, m, k, n, r, dtype, dev="cuda"):
    """x, W, A, B and an output cotangent g, as the training path has them
    (B nonzero)."""
    x = torch.randn(m, k, generator=gen, device=dev)
    w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
    a = torch.randn(r, k, generator=gen, device=dev) * 0.05
    b = torch.randn(n, r, generator=gen, device=dev) * 0.05
    g = torch.randn(m, n, generator=gen, device=dev) * m ** -0.5
    return [t.to(dtype) for t in (x, w, a, b, g)]


def _lora_calls(x, w, a, b, g, gamma):
    """{kernel: (kernel wrapper call, plain version call)} for #5-#8.  The
    residuals p and q that #7 and #8 take come from the plain versions, so
    each kernel sees exactly its plain version's inputs."""
    lm = lora_matmul
    _, p = lm.lora_fwd_plain(x, w, a, b, gamma)
    _, q = lm.lora_bwd_dx_plain(g, w, a, b, gamma)
    return {
        "lora_fwd": (lambda: lm.lora_fwd(x, w, a, b, gamma),
                     lambda: lm.lora_fwd_plain(x, w, a, b, gamma)),
        "lora_bwd_dx": (lambda: lm.lora_bwd_dx(g, w, a, b, gamma),
                        lambda: lm.lora_bwd_dx_plain(g, w, a, b, gamma)),
        "lora_bwd_da": (lambda: lm.lora_bwd_da(q, x, gamma),
                        lambda: lm.lora_bwd_da_plain(q, x, gamma)),
        "lora_bwd_db": (lambda: lm.lora_bwd_db(g, p, gamma),
                        lambda: lm.lora_bwd_db_plain(g, p, gamma)),
    }


def check_lora_kernels():
    phase("LoRA matmul kernels #5-#8 vs plain (tolerance: |kernel - plain| "
          f"<= {KERNEL_RTOL} * max(1, max|plain|))")
    gen = torch.Generator("cuda").manual_seed(3)
    cases = [("q", 512, 2048, 2048, 64), ("v", 512, 2048, 256, 64),
             ("ragged", 50, 70, 30, 3), ("ragged r=1", 33, 65, 17, 1)]
    worst = {k: 0.0 for k in LORA_KERNELS}
    for label, m, k, n, r in cases:
        for dtype in (torch.float32, torch.bfloat16):
            calls = _lora_calls(*_lora_operands(gen, m, k, n, r, dtype), 1.5)
            for kern, (kfn, pfn) in calls.items():
                got, want = kfn(), pfn()
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                for gt, wt in zip(got, want):
                    assert gt.shape == wt.shape and gt.dtype == torch.float32
                    err = float((gt - wt).abs().max())
                    scale = max(1.0, float(wt.abs().max()))
                    if not err <= KERNEL_RTOL * scale:
                        raise AssertionError(
                            f"{kern} {label} {dtype} disagrees with its plain "
                            f"version: {err} > {KERNEL_RTOL * scale}")
                    worst[kern] = max(worst[kern], err)
                print(f"{kern:12s} {label:10s} m={m} k={k} n={n} r={r} "
                      f"{str(dtype)[6:]:8s} max_abs_err over outputs "
                      f"{max(float((gt - wt).abs().max()) for gt, wt in zip(got, want)):.3e}")
    print(f"launches in this phase (not the path's): {lora_matmul.launches}")
    return worst


def _bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_lora_kernels():
    """Times at the training path's shapes (fp32, m = 4 x 128 = 512 rows,
    k = 2048, r = 64, gamma 1 as on the path): #5 and #6 with W rotated
    over copies that together exceed L2 three times (a local step reads
    each layer's W once per pass); #7 and #8 on warm inputs (x, g and the
    residuals were just written by the pass before them)."""
    phase("LoRA matmul kernel times (fp32, m=512, k=2048, r=64)")
    gen = torch.Generator("cuda").manual_seed(4)
    lm = lora_matmul
    rows = {}
    m, k, r = 512, 2048, 64
    for proj, n in (("q", 2048), ("v", 256)):
        x, w, a, b, g = _lora_operands(gen, m, k, n, r, torch.float32)
        copies = max(2, math.ceil(3 * L2_BYTES / w.nbytes))
        ws = [w.clone() for _ in range(copies)]
        _, p = lm.lora_fwd_plain(x, w, a, b, 1.0)
        _, q = lm.lora_bwd_dx_plain(g, w, a, b, 1.0)
        f4 = 4
        spec = {
            # kernel, plain, library yardstick, argsets, library argsets,
            # bytes (inputs once, outputs once), operations
            "lora_fwd": (lm.lora_fwd, lm.lora_fwd_plain, torch.matmul,
                         [(x, wi, a, b, 1.0) for wi in ws],
                         [(x, wi) for wi in ws],
                         x.nbytes + w.nbytes + a.nbytes + b.nbytes
                         + (m * n + m * r) * f4,
                         2 * m * k * n + 2 * m * k * r + 2 * m * r * n),
            "lora_bwd_dx": (lm.lora_bwd_dx, lm.lora_bwd_dx_plain,
                            lambda g_, w_: torch.matmul(g_, w_.t()),
                            [(g, wi, a, b, 1.0) for wi in ws],
                            [(g, wi) for wi in ws],
                            g.nbytes + w.nbytes + a.nbytes + b.nbytes
                            + (m * k + m * r) * f4,
                            2 * m * n * k + 2 * m * n * r + 2 * m * r * k),
            "lora_bwd_da": (lm.lora_bwd_da, lm.lora_bwd_da_plain,
                            lambda q_, x_: torch.matmul(q_.t(), x_),
                            [(q, x, 1.0)] * 8, [(q, x)] * 8,
                            q.nbytes + x.nbytes + r * k * f4,
                            2 * m * r * k),
            "lora_bwd_db": (lm.lora_bwd_db, lm.lora_bwd_db_plain,
                            lambda g_, p_: torch.matmul(g_.t(), p_),
                            [(g, p, 1.0)] * 8, [(g, p)] * 8,
                            g.nbytes + p.nbytes + n * r * f4,
                            2 * m * n * r),
        }
        for kern, (kfn, pfn, lfn, args, largs, nbytes, flops) in spec.items():
            ms = _graph_ms(kfn, args)
            plain_ms = _graph_ms(pfn, args)
            library_ms = _graph_ms(lfn, largs)
            eager_ms = _eager_ms(kfn, args)
            bound_ms, bound_by = _bound(nbytes, flops)
            rows[(kern, proj)] = dict(ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by,
                                      library_ms=library_ms,
                                      eager_ms=eager_ms)
            print(f"{kern:12s} {proj} m={m} k={k} n={n} r={r}: kernel "
                  f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
                  f"torch.matmul {library_ms * 1e3:.2f} us, bound "
                  f"{bound_ms * 1e3:.2f} us ({bound_by}; {nbytes / 1e6:.2f} "
                  f"MB, {flops / 1e9:.3f} GFLOP; "
                  f"{flops / ms / 1e9:.2f} TFLOP/s), eager call with host "
                  f"overhead {eager_ms * 1e3:.2f} us")
        del ws
    return rows


# ------------------------------------------------------- 6. training path

def train_path(name, cfg, device, *, quant=None, clients=4, rank=64,
               local_steps=2, batch=4, seq=128, rounds=3):
    """FederatedTrainer through the user's entry points (as
    ``repro_torch.launch.train`` builds it), over an fp32 base or (``quant``
    int8 / int4, group 64) one packed by ``quantize_tree``.  ``cfg`` and
    ``device`` are arguments so the phase can be rehearsed on a CPU at a
    reduced size; the launch counts hold only on the card.  Over a packed
    base it also checks save / resume: a trainer restored from a checkpoint
    written after round ``rounds - 1`` repeats the last round bit for bit."""
    base_name = quant or "fp32"
    phase(f"training path: FederatedTrainer, {cfg.name} d_model "
          f"{cfg.d_model}, {base_name} base, fp32 activations, N={clients}, "
          f"fedsa + sfedlora, rank {rank}")
    model = build_model(cfg)
    t0 = time.monotonic()
    params = model.init(torch.Generator(device).manual_seed(0), device)
    if quant is not None:
        params = quantize_tree(params, quant, QUANT_GROUP)
    lcfg = LoRAConfig(rank=rank, alpha=8.0, scaling="sfedlora",
                      targets=cfg.lora_targets)
    fcfg = FederatedConfig(num_clients=clients, local_steps=local_steps,
                           rounds=rounds, aggregation="fedsa")
    ocfg = OptimizerConfig(name="sgd", lr=5e-3)
    ckpt = ROOT / "build" / f"chip_smoke_{base_name}.npz"

    def trainer():
        ds = FederatedDataset(cfg.vocab_size, clients, seq_len=seq,
                              batch_per_client=batch, seed=0)
        return federated.FederatedTrainer(
            model, ds, lora_cfg=lcfg, fed_cfg=fcfg, opt_cfg=ocfg, seed=0,
            base_params=params, device=device)

    def b_max(tr):
        return max(float(t.abs().max())
                   for t in tree_leaves(split_ab(tr.lora)[1]))

    def run(tr, save=False):
        ms = []
        for i in range(rounds):
            _sync(device)
            t = time.monotonic()
            tr.run_round()
            _sync(device)
            ms.append((time.monotonic() - t) * 1e3)
            if i == 0:
                assert b_max(tr) > 0, "B is still zero after round 1"
            if save and i == rounds - 2:
                tr.save(str(ckpt))         # outside the timed rounds
        return ms

    _sync(device)
    print(f"init {time.monotonic() - t0:.1f} s; gamma = alpha*sqrt(N/r) = "
          f"{trainer().gamma:.4f}; {clients} clients x {local_steps} local "
          f"steps x batch {batch} x seq {seq} per round, {rounds} rounds")
    if quant is not None:
        fq = quant_footprint(params)
        print(f"base GEMM weights: {fq['base_bytes'] / 1e9:.4f} GB {quant} "
              f"({fq['base_fp_bytes'] / 1e9:.4f} GB fp32); whole tree "
              f"{fq['total_bytes'] / 1e9:.4f} GB")

    # the counted run: counts to 0 just before, read just after
    tr1 = trainer()
    _reset_launches()
    dispatch.reset_stats()
    ms1 = run(tr1)
    ppl = tr1.eval_perplexity()
    _sync(device)
    launches = _launch_counts()
    n_adapted = len(cfg.lora_targets) * cfg.num_layers
    steps = clients * local_steps * rounds
    expect = dict.fromkeys(launches, 0)
    if quant is None:
        expect.update({k: n_adapted * steps for k in LORA_KERNELS})
        expect["lora_fwd"] += n_adapted                  # one eval forward
        per_step = f"{n_adapted} of each of #5-#8"
    else:
        # k, o, w_gate, w_up, w_down; layer 0's k has an input without grad
        n_base = (7 - len(cfg.lora_targets)) * cfg.num_layers
        expect.update({k: n_adapted * steps for k in QTRAIN_PATH_KERNELS})
        expect["quant_matmul"] = n_base * steps
        expect["quant_matmul_dx"] = (n_base - 1) * steps
        expect["lora_fwd_quant"] += n_adapted            # one eval forward
        expect["quant_matmul"] += n_base
        per_step = (f"{n_adapted} of each of #9, #10, #7, #8, {n_base} of "
                    f"#11 and {n_base - 1} of #12")
    print(f"launches: { {k: v for k, v in launches.items() if v} } "
          f"(expected { {k: v for k, v in expect.items() if v} }: "
          f"{per_step} per client local step x {steps}, plus the eval "
          f"forward); dispatch {dispatch.stats}")
    assert launches == expect, (launches, expect)
    for h in tr1.history:
        print(f"round {h['round']}: loss {h['loss']:.6f}, grad_norm "
              f"{h['grad_norm']:.6e}")
        assert math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
    print(f"max |B| after {rounds} rounds: {b_max(tr1):.4e}; held-out "
          f"perplexity {ppl:.3f}")
    assert math.isfinite(ppl)

    # the same run again: bit for bit (over a packed base it also writes
    # the checkpoint after round rounds - 1)
    tr2 = trainer()
    ms2 = run(tr2, save=quant is not None)
    same = all(h1["loss"] == h2["loss"] and h1["grad_norm"] == h2["grad_norm"]
               for h1, h2 in zip(tr1.history, tr2.history))
    same = same and all(torch.equal(t1, t2) for t1, t2 in
                        zip(tree_leaves(tr1.lora), tree_leaves(tr2.lora)))
    print(f"second kernel-tier run: trajectory and adapters "
          f"{'bit-identical' if same else 'DIFFER'}")
    assert same, "two kernel-tier runs differ"

    if quant is not None:
        # resume: a fresh trainer restored from the checkpoint repeats the
        # last round of the uninterrupted run bit for bit
        t = time.monotonic()
        tr4 = trainer()
        tr4.restore(str(ckpt))
        mb = ckpt.stat().st_size / 1e6
        ckpt.unlink()
        _sync(device)
        restore_s = time.monotonic() - t
        tr4.run_round()
        same = (tr4.round_idx == rounds
                and tr4.history[-1] == tr2.history[-1]
                and all(torch.equal(t1, t2) for t1, t2 in
                        zip(tree_leaves(tr4.lora), tree_leaves(tr2.lora))))
        print(f"resume: checkpoint after round {rounds - 1} ({mb:.1f} MB), "
              f"restored in {restore_s:.1f} s; round {rounds} "
              f"{'bit-identical' if same else 'DIFFERS'} to the "
              f"uninterrupted run (loss {tr4.history[-1]['loss']:.8g})")
        assert same, "the resumed round differs from the uninterrupted one"
        del tr4

    # the plain tier on the same device
    _reset_launches()
    with dispatch.plain_tier():
        tr3 = trainer()
        run(tr3)
    assert not any(_launch_counts().values()), _launch_counts()
    worst = 0.0
    for hk, hp in zip(tr1.history, tr3.history):
        for key in ("loss", "grad_norm"):
            d = abs(hk[key] - hp[key])
            rel = d / max(abs(hp[key]), 1e-30)
            worst = max(worst, rel)
            print(f"round {hk['round']} {key}: kernel {hk[key]:.8g}, plain "
                  f"{hp[key]:.8g}, |diff| {d:.3e} (relative {rel:.3e})")
    db = max(float((t1 - t3).abs().max()) for t1, t3 in
             zip(tree_leaves(tr1.lora), tree_leaves(tr3.lora)))
    print(f"kernel vs plain tier: worst relative diff of loss and grad_norm "
          f"{worst:.3e} (bound {TRAIN_RTOL}); max |adapter diff| {db:.3e} "
          f"(max |B| {b_max(tr3):.3e})")
    assert worst <= TRAIN_RTOL

    print(f"training path on {name} ({base_name} base): ms/round "
          f"{[round(t, 1) for t in ms1]} (first run), "
          f"{[round(t, 1) for t in ms2]} (second run); "
          f"{clients * local_steps} client local steps per round")
    if device.type == "cuda" and quant in (None, "int4"):
        profile_local_step(model, tr2)
    return launches, ms2


def profile_local_step(model, tr):
    """torch.profiler over one client local step (forward, backward through
    the LoRA matmul kernels, optimizer update) after a warm-up step."""
    phase("where the time goes (torch.profiler; one client local step)")
    local = federated._make_client_local(model, get_strategy("fedsa"),
                                         tr.opt_cfg)
    lora = federated._client(tr.lora, 0)
    opt = federated._client(tr.opt_state, 0)
    batches = torch.as_tensor(tr.dataset.round_batch(1)[0],
                              device=tr.device)

    def step():
        local(tr.base, lora, opt, batches, 0, tr.gamma)

    step()
    _print_profile("local step", *_profiled(step), 1, "step")



# -------------------------------- 8. paged and quantized kernels vs plain

SCHED_KERNELS = ("paged_attention", "bgmv_matmul_quant", "bgmv_gemv_quant",
                 "quant_matmul")
QUANT_GROUP = 64
# gemma-2b's eligible base projections: (k, n) of each
PROJ = {"q": (2048, 2048), "k": (2048, 256), "v": (2048, 256),
        "o": (2048, 2048), "w_up": (2048, 16384), "w_gate": (2048, 16384),
        "w_down": (16384, 2048)}


def _err(name, label, got, want):
    """max |kernel - plain|, raising past KERNEL_RTOL * max(1, max|plain|),
    plus BF16_STEP * |plain| element by element for a bf16 output."""
    _sync(got.device)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (name, label, got.shape, want.shape, got.dtype, want.dtype)
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    scale = max(1.0, float(want.float().abs().max()))
    bound = torch.full_like(diff, KERNEL_RTOL * scale)
    if got.dtype == torch.bfloat16:
        bound += BF16_STEP * want.float().abs()
    print(f"{name:17s} {label:50s} max_abs_err={err:.3e} "
          f"max_rel_err={err / scale:.3e}")
    if not bool((diff <= bound).all()):
        worst = int((diff - bound).argmax())
        raise AssertionError(
            f"{name} {label} disagrees with its plain version: "
            f"{float(diff.flatten()[worst])} > "
            f"{float(bound.flatten()[worst])} at element {worst}")
    return err


def _paged_case(gen, b, h, kh, hd, bs, mb, idle=0, dev="cuda"):
    """One decode step's operands: request i owns mb pool blocks filled to a
    staggered level (half, full, wrapped past the ring, one short of full);
    ``idle`` trailing slots point every table entry at the null block 0, as
    the scheduler leaves a free slot."""
    live = b - idle
    npool = 1 + live * mb
    q = torch.randn(b, h, hd, generator=gen, device=dev)
    kp = torch.randn(npool, bs, kh, hd, generator=gen, device=dev)
    vp = torch.randn(npool, bs, kh, hd, generator=gen, device=dev)
    table = torch.zeros(b, mb, dtype=torch.int32, device=dev)
    table[:live] = torch.arange(1, npool, dtype=torch.int32,
                                device=dev).reshape(live, mb)
    pos_pool = torch.full((npool, bs), -1, dtype=torch.int32, device=dev)
    vlen, qpos = mb * bs, []
    for i in range(live):
        filled = (vlen // 2, vlen, vlen + 3, vlen - 1)[i % 4]
        pos = torch.arange(filled, device=dev)
        vslot = pos % vlen
        pos_pool[table[i, vslot // bs].long(), vslot % bs] = pos.int()
        qpos.append(filled - 1)
    pos_pool[0, 0] = 0                    # an idle slot's own write
    qpos = torch.tensor(qpos + [0] * idle, dtype=torch.int32, device=dev)
    return q, kp, vp, pos_pool, table, qpos


def check_sched_kernels(block_size, ring, dev="cuda"):
    """fp32 and bf16 builds of each kernel: #13 over fp32 and bf16 pools;
    #3, #4 and #11 with fp32 and bf16 activations over a base packed from
    fp32 weights (the only base their wrappers take)."""
    phase("paged-attention #13 and quantized BGMV / GEMM #3, #4, #11 vs "
          f"plain (tolerance: |kernel - plain| <= {KERNEL_RTOL} * max(1, "
          f"max|plain|), + {BF16_STEP} * |plain| for a bf16 output)")
    gen = torch.Generator(dev).manual_seed(5)
    worst = {k: 0.0 for k in SCHED_KERNELS}
    mb = -(-ring // block_size)
    pa = paged_attention
    for label, shape in ((f"B4 h8 kh1 hd256 bs{block_size} mb{mb}",
                          (4, 8, 1, 256, block_size, mb, 0)),
                         ("B3 h6 kh2 hd80 bs5 mb3 idle1",
                          (3, 6, 2, 80, 5, 3, 1))):
        q, kp, vp, *rest = _paged_case(gen, *shape, dev=dev)
        for dt, window, softcap in itertools.product(
                (torch.float32, torch.bfloat16), (None, 64), (None, 50.0)):
            args = [t.to(dt) for t in (q, kp, vp)] + rest
            got = pa.paged_attention(*args, window=window, softcap=softcap)
            want = pa.paged_attention_plain(*args, window=window,
                                            softcap=softcap)
            worst["paged_attention"] = max(worst["paged_attention"], _err(
                "paged_attention",
                f"{label} {str(dt)[6:]} w={window} c={softcap}", got, want))
    for mode, bits in (("int8", 8), ("int4", 4)):
        for proj, (k, n) in list(PROJ.items()) + [("ragged", (70, 50))]:
            w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
            wq = quantize(w, bits, QUANT_GROUP)
            del w
            for m, dt in itertools.product(
                    (4, 512) if proj != "ragged" else (5, 13),
                    (torch.float32, torch.bfloat16)):
                x = torch.randn(m, k, generator=gen, device=dev).to(dt)
                worst["quant_matmul"] = max(worst["quant_matmul"], _err(
                    "quant_matmul",
                    f"{mode} {proj} m={m} k={k} n={n} {str(dt)[6:]}",
                    lora_matmul.quant_matmul(x, wq),
                    lora_matmul.quant_matmul_plain(x, wq)))
            if proj not in ("q", "v", "ragged"):
                continue
            r = 9 if proj == "ragged" else 8
            for s, dt in itertools.product((1, 3 if proj == "ragged" else 128),
                                           (torch.float32, torch.bfloat16)):
                x = torch.randn(4, s, k, generator=gen, device=dev).to(dt)
                a = (torch.randn(4, r, k, generator=gen, device=dev)
                     * 0.05).to(dt)
                b = (torch.randn(4, n, r, generator=gen, device=dev)
                     * 0.05).to(dt)
                for ids in (torch.tensor([2, 0, 3, 1], dtype=torch.int32,
                                         device=dev), None):
                    lab = (f"{mode} {proj} B=4 s={s} k={k} n={n} r={r} "
                           f"{str(dt)[6:]} "
                           f"ids={'none' if ids is None else 'bank'}")
                    if s == 1:
                        kern, x1 = "bgmv_gemv_quant", x[:, 0].contiguous()
                        got = bgmv.bgmv_gemv_quant(x1, wq, a, b, ids)
                        want = bgmv.bgmv_gemv_quant_plain(x1, wq, a, b, ids)
                    else:
                        kern = "bgmv_matmul_quant"
                        got = bgmv.bgmv_matmul_quant(x, wq, a, b, ids)
                        want = bgmv.bgmv_matmul_quant_plain(x, wq, a, b, ids)
                    worst[kern] = max(worst[kern], _err(kern, lab, got, want))
    print(f"launches in this phase (not the path's): "
          f"{dict(paged_attention.launches)} {dict(bgmv.launches)} "
          f"quant_matmul {lora_matmul.launches['quant_matmul']}")
    return worst


def time_sched_kernels(block_size, ring, dev="cuda"):
    """Times at the scheduled path's shapes (fp32 activations, B = 4, rank
    8, int8 and int4 group 64): #3, #4 and #11 with the packed W rotated
    over copies that together exceed L2 three times (a step reads each
    layer's W once); #13 on one layer's pools, warm (18 layers of pools,
    24 MB, fit in L2)."""
    phase("paged / quantized kernel times (fp32 activations, B=4, r=8)")
    gen = torch.Generator(dev).manual_seed(6)
    rows = {}
    mb = -(-ring // block_size)
    q, kp, vp, pos_pool, table, qpos = _paged_case(gen, 4, 8, 1, 256,
                                                   block_size, mb, dev=dev)
    pa = paged_attention
    args = [(q, kp, vp, pos_pool, table, qpos)] * 8
    ms = _graph_ms(pa.paged_attention, args)
    plain_ms = _graph_ms(pa.paged_attention_plain, args)
    # the library call: SDPA over the already-gathered view, GQA expanded
    kg, vg, pg = (t.reshape(4, mb * block_size, *t.shape[3:])
                  for t in (kp[table.long()], vp[table.long()],
                            pos_pool[table.long()]))
    kh_ = kg.permute(0, 2, 1, 3).expand(4, 8, -1, -1).contiguous()
    vh_ = vg.permute(0, 2, 1, 3).expand(4, 8, -1, -1).contiguous()
    mask = ((pg >= 0) & (pg <= qpos[:, None]))[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = _graph_ms(lambda q_, k_, v_, m_: sdpa(q_, k_, v_,
                                                       attn_mask=m_),
                           [(q[:, :, None], kh_, vh_, mask)] * 8)
    eager_ms = _eager_ms(pa.paged_attention, args)
    # the work this run's fill needs: pos of every table position; K and V
    # rows (kh = 1) and q.k, p.v for the 8 query heads at the attendable
    # ones only
    n_pos, n_valid = pg.numel(), int(mask.sum())
    nbytes = (q.nbytes * 2 + n_pos * 4 + n_valid * 2 * 256 * 4
              + table.nbytes + qpos.nbytes)
    flops = 2 * 2 * 8 * 256 * n_valid
    bound_ms, bound_by = _bound(nbytes, flops)
    rows[("paged_attention", "path")] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=library_ms, eager_ms=eager_ms)
    print(f"paged_attention B=4 h=8 kh=1 hd=256 bs={block_size} mb={mb}: "
          f"kernel {ms * 1e3:.2f} us, plain (gather + softmax) "
          f"{plain_ms * 1e3:.2f} us, SDPA on the gathered view "
          f"{library_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
          f"({bound_by}; {nbytes / 1e6:.3f} MB, {n_valid} of {n_pos} "
          f"positions attendable), eager call with host "
          f"overhead {eager_ms * 1e3:.2f} us")
    for mode, bits in (("int8", 8), ("int4", 4)):
        for proj, (k, n) in PROJ.items():
            w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
            wq = quantize(w, bits, QUANT_GROUP)
            wf = wq.dequantize()
            del w
            copies = max(2, math.ceil(3 * L2_BYTES / wq.nbytes))
            wqs = [quantize(wf, bits, QUANT_GROUP) for _ in range(copies)]
            wfs = [wf.clone() for _ in range(max(2, math.ceil(
                3 * L2_BYTES / wf.nbytes)))]
            for m in (4, 512):
                x = torch.randn(m, k, generator=gen, device=dev)
                specs = [("quant_matmul", lora_matmul.quant_matmul,
                          lora_matmul.quant_matmul_plain,
                          [(x, wi) for wi in wqs], 0, 2 * m * k * n)]
                if proj in ("q", "v"):
                    s = 1 if m == 4 else 128
                    xb = x.reshape(4, s, k)
                    a = torch.randn(4, 8, k, generator=gen,
                                    device=dev) * 0.05
                    b = torch.randn(4, n, 8, generator=gen,
                                    device=dev) * 0.05
                    name = "bgmv_gemv_quant" if s == 1 else \
                        "bgmv_matmul_quant"
                    xin = xb[:, 0].contiguous() if s == 1 else xb
                    specs.append((name, getattr(bgmv, name),
                                  getattr(bgmv, name + "_plain"),
                                  [(xin, wi, a, b) for wi in wqs],
                                  a.nbytes + b.nbytes,
                                  2 * m * k * n + 2 * m * 8 * (k + n)))
                for name, kfn, pfn, argsets, extra, flops in specs:
                    ms = _graph_ms(kfn, argsets)
                    plain_ms = _graph_ms(pfn, argsets)
                    library_ms = _graph_ms(torch.matmul,
                                           [(x, wi) for wi in wfs])
                    eager_ms = _eager_ms(kfn, argsets)
                    nbytes = x.nbytes + wq.nbytes + extra + m * n * 4
                    bound_ms, bound_by = _bound(nbytes, flops)
                    rows[(name, f"{mode} {proj} m={m}")] = dict(
                        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=library_ms,
                        eager_ms=eager_ms)
                    print(f"{name:17s} {mode} {proj:6s} m={m:<3d} k={k} "
                          f"n={n}: kernel {ms * 1e3:.2f} us, plain "
                          f"{plain_ms * 1e3:.2f} us, torch.matmul on the fp32 "
                          f"W {library_ms * 1e3:.2f} us, bound "
                          f"{bound_ms * 1e3:.2f} us ({bound_by}; "
                          f"{nbytes / 1e6:.2f} MB packed, "
                          f"{flops / 1e9:.3f} GFLOP), eager "
                          f"{eager_ms * 1e3:.2f} us")
            del wqs, wfs
    return rows


# ------------------------------------------- 9. scheduled serving path

SCHED = dict(n_req=8, plen=128, steps=32, deadline=12, max_batch=4,
             block_size=16, chunk=8)


def _launch_counts():
    out = dict(bgmv.launches)
    out.update(lora_matmul.launches)
    out.update(paged_attention.launches)
    return out


def _reset_launches():
    bgmv.reset_launches()
    lora_matmul.reset_launches()
    paged_attention.reset_launches()


def _forced_paged(model, params, bank, ids, prompts, toks, plain):
    """Teacher-forced logits along the paged path for one wave: the prompt
    through one prefill, then ``toks`` (the plain tier's tokens) through
    decode steps, on the kernel tier or (``plain``) the plain tier.
    Returns (b, steps, vocab) logits."""
    b, plen = prompts.shape
    steps = toks.shape[1]
    bs = SCHED["block_size"]
    mb = -(-(plen + steps) // bs)
    dev = prompts.device
    out = []
    with torch.inference_mode(), (dispatch.plain_tier() if plain
                                  else contextlib.nullcontext()):
        base = serve._prepare_base(model, params)
        adapters = serve._prepare_adapters(model, bank.requests(ids))
        cache = model.init_paged_cache(1 + b * mb, bs, device=dev)
        table = torch.arange(1, 1 + b * mb, dtype=torch.int32,
                             device=dev).reshape(b, mb)
        lg, cache = model.prefill(base, cache, prompts, adapters,
                                  last_only=True, table=table)
        out.append(lg[:, -1])
        for t in range(steps - 1):
            pos = torch.full((b,), plen + t, dtype=torch.long, device=dev)
            lg, cache = model.decode_step(base, cache, toks[:, t:t + 1], pos,
                                          adapters, table=table)
            out.append(lg[:, -1])
    return torch.stack(out, 1)[..., :model.cfg.vocab_size]


def sched_path(name, model, params, bank, mode):
    """serve_scheduled through the user's entry points, over an fp32 base
    or one packed by ``quantize_tree`` (``mode`` int8 / int4, group 64).
    Traffic: 8 requests of 128-token prompts and 32 greedy tokens, 4
    tenants, the last with deadline_steps 12; max_batch 4, block 16, chunk
    8, wait=False: two waves that recycle slots and blocks."""
    cfg, device = model.cfg, tree_leaves(params)[0].device
    sc = SCHED
    phase(f"scheduled path: serve_scheduled, {cfg.name} d_model "
          f"{cfg.d_model}, {mode} base, {sc['n_req']} requests x "
          f"{sc['plen']}-token prompts x {sc['steps']} tokens")
    base = params if mode == "fp32" else quantize_tree(params, mode,
                                                       QUANT_GROUP)
    fp, fq = quant_footprint(params), quant_footprint(base)
    print(f"base GEMM weights: {fq['base_bytes'] / 1e9:.4f} GB {mode}, "
          f"{fp['base_bytes'] / 1e9:.4f} GB fp32 "
          f"({fp['base_bytes'] / fq['base_bytes']:.2f}x); whole tree "
          f"{fq['total_bytes'] / 1e9:.4f} GB")
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, cfg.vocab_size, (sc["n_req"], sc["plen"]))
    ids = [i % bank.size for i in range(sc["n_req"])]
    last = sc["n_req"] - 1

    def requests():
        return [serve.Request(rid=i, prompt=prompts[i].astype(np.int32),
                              steps=sc["steps"], adapter_id=ids[i],
                              deadline_steps=sc["deadline"] if i == last
                              else None)
                for i in range(sc["n_req"])]

    def run():
        return serve.serve_scheduled(
            model, base, requests(), bank=bank, max_batch=sc["max_batch"],
            block_size=sc["block_size"], chunk=sc["chunk"], wait=False)

    calls = {"prefill": 0, "decode_step": 0, "prefill_s": 0.0}
    orig = {k: getattr(model, k) for k in ("prefill", "decode_step")}

    def counting(key):
        def wrapped(*a, **k):
            calls[key] += 1
            return orig[key](*a, **k)
        return wrapped

    # the counted run: counts to 0 just before, read just after
    model.prefill, model.decode_step = (counting("prefill"),
                                        counting("decode_step"))
    _reset_launches()
    dispatch.reset_stats()
    serve.reset_timeout_meter()
    done = run()
    _sync(device)
    launches = _launch_counts()
    del model.prefill, model.decode_step
    L = cfg.num_layers
    n_ad = len(cfg.lora_targets) * L
    n_un = (7 - len(cfg.lora_targets)) * L     # k, o, w_up, w_gate, w_down
    groups, steps = calls["prefill"], calls["decode_step"]
    chunks_per_wave = -(-(sc["steps"] - 1) // sc["chunk"])
    assert groups == 2 and steps == 2 * chunks_per_wave * sc["chunk"], \
        (groups, steps)
    expect = {k: 0 for k in launches}
    expect["paged_attention"] = L * steps
    if mode == "fp32":
        expect["bgmv_gemv"] = n_ad * steps
        expect["bgmv_matmul"] = n_ad * groups
    else:
        expect["bgmv_gemv_quant"] = n_ad * steps
        expect["bgmv_matmul_quant"] = n_ad * groups
        expect["quant_matmul"] = n_un * (steps + groups)
    print(f"{groups} admission groups, {steps} decode steps; launches "
          f"{ {k: v for k, v in launches.items() if v} } (expected "
          f"{ {k: v for k, v in expect.items() if v} }); dispatch "
          f"{dispatch.stats}")
    assert launches == expect, (launches, expect)
    cut = done[last]
    print(f"deadline request rid={last}: {len(cut.tokens)} tokens, "
          f"timed_out={cut.timed_out}, timeouts meter {serve.timeouts}")
    assert cut.timed_out and len(cut.tokens) == sc["deadline"]
    assert serve.timeouts == 1
    assert all(len(r.tokens) == sc["steps"] for r in done[:last])
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.tokens)

    # the same traffic, timed: admissions' prefills timed on their own
    def timed_prefill(*a, **k):
        _sync(device)
        t = time.monotonic()
        out = orig["prefill"](*a, **k)
        _sync(device)
        calls["prefill_s"] += time.monotonic() - t
        return out

    model.prefill = timed_prefill
    _sync(device)
    t0 = time.monotonic()
    run()
    _sync(device)
    wall = time.monotonic() - t0
    del model.prefill
    n_tok = sum(len(r.tokens) for r in done)
    decode_ms = (wall - calls["prefill_s"]) * 1e3 / steps
    print(f"scheduled path on {name} ({mode}): {wall:.3f} s for {n_tok} "
          f"tokens, {n_tok / wall:.1f} tokens/s; admission prefills "
          f"{calls['prefill_s'] * 1e3:.1f} ms for {groups} groups; decode "
          f"{decode_ms:.2f} ms/step over {steps} steps of "
          f"{sc['max_batch']} slots")

    # the plain tier: no kernel, and each wave equals generate_banked on it
    _reset_launches()
    with dispatch.plain_tier():
        plain = run()
        waves = [serve.generate_banked(
            model, base, bank, ids[w:w + 4],
            torch.as_tensor(prompts[w:w + 4], device=device), sc["steps"],
            sc["plen"] + sc["steps"])[:, sc["plen"]:].cpu().numpy()
            for w in (0, 4)]
    _sync(device)
    assert not any(_launch_counts().values()), _launch_counts()
    fixed = np.concatenate(waves)
    for r in plain:
        assert r.tokens == fixed[r.rid, :len(r.tokens)].tolist(), \
            f"plain tier: request {r.rid} differs from generate_banked"
    print("plain tier: each wave's tokens equal generate_banked on that wave "
          "bit for bit (the deadline request: its first "
          f"{sc['deadline']} tokens)")

    # kernel tier vs plain tier: teacher-forced logits on the plain tokens
    worst, ties = 0.0, []
    for w in (0, 4):
        p_t = torch.as_tensor(prompts[w:w + 4], device=device)
        toks = torch.as_tensor(fixed[w:w + 4], device=device)
        lk = _forced_paged(model, base, bank, ids[w:w + 4], p_t, toks, False)
        lp = _forced_paged(model, base, bank, ids[w:w + 4], p_t, toks, True)
        assert torch.equal(lp.argmax(-1).cpu(), toks.cpu()), \
            "teacher-forced plain tier does not reproduce its tokens"
        worst = max(worst, float((lk - lp).abs().max()))
        for i in range(4):
            r, want = done[w + i], fixed[w + i, :len(done[w + i].tokens)]
            diff = [t for t, (a, b) in enumerate(zip(r.tokens, want))
                    if a != b]
            if diff:
                top2 = lp[i, diff[0]].topk(2).values
                ties.append((r.rid, diff[0], float(top2[0] - top2[1])))
        del lk, lp
    print(f"kernel vs plain tier: teacher-forced logits max |diff| "
          f"{worst:.3e} (tolerance {LOGIT_ATOL}); requests whose tokens "
          f"part: {len(ties)}")
    for rid, t, margin in ties:
        print(f"  near-tie: request {rid} parts at token {t}, plain-tier "
              f"top-2 margin {margin:.3e}")
        assert margin < LOGIT_ATOL, (rid, t, margin)
    assert worst <= LOGIT_ATOL, worst
    if device.type == "cuda":
        # where the time goes: one wave's prefill and 8 decode steps
        p_t = torch.as_tensor(prompts[:4], device=device)
        toks = torch.as_tensor(fixed[:4, :9], device=device)
        _print_profile(f"scheduled path ({mode}; teacher-forced prefill + 8 "
                       "decode steps)", *_profiled(lambda: _forced_paged(
                           model, base, bank, ids[:4], p_t, toks, False)),
                       1, "prefill + 8 steps")
    return launches, dict(ms_per_step=decode_ms, tokens_per_s=n_tok / wall)


def live_bank_path(model, params, bank):
    """A short scheduled run over a LiveAdapterBank of 2 device slots for
    the 4 tenants: admission defers and promotes."""
    phase("scheduled path over a LiveAdapterBank (2 hot slots, 4 tenants)")
    live = LiveAdapterBank.from_bank(bank, hot_slots=2)
    rng = np.random.default_rng(8)
    reqs = [serve.Request(rid=i, prompt=rng.integers(
        0, model.cfg.vocab_size, 16).astype(np.int32), steps=8,
        adapter_id=i % bank.size) for i in range(4)]
    done = serve.serve_scheduled(model, params, reqs, bank=live,
                                 max_batch=4, block_size=16, chunk=4,
                                 wait=False)
    print(f"live bank: {[len(r.tokens) for r in done]} tokens, "
          f"{live.promotions} promotions, {live.demotions} demotions")
    assert all(len(r.tokens) == 8 for r in done) and live.promotions > 0


# --------------------------------- 9. packed training kernels vs plain

def _qtrain_calls(x, wq, a, b, g, gamma=1.5):
    """{kernel: (kernel wrapper call, plain version call)} for #9, #10 and
    #12 over the packed W ``wq``."""
    lm = lora_matmul
    return {
        "lora_fwd_quant": (lambda: lm.lora_fwd_quant(x, wq, a, b, gamma),
                           lambda: lm.lora_fwd_quant_plain(x, wq, a, b,
                                                           gamma)),
        "lora_bwd_dx_quant": (
            lambda: lm.lora_bwd_dx_quant(g, wq, a, b, gamma),
            lambda: lm.lora_bwd_dx_quant_plain(g, wq, a, b, gamma)),
        "quant_matmul_dx": (lambda: lm.quant_matmul_dx(g, wq),
                            lambda: lm.quant_matmul_dx_plain(g, wq)),
    }


def _check_pair(name, label, got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(_err(name, label, gt, wt) for gt, wt in zip(got, want))


def check_qtrain_kernels(dev="cuda"):
    """#9, #10 and #12 over int8 and int4 (group 64) gemma-2b projections
    at the training path's m = 512 (#9 and #10 at the adapted q and v, #12
    at every base projection), with fp32 and bf16 activations, and a ragged
    case (m 50, k 100: an int4 W holds kq = 128 rows; n 30, r 3).  Then a
    base packed from bf16 weights through all six packed kernels (#3, #4,
    #9, #10, #11, #12), whose loaders round each product to bf16."""
    phase("packed training kernels #9, #10, #12 vs plain (tolerance: "
          f"|kernel - plain| <= {KERNEL_RTOL} * max(1, max|plain|))")
    gen = torch.Generator(dev).manual_seed(9)
    worst = {k: 0.0 for k in QTRAIN_KERNELS}
    cases = [(p, 512, k, n, 64) for p, (k, n) in PROJ.items()]
    cases.append(("ragged", 50, 100, 30, 3))
    for mode, bits in (("int8", 8), ("int4", 4)):
        for label, m, k, n, r in cases:
            wq = quantize(torch.randn(k, n, generator=gen, device=dev)
                          * k ** -0.5, bits, QUANT_GROUP)
            for dt in (torch.float32, torch.bfloat16):
                x, _, a, b, g = _lora_operands(gen, m, k, n, r, dt, dev)
                calls = _qtrain_calls(x, wq, a, b, g)
                if label not in ("q", "v", "ragged"):
                    calls = {"quant_matmul_dx": calls["quant_matmul_dx"]}
                for kern, (kfn, pfn) in calls.items():
                    worst[kern] = max(worst[kern], _check_pair(
                        kern, f"{mode} {label} m={m} k={k} n={n} r={r} "
                        f"{str(dt)[6:]}", kfn(), pfn()))
    # a base packed from bf16 weights, at the q shape: m = 512 and the
    # decode forms' m = 4
    k, n, r = PROJ["q"][0], PROJ["q"][1], 8
    for mode, bits in (("int8", 8), ("int4", 4)):
        wq = quantize((torch.randn(k, n, generator=gen, device=dev)
                       * k ** -0.5).bfloat16(), bits, QUANT_GROUP)
        assert wq.out_dtype == "bfloat16"
        x, _, a, b, g = _lora_operands(gen, 512, k, n, r, torch.float32,
                                       dev)
        bank_a = torch.randn(4, r, k, generator=gen, device=dev) * 0.05
        bank_b = torch.randn(4, n, r, generator=gen, device=dev) * 0.05
        x3 = x.reshape(4, 128, k)
        x4 = x[:4].contiguous()
        lab = f"bf16-packed {mode} q"
        pairs = dict(_qtrain_calls(x, wq, a, b, g))
        pairs["quant_matmul m=512"] = (
            lambda: lora_matmul.quant_matmul(x, wq),
            lambda: lora_matmul.quant_matmul_plain(x, wq))
        pairs["quant_matmul m=4"] = (
            lambda: lora_matmul.quant_matmul(x4, wq),
            lambda: lora_matmul.quant_matmul_plain(x4, wq))
        pairs["bgmv_matmul_quant"] = (
            lambda: bgmv.bgmv_matmul_quant(x3, wq, bank_a, bank_b),
            lambda: bgmv.bgmv_matmul_quant_plain(x3, wq, bank_a, bank_b))
        pairs["bgmv_gemv_quant"] = (
            lambda: bgmv.bgmv_gemv_quant(x4, wq, bank_a, bank_b),
            lambda: bgmv.bgmv_gemv_quant_plain(x4, wq, bank_a, bank_b))
        for kern, (kfn, pfn) in pairs.items():
            err = _check_pair(kern, lab, kfn(), pfn())
            if kern in worst:
                worst[kern] = max(worst[kern], err)
    print(f"launches in this phase (not the path's): "
          f"{ {k: v for k, v in _launch_counts().items() if v} }")
    return worst


def time_qtrain_kernels(dev="cuda"):
    """Times at the training path's shapes (fp32 activations, m = 4 x 128 =
    512, r = 64, gamma 1, int8 and int4 group 64): #9 and #10 at q and v,
    #12 at k, o, w_up and w_down, the packed W rotated over copies that
    together exceed L2 three times (a local step reads each layer's W once
    per pass).  The library call is one torch.matmul on the dequantized
    fp32 W: x @ W for #9, g @ W^T for #10 and #12."""
    phase("packed training kernel times (fp32 activations, m=512, r=64)")
    gen = torch.Generator(dev).manual_seed(10)
    lm = lora_matmul
    rows = {}
    m, r, f4 = 512, 64, 4
    for mode, bits in (("int8", 8), ("int4", 4)):
        for proj in ("q", "v", "k", "o", "w_up", "w_down"):
            k, n = PROJ[proj]
            wf = quantize(torch.randn(k, n, generator=gen, device=dev)
                          * k ** -0.5, bits, QUANT_GROUP).dequantize()
            wq0 = quantize(wf, bits, QUANT_GROUP)
            wqs = [quantize(wf, bits, QUANT_GROUP) for _ in range(max(
                2, math.ceil(3 * L2_BYTES / wq0.nbytes)))]
            wfs = [wf.clone() for _ in range(max(
                2, math.ceil(3 * L2_BYTES / wf.nbytes)))]
            x, _, a, b, g = _lora_operands(gen, m, k, n, r, torch.float32,
                                           dev)
            spec = {"quant_matmul_dx": (
                lm.quant_matmul_dx, lm.quant_matmul_dx_plain,
                lambda g_, w_: torch.matmul(g_, w_.t()),
                [(g, wi) for wi in wqs], [(g, wi) for wi in wfs],
                g.nbytes + wq0.nbytes + m * k * f4, 2 * m * n * k)}
            if proj in ("q", "v"):
                spec["lora_fwd_quant"] = (
                    lm.lora_fwd_quant, lm.lora_fwd_quant_plain, torch.matmul,
                    [(x, wi, a, b, 1.0) for wi in wqs],
                    [(x, wi) for wi in wfs],
                    x.nbytes + wq0.nbytes + a.nbytes + b.nbytes
                    + (m * n + m * r) * f4,
                    2 * m * k * n + 2 * m * k * r + 2 * m * r * n)
                spec["lora_bwd_dx_quant"] = (
                    lm.lora_bwd_dx_quant, lm.lora_bwd_dx_quant_plain,
                    lambda g_, w_: torch.matmul(g_, w_.t()),
                    [(g, wi, a, b, 1.0) for wi in wqs],
                    [(g, wi) for wi in wfs],
                    g.nbytes + wq0.nbytes + a.nbytes + b.nbytes
                    + (m * k + m * r) * f4,
                    2 * m * n * k + 2 * m * n * r + 2 * m * r * k)
            for kern, (kfn, pfn, lfn, args, largs, nbytes, flops) in \
                    spec.items():
                ms = _graph_ms(kfn, args)
                plain_ms = _graph_ms(pfn, args)
                library_ms = _graph_ms(lfn, largs)
                eager_ms = _eager_ms(kfn, args)
                bound_ms, bound_by = _bound(nbytes, flops)
                rows[(kern, f"{mode} {proj}")] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=library_ms,
                    eager_ms=eager_ms)
                print(f"{kern:17s} {mode} {proj:6s} m={m} k={k} n={n} "
                      f"r={r}: kernel {ms * 1e3:.2f} us, plain "
                      f"{plain_ms * 1e3:.2f} us, torch.matmul on the fp32 W "
                      f"{library_ms * 1e3:.2f} us, bound "
                      f"{bound_ms * 1e3:.2f} us ({bound_by}; "
                      f"{nbytes / 1e6:.2f} MB packed, {flops / 1e9:.3f} "
                      f"GFLOP; {flops / ms / 1e9:.2f} TFLOP/s), eager "
                      f"{eager_ms * 1e3:.2f} us")
            del wqs, wfs
    return rows


# ------------------------------------------------------------------ main

def _free():
    gc.collect()
    torch.cuda.empty_cache()


def main():
    smi, name = environment()
    build_kernels()
    worst = check_kernels()
    rows = time_kernels()
    # each kernel's launches come from the counted run of its own path
    fixed = run_path(name, get_config("gemma-2b"), torch.device("cuda"))
    launches = {k: fixed[k] for k in ("bgmv_gemv", "bgmv_matmul")}
    _free()                           # the serving path's weights
    worst.update(check_lora_kernels())
    rows.update(time_lora_kernels())
    train_launches, _ = train_path(name, get_config("gemma-2b"),
                                   torch.device("cuda"))
    launches.update({k: train_launches[k] for k in LORA_KERNELS})
    _free()
    ring = SCHED["plen"] + SCHED["steps"]
    worst.update(check_sched_kernels(SCHED["block_size"], ring))
    rows.update(time_sched_kernels(SCHED["block_size"], ring))
    _free()
    model, params, bank = serving_model(get_config("gemma-2b"),
                                        torch.device("cuda"))
    for mode in ("fp32", "int8", "int4"):
        sched_launches, _ = sched_path(name, model, params, bank, mode)
        _free()
        # #13 from the fp32 run; #3, #4 and #11 from the int4 run
        keep = (("paged_attention",) if mode == "fp32" else
                ("bgmv_matmul_quant", "bgmv_gemv_quant", "quant_matmul")
                if mode == "int4" else ())
        launches.update({k: sched_launches[k] for k in keep})
    live_bank_path(model, params, bank)
    del model, params, bank
    _free()
    worst.update(check_qtrain_kernels())
    rows.update(time_qtrain_kernels())
    _free()
    for mode in ("int8", "int4"):
        qtrain_launches, _ = train_path(name, get_config("gemma-2b"),
                                        torch.device("cuda"), quant=mode)
        _free()
        if mode == "int4":
            launches.update({k: qtrain_launches[k] for k in QTRAIN_KERNELS})
    kernels = []
    for kern in (("bgmv_gemv", "bgmv_matmul") + LORA_KERNELS
                 + SCHED_KERNELS + QTRAIN_KERNELS):
        row = rows[(kern, ROW[kern])]
        kernels.append({
            "name": kern, "route": "cuda", "source": SOURCES[kern],
            "replaces": REPLACES[kern], "launches": launches[kern],
            "max_abs_err": worst[kern], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print()
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
