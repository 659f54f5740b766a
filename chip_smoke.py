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
  7. result: a JSON line of per-kernel numbers, the nvidia-smi line, and
     the final {"ok": true, ...} line

Needs a CUDA device and nvcc; without them it exits non-zero and prints no
result.
"""
import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import (FederatedConfig, LoRAConfig,  # noqa: E402
                                 OptimizerConfig, get_config)
from repro_torch.core import federated                      # noqa: E402
from repro_torch.core.aggregation import get_strategy       # noqa: E402
from repro_torch.core.lora import (AdapterBank, init_adapter_set,  # noqa: E402
                                   split_ab)
from repro_torch.data.synthetic import FederatedDataset     # noqa: E402
from repro_torch.kernels import bgmv, build, dispatch, lora_matmul  # noqa: E402
from repro_torch.launch import serve                        # noqa: E402
from repro_torch.models.api import build_model              # noqa: E402
from repro_torch.tree import tree_leaves                    # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20
KERNEL_RTOL = 1e-4             # fp32 accumulation in both; only the order
                               # of the sums differs (bf16 inputs are
                               # upcast exactly, so the same bound holds)
LOGIT_ATOL = 1e-3              # teacher-forced logits, kernel vs plain tier
# training path: kernel-tier vs plain-tier per-round loss and grad-norm.
# Both run fp32 with the same data; only the order of the sums differs (the
# kernels' tiles vs cuBLAS), and 24 SGD steps through 18 layers carry that
# forward, so the bound is relative and well above fp32 rounding
TRAIN_RTOL = 1e-3
SOURCES = {"bgmv_gemv": "src/repro_torch/kernels/csrc/bgmv.cu",
           "bgmv_matmul": "src/repro_torch/kernels/csrc/bgmv.cu",
           "lora_fwd": "src/repro_torch/kernels/csrc/lora_matmul.cu",
           "lora_bwd_dx": "src/repro_torch/kernels/csrc/lora_matmul.cu",
           "lora_bwd_da": "src/repro_torch/kernels/csrc/lora_matmul.cu",
           "lora_bwd_db": "src/repro_torch/kernels/csrc/lora_matmul.cu"}
REPLACES = {"bgmv_gemv": "src/repro/kernels/bgmv.py:114",
            "bgmv_matmul": "src/repro/kernels/bgmv.py:59",
            "lora_fwd": "src/repro/kernels/lora_matmul.py:55",
            "lora_bwd_dx": "src/repro/kernels/lora_matmul.py:147",
            "lora_bwd_da": "src/repro/kernels/lora_matmul.py:201",
            "lora_bwd_db": "src/repro/kernels/lora_matmul.py:230"}


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


def run_path(name, cfg, device, *, steps=32, plen=128):
    """generate_banked through the user's entry points.  ``cfg`` and
    ``device`` are arguments so the phase can be rehearsed on a CPU at a
    reduced size; the launch counts hold only on the card."""
    phase(f"path: generate_banked, {cfg.name} d_model {cfg.d_model}, fp32")
    model = build_model(cfg)
    gen = torch.Generator(device).manual_seed(0)
    t0 = time.monotonic()
    params = model.init(gen, device)
    n_tenants = 4
    lcfg = LoRAConfig(rank=8, alpha=8.0, scaling="sfedlora",
                      targets=cfg.lora_targets)
    sets = []
    for _ in range(n_tenants):
        s = init_adapter_set(params, gen, lcfg, n_clients=n_tenants)
        sets.append(dataclasses.replace(s, lora=_nonzero_b(s.lora, gen, 0.02)))
    bank = AdapterBank.from_sets(sets)
    ids = torch.arange(n_tenants, device=device, dtype=torch.int32)
    prompt = torch.randint(0, cfg.vocab_size, (n_tenants, plen),
                           generator=gen, device=device)
    max_len = plen + steps
    _sync(device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B parameters, {n_tenants} tenants "
          f"(gamma {sets[0].gamma:.4f} folded), init "
          f"{time.monotonic() - t0:.1f} s")

    # the counted run: counts to 0 just before, read just after
    bgmv.reset_launches()
    dispatch.reset_stats()
    seq = serve.generate_banked(model, params, bank, ids, prompt, steps,
                                max_len)
    _sync(device)
    launches = dict(bgmv.launches)
    n_adapted = len(cfg.lora_targets) * cfg.num_layers
    expect = {"bgmv_matmul": n_adapted, "bgmv_gemv": n_adapted * (steps - 1)}
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


def _lora_operands(gen, m, k, n, r, dtype):
    """x, W, A, B and an output cotangent g, as the training path has them
    (B nonzero)."""
    dev = "cuda"
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

def train_path(name, cfg, device, *, clients=4, rank=64, local_steps=2,
               batch=4, seq=128, rounds=3):
    """FederatedTrainer through the user's entry points (as
    ``repro_torch.launch.train`` builds it).  ``cfg`` and ``device`` are
    arguments so the phase can be rehearsed on a CPU at a reduced size; the
    launch counts hold only on the card."""
    phase(f"training path: FederatedTrainer, {cfg.name} d_model "
          f"{cfg.d_model}, fp32, N={clients}, fedsa + sfedlora, rank {rank}")
    model = build_model(cfg)
    t0 = time.monotonic()
    params = model.init(torch.Generator(device).manual_seed(0), device)
    lcfg = LoRAConfig(rank=rank, alpha=8.0, scaling="sfedlora",
                      targets=cfg.lora_targets)
    fcfg = FederatedConfig(num_clients=clients, local_steps=local_steps,
                           rounds=rounds, aggregation="fedsa")
    ocfg = OptimizerConfig(name="sgd", lr=5e-3)

    def trainer():
        ds = FederatedDataset(cfg.vocab_size, clients, seq_len=seq,
                              batch_per_client=batch, seed=0)
        return federated.FederatedTrainer(
            model, ds, lora_cfg=lcfg, fed_cfg=fcfg, opt_cfg=ocfg, seed=0,
            base_params=params, device=device)

    def b_max(tr):
        return max(float(t.abs().max())
                   for t in tree_leaves(split_ab(tr.lora)[1]))

    def run(tr):
        ms = []
        for i in range(rounds):
            _sync(device)
            t = time.monotonic()
            tr.run_round()
            _sync(device)
            ms.append((time.monotonic() - t) * 1e3)
            if i == 0:
                assert b_max(tr) > 0, "B is still zero after round 1"
        return ms

    _sync(device)
    print(f"init {time.monotonic() - t0:.1f} s; gamma = alpha*sqrt(N/r) = "
          f"{trainer().gamma:.4f}; {clients} clients x {local_steps} local "
          f"steps x batch {batch} x seq {seq} per round, {rounds} rounds")

    # the counted run: counts to 0 just before, read just after
    tr1 = trainer()
    lora_matmul.reset_launches()
    bgmv.reset_launches()
    dispatch.reset_stats()
    ms1 = run(tr1)
    ppl = tr1.eval_perplexity()
    _sync(device)
    launches = dict(lora_matmul.launches)
    n_adapted = len(cfg.lora_targets) * cfg.num_layers
    per_run = n_adapted * clients * local_steps * rounds
    expect = {k: per_run for k in LORA_KERNELS}
    expect["lora_fwd"] += n_adapted                  # one eval forward
    print(f"launches: {launches} (expected {expect}: {n_adapted} each per "
          f"client local step x {clients * local_steps * rounds}, plus "
          f"{n_adapted} of lora_fwd for the eval); bgmv {bgmv.launches}; "
          f"dispatch {dispatch.stats}")
    assert launches == expect, (launches, expect)
    assert not any(bgmv.launches.values()), bgmv.launches
    for h in tr1.history:
        print(f"round {h['round']}: loss {h['loss']:.6f}, grad_norm "
              f"{h['grad_norm']:.6e}")
        assert math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
    print(f"max |B| after {rounds} rounds: {b_max(tr1):.4e}; held-out "
          f"perplexity {ppl:.3f}")
    assert math.isfinite(ppl)

    # the same run again: bit for bit
    tr2 = trainer()
    ms2 = run(tr2)
    same = all(h1["loss"] == h2["loss"] and h1["grad_norm"] == h2["grad_norm"]
               for h1, h2 in zip(tr1.history, tr2.history))
    same = same and all(torch.equal(t1, t2) for t1, t2 in
                        zip(tree_leaves(tr1.lora), tree_leaves(tr2.lora)))
    print(f"second kernel-tier run: trajectory and adapters "
          f"{'bit-identical' if same else 'DIFFER'}")
    assert same, "two kernel-tier runs differ"

    # the plain tier on the same device
    lora_matmul.reset_launches()
    with dispatch.plain_tier():
        tr3 = trainer()
        run(tr3)
    assert not any(lora_matmul.launches.values()), lora_matmul.launches
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

    print(f"training path on {name}: ms/round {[round(t, 1) for t in ms1]} "
          f"(first run), {[round(t, 1) for t in ms2]} (second run); "
          f"{clients * local_steps} client local steps per round")
    if device.type == "cuda":
        profile_local_step(model, tr2)
    return launches, ms2


def profile_local_step(model, tr):
    """torch.profiler over one client local step (forward, backward through
    #5-#8, optimizer update) after a warm-up step."""
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


# ------------------------------------------------------------------ main

# ------------------------------------------------------------------ main

def main():
    smi, name = environment()
    build_kernels()
    worst = check_kernels()
    rows = time_kernels()
    launches = run_path(name, get_config("gemma-2b"), torch.device("cuda"))
    gc.collect()                      # free the serving path's weights
    torch.cuda.empty_cache()
    worst.update(check_lora_kernels())
    rows.update(time_lora_kernels())
    train_launches, _ = train_path(name, get_config("gemma-2b"),
                                   torch.device("cuda"))
    launches.update(train_launches)
    kernels = []
    for kern in ("bgmv_gemv", "bgmv_matmul") + LORA_KERNELS:
        row = rows[(kern, "q")]
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
