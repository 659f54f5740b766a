#!/usr/bin/env python3
"""Smoke check of the PyTorch / CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of the checkout

Phases, in order; any failure raises and the exit code is not 0:
  1. environment: the card's name and power limit (nvidia-smi), TF32 off
  2. build: the CUDA kernels from src/repro_torch/kernels/csrc (nvcc, sm_90a)
  3. kernels vs plain: each BGMV kernel against its plain PyTorch version at
     the gemma-2b q/v shapes, uniform and mixed-rank banks, decode and
     prefill, a ragged case, fp32 and bf16; then their times beside the
     plain version, torch.matmul of the base product and the card's bound
  4. path: repro_torch.launch.serve.generate_banked on gemma-2b at full
     width (fp32, seeded random weights, 4 SFed-LoRA tenants), with the
     kernel launch counts, a teacher-forced check against the plain tier
     on the card, and ms/token
  5. result: a JSON line of per-kernel numbers, the nvidia-smi line, and
     the final {"ok": true, ...} line

Needs a CUDA device and nvcc; without them it exits non-zero and prints no
result.
"""
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import LoRAConfig, get_config      # noqa: E402
from repro_torch.core.lora import AdapterBank, init_adapter_set  # noqa: E402
from repro_torch.kernels import bgmv, build, dispatch       # noqa: E402
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
SOURCE = "src/repro_torch/kernels/csrc/bgmv.cu"
REPLACES = {"bgmv_gemv": "src/repro/kernels/bgmv.py:114",
            "bgmv_matmul": "src/repro/kernels/bgmv.py:59"}


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
            wall, events = _profiled(fn)
            if not events:
                print(f"{label}: device time not measured (the profiler "
                      "recorded no CUDA events)")
                continue
            wall_ms = wall * 1e3 / per
            busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / per
            print(f"{label}: wall {wall_ms:.2f} ms, device busy "
                  f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.2f}, "
                  f"{len(events) / per:.0f} device events per "
                  f"{'prefill' if per == 1 else 'step'}")
            by_name = {}
            for e in events:
                n, us = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
            top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
            for name, (n, us) in top:
                print(f"    {us / 1e3 / per:8.3f} ms  x{n / per:5.1f}  "
                      f"{name[:100]}")


# ------------------------------------------------------------------ main

def main():
    smi, name = environment()
    build_kernels()
    worst = check_kernels()
    rows = time_kernels()
    launches = run_path(name, get_config("gemma-2b"), torch.device("cuda"))
    kernels = []
    for kern in ("bgmv_gemv", "bgmv_matmul"):
        row = rows[(kern, "q")]
        kernels.append({
            "name": kern, "route": "cuda", "source": SOURCE,
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
