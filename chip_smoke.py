#!/usr/bin/env python3
"""Smoke check of the PyTorch / CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of the checkout

Phases, in order; any failure raises and the exit code is not 0:
  1. environment: the card's name and power limit (nvidia-smi), TF32 off
  2. build: the CUDA kernels from src/repro_torch/kernels/csrc (one nvcc
     per source, in parallel, sm_90a)
  3. kernels vs plain: each BGMV kernel against its plain PyTorch version at
     the gemma-2b q/v shapes, uniform and mixed-rank banks, decode and
     prefill, #2 also at recurrentgemma-9b's q / wx / wy and v, a ragged
     case, fp32 and bf16; then their times beside the plain version,
     torch.matmul of the base product and the card's bound (#1 and #2 at
     both models' shapes), with the tiles and split each redesigned kernel
     (#1, #2, #3, #5, #9) launches with
  4. serving path: repro_torch.launch.serve.generate_banked on gemma-2b at
     full width (fp32, seeded random weights, 4 SFed-LoRA tenants), with
     the kernel launch counts, a teacher-forced check against the plain
     tier on the card, ms/token and a profile
  5. LoRA matmul kernels vs plain: #5-#8 (forward, dx, dA, dB) against
     their plain versions at the training path's q/v shapes, bench-4l's
     widest rank (m 256, k 128, n 128, r 512) and two ragged ones, fp32 and
     bf16, #7 and #8 also twice, bit for bit; then their times beside the
     plain versions, one torch.matmul call each and the card's bound, with
     the tiles and split #5 and #6 launch with, and the clusters of #7 and
     #8 and how many the card holds at once
  6. training path: repro_torch's FederatedTrainer on gemma-2b at full
     width (fp32, seeded random base, 4 clients, fedsa + sfedlora, rank
     64), 3 rounds and a held-out eval, with the launch counts of #5-#8,
     per-round loss and grad-norm, the same run on the plain tier, a
     second kernel-tier run that must repeat bit for bit, ms/round and a
     profile of one client local step
  7. paged and quantized kernels vs plain: #13 (paged attention) at the
     scheduled path's shapes (with window and softcap variants), the
     hybrid's 16 query heads with its window of 2048, a 2048-position
     context, and a ragged case with an idle slot, over fp32 and bf16
     pools; #3, #4 (quantized BGMV) and #11 (packed GEMM) over int8 and
     int4 (group 64) gemma-2b projections, #11 at m = 1, 4, 8 (its packed
     GEMV), 9 and 512 (its forward tile) and two ragged shapes; then their
     times beside the plain versions, one PyTorch call each (SDPA for #13)
     and the card's bound, with the split #13, #11 and #4 launch with
  8. scheduled serving path: repro_torch.launch.serve.serve_scheduled on
     gemma-2b at full width and half depth (9 of its 18 layers,
     GEMMA_HALF, since phase 29) over an fp32, an int8 and an int4 base (8
     requests, two waves through 4 slots, one deadline), with the launch
     counts of #13 and #1-#4, #11, the plain tier's tokens against
     generate_banked wave by wave, the kernel tier's against the plain
     tier's, ms per decode step and tokens/s; then a short run over a
     LiveAdapterBank of 2 hot slots
  9. packed training kernels vs plain: #9, #10 (the LoRA matmul forward
     and dx over a packed W) and #12 (the packed GEMM's dx) over int8 and
     int4 (group 64) gemma-2b projections at m = 512 (#9, #10 at rank 64
     and 8) and a ragged case, fp32 and bf16 activations; a base packed
     from bf16 weights through all six packed kernels (#3, #4, #9-#12);
     then the times of #9, #10 and #12 beside their plain versions, one
     torch.matmul on the dequantized W and the card's bound, with the tiles
     and split #9, #10 and #12 launch with
 10. training path over a packed base: the FederatedTrainer of phase 6 at
     GEMMA_HALF's depth (since phase 29) over an int8 and an int4 base
     (#9, #10, #7, #8 at q and v; #11 and #12 at
     k, o and the MLP), with the launch counts, a bit-identical repeat,
     save / resume bit for bit, the plain tier, ms/round and (int4) a
     profile of one client local step
 11. RG-LRU scan and flash attention vs plain: #15 at the RG-LRU
     prefill's (4, 128, 4096), the kernel bench's (4, 2048, 256) and a
     ragged (3, 100, 1000); #14 at recurrentgemma-9b's local attention
     (s = t = 4096, 16 heads on one kv head, d 256, causal, window 2048),
     gemma-2b's (s = t = 2048, 8 heads, causal) and a non-causal cross shape
     (s 512, t 2048); fp32 and bf16, the tolerances of tests/test_kernels.py;
     then their times beside the plain versions, SDPA (#14) and the card's
     bound
 12. kernel API path: repro_torch.kernels.ops (flash_mha at both attention
     shapes, rglru_scan_op, fused_lora_matmul), with the launch counts of
     #14, #15 and #5 and the outputs against the plain versions
 13. hybrid serving path: recurrentgemma-9b at full width and half depth
     (19 of its 38 layers, RG_PATHS, since phase 28; fp32, seeded random
     weights, the 4 SFed-LoRA tenants of phase 4 at q, v, wx, wy) through
     generate_banked (13 launches of #15 and 38 of #2 per prefill, 38 of
     #1 per decode step, teacher-forced logits against the
     plain tier, ms/token, a profile) and serve_scheduled (the traffic of
     phase 8 over an fp32 base: #15 per admission group, #13 per decode
     step, plain tier against generate_banked wave by wave, kernel tier
     against plain tier)
 14. the dense configs' shapes: #1 and #2 at mistral-nemo-12b's q (5120
     -> 4096) and v (5120 -> 1024) and llama2-7b's q / v (4096 x 4096);
     #11 at m = 1, 4, 8 and 512 and #12 at llama2-7b's w_up (n = 11008)
     and w_down (k = 11008) over int8 and int4; #13 at llama2-7b's 32 kv
     heads of 128, qwen3-8b's 4 query heads a kv head and stablelm-1.6b's
     head_dim 64; #5-#8 at llama2-7b's q / v with rank 64, 128 and a rank
     16 padded to 128; fp32 and bf16 against the plain versions, then
     timed beside the plain versions, one PyTorch call each and the bound
 15. llama2-7b at full width and half depth (16 of its 32 layers, fp32;
     the whole script's time limit, see LLAMA_PATHS): generate_banked (32
     of #2 per prefill, 32 of #1 per decode step), serve_scheduled over
     fp32 (16 of #13 per decode step) and int4 bases (80 of #11 per decode
     step), the training path (rank 64, 32 of each of #5-#8 per client
     local step), the same run with per-client
     ranks (16, 32, 64, 128) (every masked row exactly 0.0 after each
     round, the plain tier, ranks all 64 bit-identical to the homogeneous
     run) and FLoRA's stacking over those ranks (2 rounds, two kernel-tier
     runs bit for bit, B A against the plain tier, the server step's share
     of a round); then qwen3-8b (18 of its 36 layers, fp32) through
     serve_scheduled
 16. the hybrid's training widths: #15's backward against its plain
     reverse loop bit for bit (and a repeat) at the scan phase's three
     shapes and s = 1, fp32 and bf16; #9, #10, #7 and #8 at
     recurrentgemma-9b's q / wx / wy (4096 x 4096) and v (4096 x 256), rank
     64, and #11 (m = 4 and 512) and #12 at its MLP (4096 <-> 12288), over
     int8 and int4; then their times beside the plain versions, one PyTorch
     call where there is one and the card's bound (#3 and #4 at q / wx / wy
     and v as well, #5-#8 at v over fp32)
 17. hybrid training, fp32 base: FederatedTrainer on recurrentgemma-9b at
     full width and RG_PATHS's half depth (19 layers since phase 28;
     seeded random weights), LoRA at q, v, wx and wy, fedsa + sfedlora,
     N = 4, rank 64, 3 rounds: launch counts (38 of each of #5-#8, 13 of
     #15 and 13 of its backward per client local step), the plain tier, a
     bit-identical
     repeat, ms/round, peak memory and a profile of one local step
 18. hybrid training over an int4 base packed on the card from a seeded
     fp32 base of the same half depth (19 layers, RG_PATHS; freed once
     packed): the checks of 17 with #9-#12, and save / resume bit for bit
 19. hybrid serving over an int4 base at that half depth: generate_banked
     (#3, #4, #11, #15) and serve_scheduled (#13 as well), with the checks
     of 13
 20. result: a JSON line of per-kernel numbers, the script's time, the
     nvidia-smi line, and the final {"ok": true, ...} line
 21. the fault-tolerant engine (run after phase 29, since then at
     GEMMA_HALF's depth: 9 of gemma-2b's 18 layers, on a base of its own
     and against phase 6's training path run again at that depth):
     FederatedTrainer's buffered engine (N = 4, rank 64, 2 local steps of 4
     x 128, fedsa): at null faults bit-identical to the synchronous run,
     with its #5-#8
     launches per client local step; publish_adapters into a
     LiveAdapterBank (2 hot slots, 4 tenants) and phase 8's traffic through
     serve_scheduled, tokens equal to a static AdapterBank's (#1, #2, #13
     counted); faults dropout=0.2, straggle=geom:0.3, corrupt=0.25 (nan)
     over 4 rounds in chunks of 2 (every leaf finite after every round, a
     bit-identical repeat, save after round 2 and resume bit for bit, the
     plain tier within 1e-3); noise-mode corruption screened as norm
     outliers; the collapse watchdog on scaling lora (collapse -> rescale,
     the run finishing under sfedlora gammas), its snapshot and rollback
     cost, phase 6's stability_report(); ms/round of each
 22. the MoE archs' shapes (run after phase 19): #1 and #2 at
     granite-moe-1b-a400m's q (1024 -> 1024) and v (1024 -> 512) and
     qwen2-moe-a2.7b's q / v (2048 -> 2048), #5-#8 there, at ranks 8 and
     64; #13 at qwen2-moe's 16 kv heads of 128 and granite's 16 query
     heads on 8 of 64; #3, #4, #9-#12 at granite's q / k / v / o over int8
     and int4; fp32 and bf16 against the plain versions, then timed beside
     the plain versions, one PyTorch call each and the bound
 23. qwen2-moe-a2.7b at full width and half depth (12 of its 24 layers,
     QWEN_MOE_PATHS, since phase 28; 60 experts padded to 64, fp32), every
     earlier model freed first: generate_banked (24 of #2 per prefill, 24
     of #1 per decode step), serve_scheduled over fp32 (12 of #13 per
     decode step) and the training path (24 of each of #5-#8 per client
     local step), each with
     the router's top-k choices that differ between the kernel and the
     plain tier, peak memory, and the expert bmms' share of a local step
 24. granite-moe-1b-a400m at full width and half depth (12 of its 24
     layers, GRANITE_PATHS, since phase 28; 32 experts top-8) over an int4
     base (q / k / v / o packed):
     serve_scheduled (#3, #4, #11, #13), and training with data_mode
     "device" at N = 16 over a Dirichlet partition, 4 rounds in chunks of
     2 (#9, #10, #7, #8, #11, #12 counted, two kernel-tier runs and a
     resume after round 2 bit for bit, the plain tier within 1e-3)
 25. xlstm-1.3b at full width and half depth (24 of its 48 layers
     alternating mLSTM and sLSTM, d_model 2048, fp32; XLSTM_PATHS, cut
     for the script's time limit since phase 26), every earlier model
     freed first: generate_banked (24 of #2 per prefill, 24 of #1 per
     decode step: q and v of the 12 mLSTM layers), serve_scheduled over
     fp32 (fresh per-slot mLSTM and sLSTM state at each admission; no #13,
     nothing packed) and the training path (24 of each of #5-#8 per
     client local step; XLSTM_TRAIN), with peak memory and profiles
 26. whisper-medium (d_model 1024, 16 heads of 64, fp32; its paths at
     half depth since phase 28, WHISPER_PATHS: 12 of its 24 decoder xattn
     layers and 12 of its 24 encoder layers), every earlier model freed
     first: its new kernel shapes (#13 at 16 query heads on 16 kv
     heads of 64; #11, #3, #4 at its MLP, 1024 -> 4096 and 4096 -> 1024,
     int8 and int4, #11 also at m = 6000) against their plain versions and
     timed; generate_banked as the serve CLI runs it (the decoder alone:
     36 of #2 per prefill, 36 of #1 per decode step); the encoder path
     (Model._encode over 4 x 1500 frames, prefill(enc_out=), 32 greedy
     tokens against the plain tier, a control without enc_out, the encoder
     over int4 with #11 at m = 6000); serve_scheduled over fp32 and int4
     (12 of #13 per decode step); training through
     FederatedTrainer.round_step with frames (36 of each of #5-#8 per
     client local step; the encoder's and cross v's gradients exactly 0,
     their B 0.0), with peak memory and profiles
 27. paligemma-3b (d_model 2048, 8 heads on one kv head of 256, GeGLU
     16384, vocab 257280 padded, patch_proj 1152 x 2048; fp32; at half
     depth since phase 31, PALIGEMMA_PATHS: 9 of its 18 layers), every
     earlier model freed first: generate_banked as the serve CLI runs it
     (text only: 18 of #2 per prefill, 18 of #1 per decode step); the
     vision-prefix forward (Model.forward over 4 x (256 stub patches + 128
     tokens) under the bank: 18 of #2, the plain tier's logits, a control
     with the patches zeroed); training through FederatedTrainer.round_step
     with patches (18 of each of #5-#8 per client local step, and 18 more
     of #5 in the recompute), then those rounds with the chunked CE
     (repro_torch.sharding.opts "chunked_ce": loss and grad-norm within
     1e-4); one local step over 4 x (256 + 1100) with the chunked CE off
     and on, the peak memory of each (the chunked one lower)
 28. roberta-large (d_model 1024, 16 heads of 64, fp32; at half depth
     since phase 29, ROBERTA_PATHS: 12 of its 24 layers): generate_banked
     as the serve CLI runs it (causal decode, as in JAX: 24 of #2 per
     prefill, 24 of #1 per decode step), serve_scheduled over fp32 (12 of
     #13 per decode step), a bidirectional control on the kernel tier,
     and the training path with the MLM loss, adamw over a Dirichlet(0.5)
     partition (24 of each of #5-#8 per client local step)
 29. training on a mesh (run right after phase 6, against its run):
     FederatedTrainer(mesh=) on gemma-2b at full width and depth over a
     1x1 mesh of a one-rank gloo group here and a 2x1 mesh of two spawned
     gloo ranks sharing the card (each trains two of the four clients and
     all-gathers the rest), both bit for bit phase 6's history, adapters
     and optimizer state, with each rank's #5-#8 launches and ms/round;
     #5-#8 at a 1x2 mesh's local shapes (q 2048 -> 1024, v 256 -> 128, m
     512, r 64) against their plain versions and timed.  A model axis
     cannot run on one card (the comment above MESH_TP_CASES says why).
     After phase 24: granite-moe at GRANITE_PATHS's depth with the
     moe_grouped switch (generate_banked and one training round, the
     kernel tier against the plain tier with routing replayed) and a
     control: one MoE layer where capacity drops tokens, grouped and flat
     dispatch differ, and where no expert can overflow, they agree
 30. the dry-run (repro_torch.launch.dryrun): its CLI as a child process
     for gemma-2b train_4k and decode_32k on the 16x16 pod (a fake
     process group, meta tensors; each record printed, its per-device
     argument bytes equal to the port's partition rules' sum), then a
     traced full-width gemma-2b round (one client at phase 6's batch and
     sequence, 1x1) against the same round run on this device on the
     plain tier: FlopCounterMode's count equal to the trace's, the peak
     above the arguments within TEMP_RTOL of the trace's temp bytes; the
     kernel tier's peak and both tiers' round times beside the roofline
     terms at the H100 data-sheet peaks
 31. remat (run right after phase 6, on its base): phase 6's round with
     apply_stack's whole-unit remat on (the default, as in JAX) and off,
     on both tiers: bit for bit equal; ms/round, the peak above the
     arguments and #5's launches of each.  Every training path's counts
     include the recompute (_recompute_counts)
 32. (after phase 8) serve_scheduled(transfer_guard=True) on phase 8's
     traffic over fp32 and int4 bases: the synchronizing operations the
     guard catches inside admission and the chunks (none expected), and
     tokens equal to the unguarded run's
 33. (after phase 32) the blocked attention's backward at 4096 positions
     with its kv-step checkpoint on and off, against the whole score
     matrix: the peaks, and the gradients
 34. (after phase 9's checks) guarded edges: the ragged cases of #1-#12,
     #14 and #15 (fp32 and bf16; int8 and int4) with every operand flush
     against an unmapped page, at its end and at its start, against the
     plain versions

Needs a CUDA device and nvcc; without them it exits non-zero and prints no
result.
"""
import collections
import contextlib
import ctypes
import dataclasses
import gc
import itertools
import json
import math
import os
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
from repro_torch.core.faults import parse_faults            # noqa: E402
from repro_torch.core.lora import (AdapterBank, AdapterSet,  # noqa: E402
                                   LiveAdapterBank, init_adapter_set,
                                   split_ab)
from repro_torch.core.quant import (apply_quant_flag,  # noqa: E402
                                    quant_footprint, quantize,
                                    quantize_tree)
from repro_torch.data.synthetic import FederatedDataset     # noqa: E402
from repro_torch.kernels import (bgmv, build, common,  # noqa: E402
                                 dispatch, flash_attention, lora_matmul, ops,
                                 paged_attention, rglru_scan)
from repro_torch.launch import serve                        # noqa: E402
from repro_torch.models import moe, transformer             # noqa: E402
from repro_torch.models.api import (PATCH_EMBED_DIM,  # noqa: E402
                                    build_model)
from repro_torch.models.transformer import stack_layout     # noqa: E402
from repro_torch.sharding import opts                       # noqa: E402
from repro_torch.tree import tree_leaves, tree_map          # noqa: E402

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
BF16_ATOL = 1e-3               # beside BF16_STEP, for outputs near zero
LOGIT_ATOL = 1e-3              # teacher-forced logits, kernel vs plain tier
# training path: kernel-tier vs plain-tier per-round loss and grad-norm.
# Both run fp32 with the same data; only the order of the sums differs (the
# kernels' tiles vs cuBLAS), and 24 SGD steps through 18-38 layers carry that
# forward, so the bound is relative and well above fp32 rounding
TRAIN_RTOL = 1e-3
# the chunked CE against the plain CE, both on the kernel tier: the same
# numbers summed in other chunks (the JAX package's test holds the two to
# 1e-4 absolute)
CHUNKED_RTOL = 1e-4
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"bgmv_gemv": "src/repro_torch/kernels/csrc/qgemv.cu",
           "bgmv_matmul": "src/repro_torch/kernels/csrc/bgmv.cu",
           "lora_fwd": "src/repro_torch/kernels/csrc/lora_matmul.cu",
           "lora_bwd_dx": "src/repro_torch/kernels/csrc/dense_dx.cu",
           "lora_bwd_da": CSRC + "lora_grads.cu",
           "lora_bwd_db": CSRC + "lora_grads.cu",
           "paged_attention": CSRC + "paged_attention.cu",
           "bgmv_matmul_quant": CSRC + "bgmv.cu",
           "bgmv_gemv_quant": CSRC + "qgemv.cu",
           "quant_matmul": CSRC + "lora_matmul.cu",
           "lora_fwd_quant": CSRC + "lora_matmul.cu",
           "lora_bwd_dx_quant": CSRC + "packed_dx.cu",
           "quant_matmul_dx": CSRC + "packed_dx.cu",
           "rglru_scan": CSRC + "rglru_scan.cu",
           "flash_attention": CSRC + "flash_attention.cu",
           "rglru_scan_bwd": CSRC + "rglru_scan.cu"}
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
            "quant_matmul_dx": "src/repro/kernels/lora_matmul.py:544",
            "rglru_scan": "src/repro/kernels/rglru_scan.py:21",
            "flash_attention": "src/repro/kernels/flash_attention.py:22",
            # no Pallas body: JAX differentiates associative_scan there
            "rglru_scan_bwd": "src/repro/models/rglru.py:61"}
# the row of each kernel's times that the kernels line reports
ROW = {"bgmv_gemv": "q", "bgmv_matmul": "q", "lora_fwd": "q",
       "lora_bwd_dx": "q", "lora_bwd_da": "q", "lora_bwd_db": "q",
       "paged_attention": "path", "bgmv_matmul_quant": "int4 q m=512",
       "bgmv_gemv_quant": "int4 q m=4", "quant_matmul": "int4 w_up m=4",
       "lora_fwd_quant": "int4 q", "lora_bwd_dx_quant": "int4 q",
       "quant_matmul_dx": "int4 w_up", "rglru_scan": "path",
       "flash_attention": "recurrentgemma-9b", "rglru_scan_bwd": "path"}


T_START = time.monotonic()


def phase(name):
    print(f"\n== {name} [{time.monotonic() - T_START:.1f} s]", flush=True)


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
    # recurrentgemma-9b's q / wx / wy and v (prefill only): one unsplit
    # and one 16-way split plan of the rank-fused forward tile
    cases += [(f"rg9b {proj}", 4, 128, 4096, n, 4, (8,) * 4)
              for proj, n in (("q", 4096), ("v", 256))]
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


def _fwd_plan_note(m, n, k, r, bits=0, group=0):
    """The tiles and the split a rank-fused forward tile kernel (#2, #3, #5,
    #9) launches with on this card (kernels/common.py fwd_plan)."""
    ksplit_p, kchunk_p, ksplit, kchunk = common.fwd_plan(
        m, n, k, r, common.num_sms(torch.device("cuda")), bits, group)
    rows, cols, pre = common.FWD_ROWS, common.FWD_COLS, common.FWD_PRE_COLS
    return (f"[pre-pass {rows}x{pre} tiles x {ksplit_p} chunks of {kchunk_p}"
            f"; main {rows}x{cols} tiles x {ksplit} chunks of {kchunk}]")


def _dx_plan_note(m, k, n):
    """The tiles and the split #12 launches with on this card
    (kernels/common.py dx_plan)."""
    ksplit, kchunk = common.dx_plan(m, k, n,
                                    common.num_sms(torch.device("cuda")))
    return (f"[{common.FWD_ROWS}x{common.FWD_COLS} tiles x {ksplit} chunks "
            f"of {kchunk}{'; fixed-order sum' if ksplit > 1 else ''}]")


def _qmm_plan_note(m, k, n, bits, group):
    """The form, tiles and split #11 launches with on this card: the packed
    GEMV (kernels/common.py qgemv_split) for m <= 8 rows, else the forward
    tile with no rank term (qmm_plan)."""
    sms = common.num_sms(torch.device("cuda"))
    if m <= common.QGEMV_MAX_ROWS:
        ksplit, kchunk = common.qgemv_split(k, n, sms)
        form = f"packed GEMV, {common.QGEMV_COLS}-column blocks"
    else:
        ksplit, kchunk = common.qmm_plan(m, n, k, sms, bits, group)
        form = f"{common.FWD_ROWS}x{common.FWD_COLS} tiles"
    return (f"[{form} x {ksplit} chunks of {kchunk}"
            f"{'; fixed-order sum' if ksplit > 1 else ''}]")


def _gemv_plan_note(nreq, k, n, col_bytes):
    """The column blocks and split #1 and #4 launch with on this card: the
    decode GEMV (kernels/common.py gemv_plan; a W row's column takes
    col_bytes bytes), then the fixed-order pass."""
    ksplit, kchunk = common.gemv_plan(nreq, k, n, col_bytes,
                                      common.num_sms(torch.device("cuda")))
    cols = common.QGEMV_COLS // col_bytes
    return (f"[decode GEMV, {-(-n // cols)} blocks of {cols} columns x "
            f"{ksplit} chunks of {kchunk}; fixed-order pass]")


def _dx_rank_plan_note(m, k, n, r):
    """The tiles and the split #6 and #10 launch with on this card
    (kernels/common.py dx_rank_plan)."""
    ksplit_p, kchunk_p, ksplit, kchunk = common.dx_rank_plan(
        m, k, n, r, common.num_sms(torch.device("cuda")))
    rows, cols, pre = common.FWD_ROWS, common.FWD_COLS, common.FWD_PRE_COLS
    return (f"[q pre-pass {rows}x{pre} tiles x {ksplit_p} chunks of "
            f"{kchunk_p}; main {rows}x{cols} tiles x {ksplit} chunks of "
            f"{kchunk}]")


def _reduce_plan_note(m, ni, nj):
    """The tiles, clusters and chunks #7 / #8 launch with on this card
    (kernels/common.py reduce_plan), and how many such clusters the card
    holds at once (cudaOccupancyMaxActiveClusters)."""
    c, chunk = common.reduce_plan(m, ni, nj,
                                  common.num_sms(torch.device("cuda")))
    tile = common.REDUCE_TILE
    tiles = -(-ni // tile) * -(-nj // tile)
    held = build.load().lora_grads_max_clusters(c)
    return (f"[{tiles} tiles of {tile}x{tile} x clusters of {c} CTAs, "
            f"chunks of {chunk} rows; the card holds {held} such clusters "
            "at once]")


def _paged_plan_note(b, kh, mb):
    """The grid and the split #13 launches with on this card
    (kernels/common.py paged_split)."""
    nsplit, cols = common.paged_split(b, kh, mb,
                                      common.num_sms(torch.device("cuda")))
    return (f"[grid {b}x{kh}x{nsplit}: {nsplit} chunks of {cols} columns"
            f"{'; merge' if nsplit > 1 else ''}]")


def _bgmv_shapes(projs):
    """(kernel, rows a request, label, k, n) of #1 (decode) and #2 (a
    128-token prefill) at each (label, k, n) of ``projs``."""
    return [(kern, s, proj, k, n)
            for kern, s in (("bgmv_gemv", 1), ("bgmv_matmul", 128))
            for proj, k, n in projs]


def time_kernels(shapes=None):
    """Times at the serving path's shapes (fp32, B=4 requests, rank 8,
    per-request adapters gathered: ids=None), W rotated over copies that
    together exceed L2 three times, as a decode step finds W cold: gemma-2b's
    q and v, and for #1 and #2 also recurrentgemma-9b's q / wx / wy (k = n =
    4096) and v (k = 4096, n = 256), where its hybrid decode steps and
    prefill spend their time; or ``shapes`` (:func:`_bgmv_shapes`)."""
    phase("kernel times (fp32, B=4, r=8, W cold in L2)")
    gen = torch.Generator("cuda").manual_seed(2)
    rows = {}
    if shapes is None:
        shapes = _bgmv_shapes([("q", 2048, 2048), ("v", 2048, 256),
                               ("rg9b q", 4096, 4096),
                               ("rg9b v", 4096, 256)])
    for kern, s, proj, k, n in shapes:
        B, r = 4, 8
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
        note = " " + (_fwd_plan_note(m, n, k, r) if kern == "bgmv_matmul"
                      else _gemv_plan_note(B, k, n, 4))
        print(f"{kern:12s} {proj} x({B},{s},{k}) W({k},{n}) r={r}: "
              f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
              f"torch.matmul (base product only) {library_ms * 1e3:.2f} "
              f"us, bound {bound_ms * 1e3:.2f} us ({bound_by}; "
              f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP), "
              f"eager call with host overhead {eager_ms * 1e3:.2f} us"
              f"{note}")
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
    """``cfg``'s model with seeded random weights and 4 SFed-LoRA tenants
    (alpha 8, rank 8, B drawn at std 0.02), as run_path builds them."""
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


def _layer_kinds(cfg):
    """The block kind of every layer, in stack order."""
    repeats, tail = stack_layout(cfg.num_layers, cfg.block_pattern)
    return tuple(cfg.block_pattern) * repeats + tuple(tail)


def _n_adapted(bank):
    """Adapted projections per token of the stack: one per layer for each
    LoRA pair (a, b) the bank holds, a repeat leaf (K, repeats, ...)
    standing for its repeats (gemma-2b: 18 x q, v; recurrentgemma-9b: 12 x
    q, v plus 26 x wx, wy; whisper-medium: 24 x attn q, attn v, cross q).
    A cross-attention k / v pair is never applied (the cross K/V take no
    adapter, as in the JAX package), so it does not count."""
    stack = bank.lora["stack"]

    def unread(node):
        return {k: ({p: v for p, v in sub.items() if p not in ("k", "v")}
                    if k == "cross" else sub) for k, sub in node.items()}

    rep_ = {k: unread(v) for k, v in stack.get("repeat", {}).items()}
    tail = {k: unread(v) for k, v in stack.get("tail", {}).items()}
    return (sum(x.shape[1] for x in tree_leaves(rep_))
            + len(tree_leaves(tail))) // 2


# each block kind's own GEMM projections that core/quant packs, and the
# MLP's; an xLSTM block packs none and has no MLP, and of its projections
# only the mLSTM's q, k and v take an adapter through dispatch (its o and
# ogate are plain matmuls, as in the JAX package).  An xattn block runs its
# self-attention's q, k, v, o and its cross-attention's q and o per token
# (CROSS_PROJ); the cross k and v run over the encoder's frames, once per
# encoder output, and never in the serve CLI's decoder-only path
OWN_PROJ = {"attn": ("q", "k", "v", "o"), "xattn": ("q", "k", "v", "o"),
            "rglru": ("wx", "wy"), "mlstm": (), "slstm": ()}
CROSS_PROJ = {"xattn": ("q", "o")}
ADAPTED_ONLY = {"mlstm": ("q", "k", "v")}
MLP_PROJ = ("w_gate", "w_up", "w_down")
ATTN_KINDS = ("attn", "xattn")


def _proj_counts(cfg):
    """(adapted, unadapted, unadapted reading the stack's input): the GEMM
    projections of the stack that core/quant packs, per token, with and
    without a LoRA target, and those of layer 0 without one that read the
    embedding (no gradient reaches it, so #12 skips them).  The RG-LRU
    block's w_a, w_i and w_out are never packed, nor is the MoE block's
    router or experts, nor any xLSTM projection; the mLSTM's q and v count
    as adapted (gemma-2b: 36, 90, 1; recurrentgemma-9b: 76, 138, 0; the MoE
    archs: 48, 48, 1; xlstm-1.3b: 48, 0, 0; whisper-medium: 72 (attn q, v,
    cross q), 120 (attn k, o, cross o, w_up, w_down), 1)."""
    mlp = (() if cfg.moe is not None else MLP_PROJ
           if cfg.mlp_variant in ("geglu", "swiglu") else MLP_PROJ[1:])
    adapted = unadapted = 0
    for kind in _layer_kinds(cfg):
        for proj in (OWN_PROJ[kind] + CROSS_PROJ.get(kind, ())
                     + (mlp if kind in ATTN_KINDS + ("rglru",) else ())):
            if proj in cfg.lora_targets:
                adapted += 1
            else:
                unadapted += 1
        adapted += sum(p in cfg.lora_targets
                       for p in ADAPTED_ONLY.get(kind, ()))
    first = _layer_kinds(cfg)[0]
    reads_input = [p for p in OWN_PROJ[first] if p != "o"]
    return adapted, unadapted, sum(p not in cfg.lora_targets
                                   for p in reads_input)


def _recompute_counts(cfg):
    """(adapted, unadapted, RG-LRU scans) the backward's recompute launches
    again per client local step: ``apply_stack`` checkpoints each repeat
    unit whole (the tail layers run once), and the recompute stops at the
    unit's last tensor saved for the backward, so a unit that closes on an
    unadapted dense MLP (whose w_down keeps only its frozen weight) does
    not rerun that w_down (gemma-2b: 36, 72, 0 at 18 layers;
    recurrentgemma-9b at 19 layers: 36, 60, 12; the MoE archs at 12: 24,
    24, 0; xlstm-1.3b at 24: 24, 0, 0)."""
    kinds = _layer_kinds(cfg)
    pattern = tuple(cfg.block_pattern)
    units = len(kinds) // len(pattern)
    unit = dataclasses.replace(cfg, num_layers=len(pattern))
    adapted, unadapted, _ = _proj_counts(unit)
    dense_mlp = cfg.moe is None and pattern[-1] in ATTN_KINDS + ("rglru",)
    closing = int(dense_mlp and "w_down" not in cfg.lora_targets)
    return (units * adapted, units * (unadapted - closing),
            units * pattern.count("rglru"))


def _in_backward() -> bool:
    """True inside the autograd engine: a checkpoint's recompute."""
    return torch._C._current_graph_task_id() != -1


@contextlib.contextmanager
def _routing(log, replay=None):
    """Within the block, every MoE layer appends its router's probabilities
    and top-k experts (recomputed from the layer's input by ``moe.route``)
    to ``log``; a dense model appends nothing.  ``replay`` (another run's
    log of the same calls) makes each call dispatch to that run's experts
    (``moe_apply(top_i=)``), while ``log`` still records this run's own
    choice: the plain tier replays the kernel tier's routing, so the tiers
    are held to each other on the same dispatch, and the choices a router
    near-tie would have flipped are counted, not hidden.  The backward's
    recompute of a layer (``apply_stack``'s remat; where it stops differs
    between tiers) logs nothing and dispatches as the layer's forward did,
    found by its parameter dict, which the checkpoint keeps alive."""
    orig = transformer.moe_apply
    forced_by_layer = {}

    def wrapped(cfg, params, x, adapters=None):
        if _in_backward():
            return orig(cfg, params, x, adapters=adapters,
                        top_i=forced_by_layer.get(id(params)))
        with torch.no_grad():
            probs, _, top_i = moe.route(cfg, params,
                                        x.reshape(-1, x.shape[-1]))
        log.append((probs, top_i))
        forced = None if replay is None else replay[len(log) - 1][1]
        forced_by_layer[id(params)] = forced
        return orig(cfg, params, x, adapters=adapters, top_i=forced)

    transformer.moe_apply = wrapped
    try:
        yield log
    finally:
        transformer.moe_apply = orig


# The xLSTM family at full depth on seeded random weights amplifies
# rounding about 1.3x a layer: the plain tier against itself, the embedding
# scaled by 1 + 1e-7, moves the prefill's logits by O(1) (run_path prints
# it).  No end-to-end comparison of two tiers can hold such a model to
# LOGIT_ATOL, so for these families the plain tier is pinned to the kernel
# tier layer by layer, as the MoE paths replay the router's choices: each
# block takes the kernel tier's input to it in value (the gradient still
# reaches the block before), and each block's output is held against the
# kernel tier's within PIN_RTOL of max(1, max|output|).  Each block's own
# kernel error is what stays.
PINNED_FAMILIES = ("ssm",)
PIN_RTOL = 1e-3


class _Pinned(torch.autograd.Function):
    """``value`` in the forward; the gradient passes to ``x`` unchanged."""

    @staticmethod
    def forward(ctx, x, value):
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


@contextlib.contextmanager
def _pinning(cfg, log, replay=None):
    """For a family of PINNED_FAMILIES (else a no-op), every block call
    (``transformer.apply_block``) appends to ``log``: its input and output,
    or, under ``replay`` (the kernel tier's log of the same calls), the
    call takes that log's input and appends its output's max |difference|
    from the logged output and the logged output's max |value| (device
    scalars: no host sync).  The backward's recompute of a block logs
    nothing and takes the value its forward took, found by the block's
    parameter dict (as :func:`_routing` does)."""
    if cfg.family not in PINNED_FAMILIES:
        yield log
        return
    orig = transformer.apply_block
    value_by_block = {}

    def wrapped(cfg_, kind, p, x, **kw):
        if _in_backward():
            value = value_by_block.get(id(p))
            if value is not None:
                x = _Pinned.apply(x, value) if x.requires_grad else value
            return orig(cfg_, kind, p, x, **kw)
        if replay is not None:
            value = replay[len(log)][0]
            value_by_block[id(p)] = value
            x = _Pinned.apply(x, value) if x.requires_grad else value
        out = orig(cfg_, kind, p, x, **kw)
        y = out[0].detach()
        if replay is None:
            log.append((x.detach().clone(), y.clone()))
        else:
            want = replay[len(log)][1]
            log.append(((y - want).abs().amax(), want.abs().amax()))
        return out

    transformer.apply_block = wrapped
    try:
        yield log
    finally:
        transformer.apply_block = orig


def _pin_report(label, log):
    """Print and check a pinned plain-tier log: the worst block output's
    max |difference| from the kernel tier's, relative to max(1,
    max|output|).  Returns it (0.0 for a log that is empty: no pinning)."""
    if not log:
        return 0.0
    diff = torch.stack([d for d, _ in log])
    rel = diff / torch.stack([s for _, s in log]).clamp_min(1.0)
    worst = int(rel.argmax())
    print(f"pinned blocks, {label}: {len(log)} block calls, worst "
          f"|diff| {float(rel[worst]):.3e} of max(1, max|output|) at call "
          f"{worst} (absolute {float(diff[worst]):.3e}; median "
          f"{float(rel.median()):.3e}), tolerance {PIN_RTOL}")
    assert float(rel[worst]) <= PIN_RTOL, (label, float(rel[worst]))
    return float(rel[worst])


def _pin_control(model, params, adapters, prompt, max_len, pin_k):
    """The pinned check's control, at full depth: the plain tier's prefill
    pinned to the kernel tier's blocks (``pin_k``, whose first calls are
    the prefill's), with the LoRA term of the last adapted layer dropped
    (its B zeroed), where the residual stream, and so the check's absolute
    tolerance, is largest.  That block must fail the check."""
    cfg = model.cfg
    period = len(cfg.block_pattern)
    layer = max(i for i, k in enumerate(_layer_kinds(cfg))
                if k in ADAPTED_ONLY)
    rep, pos = divmod(layer, period)

    def drop(t):
        if set(t) == {"a", "b"}:
            b = t["b"].clone()
            b[:, rep] = 0
            return {"a": t["a"], "b": b}
        return {k: drop(v) for k, v in t.items()}

    stack = adapters.lora["stack"]
    repeat = dict(stack["repeat"], **{f"p{pos}": drop(
        stack["repeat"][f"p{pos}"])})
    dropped = dataclasses.replace(
        adapters, lora=dict(adapters.lora, stack=dict(stack, repeat=repeat)))
    with (torch.inference_mode(), dispatch.plain_tier(),
          _pinning(cfg, [], replay=pin_k) as log):
        model.prefill(params, model.init_cache(prompt.shape[0], max_len,
                                               device=prompt.device),
                      prompt, dropped, last_only=True)
    diff, scale = (float(v) for v in log[layer])
    rel = diff / max(1.0, scale)
    print(f"pinned check's control: the plain tier's prefill with layer "
          f"{layer}'s adapter dropped differs at that block by "
          f"{rel:.3e} of max(1, max|output|) (absolute {diff:.3e}, max "
          f"|output| {scale:.3f}), {rel / PIN_RTOL:.1f}x the tolerance")
    assert rel > PIN_RTOL, ("the pinned check misses a dropped adapter",
                            rel)


def _routing_report(label, kern, plain, k):
    """Print how many top-k choices of the router differ between two logs
    of the same MoE calls (the kernel tier's, and the plain tier's own
    choices while it replays them), over how many, and the smallest
    plain-tier top-k margin (p_k - p_k+1) among the tokens whose choices
    differ.  Returns the number that differ."""
    assert len(kern) == len(plain), (len(kern), len(plain))
    n_diff, n_tok, margin, n_tie, tie_p = 0, 0, None, 0, 0.0
    for (pk, ik), (pp, ip) in zip(kern, plain):
        e = pk.shape[-1]
        per_tok = (torch.nn.functional.one_hot(ik, e).sum(1)
                   != torch.nn.functional.one_hot(ip, e).sum(1)).sum(-1) // 2
        n_diff += int(per_tok.sum())
        n_tok += ik.shape[0]
        bad = per_tok > 0
        if bool(bad.any()):
            top = torch.sort(pp[bad], dim=-1, descending=True).values
            gaps = top[:, k - 1] - top[:, k]
            m = float(gaps.min())
            margin = m if margin is None else min(margin, m)
            tied = gaps == 0
            n_tie += int(tied.sum())
            if bool(tied.any()):
                tie_p = max(tie_p, float(top[tied, k - 1].max()))
    print(f"router, {label}: {n_diff} of {n_tok * k} top-{k} choices "
          f"differ between the tiers over {len(kern)} MoE calls"
          + ("" if margin is None else
             f"; smallest plain-tier top-k margin among them {margin:.3e}")
          + ("" if not n_tie else
             f"; {n_tie} of those tokens at an exact fp32 tie of the k-th "
             f"and next probability (largest tied value {tie_p:.3e})"))
    return n_diff


def run_path(name, cfg, device, *, steps=32, plen=128, quant=None):
    """generate_banked through the user's entry points, over an fp32 base
    or (``quant`` int8 / int4, group 64) that base packed, the fp32 one
    then dropped.  ``cfg`` and ``device`` are arguments so the phase can be
    rehearsed on a CPU at a reduced size; the launch counts hold only on
    the card."""
    phase(f"path: generate_banked, {cfg.name} d_model {cfg.d_model}, "
          f"{quant or 'fp32'} base")
    t0 = time.monotonic()
    model, params, bank = serving_model(cfg, device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    if quant is not None:
        params = quantize_tree(params, quant, QUANT_GROUP)
    n_tenants = bank.size
    ids = torch.arange(n_tenants, device=device, dtype=torch.int32)
    prompt = torch.randint(0, cfg.vocab_size, (n_tenants, plen),
                           generator=torch.Generator(device).manual_seed(1),
                           device=device)
    max_len = plen + steps
    _sync(device)
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
    n_adapted = _n_adapted(bank)
    n_rglru = _layer_kinds(cfg).count("rglru")
    expect = dict.fromkeys(launches, 0)
    if quant is None:
        expect.update(bgmv_matmul=n_adapted,
                      bgmv_gemv=n_adapted * (steps - 1), rglru_scan=n_rglru)
        per = (f"{n_adapted} of #2 and {n_rglru} of #15 per prefill, "
               f"{n_adapted} of #1 per decode step")
    else:
        n_un = _proj_counts(cfg)[1]
        expect.update(bgmv_matmul_quant=n_adapted,
                      bgmv_gemv_quant=n_adapted * (steps - 1),
                      quant_matmul=n_un * steps, rglru_scan=n_rglru)
        per = (f"{n_adapted} of #3 and {n_rglru} of #15 per prefill, "
               f"{n_adapted} of #4 per decode step, {n_un} of #11 in "
               "each")
    print(f"launches: { {k: v for k, v in launches.items() if v} } "
          f"(expected { {k: v for k, v in expect.items() if v} }: "
          f"{per}); dispatch {dispatch.stats}")
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

    with _routing([]) as log_k, _pinning(cfg, []) as pin_k:
        kern_logits = forced(False)
    with (_routing([], replay=log_k) as log_p,
          _pinning(cfg, [], replay=pin_k) as pin_p):
        plain_logits = forced(True)
    if cfg.moe is not None:
        _routing_report("teacher-forced prefill and decode", log_k, log_p,
                        cfg.moe.top_k)
    if pin_k:
        _pin_report("teacher-forced prefill and decode", pin_p)
        _pin_control(model, params, bank.gather(ids), prompt, max_len, pin_k)
        _amplification(model, params, bank, ids, prompt, kern_logits,
                       forced(True))
    del log_k, log_p, pin_k, pin_p
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
    print(f"path on {name} ({quant or 'fp32'} base): "
          f"{t32 * 1e3 / steps:.2f} ms/token over a "
          f"{steps}-token generation (batch {n_tenants}, prompt {plen}); "
          f"prefill + first token {t1 * 1e3:.1f} ms; decode "
          f"{decode_ms:.2f} ms/step")
    if device.type == "cuda":
        where_time_goes(model, params, bank.gather(ids), prompt, seq)
    return launches


def _amplification(model, params, bank, ids, prompt, kern_logits, free):
    """What pinning sets aside, printed for the record: the plain tier run
    free (``free``, its teacher-forced logits) against the kernel tier's,
    and the plain tier's prefill against itself with the embedding scaled
    by 1 + 1e-7 (one fp32 rounding step of a value near 1)."""
    cfg = model.cfg
    dev = prompt.device
    out = []
    with torch.inference_mode(), dispatch.plain_tier():
        for scale in (1.0, 1.0 + 1e-7):
            p = dict(params, embed=params["embed"] * scale)
            cache = model.init_cache(prompt.shape[0], prompt.shape[1],
                                     device=dev)
            lg, _ = model.prefill(p, cache, prompt, bank.gather(ids))
            out.append(lg[..., :cfg.vocab_size])
    print(f"unpinned, for the record: plain tier vs kernel tier, teacher-"
          f"forced logits max |diff| "
          f"{float((free - kern_logits).abs().max()):.3e}; plain tier vs "
          f"itself with the embedding x (1 + 1e-7), prefill logits max "
          f"|diff| {float((out[1] - out[0]).abs().max()):.3e} (max |logit| "
          f"{float(out[0].abs().max()):.3f})")


_DeviceEvent = collections.namedtuple("_DeviceEvent", "name time_range")


def _profiled(fn, check_reader=False):
    """(host wall seconds, device events) of ``fn()`` under torch.profiler.
    The events are read from the profiler's raw trace as (name,
    time_range) records, in us: building its FunctionEvents takes minutes
    for the 219 k kernels of an xLSTM local step.  ``check_reader``: also
    build them, and check that both readers give the same device events
    and busy time."""
    from torch.autograd.profiler_util import Interval
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    raw = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    base = min((e.start_ns() for e in raw), default=0)
    events = [_DeviceEvent(e.name(), Interval((e.start_ns() - base) / 1e3,
                                              (e.end_ns() - base) / 1e3))
              for e in raw]
    if check_reader:
        old = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy, busy_old = _busy_us(events), _busy_us(old)
        print(f"profiler readers: raw trace {len(events)} device events, "
              f"{busy:.3f} us busy; FunctionEvents {len(old)}, "
              f"{busy_old:.3f} us")
        assert len(old) == len(events), (len(old), len(events))
        assert abs(busy - busy_old) <= 1e-6 * busy_old, (busy, busy_old)
    return wall, events


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
            # the decode window (a few thousand kernels) also checks the
            # raw-trace reader against torch's FunctionEvents
            _print_profile(label, *_profiled(fn, check_reader=per > 1), per,
                           "prefill" if per == 1 else "step")


def _busy_us(events):
    """Device busy us of ``events``: the union of their intervals.  Kernels
    overlap where one is a programmatic dependent of the one before (#1 /
    #4's pass starts while their GEMV runs and waits for it), so a plain
    sum of durations would count that overlap twice."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in events):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy


def _print_profile(label, wall, events, per, unit):
    """Host wall vs device busy time per ``unit`` (``per`` units in the
    profiled window) and the kernels that take the device time (each
    kernel's own duration; #1 / #4's pass counts from its early launch)."""
    if not events:
        print(f"{label}: device time not measured (the profiler recorded no "
              "CUDA events)")
        return None
    wall_ms = wall * 1e3 / per
    busy_ms = _busy_us(events) / 1e3 / per
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
    # the rank-fused forward tile's three kernels (pre-pass, main tile,
    # fixed-order sums) make up #2, #3, #5, #6, #9-#12 (#11 at m > 8 rows); the
    # main tiles with a by-row packed stager (RowsInt8 / RowsInt4) are #10's
    # and #12's, those with a by-column one and no rank term #11's; the
    # decode GEMV without the rank term (NoRank) is #11's decode form, with
    # it (BankRank) and its fixed-order pass #1 and #4; #7 and #8 are the
    # cluster-reduced gradient kernel; #13 is its split kernel and merge
    groups = (("rank-fused forward tile (#2, #3, #5, #6, #9-#12: pre-pass, "
               "main tile and sums)",
               lambda name: "fwd_kernel<" in name or "fwd_sum_kernel" in name),
              ("of which #10's and #12's main tiles (RowsInt8 / RowsInt4)",
               lambda name: "fwd_kernel<" in name and "RowsInt" in name),
              ("of which #11's main tile (ColsInt8 / ColsInt4, no rank term)",
               lambda name: ("fwd_kernel<" in name and "ColsInt" in name
                             and "NoStage" in name)),
              ("#11's decode form (decode GEMV, NoRank)",
               lambda name: "gemv_kernel<" in name and "NoRank" in name),
              ("#1 and #4 (decode GEMV, BankRank, and its fixed-order pass)",
               lambda name: (("gemv_kernel<" in name and "BankRank" in name)
                             or "bgmv_pass_kernel" in name)),
              ("#7 and #8 (the cluster-reduced gradient kernel)",
               lambda name: "lora_grad_kernel<" in name),
              ("paged attention #13 (split kernel and merge)",
               lambda name: "paged_" in name),
              ("the RG-LRU scan #15",
               lambda name: "rglru_scan_kernel<" in name),
              ("#15's backward",
               lambda name: "rglru_scan_bwd_kernel<" in name))
    for label_, match in groups:
        fam = [e for e in events if match(e.name)]
        if fam:
            print(f"    {_busy_us(fam) / 1e3 / per:8.3f} ms  "
                  f"x{len(fam) / per:5.1f}  {label_}")
    return busy_ms


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


LORA_CASES = [("q", 512, 2048, 2048, 64, 64), ("v", 512, 2048, 256, 64, 64),
              ("bench-4l", 256, 128, 128, 512, 512),
              ("ragged", 50, 70, 30, 3, 3), ("ragged r=1", 33, 65, 17, 1, 1)]


def check_lora_kernels(cases=LORA_CASES):
    """#5-#8 at each (label, m, k, n, r, active) of ``cases``, fp32 and
    bf16; ranks past ``active`` zero in A and B (a client padded to r)."""
    phase("LoRA matmul kernels #5-#8 vs plain (tolerance: |kernel - plain| "
          f"<= {KERNEL_RTOL} * max(1, max|plain|)); #7 and #8 also twice, "
          "bit for bit")
    gen = torch.Generator("cuda").manual_seed(3)
    worst = {k: 0.0 for k in LORA_KERNELS}
    for label, m, k, n, r, active in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, a, b, g = _lora_operands(gen, m, k, n, r, dtype)
            a[active:] = 0
            b[:, active:] = 0
            calls = _lora_calls(x, w, a, b, g, 1.5)
            for kern, (kfn, pfn) in calls.items():
                got, want = kfn(), pfn()
                if kern in ("lora_bwd_da", "lora_bwd_db"):
                    again = kfn()
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        raise AssertionError(
                            f"{kern} {label} {dtype}: two calls differ")
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
                      f"(active {active}) {str(dtype)[6:]:8s} max_abs_err "
                      "over outputs "
                      f"{max(float((gt - wt).abs().max()) for gt, wt in zip(got, want)):.3e}")
    print(f"launches in this phase (not the path's): {lora_matmul.launches}")
    return worst


def _bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_lora_kernels(k=2048, projs=(("q", 2048), ("v", 256))):
    """Times at the training path's shapes (fp32, m = 4 x 128 = 512 rows,
    k = 2048, r = 64, gamma 1 as on the path; or ``k`` and the (label, n)
    of ``projs``): #5 and #6 with W rotated over copies that together
    exceed L2 three times (a local step reads each layer's W once per
    pass); #7 and #8 on warm inputs (x, g and the residuals were just
    written by the pass before them)."""
    phase(f"LoRA matmul kernel times (fp32, m=512, k={k}, r=64)")
    gen = torch.Generator("cuda").manual_seed(4)
    lm = lora_matmul
    rows = {}
    m, r = 512, 64
    for proj, n in projs:
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
            note = (" " + _fwd_plan_note(m, n, k, r)
                    if kern == "lora_fwd" else
                    " " + _dx_rank_plan_note(m, k, n, r)
                    if kern == "lora_bwd_dx" else
                    " " + _reduce_plan_note(m, r, k)
                    if kern == "lora_bwd_da" else
                    " " + _reduce_plan_note(m, n, r))
            print(f"{kern:12s} {proj} m={m} k={k} n={n} r={r}: kernel "
                  f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
                  f"torch.matmul {library_ms * 1e3:.2f} us, bound "
                  f"{bound_ms * 1e3:.2f} us ({bound_by}; {nbytes / 1e6:.2f} "
                  f"MB, {flops / 1e9:.3f} GFLOP; "
                  f"{flops / ms / 1e9:.2f} TFLOP/s), eager call with host "
                  f"overhead {eager_ms * 1e3:.2f} us{note}")
        del ws
    return rows


# ------------------------------------------------------- 6. training path

def train_path(name, cfg, device, *, quant=None, clients=4, rank=64,
               local_steps=2, batch=4, seq=128, rounds=3, params=None,
               track_stability=False, b0=None, opt="sgd", lr=5e-3,
               partition="iid"):
    """FederatedTrainer through the user's entry points (as
    ``repro_torch.launch.train`` builds it), over an fp32 base or (``quant``
    int8 / int4, group 64) one packed by ``quantize_tree`` (or ``params``
    packed already, so that a caller can drop the fp32 base).  ``cfg`` and
    ``device`` are arguments so the phase can be rehearsed on a CPU at a
    reduced size; the launch counts hold only on the card.  Over a packed
    base it also checks save / resume: a trainer restored from a checkpoint
    written after round ``rounds - 1`` repeats the last round bit for bit.
    ``params``: the fp32 base (default: drawn from seed 0, as
    :func:`train_base` draws it).  ``track_stability``: the trainers
    record update_norm (phase 21 compares against it).  ``b0``: every
    trainer starts from B drawn at that std (seed 1) instead of init_lora's
    zero B, so that the first step's rank terms of #5-#7 are not zero, and
    gamma (xA^T)B^T reaches the loss.  ``opt``, ``lr`` and ``partition``:
    the optimizer and the clients' data split (sgd over iid data, or the
    accuracy table's encoder setting, adamw at 3e-3 over a Dirichlet(0.5)
    partition).  Returns the launch
    counts, the second run's ms/round, and that run's history, adapters,
    optimizer state and (``track_stability``) ``stability_report()``."""
    base_name = quant or "fp32"
    phase(f"training path: FederatedTrainer, {cfg.name} d_model "
          f"{cfg.d_model}, {base_name} base, fp32 activations, N={clients}, "
          f"fedsa + sfedlora, rank {rank}, {opt} over {partition} data")
    model = build_model(cfg)
    t0 = time.monotonic()
    if params is None:
        params = train_base(model, device)
    if quant is not None:
        params = apply_quant_flag(params, quant, QUANT_GROUP)
    lcfg = LoRAConfig(rank=rank, alpha=8.0, scaling="sfedlora",
                      targets=cfg.lora_targets)
    fcfg = FederatedConfig(num_clients=clients, local_steps=local_steps,
                           rounds=rounds, aggregation="fedsa",
                           partition=partition)
    ocfg = OptimizerConfig(name=opt, lr=lr)
    ckpt = ROOT / "build" / f"chip_smoke_{base_name}.npz"

    def trainer():
        ds = FederatedDataset(cfg.vocab_size, clients, seq_len=seq,
                              batch_per_client=batch, partition=partition,
                              seed=0)
        tr = federated.FederatedTrainer(
            model, ds, lora_cfg=lcfg, fed_cfg=fcfg, opt_cfg=ocfg, seed=0,
            base_params=params, device=device,
            track_stability=track_stability)
        if b0 is not None:
            tr.lora = _nonzero_b(tr.lora,
                                 torch.Generator(device).manual_seed(1), b0)
        return tr

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
          f"steps x batch {batch} x seq {seq} per round, {rounds} rounds"
          + ("" if b0 is None else f"; B drawn at std {b0} at the start"))
    if quant is not None:
        fq = quant_footprint(params)
        print(f"base GEMM weights: {fq['base_bytes'] / 1e9:.4f} GB {quant} "
              f"({fq['base_fp_bytes'] / 1e9:.4f} GB fp32); whole tree "
              f"{fq['total_bytes'] / 1e9:.4f} GB")

    # the counted run: counts to 0 just before, read just after
    tr1 = trainer()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _reset_launches()
    dispatch.reset_stats()
    with _routing([]) as log_k, _pinning(cfg, []) as pin_k:
        ms1 = run(tr1)
    ppl = tr1.eval_perplexity()
    _sync(device)
    launches = _launch_counts()
    n_adapted, n_base, n_no_grad = _proj_counts(cfg)
    r_ad, r_base, r_scan = _recompute_counts(cfg)
    n_rglru = _layer_kinds(cfg).count("rglru")
    steps = clients * local_steps * rounds
    expect = dict.fromkeys(launches, 0)
    if quant is None:
        expect.update({k: n_adapted * steps for k in LORA_KERNELS})
        expect["lora_fwd"] += r_ad * steps               # the recompute
        expect["lora_fwd"] += n_adapted                  # one eval forward
        per_step = (f"{n_adapted} of each of #5-#8 and {r_ad} more of #5 "
                    "in the recompute")
    else:
        # the unadapted projections; those of layer 0 that read the
        # embedding have an input without grad, so no #12
        expect.update({k: n_adapted * steps for k in QTRAIN_PATH_KERNELS})
        expect["quant_matmul"] = (n_base + r_base) * steps
        expect["quant_matmul_dx"] = (n_base - n_no_grad) * steps
        expect["lora_fwd_quant"] += r_ad * steps         # the recompute
        expect["lora_fwd_quant"] += n_adapted            # one eval forward
        expect["quant_matmul"] += n_base
        per_step = (f"{n_adapted} of each of #9, #10, #7, #8, {n_base} of "
                    f"#11 and {n_base - n_no_grad} of #12, and {r_ad} of #9 "
                    f"and {r_base} of #11 in the recompute")
    if n_rglru:
        expect["rglru_scan"] = (n_rglru + r_scan) * steps + n_rglru
        expect["rglru_scan_bwd"] = n_rglru * steps
        per_step += (f", {n_rglru} of #15 (+{r_scan} in the recompute) and "
                     f"{n_rglru} of its backward")
    print(f"launches: { {k: v for k, v in launches.items() if v} } "
          f"(expected { {k: v for k, v in expect.items() if v} }: "
          f"{per_step} per client local step x {steps}, plus the eval "
          f"forward); dispatch {dispatch.stats}")
    assert launches == expect, (launches, expect)
    if device.type == "cuda":
        print(f"peak device memory over the counted run: "
              f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB "
              f"(torch.cuda.max_memory_allocated)")
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
    with (dispatch.plain_tier(), _routing([], replay=log_k) as log_p,
          _pinning(cfg, [], replay=pin_k) as pin_p):
        tr3 = trainer()
        run(tr3)
    assert not any(_launch_counts().values()), _launch_counts()
    if cfg.moe is not None:
        _routing_report(f"{rounds} training rounds", log_k, log_p,
                        cfg.moe.top_k)
    _pin_report(f"{rounds} training rounds (forward)", pin_p)
    del log_k, log_p, pin_k, pin_p
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
    # the trainer itself stays here: it holds the base, which a caller
    # that drops its own reference expects freed
    return launches, ms2, {"history": tr2.history, "lora": tr2.lora,
                           "opt": tr2.opt_state,
                           "report": (tr2.stability_report()
                                      if track_stability else None)}


def train_base(model, device):
    """The training paths' fp32 base: seeded random weights (seed 0)."""
    return model.init(torch.Generator(device).manual_seed(0), device)


def profile_local_step(model, tr, batches=None):
    """torch.profiler over one client local step (forward, backward through
    the LoRA matmul kernels, optimizer update) after a warm-up step, on
    ``batches`` (one client's (1, ...) token tensor or batch dict; default:
    the dataset's next)."""
    phase("where the time goes (torch.profiler; one client local step)")
    local = federated._make_client_local(model, get_strategy("fedsa"),
                                         tr.opt_cfg)
    lora = federated._client(tr.lora, 0)
    opt = federated._client(tr.opt_state, 0)
    if batches is None:
        batches = torch.as_tensor(tr.dataset.round_batch(1)[0],
                                  device=tr.device)

    def step():
        local(tr.base, lora, opt, batches, 0, tr.gamma)

    step()
    _print_profile("local step", *_profiled(step), 1, "step")
    if model.cfg.moe is not None:
        _moe_share(step, moe.padded_experts(model.cfg.moe))


# the hand-written kernels' device functions (csrc/*.cu)
HAND_WRITTEN = ("fwd_kernel<", "fwd_sum_kernel", "gemv_kernel<",
                "bgmv_pass_kernel", "lora_grad_kernel<", "paged_split_kernel",
                "paged_merge_kernel", "rglru_scan", "flash_kernel")


def _moe_share(fn, ep):
    """One profiled call of ``fn``: the device time of the expert products
    (``aten::bmm`` over the ``ep`` padded experts, forward and backward)
    and of the hand-written kernels, each beside the device busy time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us(dev) / 1e3
    bmm_us = 0.0
    for e in events:
        if (e.name == "aten::bmm" and e.input_shapes
                and e.input_shapes[0] and e.input_shapes[0][0] == ep):
            bmm_us += e.device_time_total
    hand = _busy_us([e for e in dev
                     if any(h in e.name for h in HAND_WRITTEN)]) / 1e3
    if not busy:
        print("MoE share: device time not measured (no CUDA events)")
        return
    print(f"MoE local step: device busy {busy:.2f} ms; expert bmm "
          f"(aten::bmm over {ep} experts, forward and backward) "
          f"{bmm_us / 1e3:.2f} ms ({bmm_us / 1e3 / busy:.3f}); hand-written "
          f"kernels {hand:.2f} ms ({hand / busy:.3f})")



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


def _paged_shapes(block_size, ring):
    """#13's timed shapes, (label, h, table columns, window) with B 4, kh
    1, hd 256: (a) the gemma-2b scheduled path, (b) the hybrid's attention
    layers (16 query heads, window 2048) on the same ring, (c) a long
    context (the hybrid's window of 2048 positions, 128 columns)."""
    mb = -(-ring // block_size)
    return (("path", 8, mb, None), ("hybrid", 16, mb, 2048),
            ("long", 16, -(-2048 // block_size), 2048))


def _paged_check_cases(block_size, ring):
    """(label, _paged_case shape, [(window, softcap), ...]) of #13's
    checks: the three timed shapes, and a ragged case with an idle slot."""
    cases = []
    for name, h, mb, window in _paged_shapes(block_size, ring):
        variants = ([(None, None), (64, None), (None, 50.0), (64, 50.0)]
                    if name == "path" else [(window, None)])
        cases.append((f"{name} B4 h{h} kh1 hd256 bs{block_size} mb{mb}",
                      (4, h, 1, 256, block_size, mb, 0), variants))
    cases.append(("B3 h6 kh2 hd80 bs5 mb3 idle1", (3, 6, 2, 80, 5, 3, 1),
                  [(None, None), (64, None), (None, 50.0), (64, 50.0)]))
    return cases


def check_sched_kernels(block_size, ring, dev="cuda"):
    """fp32 and bf16 builds of each kernel: #13 over fp32 and bf16 pools at
    the gemma-2b path, the hybrid's and a long context (_paged_shapes), and
    a ragged case; #3, #4 and #11 with fp32 and bf16 activations over bases
    packed from fp32 weights (check_qtrain_kernels takes bf16-packed ones),
    #11 at m = 1, 4, 8 (its packed GEMV), 9 and 512 (its forward tile) and
    at two ragged shapes (k 70 and 99, n 50 and 51: odd n takes the
    GEMV's byte loads and the tile's scalar path)."""
    phase("paged-attention #13 and quantized BGMV / GEMM #3, #4, #11 vs "
          f"plain (tolerance: |kernel - plain| <= {KERNEL_RTOL} * max(1, "
          f"max|plain|), + {BF16_STEP} * |plain| for a bf16 output)")
    gen = torch.Generator(dev).manual_seed(5)
    worst = {k: 0.0 for k in SCHED_KERNELS}
    pa = paged_attention
    for label, shape, variants in _paged_check_cases(block_size, ring):
        q, kp, vp, *rest = _paged_case(gen, *shape, dev=dev)
        for dt, (window, softcap) in itertools.product(
                (torch.float32, torch.bfloat16), variants):
            args = [t.to(dt) for t in (q, kp, vp)] + rest
            got = pa.paged_attention(*args, window=window, softcap=softcap)
            want = pa.paged_attention_plain(*args, window=window,
                                            softcap=softcap)
            worst["paged_attention"] = max(worst["paged_attention"], _err(
                "paged_attention",
                f"{label} {str(dt)[6:]} w={window} c={softcap}", got, want))
    for mode, bits in (("int8", 8), ("int4", 4)):
        for proj, (k, n) in list(PROJ.items()) + [("ragged", (70, 50)),
                                                  ("odd n", (99, 51))]:
            w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
            wq = quantize(w, bits, QUANT_GROUP)
            del w
            # #11's packed GEMV (m <= 8) and forward tile (m > 8)
            for m, dt in itertools.product(
                    (1, 4, 8, 9, 512) if proj in PROJ else (1, 5, 8, 9, 13),
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


def _time_paged(gen, h, mb, window, block_size, dev, kh=1, hd=256):
    """#13 at B 4, h query heads on kh kv heads of hd, mb table columns of
    block_size positions (_paged_case's fills), fp32 pools, warm (one
    layer's pools; 18 layers of the gemma-2b path's fit in L2), beside its
    plain version, SDPA on the gathered view and the bound."""
    q, kp, vp, pos_pool, table, qpos = _paged_case(gen, 4, h, kh, hd,
                                                   block_size, mb, dev=dev)
    pa = paged_attention
    args = [(q, kp, vp, pos_pool, table, qpos)] * 8
    ms = _graph_ms(lambda *a: pa.paged_attention(*a, window=window), args)
    plain_ms = _graph_ms(
        lambda *a: pa.paged_attention_plain(*a, window=window), args)
    # the library call: SDPA over the already-gathered view, GQA expanded
    kg, vg, pg = (t.reshape(4, mb * block_size, *t.shape[3:])
                  for t in (kp[table.long()], vp[table.long()],
                            pos_pool[table.long()]))
    kh_ = kg.permute(0, 2, 1, 3).repeat_interleave(h // kh, dim=1)
    vh_ = vg.permute(0, 2, 1, 3).repeat_interleave(h // kh, dim=1)
    ok = (pg >= 0) & (pg <= qpos[:, None])
    if window:
        ok &= qpos[:, None] - pg < window
    mask = ok[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = _graph_ms(lambda q_, k_, v_, m_: sdpa(q_, k_, v_,
                                                       attn_mask=m_),
                           [(q[:, :, None], kh_, vh_, mask)] * 8)
    eager_ms = _eager_ms(lambda *a: pa.paged_attention(*a, window=window),
                         args)
    # the work this run's fill needs: pos of every table position; K and V
    # rows of the kh heads and q.k, p.v for the h query heads at the
    # attendable ones only
    n_pos, n_valid = pg.numel(), int(mask.sum())
    nbytes = (q.nbytes * 2 + n_pos * 4 + n_valid * 2 * kh * hd * 4
              + table.nbytes + qpos.nbytes)
    flops = 2 * 2 * h * hd * n_valid
    bound_ms, bound_by = _bound(nbytes, flops)
    print(f"paged_attention B=4 h={h} kh={kh} hd={hd} bs={block_size} mb={mb} "
          f"window={window}: kernel {ms * 1e3:.2f} us, plain (gather + "
          f"softmax) {plain_ms * 1e3:.2f} us, SDPA on the gathered view "
          f"{library_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
          f"({bound_by}; {nbytes / 1e6:.3f} MB, {n_valid} of {n_pos} "
          f"positions attendable), eager call with host overhead "
          f"{eager_ms * 1e3:.2f} us {_paged_plan_note(4, kh, mb)}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, eager_ms=eager_ms)


def time_sched_kernels(block_size, ring, dev="cuda", projs=PROJ,
                       paged=None, adapted=("q", "v"), rows_m=(4, 512)):
    """Times at the scheduled path's shapes (fp32 activations, B = 4, rank
    8, int8 and int4 group 64): #3, #4 and #11 with the packed W rotated
    over copies that together exceed L2 three times (a step reads each
    layer's W once), at ``projs``' (k, n) and ``rows_m`` rows (#3 and #4
    at ``adapted`` only, at m = 4 and 512); #13 at ``paged``'s (label, h,
    mb, window, kh, hd), by default _paged_shapes (_time_paged)."""
    phase("paged / quantized kernel times (fp32 activations, B=4, r=8)")
    gen = torch.Generator(dev).manual_seed(6)
    rows = {}
    if paged is None:
        paged = [shape + (1, 256) for shape in _paged_shapes(block_size,
                                                             ring)]
    for name, h, mb, window, kh, hd in paged:
        rows[("paged_attention", name)] = _time_paged(
            gen, h, mb, window, block_size, dev, kh, hd)
    for mode, bits in (("int8", 8), ("int4", 4)):
        for proj, (k, n) in projs.items():
            w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
            wq = quantize(w, bits, QUANT_GROUP)
            wf = wq.dequantize()
            del w
            copies = max(2, math.ceil(3 * L2_BYTES / wq.nbytes))
            wqs = [quantize(wf, bits, QUANT_GROUP) for _ in range(copies)]
            wfs = [wf.clone() for _ in range(max(2, math.ceil(
                3 * L2_BYTES / wf.nbytes)))]
            for m in rows_m:
                x = torch.randn(m, k, generator=gen, device=dev)
                specs = [("quant_matmul", lora_matmul.quant_matmul,
                          lora_matmul.quant_matmul_plain,
                          [(x, wi) for wi in wqs], 0, 2 * m * k * n)]
                if proj in adapted and m in (4, 512):
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
                    note = " " + (
                        _fwd_plan_note(m, n, k, 8, bits, QUANT_GROUP)
                        if name == "bgmv_matmul_quant" else
                        _qmm_plan_note(m, k, n, bits, QUANT_GROUP)
                        if name == "quant_matmul" else
                        _gemv_plan_note(m, k, n, 1))
                    print(f"{name:17s} {mode} {proj:6s} m={m:<4d} k={k} "
                          f"n={n}: kernel {ms * 1e3:.2f} us, plain "
                          f"{plain_ms * 1e3:.2f} us, torch.matmul on the fp32 "
                          f"W {library_ms * 1e3:.2f} us, bound "
                          f"{bound_ms * 1e3:.2f} us ({bound_by}; "
                          f"{nbytes / 1e6:.2f} MB packed, "
                          f"{flops / 1e9:.3f} GFLOP), eager "
                          f"{eager_ms * 1e3:.2f} us{note}")
            del wqs, wfs
    return rows


# ------------------------------------------- 9. scheduled serving path

SCHED = dict(n_req=8, plen=128, steps=32, deadline=12, max_batch=4,
             block_size=16, chunk=8)


KERNEL_MODULES = (bgmv, lora_matmul, paged_attention, rglru_scan,
                  flash_attention)


def _launch_counts():
    out = {}
    for mod in KERNEL_MODULES:
        out.update(mod.launches)
    return out


def _reset_launches():
    for mod in KERNEL_MODULES:
        mod.reset_launches()


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
        cache = model.init_paged_cache(1 + b * mb, bs, b, device=dev)
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


def sched_path(name, model, params, bank, mode, profile=True):
    """serve_scheduled through the user's entry points, over an fp32 base
    or one packed by ``quantize_tree`` (``mode`` int8 / int4, group 64;
    ``params`` may come packed already, so that a caller can drop the fp32
    base).
    Traffic: 8 requests of 128-token prompts and 32 greedy tokens, 4
    tenants, the last with deadline_steps 12; max_batch 4, block 16, chunk
    8, wait=False: two waves that recycle slots and blocks.  ``profile``:
    profile one wave's prefill and 8 decode steps."""
    cfg, device = model.cfg, tree_leaves(params)[0].device
    sc = SCHED
    phase(f"scheduled path: serve_scheduled, {cfg.name} d_model "
          f"{cfg.d_model}, {mode} base, {sc['n_req']} requests x "
          f"{sc['plen']}-token prompts x {sc['steps']} tokens")
    base = params if mode == "fp32" else apply_quant_flag(params, mode,
                                                          QUANT_GROUP)
    fq = quant_footprint(base)
    ratio = (f" ({fq['base_fp_bytes'] / fq['base_bytes']:.2f}x)"
             if fq["base_bytes"] else " (no eligible GEMM weight)")
    print(f"base GEMM weights: {fq['base_bytes'] / 1e9:.4f} GB {mode}, "
          f"{fq['base_fp_bytes'] / 1e9:.4f} GB fp32{ratio}; whole tree "
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
    with _routing([]) as log_k, _pinning(cfg, []) as pin_k:
        done = run()
    _sync(device)
    launches = _launch_counts()
    del model.prefill, model.decode_step
    kinds = _layer_kinds(cfg)
    n_ad = _n_adapted(bank)
    n_un = _proj_counts(cfg)[1]
    groups, steps = calls["prefill"], calls["decode_step"]
    chunks_per_wave = -(-(sc["steps"] - 1) // sc["chunk"])
    assert groups == 2 and steps == 2 * chunks_per_wave * sc["chunk"], \
        (groups, steps)
    expect = {k: 0 for k in launches}
    expect["paged_attention"] = sum(map(kinds.count, ATTN_KINDS)) * steps
    expect["rglru_scan"] = kinds.count("rglru") * groups
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
    # (a dense or xLSTM model: an MoE router's capacity couples the
    # requests of a decode batch, and a deadline's idle slot changes that
    # batch, so the MoE archs hold the scheduled tokens against the plain
    # tier's instead, the plain tier dispatching to the kernel tier's
    # experts; a pinned family holds them against a second plain-tier run
    # pinned to the kernel tier's blocks)
    _reset_launches()
    with dispatch.plain_tier():
        with _routing([], replay=log_k) as log_p:
            plain = run()
        if pin_k:
            # the kernel tier's tokens against the pinned plain tier's
            with _pinning(cfg, [], replay=pin_k) as pin_p:
                pinned = run()
        if cfg.moe is None:
            waves = [serve.generate_banked(
                model, base, bank, ids[w:w + 4],
                torch.as_tensor(prompts[w:w + 4], device=device),
                sc["steps"], sc["plen"] + sc["steps"])[:, sc["plen"]:]
                .cpu().numpy() for w in (0, 4)]
    _sync(device)
    assert not any(_launch_counts().values()), _launch_counts()
    if cfg.moe is None:
        fixed = np.concatenate(waves)
        for r in plain:
            assert r.tokens == fixed[r.rid, :len(r.tokens)].tolist(), \
                f"plain tier: request {r.rid} differs from generate_banked"
        print("plain tier: each wave's tokens equal generate_banked on that "
              f"wave bit for bit (the deadline request: its first "
              f"{sc['deadline']} tokens)")
    if cfg.moe is not None or pin_k:
        if cfg.moe is not None:
            _routing_report("scheduled run", log_k, log_p, cfg.moe.top_k)
        else:
            _pin_report("scheduled run", pin_p)
            plain = pinned
        # the teacher-forced waves below take the kernel tier's scheduled
        # tokens (the deadline's cut request padded with token 0)
        fixed = np.zeros((sc["n_req"], sc["steps"]), np.int64)
        for r in done:
            fixed[r.rid, :len(r.tokens)] = r.tokens
        parted = [(k.rid, next(t for t, (a, b) in enumerate(
            zip(k.tokens, p.tokens)) if a != b))
            for k, p in zip(done, plain) if k.tokens != p.tokens]
        print("kernel vs plain tier, scheduled tokens: "
              f"{len(plain) - len(parted)} of {len(plain)} requests equal"
              + "".join(f"; request {rid} parts at token {t}"
                        for rid, t in parted))
        assert not parted, parted
    del log_k, log_p, pin_k

    # kernel tier vs plain tier: teacher-forced logits on the plain tokens
    worst, ties = 0.0, []
    for w in (0, 4):
        p_t = torch.as_tensor(prompts[w:w + 4], device=device)
        toks = torch.as_tensor(fixed[w:w + 4], device=device)
        with _routing([]) as log_k, _pinning(cfg, []) as pin_k:
            lk = _forced_paged(model, base, bank, ids[w:w + 4], p_t, toks,
                               False)
        with (_routing([], replay=log_k) as log_p,
              _pinning(cfg, [], replay=pin_k) as pin_p):
            lp = _forced_paged(model, base, bank, ids[w:w + 4], p_t, toks,
                               True)
        worst = max(worst, float((lk - lp).abs().max()))
        if cfg.moe is not None or pin_k:
            if cfg.moe is not None:
                _routing_report(f"teacher-forced wave {w // 4 + 1}", log_k,
                                log_p, cfg.moe.top_k)
            _pin_report(f"teacher-forced wave {w // 4 + 1}", pin_p)
            del lk, lp, log_k, log_p, pin_k, pin_p
            continue
        del log_k, log_p, pin_k, pin_p
        assert torch.equal(lp.argmax(-1).cpu(), toks.cpu()), \
            "teacher-forced plain tier does not reproduce its tokens"
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
    if device.type == "cuda" and profile:
        # where the time goes: one wave's prefill and 8 decode steps
        p_t = torch.as_tensor(prompts[:4], device=device)
        toks = torch.as_tensor(fixed[:4, :9], device=device)
        busy = _print_profile(
            f"scheduled path ({mode}; teacher-forced prefill + 8 decode "
            "steps)", *_profiled(lambda: _forced_paged(
                model, base, bank, ids[:4], p_t, toks, False)),
            1, "prefill + 8 steps")
        # the same prefill alone: the rest is the 8 decode steps
        _, events = _profiled(lambda: _forced_paged(
            model, base, bank, ids[:4], p_t, toks[:, :1], False))
        pre = _busy_us(events) / 1e3
        if busy is not None and events:
            print(f"scheduled decode ({mode}): device busy "
                  f"{(busy - pre) / 8:.2f} ms a step (prefill + 8 steps "
                  f"{busy:.2f} ms, prefill alone {pre:.2f} ms)")
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
    at the training path's m = 512 (#9 and #10 at the adapted q and v, with
    rank 64 and 8, #12 at every base projection), with fp32 and bf16
    activations, and a ragged case (m 50, k 100: an int4 W holds kq = 128
    rows; n 30, r 3).  Then a
    base packed from bf16 weights through all six packed kernels (#3, #4,
    #9, #10, #11, #12), whose loaders round each product to bf16."""
    phase("packed training kernels #9, #10, #12 vs plain (tolerance: "
          f"|kernel - plain| <= {KERNEL_RTOL} * max(1, max|plain|))")
    gen = torch.Generator(dev).manual_seed(9)
    worst = {k: 0.0 for k in QTRAIN_KERNELS}
    # (label, m, k, n, r, adapted: #9 and #10 run beside #12)
    cases = [(p, 512, k, n, 64, p in ("q", "v")) for p, (k, n) in
             PROJ.items()]
    cases += [(f"{p} r8", 512, *PROJ[p], 8, True) for p in ("q", "v")]
    cases.append(("ragged", 50, 100, 30, 3, True))
    for mode, bits in (("int8", 8), ("int4", 4)):
        for label, m, k, n, r, adapted in cases:
            wq = quantize(torch.randn(k, n, generator=gen, device=dev)
                          * k ** -0.5, bits, QUANT_GROUP)
            for dt in (torch.float32, torch.bfloat16):
                x, _, a, b, g = _lora_operands(gen, m, k, n, r, dt, dev)
                calls = _qtrain_calls(x, wq, a, b, g)
                if not adapted:
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


def time_qtrain_kernels(dev="cuda", projs=("q", "v", "k", "o", "w_up",
                                            "w_down"), proj=PROJ,
                        adapted=("q", "v")):
    """Times at the training path's shapes (fp32 activations, m = 4 x 128 =
    512, r = 64, gamma 1, int8 and int4 group 64): #9 and #10 at q and v,
    #12 at k, o, w_up and w_down, the packed W rotated over copies that
    together exceed L2 three times (a local step reads each layer's W once
    per pass), or ``projs`` of ``proj`` (#9 and #10 at ``adapted``).  The
    library call is one torch.matmul on the dequantized fp32 W: x @ W for
    #9, g @ W^T for #10 and #12."""
    phase("packed training kernel times (fp32 activations, m=512, r=64)")
    gen = torch.Generator(dev).manual_seed(10)
    lm = lora_matmul
    rows = {}
    m, r, f4 = 512, 64, 4
    for mode, bits in (("int8", 8), ("int4", 4)):
        for label in projs:
            k, n = proj[label]
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
            if label in adapted:
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
                rows[(kern, f"{mode} {label}")] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=library_ms,
                    eager_ms=eager_ms)
                note = (" " + _fwd_plan_note(m, n, k, r, bits, QUANT_GROUP)
                        if kern == "lora_fwd_quant" else
                        " " + _dx_plan_note(m, k, n)
                        if kern == "quant_matmul_dx" else
                        " " + _dx_rank_plan_note(m, k, n, r))
                print(f"{kern:17s} {mode} {label:6s} m={m} k={k} n={n} "
                      f"r={r}: kernel {ms * 1e3:.2f} us, plain "
                      f"{plain_ms * 1e3:.2f} us, torch.matmul on the fp32 W "
                      f"{library_ms * 1e3:.2f} us, bound "
                      f"{bound_ms * 1e3:.2f} us ({bound_by}; "
                      f"{nbytes / 1e6:.2f} MB packed, {flops / 1e9:.3f} "
                      f"GFLOP; {flops / ms / 1e9:.2f} TFLOP/s), eager "
                      f"{eager_ms * 1e3:.2f} us{note}")
            del wqs, wfs
    return rows


# ------------------------- 11. RG-LRU scan #15 and flash attention #14

SCAN_FLASH = ("rglru_scan", "flash_attention")
# tests/test_kernels.py:89 (#14) and :124 (#15): |kernel - plain| <= tol *
# |plain| + 5 tol
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
SCAN_TOL = {torch.float32: 1e-5, torch.bfloat16: 4e-2}
# (bt, s, d) of #15: the RG-LRU prefill of the hybrid path (batch 4, a
# 128-token prompt, rglru_d_state 4096), benchmarks/kernels_bench.py's, and
# a ragged one
SCAN_SHAPES = {"path": (4, 128, 4096), "bench": (4, 2048, 256),
               "ragged": (3, 100, 1000)}
# (b, s, t, h, kh, d, causal, window) of ops.flash_mha
FLASH_SHAPES = {
    "recurrentgemma-9b": (1, 4096, 4096, 16, 1, 256, True, 2048),
    "gemma-2b": (1, 2048, 2048, 8, 1, 256, True, None),
    "cross": (1, 512, 2048, 8, 1, 256, False, None)}


def _allclose(name, label, got, want, tol):
    """max |kernel - plain|, raising past tol * |plain| + 5 tol element by
    element (the assert_allclose of tests/test_kernels.py) and, for a bf16
    output, past BF16_STEP * |plain| + BF16_ATOL as well: the first bound's
    floor is several times a typical attention output, so alone it would
    pass zeros or an ignored window."""
    _sync(got.device)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (name, label, got.shape, want.shape, got.dtype, want.dtype)
    diff = (got.float() - want.float()).abs()
    bound = tol * want.float().abs() + 5 * tol
    note = f"tolerance {tol} * |plain| + {5 * tol:g}"
    if got.dtype == torch.bfloat16:
        bound = torch.minimum(bound, BF16_STEP * want.float().abs()
                              + BF16_ATOL)
        note += f", and {BF16_STEP} * |plain| + {BF16_ATOL:g}"
    err = float(diff.max())
    print(f"{name:16s} {label:44s} max_abs_err={err:.3e} ({note})"
          + (" bit-identical" if torch.equal(got, want) else ""))
    if not bool((diff <= bound).all()):
        raise AssertionError(f"{name} {label} disagrees with its plain "
                             f"version: max |diff| {err}")
    return err


def _scan_operands(gen, shape, dtype, dev="cuda"):
    """a in [0.5, 0.999) and b ~ N(0, 0.25), as tests/test_kernels.py."""
    a = 0.5 + 0.499 * torch.rand(shape, generator=gen, device=dev)
    b = torch.randn(shape, generator=gen, device=dev) * 0.5
    return a.to(dtype), b.to(dtype)


def _flash_operands(gen, shape, dtype, dev="cuda"):
    """Folded q (b h, s, d), k and v (b kh, t, d) of a FLASH_SHAPES row."""
    b, s, t, h, kh, d, _, _ = shape
    q = torch.randn(b * h, s, d, generator=gen, device=dev)
    k = torch.randn(b * kh, t, d, generator=gen, device=dev)
    v = torch.randn(b * kh, t, d, generator=gen, device=dev)
    return [x.to(dtype) for x in (q, k, v)]


def check_scan_flash(dev="cuda"):
    phase("RG-LRU scan #15 and flash attention #14 vs plain (fp32 and "
          "bf16)")
    gen = torch.Generator(dev).manual_seed(11)
    worst = dict.fromkeys(SCAN_FLASH, 0.0)
    for label, shape in SCAN_SHAPES.items():
        for dt in (torch.float32, torch.bfloat16):
            a, b = _scan_operands(gen, shape, dt, dev)
            worst["rglru_scan"] = max(worst["rglru_scan"], _allclose(
                "rglru_scan", f"{label} {shape} {str(dt)[6:]}",
                rglru_scan.rglru_scan(a, b),
                rglru_scan.rglru_scan_plain(a, b), SCAN_TOL[dt]))
    fa = flash_attention
    for label, shape in FLASH_SHAPES.items():
        causal, window = shape[6], shape[7]
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = _flash_operands(gen, shape, dt, dev)
            worst["flash_attention"] = max(worst["flash_attention"], _allclose(
                "flash_attention",
                f"{label} s={shape[1]} t={shape[2]} h={shape[3]} "
                f"d={shape[5]} {str(dt)[6:]}",
                fa.flash_attention(q, k, v, causal=causal, window=window),
                fa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window), FLASH_TOL[dt]))
            del q, k, v
    print(f"launches in this phase (not the path's): "
          f"{dict(rglru_scan.launches)} {dict(flash_attention.launches)}")
    return worst


def time_scan_flash():
    """fp32 times: #15 at the path's and the bench's shapes over 6 input
    copies (150 MB, three times L2, as a prefill finds them cold); #14 at
    the two attention shapes (bound by operations, so inputs stay warm)
    beside SDPA on the expanded heads (``is_causal``, or a band mask for
    the window)."""
    phase("RG-LRU scan and flash attention times (fp32)")
    gen = torch.Generator("cuda").manual_seed(12)
    rows = {}
    for label in ("path", "bench"):
        shape = SCAN_SHAPES[label]
        args = [_scan_operands(gen, shape, torch.float32) for _ in range(6)]
        ms = _graph_ms(rglru_scan.rglru_scan, args)
        plain_ms = _graph_ms(rglru_scan.rglru_scan_plain, args[:2], reps=2)
        a = args[0][0]
        nbytes = 3 * a.nbytes
        bound_ms, bound_by = _bound(nbytes, 2 * a.numel())
        rows[("rglru_scan", label)] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None)
        print(f"rglru_scan {label} {shape}: kernel {ms * 1e3:.2f} us, plain "
              f"(a loop of {shape[1]} steps) {plain_ms * 1e3:.2f} us, no "
              f"single library call, bound {bound_ms * 1e3:.2f} us "
              f"({bound_by}; {nbytes / 1e6:.2f} MB)")
        del args
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fa = flash_attention
    for label in ("recurrentgemma-9b", "gemma-2b"):
        b, s, t, h, kh, d, causal, window = FLASH_SHAPES[label]
        q, k, v = _flash_operands(gen, FLASH_SHAPES[label], torch.float32)
        args = [(q, k, v)] * 2
        kw = dict(causal=causal, window=window)
        ms = _graph_ms(lambda *x: fa.flash_attention(*x, **kw), args)
        plain_ms = _graph_ms(lambda *x: fa.flash_attention_plain(*x, **kw),
                             args[:1], reps=2)
        mask = fa.band_mask(s, t, causal=causal, window=window,
                            device=q.device)
        qh = q.reshape(b, h, s, d)
        kx = k.reshape(b, kh, t, d).repeat_interleave(h // kh, dim=1)
        vx = v.reshape(b, kh, t, d).repeat_interleave(h // kh, dim=1)
        if window is None:
            library_ms = _graph_ms(
                lambda *x: sdpa(*x, is_causal=causal), [(qh, kx, vx)] * 2)
        else:
            library_ms = _graph_ms(
                lambda *x: sdpa(*x, attn_mask=mask), [(qh, kx, vx)] * 2)
        pairs = int(mask.sum())
        flops = 4 * b * h * pairs * d
        nbytes = 2 * q.nbytes + k.nbytes + v.nbytes
        bound_ms, bound_by = _bound(nbytes, flops)
        rows[("flash_attention", label)] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms)
        print(f"flash_attention {label} b={b} s={s} t={t} h={h} kh={kh} "
              f"d={d} causal={causal} window={window}: kernel "
              f"{ms * 1e3:.2f} us, plain (whole score matrix) "
              f"{plain_ms * 1e3:.2f} us, SDPA on the expanded heads "
              f"{library_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
              f"({bound_by}; {pairs} attended pairs per head, "
              f"{flops / 1e9:.2f} GFLOP; {flops / ms / 1e9:.2f} TFLOP/s)")
        del q, k, v, qh, kx, vx, args
        _free()
    return rows


# ------------------------------------------------- 12. kernel API path

def ops_path(dev="cuda"):
    """The public kernel API through its entry points: ``flash_mha`` at
    recurrentgemma-9b's and gemma-2b's attention shapes (b, s, h, d heads;
    one kv head), ``rglru_scan_op`` at the RG-LRU prefill's shape and
    ``fused_lora_matmul`` at gemma-2b's q projection of 4 x 128 rows, fp32.
    Inputs are drawn first; the counts go to 0 just before the calls and
    are read just after, then each output is held against its plain
    version."""
    phase("kernel API path: repro_torch.kernels.ops")
    gen = torch.Generator(dev).manual_seed(13)
    inputs = {}
    for label in ("recurrentgemma-9b", "gemma-2b"):
        b, s, t, h, kh, d, causal, window = FLASH_SHAPES[label]
        inputs[label] = [torch.randn(b, n, hh, d, generator=gen, device=dev)
                         for n, hh in ((s, h), (t, kh), (t, kh))]
    a, bb = _scan_operands(gen, SCAN_SHAPES["path"], torch.float32, dev)
    x, w, la, lb, _ = _lora_operands(gen, 512, 2048, 2048, 8, torch.float32,
                                     dev)
    x = x.reshape(4, 128, 2048)
    _reset_launches()
    outs = {}
    with torch.inference_mode():
        for label, (q, k, v) in inputs.items():
            causal, window = FLASH_SHAPES[label][6:]
            outs[label] = ops.flash_mha(q, k, v, causal=causal,
                                        window=window)
        outs["scan"] = ops.rglru_scan_op(a, bb)
        outs["lora"] = ops.fused_lora_matmul(x, w, la, lb, 2.0)
    _sync(torch.device(dev))
    launches = _launch_counts()
    expect = dict.fromkeys(launches, 0)
    expect.update(flash_attention=2, rglru_scan=1, lora_fwd=1)
    print(f"launches: { {k: v for k, v in launches.items() if v} } "
          f"(expected { {k: v for k, v in expect.items() if v} })")
    assert launches == expect, (launches, expect)
    fa = flash_attention
    for label, (q, k, v) in inputs.items():
        b, s, t, h, kh, d, causal, window = FLASH_SHAPES[label]
        want = fa.flash_attention_plain(
            *(y.transpose(1, 2).reshape(-1, y.shape[1], d)
              for y in (q, k, v)), causal=causal, window=window)
        got = outs[label].transpose(1, 2).reshape(b * h, s, d)
        assert outs[label].shape == (b, s, h, d) and bool(got.isfinite().all())
        _allclose("ops.flash_mha", label, got.contiguous(), want,
                  FLASH_TOL[torch.float32])
    _allclose("ops.rglru_scan_op", str(SCAN_SHAPES["path"]), outs["scan"],
              rglru_scan.rglru_scan_plain(a, bb), SCAN_TOL[torch.float32])
    want = lora_matmul.lora_fwd_plain(x.reshape(512, 2048), w, la, lb,
                                      2.0)[0].reshape(4, 128, 2048)
    err = float((outs["lora"] - want).abs().max())
    print(f"ops.fused_lora_matmul (4, 128, 2048) x (2048, 2048), r 8: "
          f"max_abs_err={err:.3e} (tolerance {KERNEL_RTOL} * max(1, "
          f"max|plain|))")
    assert err <= KERNEL_RTOL * max(1.0, float(want.abs().max()))
    return launches


# ------------------------------------------------ 13. hybrid serving path

def hybrid_path(name):
    """recurrentgemma-9b at full width and half depth (RG_PATHS: 19 of its
    38 layers) through generate_banked and serve_scheduled (fp32 base),
    the model freed after each."""
    cfg = RG_PATHS
    fixed = run_path(name, cfg, torch.device("cuda"))
    _free()
    model, params, bank = serving_model(cfg, torch.device("cuda"))
    sched, _ = sched_path(name, model, params, bank, "fp32")
    del model, params, bank
    _free()
    return fixed, sched


# ------------------ 14. the dense configs' shapes and the llama2-7b paths

LLAMA = get_config("llama2-7b")
# The script runs in a fixed time on one card: with the MoE phases
# (22-24) at full depth, llama2-7b's and qwen3-8b's paths (phase 15) and
# the hybrid over int4 (phases 18-19) run at half depth, at full width, so
# that the whole stays inside that time on the slower hosts measured
LLAMA_PATHS = dataclasses.replace(LLAMA, num_layers=16)
NEMO = get_config("mistral-nemo-12b")
QWEN = get_config("qwen3-8b")
QWEN_PATH = dataclasses.replace(QWEN, num_layers=18)    # as LLAMA_PATHS
STABLELM = get_config("stablelm-1.6b")
# #1 / #2 (label, k, n): mistral-nemo-12b's q and v (heads x head_dim 4096
# below d_model 5120), llama2-7b's q and v (MHA: both 4096 x 4096)
DENSE_BGMV = (("nemo q", NEMO.d_model, NEMO.q_dim),
              ("nemo v", NEMO.d_model, NEMO.kv_dim),
              ("llama2-7b q/v", LLAMA.d_model, LLAMA.q_dim))
# #11 / #12 at llama2-7b's MLP: n = 11008 and k = 11008, no power of two;
# #3 / #4 (and #11) at its q / v over the int4 scheduled path's base
LLAMA_MLP = {"llama2-7b w_up": (LLAMA.d_model, LLAMA.d_ff),
             "llama2-7b w_down": (LLAMA.d_ff, LLAMA.d_model)}
LLAMA_QV = {"llama2-7b q/v": (LLAMA.d_model, LLAMA.q_dim)}
# #13 (label, query heads, kv heads, head_dim) of the dense decode steps
DENSE_PAGED = tuple((c.name, c.num_heads, c.num_kv_heads, c.head_dim)
                    for c in (LLAMA, QWEN, STABLELM))
# #5-#8 at llama2-7b's q / v (m 512, k = n = 4096): rank 64 (the training
# path), 128 (the heterogeneous paths' r_max) and a client of rank 16
# padded to 128
LLAMA_LORA_CASES = [("llama q/v", 512, LLAMA.d_model, LLAMA.q_dim, r, act)
                    for r, act in ((64, 64), (128, 128), (128, 16))]
HETERO_RANKS = (16, 32, 64, 128)
# FLoRA on the card: the kernel tier's aggregate B A against the plain
# tier's, max |diff| over max |plain| per client and layer.  The local
# steps differ in the order of their sums (TRAIN_RTOL), and the SVD of the
# stacked factors passes that on to B A at the same scale
FLORA_RTOL = 1e-3


def check_dense_kernels(dev="cuda"):
    """The kernels at the dense configs' shapes, fp32 and bf16, against
    their plain versions: #1 and #2 (rank 8, bank ids and ids=None) at
    DENSE_BGMV; #11 over int8 and int4 (group 64) at m = 1, 4, 8 (its
    decode GEMV; at w_down the last chunk of k = 11008 is short) and 512
    (its forward tile), and #12 at m = 512, at llama2-7b's w_up and w_down;
    #3 and #4 (4 requests, rank 8) at its q / v over int8 and int4; #13 at
    DENSE_PAGED (160 positions, 10 columns of 16, plus a window of 64);
    then #5-#8 at LLAMA_LORA_CASES (check_lora_kernels)."""
    phase("the dense configs' shapes vs plain (tolerance: |kernel - plain| "
          f"<= {KERNEL_RTOL} * max(1, max|plain|), + {BF16_STEP} * |plain| "
          "for a bf16 output)")
    gen = torch.Generator(dev).manual_seed(11)
    worst = {}

    def note(kern, err):
        worst[kern] = max(worst.get(kern, 0.0), err)

    for label, k, n in DENSE_BGMV:
        for dt in (torch.float32, torch.bfloat16):
            for s in (1, 128):
                x, w, a, b, ids = _bank(gen, 4, s, k, n, 4, (8,) * 4, dt)
                for id_mode in ("bank", "none"):
                    a_, b_, ids_ = (a, b, ids) if id_mode == "bank" else (
                        a.index_select(0, ids.long()).contiguous(),
                        b.index_select(0, ids.long()).contiguous(), None)
                    lab = (f"{label} k={k} n={n} s={s} {str(dt)[6:]} "
                           f"ids={id_mode}")
                    if s == 1:
                        x1 = x[:, 0].contiguous()
                        note("bgmv_gemv", _err(
                            "bgmv_gemv", lab,
                            bgmv.bgmv_gemv(x1, w, a_, b_, ids_),
                            bgmv.bgmv_gemv_plain(x1, w, a_, b_, ids_)))
                    else:
                        note("bgmv_matmul", _err(
                            "bgmv_matmul", lab,
                            bgmv.bgmv_matmul(x, w, a_, b_, ids_),
                            bgmv.bgmv_matmul_plain(x, w, a_, b_, ids_)))
    for mode, bits in (("int8", 8), ("int4", 4)):
        for label, (k, n) in LLAMA_MLP.items():
            wq = quantize(torch.randn(k, n, generator=gen, device=dev)
                          * k ** -0.5, bits, QUANT_GROUP)
            for m, dt in itertools.product((1, 4, 8, 512),
                                           (torch.float32, torch.bfloat16)):
                x = torch.randn(m, k, generator=gen, device=dev).to(dt)
                lab = f"{mode} {label} m={m} k={k} n={n} {str(dt)[6:]}"
                got = lora_matmul.quant_matmul(x, wq)
                again = lora_matmul.quant_matmul(x, wq)
                assert torch.equal(got, again), f"#11 {lab}: two calls differ"
                note("quant_matmul", _err(
                    "quant_matmul", lab, got,
                    lora_matmul.quant_matmul_plain(x, wq)))
                if m == 512:
                    g = torch.randn(m, n, generator=gen, device=dev).to(dt)
                    note("quant_matmul_dx", _err(
                        "quant_matmul_dx", lab,
                        lora_matmul.quant_matmul_dx(g, wq),
                        lora_matmul.quant_matmul_dx_plain(g, wq)))
            del wq
        for label, (k, n) in LLAMA_QV.items():
            wq = quantize(torch.randn(k, n, generator=gen, device=dev)
                          * k ** -0.5, bits, QUANT_GROUP)
            for s_, dt in itertools.product((1, 128),
                                            (torch.float32, torch.bfloat16)):
                x, _, a, b, ids = _bank(gen, 4, s_, k, n, 4, (8,) * 4, dt)
                lab = f"{mode} {label} B=4 s={s_} k={k} n={n} {str(dt)[6:]}"
                if s_ == 1:
                    x1 = x[:, 0].contiguous()
                    note("bgmv_gemv_quant", _err(
                        "bgmv_gemv_quant", lab,
                        bgmv.bgmv_gemv_quant(x1, wq, a, b, ids),
                        bgmv.bgmv_gemv_quant_plain(x1, wq, a, b, ids)))
                else:
                    note("bgmv_matmul_quant", _err(
                        "bgmv_matmul_quant", lab,
                        bgmv.bgmv_matmul_quant(x, wq, a, b, ids),
                        bgmv.bgmv_matmul_quant_plain(x, wq, a, b, ids)))
            del wq
    for label, h, kh, hd in DENSE_PAGED:
        q, kp, vp, *rest = _paged_case(gen, 4, h, kh, hd, 16, 10, dev=dev)
        for dt, window in itertools.product((torch.float32, torch.bfloat16),
                                            (None, 64)):
            args = [t.to(dt) for t in (q, kp, vp)] + rest
            got = paged_attention.paged_attention(*args, window=window)
            again = paged_attention.paged_attention(*args, window=window)
            assert torch.equal(got, again), f"#13 {label}: two calls differ"
            note("paged_attention", _err(
                "paged_attention",
                f"{label} B4 h{h} kh{kh} hd{hd} bs16 mb10 {str(dt)[6:]} "
                f"w={window}", got,
                paged_attention.paged_attention_plain(*args,
                                                      window=window)))
    for kern, err in check_lora_kernels(LLAMA_LORA_CASES).items():
        note(kern, err)
    return worst


def time_dense_kernels(block_size=16, ring=160):
    """Times at the dense configs' shapes: #1 and #2 at DENSE_BGMV
    (time_kernels), #5-#8 at llama2-7b's q / v (time_lora_kernels), #11 at
    m = 4 and 512 and #12 at llama2-7b's w_up and w_down over int8 and int4
    (time_sched_kernels, time_qtrain_kernels), #3, #4 and #11 at its q / v
    and #13 at DENSE_PAGED over the scheduled path's 10 columns
    (time_sched_kernels)."""
    rows = time_kernels(_bgmv_shapes(DENSE_BGMV))
    rows.update(time_lora_kernels(LLAMA.d_model,
                                  (("llama2-7b q/v", LLAMA.q_dim),)))
    mb = -(-ring // block_size)
    rows.update(time_sched_kernels(
        block_size, ring, projs={**LLAMA_MLP, **LLAMA_QV},
        paged=[(label, h, mb, None, kh, hd)
               for label, h, kh, hd in DENSE_PAGED],
        adapted=tuple(LLAMA_QV)))
    rows.update(time_qtrain_kernels(projs=tuple(LLAMA_MLP), proj=LLAMA_MLP))
    return rows


def _ab_nodes(tree):
    """The {"a", "b"} nodes of a LoRA tree, in key order."""
    if isinstance(tree, dict):
        if set(tree) == {"a", "b"}:
            return [tree]
        return [n for k in sorted(tree) for n in _ab_nodes(tree[k])]
    return []


def _masked_rows_zero(tr):
    """True when every client i's rank rows r_i.. of A and columns r_i..
    of B are exactly 0.0 (compared on the device)."""
    return all(bool((node["a"][i][..., r_i:, :] == 0).all())
               and bool((node["b"][i][..., :, r_i:] == 0).all())
               for node in _ab_nodes(tr.lora)
               for i, r_i in enumerate(tr.ranks))


def _product_rel_diff(lora1, lora2):
    """max over clients and adapted layers of max |B1 A1 - B2 A2| / max
    |B2 A2|."""
    worst = 0.0
    for n1, n2 in zip(_ab_nodes(lora1), _ab_nodes(lora2)):
        for c in range(n1["a"].shape[0]):
            p1 = n1["b"][c] @ n1["a"][c]
            p2 = n2["b"][c] @ n2["a"][c]
            worst = max(worst, float((p1 - p2).abs().max())
                        / max(float(p2.abs().max()), 1e-30))
    return worst


def hetero_train_path(name, cfg, device, params, hom=None, *,
                      strategy="fedsa", ranks=HETERO_RANKS, rounds=3,
                      clients=4, local_steps=2, batch=4, seq=128,
                      equal_rank=64):
    """FederatedTrainer over heterogeneous per-client ranks (``ranks``,
    padded to r_max under a rank mask, client i at gamma_i = alpha
    sqrt(N / r_i)), fp32 base ``params``, the traffic of train_path: the
    launch counts of #5-#8, every masked row of A and column of B exactly
    0.0 after each round, the plain tier within TRAIN_RTOL in loss and
    grad-norm, ms/round.  ``strategy`` flora: a second kernel-tier run bit
    for bit, the aggregate's B A against the plain tier's (FLORA_RTOL) and
    the server step's share of a round.  ``hom`` (train_path's run): ranks
    all ``equal_rank`` must give its bits.  ``cfg`` and ``device`` are
    arguments so the phase can be rehearsed on a CPU at a reduced size."""
    phase(f"heterogeneous training path: FederatedTrainer, {cfg.name} "
          f"d_model {cfg.d_model}, fp32 base, N={clients}, {strategy} + "
          f"sfedlora, ranks {ranks}")
    model = build_model(cfg)

    def trainer(rk):
        ds = FederatedDataset(cfg.vocab_size, clients, seq_len=seq,
                              batch_per_client=batch, seed=0)
        return federated.FederatedTrainer(
            model, ds,
            lora_cfg=LoRAConfig(rank=max(rk), ranks=rk, alpha=8.0,
                                scaling="sfedlora",
                                targets=cfg.lora_targets),
            fed_cfg=FederatedConfig(num_clients=clients,
                                    local_steps=local_steps, rounds=rounds,
                                    aggregation=strategy),
            opt_cfg=OptimizerConfig(name="sgd", lr=5e-3), seed=0,
            base_params=params, device=device)

    def run(tr):
        ms = []
        for _ in range(rounds):
            _sync(device)
            t = time.monotonic()
            tr.run_round()
            _sync(device)
            ms.append((time.monotonic() - t) * 1e3)
            assert _masked_rows_zero(tr), \
                f"round {tr.round_idx}: a masked rank row is not 0.0"
        return ms

    def same(tr_a, hist_b, lora_b):
        return (tr_a.history == hist_b and all(
            torch.equal(x, y) for x, y in zip(tree_leaves(tr_a.lora),
                                              tree_leaves(lora_b))))

    tr1 = trainer(ranks)
    want = [8.0 * math.sqrt(clients / r) for r in ranks]
    print(f"r_max {tr1.lora_cfg.rank}, rank mask {tr1.rank_mask.shape}, "
          f"gamma_i = 8 sqrt(N / r_i) = "
          f"{[round(g, 4) for g in tr1.gammas]}; gamma "
          f"{tr1.gamma} (mixed)")
    assert tr1.lora_cfg.rank == max(ranks) and tr1.gamma is None
    assert all(abs(g - w) <= 1e-6 * w for g, w in zip(tr1.gammas, want))
    assert _masked_rows_zero(tr1), "a masked rank row is not 0.0 at init"

    # the counted run: counts to 0 just before, read just after
    _reset_launches()
    dispatch.reset_stats()
    ms1 = run(tr1)
    _sync(device)
    launches = _launch_counts()
    n_adapted = len(cfg.lora_targets) * cfg.num_layers
    r_ad = _recompute_counts(cfg)[0]
    steps = clients * local_steps * rounds
    expect = dict.fromkeys(launches, 0)
    expect.update({k: n_adapted * steps for k in LORA_KERNELS})
    expect["lora_fwd"] += r_ad * steps
    print(f"launches: { {k: v for k, v in launches.items() if v} } "
          f"(expected {n_adapted} of each of #5-#8 and {r_ad} more of #5 "
          f"in the recompute per client local step x {steps}); dispatch "
          f"{dispatch.stats}")
    assert launches == expect, (launches, expect)
    for h in tr1.history:
        print(f"round {h['round']}: loss {h['loss']:.6f}, grad_norm "
              f"{h['grad_norm']:.6e}")
        assert math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
    print(f"every masked rank row of A and column of B exactly 0.0 after "
          f"each of {rounds} rounds (and at init)")

    if strategy == "flora":
        tr2 = trainer(ranks)
        run(tr2)
        ok = same(tr2, tr1.history, tr1.lora)
        print(f"second kernel-tier run: trajectory and adapters "
              f"{'bit-identical' if ok else 'DIFFER'}")
        assert ok, "two kernel-tier flora runs differ"
        del tr2
        # the server step alone on the final state: QR of the stacked
        # factors, the SVD of their (N r_max)-wide core, redistribution
        strat = get_strategy("flora")
        svds = sum(n["a"][0].numel() // (n["a"].shape[-1] * n["a"].shape[-2])
                   for n in _ab_nodes(tr1.lora))
        _sync(device)
        t = time.monotonic()
        strat.aggregate(tr1.lora, rounds, rank_mask=tr1.rank_mask)
        _sync(device)
        agg = (time.monotonic() - t) * 1e3
        core = clients * max(ranks)
        print(f"flora server step: {agg:.1f} ms for {svds} SVDs of {core} x "
              f"{core} cores (the stacked factors of {svds} adapted "
              f"{cfg.d_model}-wide projections, QR'd in float64), "
              f"{agg / ms1[-1]:.3f} of the last {ms1[-1]:.1f} ms round")

    # the plain tier on the same device
    _reset_launches()
    with dispatch.plain_tier():
        tr3 = trainer(ranks)
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
    print(f"kernel vs plain tier: worst relative diff of loss and grad_norm "
          f"{worst:.3e} (bound {TRAIN_RTOL})")
    assert worst <= TRAIN_RTOL
    if strategy == "flora":
        rel = _product_rel_diff(tr1.lora, tr3.lora)
        print(f"flora aggregate, kernel vs plain tier: max |B A diff| / "
              f"max |B A| {rel:.3e} over every client and layer (bound "
              f"{FLORA_RTOL})")
        assert rel <= FLORA_RTOL
    del tr3

    if hom is not None:
        tr4 = trainer((equal_rank,) * clients)
        run(tr4)
        ok = same(tr4, hom["history"], hom["lora"])
        print(f"ranks {(equal_rank,) * clients}: trajectory and adapters "
              f"{'bit-identical' if ok else 'DIFFER'} to the homogeneous "
              f"rank-{equal_rank} run")
        assert ok, "equal ranks differ from the homogeneous run"
        del tr4
    print(f"heterogeneous training path on {name} ({strategy}, ranks "
          f"{ranks}): ms/round {[round(t, 1) for t in ms1]}; "
          f"{clients * local_steps} client local steps per round")
    return launches, ms1


def llama_paths(name):
    """llama2-7b at full width and half depth (LLAMA_PATHS: 16 of its 32
    layers, fp32, seeded random weights), the model freed after each path:
    generate_banked (32 of #2 per prefill, 32 of #1 per decode step),
    serve_scheduled over an fp32 base (16 of #13 per decode step) and an
    int4 one (#3, #4, and 80 of #11 per decode step: k, o, w_gate, w_up,
    w_down), training (train_path, 32 of each of #5-#8 per client local
    step), heterogeneous ranks (fedsa, and flora for 2 rounds)."""
    dev = torch.device("cuda")
    run_path(name, LLAMA_PATHS, dev)
    _free()
    model, params, bank = serving_model(LLAMA_PATHS, dev)
    for mode in ("fp32", "int4"):
        sched_path(name, model, params, bank, mode)
        _free()
    del model, params, bank
    _free()
    params = train_base(build_model(LLAMA_PATHS), dev)
    _, _, hom = train_path(name, LLAMA_PATHS, dev, params=params)
    _free()
    hetero_train_path(name, LLAMA_PATHS, dev, params, hom)
    del hom
    _free()
    hetero_train_path(name, LLAMA_PATHS, dev, params, strategy="flora",
                      rounds=2)
    del params
    _free()


def qwen_path(name):
    """qwen3-8b at full width and half depth (QWEN_PATH: 18 of its 36
    layers, fp32) through serve_scheduled: #13 at 4 query heads a kv head,
    qk_norm in the model, v at 4096 x 1024."""
    model, params, bank = serving_model(QWEN_PATH, torch.device("cuda"))
    sched_path(name, model, params, bank, "fp32")
    del model, params, bank
    _free()


# ------------------------ 16-19. the RG-LRU hybrid trained and packed

RG = get_config("recurrentgemma-9b")
# phases 18-19 at half depth (see LLAMA_PATHS): 6 repeats of (rglru,
# rglru, attn) and one rglru, 13 RG-LRU and 6 attention layers; since the
# phases of paligemma-3b and roberta-large, phases 13 and 17 as well
RG_PATHS = dataclasses.replace(RG, num_layers=19)
# (bt, s, d) of #15's backward: the scan phase's shapes (the hybrid's
# training and prefill shape first) and s = 1
SCAN_BWD_SHAPES = {**SCAN_SHAPES, "s=1": (4, 1, 4096)}
# the hybrid's packed GEMMs (k, n): q, wx and wy, v (one kv head of 256),
# and the MLP's w_gate / w_up and w_down
HYBRID_PROJ = {"hybrid q/wx/wy": (RG.d_model, RG.q_dim),
               "hybrid v": (RG.d_model, RG.kv_dim),
               "hybrid w_up": (RG.d_model, RG.d_ff),
               "hybrid w_down": (RG.d_ff, RG.d_model)}
HYBRID_ADAPTED = ("hybrid q/wx/wy", "hybrid v")


def check_hybrid_kernels(dev="cuda"):
    """#15's backward at SCAN_BWD_SHAPES, fp32 and bf16, against its plain
    reverse loop bit for bit, and a second call against the first; #9,
    #10, #7 and #8 (rank 64, m = 512; #7 and #8 on the plain versions'
    residuals) at HYBRID_ADAPTED, and #11 at m = 4 and 512 and #12 at m =
    512 at the MLP, over int8 and int4, fp32 and bf16 activations, against
    their plain versions, each called twice with results equal bit for
    bit."""
    phase("the hybrid's training widths vs plain: #15's backward bit for "
          f"bit; #9-#12, #7, #8 (tolerance: |kernel - plain| <= "
          f"{KERNEL_RTOL} * max(1, max|plain|))")
    gen = torch.Generator(dev).manual_seed(14)
    rs, lm = rglru_scan, lora_matmul
    worst = {}

    def note(kern, label, kfn, pfn):
        got, again = kfn(), kfn()
        _sync(torch.device(dev))
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        if not all(torch.equal(u, v) for u, v in zip(got, again)):
            raise AssertionError(f"{kern} {label}: two calls differ")
        err = _check_pair(kern, label, got, pfn())
        worst[kern] = max(worst.get(kern, 0.0), err)
        return got

    for label, shape in SCAN_BWD_SHAPES.items():
        for dt in (torch.float32, torch.bfloat16):
            a, b = _scan_operands(gen, shape, dt, dev)
            g = torch.randn(shape, generator=gen, device=dev).to(dt)
            h = rs.rglru_scan_plain(a, b)
            lab = f"{label} {shape} {str(dt)[6:]}"
            want = rs.rglru_scan_bwd_plain(a, h, g)
            got = note("rglru_scan_bwd", lab, lambda: rs.rglru_scan_bwd(
                a, h, g), lambda: want)
            if not all(torch.equal(u, v) for u, v in zip(got, want)):
                raise AssertionError(f"rglru_scan_bwd {lab}: not bit-"
                                     "identical to the plain reverse loop")
            print(f"rglru_scan_bwd    {lab}: da, db bit-identical to the "
                  "plain reverse loop and on a repeat")
    for mode, bits in (("int8", 8), ("int4", 4)):
        for label in HYBRID_ADAPTED:
            k, n = HYBRID_PROJ[label]
            wq = quantize(torch.randn(k, n, generator=gen, device=dev)
                          * k ** -0.5, bits, QUANT_GROUP)
            for dt in (torch.float32, torch.bfloat16):
                x, _, a, b, g = _lora_operands(gen, 512, k, n, 64, dt, dev)
                _, p = lm.lora_fwd_quant_plain(x, wq, a, b, 1.5)
                _, q = lm.lora_bwd_dx_quant_plain(g, wq, a, b, 1.5)
                calls = _qtrain_calls(x, wq, a, b, g)
                del calls["quant_matmul_dx"]
                calls["lora_bwd_da"] = (lambda: lm.lora_bwd_da(q, x, 1.5),
                                        lambda: lm.lora_bwd_da_plain(q, x,
                                                                     1.5))
                calls["lora_bwd_db"] = (lambda: lm.lora_bwd_db(g, p, 1.5),
                                        lambda: lm.lora_bwd_db_plain(g, p,
                                                                     1.5))
                for kern, (kfn, pfn) in calls.items():
                    note(kern, f"{mode} {label} m=512 k={k} n={n} r=64 "
                         f"{str(dt)[6:]}", kfn, pfn)
            del wq
        for label in ("hybrid w_up", "hybrid w_down"):
            k, n = HYBRID_PROJ[label]
            wq = quantize(torch.randn(k, n, generator=gen, device=dev)
                          * k ** -0.5, bits, QUANT_GROUP)
            for m, dt in itertools.product((4, 512),
                                           (torch.float32, torch.bfloat16)):
                x = torch.randn(m, k, generator=gen, device=dev).to(dt)
                lab = f"{mode} {label} m={m} k={k} n={n} {str(dt)[6:]}"
                note("quant_matmul", lab, lambda: lm.quant_matmul(x, wq),
                     lambda: lm.quant_matmul_plain(x, wq))
                if m == 512:
                    g = torch.randn(m, n, generator=gen, device=dev).to(dt)
                    note("quant_matmul_dx", lab,
                         lambda: lm.quant_matmul_dx(g, wq),
                         lambda: lm.quant_matmul_dx_plain(g, wq))
            del wq
    print(f"launches in this phase (not the path's): "
          f"{ {k: v for k, v in _launch_counts().items() if v} }")
    return worst


def time_hybrid_kernels():
    """fp32 times: #15's backward at the training path's and the bench's
    shapes over 6 input copies (a, h, g: 151 MB, three times L2, as a local
    step's backward finds them cold), beside its plain reverse loop and
    the bound (no single PyTorch call computes it); #5-#8 at the hybrid's
    v (time_lora_kernels); #3, #4 and #11 at HYBRID_PROJ
    (time_sched_kernels) and #9, #10 and #12 there
    (time_qtrain_kernels)."""
    phase("#15's backward times (fp32)")
    gen = torch.Generator("cuda").manual_seed(15)
    rows = {}
    for label in ("path", "bench"):
        shape = SCAN_SHAPES[label]
        args = []
        for _ in range(6):
            a, b = _scan_operands(gen, shape, torch.float32)
            args.append((a, rglru_scan.rglru_scan_plain(a, b),
                         torch.randn(shape, generator=gen, device="cuda")))
        ms = _graph_ms(rglru_scan.rglru_scan_bwd, args)
        plain_ms = _graph_ms(rglru_scan.rglru_scan_bwd_plain, args[:2],
                             reps=2)
        a = args[0][0]
        nbytes = 5 * a.nbytes                # a, h, g read; da, db written
        bound_ms, bound_by = _bound(nbytes, 3 * a.numel())
        rows[("rglru_scan_bwd", label)] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None)
        print(f"rglru_scan_bwd {label} {shape}: kernel {ms * 1e3:.2f} us, "
              f"plain (a reverse loop of {shape[1]} steps) "
              f"{plain_ms * 1e3:.2f} us, no single library call, bound "
              f"{bound_ms * 1e3:.2f} us ({bound_by}; {nbytes / 1e6:.2f} MB; "
              f"{bound_ms / ms:.2f} of it)")
        del args
    # #5-#8 at the hybrid's v (4096 -> 256; its q / wx / wy are llama2-7b's
    # q / v shape, timed in phase 14)
    rows.update(time_lora_kernels(k=RG.d_model,
                                  projs=(("hybrid v", RG.kv_dim),)))
    rows.update(time_sched_kernels(SCHED["block_size"], 0, projs=HYBRID_PROJ,
                                   paged=[], adapted=HYBRID_ADAPTED))
    rows.update(time_qtrain_kernels(projs=tuple(HYBRID_PROJ),
                                    proj=HYBRID_PROJ,
                                    adapted=HYBRID_ADAPTED))
    return rows


def hybrid_train_paths(name):
    """recurrentgemma-9b trained at full width and RG_PATHS's half depth
    (19 layers, 13 RG-LRU and 6 attention): train_path over a fp32 seeded
    random base, then over that base packed int4 on the card, the fp32
    tree dropped once packed.  Returns the two runs' launch counts."""
    dev = torch.device("cuda")
    params = train_base(build_model(RG_PATHS), dev)
    fp32, _, _ = train_path(name, RG_PATHS, dev, params=params)
    del params
    _free()
    params = quantize_tree(train_base(build_model(RG_PATHS), dev), "int4",
                           QUANT_GROUP)
    _free()
    int4, _, _ = train_path(name, RG_PATHS, dev, quant="int4",
                            params=params)
    del params
    _free()
    return fp32, int4


def hybrid_packed_serving(name):
    """recurrentgemma-9b at RG_PATHS's half depth served over an int4 base
    (packed on the card from the seeded fp32 weights, which are then
    dropped): generate_banked and serve_scheduled, with the 4 SFed-LoRA
    tenants of phase 13."""
    dev = torch.device("cuda")
    run_path(name, RG_PATHS, dev, quant="int4")
    _free()
    model, params, bank = serving_model(RG_PATHS, dev)
    params = quantize_tree(params, "int4", QUANT_GROUP)
    _free()
    sched_path(name, model, params, bank, "int4")
    del model, params, bank
    _free()


# ------------------------------------------ 21. the fault-tolerant engine

# gemma-2b at half depth (9 of its 18 layers, full width): phase 21, the
# scheduled and live-bank paths and the packed training paths, cut since
# phase 29 for the script's time limit (phase 6, the fixed-batch path and
# phase 29 stay at full depth)
GEMMA_HALF = dataclasses.replace(get_config("gemma-2b"), num_layers=9)
FT_ROUNDS = 4
FT_FAULTS = "dropout=0.2,straggle=geom:0.3,corrupt=0.25"
FT_NOISE = "corrupt=0.25,mode=noise"
FT_NOISE_ROUNDS = 6


def _trees_equal(t1, t2):
    la, lb = tree_leaves(t1), tree_leaves(t2)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _state_equal(a, b):
    """Two trainers' adapters, optimizer state and async carry, bit for
    bit."""
    return _trees_equal({"l": a.lora, "o": a.opt_state, "x": a.async_state},
                        {"l": b.lora, "o": b.opt_state, "x": b.async_state})


def _check_finite_each_round(tr):
    """Wrap ``tr``'s round body so that every adapter leaf is checked
    finite after every round (one host read a round: the counted run
    only; the repeat and the timings run unwrapped)."""
    body = tr._round_body

    def checked(*args, **kw):
        out = body(*args, **kw)
        bad = [i for i, x in enumerate(tree_leaves(out[0].lora))
               if not bool(torch.isfinite(x).all())]
        assert not bad, f"round {args[6]}: non-finite adapter leaves {bad}"
        return out
    tr._round_body = checked


def _timed_chunks(tr, rounds, chunk, device):
    """``rounds`` rounds in chunks of ``chunk``: ms/round of each chunk."""
    ms = []
    for _ in range(rounds // chunk):
        _sync(device)
        t = time.monotonic()
        tr.run(chunk)
        _sync(device)
        ms.append((time.monotonic() - t) * 1e3 / chunk)
    return ms


def _publish_then_serve(model, tr, live, device):
    """``publish_adapters`` into ``live`` (2 hot slots for the 4 tenants),
    then phase 8's traffic through serve_scheduled over it, against a
    static AdapterBank stacked from the same round.  The tenants go in
    pairs (0, 0, 1, 1, 2, 2, 3, 3), so each wave's two tenants fit the hot
    slots: both banks admit the same groups, the kernels see the same
    shapes, and the tokens must be equal.  Returns the launches of the
    live run."""
    clients = tr.fed_cfg.num_clients
    n = tr.publish_adapters(live)
    print(f"publish_adapters: {n} tenants, {live.swaps} swapped on the "
          f"device, versions {[live.tenant_version(t) for t in range(n)]}")
    assert n == clients and live.swaps == 2
    static = AdapterBank.from_sets([tr.client_adapters(c)
                                    for c in range(clients)])
    sc, cfg = SCHED, model.cfg
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, cfg.vocab_size, (sc["n_req"], sc["plen"]))
    ids = [(i // 2) % clients for i in range(sc["n_req"])]
    last = sc["n_req"] - 1

    def run(bank):
        reqs = [serve.Request(rid=i, prompt=prompts[i].astype(np.int32),
                              steps=sc["steps"], adapter_id=ids[i],
                              deadline_steps=sc["deadline"] if i == last
                              else None) for i in range(sc["n_req"])]
        return serve.serve_scheduled(
            model, tr.base, reqs, bank=bank, max_batch=sc["max_batch"],
            block_size=sc["block_size"], chunk=sc["chunk"], wait=False)

    calls = {"prefill": 0, "decode_step": 0}
    orig = {k: getattr(model, k) for k in calls}

    def counting(key):
        def wrapped(*a, **k):
            calls[key] += 1
            return orig[key](*a, **k)
        return wrapped

    model.prefill, model.decode_step = (counting("prefill"),
                                        counting("decode_step"))
    _reset_launches()
    _sync(device)
    t = time.monotonic()
    served = run(live)
    _sync(device)
    wall = time.monotonic() - t
    launches = _launch_counts()
    del model.prefill, model.decode_step
    groups, steps = calls["prefill"], calls["decode_step"]
    n_ad = _n_adapted(live.bank)
    expect = dict.fromkeys(launches, 0)
    expect.update(bgmv_matmul=n_ad * groups, bgmv_gemv=n_ad * steps,
                  paged_attention=_layer_kinds(cfg).count("attn") * steps)
    print(f"served over the live bank: {groups} admission groups, {steps} "
          f"decode steps, {wall:.3f} s; {live.promotions} promotions, "
          f"{live.demotions} demotions; launches #2 {launches['bgmv_matmul']}"
          f", #1 {launches['bgmv_gemv']}, #13 {launches['paged_attention']} "
          f"(expected { {k: v for k, v in expect.items() if v} })")
    assert launches == expect, (launches, expect)
    assert live.promotions > 0
    want = run(static)
    same = [a.tokens == b.tokens for a, b in zip(served, want)]
    print(f"tokens over the live bank vs a static AdapterBank of the same "
          f"round: {sum(same)} of {len(same)} requests equal "
          f"({sum(len(r.tokens) for r in served)} tokens)")
    assert all(same)
    return launches


def fault_tolerant_paths(name, cfg, device, params, sync, *, clients=4,
                         rank=64, local_steps=2, batch=4, seq=128):
    """Phase 21 on phase 6's base ``params`` and against its synchronous
    run ``sync`` (train_path's result with track_stability, plus its
    counted ``launches`` and ``ms``): the buffered engine at null faults, under nan and noise faults, the watchdog, and the publish hook
    into a live serving bank.  ``cfg`` and ``device`` are arguments so the
    phase can be rehearsed on a CPU at a reduced size."""
    phase(f"fault-tolerant engine: buffered at null faults, {cfg.name} "
          f"d_model {cfg.d_model}, fp32, N={clients}, fedsa, rank {rank}")
    model = build_model(cfg)
    rounds = len(sync["history"])
    n_adapted = _proj_counts(cfg)[0]

    def trainer(scaling="sfedlora", chunk_rounds=0, watchdog=None, **fed):
        ds = FederatedDataset(cfg.vocab_size, clients, seq_len=seq,
                              batch_per_client=batch, seed=0)
        return federated.FederatedTrainer(
            model, ds, lora_cfg=LoRAConfig(rank=rank, alpha=8.0,
                                           scaling=scaling,
                                           targets=cfg.lora_targets),
            fed_cfg=FederatedConfig(num_clients=clients,
                                    local_steps=local_steps,
                                    rounds=FT_ROUNDS, aggregation="fedsa",
                                    **fed),
            opt_cfg=OptimizerConfig(name="sgd", lr=5e-3), seed=0,
            base_params=params, device=device, chunk_rounds=chunk_rounds,
            watchdog=watchdog, track_stability=True)

    def lora_launches(n_rounds):
        out = dict.fromkeys(_launch_counts(), 0)
        out.update({k: n_adapted * clients * local_steps * n_rounds
                    for k in LORA_KERNELS})
        out["lora_fwd"] += (_recompute_counts(cfg)[0] * clients
                            * local_steps * n_rounds)
        return out

    # 1. buffer 0 (no cap), no faults: the synchronous run, bit for bit
    tr = trainer(buffer_size=0)
    live = LiveAdapterBank.from_sets(
        [tr.client_adapters(c) for c in range(clients)], hot_slots=2,
        device=device)
    _reset_launches()
    ms_null = []
    for _ in range(rounds):
        _sync(device)
        t = time.monotonic()
        tr.run_round()
        _sync(device)
        ms_null.append((time.monotonic() - t) * 1e3)
    launches = _launch_counts()
    assert launches == lora_launches(rounds), (launches, rounds)
    steps = clients * local_steps * rounds
    per_step = {k: launches[k] / steps for k in LORA_KERNELS}
    # phase 6's counted run, its eval forward's #5 taken out
    sync_per_step = {k: (sync["launches"][k]
                         - (n_adapted if k == "lora_fwd" else 0)) / steps
                     for k in LORA_KERNELS}
    print(f"launches per client local step {per_step} (synchronous run: "
          f"{sync_per_step})")
    assert per_step == sync_per_step
    same = _trees_equal({"l": tr.lora, "o": tr.opt_state},
                        {"l": sync["lora"], "o": sync["opt"]}) and all(
        hb[k] == hs[k] for hb, hs in zip(tr.history, sync["history"])
        for k in ("loss", "grad_norm", "update_norm"))
    for h in tr.history:
        print(f"round {h['round']}: loss {h['loss']:.6f}, n_eff "
              f"{h['n_eff']:g}, gamma_scale {h['gamma_scale']:g}, "
              f"delivered {h['delivered']:g}, stale {h['stale']:g}")
    print(f"buffered at null faults vs the synchronous run of phase 6: "
          f"trajectory and state {'bit-identical' if same else 'DIFFER'}; "
          f"gamma_eff {tr.gamma_eff:.6g} (gamma {tr.gamma:.6g})")
    assert same and tr.gamma_eff == tr.gamma
    phase("fault-tolerant engine: train to serve (publish_adapters into a "
          "LiveAdapterBank of 2 hot slots, 4 tenants; serve_scheduled)")
    serve_launches = _publish_then_serve(model, tr, live, device)
    del tr, live
    _free()

    # 2. nan faults in chunks of 2, screening on
    faults = parse_faults(FT_FAULTS)
    phase(f"fault-tolerant engine: faults [{FT_FAULTS}], buffer 0, chunks "
          f"of 2, {FT_ROUNDS} rounds")
    tr_a = trainer(buffer_size=0, faults=faults, chunk_rounds=2)
    _check_finite_each_round(tr_a)
    _reset_launches()
    ms_a = _timed_chunks(tr_a, FT_ROUNDS, 2, device)
    launches = _launch_counts()
    assert launches == lora_launches(FT_ROUNDS), launches
    for h in tr_a.history:
        print(f"round {h['round']}: loss {h['loss']:.6f}, grad_norm "
              f"{h['grad_norm']:.6e}, n_eff {h['n_eff']:g}, delivered "
              f"{h['delivered']:g}, rejected {h['rejected']:g}, stale "
              f"{h['stale']:g}, gamma_scale {h['gamma_scale']:.6g}")
    print(f"every adapter leaf finite after every round; gamma_eff "
          f"{tr_a.gamma_eff:.6g} (gamma {tr_a.gamma:.6g}); launches "
          f"{ {k: v for k, v in launches.items() if v} } (every client "
          "trains, in flight or not)")
    tr_b = trainer(buffer_size=0, faults=faults, chunk_rounds=2)
    ms_b = _timed_chunks(tr_b, FT_ROUNDS, 2, device)
    same = _state_equal(tr_a, tr_b) and tr_a.history == tr_b.history
    print(f"second faulted run: {'bit-identical' if same else 'DIFFERS'}")
    assert same
    del tr_b
    ckpt = ROOT / "build" / "chip_smoke_faults.npz"
    tr_c = trainer(buffer_size=0, faults=faults, chunk_rounds=2)
    tr_c.run(2)
    _sync(device)
    t = time.monotonic()
    tr_c.save(str(ckpt))
    save_s = time.monotonic() - t
    tr_c.run(FT_ROUNDS - 2)
    tr_d = trainer(buffer_size=0, faults=faults, chunk_rounds=2)
    t = time.monotonic()
    tr_d.restore(str(ckpt))
    _sync(device)
    restore_s = time.monotonic() - t
    mb = ckpt.stat().st_size / 1e6
    ckpt.unlink()
    tr_d.run(FT_ROUNDS - 2)
    same = (_state_equal(tr_d, tr_c) and _state_equal(tr_c, tr_a)
            and tr_d.history == tr_c.history[2:])
    print(f"save after round 2 ({mb:.1f} MB in {save_s:.1f} s), restored in "
          f"{restore_s:.1f} s; rounds 3-{FT_ROUNDS} "
          f"{'bit-identical' if same else 'DIFFER'} to the uninterrupted "
          "run")
    assert same
    del tr_c, tr_d
    _free()
    _reset_launches()
    with dispatch.plain_tier():
        tr_e = trainer(buffer_size=0, faults=faults, chunk_rounds=2)
        tr_e.run(FT_ROUNDS)
    assert not any(_launch_counts().values()), _launch_counts()
    worst = 0.0
    for hk, hp in zip(tr_a.history, tr_e.history):
        for key in ("delivered", "rejected", "stale"):
            assert hk[key] == hp[key], (key, hk, hp)
        for key in ("loss", "grad_norm"):
            worst = max(worst, abs(hk[key] - hp[key])
                        / max(abs(hp[key]), 1e-30))
    print(f"kernel vs plain tier under faults: worst relative diff of loss "
          f"and grad_norm {worst:.3e} (bound {TRAIN_RTOL}); delivered / "
          "rejected / stale equal every round")
    assert worst <= TRAIN_RTOL
    del tr_e
    _free()

    # 3. noise-mode corruption: finite norm bombs, screened against the
    # candidates' lower median
    phase(f"fault-tolerant engine: faults [{FT_NOISE}], {FT_NOISE_ROUNDS} "
          "rounds in chunks of 2")
    tr_n = trainer(buffer_size=0, faults=parse_faults(FT_NOISE),
                   chunk_rounds=2)
    _check_finite_each_round(tr_n)
    ms_n = _timed_chunks(tr_n, FT_NOISE_ROUNDS, 2, device)
    fm = tr_n.fault_model
    expect = []
    for r in range(FT_NOISE_ROUNDS):
        c = int(fm.sample(fm.round_generator(0, r, device),
                          clients)["corrupt"].sum())
        # the lower median of the N candidates is clean while the clean
        # ones outnumber its index; a corrupted majority goes unrejected
        expect.append(c if clients - c > (clients - 1) // 2 else 0)
    rejected = [int(h["rejected"]) for h in tr_n.history]
    print(f"corrupted uploads a round (redrawn from the round generators) "
          f"screened: rejected {rejected}, expected {expect}")
    assert rejected == expect and sum(rejected) >= 1
    del tr_n

    # 4. the watchdog: classic LoRA gamma = alpha / r at r = 64, N = 4
    phase(f"fault-tolerant engine: watchdog (scaling lora, rank {rank}, "
          "max_retries 2, chunks of 2)")
    tr_w = trainer(scaling="lora", buffer_size=0, chunk_rounds=2,
                   watchdog=federated.WatchdogConfig(max_retries=2))
    cost = {"snapshot": [], "rollback": []}
    for key in cost:
        fn = getattr(tr_w, f"_{key}")

        def timed(*a, fn=fn, key=key):
            _sync(device)
            t = time.monotonic()
            out = fn(*a)
            _sync(device)
            cost[key].append((time.monotonic() - t) * 1e3)
            return out
        setattr(tr_w, f"_{key}", timed)
    gamma0 = tr_w.gamma
    tr_w.run(FT_ROUNDS)
    for ev in tr_w.watchdog_events:
        print(f"# watchdog: round {ev['round']} verdict={ev['verdict']} -> "
              f"{ev['action']} ({ev['detail']}, retry {ev['retry']})")
    ev = tr_w.watchdog_events[0]
    rep = tr_w.stability_report()
    print(f"gamma {gamma0:.4g} (lora) -> {tr_w.gamma:.4g} "
          f"({tr_w.lora_cfg.scaling}); {len(tr_w.history)} rounds kept; "
          f"final report: {rep}")
    print(f"snapshot {[round(x, 3) for x in cost['snapshot']]} ms, rollback "
          f"{[round(x, 3) for x in cost['rollback']]} ms")
    assert ev["verdict"] == "collapse" and ev["action"] == "rescale"
    assert tr_w.lora_cfg.scaling == "sfedlora"
    assert math.isclose(tr_w.gamma, 8.0 * math.sqrt(clients / rank))
    assert len(tr_w.history) == FT_ROUNDS and tr_w.round_idx == FT_ROUNDS
    print(f"stability_report() of phase 6's synchronous run: "
          f"{sync['report']}")
    del tr_w
    _free()
    sync_ms = sync["ms"]
    print(f"fault-tolerant engine on {name}: ms/round synchronous (phase 6) "
          f"{[round(x, 1) for x in sync_ms]}, buffered at null faults "
          f"{[round(x, 1) for x in ms_null]}, faults [{FT_FAULTS}] "
          f"{[round(x, 1) for x in ms_a]} (first run) "
          f"{[round(x, 1) for x in ms_b]} (second), noise mode "
          f"{[round(x, 1) for x in ms_n]}; each a chunk's mean")
    return serve_launches


# ----------------------------------------- 22-24. the MoE family

QWEN_MOE = get_config("qwen2-moe-a2.7b")
GRANITE = get_config("granite-moe-1b-a400m")
# With paligemma-3b's and roberta-large's phases the script no longer fits
# its time on one card: both MoE archs' paths run at half depth (12 of
# their 24 layers), at full width, as LLAMA_PATHS does for llama2-7b; the
# kernel phases keep their full shapes
QWEN_MOE_PATHS = dataclasses.replace(QWEN_MOE, num_layers=12)
GRANITE_PATHS = dataclasses.replace(GRANITE, num_layers=12)
# #1 / #2 and #5-#8 (label, k, n): the MoE archs' adapted q and v
MOE_QV = (("granite q", GRANITE.d_model, GRANITE.q_dim),
          ("granite v", GRANITE.d_model, GRANITE.kv_dim),
          ("qwen2-moe q/v", QWEN_MOE.d_model, QWEN_MOE.q_dim))
MOE_RANKS = (8, 64)
# #3, #4 and #9-#12 at granite-moe's packed projections (k, n): its base
# over int4 packs q, k, v and o only (the router and experts stay fp32)
GRANITE_PROJ = {"granite q": (GRANITE.d_model, GRANITE.q_dim),
                "granite k": (GRANITE.d_model, GRANITE.kv_dim),
                "granite v": (GRANITE.d_model, GRANITE.kv_dim),
                "granite o": (GRANITE.q_dim, GRANITE.d_model)}
GRANITE_ADAPTED = ("granite q", "granite v")
# the two (k, n) among them, as timed: q and o (1024 x 1024), k and v
# (1024 x 512); #3, #4, #9 and #10 time at both (q and v)
GRANITE_TIMED = {"granite q/o": (GRANITE.d_model, GRANITE.q_dim),
                 "granite k/v": (GRANITE.d_model, GRANITE.kv_dim)}
# #13 (label, query heads, kv heads, head_dim) of the MoE decode steps
MOE_PAGED = tuple((c.name, c.num_heads, c.num_kv_heads, c.head_dim)
                  for c in (QWEN_MOE, GRANITE))
# granite-moe's device-data training: N clients over a Dirichlet
# partition, one local step a round (the path is host-bound at about 0.25
# s a local step), rounds in chunks, a save after the first chunk
DD_TRAIN = dict(clients=16, local_steps=1, rounds=4, chunk=2)


def check_moe_kernels(dev="cuda"):
    """The kernels at the MoE archs' shapes, fp32 and bf16, against their
    plain versions: #1 and #2 (4 requests, bank ids and ids=None) at
    MOE_QV with ranks 8 and 64; #13 at MOE_PAGED (160 positions, 10
    columns of 16, plus a window of 64); #11 at m = 1, 4, 8 and 512, #12 at
    m = 512, and at q and v #3 and #4 (rank 8) and #9 and #10 (ranks 8 and
    64), over int8 and int4 (group 64) at GRANITE_PROJ; then #5-#8 at
    MOE_QV with ranks 8 and 64 (check_lora_kernels)."""
    phase("the MoE archs' shapes vs plain (tolerance: |kernel - plain| <= "
          f"{KERNEL_RTOL} * max(1, max|plain|), + {BF16_STEP} * |plain| for "
          "a bf16 output)")
    gen = torch.Generator(dev).manual_seed(12)
    worst = {}
    dts = (torch.float32, torch.bfloat16)

    def note(kern, err):
        worst[kern] = max(worst.get(kern, 0.0), err)

    for (label, k, n), r, dt, s in itertools.product(MOE_QV, MOE_RANKS, dts,
                                                     (1, 128)):
        x, w, a, b, ids = _bank(gen, 4, s, k, n, 4, (r,) * 4, dt)
        for id_mode in ("bank", "none"):
            a_, b_, ids_ = (a, b, ids) if id_mode == "bank" else (
                a.index_select(0, ids.long()).contiguous(),
                b.index_select(0, ids.long()).contiguous(), None)
            lab = f"{label} k={k} n={n} r={r} s={s} {str(dt)[6:]} ids={id_mode}"
            if s == 1:
                x1 = x[:, 0].contiguous()
                note("bgmv_gemv", _err(
                    "bgmv_gemv", lab, bgmv.bgmv_gemv(x1, w, a_, b_, ids_),
                    bgmv.bgmv_gemv_plain(x1, w, a_, b_, ids_)))
            else:
                note("bgmv_matmul", _err(
                    "bgmv_matmul", lab, bgmv.bgmv_matmul(x, w, a_, b_, ids_),
                    bgmv.bgmv_matmul_plain(x, w, a_, b_, ids_)))
    for label, h, kh, hd in MOE_PAGED:
        q, kp, vp, *rest = _paged_case(gen, 4, h, kh, hd, 16, 10, dev=dev)
        for dt, window in itertools.product(dts, (None, 64)):
            args = [t.to(dt) for t in (q, kp, vp)] + rest
            got = paged_attention.paged_attention(*args, window=window)
            again = paged_attention.paged_attention(*args, window=window)
            assert torch.equal(got, again), f"#13 {label}: two calls differ"
            note("paged_attention", _err(
                "paged_attention",
                f"{label} B4 h{h} kh{kh} hd{hd} bs16 mb10 {str(dt)[6:]} "
                f"w={window}", got,
                paged_attention.paged_attention_plain(*args, window=window)))
    for mode, bits in (("int8", 8), ("int4", 4)):
        for label, (k, n) in GRANITE_PROJ.items():
            wq = quantize(torch.randn(k, n, generator=gen, device=dev)
                          * k ** -0.5, bits, QUANT_GROUP)
            for m, dt in itertools.product((1, 4, 8, 512), dts):
                x = torch.randn(m, k, generator=gen, device=dev).to(dt)
                lab = f"{mode} {label} m={m} k={k} n={n} {str(dt)[6:]}"
                got = lora_matmul.quant_matmul(x, wq)
                assert torch.equal(got, lora_matmul.quant_matmul(x, wq)), \
                    f"#11 {lab}: two calls differ"
                note("quant_matmul", _err(
                    "quant_matmul", lab, got,
                    lora_matmul.quant_matmul_plain(x, wq)))
                if m == 512:
                    g = torch.randn(m, n, generator=gen, device=dev).to(dt)
                    note("quant_matmul_dx", _err(
                        "quant_matmul_dx", lab,
                        lora_matmul.quant_matmul_dx(g, wq),
                        lora_matmul.quant_matmul_dx_plain(g, wq)))
            if label not in GRANITE_ADAPTED:
                continue
            for s_, dt in itertools.product((1, 128), dts):
                x, _, a, b, ids = _bank(gen, 4, s_, k, n, 4, (8,) * 4, dt)
                lab = f"{mode} {label} B=4 s={s_} k={k} n={n} {str(dt)[6:]}"
                if s_ == 1:
                    x1 = x[:, 0].contiguous()
                    note("bgmv_gemv_quant", _err(
                        "bgmv_gemv_quant", lab,
                        bgmv.bgmv_gemv_quant(x1, wq, a, b, ids),
                        bgmv.bgmv_gemv_quant_plain(x1, wq, a, b, ids)))
                else:
                    note("bgmv_matmul_quant", _err(
                        "bgmv_matmul_quant", lab,
                        bgmv.bgmv_matmul_quant(x, wq, a, b, ids),
                        bgmv.bgmv_matmul_quant_plain(x, wq, a, b, ids)))
            for r, dt in itertools.product(MOE_RANKS, dts):
                x, _, a, b, g = _lora_operands(gen, 512, k, n, r, dt, dev)
                calls = _qtrain_calls(x, wq, a, b, g)
                for kern in ("lora_fwd_quant", "lora_bwd_dx_quant"):
                    kfn, pfn = calls[kern]
                    note(kern, _check_pair(
                        kern, f"{mode} {label} m=512 k={k} n={n} r={r} "
                        f"{str(dt)[6:]}", kfn(), pfn()))
            del wq
    for kern, err in check_lora_kernels(
            [(label, 512, k, n, r, r) for label, k, n in MOE_QV
             for r in MOE_RANKS]).items():
        note(kern, err)
    return worst


def time_moe_kernels(block_size=16, ring=160):
    """Times at the MoE archs' shapes: #1 and #2 at MOE_QV (time_kernels,
    rank 8), #5-#8 at MOE_QV (time_lora_kernels, rank 64), #3, #4 and #11
    at GRANITE_PROJ and #13 at MOE_PAGED over the scheduled path's 10
    columns (time_sched_kernels), #9, #10 and #12 at GRANITE_PROJ
    (time_qtrain_kernels); GRANITE_PROJ's four projections have two
    shapes, timed once each (GRANITE_TIMED)."""
    rows = time_kernels(_bgmv_shapes(MOE_QV))
    rows.update(time_lora_kernels(
        GRANITE.d_model, (("granite q", GRANITE.q_dim),
                          ("granite v", GRANITE.kv_dim))))
    rows.update(time_lora_kernels(QWEN_MOE.d_model,
                                  (("qwen2-moe q/v", QWEN_MOE.q_dim),)))
    mb = -(-ring // block_size)
    rows.update(time_sched_kernels(
        block_size, ring, projs=GRANITE_TIMED,
        paged=[(label, h, mb, None, kh, hd)
               for label, h, kh, hd in MOE_PAGED],
        adapted=tuple(GRANITE_TIMED)))
    rows.update(time_qtrain_kernels(projs=tuple(GRANITE_TIMED),
                                    proj=GRANITE_TIMED,
                                    adapted=tuple(GRANITE_TIMED)))
    return rows


def _peak(label, device):
    """Print and reset the peak device memory since the last reset."""
    print(f"peak device memory, {label}: "
          f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB "
          "(torch.cuda.max_memory_allocated)")
    torch.cuda.reset_peak_memory_stats(device)


def qwen_moe_paths(name):
    """qwen2-moe-a2.7b at full width and half depth (QWEN_MOE_PATHS: 12 of
    its 24 layers, 60 experts padded to 64, top-4, 4 shared experts, an
    untied head; seeded random weights), every earlier model freed first:
    generate_banked (24 of #2 per prefill, 24 of #1 per decode step),
    serve_scheduled over the fp32 base (12 of #13 per decode step), and
    training (train_path: 24 of each of #5-#8 per client local step; no
    checkpoint), with peak memory and the expert bmms' share of a local
    step."""
    dev = torch.device("cuda")
    _free()
    torch.cuda.reset_peak_memory_stats(dev)
    run_path(name, QWEN_MOE_PATHS, dev)
    _peak("qwen2-moe fixed-batch serving", dev)
    _free()
    model, params, bank = serving_model(QWEN_MOE_PATHS, dev)
    sched_path(name, model, params, bank, "fp32")
    _peak("qwen2-moe scheduled serving", dev)
    del model, bank
    _free()
    # serving_model draws the base first from seed 0, as train_base does
    train_path(name, QWEN_MOE_PATHS, dev, params=params)
    del params
    _free()
    _peak("qwen2-moe training", dev)


def device_data_train_path(name, cfg, device, params, *, clients=16,
                           rank=64, local_steps=2, batch=4, seq=128,
                           rounds=4, chunk=2):
    """FederatedTrainer with ``data_mode="device"`` (every round's batches
    drawn on the card from the trainer's own generator, a Dirichlet
    partition of ``clients`` clients) over ``params`` (a packed base),
    ``rounds`` rounds in chunks of ``chunk``: the launch counts, a second
    kernel-tier run, saved after its first chunk and finished by a trainer
    restored from that checkpoint, bit for bit the first, and the plain
    tier within TRAIN_RTOL."""
    phase(f"device-data training path: FederatedTrainer(data_mode="
          f"'device'), {cfg.name} d_model {cfg.d_model}, packed base, "
          f"N={clients} (dirichlet), fedsa + sfedlora, rank {rank}, "
          f"{rounds} rounds in chunks of {chunk}")
    model = build_model(cfg)
    lcfg = LoRAConfig(rank=rank, alpha=8.0, scaling="sfedlora",
                      targets=cfg.lora_targets)
    fcfg = FederatedConfig(num_clients=clients, local_steps=local_steps,
                           rounds=rounds, aggregation="fedsa",
                           partition="dirichlet")
    ocfg = OptimizerConfig(name="sgd", lr=5e-3)
    ckpt = ROOT / "build" / "chip_smoke_device_data.npz"

    def trainer():
        ds = FederatedDataset(cfg.vocab_size, clients, seq_len=seq,
                              batch_per_client=batch,
                              partition="dirichlet", seed=0)
        return federated.FederatedTrainer(
            model, ds, lora_cfg=lcfg, fed_cfg=fcfg, opt_cfg=ocfg, seed=0,
            base_params=params, data_mode="device", chunk_rounds=chunk,
            device=device)

    def run(tr, n=rounds):
        ms = []
        for _ in range(n // chunk):
            _sync(device)
            t = time.monotonic()
            tr.run(chunk)
            _sync(device)
            ms.append((time.monotonic() - t) * 1e3 / chunk)
        return ms

    # the counted run: counts to 0 just before, read just after
    tr1 = trainer()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _reset_launches()
    dispatch.reset_stats()
    with _routing([]) as log_k:
        ms1 = run(tr1)
    ppl = tr1.eval_perplexity()
    _sync(device)
    launches = _launch_counts()
    n_adapted, n_base, n_no_grad = _proj_counts(cfg)
    r_ad, r_base, _ = _recompute_counts(cfg)
    steps = clients * local_steps * rounds
    expect = dict.fromkeys(launches, 0)
    expect.update({k: n_adapted * steps for k in QTRAIN_PATH_KERNELS})
    expect["quant_matmul"] = n_base * (steps + 1) + r_base * steps
    expect["quant_matmul_dx"] = (n_base - n_no_grad) * steps
    expect["lora_fwd_quant"] += n_adapted + r_ad * steps  # eval, recompute
    print(f"launches: { {k: v for k, v in launches.items() if v} } "
          f"(expected { {k: v for k, v in expect.items() if v} }: "
          f"{n_adapted} of each of #9, #10, #7, #8, {n_base} of #11 and "
          f"{n_base - n_no_grad} of #12, and {r_ad} of #9 and {r_base} of "
          f"#11 in the recompute, per client local step x {steps}, plus "
          f"the eval forward); dispatch {dispatch.stats}")
    assert launches == expect, (launches, expect)
    if device.type == "cuda":
        print(f"peak device memory over the counted run: "
              f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB "
              f"(torch.cuda.max_memory_allocated)")
    for h in tr1.history:
        print(f"round {h['round']}: loss {h['loss']:.6f}, grad_norm "
              f"{h['grad_norm']:.6e}")
        assert math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
    print(f"held-out perplexity {ppl:.3f}")
    assert math.isfinite(ppl)

    # a second kernel-tier run, saved after its first chunk and resumed
    # from that checkpoint by a fresh trainer: bit for bit the first run
    tr2 = trainer()
    ms2 = run(tr2, chunk)
    tr2.save(str(ckpt))
    first_half = tr2.history == tr1.history[:chunk]
    del tr2
    t = time.monotonic()
    tr3 = trainer()
    tr3.restore(str(ckpt))
    mb = ckpt.stat().st_size / 1e6
    ckpt.unlink()
    _sync(device)
    restore_s = time.monotonic() - t
    ms2 += run(tr3, rounds - chunk)
    resumed = (tr3.history == tr1.history[chunk:]
               and all(torch.equal(x, y) for x, y in
                       zip(tree_leaves(tr3.lora), tree_leaves(tr1.lora))))
    print(f"second kernel-tier run: rounds 1-{chunk} "
          f"{'bit-identical' if first_half else 'DIFFER'}; checkpoint after "
          f"round {chunk} ({mb:.1f} MB, the data generator's state in it), "
          f"restored in {restore_s:.1f} s; rounds {chunk + 1}-{rounds} and "
          f"the adapters {'bit-identical' if resumed else 'DIFFER'} to the "
          "first run's")
    assert first_half, "two kernel-tier device-data runs differ"
    assert resumed, "the resumed rounds differ from the uninterrupted run"
    del tr3

    # the plain tier on the same device draws the same batches
    _reset_launches()
    with dispatch.plain_tier(), _routing([], replay=log_k) as log_p:
        tr4 = trainer()
        run(tr4)
    assert not any(_launch_counts().values()), _launch_counts()
    _routing_report(f"{rounds} device-data training rounds", log_k, log_p,
                    cfg.moe.top_k)
    del log_k, log_p
    worst = 0.0
    for hk, hp in zip(tr1.history, tr4.history):
        for key in ("loss", "grad_norm"):
            d = abs(hk[key] - hp[key])
            rel = d / max(abs(hp[key]), 1e-30)
            worst = max(worst, rel)
            print(f"round {hk['round']} {key}: kernel {hk[key]:.8g}, plain "
                  f"{hp[key]:.8g}, |diff| {d:.3e} (relative {rel:.3e})")
    print(f"kernel vs plain tier: worst relative diff of loss and grad_norm "
          f"{worst:.3e} (bound {TRAIN_RTOL})")
    assert worst <= TRAIN_RTOL
    print(f"device-data training path on {name}: ms/round "
          f"{[round(x, 1) for x in ms1]} (first run, a chunk's mean), "
          f"{[round(x, 1) for x in ms2]} (second run, resumed after its "
          f"first chunk); "
          f"{clients * local_steps} client local steps per round")
    return launches


def granite_paths(name):
    """granite-moe-1b-a400m at full width and half depth (GRANITE_PATHS: 12
    of its 24 layers, 32 experts top-8, seeded random weights, packed int4
    on the card and the fp32 tree dropped): serve_scheduled (#3, #4, #13
    and 24 of #11 per decode step at k and o), then device-data training
    at N = 16
    (#9, #10, #7, #8 at q and v, #11 and #12 at k and o; DD_TRAIN)."""
    dev = torch.device("cuda")
    _free()
    torch.cuda.reset_peak_memory_stats(dev)
    model, params, bank = serving_model(GRANITE_PATHS, dev)
    params = quantize_tree(params, "int4", QUANT_GROUP)
    _free()
    sched_path(name, model, params, bank, "int4", profile=False)
    del model, bank
    _free()
    device_data_train_path(name, GRANITE_PATHS, dev, params, **DD_TRAIN)
    del params
    _free()
    _peak("granite-moe scheduled serving and device-data training", dev)


# ------------------------------------------------- 25. the xLSTM family

XLSTM = get_config("xlstm-1.3b")
# With whisper-medium's phase 26 the script no longer fits its time on one
# card: xlstm-1.3b's paths run at half depth (24 of its 48 layers: 12 mLSTM
# and 12 sLSTM blocks), at full width, as LLAMA_PATHS does for llama2-7b
XLSTM_PATHS = dataclasses.replace(XLSTM, num_layers=24)
# training: 4 clients x 1 local step of 4 x 128, one round (a local step
# runs the sLSTM's 128-step loop forward and back in 24 layers, seconds on
# the host).  One round: at random init the 48-layer stack's gradient norm
# is O(1e5) (it grows with depth, in the JAX package as here), so a round of
# SGD at lr 5e-3 throws B to O(100), and a second round would hold two
# tiers whose adapters already part, not the kernels.  So that the one
# compared step runs every rank term (a zero B zeroes #5's and #6's and all
# of #7), B starts at std 0.02, as the serving tenants' does.
XLSTM_TRAIN = dict(local_steps=1, rounds=1, b0=0.02)


def xlstm_paths(name):
    """xlstm-1.3b at full width and half depth (XLSTM_PATHS: 24 of its 48
    layers, d_model 2048, 4 heads of 512; seeded random weights), every
    earlier model freed first: generate_banked (24 of #2 per prefill, 24
    of #1 per decode step), serve_scheduled over the fp32 base (per-slot
    mLSTM and sLSTM state drawn fresh at each admission; no #13, nothing
    packed; not profiled: run_path profiles the same prefill and decode),
    and training (train_path: 24 of each of #5-#8 per client local step;
    XLSTM_TRAIN), with peak memory."""
    dev = torch.device("cuda")
    _free()
    torch.cuda.reset_peak_memory_stats(dev)
    run_path(name, XLSTM_PATHS, dev)
    _peak("xlstm-1.3b fixed-batch serving", dev)
    _free()
    model, params, bank = serving_model(XLSTM_PATHS, dev)
    sched_path(name, model, params, bank, "fp32", profile=False)
    _peak("xlstm-1.3b scheduled serving", dev)
    del model, bank
    _free()
    # serving_model draws the base first from seed 0, as train_base does
    launches, _, _ = train_path(name, XLSTM_PATHS, dev, params=params,
                                **XLSTM_TRAIN)
    del params
    _free()
    _peak("xlstm-1.3b training", dev)
    return launches


# -------------------------------------- 26. the audio encoder-decoder

WHISPER = get_config("whisper-medium")
# #3, #4 and #11 at whisper-medium's MLP (k, n): the int4 serving path runs
# #11 there every decode step and admission, the encoder over a packed base
# at m = 4 x 1500 frames; #3 / #4 are held and timed there too
WHISPER_MLP = {"whisper w_up": (WHISPER.d_model, WHISPER.d_ff),
               "whisper w_down": (WHISPER.d_ff, WHISPER.d_model)}
WHISPER_M = (4, 512, 4 * WHISPER.encoder_frames)
# #13 (label, query heads, kv heads, head_dim): the decoder's self-attention
WHISPER_PAGED = ((WHISPER.name, WHISPER.num_heads, WHISPER.num_kv_heads,
                  WHISPER.head_dim),)
# With paligemma-3b's and roberta-large's phases the script no longer fits
# its time on one card: whisper-medium's paths run at half depth (12 decoder
# and 12 encoder layers), at full width, as XLSTM_PATHS does for xlstm-1.3b
WHISPER_PATHS = dataclasses.replace(WHISPER, num_layers=12, encoder_layers=12)
# training through FederatedTrainer.round_step: N clients x 1 local step of
# 4 x 128 tokens and 4 x 1500 frames each, 2 rounds
WHISPER_TRAIN = dict(clients=4, local_steps=1, rounds=2, batch=4, seq=128)


def check_whisper_kernels(dev="cuda"):
    """The kernels at whisper-medium's new shapes, fp32 and bf16, against
    their plain versions: #13 at WHISPER_PAGED (160 positions, 10 columns
    of 16, with and without a window of 64); #11 at WHISPER_MLP with m =
    4, 512 and 6000 and #3 / #4 there (a rank 8 bank, 4 requests of 128
    rows / one row), over int8 and int4 (group 64)."""
    phase("whisper-medium's shapes vs plain (tolerance: |kernel - plain| "
          f"<= {KERNEL_RTOL} * max(1, max|plain|), + {BF16_STEP} * |plain| "
          "for a bf16 output)")
    gen = torch.Generator(dev).manual_seed(26)
    worst = {}
    dts = (torch.float32, torch.bfloat16)

    def note(kern, err):
        worst[kern] = max(worst.get(kern, 0.0), err)

    for label, h, kh, hd in WHISPER_PAGED:
        q, kp, vp, *rest = _paged_case(gen, 4, h, kh, hd, 16, 10, dev=dev)
        for dt, window in itertools.product(dts, (None, 64)):
            args = [t.to(dt) for t in (q, kp, vp)] + rest
            got = paged_attention.paged_attention(*args, window=window)
            again = paged_attention.paged_attention(*args, window=window)
            assert torch.equal(got, again), f"#13 {label}: two calls differ"
            note("paged_attention", _err(
                "paged_attention",
                f"{label} B4 h{h} kh{kh} hd{hd} bs16 mb10 {str(dt)[6:]} "
                f"w={window}", got,
                paged_attention.paged_attention_plain(*args, window=window)))
    for (mode, bits), (label, (k, n)) in itertools.product(
            (("int8", 8), ("int4", 4)), WHISPER_MLP.items()):
        wq = quantize(torch.randn(k, n, generator=gen, device=dev)
                      * k ** -0.5, bits, QUANT_GROUP)
        for m, dt in itertools.product(WHISPER_M, dts):
            x = torch.randn(m, k, generator=gen, device=dev).to(dt)
            lab = f"{mode} {label} m={m} k={k} n={n} {str(dt)[6:]}"
            got = lora_matmul.quant_matmul(x, wq)
            assert torch.equal(got, lora_matmul.quant_matmul(x, wq)), \
                f"#11 {lab}: two calls differ"
            note("quant_matmul", _err("quant_matmul", lab, got,
                                      lora_matmul.quant_matmul_plain(x, wq)))
        for s_, dt in itertools.product((1, 128), dts):
            x, _, a, b, ids = _bank(gen, 4, s_, k, n, 4, (8,) * 4, dt)
            lab = f"{mode} {label} B=4 s={s_} k={k} n={n} {str(dt)[6:]}"
            if s_ == 1:
                x1 = x[:, 0].contiguous()
                note("bgmv_gemv_quant", _err(
                    "bgmv_gemv_quant", lab,
                    bgmv.bgmv_gemv_quant(x1, wq, a, b, ids),
                    bgmv.bgmv_gemv_quant_plain(x1, wq, a, b, ids)))
            else:
                note("bgmv_matmul_quant", _err(
                    "bgmv_matmul_quant", lab,
                    bgmv.bgmv_matmul_quant(x, wq, a, b, ids),
                    bgmv.bgmv_matmul_quant_plain(x, wq, a, b, ids)))
        del wq
    return worst


def time_whisper_kernels(block_size=16, ring=160):
    """Times at whisper-medium's new shapes (time_sched_kernels): #13 at
    WHISPER_PAGED over the scheduled path's 10 columns, #11 at WHISPER_MLP
    with m = 4, 512 and 6000, #3 and #4 there at m = 512 and 4."""
    mb = -(-ring // block_size)
    return time_sched_kernels(
        block_size, ring, projs=WHISPER_MLP,
        paged=[(label, h, mb, None, kh, hd)
               for label, h, kh, hd in WHISPER_PAGED],
        adapted=tuple(WHISPER_MLP), rows_m=WHISPER_M)


def _frames(cfg, n, device, seed):
    """(n, frames, d_model) seeded stub frames (the mel / conv frontend's
    output, a stub in the JAX package too)."""
    return torch.randn(n, cfg.encoder_frames, cfg.d_model, device=device,
                       generator=torch.Generator(device).manual_seed(seed))


def _timed(fn, device):
    """(fn's result, its host wall ms with the device synchronized)."""
    _sync(device)
    t = time.monotonic()
    out = fn()
    _sync(device)
    return out, (time.monotonic() - t) * 1e3


def encoder_path(name, model, params, bank, *, steps=32, plen=128):
    """The path a whisper user runs, through the model API (the serve CLI
    runs the decoder alone, as JAX's does): ``Model._encode`` over 4 x 1500
    seeded frames, ``prefill(enc_out=)`` under the 4-tenant bank, then
    ``steps - 1`` banked greedy decode steps on the kernel tier (counted:
    #2 and #1 only; the encoder and the cross K/V are plain matmuls over an
    fp32 base); the plain tier teacher-forced on its tokens, logits within
    LOGIT_ATOL; a control without ``enc_out`` that must move the logits by
    far more than that; the encoder once more over an int4 base (#11 at m
    = 6000, 6 a layer) against the plain tier.  Prints the encoder's and
    the prefill's ms, ms per decode step, a profile of the encoder and of
    4 decode steps, and peak memory.  ``model`` may be a reduced config on
    a CPU (the counts and the profile hold only on the card)."""
    cfg = model.cfg
    device = tree_leaves(params)[0].device
    n = bank.size
    phase(f"encoder path: Model._encode over {n} x {cfg.encoder_frames} "
          f"frames, prefill(enc_out=) of {n} x {plen} tokens, {steps} greedy "
          f"tokens, {cfg.name} d_model {cfg.d_model}, fp32 base")
    ids = torch.arange(n, device=device, dtype=torch.int32)
    prompt = torch.randint(0, cfg.vocab_size, (n, plen),
                           generator=torch.Generator(device).manual_seed(1),
                           device=device)
    frames = _frames(cfg, n, device, 3)
    adapters = bank.requests(ids)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with torch.inference_mode():
        model._encode(params, {"frames": frames})         # warm
        _reset_launches()
        enc_out, enc_ms = _timed(
            lambda: model._encode(params, {"frames": frames}), device)
        assert not any(_launch_counts().values()), _launch_counts()
        assert bool(torch.isfinite(enc_out).all())

        def greedy(enc, forced=None, plain=False):
            """Greedy decode (or teacher-forced on ``forced``) after a
            prefill with ``enc``: (tokens (n, steps), logits, prefill ms,
            decode ms a step)."""
            with (dispatch.plain_tier() if plain
                  else contextlib.nullcontext()):
                cache = model.init_cache(n, plen + steps, device=device)
                (lg, cache), pre_ms = _timed(lambda: model.prefill(
                    params, cache, prompt, adapters, enc_out=enc,
                    last_only=True), device)
                out, toks = [lg[:, -1]], [lg[:, -1, :cfg.vocab_size]
                                          .argmax(-1)]
                _sync(device)
                t = time.monotonic()
                for i in range(steps - 1):
                    tok = (toks[-1] if forced is None
                           else forced[:, i])[:, None]
                    pos = torch.full((n,), plen + i, device=device)
                    lg, cache = model.decode_step(params, cache, tok, pos,
                                                  adapters)
                    out.append(lg[:, -1])
                    toks.append(lg[:, -1, :cfg.vocab_size].argmax(-1))
                _sync(device)
                dec_ms = (time.monotonic() - t) * 1e3 / (steps - 1)
            return (torch.stack(toks, 1),
                    torch.stack(out, 1)[..., :cfg.vocab_size], pre_ms,
                    dec_ms)

        # the counted run: counts to 0 just before, read just after
        _reset_launches()
        toks, kern, pre_ms, dec_ms = greedy(enc_out)
        launches = _launch_counts()
        n_ad = _n_adapted(bank)
        expect = dict.fromkeys(launches, 0)
        expect.update(bgmv_matmul=n_ad, bgmv_gemv=n_ad * (steps - 1))
        print(f"launches: { {k: v for k, v in launches.items() if v} } "
              f"(expected { {k: v for k, v in expect.items() if v} }: "
              f"{n_ad} of #2 per prefill, {n_ad} of #1 per decode step; "
              "none in the encoder or the cross K/V)")
        assert launches == expect, (launches, expect)
        assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
        _, plain, _, _ = greedy(enc_out, forced=toks, plain=True)
        diff = float((kern - plain).abs().max())
        ties = [(i, t) for i, t in zip(*torch.nonzero(
            plain.argmax(-1) != toks, as_tuple=True))]
        print(f"kernel vs plain tier (plain teacher-forced on the kernel "
              f"tier's {steps} greedy tokens): logits max |diff| {diff:.3e}, "
              f"max |logit| {float(plain.abs().max()):.3f}, tolerance "
              f"{LOGIT_ATOL}; tokens whose plain-tier argmax differs: "
              f"{len(ties)}")
        for i, t in ties:
            top2 = plain[i, t].topk(2).values
            margin = float(top2[0] - top2[1])
            print(f"  near-tie: request {int(i)} token {int(t)}, plain-tier "
                  f"top-2 margin {margin:.3e}")
            assert margin < LOGIT_ATOL, (int(i), int(t), margin)
        assert diff <= LOGIT_ATOL, diff
        # the control: the same prompt without enc_out (zero cross K/V)
        ctrl = greedy(None, forced=toks)[1]
        moved = float((ctrl - kern).abs().max())
        print(f"control, the same prompt without enc_out: logits move by "
              f"max |diff| {moved:.3e} ({moved / LOGIT_ATOL:.1f}x the "
              "tolerance): the encoder output is live")
        assert moved > 100 * LOGIT_ATOL, moved
        del ctrl, plain, kern
        print(f"encoder path on {name}: encoder {enc_ms:.1f} ms for "
              f"{n} x {cfg.encoder_frames} frames ({cfg.encoder_layers} "
              f"layers); prefill with enc_out {pre_ms:.1f} ms; decode "
              f"{dec_ms:.2f} ms/step over {steps - 1} steps of batch {n}")
        if device.type == "cuda":
            _peak("whisper encoder path", device)
            phase("where the time goes (torch.profiler; the encoder, and 4 "
                  "decode steps reading the cached cross K/V)")
            _print_profile("encoder", *_profiled(
                lambda: model._encode(params, {"frames": frames})), 1,
                "encoder call")
            cache = model.init_cache(n, plen + 4, device=device)
            model.prefill(params, cache, prompt, adapters, enc_out=enc_out,
                          last_only=True)

            def decode():
                for i in range(4):
                    pos = torch.full((n,), plen + i, device=device)
                    model.decode_step(params, cache, toks[:, i:i + 1], pos,
                                      adapters)

            _print_profile("decode (cross-attending 1500 cached frames)",
                           *_profiled(decode), 4, "step")
            del cache

        # the encoder over an int4 base: #11 at m = n x frames
        phase(f"encoder over an int4 base (group {QUANT_GROUP}): #11 at m = "
              f"{n * cfg.encoder_frames}")
        packed = quantize_tree(params, "int4", QUANT_GROUP)
        model._encode(packed, {"frames": frames})         # warm
        _reset_launches()
        enc_q, q_ms = _timed(
            lambda: model._encode(packed, {"frames": frames}), device)
        launches = {k: v for k, v in _launch_counts().items() if v}
        want = {"quant_matmul": 6 * cfg.encoder_layers}
        print(f"launches: {launches} (expected {want}: q, k, v, o, w_up, "
              "w_down of every encoder layer)")
        assert launches == want, launches
        with dispatch.plain_tier():
            enc_qp = model._encode(packed, {"frames": frames})
        diff = float((enc_q - enc_qp).abs().max())
        scale = max(1.0, float(enc_qp.abs().max()))
        print(f"int4 encoder, kernel vs plain tier: max |diff| {diff:.3e}, "
              f"max |output| {scale:.3f}, tolerance {LOGIT_ATOL} x max(1, "
              f"max|output|); {q_ms:.1f} ms (fp32 base {enc_ms:.1f} ms)")
        assert diff <= LOGIT_ATOL * scale, diff
        del packed, enc_q, enc_qp, enc_out
    return dict(encoder_ms=enc_ms, prefill_ms=pre_ms, decode_ms=dec_ms)


def _unread_nodes(tree, path=()):
    """(path, {"a", "b"}) of every adapter node no projection reads: the
    encoder's (``_encode`` takes none) and ``cross/v`` (nor does
    ``build_cross_kv``)."""
    if set(tree) == {"a", "b"}:
        if path[0] == "encoder" or path[-2:] == ("cross", "v"):
            yield path, tree
        return
    for k in sorted(tree):
        yield from _unread_nodes(tree[k], path + (k,))


def _side_batch(cfg, lead, device, gen):
    """(key, tensor) of the batch leaf a family's forward reads beside the
    tokens: whisper's stub frames (lead + (1500, d_model)) or paligemma's
    stub SigLIP patches (lead + (256, 1152)), seeded."""
    if cfg.family == "audio":
        return "frames", torch.randn(*lead, cfg.encoder_frames, cfg.d_model,
                                     generator=gen, device=device)
    return "patches", torch.randn(*lead, cfg.num_patches, PATCH_EMBED_DIM,
                                  generator=gen, device=device)


def round_step_train_path(name, cfg, device, params, *, clients=4, rank=64,
                          local_steps=1, rounds=2, batch=4, seq=128,
                          chunked=False):
    """FederatedTrainer.round_step over caller-supplied batches (the JAX
    package's only training entry for whisper's frames and paligemma's
    patches; its train CLI, as the port's, fails for want of them): fedsa
    + sfedlora, ``clients`` clients x ``local_steps`` steps of ``batch`` x
    ``seq`` tokens and ``batch`` seeded frames or patches, ``rounds``
    rounds; launch counts of #5-#8; whisper's unread adapter nodes (the
    encoder's, cross v) None to autograd (exact zeros in the client loop)
    and their B exactly 0.0 after the rounds; a bit-identical repeat, the
    plain tier within TRAIN_RTOL, ms/round, peak memory and a profile of
    one local step.  ``chunked``: the counted run once more with the
    ``chunked_ce`` switch on (the same launches), its loss and grad-norm
    within CHUNKED_RTOL of the counted run's.  ``cfg`` and ``device`` are
    arguments so the phase can be rehearsed on a CPU at a reduced size.
    Returns the launch counts and the first run's history."""
    model = build_model(cfg)
    gen = torch.Generator(device).manual_seed(5)
    data = []
    for _ in range(rounds):
        toks = torch.randint(0, cfg.vocab_size,
                             (clients, local_steps, batch, seq),
                             generator=gen, device=device)
        key, side = _side_batch(cfg, (clients, local_steps, batch), device,
                                gen)
        data.append({"tokens": toks, key: side})
    phase(f"training path: FederatedTrainer.round_step, {cfg.name} d_model "
          f"{cfg.d_model}, fp32 base, N={clients}, fedsa + sfedlora, rank "
          f"{rank}, {local_steps} local step(s) of {batch} x {seq} tokens + "
          f"{batch} x {side.shape[-2]} {key}, {rounds} rounds")
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

    def run(tr):
        aset, opt, hist, ms = tr.adapters, tr.opt_state, [], []
        for r in range(rounds):
            (aset, opt, m), t = _timed(lambda: tr.round_step(
                tr.base, aset, opt, data[r], r), device)
            hist.append({k: float(v) for k, v in m.items()})
            ms.append(t)
        return aset, hist, ms

    tr1 = trainer()
    print(f"gamma = alpha*sqrt(N/r) = {tr1.gamma:.4f}; {clients} clients x "
          f"{local_steps} local step(s) per round, {rounds} rounds")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    n_adapted = _proj_counts(cfg)[0]
    r_ad = _recompute_counts(cfg)[0]
    steps = clients * local_steps * rounds

    def counted(tr, label):
        """run(tr) with the counts at 0 just before, checked just after:
        n_adapted of each of #5-#8 per client local step, and #5 again in
        the recompute."""
        _reset_launches()
        dispatch.reset_stats()
        out = run(tr)
        launches = _launch_counts()
        expect = dict.fromkeys(launches, 0)
        expect.update({k: n_adapted * steps for k in LORA_KERNELS})
        expect["lora_fwd"] += r_ad * steps
        print(f"launches ({label} run): "
              f"{ {k: v for k, v in launches.items() if v} } (expected "
              f"{ {k: v for k, v in expect.items() if v} }: {n_adapted} of "
              f"each of #5-#8 and {r_ad} more of #5 in the recompute per "
              f"client local step x {steps}); dispatch {dispatch.stats}")
        assert launches == expect, (launches, expect)
        return launches, out

    # the counted run: counts to 0 just before, read just after
    launches, (a1, h1, ms1) = counted(tr1, "counted")
    if device.type == "cuda":
        _peak(f"{cfg.name} training, the counted run", device)
    for r, h in enumerate(h1):
        print(f"round {r + 1}: loss {h['loss']:.6f}, grad_norm "
              f"{h['grad_norm']:.6e}")
        assert math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
    unread = list(_unread_nodes(a1.lora))
    b_read = max(float(t.abs().max()) for t in tree_leaves(
        split_ab(a1.lora)[1]))
    if unread:
        b_unread = max(float(node["b"].abs().max()) for _, node in unread)
        print(f"after {rounds} rounds: max |B| {b_read:.4e}; the "
              f"{len(unread)} unread adapter nodes (the encoder's q / v, "
              f"cross v) max |B| {b_unread}")
        assert b_unread == 0.0
    else:
        print(f"after {rounds} rounds: max |B| {b_read:.4e}; every adapter "
              "node is read")
    assert b_read > 0

    # autograd reaches no unread leaf: the client loop's gradient there is
    # an exact zero, as jax.grad gives it
    leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      federated._client(a1.lora, 0))
    one = {k: v[0, 0] for k, v in data[0].items()}
    loss, _ = model.loss(tr1.base, one, adapters=AdapterSet(
        lora=leaves, gamma=tr1.gamma))
    grads = torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=True)
    n_none = sum(g is None for g in grads)
    print(f"one local step's gradient: {n_none} of {len(grads)} leaves "
          f"unreached by autograd (exact zeros in the client loop; expected "
          f"{2 * len(unread)}, the a and b of every unread node)")
    assert n_none == 2 * len(unread), n_none
    del loss, grads, leaves

    # the same run again: bit for bit
    a2, h2, ms2 = run(trainer())
    same = h1 == h2 and all(torch.equal(x, y) for x, y in zip(
        tree_leaves(a1.lora), tree_leaves(a2.lora)))
    print(f"second kernel-tier run: trajectory and adapters "
          f"{'bit-identical' if same else 'DIFFER'}")
    assert same, "two kernel-tier runs differ"

    # the plain tier on the same device
    _reset_launches()
    with dispatch.plain_tier():
        a3, h3, _ = run(trainer())
    assert not any(_launch_counts().values()), _launch_counts()
    worst = 0.0
    for r, (hk, hp) in enumerate(zip(h1, h3)):
        for key in ("loss", "grad_norm"):
            d = abs(hk[key] - hp[key])
            rel = d / max(abs(hp[key]), 1e-30)
            worst = max(worst, rel)
            print(f"round {r + 1} {key}: kernel {hk[key]:.8g}, plain "
                  f"{hp[key]:.8g}, |diff| {d:.3e} (relative {rel:.3e})")
    db = max(float((x - y).abs().max()) for x, y in zip(
        tree_leaves(a1.lora), tree_leaves(a3.lora)))
    print(f"kernel vs plain tier: worst relative diff of loss and grad_norm "
          f"{worst:.3e} (bound {TRAIN_RTOL}); max |adapter diff| {db:.3e}")
    assert worst <= TRAIN_RTOL
    if chunked:
        # the counted run's rounds with the chunked CE: the same kernels,
        # the loss and grad-norm within CHUNKED_RTOL
        opts.set_opts(["chunked_ce"])
        try:
            _, (_, h4, ms4) = counted(trainer(), "chunked_ce")
        finally:
            opts.reset()
        worst = max(abs(hk[key] - hc[key]) / max(abs(hk[key]), 1e-30)
                    for hk, hc in zip(h1, h4) for key in ("loss",
                                                         "grad_norm"))
        print(f"chunked_ce on vs off (kernel tier): worst relative diff of "
              f"loss and grad_norm {worst:.3e} (bound {CHUNKED_RTOL}); "
              f"ms/round {[round(t, 1) for t in ms4]}")
        assert worst <= CHUNKED_RTOL, worst
    print(f"training path on {name} (round_step, fp32 base): ms/round "
          f"{[round(t, 1) for t in ms1]} (first run), "
          f"{[round(t, 1) for t in ms2]} (second run); "
          f"{clients * local_steps} client local steps per round")
    if device.type == "cuda":
        tr1.lora = a1.lora
        profile_local_step(model, tr1, batches={k: v[0] for k, v in
                                                data[0].items()})
    del tr1, a1, a2, a3, data
    return launches, h1


def whisper_paths(name):
    """whisper-medium at full width and half depth (WHISPER_PATHS: 12 of
    its 24 decoder xattn layers, 12 of its 24 encoder layers, d_model 1024,
    16 heads of 64; seeded random weights), every earlier model freed
    first: generate_banked as the serve CLI runs it (the decoder alone, no
    encoder output: 36 of #2 per prefill, 36 of #1 per decode step);
    encoder_path (the encoder over 4 x 1500 frames, prefill(enc_out=),
    banked decode, its control, the encoder over int4); serve_scheduled
    over fp32 (12 of #13 per decode step) and int4 (#3, #4, #11 as well;
    per-slot cross K/V of 295 MB merged at each admission; not profiled:
    run_path profiles the same decode); and round_step_train_path
    (WHISPER_TRAIN), with peak memory."""
    dev = torch.device("cuda")
    _free()
    torch.cuda.reset_peak_memory_stats(dev)
    fixed = run_path(name, WHISPER_PATHS, dev)
    _peak("whisper-medium fixed-batch serving (decoder alone)", dev)
    _free()
    model, params, bank = serving_model(WHISPER_PATHS, dev)
    encoder_path(name, model, params, bank)
    _free()
    sched = {}
    for mode in ("fp32", "int4"):
        sched[mode], _ = sched_path(name, model, params, bank, mode,
                                    profile=False)
        _free()
    _peak("whisper-medium scheduled serving", dev)
    del model, bank
    _free()
    # serving_model draws the base first from seed 0, as train_base does
    train, _ = round_step_train_path(name, WHISPER_PATHS, dev, params,
                                     **WHISPER_TRAIN)
    del params
    _free()
    _peak("whisper-medium training", dev)
    return fixed, sched, train


# ------------------------------------------------- 27. paligemma-3b

PALIGEMMA = get_config("paligemma-3b")
# the paths at half depth (phase 31's cut: it was the costliest path
# still at full depth); the kernel phases keep the full widths
PALIGEMMA_PATHS = dataclasses.replace(PALIGEMMA, num_layers=9)
# training through FederatedTrainer.round_step: N clients x 1 local step of
# 4 x (256 patches + 128 tokens) each, 2 rounds; then those rounds with the
# chunked CE
VLM_TRAIN = dict(clients=4, local_steps=1, rounds=2, batch=4, seq=128)
# the chunked CE's memory step: 4 x (256 patches + CE_TEXT tokens); the
# CE_TEXT - 1 predicting positions make 3 chunks of 512, the last ragged
CE_TEXT = 1100


def vision_prefix_path(name, model, params, bank, *, plen=128):
    """Model.forward over 4 seeded requests of 256 stub patches and
    ``plen`` tokens under the 4-tenant bank, one tenant a row: the
    patches projected by ``patch_proj`` (a plain matmul, as in JAX) and
    prepended, RoPE and the causal mask over all 256 + ``plen``
    positions, each adapted projection once as #2 over the 4 x (256 +
    ``plen``) rows; the plain tier's logits within LOGIT_ATOL; a control
    with the patches zeroed that must move the text's logits by far more
    than that.  Prints the forward's ms, its profile and peak memory.
    ``model`` may be a reduced config on a CPU."""
    cfg = model.cfg
    device = tree_leaves(params)[0].device
    n = bank.size
    phase(f"vision-prefix forward: Model.forward over {n} x "
          f"({cfg.num_patches} patches + {plen} tokens), {cfg.name} d_model "
          f"{cfg.d_model}, banked adapters, fp32 base")
    gen = torch.Generator(device).manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (n, plen), generator=gen,
                         device=device)
    _, patches = _side_batch(cfg, (n,), device, gen)
    batch = {"tokens": toks, "patches": patches}
    adapters = bank.requests(torch.arange(n, device=device,
                                          dtype=torch.int32))
    v = cfg.vocab_size
    with torch.inference_mode():
        model.forward(params, batch, adapters)             # warm
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        # the counted run: counts to 0 just before, read just after
        _reset_launches()
        (kern, _), ms = _timed(lambda: model.forward(params, batch,
                                                     adapters), device)
        launches = _launch_counts()
        n_ad = _n_adapted(bank)
        expect = dict.fromkeys(launches, 0)
        expect["bgmv_matmul"] = n_ad
        print(f"launches: { {k: x for k, x in launches.items() if x} } "
              f"(expected { {k: x for k, x in expect.items() if x} }: "
              f"{n_ad} of #2, each adapted projection once over "
              f"{n} x {cfg.num_patches + plen} rows)")
        assert launches == expect, (launches, expect)
        assert tuple(kern.shape) == (n, cfg.num_patches + plen,
                                     model.vocab_padded)
        with dispatch.plain_tier():
            plain, _ = model.forward(params, batch, adapters)
        diff = float((kern[..., :v] - plain[..., :v]).abs().max())
        scale = float(plain[..., :v].abs().max())
        print(f"kernel vs plain tier: logits over every position max |diff| "
              f"{diff:.3e}, max |logit| {scale:.3f}, tolerance {LOGIT_ATOL}")
        assert diff <= LOGIT_ATOL, diff
        del plain
        ctrl, _ = model.forward(params, {**batch, "patches":
                                         torch.zeros_like(patches)},
                                adapters)
        moved = float((ctrl[:, -plen:, :v] - kern[:, -plen:, :v])
                      .abs().max())
        print(f"control, the patches zeroed: the text's logits move by max "
              f"|diff| {moved:.3e} ({moved / LOGIT_ATOL:.1f}x the "
              "tolerance): the prefix is live")
        assert moved > 100 * LOGIT_ATOL, moved
        del ctrl, kern
        print(f"vision-prefix forward on {name}: {ms:.1f} ms for {n} x "
              f"({cfg.num_patches} + {plen}) positions")
        if device.type == "cuda":
            _peak(f"{cfg.name} vision-prefix forward", device)
            phase("where the time goes (torch.profiler; one vision-prefix "
                  "forward)")
            _print_profile("vision-prefix forward", *_profiled(
                lambda: model.forward(params, batch, adapters)), 1,
                "forward")
    return dict(ms=ms)


def chunked_ce_memory(name, model, params, *, batch=4, text=CE_TEXT,
                      rank=64):
    """One local step (the loss and its LoRA gradient, a rank-64 SFed-LoRA
    set with B drawn at std 0.02) over ``batch`` x (256 patches + ``text``
    tokens), with the ``chunked_ce`` switch off and then on: the same
    launches of #5-#8, the loss and every gradient within CHUNKED_RTOL,
    and the peak memory of each step above what was resident before it.
    Off, the step holds the (batch, text - 1, V) fp32 logits and their
    gradient; on, one chunk's, recomputed in the backward; so the chunked
    step must peak lower.  ``model`` may be a reduced config on a CPU (the
    peaks are then not measured)."""
    cfg = model.cfg
    device = tree_leaves(params)[0].device
    sl = text - 1
    c = min(512, sl)
    phase(f"chunked CE: one local step over {batch} x ({cfg.num_patches} "
          f"patches + {text} tokens), {cfg.name}, chunked_ce off then on "
          f"({sl} predicting positions: {-(-sl // c)} chunks of {c}, the "
          f"last {sl - (sl - 1) // c * c})")
    gen = torch.Generator(device).manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (batch, text), generator=gen,
                         device=device)
    _, patches = _side_batch(cfg, (batch,), device, gen)
    data = {"tokens": toks, "patches": patches}
    lcfg = LoRAConfig(rank=rank, alpha=8.0, scaling="sfedlora",
                      targets=cfg.lora_targets)
    aset = init_adapter_set(params, gen, lcfg, n_clients=4)
    lora = _nonzero_b(aset.lora, gen, 0.02)
    n_ad = _proj_counts(cfg)[0]
    print(f"the unchunked logits: {batch * sl * model.vocab_padded * 4 / 1e9:.2f}"
          f" GB fp32 ({batch} x {sl} x {model.vocab_padded}); a chunk's "
          f"{batch * c * model.vocab_padded * 4 / 1e9:.2f} GB")

    def step():
        leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                          lora)
        loss, _ = model.loss(params, data, adapters=AdapterSet(
            lora=leaves, gamma=aset.gamma))
        return loss.detach(), torch.autograd.grad(loss, tree_leaves(leaves))

    out = {}
    for on in (False, True):
        if on:
            opts.set_opts(["chunked_ce"])
        try:
            gc.collect()
            resident = 0
            if device.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
                resident = torch.cuda.memory_allocated(device)
            _reset_launches()
            (loss, grads), ms = _timed(step, device)
            launches = _launch_counts()
        finally:
            opts.reset()
        expect = dict.fromkeys(launches, 0)
        expect.update({k: n_ad for k in LORA_KERNELS})
        expect["lora_fwd"] += _recompute_counts(cfg)[0]
        assert launches == expect, (launches, expect)
        peak = (torch.cuda.max_memory_allocated(device) - resident
                if device.type == "cuda" else None)
        label = "on" if on else "off"
        print(f"chunked_ce {label}: loss {float(loss):.8g}, {ms:.1f} ms, "
              f"launches { {k: x for k, x in launches.items() if x} }; "
              + ("peak memory not measured (not on the card)"
                 if peak is None else
                 f"peak device memory above the resident "
                 f"{resident / 1e9:.2f} GB: {peak / 1e9:.2f} GB "
                 "(torch.cuda.max_memory_allocated)"))
        out[on] = (loss, grads, peak, ms)
        del loss, grads
    (l0, g0, p0, _), (l1, g1, p1, _) = out[False], out[True]
    dl = abs(float(l1 - l0)) / abs(float(l0))
    dg = max(float((x - y).abs().max()) / max(float(x.abs().max()), 1e-30)
             for x, y in zip(g0, g1))
    print(f"chunked vs plain CE: loss relative diff {dl:.3e}, gradients "
          f"worst max|diff| / max|grad| {dg:.3e} (bound {CHUNKED_RTOL})")
    assert dl <= CHUNKED_RTOL and dg <= CHUNKED_RTOL, (dl, dg)
    if p0 is not None:
        print(f"chunked CE on {name}: peak {p1 / 1e9:.2f} GB against "
              f"{p0 / 1e9:.2f} GB unchunked ({(p0 - p1) / 1e9:.2f} GB less)")
        assert p1 < p0, (p1, p0)
    return dict(peak_off=p0, peak_on=p1)


def paligemma_paths(name):
    """paligemma-3b at full width and half depth (PALIGEMMA_PATHS: 9 of
    18 layers, d_model 2048, 8 heads on one kv head of 256, GeGLU 16384,
    vocab 257216 padded to 257280, patch_proj 1152 x 2048; seeded random
    weights), every earlier model freed first: generate_banked as the
    serve CLI runs it (text only, as JAX serves it: 18 of #2 per prefill,
    18 of #1 per decode step); vision_prefix_path; round_step_train_path
    over patches (VLM_TRAIN: 18 of each of #5-#8 per client local step and
    18 more of #5 in the recompute, then the same rounds with the chunked
    CE); chunked_ce_memory; with peak memory."""
    dev = torch.device("cuda")
    _free()
    torch.cuda.reset_peak_memory_stats(dev)
    fixed = run_path(name, PALIGEMMA_PATHS, dev)
    _peak("paligemma-3b fixed-batch serving (text only)", dev)
    _free()
    model, params, bank = serving_model(PALIGEMMA_PATHS, dev)
    vision_prefix_path(name, model, params, bank)
    del bank
    _free()
    # serving_model draws the base first from seed 0, as train_base does
    train, _ = round_step_train_path(name, PALIGEMMA_PATHS, dev, params,
                                     chunked=True, **VLM_TRAIN)
    _free()
    _peak("paligemma-3b training", dev)
    chunked_ce_memory(name, model, params)
    del model, params
    _free()
    return fixed, train


# ------------------------------------------------- 28. roberta-large

ROBERTA = get_config("roberta-large")
# with phase 29 the script no longer fits its time: roberta's paths run at
# half depth (12 of its 24 layers), at full width, since phase 29
ROBERTA_PATHS = dataclasses.replace(ROBERTA, num_layers=12)
# the accuracy table's encoder setting (benchmarks/tab12_accuracy.py tab2)
ROBERTA_TRAIN = dict(opt="adamw", lr=3e-3, partition="dirichlet")


def bidirectional_control(model, params, adapters, *, seq=128):
    """On the kernel tier (an AdapterSet: #5 at every adapted projection):
    changing the last token of a sequence must move position 0's logits
    (a causal forward would leave them exactly)."""
    cfg = model.cfg
    device = tree_leaves(params)[0].device
    phase(f"bidirectional control: {cfg.name}, the last of {seq} tokens "
          "changed")
    toks = torch.randint(0, cfg.vocab_size, (2, seq), device=device,
                         generator=torch.Generator(device).manual_seed(8))
    other = toks.clone()
    other[:, -1] = (other[:, -1] + 1) % cfg.vocab_size
    with torch.inference_mode():
        _reset_launches()
        a, _ = model.forward(params, {"tokens": toks}, adapters)
        b, _ = model.forward(params, {"tokens": other}, adapters)
        launches = {k: x for k, x in _launch_counts().items() if x}
    n_ad = _proj_counts(cfg)[0]
    assert launches == {"lora_fwd": 2 * n_ad}, launches
    moved = float((a[:, 0] - b[:, 0]).abs().max())
    print(f"position 0's logits move by max |diff| {moved:.3e} "
          f"({moved / LOGIT_ATOL:.1f}x LOGIT_ATOL; launches {launches}): "
          "the forward attends both ways")
    assert moved > LOGIT_ATOL, moved


def roberta_paths(name):
    """roberta-large at full width and half depth (ROBERTA_PATHS: 12 of
    its 24 layers since phase 29; d_model 1024, 16 heads of 64, LayerNorm,
    GELU 4096, vocab 50265 padded to 50432; seeded random weights), every
    earlier model freed first: generate_banked as the serve CLI runs it
    (causal decode, as in JAX: 24 of #2 per prefill, 24 of #1 per decode
    step); serve_scheduled over fp32 (12 of #13 per decode step);
    bidirectional_control; and train_path with the MLM loss
    (ROBERTA_TRAIN: adamw over a Dirichlet(0.5) partition, 24 of each of
    #5-#8 per client local step), with peak memory."""
    dev = torch.device("cuda")
    _free()
    torch.cuda.reset_peak_memory_stats(dev)
    fixed = run_path(name, ROBERTA_PATHS, dev)
    _peak("roberta-large fixed-batch serving (causal decode)", dev)
    _free()
    model, params, bank = serving_model(ROBERTA_PATHS, dev)
    sched, _ = sched_path(name, model, params, bank, "fp32")
    _peak("roberta-large scheduled serving", dev)
    bidirectional_control(model, params, bank.adapter(0))
    del model, bank
    _free()
    train, _, _ = train_path(name, ROBERTA_PATHS, dev, params=params,
                             **ROBERTA_TRAIN)
    del params
    _free()
    _peak("roberta-large training", dev)
    return fixed, sched, train


# ------------------------------------------------------------------ main

# ----------------------------------------------- 29. training on a mesh

# The card is one GPU, and two ranks cannot share it over a model axis:
# NCCL refuses two ranks on one device ("Duplicate GPU detected : rank 1
# and rank 0 both on CUDA device 3b000"), and over gloo the c10d
# collectives on CUDA tensors run but DTensor's all-gather (full_tensor of
# a Shard(1) DTensor) never returned, on an H100 80GB HBM3.  So phase 29
# runs the client axis over two gloo ranks on the card (2x1: no DTensor, one
# all-gather per dtype a round), a 1x1 mesh in this process, and #5-#8 at
# the 1x2 mesh's local shapes (q 2048 -> 1024, v 256 -> 128); the model
# axis trains on the CPU (tests/test_torch_mesh.py).
MESH_TP_CASES = [("q 1x2", 512, 2048, 1024, 64, 64),
                 ("v 1x2", 512, 2048, 128, 64, 64)]
MESH_TP_PROJS = (("q 1x2", 1024), ("v 1x2", 128))
MESH_ROUNDS = 3                  # phase 6's
MESH_TIMEOUT_S = 300


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _mesh_trainer(cfg, device, params, mesh, rank=64, seq=128):
    """Phase 6's trainer (train_path's, track_stability on) on ``mesh``;
    ``rank`` and ``seq`` as phase 6 ran them."""
    return federated.FederatedTrainer(
        build_model(cfg),
        FederatedDataset(cfg.vocab_size, 4, seq_len=seq, batch_per_client=4,
                         seed=0),
        lora_cfg=LoRAConfig(rank=rank, alpha=8.0, scaling="sfedlora",
                            targets=cfg.lora_targets),
        fed_cfg=FederatedConfig(num_clients=4, local_steps=2,
                                rounds=MESH_ROUNDS, aggregation="fedsa"),
        opt_cfg=OptimizerConfig(name="sgd", lr=5e-3), seed=0,
        base_params=params, device=device, mesh=mesh, track_stability=True)


def _mesh_rounds(tr, device):
    """Phase 6's rounds on a mesh trainer, counted and timed."""
    _reset_launches()
    ms = []
    for _ in range(MESH_ROUNDS):
        _sync(device)
        t = time.monotonic()
        tr.run_round()
        _sync(device)
        ms.append((time.monotonic() - t) * 1e3)
    return _launch_counts(), ms


def _mesh_rank(rank, world, port, spec, out, cfg, device, shape):
    """One rank of the 2x1 mesh (a spawned process on the same card)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import mesh_from_spec
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)          # both ranks on the one card
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        tr = _mesh_trainer(cfg, dev, train_base(build_model(cfg), dev),
                           mesh_from_spec(spec, dev), **shape)
        launches, ms = _mesh_rounds(tr, dev)
        res = {"launches": launches, "ms": ms, "history": tr.history,
               "block": tr.mesh_run.block(4)}
        if rank == 0:
            res.update(lora=tree_map(lambda t: t.cpu(), tr.lora),
                       opt=tree_map(lambda t: t.cpu(), tr.opt_state))
        torch.save(res, out / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _same_state(got, sync):
    return got["history"] == sync["history"] and all(
        torch.equal(a.cpu(), b.cpu()) for a, b in zip(
            tree_leaves({"l": got["lora"], "o": got["opt"]}),
            tree_leaves({"l": sync["lora"], "o": sync["opt"]}),
            strict=True))


def mesh_paths(name, cfg, device, sync, sync_ms, *, rank=64, seq=128):
    """Phase 29 against phase 6's run ``sync`` (its ms/round ``sync_ms``):
    FederatedTrainer(mesh=) on a 1x1 mesh here and on a 2x1 mesh of two
    spawned gloo ranks on this card (each trains two of the four clients
    and gathers the rest), both bit for bit phase 6's history, adapters
    and optimizer state, with each rank's #5-#8 launches; then #5-#8 at a
    1x2 mesh's local shapes against their plain versions and timed.
    ``rank`` and ``seq``: phase 6's (a CPU rehearsal passes its own)."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import mesh_from_spec
    phase(f"training on a mesh: FederatedTrainer(mesh=), {cfg.name} d_model "
          f"{cfg.d_model}, 1x1 here and 2x1 over two gloo ranks on this "
          "device, against phase 6's run")
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    n_adapted = _proj_counts(cfg)[0]
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        tr = _mesh_trainer(cfg, device, train_base(build_model(cfg), device),
                           mesh_from_spec("1x1", device), rank=rank, seq=seq)
        launches, ms1 = _mesh_rounds(tr, device)
        got = {"history": tr.history, "lora": tr.lora, "opt": tr.opt_state}
        same = _same_state(got, sync)
    finally:
        dist.destroy_process_group()
    del tr, got
    _free()
    expect = n_adapted * 4 * 2 * MESH_ROUNDS
    fwd = expect + _recompute_counts(cfg)[0] * 4 * 2 * MESH_ROUNDS
    print(f"1x1: launches { {k: launches[k] for k in LORA_KERNELS} } "
          f"(expected {expect} each, #5 {fwd}); ms/round "
          f"{[round(t, 1) for t in ms1]} (phase 6: "
          f"{[round(t, 1) for t in sync_ms]}); history, adapters and "
          f"optimizer state {'bit-identical' if same else 'DIFFER'}")
    assert all(launches[k] == (fwd if k == "lora_fwd" else expect)
               for k in LORA_KERNELS), launches
    assert same, "the 1x1 mesh run differs from phase 6's"
    # the spawned ranks count their own launches, on the card only (a CPU
    # rehearsal's counting patches stay in this process)
    counted = device.type == "cuda"

    out = ROOT / "build" / "mesh_2x1"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    ctx = mp.start_processes(_mesh_rank, args=(2, _free_port(), "2x1", out,
                                               cfg, str(device),
                                               dict(rank=rank, seq=seq)),
                             nprocs=2, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() - t0 > MESH_TIMEOUT_S:
                raise TimeoutError(f"the 2x1 ranks ran past "
                                   f"{MESH_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    ranks = [torch.load(out / f"rank{r}.pt") for r in range(2)]
    for r in range(2):
        (out / f"rank{r}.pt").unlink()
    same = _same_state(ranks[0], sync) and \
        ranks[1]["history"] == sync["history"]
    expect = n_adapted * 2 * 2 * MESH_ROUNDS
    fwd = expect + _recompute_counts(cfg)[0] * 2 * 2 * MESH_ROUNDS
    for r, res in enumerate(ranks):
        print(f"2x1 rank {r}: clients {res['block']}, launches "
              f"{ {k: res['launches'][k] for k in LORA_KERNELS} } "
              f"(expected {expect} each, #5 {fwd}: two clients); ms/round "
              f"{[round(t, 1) for t in res['ms']]}")
        assert not counted or all(
            res["launches"][k] == (fwd if k == "lora_fwd" else expect)
            for k in LORA_KERNELS)
    print(f"2x1: two ranks in {time.monotonic() - t0:.1f} s from spawn to "
          f"exit; history, adapters and optimizer state "
          f"{'bit-identical' if same else 'DIFFER'} to phase 6's")
    assert same, "the 2x1 mesh run differs from phase 6's"
    del ranks
    if not counted:
        return {}
    worst = check_lora_kernels(MESH_TP_CASES)
    time_lora_kernels(k=cfg.d_model, projs=MESH_TP_PROJS)
    return worst


def _grouped_control(cfg, device):
    """One MoE layer (seeded random weights, 4 x 128 tokens): the grouped
    and the flat dispatch agree where no expert can overflow (capacity
    factor e / k: every slot fits) and differ where capacity drops tokens
    (factor 0.5: half an even share), each path's drops counted."""
    g = torch.Generator(device).manual_seed(7)
    m = cfg.moe
    for cf in (0.5, m.num_experts / m.top_k):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=cf))
        params = moe.moe_params(c, g)
        x = torch.randn(4, 128, c.d_model, generator=g, device=device)
        _, _, top_i = moe.route(c, params, x.reshape(-1, c.d_model))
        assign = torch.nn.functional.one_hot(top_i, m.num_experts).sum(1)
        flat_drops = int((torch.cumsum(assign, 0) > moe.capacity(
            c, assign.shape[0])).logical_and(assign > 0).sum())
        rows = assign.reshape(4, 128, -1)
        grp_drops = int((torch.cumsum(rows, 1) > moe.capacity(
            c, 128)).logical_and(rows > 0).sum())
        with torch.inference_mode():
            flat, _ = moe.moe_apply(c, params, x)
            opts.set_opts(["moe_grouped"])
            try:
                grouped, _ = moe.moe_apply(c, params, x)
            finally:
                opts.set_opts(["moe_grouped"], False)
        diff = float((grouped - flat).abs().max())
        print(f"capacity factor {cf}: dropped (token, expert) choices flat "
              f"{flat_drops}, grouped {grp_drops}; max |grouped - flat| "
              f"{diff:.3e}")
        if cf == 0.5:
            assert flat_drops > 0 and grp_drops > 0 and diff > 1e-3, diff
        else:
            assert flat_drops == grp_drops == 0
            assert diff <= KERNEL_RTOL * max(1.0, float(flat.abs().max()))


def grouped_moe_paths(name, cfg=GRANITE_PATHS, device=None, **train):
    """granite-moe-1b-a400m at GRANITE_PATHS's depth, fp32, with the
    ``moe_grouped`` switch on: generate_banked (the kernel tier against
    the plain tier, routing replayed) and one training round (#5-#8
    counted, a repeat bit for bit, the plain tier within 1e-3), then the
    grouped-vs-flat control.  ``cfg``, ``device`` and ``train``
    (train_path's shape) so that it can be rehearsed on a CPU."""
    dev = device or torch.device("cuda")
    phase("grouped MoE dispatch (sharding switch moe_grouped): "
          f"{cfg.name}, {cfg.num_layers} layers, fp32")
    opts.set_opts(["moe_grouped"])
    try:
        run_path(name, cfg, dev, steps=8)
        train_path(name, cfg, dev, rounds=1, **train)
    finally:
        opts.reset()
    phase(f"grouped MoE control: grouped vs flat dispatch, one layer of "
          f"{cfg.name}")
    _grouped_control(cfg, dev)


# ------------------------------------------------------------- 30. dry-run

DRYRUN_SHAPES = ("train_4k", "decode_32k")
DRYRUN_TIMEOUT_S = 300
TEMP_RTOL = 0.15               # real peak above the arguments vs the trace's
# one round of one client at phase 6's per-client batch and sequence
# (train_path's defaults), one local step
ROUND_SHAPE = dict(seq_len=128, global_batch=4)


def _rules_bytes(arch, shape_name, sizes=(16, 16)):
    """Per-device argument bytes of the dry-run's step on the
    ``("data", "model")`` mesh of ``sizes``, from the port's partition
    rules alone (a MeshShape: no process group): every leaf's bytes over
    the product of the axes its spec names, as the CPU test sums JAX's;
    the train step's client stacks (adapters, optimizer state, batches)
    whole, as ``FederatedTrainer(mesh=)`` keeps them on every device."""
    from repro_torch.configs import INPUT_SHAPES, config_for_shape
    from repro_torch.core.lora import init_lora
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape, num_clients
    from repro_torch.sharding import rules
    mesh = MeshShape(("data", "model"), sizes)
    shape = INPUT_SHAPES[shape_name]
    cfg = dataclasses.replace(config_for_shape(arch, shape_name),
                              dtype="bfloat16", param_dtype="bfloat16")
    model = build_model(cfg)
    with dryrun._MetaInit():
        params = model.init(torch.Generator(), device="meta")

    def total(tree, spec_fn):
        out = 0
        for t, spec in zip(tree_leaves(tree), tree_leaves(
                rules.tree_specs(tree, mesh, spec_fn))):
            div = math.prod(mesh.shape[a] for e in spec if e is not None
                            for a in ((e,) if isinstance(e, str) else e))
            out += t.numel() * t.element_size() // div
        return out
    n_bytes = total(params, rules.param_spec)
    if shape.kind == "train":
        n = num_clients(mesh)
        with dryrun._MetaInit():
            lora = init_lora(params, torch.Generator(), LoRAConfig(
                rank=64, alpha=8.0, targets=cfg.lora_targets))
        stacked = tree_map(lambda x: x.expand((n,) + tuple(x.shape)), lora)
        opt = {"t": torch.empty((n,), dtype=torch.int32, device="meta")}
        batch = {k: torch.empty((n, 1) + tuple(v.shape[1:]), dtype=v.dtype,
                                device="meta")
                 for k, v in model.input_specs(shape, n_clients=n).items()}
        return n_bytes + sum(t.numel() * t.element_size() for tree in
                             (stacked, opt, batch) for t in tree_leaves(tree))
    spec = model.input_specs(shape)

    def inputs(p, sh, m):
        return rules.input_spec(p, sh, m, client_dim=False)
    return (n_bytes + total(spec["cache"], rules.cache_spec)
            + total({"t": spec["token"]}, inputs)
            + total({"t": spec["pos"]}, inputs))


def _round_once(fn, args, device):
    """One call of the traced round on real tensors (autograd on); its
    result and host wall ms with the device synchronized."""
    with torch.enable_grad():
        return _timed(lambda: fn(*args), device)


def dryrun_paths(name, smi, device=None):
    """Phase 30: the dry-run (``repro_torch.launch.dryrun``).  (a) Its CLI
    as a child process on the installed torch, gemma-2b train_4k and
    decode_32k on the 16x16 pod over a fake process group, each record
    printed and its argument bytes held to the port's rules
    (:func:`_rules_bytes`).  (b) A traced round held against the same
    round run for real on this card, 1x1: full-width gemma-2b, one client
    at phase 6's per-client batch and sequence, built by the dry-run's own
    ``_build``; on the plain tier (``dispatch.plain_tier()``) its
    FlopCounterMode count must equal the trace's exactly and its peak
    above the arguments (``max_memory_allocated``) the trace's
    ``temp_size_in_bytes`` within TEMP_RTOL; the kernel tier's peak and
    both tiers' round times are printed beside ``hillclimb.terms``."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun, hillclimb
    device = device or torch.device("cuda")
    phase("dry-run: repro_torch.launch.dryrun's CLI on the 16x16 pod (fake "
          "process group, meta tensors), and a traced round against a real "
          "one on this device")
    out = ROOT / "build" / "dryrun"
    out.mkdir(parents=True, exist_ok=True)
    for f in out.glob("*.json"):
        f.unlink()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.monotonic()
    # one child per shape, run side by side
    procs = {shape: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma-2b", "--shape", shape, "--out", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(ROOT)) for shape in DRYRUN_SHAPES}
    for shape, proc in procs.items():
        try:
            _, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
        assert proc.returncode == 0, err[-2000:]
        rec = json.loads((out / f"gemma-2b__{shape}__sp.json").read_text())
        assert "error" not in rec, rec.get("trace")
        want = _rules_bytes("gemma-2b", shape)
        print(f"{shape} (by {time.monotonic() - t0:.1f} s, the children "
              f"started together): {json.dumps(rec)}")
        print(f"  argument bytes per device {rec['argument_size_in_bytes']}"
              f", from the rules {want}; terms "
              f"{ {k: round(v, 6) for k, v in hillclimb.terms(rec).items()} }"
              " (H100 data-sheet peaks: predictions)")
        assert rec["argument_size_in_bytes"] == want, (shape, want)

    shape = InputShape("phase6_round", kind="train", **ROUND_SHAPE)
    t0 = time.monotonic()
    fn, args, kind = dryrun._build("gemma-2b", "train_4k", None, 64, 8.0,
                                   shape=shape)
    rec = dryrun.trace(fn, args, kind)
    terms = hillclimb.terms(rec)
    del fn, args
    print(f"traced round ({time.monotonic() - t0:.1f} s): flops "
          f"{rec['flops']}, bytes {rec['bytes_accessed']}, arguments "
          f"{rec['argument_size_in_bytes']}, temp {rec['temp_size_in_bytes']}"
          f"; compute_s {terms['compute_s'] * 1e3:.3f} ms, memory_s "
          f"{terms['memory_s'] * 1e3:.3f} ms at the H100 data-sheet peaks")
    fn, args, _ = dryrun._build("gemma-2b", "train_4k", None, 64, 8.0,
                                shape=shape, device=device, seed=0)
    real = {}
    for tier in ("plain", "kernel"):
        ctx = (dispatch.plain_tier() if tier == "plain"
               else contextlib.nullcontext())
        with ctx:
            _round_once(fn, args, device)                  # warm-up
            _free()
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            if tier == "plain":
                with FlopCounterMode(display=False) as fc:
                    res, _ = _round_once(fn, args, device)
                real["flops"] = fc.get_total_flops()
            else:
                res, _ = _round_once(fn, args, device)
            peak = torch.cuda.max_memory_allocated(device) - base
            del res
            _free()
            ms = sorted(_round_once(fn, args, device)[1] for _ in range(3))
        real[tier] = (peak, ms[1])
    del fn, args
    _free()
    temp = rec["temp_size_in_bytes"]
    plain_peak, plain_ms = real["plain"]
    kern_peak, kern_ms = real["kernel"]
    print(f"nvidia-smi: {smi}")
    print(f"plain tier: FlopCounterMode {real['flops']} (trace "
          f"{rec['flops']}); peak above the arguments {plain_peak} B, trace "
          f"temp {temp} B ({plain_peak / temp - 1:+.3%}); round "
          f"{plain_ms:.1f} ms (median of 3)")
    print(f"kernel tier: peak above the arguments {kern_peak} B "
          f"({kern_peak / temp - 1:+.3%} of the trace's); round "
          f"{kern_ms:.1f} ms; compute_s {terms['compute_s'] * 1e3:.3f} ms, "
          f"memory_s {terms['memory_s'] * 1e3:.3f} ms")
    assert real["flops"] == rec["flops"], (real["flops"], rec["flops"])
    assert abs(plain_peak - temp) <= TEMP_RTOL * temp, (plain_peak, temp)


# ------------------------------------- 31-33. remat, blocked attention, guard

def _resident(device):
    """Memory held now, with the peak counter reset to it (0 off CUDA)."""
    _sync(device)
    if device.type != "cuda":
        return 0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def _peak_above(device, resident):
    _sync(device)
    return (torch.cuda.max_memory_allocated(device) - resident
            if device.type == "cuda" else 0)


def remat_paths(name, cfg, device, params, *, clients=4, rank=64,
                local_steps=2, batch=4, seq=128):
    """31. Phase 6's round (one round of fedsa + sfedlora, sgd at 5e-3,
    the same trainer) with ``apply_stack``'s remat on, the default, and
    off (``remat=False``, patched in for the comparison only), on the
    kernel tier twice each and on the plain tier: the losses, grad norms
    and adapters bit for bit equal between the two settings on each tier;
    ms/round, the peak above the arguments (the resident base, adapters
    and optimizer state) and #5's launches of each (the recompute adds
    ``_recompute_counts`` per client local step)."""
    phase(f"remat: phase 6's round ({cfg.name}, {cfg.num_layers} layers) "
          "with apply_stack's whole-unit remat on (default) and off")
    model = build_model(cfg)
    api_mod = sys.modules[build_model.__module__]
    steps = clients * local_steps
    n_adapted, r_ad = _proj_counts(cfg)[0], _recompute_counts(cfg)[0]

    def one_round(remat, plain):
        tr = federated.FederatedTrainer(
            model, FederatedDataset(cfg.vocab_size, clients, seq_len=seq,
                                    batch_per_client=batch, seed=0),
            lora_cfg=LoRAConfig(rank=rank, alpha=8.0, scaling="sfedlora",
                                targets=cfg.lora_targets),
            fed_cfg=FederatedConfig(num_clients=clients,
                                    local_steps=local_steps, rounds=1,
                                    aggregation="fedsa"),
            opt_cfg=OptimizerConfig(name="sgd", lr=5e-3), seed=0,
            base_params=params, device=device)
        resident = _resident(device)
        _reset_launches()
        orig = api_mod.apply_stack
        api_mod.apply_stack = lambda *a, **k: transformer.apply_stack(
            *a, remat=remat, **k)
        try:
            with (dispatch.plain_tier() if plain
                  else contextlib.nullcontext()):
                t = time.monotonic()
                tr.run_round()
                _sync(device)
                ms = (time.monotonic() - t) * 1e3
        finally:
            api_mod.apply_stack = orig
        out = {"history": tr.history, "lora": tr.lora, "ms": ms,
               "peak": _peak_above(device, resident),
               "lora_fwd": _launch_counts()["lora_fwd"]}
        del tr
        return out

    res = {}
    for plain in (False, True):
        for rep in range(1 if plain else 2):
            for remat in (True, False):
                res.setdefault((plain, remat), []).append(
                    one_round(remat, plain))
    for plain in (False, True):
        tier = "plain" if plain else "kernel"
        on, off = res[(plain, True)][0], res[(plain, False)][0]
        same = on["history"] == off["history"] and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(on["lora"]),
                                              tree_leaves(off["lora"])))
        for remat in (True, False):
            runs = res[(plain, remat)]
            want = 0 if plain else (n_adapted + (r_ad if remat else 0)) \
                * steps
            print(f"{tier} tier, remat {'on ' if remat else 'off'}: "
                  f"ms/round {[round(r['ms'], 1) for r in runs]}, peak "
                  f"above the arguments {runs[0]['peak'] / 1e9:.3f} GB "
                  f"({runs[0]['peak']} B), #5 launches "
                  f"{[r['lora_fwd'] for r in runs]} (expected {want}); "
                  f"loss {runs[0]['history'][-1]['loss']:.8g}")
            assert all(r["lora_fwd"] == want for r in runs), (runs, want)
            assert all(r["history"] == runs[0]["history"] for r in runs)
        print(f"{tier} tier: remat on vs off: losses, grad norms and "
              f"adapters {'bit-identical' if same else 'DIFFER'}")
        assert same, f"remat changes the {tier} tier's round"
        if device.type == "cuda":
            assert on["peak"] < off["peak"], (on["peak"], off["peak"])
    on_k, off_k = res[(False, True)], res[(False, False)]
    print(f"remat on {name}: the kernel tier's round "
          f"{min(r['ms'] for r in on_k):.1f} ms against "
          f"{min(r['ms'] for r in off_k):.1f} ms off; peak "
          f"{on_k[0]['peak'] / 1e9:.3f} GB against "
          f"{off_k[0]['peak'] / 1e9:.3f} GB")
    del res, model
    _free()


# (b, s, heads, kv heads, head dim): the CPU test's reduced layout and
# gemma-2b's heads, both at 4096 positions (above BLOCKWISE_THRESHOLD)
BLOCKED_SHAPES = {"reduced (2 heads on 1, hd 64)": (1, 4096, 2, 1, 64),
                  "gemma-2b heads (8 on 1, hd 256)": (1, 4096, 8, 1, 256)}


def blocked_attention_paths(name, device, shapes=BLOCKED_SHAPES):
    """33. The blocked attention's backward at 4096 positions: the
    gradients of sum(out * w) with each kv step checkpointed (the
    default), without the checkpoint (``checkpointed`` patched to a plain
    call), and through the plain whole-matrix ``attention_core``; the
    peak above the inputs of each.  The checkpointed gradients equal the
    unchecked ones bit for bit and the whole matrix's within
    KERNEL_RTOL x max(1, max|grad|)."""
    from repro_torch.models import attention
    phase("blocked attention backward at s 4096: kv-step checkpoint on / "
          "off and the whole score matrix")
    cfg = get_config("gemma-2b").reduced()
    for label, (b, s, h, kh, hd) in shapes.items():
        gen = torch.Generator(device).manual_seed(0)
        q, w = (torch.randn(b, s, h, hd, generator=gen, device=device)
                for _ in range(2))
        k, v = (torch.randn(b, s, kh, hd, generator=gen, device=device)
                for _ in range(2))
        pos = torch.arange(s, device=device)[None].expand(b, s)

        def blocked(qq, kk, vv):
            return attention.blockwise_attention(cfg, qq, kk, vv, pos, pos,
                                                 causal=True, window=None)

        def whole(qq, kk, vv):
            mask = attention.make_mask(pos, pos, causal=True)
            return attention.attention_core(cfg, qq, kk, vv, mask)

        def run(fn):
            args = [t.detach().clone().requires_grad_(True)
                    for t in (q, k, v)]
            resident = _resident(device)
            t0 = time.monotonic()
            loss = (fn(*args) * w).sum()
            grads = torch.autograd.grad(loss, args)
            _sync(device)
            return (grads, (time.monotonic() - t0) * 1e3,
                    _peak_above(device, resident))

        run(blocked)                     # warm-up: allocator, cuBLAS plans
        checked = run(blocked)
        orig = attention.checkpointed
        attention.checkpointed = lambda fn, *a, **k: fn(*a)
        try:
            unchecked = run(blocked)
        finally:
            attention.checkpointed = orig
        full = run(whole)
        same = all(torch.equal(a, c) for a, c in zip(checked[0],
                                                     unchecked[0]))
        err = max(float((a - c).abs().max()) / max(1.0, float(
            c.abs().max())) for a, c in zip(checked[0], full[0]))
        print(f"{label}: peak above the inputs {checked[2] / 1e6:.1f} MB "
              f"checkpointed, {unchecked[2] / 1e6:.1f} MB without, "
              f"{full[2] / 1e6:.1f} MB whole-matrix; forward + backward "
              f"{checked[1]:.1f} / {unchecked[1]:.1f} / {full[1]:.1f} ms; "
              f"gradients {'bit-identical' if same else 'DIFFER'} to the "
              f"unchecked run's, relative diff to the whole matrix's "
              f"{err:.3e} (bound {KERNEL_RTOL})")
        assert same and err <= KERNEL_RTOL
        if device.type == "cuda":
            assert checked[2] < unchecked[2]
        del q, k, v, w, checked, unchecked, full
        _free()


def guarded_sched_path(name, model, params, bank, modes=("fp32", "int4")):
    """32. serve_scheduled(transfer_guard=True) on phase 8's traffic over
    each base: first with the guard's region in "warn" mode, every
    synchronizing operation inside admission or a decode chunk printed
    with the port's line that called it (none expected), then as users
    run it ("error" mode: such an operation raises TransferGuardError);
    the tokens equal the unguarded run's."""
    import traceback
    import warnings

    from repro_torch.analysis import sanitizers
    sc = SCHED
    phase(f"guarded scheduled path: serve_scheduled(transfer_guard=True), "
          f"{model.cfg.name} at {model.cfg.num_layers} layers, phase 8's "
          "traffic")
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, model.cfg.vocab_size, (sc["n_req"],
                                                     sc["plen"]))

    def run(base, **kw):
        reqs = [serve.Request(rid=i, prompt=prompts[i].astype(np.int32),
                              steps=sc["steps"], adapter_id=i % bank.size,
                              deadline_steps=sc["deadline"]
                              if i == sc["n_req"] - 1 else None)
                for i in range(sc["n_req"])]
        t = time.monotonic()
        done = serve.serve_scheduled(
            model, base, reqs, bank=bank, max_batch=sc["max_batch"],
            block_size=sc["block_size"], chunk=sc["chunk"], wait=False, **kw)
        return [r.tokens for r in done], time.monotonic() - t

    @contextlib.contextmanager
    def warn_region(caught):
        before = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")

        def show(message, *a, **k):
            frames = [f for f in traceback.extract_stack()
                      if "repro_torch" in f.filename]
            where = (f"{Path(frames[-1].filename).name}:{frames[-1].lineno} "
                     f"{frames[-1].line}" if frames else "?")
            caught[where] = caught.get(where, 0) + 1
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = show
                yield
        finally:
            torch.cuda.set_sync_debug_mode(before)

    for mode in modes:
        base = params if mode == "fp32" else apply_quant_flag(
            params, mode, QUANT_GROUP)
        want, s_plain = run(base)
        caught = {}
        orig = sanitizers.no_implicit_transfers
        sanitizers.no_implicit_transfers = lambda: warn_region(caught)
        try:
            warned, _ = run(base, transfer_guard=True)
        finally:
            sanitizers.no_implicit_transfers = orig
        print(f"{mode}: synchronizing operations inside admission and the "
              f"chunks: {sum(caught.values())}"
              + "".join(f"\n  {n} x {where}" for where, n in
                        sorted(caught.items())))
        got, s_guard = run(base, transfer_guard=True)
        guard = sanitizers.RecompileGuard()
        rec, _ = run(base, guard=guard)
        print(f"{mode}: guarded tokens "
              f"{'identical' if got == want == warned == rec else 'DIFFER'}"
              f" to the unguarded run's ({s_guard:.2f} s guarded, "
              f"{s_plain:.2f} s unguarded); RecompileGuard events "
              f"{guard.events}")
        assert got == want == warned == rec and not caught
        del base
        _free()


class _CuMemProp(ctypes.Structure):
    """CUmemAllocationProp: pinned memory on one device."""
    _fields_ = [("type", ctypes.c_int), ("handle_types", ctypes.c_int),
                ("loc_type", ctypes.c_int), ("loc_id", ctypes.c_int),
                ("win32_meta", ctypes.c_void_p), ("compression", ctypes.c_ubyte),
                ("rdma", ctypes.c_ubyte), ("usage", ctypes.c_ushort),
                ("reserved", ctypes.c_ubyte * 4)]


class _CuMemAccess(ctypes.Structure):
    """CUmemAccessDesc: read-write access from one device."""
    _fields_ = [("loc_type", ctypes.c_int), ("loc_id", ctypes.c_int),
                ("flags", ctypes.c_int)]


_TYPESTR = {torch.float32: "<f4", torch.bfloat16: "<i2", torch.int8: "|i1",
            torch.uint8: "|u1", torch.int32: "<i4"}


class _Granules:
    """Buffers flush against an unmapped page, through the CUDA driver's
    virtual memory calls: each buffer gets a reserved range of three
    granules whose middle one alone is mapped, and lies against that
    granule's end or its start.  A kernel that reads or writes one byte
    past the buffer's edge then faults (cudaErrorIllegalAddress), whatever
    the caching allocator's layout would have put there."""

    def __init__(self, device):
        self.cu = ctypes.CDLL("libcuda.so.1")
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        self.prop = _CuMemProp(1, 0, 1, idx, None, 0, 0, 0)
        self.access = _CuMemAccess(1, idx, 3)
        gran = ctypes.c_size_t()
        self._ok(self.cu.cuMemGetAllocationGranularity(
            ctypes.byref(gran), ctypes.byref(self.prop), 0), "granularity")
        self.size, self.device, self.held = gran.value, device, []

    @staticmethod
    def _ok(rc, what):
        if rc:
            raise RuntimeError(f"guarded granule: {what} returned CUresult "
                               f"{rc}")

    def place(self, src, at):
        """A copy of ``src`` (contiguous) at the ``at`` ("end" or "start")
        of a lone mapped granule."""
        nbytes = src.numel() * src.element_size()
        assert 0 < nbytes <= self.size and src.dtype in _TYPESTR
        base, handle = ctypes.c_uint64(), ctypes.c_uint64()
        g = ctypes.c_size_t(self.size)
        self._ok(self.cu.cuMemAddressReserve(
            ctypes.byref(base), ctypes.c_size_t(3 * self.size),
            ctypes.c_size_t(0), ctypes.c_uint64(0), ctypes.c_ulonglong(0)),
            "reserve")
        self._ok(self.cu.cuMemCreate(ctypes.byref(handle), g,
                                     ctypes.byref(self.prop),
                                     ctypes.c_ulonglong(0)), "create")
        mid = ctypes.c_uint64(base.value + self.size)
        self._ok(self.cu.cuMemMap(mid, g, ctypes.c_size_t(0), handle,
                                  ctypes.c_ulonglong(0)), "map")
        self.held.append((base, mid, handle))
        self._ok(self.cu.cuMemSetAccess(mid, g, ctypes.byref(self.access),
                                        ctypes.c_size_t(1)), "access")
        ptr = mid.value + (self.size - nbytes if at == "end" else 0)
        view = type("CudaArray", (), {"__cuda_array_interface__": {
            "shape": (src.numel(),), "typestr": _TYPESTR[src.dtype],
            "data": (ptr, False), "version": 3, "strides": None}})()
        t = torch.as_tensor(view, device=self.device).view(src.dtype)
        return t.view(src.shape).copy_(src)

    def release(self):
        """Unmap and free every granule (no tensor placed may be used after
        this)."""
        torch.cuda.synchronize(self.device)
        g = ctypes.c_size_t(self.size)
        for base, mid, handle in self.held:
            self._ok(self.cu.cuMemUnmap(mid, g), "unmap")
            self._ok(self.cu.cuMemRelease(handle), "release")
            self._ok(self.cu.cuMemAddressFree(
                base, ctypes.c_size_t(3 * self.size)), "free")
        self.held = []


def _edge_cases(gen, dev):
    """(label, operands, make, tol) of guarded_edges: ``make(*operands)``
    gives {kernel: (kernel call, plain call)}; tol None holds them to
    KERNEL_RTOL (_check_pair), else to tol (_allclose)."""
    lm, fa, rg = lora_matmul, flash_attention, rglru_scan
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        d = str(dt)[6:]
        for m, k, n, r in ((50, 100, 30, 3), (33, 65, 17, 1)):
            x, w, a, b, g = _lora_operands(gen, m, k, n, r, dt, dev)
            cases.append((f"#5-#8 m={m} k={k} n={n} r={r} {d}",
                          (x, w, a, b, g),
                          lambda *o: _lora_calls(*o, 1.5), None))
            for mode, bits in (("int8", 8), ("int4", 4)):
                wq = quantize(w.float(), bits, QUANT_GROUP)

                def packed(x, x4, data, scales, a, b, g, wq=wq):
                    wq = dataclasses.replace(wq, data=data, scales=scales)
                    calls = _qtrain_calls(x, wq, a, b, g)
                    for name, xx in (("quant_matmul", x),
                                     ("quant_matmul m=4", x4)):
                        calls[name] = (
                            lambda xx=xx: lm.quant_matmul(xx, wq),
                            lambda xx=xx: lm.quant_matmul_plain(xx, wq))
                    return calls
                cases.append((f"#9-#12 {mode} m={m} k={k} n={n} r={r} {d}",
                              (x, x[:4].contiguous(), wq.data, wq.scales,
                               a, b, g), packed, None))
        x, w, a, b, ids = _bank(gen, 4, 3, 70, 50, 3, (9, 9, 9), dt)
        wq = quantize(w.float(), 4, QUANT_GROUP)

        def banked(x, x1, w, data, scales, a, b, ids, wq=wq):
            wq = dataclasses.replace(wq, data=data, scales=scales)
            return {
                "bgmv_matmul": (lambda: bgmv.bgmv_matmul(x, w, a, b, ids),
                                lambda: bgmv.bgmv_matmul_plain(x, w, a, b,
                                                               ids)),
                "bgmv_gemv": (lambda: bgmv.bgmv_gemv(x1, w, a, b, ids),
                              lambda: bgmv.bgmv_gemv_plain(x1, w, a, b, ids)),
                "bgmv_matmul_quant": (
                    lambda: bgmv.bgmv_matmul_quant(x, wq, a, b, ids),
                    lambda: bgmv.bgmv_matmul_quant_plain(x, wq, a, b, ids)),
                "bgmv_gemv_quant": (
                    lambda: bgmv.bgmv_gemv_quant(x1, wq, a, b, ids),
                    lambda: bgmv.bgmv_gemv_quant_plain(x1, wq, a, b, ids))}
        cases.append((f"#1-#4 s=3 k=70 n=50 int4 {d}",
                      (x, x[:, 0].contiguous(), w, wq.data, wq.scales, a, b,
                       ids), banked, None))
        q, k, v = _flash_operands(gen, (1, 100, 100, 2, 1, 64, True, None),
                                  dt, dev)
        cases.append((f"#14 s=t=100 h=2 d=64 causal {d}", (q, k, v),
                      lambda q, k, v: {"flash_attention": (
                          lambda: fa.flash_attention(q, k, v, causal=True),
                          lambda: fa.flash_attention_plain(q, k, v,
                                                           causal=True))},
                      FLASH_TOL[dt]))
        a, b = _scan_operands(gen, SCAN_SHAPES["ragged"], dt, dev)
        gh = torch.randn(SCAN_SHAPES["ragged"], generator=gen,
                         device=dev).to(dt)
        cases.append((f"#15 {SCAN_SHAPES['ragged']} {d}", (a, b, gh),
                      lambda a, b, gh: {
                          "rglru_scan": (lambda: rg.rglru_scan(a, b),
                                         lambda: rg.rglru_scan_plain(a, b)),
                          "rglru_scan_bwd": (
                              lambda: rg.rglru_scan_bwd(a, b, gh),
                              lambda: rg.rglru_scan_bwd_plain(a, b, gh))},
                      SCAN_TOL[dt]))
    return cases


def guarded_edges(dev="cuda"):
    """34. (after phase 9's checks, which follow phase 33's large
    allocate-and-free) The ragged cases of the kernels whose loads mask
    ragged edges (#1-#12, #14, #15, fp32 and bf16, int8 and int4), each
    operand copied flush against the end, then the start, of a lone mapped
    granule (_Granules), against the plain version on the ordinary copies.
    A read past an operand's edge faults here whatever the allocator's
    layout: before the bf16 loads went through ``loaders.cuh``'s ``ldg``,
    #10's bf16 case faulted at every "end" placement."""
    phase("guarded edges: ragged kernel cases with every operand against "
          "an unmapped page, end and start")
    gen = torch.Generator(dev).manual_seed(34)
    mem = _Granules(torch.device(dev))
    worst = {}
    for label, operands, make, tol in _edge_cases(gen, dev):
        plain = make(*operands)
        for at in ("end", "start"):
            guarded = [mem.place(t, at) for t in operands]
            for kern, (kfn, _) in make(*guarded).items():
                want = plain[kern][1]()
                got = kfn()
                name = kern.split(" ")[0]
                if tol is None:
                    err = _check_pair(name, f"{label} at {at}", got, want)
                else:
                    pairs = (zip(got, want) if isinstance(got, tuple)
                             else [(got, want)])
                    err = max(_allclose(name, f"{label} at {at}", gt, wt,
                                        tol) for gt, wt in pairs)
                worst[name] = max(worst.get(name, 0.0), err)
            del guarded, got, want
            mem.release()
    print(f"launches in this phase (not the path's): "
          f"{ {k: v for k, v in _launch_counts().items() if v} }")
    return worst


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
    gemma, dev = get_config("gemma-2b"), torch.device("cuda")
    params = train_base(build_model(gemma), dev)
    train_launches, sync_ms, sync = train_path(name, gemma, dev,
                                               params=params,
                                               track_stability=True)
    launches.update({k: train_launches[k] for k in LORA_KERNELS})
    remat_paths(name, gemma, dev, params)
    del params
    _free()
    # phase 29 runs here, against phase 6's run
    for kern, err in mesh_paths(name, gemma, dev, sync, sync_ms).items():
        worst[kern] = max(worst[kern], err)
    del sync
    _free()
    # phase 21 at GEMMA_HALF's depth, on its own base and synchronous run
    params = train_base(build_model(GEMMA_HALF), dev)
    half_launches, half_ms, sync = train_path(name, GEMMA_HALF, dev,
                                              params=params,
                                              track_stability=True)
    fault_tolerant_paths(name, GEMMA_HALF, dev, params,
                         dict(sync, launches=half_launches, ms=half_ms))
    del params, sync
    _free()
    ring = SCHED["plen"] + SCHED["steps"]
    worst.update(check_sched_kernels(SCHED["block_size"], ring))
    rows.update(time_sched_kernels(SCHED["block_size"], ring))
    _free()
    model, params, bank = serving_model(GEMMA_HALF, torch.device("cuda"))
    for mode in ("fp32", "int8", "int4"):
        sched_launches, _ = sched_path(name, model, params, bank, mode)
        _free()
        # #13 from the fp32 run; #3, #4 and #11 from the int4 run
        keep = (("paged_attention",) if mode == "fp32" else
                ("bgmv_matmul_quant", "bgmv_gemv_quant", "quant_matmul")
                if mode == "int4" else ())
        launches.update({k: sched_launches[k] for k in keep})
    live_bank_path(model, params, bank)
    guarded_sched_path(name, model, params, bank)
    del model, params, bank
    _free()
    blocked_attention_paths(name, dev)
    # phase 9's checks right after phase 33's large allocate-and-free, then
    # the same kernels with every operand against an unmapped page
    worst.update(check_qtrain_kernels())
    for kern, err in guarded_edges().items():
        if kern in worst:
            worst[kern] = max(worst[kern], err)
    rows.update(time_qtrain_kernels())
    _free()
    for mode in ("int8", "int4"):
        qtrain_launches, _, _ = train_path(name, GEMMA_HALF,
                                           torch.device("cuda"), quant=mode)
        _free()
        if mode == "int4":
            launches.update({k: qtrain_launches[k] for k in QTRAIN_KERNELS})
    worst.update(check_scan_flash())
    rows.update(time_scan_flash())
    _free()
    launches["flash_attention"] = ops_path()["flash_attention"]
    _free()
    hybrid_fixed, _ = hybrid_path(name)
    launches["rglru_scan"] = hybrid_fixed["rglru_scan"]
    for kern, err in check_dense_kernels().items():
        worst[kern] = max(worst[kern], err)
    rows.update(time_dense_kernels())
    _free()
    llama_paths(name)
    qwen_path(name)
    for kern, err in check_hybrid_kernels().items():
        worst[kern] = max(worst.get(kern, 0.0), err)
    rows.update(time_hybrid_kernels())
    _free()
    hybrid_launches, _ = hybrid_train_paths(name)
    launches["rglru_scan_bwd"] = hybrid_launches["rglru_scan_bwd"]
    hybrid_packed_serving(name)
    _free()
    for kern, err in check_moe_kernels().items():
        worst[kern] = max(worst.get(kern, 0.0), err)
    rows.update(time_moe_kernels())
    _free()
    qwen_moe_paths(name)
    granite_paths(name)
    _free()
    grouped_moe_paths(name)
    _free()
    xlstm_paths(name)
    for kern, err in check_whisper_kernels().items():
        worst[kern] = max(worst.get(kern, 0.0), err)
    rows.update(time_whisper_kernels())
    _free()
    whisper_paths(name)
    paligemma_paths(name)
    roberta_paths(name)
    _free()
    dryrun_paths(name, smi)
    _free()
    kernels = []
    for kern in (("bgmv_gemv", "bgmv_matmul") + LORA_KERNELS
                 + SCHED_KERNELS + QTRAIN_KERNELS + SCAN_FLASH
                 + ("rglru_scan_bwd",)):
        row = rows[(kern, ROW[kern])]
        kernels.append({
            "name": kern, "route": "cuda", "source": SOURCES[kern],
            "replaces": REPLACES[kern], "launches": launches[kern],
            "max_abs_err": worst[kern], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(f"\nchip_smoke.py: {time.monotonic() - T_START:.1f} s from start "
          "to result, the kernels' build included")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
