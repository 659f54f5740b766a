"""Configuration dataclasses for models, LoRA adapters, federated rounds and
optimizers.

A copy of the parts of ``repro/configs/base.py`` that the port reads.  The
JAX config's ``use_pallas`` flag has no counterpart: here the device of the
tensors decides the tier (see ``kernels/dispatch.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0          # routed experts
    top_k: int = 0
    num_shared_experts: int = 0   # always-on experts
    d_ff_expert: int = 0          # per-expert hidden size
    d_ff_shared: int = 0          # shared-expert hidden size (total)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | vlm | audio | encoder
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    citation: str = ""

    # --- variants -----------------------------------------------------------
    mlp_variant: str = "swiglu"   # swiglu | geglu | gelu
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    qk_norm: bool = False
    attn_window: Optional[int] = None   # sliding-window size (None = full attention)
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    attn_logit_softcap: Optional[float] = None
    parallel_residual: bool = False      # stablelm-style parallel attn+mlp

    # --- block pattern (hybrid / ssm) ----------------------------------------
    block_pattern: Tuple[str, ...] = ("attn",)

    # --- MoE ------------------------------------------------------------------
    moe: Optional[MoEConfig] = None

    # --- recurrent (RG-LRU / xLSTM) -------------------------------------------
    rglru_d_state: int = 0
    mlstm_proj_factor: float = 2.0
    slstm_num_heads: int = 4

    # --- encoder-decoder (audio) ----------------------------------------------
    encoder_layers: int = 0
    encoder_frames: int = 0
    encoder_d_model: int = 0

    # --- VLM --------------------------------------------------------------------
    num_patches: int = 0

    # --- numerics ----------------------------------------------------------------
    dtype: str = "float32"        # activation dtype
    param_dtype: str = "float32"

    # --- LoRA defaults (paper: W_q, W_v) ------------------------------------------
    lora_targets: Tuple[str, ...] = ("q", "v")

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def reduced(self, *, num_layers: int = 2, d_model: int = 256,
                vocab_size: int = 512, seq_cap: int = 128) -> "ModelConfig":
        """A smoke-test-sized variant of the same family (<=512 d_model,
        2 layers, <=4 experts), preserving every structural switch."""
        num_heads = max(2, min(4, self.num_heads))
        num_kv = max(1, min(self.num_kv_heads, num_heads))
        head_dim = max(16, d_model // num_heads)
        d_model = num_heads * head_dim
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(2, self.moe.top_k),
                num_shared_experts=min(1, self.moe.num_shared_experts),
                d_ff_expert=64, d_ff_shared=128)
        return dataclasses.replace(
            self, num_layers=num_layers, d_model=d_model, num_heads=num_heads,
            num_kv_heads=num_kv, head_dim=head_dim,
            d_ff=0 if self.d_ff == 0 else 4 * d_model,
            vocab_size=vocab_size, moe=moe,
            rglru_d_state=d_model if self.rglru_d_state else 0,
            encoder_layers=min(2, self.encoder_layers),
            encoder_frames=min(16, self.encoder_frames),
            encoder_d_model=d_model if self.encoder_d_model else 0,
            num_patches=min(8, self.num_patches),
            attn_window=None if self.attn_window is None
            else min(self.attn_window, seq_cap // 2),
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One input shape of the dry-run (``launch/dryrun.py``): a global
    batch of ``seq_len`` tokens for a train step, a prefill or a decode
    step over a cache of ``seq_len`` positions."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 8.0
    scaling: str = "sfedlora"      # lora | rslora | sfedlora | za | zb
    targets: Tuple[str, ...] = ("q", "v")
    init_std: float = 0.02
    # heterogeneous clients: one rank per client (len == num_clients)
    ranks: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True)
class FederatedConfig:
    num_clients: int = 3
    local_steps: int = 10
    rounds: int = 100
    aggregation: str = "fedsa"     # fedit | ffa | fedsa | rolora
    partition: str = "iid"         # iid | dirichlet
    dirichlet_alpha: float = 0.5
    participation: float = 1.0     # fraction of clients sampled per round
    # weight the server aggregate by per-client example counts
    # (dataset.size_weights) instead of a plain client mean
    weight_by_size: bool = False
    # --- async buffered aggregation and fault injection
    # (core/federated.make_buffered_round_body): buffer_size None with
    # faults None is the synchronous engine; anything else switches the
    # trainer to the buffered one.
    buffer_size: Optional[int] = None   # max accepted uploads a round; 0 = N
    staleness_beta: float = 0.5    # staleness discount (1 + tau) ** -beta
    screen_updates: bool = True    # reject non-finite / norm-outlier uploads
    screen_norm_mult: float = 10.0  # outlier: norm > mult x round median
    faults: Optional[object] = None  # core.faults.FaultConfig


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "sgd"              # sgd | adamw
    lr: float = 5e-3
    momentum: float = 0.0
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    lr_schedule: str = "constant"     # constant | warmup_cosine | step
    lr_schedule_kwargs: Optional[dict] = None
