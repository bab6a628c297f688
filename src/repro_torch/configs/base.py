"""Model/config system (a copy of the JAX package's ``repro.configs.base``,
kept here so the port never imports the JAX package): one frozen dataclass drives every architecture
family (dense / moe / vlm / ssm / audio / hybrid) plus the paper's CNNs.

Every assigned architecture gets a module in this package exposing
``CONFIG`` (the exact published geometry) and ``SMOKE`` (a reduced same-
family config for CPU tests).  ``repro_torch.configs.registry`` maps ``--arch``
ids to them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str         # dense | moe | vlm | ssm | mamba | audio | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1              # every Nth layer is MoE (llama4: 2)
    moe_capacity_factor: float = 1.25
    dense_residual_ff: int = 0      # arctic: parallel dense MLP width

    # --- SSM / hybrid ---
    ssm_state: int = 0              # N (state size per channel)
    ssm_head_dim: int = 64          # P
    ssm_expand: int = 2             # d_inner = expand * d_model
    attn_every: int = 0             # zamba2: shared attn block cadence

    # --- RWKV ---
    rwkv_head_dim: int = 64

    # --- encoder-decoder (audio) ---
    encoder_layers: int = 0
    encoder_frames: int = 1500      # whisper 30 s @ 50 Hz (post-conv stub)

    # --- VLM ---
    vision_tokens: int = 0          # stubbed patch embeddings per image

    # --- common knobs ---
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0      # chatglm3 rotates half the head dim
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # --- training-system knobs ---
    optimizer: str = "adamw"        # "adamw" | "adafactor" (giant MoE)
    remat: bool = True
    max_microbatch_tokens: int = 8192   # per-DP-shard grad-accum slice
    use_pallas_kernels: bool = False    # TPU hot path; XLA path for dry-run
    scan_layers: bool = True            # False: unroll (cost-extrapolation)

    # --- beyond-paper performance knobs (§Perf; default = paper-faithful
    # baseline behaviour) ---
    bf16_reduce: bool = False       # bf16 partial sums across TP boundaries
    remat_policy: str = "nothing"   # "nothing" | "save_coll" | "dots"
    rwkv_pad_heads_to: int = 0      # pad WKV heads to a TP multiple (0=off)
    fsdp: bool = False              # weight-gathered parallelism: batch over
                                    # ALL mesh axes, params 2D-sharded; wire
                                    # cost ~ params/layer instead of
                                    # activations (wins when tokens*d >>
                                    # layer params — the train_4k regime)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 (Megatron-style padding) so the vocab dim
        always divides the TP degree; padded logit slots are masked."""
        return -(-self.vocab_size // 256) * 256

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def is_attention_free(self) -> bool:
        return self.family in ("ssm", "mamba")

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: recurrent-state families only."""
        return self.family in ("ssm", "mamba", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def moe_layer_ids(self) -> Tuple[int, ...]:
        if not self.num_experts:
            return ()
        return tuple(i for i in range(self.num_layers) if (i % self.moe_every) == self.moe_every - 1)

    # ------------------------------------------------------------------
    # Parameter / FLOP accounting (roofline MODEL_FLOPS = 6*N*D).
    # ------------------------------------------------------------------

    def param_count(self) -> int:
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        dense_mlp = 3 * d * ff
        n = 0
        if self.family in ("dense", "moe", "vlm"):
            moe_ids = set(self.moe_layer_ids())
            for i in range(self.num_layers):
                n += attn + 2 * d
                if i in moe_ids:
                    n += self.num_experts * 3 * d * ff + d * self.num_experts
                    n += 3 * d * self.dense_residual_ff
                else:
                    n += dense_mlp
        elif self.family == "ssm":  # rwkv6: 5 dxd tmix mats + cr + relu^2 ffn
            per = 6 * d * d + 2 * d * ff + 64 * d + 12 * d
            n = self.num_layers * per
        elif self.family == "mamba":  # mamba2: mixer blocks only (no FFN)
            di = self.d_inner
            per = (d * (2 * di + 2 * self.ssm_state + self.ssm_heads)
                   + 4 * (di + 2 * self.ssm_state) + di * d + di + d)
            n = self.num_layers * per + d
        elif self.family == "hybrid":  # zamba2: mamba blocks + one shared attn
            di = self.d_inner
            per = (d * (2 * di + 2 * self.ssm_state + self.ssm_heads)
                   + 4 * (di + 2 * self.ssm_state) + di * d + di + d)
            n = self.num_layers * per + (attn + d) + d
        elif self.family == "audio":
            gelu_mlp = 2 * d * ff
            enc = self.encoder_layers * (attn + gelu_mlp + 2 * d)
            dec = self.num_layers * (2 * attn + gelu_mlp + 3 * d)
            n = enc + dec + self.encoder_frames * d + 32768 * d + 2 * d
        n += v * d * (1 if self.tie_embeddings else 2)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.num_experts:
            return self.param_count()
        full = self.param_count()
        moe_layers = len(self.moe_layer_ids())
        all_experts = moe_layers * self.num_experts * 3 * self.d_model * self.d_ff
        active = moe_layers * self.experts_per_token * 3 * self.d_model * self.d_ff
        return full - all_experts + active

    def model_flops_per_token(self, training: bool = True) -> float:
        """6*N_active per token for train (fwd+bwd), 2*N_active for inference."""
        mult = 6.0 if training else 2.0
        return mult * self.active_param_count()


def with_depth(cfg: ModelConfig, k: int) -> ModelConfig:
    """Depth-k variant (k scan units, layers UNROLLED) for the dry-run's
    cost extrapolation: cost(full) = cost(k=1) + (D-1)*(cost(k=2)-cost(k=1)),
    because XLA's cost_analysis counts a scanned body once (see
    roofline/analysis.py).  Structure per family:
      dense/moe/vlm: k super-blocks;  ssm: k layers;
      hybrid: k super-blocks (tail dropped);  audio: k enc + k dec layers.
    """
    me = max(cfg.moe_every, 1) if cfg.num_experts else 1
    over = dict(scan_layers=False, name=f"{cfg.name}-d{k}")
    if cfg.family == "hybrid":
        over["num_layers"] = k * cfg.attn_every
    elif cfg.family == "audio":
        over["num_layers"] = k
        over["encoder_layers"] = k
    else:
        over["num_layers"] = k * me
    return dataclasses.replace(cfg, **over)


def depth_units(cfg: ModelConfig) -> int:
    """Number of scan units D in the full config (matches with_depth)."""
    me = max(cfg.moe_every, 1) if cfg.num_experts else 1
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every  # tail counted via remainder
    if cfg.family == "audio":
        return cfg.num_layers  # enc and dec both scale with k
    return cfg.num_layers // me


def scale_down(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Build the reduced same-family SMOKE config."""
    base = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_frames=16 if cfg.encoder_layers else cfg.encoder_frames,
        num_experts=8 if cfg.num_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.num_experts else 0,
        # drop-free capacity so decode == teacher-forced forward exactly
        moe_capacity_factor=64.0 if cfg.num_experts else cfg.moe_capacity_factor,
        vision_tokens=8 if cfg.vision_tokens else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if (cfg.ssm_state or cfg.family == "ssm") else cfg.ssm_head_dim,
        rwkv_head_dim=16,
        attn_every=2 if cfg.attn_every else 0,
        max_microbatch_tokens=1 << 30,  # no grad accum in smoke tests
        name=cfg.name + "-smoke",
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
