"""--arch registry (a copy of the JAX package's ``repro.configs.registry``):
the 10 assigned architectures (exact published geometries) + reduced SMOKE
variants.  Sources per the assignment sheet."""
from __future__ import annotations

from typing import Dict

from .base import ModelConfig, scale_down

# [arXiv:2402.19173; hf] — GQA, RoPE
STARCODER2_15B = ModelConfig(
    name="starcoder2-15b", family="dense", num_layers=40, d_model=6144,
    num_heads=48, num_kv_heads=4, head_dim=128, d_ff=24576, vocab_size=49152,
    rope_theta=100_000.0,
)

# [arXiv:2407.21783; unverified] — GQA, 128k vocab
LLAMA3_8B = ModelConfig(
    name="llama3-8b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=128256,
    rope_theta=500_000.0,
)

# [arXiv:2406.12793; hf] — RoPE 2d (half-dim rotary), GQA kv=2
CHATGLM3_6B = ModelConfig(
    name="chatglm3-6b", family="dense", num_layers=28, d_model=4096,
    num_heads=32, num_kv_heads=2, head_dim=128, d_ff=13696, vocab_size=65024,
    rope_fraction=0.5,
)

# [arXiv:2401.14196; hf] — llama-arch
DEEPSEEK_CODER_33B = ModelConfig(
    name="deepseek-coder-33b", family="dense", num_layers=62, d_model=7168,
    num_heads=56, num_kv_heads=8, head_dim=128, d_ff=19200, vocab_size=32256,
    rope_theta=100_000.0,
)

# [hf:Snowflake/snowflake-arctic-base; hf] — 128e top-2 + dense residual
ARCTIC_480B = ModelConfig(
    name="arctic-480b", family="moe", num_layers=35, d_model=7168,
    num_heads=56, num_kv_heads=8, head_dim=128, d_ff=4864, vocab_size=32000,
    num_experts=128, experts_per_token=2, moe_every=1, dense_residual_ff=4864,
    optimizer="adafactor",
)

# [hf:meta-llama/Llama-4-Scout...; unverified] — 128e top-1, interleaved MoE
LLAMA4_MAVERICK_400B = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe", num_layers=48, d_model=5120,
    num_heads=40, num_kv_heads=8, head_dim=128, d_ff=8192, vocab_size=202048,
    num_experts=128, experts_per_token=1, moe_every=2,
    optimizer="adafactor", rope_theta=500_000.0,
)

# [arXiv:2404.16821; hf] — InternViT stub + InternLM2 backbone
INTERNVL2_1B = ModelConfig(
    name="internvl2-1b", family="vlm", num_layers=24, d_model=896,
    num_heads=14, num_kv_heads=2, head_dim=64, d_ff=4864, vocab_size=151655,
    vision_tokens=256, rope_theta=1_000_000.0,
)

# [arXiv:2404.05892; hf] — Finch: attention-free, data-dependent decay
RWKV6_3B = ModelConfig(
    name="rwkv6-3b", family="ssm", num_layers=32, d_model=2560,
    num_heads=0, num_kv_heads=0, d_ff=8960, vocab_size=65536,
    rwkv_head_dim=64,
)

# [arXiv:2212.04356; unverified] — enc-dec, conv frontend stubbed
WHISPER_LARGE_V3 = ModelConfig(
    name="whisper-large-v3", family="audio", num_layers=32, d_model=1280,
    num_heads=20, num_kv_heads=20, head_dim=64, d_ff=5120, vocab_size=51866,
    encoder_layers=32, encoder_frames=1500,
)

# [arXiv:2411.15242; hf] — Mamba2 backbone + shared attention blocks
ZAMBA2_1P2B = ModelConfig(
    name="zamba2-1.2b", family="hybrid", num_layers=38, d_model=2048,
    num_heads=32, num_kv_heads=32, head_dim=64, d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, attn_every=6,
)

# --- serving extras (not assigned archs) -----------------------------------
# Like the drafts below, EXTRAS deliberately do NOT live in ARCHS: the
# per-arch smoke/sharding/dryrun matrices cover the 10 assigned
# architectures only.  mamba2-2.7b exists to exercise the *pure*-recurrent
# paged-state serving path (rwkv6 covers attention-free-with-token-shift,
# zamba2 covers hybrid; plain mamba2 is the canonical SSD state machine).
# [arXiv:2405.21060; hf:state-spaces/mamba2-2.7b]
MAMBA2_2P7B = ModelConfig(
    name="mamba2-2.7b", family="mamba", num_layers=64, d_model=2560,
    num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=50288,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
)

EXTRAS: Dict[str, ModelConfig] = {c.name: c for c in (MAMBA2_2P7B,)}


# --- speculative-decoding draft pairings (speculative decoding) ----------------------
# A draft model shares the target's token space (same tokenizer, hence the
# same vocab_size — enforced by the JAX package's check_draft_pair) and
# is small enough that spec_k draft steps cost less than the one target
# forward they amortise.  Drafts deliberately do NOT live in ARCHS: they are
# serving accessories, not assigned architectures, so the per-arch
# smoke/sharding/dryrun test matrices never pick them up.
LLAMA3_8B_DRAFT = ModelConfig(
    name="llama3-8b-draft", family="dense", num_layers=4, d_model=1024,
    num_heads=8, num_kv_heads=2, head_dim=64, d_ff=4096, vocab_size=128256,
    rope_theta=500_000.0,
)

DRAFTS: Dict[str, ModelConfig] = {c.name: c for c in (LLAMA3_8B_DRAFT,)}

#: target arch -> registered draft arch (the launcher's ``--draft-model auto``)
DRAFT_FOR: Dict[str, str] = {"llama3-8b": "llama3-8b-draft"}


def get_draft_config(arch: str, smoke: bool = False, *,
                     pairing: bool = True):
    """Draft config lookup; ``None`` when nothing is registered.

    With ``pairing=True`` (default) ``arch`` names a *target* and resolves
    through ``DRAFT_FOR``; with ``pairing=False`` it must name a draft in
    ``DRAFTS`` directly — the two namespaces are kept separate so an
    explicit draft name that happens to be a target arch errors instead of
    silently serving the target's paired draft.  Smoke drafts scale down
    one notch further than the target's smoke config (single layer) so the
    draft stays cheaper than its target even at smoke scale."""
    name = (DRAFT_FOR.get(arch) if pairing
            else (arch if arch in DRAFTS else None))
    if name is None:
        return None
    cfg = DRAFTS[name]
    return scale_down(cfg, num_layers=1) if smoke else cfg


ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (
        STARCODER2_15B, LLAMA3_8B, CHATGLM3_6B, DEEPSEEK_CODER_33B,
        ARCTIC_480B, LLAMA4_MAVERICK_400B, INTERNVL2_1B, RWKV6_3B,
        WHISPER_LARGE_V3, ZAMBA2_1P2B,
    )
}

SMOKE: Dict[str, ModelConfig] = {}
for _n, _c in ARCHS.items():
    _over = {}
    if _c.family == "hybrid":
        _over = dict(num_layers=5, attn_every=2)      # 2 super-blocks + tail
    elif _c.family == "moe":
        _over = dict(num_layers=2 * max(_c.moe_every, 1))
    SMOKE[_n] = scale_down(_c, **_over)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    table = SMOKE if smoke else ARCHS
    if arch in table:
        return table[arch]
    if arch in EXTRAS:
        cfg = EXTRAS[arch]
        return scale_down(cfg) if smoke else cfg
    raise KeyError(f"unknown arch {arch!r}; available: "
                   f"{sorted(set(table) | set(EXTRAS))}")
