"""Assigned architecture registry: exact configs from the assignment table.

Every entry is selectable via ``--arch <id>`` in the launchers.  Per-arch
divergences from upstream implementations are recorded in ``notes`` and in
DESIGN.md §Arch-applicability.
"""
from __future__ import annotations

from typing import Dict, List

from ..models.config import ModelConfig

ARCHS: Dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


# --- [ssm] SSD (state-space duality), arXiv:2405.21060 ----------------------
mamba2_130m = _register(ModelConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
    vocab_size=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    conv_width=4, tie_embeddings=True, d_ff=0, optimizer="adamw",
    notes="attention-free; runs long_500k (sub-quadratic decode state)"))

# --- [dense] InternLM2-20B, arXiv:2403.17297 --------------------------------
internlm2_20b = _register(ModelConfig(
    name="internlm2-20b", family="dense", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=16384, vocab_size=92544,
    rope_theta=1e6))

# --- [dense] SmolLM-360M (llama-arch small) ---------------------------------
smollm_360m = _register(ModelConfig(
    name="smollm-360m", family="dense", n_layers=32, d_model=960,
    n_heads=15, n_kv_heads=5, head_dim=64, d_ff=2560, vocab_size=49152,
    tie_embeddings=True, rope_theta=1e4,
    notes="15 heads indivisible by 16-way TP → attention TP falls back to "
          "replication (rules drop non-dividing assignments); MLP/vocab shard"))

# --- [dense] Qwen2.5-32B (GQA, QKV bias) ------------------------------------
qwen2_5_32b = _register(ModelConfig(
    name="qwen2.5-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=40, n_kv_heads=8, head_dim=128, d_ff=27648, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6,
    notes="40 heads % 16 != 0 → attention heads replicated under TP; the "
          "27648-wide MLP (84% of layer FLOPs) keeps full TP"))

# --- [dense] StableLM-2-1.6B (MHA kv=32) ------------------------------------
stablelm_1_6b = _register(ModelConfig(
    name="stablelm-1.6b", family="dense", n_layers=24, d_model=2048,
    n_heads=32, n_kv_heads=32, head_dim=64, d_ff=5632, vocab_size=100352,
    rope_theta=1e4,
    notes="upstream uses partial-rotary (25%); we apply full RoPE (documented)"))

# --- [audio] Whisper-base enc-dec, arXiv:2212.04356 -------------------------
whisper_base = _register(ModelConfig(
    name="whisper-base", family="encdec", n_layers=6, n_encoder_layers=6,
    d_model=512, n_heads=8, n_kv_heads=8, head_dim=64, d_ff=2048,
    vocab_size=51865, act="gelu", use_rope=False, tie_embeddings=True,
    notes="conv frontend stubbed: input_specs feeds precomputed frame "
          "embeddings (B,S,D); learned abs pos; RMSNorm in place of LN"))

# --- [hybrid] Jamba-1.5-large 398B, arXiv:2403.19887 ------------------------
jamba_1_5_large = _register(ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid", n_layers=72, d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=24576, vocab_size=65536,
    n_experts=16, moe_top_k=2, moe_layer_period=2, moe_layer_offset=1,
    attn_layer_period=8, attn_layer_offset=4,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    optimizer="adafactor", use_rope=False,
    notes="mamba+attn 1:7 interleave, MoE every other layer; upstream uses "
          "Mamba-1 + no positional encoding — we use the SSD (Mamba-2) mixer "
          "uniformly and no RoPE (matching Jamba); adafactor (398B params "
          "cannot carry AdamW state on one v5e pod); runs long_500k"))

# --- [moe] Granite-3.0-1B-A400M ----------------------------------------------
granite_moe_1b = _register(ModelConfig(
    name="granite-moe-1b-a400m", family="moe", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=8, head_dim=64, d_ff=512, d_ff_expert=512,
    vocab_size=49155, n_experts=32, moe_top_k=8, tie_embeddings=True,
    rope_theta=1e4))

# --- [moe] Kimi-K2 1T-A32B (paper-table) -------------------------------------
kimi_k2_1t = _register(ModelConfig(
    name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=2048, d_ff_expert=2048,
    vocab_size=163840, n_experts=384, moe_top_k=8,
    optimizer="adafactor", rope_theta=1e6,
    notes="assignment specifies GQA kv=8 (real K2 uses MLA — we follow the "
          "assignment); adafactor: 1T params exceed AdamW state on 256 chips; "
          "train_4k memory needs the 512-chip multi-pod mesh (see roofline)"))

# --- [vlm] InternVL2-26B (InternViT stub + InternLM2-20B backbone) -----------
internvl2_26b = _register(ModelConfig(
    name="internvl2-26b", family="vlm", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=16384, vocab_size=92553,
    n_prefix_embeds=1024, rope_theta=1e6,
    notes="ViT frontend stubbed: input_specs feeds 1024 precomputed patch "
          "embeddings per sample; backbone = InternLM2-20B"))


# Beyond-paper optimized variants (§Perf hillclimb winners), per shape kind.
# The registry configs stay the paper-faithful baselines; these overrides are
# applied by ``dryrun --optimized`` and recorded separately in EXPERIMENTS.md.
# Scoping is measured, not assumed: dp_only requires global_batch ≥ chips
# (train_4k only — prefill_32k's batch of 32 would replicate 256×), and
# shard_map MoE wins on train+prefill but regresses single-token decode
# (gspmd fallback built into moe_shard_map).
_DP_ONLY_TRAIN = {"train": {"sharding_profile": "dp_only"}}
_SHARD_MAP_MOE = {"train": {"moe_impl": "shard_map"},
                  "prefill": {"moe_impl": "shard_map"}}
OPTIMIZED = {
    "smollm-360m": {"train": {"sharding_profile": "dp_only",
                              "remat": "dots_nb"}},
    "granite-moe-1b-a400m": _SHARD_MAP_MOE,
    "kimi-k2-1t-a32b": _SHARD_MAP_MOE,
    "jamba-1.5-large-398b": _SHARD_MAP_MOE,
    "mamba2-130m": _DP_ONLY_TRAIN,
    "whisper-base": _DP_ONLY_TRAIN,
}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]


def names() -> List[str]:
    return list(ARCHS)
