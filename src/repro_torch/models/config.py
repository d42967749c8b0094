"""Single config language for all assigned architectures (a copy of the
reference package's ``models/config.py``; ``torch_dtype`` stands where the
reference has ``jdtype``)."""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab_size: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 128
    d_ff: int = 0                  # dense-FFN width (or per-expert width if MoE-only)
    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 0
    moe_layer_period: int = 1      # MoE at layers i % period == offset
    moe_layer_offset: int = 0
    d_ff_expert: int = 0           # per-expert width (defaults to d_ff)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_width: int = 4
    ssm_chunk: int = 256
    attn_layer_period: int = 0     # hybrid: attention at i % period == offset
    attn_layer_offset: int = 0
    # --- encoder-decoder ---
    n_encoder_layers: int = 0
    # --- modality stubs ---
    n_prefix_embeds: int = 0       # VLM patches / audio frames fed pre-embedded
    # --- misc ---
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 1e6
    act: str = "silu_glu"          # silu_glu | gelu
    use_rope: bool = True
    vocab_pad_to: int = 256
    dtype: str = "bfloat16"
    remat: str = "full"            # full | dots | none
    attn_impl: str = "dense"       # dense | blockwise
    attn_block_q: int = 1024
    attn_block_kv: int = 2048
    optimizer: str = "adamw"       # adamw | adafactor
    attn_batch_shard: bool = False  # reshard attention batch over (dp, tp):
    #                                 recovers the idle model axis when
    #                                 n_heads doesn't divide the TP width
    sharding_profile: str = "default"   # default (FSDP+TP) | dp_only
    attn_softmax_dtype: str = "f32"     # f32 | bf16 — dtype of the
    #                                     *materialized* S×S tensors (exp/probs
    #                                     stay f32 in-register either way)
    moe_impl: str = "gspmd"             # gspmd (auto) | shard_map (explicit
    #                                     local dispatch + output psum — no
    #                                     cross-device token exchange)
    seq_parallel: bool = False          # Megatron-SP: residual stream sharded
    #                                     over the model axis on the sequence
    #                                     dim between blocks (16× smaller
    #                                     stash/norm traffic; AR → AG+RS)
    notes: str = ""

    # ------------------------------------------------------------- derived
    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def d_ff_e(self) -> int:
        return self.d_ff_expert or self.d_ff

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    def layer_plan(self) -> List[Tuple[str, Optional[str]]]:
        """(mixer, ffn) per position within one scan period."""
        period = self.scan_period()
        plan = []
        for i in range(period):
            if self.family == "ssm":
                mixer = "ssm"
            elif self.family == "hybrid":
                mixer = ("attn" if self.attn_layer_period and
                         i % self.attn_layer_period == self.attn_layer_offset
                         else "ssm")
            else:
                mixer = "attn"
            if self.family == "ssm":
                ffn: Optional[str] = None
            elif self.n_experts and i % self.moe_layer_period == self.moe_layer_offset:
                ffn = "moe"
            else:
                ffn = "dense" if self.d_ff else None
            plan.append((mixer, ffn))
        return plan

    def scan_period(self) -> int:
        p = 1
        if self.family == "hybrid" and self.attn_layer_period:
            p = math.lcm(p, self.attn_layer_period)
        if self.n_experts:
            p = math.lcm(p, self.moe_layer_period)
        return p

    @property
    def n_groups_scan(self) -> int:
        period = self.scan_period()
        assert self.n_layers % period == 0, (self.n_layers, period)
        return self.n_layers // period

    # --------------------------------------------------------- param counts
    def param_count(self) -> int:
        """Exact parameter count (excluding negligible norm scales)."""
        D, dh = self.d_model, self.head_dim
        total = self.padded_vocab * D * (1 if self.tie_embeddings else 2)
        enc_extra = 0
        for mixer, ffn in self.layer_plan() * self.n_groups_scan:
            if mixer == "attn":
                total += D * self.n_heads * dh * 2          # wq, wo
                total += D * self.n_kv_heads * dh * 2       # wk, wv
            else:
                d_in, H = self.d_inner, self.ssm_heads
                p_in = 2 * d_in + 2 * self.ssm_groups * self.ssm_state + H
                total += D * p_in + d_in * D
                total += self.conv_width * (d_in + 2 * self.ssm_groups * self.ssm_state)
            if ffn == "dense":
                total += 3 * D * self.d_ff
            elif ffn == "moe":
                total += D * self.n_experts
                total += 3 * D * self.d_ff_e * self.n_experts
        if self.family == "encdec":
            # encoder layers: self-attn + mlp; decoder already counted above
            enc_extra = self.n_encoder_layers * (
                D * self.n_heads * dh * 2 + D * self.n_kv_heads * dh * 2
                + (2 if self.act == "gelu" else 3) * D * self.d_ff)
            # decoder cross-attention
            enc_extra += self.n_layers * (D * self.n_heads * dh * 2
                                          + D * self.n_kv_heads * dh * 2)
        return total + enc_extra

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k of experts)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        moe_layers = sum(1 for m, f in self.layer_plan() if f == "moe") \
            * self.n_groups_scan
        expert_total = 3 * self.d_model * self.d_ff_e * self.n_experts * moe_layers
        expert_active = 3 * self.d_model * self.d_ff_e * self.moe_top_k * moe_layers
        return full - expert_total + expert_active

    def reduced(self, seed_layers: int = 0) -> "ModelConfig":
        """Smoke-test config: same family/pattern, tiny dims."""
        period = self.scan_period()
        return replace(
            self,
            name=self.name + "-smoke",
            n_layers=period * 2 if self.n_layers >= period * 2 else period,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(4, max(1, self.n_kv_heads)) if self.n_kv_heads else 0,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            d_ff_expert=32 if self.d_ff_expert else 0,
            vocab_size=512,
            n_experts=min(self.n_experts, 8),
            moe_top_k=min(self.moe_top_k, 2),
            capacity_factor=8.0,    # drop-free: decode/prefill token counts
            #                         differ from train, so drops would make
            #                         smoke equivalence checks flaky

            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=16,
            n_prefix_embeds=min(self.n_prefix_embeds, 8),
            attn_block_q=32,
            attn_block_kv=32,
            dtype="float32",
        )
