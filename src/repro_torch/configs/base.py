"""Architecture config schema + parameter-count accounting.

A copy of ``repro.configs.base`` kept inside the port, so that the port
never imports the JAX package (``import repro.configs`` runs
``repro/__init__.py``, which loads JAX).  One ``ArchCfg`` describes every
architecture; ``reduced()`` produces the CPU-test variant of the same
family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchCfg:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    block: str                     # dense | moe | mla_moe | xlstm | rglru_hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    window: Optional[int] = None   # sliding-window attention size
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0              # per-expert hidden
    n_dense_layers: int = 0        # leading dense layers (DeepSeek-V3: 3)
    moe_capacity_factor: float = 1.25
    # --- MLA (DeepSeek) ---
    mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    mtp: bool = False              # multi-token-prediction aux head
    # --- xLSTM ---
    slstm_every: int = 0           # one sLSTM per this many layers (0 = none)
    # --- hybrid (RecurrentGemma) ---
    pattern: Tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    d_rnn: int = 0
    # --- enc-dec (Seamless) ---
    n_enc_layers: int = 0
    # --- VLM ---
    n_patches: int = 0             # vision-stub prefix length
    # --- serving ---
    eos_token: Optional[int] = None  # default stop token for generation
    # --- FFN flavour ---
    gated_mlp: bool = True         # SwiGLU-style (3 mats) vs plain (2 mats)
    mlp_activation: str = "silu"
    # --- numerics ---
    dtype: str = "bfloat16"
    tie_embeddings: bool = True
    remat: bool = True
    mlstm_chunk: int = 256
    # Unroll layer-stack scans. Compiled code is identical per layer; the
    # dry-run sets this so XLA cost analysis counts every layer (while-loop
    # bodies are otherwise counted once — see EXPERIMENTS.md §Dry-run).
    scan_unroll: bool = False
    # XLA-path attention: "naive" full-T^2 softmax vs "chunked" online
    # softmax (flash semantics; §Perf iteration 3).  The Pallas kernel is
    # always flash-structured.
    attention_impl: str = "naive"
    # ZeRO stage: FSDP-shard params over the dp axes (True) or replicate
    # them there (False; right for small models where the per-layer
    # all-gathers dominate collectives — §Perf iteration 4).
    fsdp: bool = True
    # Tensor-parallelism: shard weights on the model axis (True).  False
    # replicates weights across the model axis — the right call for small
    # models whose TP'd activations generate more collective traffic than
    # the whole gradient all-reduce (§Perf iteration 4b).
    tp: bool = True

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    # ---------------- parameter accounting (for rooflines) ----------------

    def _attn_params(self) -> int:
        d = self.d_model
        if self.mla:
            qk = self.qk_nope_dim + self.qk_rope_dim
            return (d * self.q_lora_rank
                    + self.q_lora_rank * self.n_heads * qk
                    + d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank * self.n_heads
                    * (self.qk_nope_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d)
        dh = self.dh
        return d * dh * (self.n_heads * 2 + self.n_kv_heads * 2)

    def _mlp_params(self, d_ff: int) -> int:
        return (3 if self.gated_mlp else 2) * self.d_model * d_ff

    def _moe_layer_params(self) -> tuple[int, int]:
        """(total, active) params of one MoE FFN layer."""
        per = self._mlp_params(self.moe_d_ff)
        shared = self._mlp_params(self.moe_d_ff * self.n_shared_experts) \
            if self.n_shared_experts else 0
        router = self.d_model * self.n_experts
        total = per * self.n_experts + shared + router
        active = per * self.top_k + shared + router
        return total, active

    def _xlstm_layer_params(self) -> int:
        d, h = self.d_model, self.n_heads
        dk = dv = d // h
        return d * h * (2 * dk + 2 * dv) + 2 * d * h + h * dv * d

    def _rglru_layer_params(self) -> int:
        d, dr = self.d_model, self.d_rnn
        return 2 * d * dr + 2 * dr * dr + dr * d

    def param_counts(self) -> tuple[int, int]:
        """(total, active) parameter counts (embeddings included once)."""
        d = self.d_model
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        total = active = emb
        if self.block in ("dense",):
            per = self._attn_params() + self._mlp_params(self.d_ff)
            total += per * self.n_layers
            active = total
        elif self.block in ("moe", "mla_moe"):
            attn = self._attn_params()
            moe_t, moe_a = self._moe_layer_params()
            n_moe = self.n_layers - self.n_dense_layers
            dense = self._mlp_params(self.d_ff) * self.n_dense_layers
            total += (attn * self.n_layers + dense + moe_t * n_moe)
            active += (attn * self.n_layers + dense + moe_a * n_moe)
        elif self.block == "xlstm":
            per = self._xlstm_layer_params()
            total += per * self.n_layers
            active = total
        elif self.block == "rglru_hybrid":
            n_attn = self.n_layers // len(self.pattern) * self.pattern.count(
                "attn")
            n_rec = self.n_layers - n_attn
            total += (self._attn_params() * n_attn
                      + self._rglru_layer_params() * n_rec
                      + self._mlp_params(self.d_ff) * self.n_layers)
            active = total
        elif self.block == "encdec":
            # enc: self-attn + mlp; dec: self + cross + mlp
            enc = (self._attn_params() + self._mlp_params(self.d_ff)
                   ) * self.n_enc_layers
            dec = (2 * self._attn_params() + self._mlp_params(self.d_ff)
                   ) * self.n_layers
            total += enc + dec
            active = total
        else:
            raise ValueError(self.block)
        return total, active

    def reduced(self) -> "ArchCfg":
        """Small same-family variant for CPU smoke tests."""
        updates = dict(
            n_layers=max(2, min(4, self.n_layers // 16)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 1,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            dtype="float32",
            remat=False,
            mlstm_chunk=16,
        )
        if self.block in ("moe", "mla_moe"):
            updates.update(n_experts=4, top_k=2, moe_d_ff=64,
                           n_dense_layers=min(1, self.n_dense_layers))
        if self.mla:
            updates.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                           qk_rope_dim=8, v_head_dim=16, head_dim=None)
        if self.block == "xlstm":
            updates.update(n_layers=max(self.slstm_every or 2, 4),
                           head_dim=None)
        if self.block == "rglru_hybrid":
            updates.update(n_layers=2 * len(self.pattern), d_rnn=128,
                           head_dim=32)
        if self.block == "encdec":
            updates.update(n_enc_layers=2, n_layers=2)
        if self.window:
            updates.update(window=8)
        if self.n_patches:
            updates.update(n_patches=4)
        return dataclasses.replace(self, **updates)
