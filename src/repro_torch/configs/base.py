"""Model architectures and input shapes — the port's copy of
``repro.configs.base``.

``ModelConfig``, ``ShapeConfig``, ``INPUT_SHAPES``, ``MeshConfig``, the
registry and ``reduced`` are the reference's, field for field, so a
config named in either package describes the same model; the port
registers all ten assigned architectures.  ``MeshConfig`` is the
production mesh the launch tooling's dry run places a model on
(:mod:`repro_torch.launch.mesh`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

# ---------------------------------------------------------------------------
# Block descriptors
# ---------------------------------------------------------------------------

# mixer ∈ {"attn", "mamba", "mlstm", "slstm"}; ffn ∈ {"mlp", "moe", "none"}
Block = tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense|moe|hybrid|ssm|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    # --- block structure ---------------------------------------------------
    block_pattern: tuple = (("attn", "mlp"),)
    # --- attention ----------------------------------------------------------
    head_dim: int = 0               # 0 -> d_model // num_heads
    qk_norm: bool = False
    attn_bias: bool = False
    # serving-path q/k/v layout constraint (§Perf G-P3): replicate K/V on
    # the model axis when KV heads don't divide it.  Measured: −75 %
    # collective on granite prefill; REGRESSES phi3.5 — per-arch tunable.
    attn_layout_constraint: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0         # 0 = full attention
    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0               # per-expert hidden dim (d_ff if 0)
    capacity_factor: float = 1.25
    moe_dispatch: str = "einsum"    # "einsum" (GSPMD) | "sort" (MegaBlocks-ish)
    expert_pad_to: int = 0          # pad expert count (e.g. 40→48 so the
                                    # expert axis divides the model axis)
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    # --- SSM (mamba) ----------------------------------------------------------
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    # --- encoder-decoder ------------------------------------------------------
    encoder_layers: int = 0         # >0 => enc-dec; num_layers = decoder layers
    # --- modality frontend (STUB per assignment carve-out) --------------------
    frontend: str = "none"          # none|vit_stub|audio_stub
    frontend_tokens: int = 0        # patch/frame positions occupied per example
    # --- misc ------------------------------------------------------------------
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # long-context decode strategy for the long_500k shape:
    #   "native"  — sub-quadratic by construction (ssm / hybrid states)
    #   "swa"     — sliding-window ring cache (Mistral-style)
    #   "cross"   — enc-dec: O(L_enc) cross-attention per decoded token
    long_context_mode: str = "swa"
    remat: bool = True              # activation checkpointing over superblocks
    citation: str = ""

    # ----- derived -----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def pattern_len(self) -> int:
        return len(self.block_pattern)

    @property
    def num_superblocks(self) -> int:
        assert self.num_layers % self.pattern_len == 0, (
            f"{self.name}: {self.num_layers} layers not divisible by "
            f"pattern of length {self.pattern_len}")
        return self.num_layers // self.pattern_len

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so it shards over any
        reasonable model-parallel degree (e.g. granite's 49155 → 49408)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        D, hd = self.d_model, self.hd
        total = self.padded_vocab * D                      # embed
        if not self.tie_embeddings:
            total += self.padded_vocab * D                 # lm head
        def attn_params():
            return D * (self.num_heads * hd) + 2 * D * (self.num_kv_heads * hd) \
                + (self.num_heads * hd) * D + 2 * D  # q,k,v,o + norms
        def mlp_params(ff):
            return 3 * D * ff + D
        def moe_params():
            return (self.num_experts * 3 * D * self.expert_d_ff
                    + D * self.num_experts + D)
        def mamba_params():
            di = self.ssm_expand * D
            return (2 * D * di + di * self.ssm_conv_width
                    + di * (2 * self.ssm_state_dim + 2) + di * D + D)
        def xlstm_params(kind):
            di = 2 * D
            if kind == "mlstm":
                return 2 * D * di + 3 * di + di * D + 2 * D
            return 4 * D * D + 4 * D * D // self.num_heads + 2 * D * D + 2 * D
        per_pattern = 0
        for mixer, ffn in self.block_pattern:
            if mixer == "attn":
                per_pattern += attn_params()
            elif mixer == "mamba":
                per_pattern += mamba_params()
            elif mixer in ("mlstm", "slstm"):
                per_pattern += xlstm_params(mixer)
            if ffn == "mlp":
                per_pattern += mlp_params(self.d_ff)
            elif ffn == "moe":
                per_pattern += moe_params()
        total += per_pattern * self.num_superblocks
        if self.encoder_layers:
            # encoder: self-attn + mlp per layer; decoder cross-attn extra
            total += self.encoder_layers * (attn_params() + mlp_params(self.d_ff))
            total += self.num_layers * attn_params()       # cross-attn
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if not self.num_experts:
            return self.param_count()
        dense = self.param_count() - (
            sum(1 for _, f in self.block_pattern if f == "moe")
            * self.num_superblocks * self.num_experts * 3
            * self.d_model * self.expert_d_ff)
        active = (sum(1 for _, f in self.block_pattern if f == "moe")
                  * self.num_superblocks * self.experts_per_token * 3
                  * self.d_model * self.expert_d_ff)
        return dense + active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# Sliding window used when a full-attention arch runs long_500k in "swa"
# mode (Mistral-style ring cache).
DEFAULT_SWA_WINDOW = 4096


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = 16
    model: int = 16
    pod: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.pod

    @property
    def axis_names(self):
        return (("pod", "data", "model") if self.pod > 1
                else ("data", "model"))

    @property
    def shape(self):
        return ((self.pod, self.data, self.model) if self.pod > 1
                else (self.data, self.model))

    @property
    def batch_axes(self):
        return (("pod", "data") if self.pod > 1 else ("data",))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        load_all()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> dict:
    if not _REGISTRY:
        load_all()
    return dict(_REGISTRY)


ASSIGNED_ARCHS = (
    "pixtral-12b", "jamba-v0.1-52b", "phi3.5-moe-42b-a6.6b",
    "internlm2-20b", "xlstm-1.3b", "granite-moe-3b-a800m", "qwen3-32b",
    "seamless-m4t-medium", "deepseek-7b", "command-r-35b",
)


def load_all() -> None:
    """Import every per-arch config module (they call ``register``)."""
    import importlib
    for arch in ASSIGNED_ARCHS:
        importlib.import_module("repro_torch.configs." + arch.replace(
            "-", "_").replace(".", "_"))


def reduced(cfg: ModelConfig, *, layers: Optional[int] = None,
            d_model: int = 256, vocab: int = 512,
            experts: int = 4) -> ModelConfig:
    """Smoke-test variant of the same family: ≤2 superblocks, d_model ≤ 512,
    ≤ 4 experts (assignment requirement)."""
    pat = cfg.block_pattern
    n_layers = layers or max(len(pat), 2 if len(pat) == 1 else len(pat))
    if n_layers % len(pat) != 0:
        n_layers = len(pat)
    heads = max(2, min(4, cfg.num_heads))
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=n_layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=d_model // heads,
        d_ff=max(64, d_model * 2),
        moe_d_ff=(min(cfg.expert_d_ff, d_model) if cfg.num_experts else 0),
        vocab_size=vocab,
        num_experts=min(cfg.num_experts, experts) if cfg.num_experts else 0,
        experts_per_token=(min(cfg.experts_per_token, 2)
                           if cfg.num_experts else 0),
        encoder_layers=min(cfg.encoder_layers, 2),
        frontend_tokens=min(cfg.frontend_tokens, 8),
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
        remat=False,
    )
