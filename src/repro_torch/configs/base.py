"""Model and run configuration: the port's own copy of
``repro.configs.base`` (the reference package is never imported).

A :class:`ModelConfig` describes one architecture, a :class:`RunConfig`
binds it to a shape and a compute dtype.  The fields, defaults, derived
quantities and :data:`SHAPES` are the reference's, so a config means the
same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer position inside the repeating block.

    mixer: "attn" | "attn_local" | "mamba"
    mlp:   "dense" | "moe" | "none"
    """
    mixer: str = "attn"
    mlp: str = "dense"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # repeating layer pattern; len(pattern) must divide num_layers.
    pattern: Sequence[LayerSpec] = (LayerSpec(),)

    # --- attention details ---
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: Optional[float] = None     # gemma2: 50.0
    logit_softcap: Optional[float] = None    # gemma2: 30.0
    sliding_window: Optional[int] = None     # window for "attn_local" mixers
    rope_theta: float = 10000.0
    pos_embedding: str = "rope"              # "rope" | "learned" | "none"
    max_position: int = 0                    # learned-pos table size (0=auto)
    use_post_norm: bool = False              # gemma2 post-layer norms

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_kernel: int = 4
    ssm_groups: int = 1

    # --- MLP style ---
    mlp_gated: bool = True                   # llama-style SwiGLU vs plain GELU

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0                  # >0 => encoder-decoder
    encoder_seq: int = 0                     # stub frontend sequence length

    # --- modality frontend stubs ---
    frontend: Optional[str] = None           # "patch" | "audio" | None
    frontend_seq: int = 0                    # extra prefix embeddings per seq

    # --- misc ---
    tie_embeddings: bool = False
    scale_embeddings: bool = False           # gemma-style sqrt(d) embed scale
    norm_eps: float = 1e-6
    vocab_pad_to: int = 256
    # attention implementation: chunked flash path beyond this many kv tokens
    attn_chunk: int = 2048

    # ---- derived ----
    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab_size + p - 1) // p * p

    @property
    def d_inner(self) -> int:                # SSD inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def full_pattern(self) -> Sequence[LayerSpec]:
        if self.num_layers % len(self.pattern):
            raise ValueError(f"{self.name}: pattern {len(self.pattern)} "
                             f"does not divide {self.num_layers} layers")
        return tuple(self.pattern)

    @property
    def num_blocks(self) -> int:
        return self.num_layers // len(self.pattern)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model FLOPs)."""
        d, v = self.d_model, self.padded_vocab
        n = v * d
        if not self.tie_embeddings:
            n += v * d
        n += self.num_blocks * sum(
            self._layer_params(spec) for spec in self.full_pattern)
        if self.encoder_layers:
            n += self.encoder_layers * self._layer_params(
                LayerSpec("attn", "dense"))
            # decoder cross-attention blocks (+ their norms)
            n += self.num_layers * (self._attn_params() + self.d_model)
        return n

    def _attn_params(self) -> int:
        d, h, kv, hd = self.d_model, self.num_heads, self.num_kv_heads, \
            self.head_dim
        p = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.qkv_bias:
            p += (h + 2 * kv) * hd
        return p

    def _layer_params(self, spec: LayerSpec) -> int:
        d = self.d_model
        n = 2 * d  # norms
        if spec.mixer in ("attn", "attn_local"):
            n += self._attn_params()
        elif spec.mixer == "mamba":
            din, st, g, nh = (self.d_inner, self.ssm_state, self.ssm_groups,
                              self.ssm_heads)
            n += d * (2 * din + 2 * g * st + nh)      # in_proj
            n += self.ssm_conv_kernel * (din + 2 * g * st)  # conv
            n += din * d                              # out_proj
            n += 3 * nh                               # A, D, dt_bias
        if spec.mlp == "dense":
            mult = 3 if self.mlp_gated else 2
            n += mult * d * self.d_ff
        elif spec.mlp == "moe":
            mult = 3 if self.mlp_gated else 2
            n += self.num_experts * mult * d * self.moe_d_ff
            n += d * self.num_experts                 # router
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        d = self.d_model
        n = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        for spec in self.full_pattern:
            ln = self._layer_params(spec)
            if spec.mlp == "moe":
                mult = 3 if self.mlp_gated else 2
                ln -= self.num_experts * mult * d * self.moe_d_ff
                ln += self.experts_per_token * mult * d * self.moe_d_ff
            n += self.num_blocks * ln
        return n


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """The reference's run configuration, field for field.

    Serving reads ``compute_dtype``, ``use_pallas``, ``moe_impl``,
    ``attn_causal_skip`` and ``seq_parallel`` (which keeps q whole in the
    chunked attention, as the reference does).  Training also reads
    ``optimizer``, ``learning_rate``, ``weight_decay``, ``grad_clip``,
    ``remat``, ``microbatches``, ``param_dtype`` (the weights of
    ``train_step.init_train_state``) and ``model``.  ``grad_compression``
    is read by neither package: the compressed data-parallel step is
    built with ``train.grad_compression.make_compressed_dp_step``.
    ``shard_grads`` makes the train steps place their gradient trees like
    the parameters (``train_step.constrain_like_params``: DTensor leaves
    in the training rules' layout, where the sharded step's gradients
    already arrive; plain leaves unchanged).  ``multi_pod`` names the 2 x
    16 x 16 production mesh (``launch.mesh.make_production_mesh``; the
    launcher's ``--multi-pod``), and ``serve_tp`` picks the TP-only serving
    rules and bf16 weights in ``launch.dryrun``.  ``seed`` is the
    reference's; the launchers take ``--seed``."""
    model: ModelConfig
    shape: ShapeConfig
    multi_pod: bool = False
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    remat: str = "full"
    microbatches: int = 1
    moe_impl: str = "aam"
    attn_causal_skip: bool = False
    shard_grads: bool = False
    serve_tp: bool = False
    seq_parallel: bool = False
    # the hand-written kernels where the reference has Pallas ones (the SSD
    # chunk); False runs the plain einsum path.  The MoE's bucket count
    # runs its kernel either way (plan_buckets_sorted's default).
    use_pallas: bool = False
    grad_compression: str = "none"
    seed: int = 0


def smoke_model(cfg: ModelConfig) -> ModelConfig:
    """Shrink a config to a CPU-runnable smoke variant of the same family."""
    pat = cfg.full_pattern
    # keep one full pattern block (preserves heterogeneity)
    num_layers = len(pat)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=num_layers,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        vocab_size=503,          # deliberately ragged to exercise padding
        vocab_pad_to=64,
        sliding_window=32 if cfg.sliding_window else None,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=24 if cfg.encoder_seq else 0,
        frontend_seq=8 if cfg.frontend_seq else 0,
        attn_chunk=64,
    )
