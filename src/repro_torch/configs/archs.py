"""The architectures of the reference package (``repro.configs.archs``),
entry for entry, so a name means the same config in both packages.

Each entry records the published config it was taken from.  Reduced smoke
variants come from :func:`repro_torch.configs.base.smoke_model`.  The port
serves every family: decoder-only through :mod:`repro_torch.models.lm`,
whisper through :mod:`repro_torch.models.encdec`.
"""
from __future__ import annotations

from repro_torch.configs.base import LayerSpec, ModelConfig

A = LayerSpec  # shorthand

# jamba-1.5-large-398b [hybrid]: 72L, d=8192, 64H (kv=8), d_ff=24576,
# vocab=65536, MoE 16e top-2, Mamba+attn 1:7 interleave [arXiv:2403.19887].
# Period-8 block: positions 0..7, attention at position 4 (as in Jamba),
# MoE on every odd position (period 2) -> lcm(2,8)=8 block.
_jamba_block = tuple(
    LayerSpec(mixer=("attn" if i == 4 else "mamba"),
              mlp=("moe" if i % 2 == 1 else "dense"))
    for i in range(8)
)

JAMBA = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    pattern=_jamba_block,
    num_experts=16, experts_per_token=2, moe_d_ff=24576,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_conv_kernel=4,
    ssm_groups=1, mlp_gated=True, rope_theta=1e6,
)

# granite-34b [dense]: 88L, d=6144, 48H (kv=1 MQA), d_ff=24576, vocab=49152.
# GPT-BigCode style code model: MQA + non-gated MLP [arXiv:2405.04324].
GRANITE = ModelConfig(
    name="granite-34b", family="dense",
    num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1, head_dim=128,
    d_ff=24576, vocab_size=49152,
    mlp_gated=False, rope_theta=1e5,
)

# gemma2-27b [dense]: 46L, d=4608, 32H (kv=16), d_ff=36864, vocab=256000.
# Alternating local(4096-window)/global attention, attn softcap 50,
# final-logit softcap 30, post-norms [arXiv:2408.00118].
GEMMA2 = ModelConfig(
    name="gemma2-27b", family="dense",
    num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000,
    pattern=(A(mixer="attn_local"), A(mixer="attn")),
    sliding_window=4096, attn_softcap=50.0, logit_softcap=30.0,
    use_post_norm=True, tie_embeddings=True, scale_embeddings=True,
    mlp_gated=True,
)

# deepseek-67b [dense]: 95L, d=8192, 64H (kv=8), d_ff=22016, vocab=102400.
# Llama architecture [arXiv:2401.02954].
DEEPSEEK = ModelConfig(
    name="deepseek-67b", family="dense",
    num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=102400, mlp_gated=True,
)

# qwen2-1.5b [dense]: 28L, d=1536, 12H (kv=2), d_ff=8960, vocab=151936.
# GQA with QKV bias, tied embeddings [arXiv:2407.10671].
QWEN2 = ModelConfig(
    name="qwen2-1.5b", family="dense",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936,
    qkv_bias=True, tie_embeddings=True, mlp_gated=True, rope_theta=1e6,
)

# phi3.5-moe-42b-a6.6b [moe]: 32L, d=4096, 32H (kv=8), expert d_ff=6400,
# vocab=32064, 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct].
PHI35_MOE = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=6400, vocab_size=32064,
    pattern=(A(mlp="moe"),),
    num_experts=16, experts_per_token=2, moe_d_ff=6400, mlp_gated=True,
)

# qwen3-moe-235b-a22b [moe]: 94L, d=4096, 64H (kv=4), expert d_ff=1536,
# vocab=151936, 128 experts top-8, qk-norm [hf:Qwen/Qwen3-30B-A3B family].
QWEN3_MOE = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936,
    pattern=(A(mlp="moe"),),
    num_experts=128, experts_per_token=8, moe_d_ff=1536,
    qk_norm=True, mlp_gated=True, rope_theta=1e6,
)

# mamba2-780m [ssm]: 48L, d=1536, attn-free, vocab=50280, ssm_state=128.
# SSD (state-space duality) [arXiv:2405.21060].
MAMBA2 = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    pattern=(A(mixer="mamba", mlp="none"),),
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv_kernel=4,
    ssm_groups=1, tie_embeddings=True,
)

# pixtral-12b [vlm]: 40L, d=5120, 32H (kv=8), d_ff=14336, vocab=131072.
# pixtral-ViT frontend is a STUB (precomputed patch embeddings);
# backbone is mistral-nemo style [hf:mistralai/Pixtral-12B-2409].
PIXTRAL = ModelConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072, mlp_gated=True, rope_theta=1e6,
    frontend="patch", frontend_seq=256,
)

# whisper-small [audio]: 12L enc + 12L dec, d=768, 12H (MHA), d_ff=3072,
# vocab=51865. Conv frontend is a STUB (precomputed frame embeddings)
# [arXiv:2212.04356].
WHISPER = ModelConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51865,
    mlp_gated=False, encoder_layers=12, encoder_seq=1500,
    frontend="audio", pos_embedding="learned", tie_embeddings=True,
)

ARCHS: dict[str, ModelConfig] = {
    "jamba-1.5-large-398b": JAMBA,
    "granite-34b": GRANITE,
    "gemma2-27b": GEMMA2,
    "deepseek-67b": DEEPSEEK,
    "qwen2-1.5b": QWEN2,
    "phi3.5-moe-42b-a6.6b": PHI35_MOE,
    "qwen3-moe-235b-a22b": QWEN3_MOE,
    "mamba2-780m": MAMBA2,
    "pixtral-12b": PIXTRAL,
    "whisper-small": WHISPER,
}

# long_500k requires sub-quadratic attention; the memory-feasible decoders
# are the SSM/hybrid archs + gemma2 (alternating local windows; SP-sharded
# global cache fits).  Pure full-attention archs skip.
LONG_CONTEXT_OK = {"jamba-1.5-large-398b", "mamba2-780m", "gemma2-27b"}


def skip_reason(arch: str, shape: str) -> str | None:
    if shape == "long_500k" and arch not in LONG_CONTEXT_OK:
        return "full-attention arch: 500k decode cache infeasible (DESIGN §5)"
    return None
