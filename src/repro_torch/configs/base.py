"""Model & run configuration dataclasses."""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import ClassVar


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 → d_model // n_heads

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_period: int = 1         # MoE every p-th layer (jamba: 2), rest dense
    moe_impl: str = "dense"     # dense (masked) | ragged (sort + ragged_dot)

    # attention pattern
    sliding_window: int = 0     # 0 = global attention
    local_global_period: int = 0   # gemma3: 6 → 5 local + 1 global per period
    attn_chunk: int = 1024      # flash-style KV chunking (0 = dense scores)
    gqa_grouped: bool = False   # grouped-head einsum (no KV repeat) — §Perf

    # hybrid (jamba): one attention layer per `attn_period` layers, rest Mamba
    attn_period: int = 0
    ssm_state: int = 16
    ssm_expand: int = 2
    ssm_conv: int = 4

    block_type: str = "transformer"   # transformer | jamba | xlstm
    mlp_type: str = "swiglu"          # swiglu | geglu | gelu | relu2
    norm_type: str = "rmsnorm"        # rmsnorm | layernorm
    rope_theta: float = 1e4
    tie_embeddings: bool = False

    # modality frontend stub (backbone-only per assignment)
    frontend: str = "none"            # none | vision | audio
    n_codebooks: int = 1              # musicgen EnCodec streams

    dtype: str = "bfloat16"
    # distribution/training knobs
    remat: bool = True
    scan_layers: bool = True

    # the fields of :class:`PortConfig` (the reference's configurations
    # have none of them): their values for every other configuration
    yarn: ClassVar[tuple] = ()
    expert_first: ClassVar[int] = 0
    experts_held: ClassVar[int] = 0

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def active_params(self) -> int:
        """Active parameters per token (MoE counts top_k experts)."""
        return _param_count(self, active_only=True)

    @property
    def total_params(self) -> int:
        return _param_count(self, active_only=False)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        return replace(
            self,
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            sliding_window=min(self.sliding_window, 32) if
            self.sliding_window else 0,
            local_global_period=self.local_global_period and 2,
            attn_period=self.attn_period and 2,
            ssm_state=min(self.ssm_state, 8),
            attn_chunk=0,
            dtype="float32",
            remat=False,
        )


@dataclass(frozen=True)
class PortConfig(ModelConfig):
    """A configuration of the port alone, beyond the reference's fields."""
    # YaRN on the global layers of a local/global pattern: (factor,
    # original context, beta_fast, beta_slow, attention factor); () = none
    yarn: tuple = ()
    # one device's share of the experts (expert parallelism without its
    # exchange): experts expert_first .. + experts_held - 1 of the
    # n_experts the router routes over (0 = all of them)
    expert_first: int = 0
    experts_held: int = 0

    def reduced(self) -> "PortConfig":
        r = super().reduced()
        return replace(r, expert_first=0,
                       experts_held=min(self.experts_held, r.n_experts))


def _param_count(c: ModelConfig, active_only: bool) -> int:
    d, hd = c.d_model, c.hd
    attn = d * hd * c.n_heads + 2 * d * hd * c.n_kv_heads \
        + hd * c.n_heads * d
    if c.mlp_type in ("swiglu", "geglu"):
        mlp_dense = 3 * d * c.d_ff
    else:
        mlp_dense = 2 * d * c.d_ff
    if c.n_experts:
        e = c.top_k if active_only else c.n_experts
        moe = mlp_dense * e + d * c.n_experts      # router
        n_moe = c.n_layers // max(c.moe_period, 1)
        mlp_avg = (moe * n_moe + mlp_dense * (c.n_layers - n_moe)) \
            / c.n_layers
        mlp = mlp_avg
    else:
        mlp = mlp_dense
    if c.block_type == "jamba":
        di = c.ssm_expand * d
        mamba = d * 2 * di + di * c.ssm_conv + di * (2 * c.ssm_state + 2) \
            + di * d
        n_attn = c.n_layers // max(c.attn_period, 1)
        per = (attn + mlp) * n_attn + (mamba + mlp) * (c.n_layers - n_attn)
        return int(per + 2 * c.vocab * d)
    if c.block_type == "xlstm":
        di = c.ssm_expand * d
        per = (4 * d * di + 4 * di) * c.n_layers
        return per + 2 * c.vocab * d
    return int((attn + mlp + 2 * d) * c.n_layers
               + (1 if c.tie_embeddings else 2) * c.vocab * d)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode | long_decode

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")
