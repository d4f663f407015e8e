"""Architecture configuration schema + registry + assigned input shapes.

Counterpart of ``src/repro/configs/base.py``.  Every assigned architecture
provides one module ``configs/<id>.py`` holding its exact published
configuration (``dtype`` ``torch.bfloat16``) and a reduced variant for CPU
tests (``torch.float32``).  Shapes follow the assignment:

    train_4k     seq 4096   global_batch 256   (training step)
    prefill_32k  seq 32768  global_batch 32    (inference prefill)
    decode_32k   seq 32768  global_batch 128   (single-token decode w/ KV)
    long_500k    seq 524288 global_batch 1     (long-context decode;
                 sub-quadratic archs only)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 256
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mlp_act: str = "silu"           # silu (SwiGLU) | gelu (GeGLU)
    tie_embeddings: bool = False
    # gemma2-style features
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    sliding_window: int = 0         # >0: alternate local/global layers
    post_norms: bool = False
    # MoE / SSM / hybrid
    moe: MoEConfig = MoEConfig()
    ssm: SSMConfig = SSMConfig()
    attn_every: int = 0             # hybrid: shared attn block cadence
    # modality frontend stubs
    frontend: str = "none"          # none | patch (vlm) | frame (audio)
    frontend_len: int = 0           # prepended embedding positions
    # numerics
    dtype: Any = torch.bfloat16
    # which shape cells apply (long_500k only for sub-quadratic archs)
    supports_long_context: bool = False

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 (pad logits are masked to
        -1e30)."""
        return (self.vocab + 255) // 256 * 256

    @property
    def n_experts_padded(self) -> int:
        """Experts rounded up to a multiple of 16 (pad experts are never
        routed to)."""
        e = self.moe.n_experts
        return (e + 15) // 16 * 16 if e else 0

    def param_count(self) -> int:
        """Approximate parameter count."""
        d, ff, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        hd = self.hd
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family in ("ssm",):
            d_in = self.ssm.expand * d
            per = (d * (2 * d_in + 2 * self.ssm.n_groups * self.ssm.d_state
                        + d_in // self.ssm.head_dim)
                   + d_in * d + d_in * self.ssm.d_conv)
            return emb + L * per
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + \
            self.n_heads * hd * d
        if self.moe.n_experts:
            fe = self.moe.d_expert
            mlp = (self.moe.n_experts + self.moe.n_shared) * 3 * d * fe + \
                d * self.moe.n_experts
        else:
            mlp = 3 * d * ff if self.mlp_act in ("silu", "gelu") else 2 * d * ff
        per = attn + mlp
        if self.family == "hybrid":
            d_in = self.ssm.expand * d
            ssm_per = (d * (2 * d_in + 2 * self.ssm.n_groups *
                            self.ssm.d_state + d_in // self.ssm.head_dim)
                       + d_in * d + d_in * self.ssm.d_conv)
            n_attn = 1  # one shared block
            return emb + L * ssm_per + n_attn * per
        return emb + L * per

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if not self.moe.n_experts:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        hd = self.hd
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + \
            self.n_heads * hd * d
        fe = self.moe.d_expert
        act_mlp = (self.moe.top_k + self.moe.n_shared) * 3 * d * fe + \
            d * self.moe.n_experts
        return emb + L * (attn + act_mlp)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------- registry

REGISTRY: Dict[str, ArchConfig] = {}
REDUCED: Dict[str, Callable[[], ArchConfig]] = {}


def register(cfg: ArchConfig, reduced: Callable[[], ArchConfig]) -> ArchConfig:
    REGISTRY[cfg.name] = cfg
    REDUCED[cfg.name] = reduced
    return cfg


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    import repro_torch.configs  # ensure all modules registered  # noqa: F401
    if reduced:
        return REDUCED[name]()
    return REGISTRY[name]


def list_archs() -> List[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(REGISTRY)


def cell_applicable(cfg: ArchConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """Whether a (arch × shape) cell runs; reason recorded if skipped."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention arch: 512k dense decode is "
                       "quadratic — skipped per assignment")
    return True, ""


# ----------------------------------------------------------- input specs

def input_specs(cfg: ArchConfig, shape: ShapeCell) -> Dict[str, Any]:
    """Stand-ins on the ``meta`` device (shape and dtype, no storage) for
    every model input of the given cell."""
    B, S = shape.global_batch, shape.seq_len

    def f(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")
    specs: Dict[str, Any] = {}
    if shape.kind == "train":
        specs["tokens"] = f((B, S), torch.int32)
        specs["labels"] = f((B, S), torch.int32)
    elif shape.kind == "prefill":
        specs["tokens"] = f((B, S), torch.int32)
    else:  # decode: one new token against a seq_len-deep cache
        specs["tokens"] = f((B, 1), torch.int32)
        specs["cache_index"] = f((), torch.int32)
    if cfg.frontend == "patch":
        n = cfg.frontend_len or 256
        specs["frontend_embed"] = f((B, n, cfg.d_model), cfg.dtype)
    elif cfg.frontend == "frame":
        n = cfg.frontend_len or 64
        specs["frontend_embed"] = f((B, n, cfg.d_model), cfg.dtype)
    return specs
