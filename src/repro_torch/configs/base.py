"""Config system: model architectures, input shapes, platform parameters.

The port's own copy of ``repro/configs/base.py`` (``ModelConfig``,
``InputShape``, ``SHAPES``, ``PlatformConfig``), field for field, with
``reduced()`` and ``for_shape()``: ``tests/test_torch_isolation.py`` holds
``dataclasses.asdict`` of each copied config (and of its ``reduced()``)
equal to the JAX package's.  Fields that only the JAX package reads
(``scan_layers``, ``remat_policy``, ``unroll_inner``, ...) are kept so the
two stay comparable; the port ignores them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

__all__ = ["ModelConfig", "InputShape", "SHAPES", "PlatformConfig"]

BlockKind = Literal["attn", "local", "rec", "mlstm", "slstm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (one instance per assigned arch)."""

    name: str
    family: str                      # dense | moe | audio | vlm | hybrid | ssm
    source: str                      # citation (arXiv / hf model card)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0                # 0 -> d_model // n_heads
    # Attention implementation: "ref" = chunked pure-jnp (CPU/compile
    # path), "pallas_interpret" = Pallas kernels via the interpreter (CPU
    # validation), "pallas" = compiled Pallas kernels (real TPUs).
    attn_impl: str = "ref"
    # "grouped" computes GQA attention in (B,S,KV,g,hd) layout; "repeat_kv"
    # expands k/v to H heads first so the head dim stays mesh-divisible
    # through attention (fixes TP-replicated attention when KV < mesh;
    # 11x prefill win in §Perf — now the default).
    attn_layout: str = "repeat_kv"
    # Layer pattern: cycled over layers ("attn" = global causal attention,
    # "local" = sliding-window attention, "rec" = RG-LRU recurrent block,
    # "mlstm"/"slstm" = xLSTM blocks).
    block_unit: tuple[str, ...] = ("attn",)
    attn_window: int = 4096          # window for "local" blocks
    causal: bool = True              # False => encoder-only (bidirectional)
    embed_inputs: bool = True        # False => inputs are precomputed embeddings
    tie_embeddings: bool = False
    rope_theta: float = 500000.0
    mrope_sections: tuple[int, int, int] | None = None  # (t, h, w) for M-RoPE

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    expert_d_ff: int = 0             # per-expert FFN width (0 = use d_ff)
    router_aux_coef: float = 0.001
    # GShard-style expert capacity factor for train/prefill; None = dropless.
    # Decode is always dropless (see transformer._block_decode).
    capacity_factor: float | None = 1.25
    # Pad the expert count to this value (0 = off).  60 experts cannot shard
    # over a 16-wide model axis; padding to 64 makes the expert dim mesh-
    # divisible at the cost of 6% dead expert weights (hillclimb knob).
    pad_experts_to: int = 0

    # Recurrent (RG-LRU / xLSTM)
    lru_width: int = 0               # 0 -> d_model
    conv1d_width: int = 4

    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # Training-time execution knobs (per-arch defaults; overridable).
    remat: bool = True
    # "default" lets XLA save cheap intermediates; "nothing" forces full
    # recompute inside each scanned repeat (min-memory hillclimb setting).
    remat_policy: str = "default"
    microbatches: int = 1
    # Attention / mLSTM inner chunk sizes.  The roofline analysis lowers
    # with chunk = seq_len so XLA's cost model (which counts loop bodies
    # once) sees the full quadratic work; production configs keep memory-
    # bounded chunks.
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    mlstm_chunk: int = 256
    # scan_layers=False unrolls the repeat loop (roofline analysis variants
    # only: XLA cost_analysis counts scan bodies once regardless of trip
    # count, so analysis lowers a small unrolled model and extrapolates).
    scan_layers: bool = True
    # unroll_inner=True unrolls attention-chunk / mLSTM-chunk loops (same
    # work, python loops instead of scan) for the same cost-analysis reason.
    unroll_inner: bool = False
    opt_dtype: str = "float32"       # AdamW moment dtype
    grad_accum_dtype: str = "float32"  # microbatch grad accumulator dtype
    # Window used when a *dense full-attention* arch is asked to run the
    # long_500k decode shape (sub-quadratic variant; see DESIGN.md §5).
    long_context_window: int = 8192

    def __post_init__(self) -> None:
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)
        if self.n_heads % max(1, self.n_kv_heads):
            raise ValueError(f"{self.name}: n_heads {self.n_heads} not a "
                             f"multiple of n_kv_heads {self.n_kv_heads}")

    # -- derived -------------------------------------------------------------

    @property
    def blocks(self) -> tuple[str, ...]:
        """Per-layer block kinds (unit cycled to n_layers)."""
        unit = self.block_unit
        reps = math.ceil(self.n_layers / len(unit))
        return tuple((unit * reps)[: self.n_layers])

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, hd = self.d_model, self.head_dim
        n = 0
        if self.embed_inputs:
            n += self.vocab_size * d
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for kind in self.blocks:
            n += 2 * d  # norms
            if kind in ("attn", "local"):
                n += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                    + self.n_heads * hd * d
            elif kind == "rec":
                w = self.lru_width
                n += 2 * d * w + w * d + self.conv1d_width * w + 3 * w
            elif kind == "mlstm":
                w = self.d_model
                n += d * 3 * w + 2 * w + w * d + 2 * d * 2 * d  # qkv,gates,out,gate-mlp
            elif kind == "slstm":
                w = self.d_model
                n += 4 * d * w + 4 * w * hd + w * d
            if kind in ("attn", "local") or self.family in ("moe",):
                if self.n_experts:
                    eff = self.expert_d_ff or self.d_ff
                    n += self.n_experts * 3 * d * eff
                    n += self.n_shared_experts * 3 * d * eff
                    n += d * self.n_experts  # router
                elif self.d_ff:
                    n += 3 * d * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Parameters active per token (MoE: top_k + shared experts only)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        eff = self.expert_d_ff or self.d_ff
        inactive = (self.n_experts - self.top_k) * 3 * d * eff * self.n_layers
        return self.param_count() - inactive

    # -- variants ------------------------------------------------------------

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <= 2 layers, d_model <= 512, <= 4 experts."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kv = max(1, min(self.n_kv_heads, heads))
        while heads % kv:
            kv -= 1
        unit = self.block_unit
        n_layers = min(self.n_layers, max(2, len(unit)))
        n_layers = min(n_layers, 3)  # hybrid unit is 3 long
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=d // heads,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            expert_d_ff=min(self.expert_d_ff, 128) if self.expert_d_ff else 0,
            lru_width=d,
            attn_window=min(self.attn_window, 64),
            long_context_window=64,
            microbatches=1,
            mrope_sections=(d // heads // 4, d // heads // 8, d // heads // 8)
            if self.mrope_sections else None,
        )

    def for_shape(self, shape: "InputShape") -> "ModelConfig":
        """Shape-dependent variant selection (DESIGN.md §5).

        For ``long_500k`` on pure full-attention architectures, swap global
        attention for sliding-window attention so decode is sub-quadratic
        with a bounded cache.
        """
        if shape.name == "long_500k" and all(b == "attn" for b in self.block_unit):
            return dataclasses.replace(
                self,
                block_unit=tuple("local" for _ in self.block_unit),
                attn_window=self.long_context_window,
            )
        return self


@dataclasses.dataclass(frozen=True)
class InputShape:
    """A workload shape from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class PlatformConfig:
    """Fault/checkpoint platform parameters (paper §5.1 defaults, TPU-adapted).

    mu_ind is the per-chip MTBF; the planner divides by the mesh size.
    C and C_p can be given directly (seconds) or derived from state bytes and
    checkpoint bandwidth by the checkpoint manager.
    """

    mu_ind: float = 125.0 * 365.0 * 86400.0  # 125 years (Jaguar-calibrated, paper uses 365-day years)
    c: float = 600.0
    cp: float = 600.0
    d: float = 60.0
    r: float = 600.0
    recall: float = 0.85
    precision: float = 0.82
    ckpt_bandwidth: float = 2e9  # bytes/s per chip to stable storage
    # Outage fractions for the availability objective (repro.fleet): how
    # much of each cost is service downtime.  Unit weights = waste model.
    ckpt_outage: float = 1.0     # stop-the-world fraction of a periodic C
    prockpt_outage: float = 1.0  # ... of a proactive C_p
    replay_outage: float = 1.0   # outage fraction of re-executed work
