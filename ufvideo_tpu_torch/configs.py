"""Typed configuration for the video-QA, region-referring and ``[SEG]``
segmentation paths (SigLIP + STC-v35 projector + region encoder + Qwen2 +
SAM2 Hiera-L), mirroring ``ufvideo_tpu/configs.py`` with torch dtypes.

Only the fields this package implements are here; the loss settings come
with the training slice (ROADMAP.md queue 1). ``SAM2HieraConfig`` has no
``head_pad``: padding each head to 128 lanes is a TPU layout, and this
package always runs the native head dim.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Tuple

import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class SiglipVisionConfig:
    """SigLIP-SO400M-patch14-384 vision tower."""

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 27
    num_heads: int = 16
    image_size: int = 384
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    # feature tap hidden_states[-2]: the final encoder layer never runs
    select_layer: int = -2

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_encode_layers(self) -> int:
        """Encoder layers executed for the feature tap (26 for -2)."""
        if self.select_layer >= 0:
            raise ValueError("select_layer must be negative")
        return self.num_layers + 1 + self.select_layer


@dataclass(frozen=True)
class Qwen2Config:
    """Qwen2-7B-Instruct LLM dims."""

    vocab_size: int = 152064
    hidden_size: int = 3584
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    head_dim: int = 128
    intermediate_size: int = 18944
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    max_position_embeddings: int = 32768
    # a checkpoint's lm_head is the embedding (the port keeps a copy of it)
    tie_word_embeddings: bool = False
    eos_token_id: int = 151645  # <|im_end|>
    pad_token_id: int = 151643  # <|endoftext|>
    # gradient checkpointing in the train forward: each decoder layer is
    # recomputed in the backward instead of keeping its activations
    # (torch.utils.checkpoint, one layer a checkpoint)
    remat: bool = False

    @property
    def padded_vocab_size(self) -> int:
        """Embedding / lm_head rows, rounded up to a multiple of 256."""
        return _round_up(self.vocab_size, 256)


@dataclass(frozen=True)
class ProjectorConfig:
    """STC-v35 connector: RegStage(4) → Conv3d (2,2,2) stride 2 pad 0 →
    RegStage(4) → 2-layer MLP readout."""

    projector_type: str = "stc_connector_v35"
    encoder_hidden_size: int = 1152
    hidden_size: int = 3584
    depth: int = 4
    mlp_depth: int = 2
    downsample: Tuple[int, int, int] = (2, 2, 2)  # (t, h, w)

    def token_grid(self, num_frames: int, vis_grid: int) -> Tuple[int, int, int]:
        """Output grid (t, h, w); padding 0, so dims floor-divide."""
        if self.projector_type != "stc_connector_v35":
            raise NotImplementedError(
                f"projector {self.projector_type!r}: only stc_connector_v35 "
                "is ported (ROADMAP.md queue 1)"
            )
        dt, dh, dw = self.downsample
        return (
            (num_frames - dt) // dt + 1,
            (vis_grid - dh) // dh + 1,
            (vis_grid - dw) // dw + 1,
        )

    def num_video_tokens(self, num_frames: int, vis_grid: int) -> int:
        t, h, w = self.token_grid(num_frames, vis_grid)
        return t * h * w


@dataclass(frozen=True)
class RegionEncoderConfig:
    """Mask-pooled region tokens (``models/region_encoder.py``):
    ``region_token_num`` is the merge budget of one region and the splice
    plan's region stride."""

    encoder_hidden_size: int = 1152
    hidden_size: int = 3584
    depth: int = 2
    region_token_num: int = 4
    mask_shape: int = 112


@dataclass(frozen=True)
class SAM2HieraConfig:
    """Hiera-Large image-encoder trunk."""

    embed_dim: int = 144
    num_heads: int = 2
    stages: Tuple[int, ...] = (2, 6, 36, 4)
    global_att_blocks: Tuple[int, ...] = (23, 33, 43)
    window_pos_embed_bkg_spatial_size: Tuple[int, int] = (7, 7)
    window_spec: Tuple[int, ...] = (8, 4, 16, 8)
    dim_mul: float = 2.0
    head_mul: float = 2.0
    q_stride: Tuple[int, int] = (2, 2)
    patch_kernel: int = 7
    patch_stride: int = 4
    patch_padding: int = 3
    mlp_ratio: float = 4.0
    image_size: int = 1024


@dataclass(frozen=True)
class SAM2Config:
    """SAM2 hiera-large video model."""

    hiera: SAM2HieraConfig = field(default_factory=SAM2HieraConfig)
    # FPN neck
    fpn_dim: int = 256
    fpn_backbone_channels: Tuple[int, ...] = (1152, 576, 288, 144)
    fpn_top_down_levels: Tuple[int, ...] = (2, 3)
    scalp: int = 1  # drop the lowest-resolution level
    # memory attention
    mem_attn_layers: int = 4
    mem_attn_dim: int = 256
    mem_attn_dff: int = 2048
    mem_attn_num_heads: int = 1
    mem_attn_rope_theta: float = 10000.0
    mem_attn_rope_feat_sizes: Tuple[int, int] = (32, 32)
    mem_attn_kv_in_dim: int = 64
    # memory encoder
    mem_dim: int = 64
    num_maskmem: int = 7
    max_obj_ptrs_in_encoder: int = 16
    # SAM heads
    sam_embed_dim: int = 256
    sam_image_embedding_size: int = 64  # 1024 / 16
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    pred_obj_scores: bool = True
    # propagation
    sigmoid_scale_for_mem_enc: float = 20.0
    sigmoid_bias_for_mem_enc: float = -10.0


@dataclass(frozen=True)
class MultimodalBudget:
    """Static token budgets every sequence is padded to."""

    max_seq_len: int = 4096
    max_text_len: int = 2048
    max_regions: int = 8
    max_objects: int = 8
    max_new_tokens: int = 1024
    num_frames: int = 32
    num_frames_sam: int = 4


@dataclass(frozen=True)
class UFVideoConfig:
    vision: SiglipVisionConfig = field(default_factory=SiglipVisionConfig)
    llm: Qwen2Config = field(default_factory=Qwen2Config)
    projector: ProjectorConfig = field(default_factory=ProjectorConfig)
    region: RegionEncoderConfig = field(default_factory=RegionEncoderConfig)
    sam: SAM2Config = field(default_factory=SAM2Config)
    budget: MultimodalBudget = field(default_factory=MultimodalBudget)

    # token ids filled in from the tokenizer by model_init
    region_token_id: int = -1
    seg_token_id: int = -1
    temporal_token_start_id: int = -1

    # width of the [SEG] text head's output (SAM2's prompt embedding)
    sam_out_dim: int = 256

    # training loss weights (the reference's train.py defaults)
    ce_loss_weight: float = 1.0
    bce_loss_weight: float = 2.0
    dice_loss_weight: float = 0.5

    # bf16 compute and storage; LayerNorm / RMSNorm / softmax in float32
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16
    # weight-only quantised LLM: False | True / 'int8' | 'int4' (quant.py)
    quant_llm: Any = False
    # W8A8 int8 SigLIP encoder (ops.hiera_block.fused_block_w8a8)
    quant_vision: bool = False
    # int8 KV cache with per-position scales (ops.ragged_decode_attention_q8)
    quant_kv: bool = False
    # >0: prefill this many sequences at a time (models/generate.prefill_cache)
    prefill_chunk: int = 0
    # >0: prompt-lookup speculation with this many drafts a verify step, for
    # greedy decoding without multi-token stops (models/speculative.py)
    spec_decode: int = 0

    @property
    def num_video_tokens(self) -> int:
        return self.projector.num_video_tokens(
            self.budget.num_frames, self.vision.grid_size
        )

    def replace(self, **kw) -> "UFVideoConfig":
        return dataclasses.replace(self, **kw)


_SIGLIP_GELUS = {"tanh": "gelu_tanh", "poly": "gelu_tanh_poly",
                 "poly_bf16": "gelu_tanh_poly_bf16"}
_HIERA_GELUS = {"exact": "gelu_exact", "poly": "gelu_poly", "poly_bf16": "gelu_poly_bf16"}


@dataclass(frozen=True)
class VisionRouting:
    """Which kernels and modules the vision towers run, fixed when the towers
    are built. Each field stands for a switch that the JAX package reads from
    its environment (or a module argument) at trace time; this package reads
    no environment variable. The defaults are the JAX defaults.

    Not carried over, being TPU layout devices: ``UFVIDEO_GLOBAL_PAD_HEADS``
    (zero head lanes, exact either way), ``UFVIDEO_HIERA_ALIGN_QKV`` /
    ``head_pad`` and ``UFVIDEO_HIERA_GROUP_ROWS``.
    """

    # SiglipVisionTower(ln_dtype=): "f32" runs each layer as one fused block,
    # "bf16" the unfused float layer (LayerNorm rounded to bf16, the packed
    # attention kernel between dense products)
    siglip_ln_dtype: str = "f32"
    # UFVIDEO_SIGLIP_INT8_FUSED: the W8A8 tower as one fused block a layer
    # (True) or the unfused W8A8 layer (W8A8 dense products around the packed
    # attention kernel)
    siglip_int8_fused: bool = True
    # UFVIDEO_SIGLIP_GELU: the fused float layer's GELU, "tanh" / "poly" /
    # "poly_bf16"; only that layer reads it: the unfused layers and the W8A8
    # tower, fused or not, always take the tanh GELU, as in the JAX package
    siglip_gelu: str = "tanh"
    # UFVIDEO_HIERA_GELU: the Hiera kernels' GELU, "exact" / "poly" / "poly_bf16"
    hiera_gelu: str = "exact"
    # UFVIDEO_QPOOL_FUSED: a width-changing q-pool block as one fused block
    # (True) or front, pooling, attention and tail apart
    qpool_fused: bool = True
    # UFVIDEO_SAM2_INT8_SPECIAL: the W8A8 trunk's q-pool and global blocks on
    # the fused front / tail kernels (True) or on the generic W8A8 block
    sam2_int8_special: bool = True
    # UFVIDEO_HIERA_STAGE_NB: up to this many consecutive identical windowed
    # float blocks run as one fused_hiera_stage call
    hiera_stage_nb: int = 1

    def __post_init__(self):
        if self.siglip_ln_dtype not in ("f32", "bf16"):
            raise ValueError(f"siglip_ln_dtype {self.siglip_ln_dtype!r}: 'f32' or 'bf16'")
        if self.siglip_gelu not in _SIGLIP_GELUS:
            raise ValueError(f"siglip_gelu {self.siglip_gelu!r}: one of {list(_SIGLIP_GELUS)}")
        if self.hiera_gelu not in _HIERA_GELUS:
            raise ValueError(f"hiera_gelu {self.hiera_gelu!r}: one of {list(_HIERA_GELUS)}")
        if self.hiera_stage_nb < 1:
            raise ValueError(f"hiera_stage_nb {self.hiera_stage_nb} < 1")

    @property
    def siglip_act(self) -> str:
        """The fused float SigLIP layer's activation, as the kernels name it."""
        return _SIGLIP_GELUS[self.siglip_gelu]

    @property
    def hiera_act(self) -> str:
        """The Hiera kernels' activation, as the kernels name it."""
        return _HIERA_GELUS[self.hiera_gelu]


def tiny_config() -> UFVideoConfig:
    """Miniature config for tests: the dims of ``ufvideo_tpu`` tiny_config."""
    return UFVideoConfig(
        vision=SiglipVisionConfig(
            hidden_size=32, intermediate_size=64, num_layers=3, num_heads=2,
            image_size=56, patch_size=14,
        ),
        llm=Qwen2Config(
            vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=128,
            eos_token_id=2, pad_token_id=0,
        ),
        projector=ProjectorConfig(encoder_hidden_size=32, hidden_size=64),
        region=RegionEncoderConfig(encoder_hidden_size=32, hidden_size=64),
        sam=SAM2Config(
            hiera=SAM2HieraConfig(
                embed_dim=16, num_heads=1, stages=(1, 2, 1, 1),
                global_att_blocks=(2,), window_spec=(4, 2, 4, 2),
                image_size=128,
            ),
            fpn_backbone_channels=(128, 64, 32, 16),
            fpn_dim=32,
            mem_attn_layers=1,
            mem_attn_dim=32,
            mem_attn_dff=64,
            mem_attn_kv_in_dim=16,
            mem_dim=16,
            sam_embed_dim=32,
            sam_image_embedding_size=8,
            iou_head_hidden_dim=32,
        ),
        budget=MultimodalBudget(
            max_seq_len=128, max_text_len=64, max_regions=2, max_objects=2,
            max_new_tokens=8, num_frames=4, num_frames_sam=2,
        ),
        sam_out_dim=32,
        compute_dtype=torch.float32,
        param_dtype=torch.float32,
    )
