"""Parallelism: the device mesh, the partition rules and their FSDP2 /
DTensor placements (mirrors ``ufvideo_tpu/parallel``). Importing it builds
nothing and starts no process group."""

from .mesh import (  # noqa: F401
    AXIS_NAMES,
    BATCH_SPEC,
    DATA_AXIS,
    FSDP_AXIS,
    TENSOR_AXIS,
    MeshShape,
    P,
    create_mesh,
    maybe_initialize_distributed,
    single_device_mesh,
)
from .partition import (  # noqa: F401
    DEFAULT_RULES,
    QWEN2_RULES,
    VISION_RULES,
    audit_shardings,
    partition_specs,
    per_chip_state_bytes,
    shard_params,
    shardings_for,
)
