"""ZeRO configuration for the port.

A copy of ``deepspeed_tpu/runtime/zero/config.py`` (the reference's
``DeepSpeedZeroConfig`` and offload sections). On one device the four
stages hold the same tensors and train identically; the engine accepts
stages 0-3 and raises for offload.
"""

from dataclasses import dataclass, field
from typing import Optional

from deepspeed_tpu_torch.runtime.config_utils import ConfigError, DSConfigModel, submodel

ZERO_OPTIMIZATION = "zero_optimization"


class OffloadDeviceEnum:
    none = "none"
    cpu = "cpu"
    nvme = "nvme"


@dataclass
class DeepSpeedZeroOffloadParamConfig(DSConfigModel):
    """Parameter offload (reference offload_config.py:14)."""

    device: str = OffloadDeviceEnum.none
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    max_in_cpu: int = 1_000_000_000
    pin_memory: bool = False

    def _validate(self):
        if self.device not in (OffloadDeviceEnum.none, OffloadDeviceEnum.cpu, OffloadDeviceEnum.nvme):
            raise ConfigError(f"Invalid offload device {self.device}")


@dataclass
class DeepSpeedZeroOffloadOptimizerConfig(DSConfigModel):
    """Optimizer offload (reference offload_config.py:21)."""

    device: str = OffloadDeviceEnum.none
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    # Twin-Flow partial offload (reference engine.py:921 zero_partial_offload):
    # fraction of optimizer-state bytes placed in host memory; the rest stays
    # in HBM so only `ratio` of the state crosses the link each step
    ratio: float = 1.0
    # SuperOffload (reference engine.py:924 + superoffload_stage3.py): run the
    # whole optimizer host-side against RAM-resident state via CPU-Adam
    super_offload: bool = False
    cpuadam_cores_perc: float = 0.8
    # weight_stream tier: store/stream the Adam moments as int8 blocks with
    # fp32 per-256-block scales (ZeRO++ quantized exchange applied to the
    # ZeRO-Infinity swap traffic — reference stage3.py:1610
    # quantize_nontrainable_params + partitioned_optimizer_swapper). The
    # streamed step is wire-limited; bytes are the lever (PERF.md
    # streamed-7B roofline). 0 = fp32 state (default), 8 = int8 moments.
    stream_quant_bits: int = 0

    def _validate(self):
        if self.device not in (OffloadDeviceEnum.none, OffloadDeviceEnum.cpu, OffloadDeviceEnum.nvme):
            raise ConfigError(f"Invalid offload device {self.device}")
        if not 0.0 <= self.ratio <= 1.0:
            raise ConfigError("offload_optimizer.ratio must be in [0, 1]")


@dataclass
class DeepSpeedZeroConfig(DSConfigModel):
    """``zero_optimization`` section (reference runtime/zero/config.py:89).

    Knobs that exist purely to tune manual CUDA bucketing/overlap are accepted
    for config compatibility but are no-ops on TPU, where XLA handles
    bucketing/fusion/overlap; they are marked [compat] below.
    """

    stage: int = 0
    contiguous_gradients: bool = True  # [compat]
    reduce_scatter: bool = True  # [compat] — always reduce-scatter on TPU for stage>=2
    # grad reduce-scatter bucket target (bytes): leaves are grouped into
    # buckets of this size and each bucket crosses the wire in ONE
    # collective, launched independently so the scheduler can pipeline them
    # behind remaining backward compute (runtime/zero/overlap.py)
    reduce_bucket_size: int = 500_000_000
    allgather_partitions: bool = True  # [compat]
    allgather_bucket_size: int = 500_000_000  # [compat]
    # Bucketed comm/compute overlap (reference overlap_comm + the stage-3
    # prefetch coordinator): None = auto (ON — the overlapped and
    # unoverlapped paths are loss-bitwise identical), False = escape hatch
    # forcing the per-leaf/serial schedule, True = explicit opt-in.
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False
    # Offload
    offload_param: DeepSpeedZeroOffloadParamConfig = submodel(DeepSpeedZeroOffloadParamConfig)
    offload_optimizer: DeepSpeedZeroOffloadOptimizerConfig = submodel(DeepSpeedZeroOffloadOptimizerConfig)
    # Stage-3 specifics
    sub_group_size: int = 1_000_000_000
    max_live_parameters: int = 1_000_000_000  # [compat]
    max_reuse_distance: int = 1_000_000_000  # [compat]
    # parameter-prefetch window (bytes): bounds how many layers' worth of
    # gathered/staged weights sit in HBM ahead of the layer being computed
    # (transformer scan chunking — overlap.overlap_chunk) and the qwZ
    # gather bucket target. ``stage3_prefetch_bucket_size`` is the
    # reference's spelling for the same knob and takes precedence when set.
    prefetch_bucket_size: int = 50_000_000
    stage3_prefetch_bucket_size: Optional[int] = None
    param_persistence_threshold: int = 100_000  # params smaller than this stay replicated
    model_persistence_threshold: int = 9223372036854775807
    gather_16bit_weights_on_model_save: bool = False
    stage3_gather_16bit_weights_on_model_save: bool = False
    ignore_unused_parameters: bool = True
    round_robin_gradients: bool = False  # [compat]
    # ZeRO++ (hpZ / qwZ / qgZ — reference engine.py:1085-1097)
    zero_hpz_partition_size: int = 1
    zero_quantized_weights: bool = False
    zero_quantized_nontrainable_weights: bool = False
    zero_quantized_gradients: bool = False
    zeropp_loco_param: Optional[dict] = None
    # MiCS
    mics_shard_size: int = -1
    mics_hierarchical_params_gather: bool = False
    memory_efficient_linear: bool = True
    pipeline_loading_checkpoint: bool = False
    override_module_apply: bool = True
    log_trace_cache_warnings: bool = False

    @property
    def overlap_enabled(self) -> bool:
        """overlap_comm resolved: None (auto) and True → on; False → off."""
        return self.overlap_comm is not False

    @property
    def effective_prefetch_bucket_size(self) -> int:
        if self.stage3_prefetch_bucket_size is not None:
            return int(self.stage3_prefetch_bucket_size)
        return int(self.prefetch_bucket_size)

    def _validate(self):
        if not 0 <= self.stage <= 3:
            raise ConfigError(f"ZeRO stage must be 0-3, got {self.stage}")
        if self.zero_hpz_partition_size < 1:
            raise ConfigError("zero_hpz_partition_size must be >= 1")
        if self.reduce_bucket_size <= 0:
            raise ConfigError("reduce_bucket_size must be > 0")
        if self.effective_prefetch_bucket_size <= 0:
            raise ConfigError("prefetch_bucket_size must be > 0")
