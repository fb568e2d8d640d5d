"""DeepSpeed-style JSON configuration for the port.

A copy of ``deepspeed_tpu/runtime/config.py`` (which imports no jax): one
JSON/dict config resolved into typed sub-configs, with the train-batch
arithmetic ``train_batch_size = micro_batch_per_device *
gradient_accumulation_steps * dp_world_size`` and the rejection of
duplicate keys in a JSON file. Every section parses; the engine raises for
the ones this slice does not run (offload, pipeline, mesh axes above 1,
curriculum, the flops profiler, ...).
"""

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

from deepspeed_tpu_torch.runtime.config_utils import (
    ConfigError,
    DSConfigModel,
    dict_raise_error_on_duplicate_keys,
    submodel,
)
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.utils.logging import logger


@dataclass
class FP16Config(DSConfigModel):
    """``fp16`` section (reference runtime/config.py / fp16 constants)."""

    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0  # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0
    fp16_master_weights_and_grads: bool = False


@dataclass
class BF16Config(DSConfigModel):
    """``bf16`` section. ``immediate_grad_update`` matches reference bf16 config."""

    enabled: bool = False
    immediate_grad_update: bool = True


@dataclass
class OptimizerConfig(DSConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)
    legacy_fusion: bool = False


@dataclass
class SchedulerConfig(DSConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ActivationCheckpointingConfig(DSConfigModel):
    """``activation_checkpointing`` (reference runtime/activation_checkpointing/config.py).

    On TPU this maps to ``jax.checkpoint`` (remat) policies; partitioned
    activations become sequence/model-axis sharding constraints on saved
    residuals.
    """

    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False  # [compat]
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False  # [compat]
    profile: bool = False


@dataclass
class CommsLoggerConfig(DSConfigModel):
    """``comms_logger`` (reference utils/comms_logging.py)."""

    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: List[str] = field(default_factory=list)


@dataclass
class FlopsProfilerConfig(DSConfigModel):
    """``flops_profiler`` (reference profiling/config.py)."""

    enabled: bool = False
    recompute_fwd_factor: float = 0.0
    profile_step: int = 1
    module_depth: int = -1
    top_modules: int = 1
    detailed: bool = True
    output_file: Optional[str] = None


@dataclass
class TensorBoardConfig(DSConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclass
class WandbConfig(DSConfigModel):
    enabled: bool = False
    group: Optional[str] = None
    team: Optional[str] = None
    project: str = "deepspeed"


@dataclass
class CometConfig(DSConfigModel):
    """Reference monitor/config.py CometConfig (comet.py writer)."""

    enabled: bool = False
    samples_log_interval: int = 100
    project: Optional[str] = None
    workspace: Optional[str] = None
    api_key: Optional[str] = None
    experiment_name: Optional[str] = None
    experiment_key: Optional[str] = None
    online: Optional[bool] = None
    mode: Optional[str] = None


@dataclass
class CSVConfig(DSConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclass
class PrometheusConfig(DSConfigModel):
    """``prometheus`` monitor section: dependency-free text-exposition
    writer (monitor/monitor.py PrometheusMonitor). ``output_path`` empty =
    in-memory only (scraped via the serving layer's /metrics); set it to a
    node-exporter textfile-collector dir to publish training metrics."""

    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclass
class CheckpointConfig(DSConfigModel):
    """``checkpoint`` section (reference runtime/config.py checkpoint params)."""

    tag_validation: str = "Warn"  # Ignore | Warn | Fail
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write: Dict[str, Any] = field(default_factory=dict)
    writer: Optional[str] = None  # None | "fast" | "decoupled"

    def _validate(self):
        if self.tag_validation.lower() not in ("ignore", "warn", "fail"):
            raise ConfigError(f"tag_validation must be Ignore|Warn|Fail, got {self.tag_validation}")


@dataclass
class DataTypesConfig(DSConfigModel):
    grad_accum_dtype: Optional[str] = None

    def _validate(self):
        if self.grad_accum_dtype not in (None, "fp32", "fp16", "bf16"):
            raise ConfigError(f"Invalid grad_accum_dtype {self.grad_accum_dtype}")


@dataclass
class MeshConfig(DSConfigModel):
    """TPU mesh axis sizes. Axes with size 1 collapse away; ``data`` is
    inferred from the device count when left at 0 (auto)."""

    data: int = 0  # 0 = infer from device count
    model: int = 1  # tensor parallel
    pipe: int = 1  # pipeline parallel
    sequence: int = 1  # Ulysses / ring sequence parallel
    context: int = 1  # ring context parallel (shards the sequence dim itself)
    expert: int = 1  # MoE expert parallel


@dataclass
class TensorParallelConfig(DSConfigModel):
    """``tensor_parallel`` section (reference runtime/tensor_parallel config)."""

    autotp_size: int = 0
    tp_size: int = 1
    tp_grain_size: int = 1


@dataclass
class PipelineConfig(DSConfigModel):
    stages: int = 1
    partition_method: str = "parameters"
    activation_checkpoint_interval: int = 0
    micro_batches: Optional[int] = None


@dataclass
class EigenvalueConfig(DSConfigModel):
    enabled: bool = False
    verbose: bool = False
    max_iter: int = 100
    tol: float = 1e-2
    stability: float = 1e-6
    gas_boundary_resolution: int = 1
    layer_name: str = "bert.encoder.layer"
    layer_num: int = 0


TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"


@dataclass
class DeepSpeedConfig(DSConfigModel):
    """Top-level typed config (reference runtime/config.py DeepSpeedConfig)."""

    train_batch_size: Optional[int] = None
    train_micro_batch_size_per_gpu: Optional[int] = None
    gradient_accumulation_steps: Optional[int] = None
    steps_per_print: int = 10
    gradient_clipping: float = 0.0
    prescale_gradients: bool = False
    gradient_predivide_factor: float = 1.0
    sparse_gradients: bool = False
    communication_data_type: Optional[str] = None
    disable_allgather: bool = False  # [compat]
    dump_state: bool = False
    wall_clock_breakdown: bool = False
    memory_breakdown: bool = False
    # None = auto. check_grad_overflow (reference engine.py:1774 bf16 knob):
    # the isfinite scan + functional skip-step — auto runs it for fp16 only
    # (bf16/fp32 training has no loss scale to protect; the pass costs a full
    # fp32-grad read per step). monitor_grad_norm: the global-norm reduction
    # — auto computes it when clipping or a monitor consumes it.
    check_grad_overflow: Optional[bool] = None
    monitor_grad_norm: Optional[bool] = None
    # quantized collectives for the non-gradient hot wires (comm/quantized.py,
    # EQuARX-style int8-inside-the-collective): "int8" moves the pipeline
    # activation/cotangent ppermute sends and the MoE expert-parallel
    # dispatch/combine as int8 payloads + fp32 block scales; "none" keeps
    # full-width collectives. Gradient-exchange quantization has its own
    # knobs (zero_quantized_gradients / compression).
    comm_quant: str = "none"
    # tile-granular compute/collective overlap (comm/overlap_tiled.py):
    # "tiled" splits the ZeRO-3 bucketed parameter all-gathers into
    # tp_overlap_tiles independent per-tile collectives so parameter tiles
    # stream in behind the transformer scan's GEMM slices instead of
    # arriving bucket-at-a-time (bitwise-identical either way — the
    # gathers are transport-only); "none" keeps one collective per bucket.
    comm_overlap: str = "none"
    tp_overlap_tiles: int = 4
    zero_allow_untested_optimizer: bool = True
    zero_force_ds_cpu_optimizer: bool = False  # [compat] no CPU-only optimizer binary on TPU
    graph_harvesting: bool = False  # [compat] jit covers CUDA-graph capture
    seed: int = 1234

    fp16: FP16Config = submodel(FP16Config)
    bf16: BF16Config = submodel(BF16Config, metadata={"alias": "bfloat16"})
    optimizer: OptimizerConfig = submodel(OptimizerConfig)
    scheduler: SchedulerConfig = submodel(SchedulerConfig)
    zero_optimization: DeepSpeedZeroConfig = submodel(DeepSpeedZeroConfig)
    activation_checkpointing: ActivationCheckpointingConfig = submodel(ActivationCheckpointingConfig)
    comms_logger: CommsLoggerConfig = submodel(CommsLoggerConfig)
    flops_profiler: FlopsProfilerConfig = submodel(FlopsProfilerConfig)
    tensorboard: TensorBoardConfig = submodel(TensorBoardConfig)
    wandb: WandbConfig = submodel(WandbConfig)
    csv_monitor: CSVConfig = submodel(CSVConfig)
    comet: CometConfig = submodel(CometConfig)
    prometheus: PrometheusConfig = submodel(PrometheusConfig)
    checkpoint: CheckpointConfig = submodel(CheckpointConfig)
    data_types: DataTypesConfig = submodel(DataTypesConfig)
    mesh: MeshConfig = submodel(MeshConfig)
    tensor_parallel: TensorParallelConfig = submodel(TensorParallelConfig)
    pipeline: PipelineConfig = submodel(PipelineConfig)
    eigenvalue: EigenvalueConfig = submodel(EigenvalueConfig)
    # Free-form sections handled by their own subsystems
    data_efficiency: Dict[str, Any] = field(default_factory=dict)
    curriculum_learning: Dict[str, Any] = field(default_factory=dict)
    compression_training: Dict[str, Any] = field(default_factory=dict)
    elasticity: Dict[str, Any] = field(default_factory=dict)
    autotuning: Dict[str, Any] = field(default_factory=dict)
    aio: Dict[str, Any] = field(default_factory=dict)
    nebula: Dict[str, Any] = field(default_factory=dict)
    zenflow: Dict[str, Any] = field(default_factory=dict)
    compile: Dict[str, Any] = field(default_factory=dict)

    # ---- resolution state (filled by resolve()) ----
    _dp_world_size: int = 1

    @classmethod
    def load(cls, config: Union[str, dict], dp_world_size: int = 1, strict: bool = False):
        """Load from a JSON file path or a dict, then resolve batch sizes."""
        if isinstance(config, str):
            if not os.path.exists(config):
                raise ConfigError(f"DeepSpeed config file not found: {config}")
            with open(config) as f:
                config = json.load(f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
        if not isinstance(config, dict):
            raise ConfigError(f"Expected a dict or JSON path, got {type(config)}")
        obj = cls.from_dict(config, strict=strict)
        obj.resolve(dp_world_size)
        return obj

    # -- batch arithmetic (reference DeepSpeedConfig._configure_train_batch_size) --
    def resolve(self, dp_world_size: int):
        self._dp_world_size = dp_world_size
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps

        if train_batch and micro_batch and gas:
            pass
        elif train_batch and micro_batch:
            gas = train_batch // micro_batch
            gas //= dp_world_size
        elif train_batch and gas:
            micro_batch = train_batch // dp_world_size
            micro_batch //= gas
        elif micro_batch and gas:
            train_batch = micro_batch * gas * dp_world_size
        elif train_batch:
            gas = 1
            micro_batch = train_batch // dp_world_size
        elif micro_batch:
            train_batch = micro_batch * dp_world_size
            gas = 1
        else:
            raise ConfigError("Either train_batch_size or train_micro_batch_size_per_gpu needs to be provided")

        self.train_batch_size = train_batch
        self.train_micro_batch_size_per_gpu = micro_batch
        self.gradient_accumulation_steps = gas
        self._batch_assertion(dp_world_size)
        if self.comm_quant not in ("none", "int8"):
            raise ConfigError(
                f"comm_quant={self.comm_quant!r}: expected 'none' or 'int8'"
            )
        if self.comm_overlap not in ("none", "tiled"):
            raise ConfigError(
                f"comm_overlap={self.comm_overlap!r}: expected 'none' or 'tiled'"
            )
        if int(self.tp_overlap_tiles) < 1:
            raise ConfigError(
                f"tp_overlap_tiles={self.tp_overlap_tiles!r}: expected an int >= 1"
            )

    def _batch_assertion(self, dp_world_size):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        if train_batch <= 0:
            raise ValueError(f"Train batch size: {train_batch} has to be greater than 0")
        if micro_batch <= 0:
            raise ValueError(f"Micro batch size per gpu: {micro_batch} has to be greater than 0")
        if grad_acc <= 0:
            raise ValueError(f"Gradient accumulation steps: {grad_acc} has to be greater than 0")
        if train_batch != micro_batch * grad_acc * dp_world_size:
            raise ConfigError(
                f"Check batch related parameters. train_batch_size is not equal to "
                f"micro_batch_per_gpu * gradient_acc_step * world_size "
                f"{train_batch} != {micro_batch} * {grad_acc} * {dp_world_size}"
            )

    def _validate(self):
        if self.fp16.enabled and self.bf16.enabled:
            raise ConfigError("fp16 and bf16 cannot both be enabled")

    # convenience accessors matching reference engine property names
    @property
    def zero_enabled(self):
        return self.zero_optimization.stage > 0

    @property
    def precision_dtype(self):
        if self.bf16.enabled:
            return "bfloat16"
        if self.fp16.enabled:
            return "float16"
        return "float32"

    def print_config(self):
        logger.info(f"DeepSpeedTPU config: {json.dumps(self.to_dict(), default=str, indent=2)}")
