"""Experiment monitoring.

Analogue of the reference ``deepspeed/monitor/`` (``MonitorMaster``
monitor.py:30 fanning out to TensorBoard/W&B/Comet/CSV writers). Events are
``(name, value, global_sample)`` triples (reference ``write_events``).

The Prometheus writer renders the text exposition format with no external
dependency so training and serving metrics share one sink: the serving
layer's ``/metrics`` endpoint and this writer's textfile output use the
same formatting helpers below.

Copy of ``deepspeed_tpu/monitor/monitor.py``: the same writers, the same
event names and the same exposition text. ``MonitorMaster`` writes on
rank 0 of ``torch.distributed`` (every process is rank 0 when no group is
initialized). The TensorBoard, W&B and Comet writers disable themselves
with a warning when their package is missing, as the JAX package's do.
"""

import csv
import os
import re
import tempfile
from typing import List, Optional, Tuple

from deepspeed_tpu_torch.utils.logging import logger

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def prometheus_metric_name(name: str) -> str:
    """Sanitize an event name into a legal Prometheus metric name
    (``Train/Samples/loss`` → ``Train_Samples_loss``)."""
    name = _PROM_BAD.sub("_", str(name))
    if name and name[0].isdigit():
        name = "_" + name
    return name


def escape_label_value(value) -> str:
    """Escape a label VALUE per the exposition-format spec: backslash,
    double quote, and line feed. Label values can be user-supplied
    (tenant/tier strings off HTTP bodies) — an unescaped newline would
    let one request break every scraper of the shared ``/metrics``."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def render_prometheus_text(samples: List[Tuple]) -> str:
    """Render ``(name, labels_dict_or_None, value, type_or_None)`` samples as
    Prometheus text exposition. Consecutive samples of one metric share a
    single ``# TYPE`` header."""
    lines = []
    typed = set()
    for name, labels, value, mtype in samples:
        base = name.split("{")[0]
        if mtype == "histogram" and base.endswith("_bucket"):
            base = base[: -len("_bucket")]  # TYPE header names the family
        if mtype and base not in typed:
            lines.append(f"# TYPE {base} {mtype}")
            typed.add(base)
        label_s = ""
        if labels:
            inner = ",".join(
                '%s="%s"' % (k, escape_label_value(v))
                for k, v in labels.items()
            )
            label_s = "{" + inner + "}"
        vs = "+Inf" if value == float("inf") else repr(float(value))
        lines.append(f"{name}{label_s} {vs}")
    return "\n".join(lines) + "\n"


class Monitor:
    def __init__(self, config):
        self.enabled = bool(getattr(config, "enabled", False))

    def write_events(self, event_list: List[Tuple]):
        raise NotImplementedError


class TensorBoardMonitor(Monitor):
    """Backed by torch.utils.tensorboard (which needs the tensorboard package)."""

    def __init__(self, config):
        super().__init__(config)
        self.summary_writer = None
        if self.enabled:
            try:
                from torch.utils.tensorboard import SummaryWriter

                log_dir = os.path.join(config.output_path or "./runs", config.job_name)
                self.summary_writer = SummaryWriter(log_dir=log_dir)
            except Exception as e:
                logger.warning(f"TensorBoard monitor unavailable: {e}")
                self.enabled = False

    def write_events(self, event_list, flush=True):
        if self.summary_writer is None:
            return
        for name, value, step in event_list:
            self.summary_writer.add_scalar(name, value, step)
        if flush:
            self.summary_writer.flush()


class WandbMonitor(Monitor):
    def __init__(self, config):
        super().__init__(config)
        self._wandb = None
        if self.enabled:
            try:
                import wandb

                wandb.init(project=config.project, group=config.group, entity=config.team)
                self._wandb = wandb
            except Exception as e:
                logger.warning(f"W&B monitor unavailable: {e}")
                self.enabled = False

    def write_events(self, event_list):
        if self._wandb is None:
            return
        for name, value, step in event_list:
            self._wandb.log({name: value}, step=step)


class CometMonitor(Monitor):
    """Reference monitor/comet.py: metrics to a Comet experiment. comet_ml
    is not in the image — the writer degrades to disabled with a warning,
    exactly like the W&B writer does without credentials."""

    def __init__(self, config):
        super().__init__(config)
        self._experiment = None
        if self.enabled:
            try:
                import comet_ml

                kwargs = {
                    k: getattr(config, k)
                    for k in ("api_key", "project", "workspace", "experiment_key", "mode", "online")
                    if getattr(config, k, None) is not None
                }
                if "project" in kwargs:
                    kwargs["project_name"] = kwargs.pop("project")
                self._experiment = comet_ml.start(**kwargs)
                if getattr(config, "experiment_name", None):
                    self._experiment.set_name(config.experiment_name)
            except Exception as e:
                logger.warning(f"Comet monitor unavailable: {e}")
                self.enabled = False

    @property
    def experiment(self):
        return self._experiment

    def write_events(self, event_list):
        if self._experiment is None:
            return
        for name, value, step in event_list:
            self._experiment.__internal_api__log_metric__(name, value, step=step)


class csvMonitor(Monitor):
    def __init__(self, config):
        super().__init__(config)
        self.filenames = {}
        self.output_path = None
        if self.enabled:
            self.output_path = os.path.join(config.output_path or "./csv_logs", config.job_name)
            os.makedirs(self.output_path, exist_ok=True)

    def write_events(self, event_list):
        if not self.enabled:
            return
        for name, value, step in event_list:
            fname = os.path.join(self.output_path, name.replace("/", "_") + ".csv")
            new = not os.path.exists(fname)
            with open(fname, "a", newline="") as f:
                w = csv.writer(f)
                if new:
                    w.writerow(["step", name])
                w.writerow([step, value])


class PrometheusMonitor(Monitor):
    """Text-exposition writer (no dependencies): keeps the latest value per
    event name and renders them as Prometheus gauges — served in-memory via
    ``expose()`` (the serving layer's ``/metrics`` endpoint) and optionally
    written to a node-exporter textfile (``output_path``/``job_name``.prom,
    atomic rename so the collector never reads a torn file)."""

    def __init__(self, config):
        super().__init__(config)
        self._values = {}
        self._path = None
        if self.enabled and getattr(config, "output_path", ""):
            os.makedirs(config.output_path, exist_ok=True)
            job = getattr(config, "job_name", None) or "deepspeed_tpu"
            self._path = os.path.join(config.output_path, f"{job}.prom")

    def write_events(self, event_list):
        if not self.enabled:
            return
        for name, value, step in event_list:
            try:
                self._values[prometheus_metric_name(name)] = (float(value), int(step))
            except (TypeError, ValueError):
                continue  # non-numeric events have no Prometheus form
        if self._path is not None:
            self._flush_file()

    def expose(self) -> str:
        """Current state in Prometheus text exposition format."""
        samples = []
        for name in sorted(self._values):
            value, step = self._values[name]
            samples.append((name, None, value, "gauge"))
            samples.append((name + "_last_step", None, step, "gauge"))
        return render_prometheus_text(samples) if samples else ""

    def _flush_file(self):
        text = self.expose()
        d = os.path.dirname(self._path)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(text)
            os.replace(tmp, self._path)
        except OSError as e:
            logger.warning(f"Prometheus textfile write failed: {e}")
            if os.path.exists(tmp):
                os.unlink(tmp)


class MonitorMaster(Monitor):
    """Fan-out to every enabled writer; rank-0 only (reference monitor.py:30)."""

    def __init__(self, ds_config):
        import torch.distributed as dist

        self.tb_monitor = TensorBoardMonitor(ds_config.tensorboard)
        self.wandb_monitor = WandbMonitor(ds_config.wandb)
        self.csv_monitor = csvMonitor(ds_config.csv_monitor)
        self.comet_monitor = CometMonitor(ds_config.comet)
        self.prometheus_monitor = PrometheusMonitor(
            getattr(ds_config, "prometheus", None) or type("_Off", (), {"enabled": False})()
        )
        self._rank0 = not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
        self.enabled = self._rank0 and (
            self.tb_monitor.enabled
            or self.wandb_monitor.enabled
            or self.csv_monitor.enabled
            or self.comet_monitor.enabled
            or self.prometheus_monitor.enabled
        )

    def write_events(self, event_list):
        if not self.enabled:
            return
        for m in (
            self.tb_monitor,
            self.wandb_monitor,
            self.csv_monitor,
            self.comet_monitor,
            self.prometheus_monitor,
        ):
            if m.enabled:
                m.write_events(event_list)
