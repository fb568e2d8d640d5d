"""Rank-aware logging utilities.

Counterpart of ``deepspeed_tpu/utils/logging.py`` (``logger``,
``log_dist``, ``log_dist_once``). Rank filtering reads the
``torch.distributed`` rank when a process group is up, else rank 0.
"""

import functools
import logging
import os
import sys

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


class _LoggerFactory:
    @staticmethod
    def create_logger(name=None, level=logging.INFO):
        if name is None:
            raise ValueError("name for logger cannot be None")
        formatter = logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(filename)s:%(lineno)d:%(funcName)s] %(message)s"
        )
        logger_ = logging.getLogger(name)
        logger_.setLevel(level)
        logger_.propagate = False
        if not logger_.handlers:
            ch = logging.StreamHandler(stream=sys.stdout)
            ch.setLevel(level)
            ch.setFormatter(formatter)
            logger_.addHandler(ch)
        return logger_


logger = _LoggerFactory.create_logger(
    name="DeepSpeedTPUTorch",
    level=LOG_LEVELS.get(os.environ.get("DSTPU_LOG_LEVEL", "info"), logging.INFO),
)


def _process_index():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message, ranks=None, level=logging.INFO):
    """Log on listed process ranks only (rank -1 or None == all)."""
    should_log = ranks is None or len(ranks) == 0 or -1 in ranks
    if not should_log:
        should_log = _process_index() in set(ranks)
    if should_log:
        logger.log(level, f"[Rank {_process_index()}] {message}")


_logged_once = set()


def log_dist_once(message, ranks=None, level=logging.INFO):
    key = (message, tuple(ranks) if ranks else None, level)
    if key not in _logged_once:
        _logged_once.add(key)
        log_dist(message, ranks=ranks, level=level)


@functools.lru_cache(None)
def warning_once(message):
    logger.warning(message)


def print_rank_0(message):
    if _process_index() == 0:
        print(message, flush=True)
