"""Logging — the reference's Log subsystem (misc/Log.cpp:6-54).

logI/W/E -> timestamped lines, routed through python logging with the same
three severities and a "time [SEVERITY]: msg" shape.
"""

from __future__ import annotations

import logging
import sys

_logger = logging.getLogger("opencl_ray_tracer_tpu_torch")
if not _logger.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(
        logging.Formatter("%(asctime)s [%(levelname)s] %(name)s: %(message)s")
    )
    _logger.addHandler(_handler)
    _logger.setLevel(logging.INFO)
    _logger.propagate = False


def log_info(msg: str, *args) -> None:
    _logger.info(msg, *args)


def log_warning(msg: str, *args) -> None:
    _logger.warning(msg, *args)


def log_error(msg: str, *args) -> None:
    _logger.error(msg, *args)


def set_level(level: int | str) -> None:
    _logger.setLevel(level)


def get_logger() -> logging.Logger:
    return _logger
