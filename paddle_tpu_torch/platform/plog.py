"""Logging wrapper (a copy of ``paddle_tpu/platform/plog.py``): one
``paddle_tpu_torch`` logger on standard error at ``FLAGS.log_level``."""

from __future__ import annotations

import logging
import sys

_LOGGER = None


def logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        from paddle_tpu_torch.platform.flags import FLAGS

        log = logging.getLogger("paddle_tpu_torch")
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s] %(message)s", "%H:%M:%S"))
        log.addHandler(handler)
        log.setLevel(getattr(logging, str(FLAGS.log_level).upper(),
                             logging.INFO))
        log.propagate = False
        _LOGGER = log
    return _LOGGER


def info(msg, *args):
    logger().info(msg, *args)


def warning(msg, *args):
    logger().warning(msg, *args)


def error(msg, *args):
    logger().error(msg, *args)


def debug(msg, *args):
    logger().debug(msg, *args)
