"""Logging with the reference's verbosity/format contract.

Contract (reference vclust.py:601-634,1560-1574): verbosity 0 -> ERROR,
1 -> INFO, 2 -> DEBUG; log format ``{asctime} [{levelname:^7}] {message}``
with per-level ANSI colors; tests assert the literal words ``Running`` /
``Completed`` / ``INFO`` appear on stderr at verbosity >= 1.
"""

import logging
import sys

LOGGER_NAME = 'vclust-tpu'

_LEVELS = {0: logging.ERROR, 1: logging.INFO, 2: logging.DEBUG}

_COLORS = {
    'DEBUG': '\033[0;36m',     # cyan
    'INFO': '\033[0;32m',      # green
    'WARNING': '\033[0;33m',   # yellow
    'ERROR': '\033[0;31m',     # red
    'CRITICAL': '\033[1;31m',  # bold red
}
_RESET = '\033[0m'


class _ColorFormatter(logging.Formatter):

    def format(self, record):
        text = super().format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelname, '')
            if color:
                return f'{color}{text}{_RESET}'
        return text


def create_logger(verbosity_level: int = 1) -> logging.Logger:
    """Create (or reconfigure) the package logger for a verbosity level."""
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(_LEVELS.get(verbosity_level, logging.INFO))
    logger.handlers.clear()
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(_ColorFormatter(
        fmt='{asctime} [{levelname:^7}] {message}', style='{'
    ))
    logger.addHandler(handler)
    logger.propagate = False
    return logger


def get_logger() -> logging.Logger:
    return logging.getLogger(LOGGER_NAME)
