"""Leveled logging (the port's copy of orb_slam3_tpu/utils/verbose.py): the
`Verbose` utility of the reference (`System.h:47-72`), a process-wide
threshold and `print_mess(msg, level)`, which prints only when the
message's level is at or below the threshold. Default QUIET
(`System.cc:240`)."""

from __future__ import annotations

VERBOSITY_QUIET = 0
VERBOSITY_NORMAL = 1
VERBOSITY_VERBOSE = 2
VERBOSITY_DEBUG = 3

_level = VERBOSITY_QUIET


def set_verbosity(level: int):
    global _level
    _level = int(level)


def get_verbosity() -> int:
    return _level


def print_mess(msg: str, level: int = VERBOSITY_NORMAL):
    """Verbose::PrintMess (`System.h:60-66`)."""
    if level <= _level:
        print(msg, flush=True)
