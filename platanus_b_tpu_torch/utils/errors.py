"""Typed error system with numeric exit codes.

Mirrors the reference's ErrorBase hierarchy and exit-ID enum
(common.h:55-56, common.h:86-246); caught at the CLI top level
(main.cpp:118-127 equivalent: commands.main).

Port copy of platanus_b_tpu/utils/errors.py: the same classes and exit
ids, so that ERROR(n) and the exit codes are the reference's.
"""


class PlatanusError(Exception):
    """Base of all typed errors (reference: common.h:86 ErrorBase)."""

    exit_id = 1

    def __init__(self, message: str = ""):
        super().__init__(message)
        self.message = message


class IOError_(PlatanusError):
    exit_id = 2


class FormatError(PlatanusError):
    exit_id = 3


class KmerError(PlatanusError):
    exit_id = 4


class ArgError(PlatanusError):
    exit_id = 5


class MemError(PlatanusError):
    exit_id = 6


class MapError(PlatanusError):
    exit_id = 7


class TmpError(PlatanusError):
    exit_id = 8


class ThreadError(PlatanusError):
    exit_id = 9
