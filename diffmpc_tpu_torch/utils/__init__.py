from .batch import bclamp, bdiag, bdot, bger, bmm, bmv, bquad, btrans, detach, eclamp, symmetrize
from .debug import checked_solve, debug_nans
from .logging import CSVLogger, JSONLLogger, profile_trace, table_log

__all__ = [
    "CSVLogger", "JSONLLogger", "bclamp", "bdiag", "bdot", "bger", "bmm", "bmv", "bquad", "btrans", "checked_solve",
    "debug_nans", "detach", "eclamp", "profile_trace", "symmetrize", "table_log",
]
