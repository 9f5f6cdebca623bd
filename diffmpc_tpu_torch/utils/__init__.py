from .batch import bclamp, bdot, bger, bmm, bmv, bquad, btrans, detach, eclamp, symmetrize

__all__ = [
    "bclamp", "bdot", "bger", "bmm", "bmv", "bquad", "btrans", "detach", "eclamp", "symmetrize",
]
