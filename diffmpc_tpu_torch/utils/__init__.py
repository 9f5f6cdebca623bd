from .batch import bclamp, bdot, bger, bmv, bquad, btrans, detach, eclamp

__all__ = ["bclamp", "bdot", "bger", "bmv", "bquad", "btrans", "detach", "eclamp"]
