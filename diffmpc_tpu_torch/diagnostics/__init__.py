"""Diagnostics of the Riccati sweep's serial chain, on the card.

Counterparts of the JAX package's ``scripts/ab_blocked_ilp.py`` (the
depth-blocked sweep against the serial one) and
``scripts/profile_riccati_pieces.py`` (the cost of each piece of the fused
iLQR sweep by the repeat-slope method). Each module has a function that
returns its records and a ``python -m`` entry that prints them, one JSON
line each; both need a CUDA device.
"""
