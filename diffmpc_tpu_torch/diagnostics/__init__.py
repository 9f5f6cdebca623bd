"""Diagnostics of the port's kernels, on the card.

Counterparts of the JAX package's ``scripts/ab_blocked_ilp.py`` (the
depth-blocked sweep against the serial one) and
``scripts/profile_riccati_pieces.py`` (the cost of each piece of the fused
iLQR sweep by the repeat-slope method), ``ab_nn_reread`` (the MLP
step's weights re-read each step, against a build that lets the compiler
hold them in registers), ``ab_ilqr_lanes`` (the fused iLQR kernel at
each lane count against one lane) and ``ab_solve_grad`` (``mpc_solve`` with
and without the gradient, in checkouts of the repository side by side, run
as a script). Each module has a function that returns its records and a
``python -m`` entry that prints them, one JSON line each; each needs a CUDA
device.
"""
