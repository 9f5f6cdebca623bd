"""``diagnostics/ab_kkt_lanes.py``'s ``--parent``, on the CPU: another
checkout of the port is imported beside this one under a name of its own,
with its own wrapper and ``KktArgs``, and its struct is filled field by
field from this checkout's staging, where a field this checkout does not
have raises. The card's timing itself runs only on a CUDA device.
"""

import ctypes
import os
import shutil
import sys
import types

import pytest

torch = pytest.importorskip("torch")

from diffmpc_tpu_torch.diagnostics import ab_kkt_lanes as ab  # noqa: E402
from diffmpc_tpu_torch.ops.cuda import kkt  # noqa: E402


@pytest.fixture(scope="module")
def other_kkt(tmp_path_factory):
    """A copy of this checkout's package, imported as another checkout."""
    root = tmp_path_factory.mktemp("tree")
    pkg = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(kkt.__file__))))
    shutil.copytree(pkg, root / "diffmpc_tpu_torch", ignore=shutil.ignore_patterns("_build", "__pycache__"))
    return ab.load_tree(str(root))


def _inputs(T=3, B=5, n=3, m=1, seed=0):
    g = torch.Generator().manual_seed(seed)
    nm = n + m
    A = torch.randn((T, B, nm, nm), generator=g)
    C = A @ A.transpose(-1, -2) / nm + torch.eye(nm)
    rand = lambda *shape: torch.randn(shape, generator=g)  # noqa: E731
    tight = torch.zeros((T, B, m), dtype=torch.bool)
    tight[0, 0, 0] = True
    return C, rand(T, B, nm), rand(T, B, n, nm) * 0.5, rand(T, B, nm), rand(T, B, nm), tight


def test_another_checkout_is_imported_beside_this_one(other_kkt):
    assert other_kkt.__name__ != kkt.__name__ and other_kkt.__name__.endswith(".ops.cuda.kkt")
    assert other_kkt._KktArgs is not kkt._KktArgs
    assert other_kkt.kkt_backward_fused is not kkt.kkt_backward_fused
    # nothing of its solve path: the diffmpc:: operators are registered once
    tree = other_kkt.__name__.split(".")[0]
    assert not any(m.startswith(tree) and m.endswith((".ops.library", ".mpc")) for m in sys.modules)
    assert ab.load_tree(os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        other_kkt.__file__))))) is other_kkt
    # its wrapper on CPU tensors runs its own plain version: the same function
    ins = _inputs()
    for got, want in zip(other_kkt.kkt_backward_fused(*ins), kkt.kkt_backward_fused(*ins)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_its_struct_is_filled_field_by_field(other_kkt):
    staged = kkt.stage_kkt(*_inputs(), in_place=False, lanes=16)
    args = ab.tree_args(other_kkt, staged)
    assert type(args) is other_kkt._KktArgs
    for name, _ in other_kkt._KktArgs._fields_:
        assert getattr(args, name) == getattr(staged.args, name), name

    class Wider(ctypes.Structure):
        _fields_ = kkt._KktArgs._fields_ + [("a_later_field", ctypes.c_int)]

    with pytest.raises(RuntimeError, match="a_later_field"):
        ab.tree_args(types.SimpleNamespace(_KktArgs=Wider), staged)


def test_the_recorded_call_keeps_a_shared_C_where_it_lies():
    """The diagnostic records the KKT call of a solve + gradient: every input
    cloned but a C or F that the kernels read in place (the headline's
    expanded ``QuadCost`` C), which stays the tensor the backward got."""
    from diffmpc_tpu_torch import MPCConfig, QuadCost, mpc_solve
    from diffmpc_tpu_torch.models import PendulumDx

    dx = PendulumDx.default(device="cpu")
    q, p = dx.get_true_obj()
    prm = dx.params.clone().requires_grad_(True)
    cfg = MPCConfig(n_state=3, n_ctrl=1, T=4, lqr_iter=2, exit_unconverged=False, detach_unconverged=False)
    calls = []
    with ab.recorded_calls(calls):
        sol = mpc_solve(cfg, torch.tensor(ab.swing_up_starts(3)), QuadCost(torch.diag(q), p),
                        dx.replace(params=prm), u_lower=-2.0, u_upper=2.0)
        torch.autograd.grad((sol.us ** 2).mean(), prm)
    (args, kw), = calls
    assert {"reg", "value_update_exact_reg"} <= set(kw)
    # C and the cost's c are the same for every scenario; F, r, tau, tight not
    assert [a.stride(1) == 0 for a in args] == [True, True, False, False, False, False]
    assert kkt.reads_in_place(args[0]) and not kkt.reads_in_place(args[2])
