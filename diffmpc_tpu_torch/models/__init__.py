from .dynamics import AffineDynamics, CtrlPassthroughDynamics, Dynamics, NNDynamics, autodiff_grad_input
from .envs import AcrobotDx, CartpoleDx, PendulumDx, QuadrotorDx, VehicleDx

__all__ = [
    "AcrobotDx", "AffineDynamics", "CartpoleDx", "CtrlPassthroughDynamics", "Dynamics", "NNDynamics", "PendulumDx",
    "QuadrotorDx", "VehicleDx", "autodiff_grad_input",
]
