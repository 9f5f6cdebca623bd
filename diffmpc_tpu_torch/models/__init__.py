from .dynamics import AffineDynamics, Dynamics, NNDynamics, autodiff_grad_input
from .envs import PendulumDx

__all__ = ["AffineDynamics", "Dynamics", "NNDynamics", "PendulumDx", "autodiff_grad_input"]
