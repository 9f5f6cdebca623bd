from .acrobot import AcrobotDx
from .cartpole import CartpoleDx
from .pendulum import PendulumDx
from .quadrotor import QuadrotorDx
from .vehicle import VehicleDx

__all__ = ["AcrobotDx", "CartpoleDx", "PendulumDx", "QuadrotorDx", "VehicleDx"]
