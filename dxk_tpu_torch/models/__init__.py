"""Models built with the scene builder: the humanoid ragdoll, the
gear-driven vehicle and the locomotion policy network."""

from dxk_tpu_torch.models.vehicle import (GearDesc, Vehicle, WheelDesc,
                                          add_vehicle)

__all__ = ["GearDesc", "Vehicle", "WheelDesc", "add_vehicle"]
