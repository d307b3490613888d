from dxk_tpu_torch.scene.builder import SceneBuilder  # noqa: F401
from dxk_tpu_torch.scene.scene import (  # noqa: F401
    Scene, State, StepInfo, MotorControls, ClothState,
    SHAPE_SPHERE, SHAPE_CAPSULE, SHAPE_CYLINDER, SHAPE_BOX, SHAPE_HULL,
)
