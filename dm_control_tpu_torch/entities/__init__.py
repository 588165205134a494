"""Reusable composer entities (reference: dm_control/entities/); the port
of `dm_control_tpu/entities/`."""

from dm_control_tpu_torch.entities import props  # noqa: F401
from dm_control_tpu_torch.entities.duplo import duplo_entity  # noqa: F401
from dm_control_tpu_torch.entities.manipulators import (  # noqa: F401
    JacoArm, JacoHand)
from dm_control_tpu_torch.entities.manipulators_base import (  # noqa: F401
    DOWN_QUATERNION, RobotArm, RobotHand)
