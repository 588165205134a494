"""Locomotion tier: walkers, procedural arenas, tasks
(reference: dm_control/locomotion/).

The port of `dm_control_tpu/locomotion/`: `arenas`, `walkers` (Ant, Rat,
JumpingBallWithHead, CMUHumanoid), `props` (TargetSphere) and `tasks`
(go_to_target, random_goal_maze, escape, two_touch,
run_through_corridor).  The JAX package's soccer, tracking, mocap,
rescale and cmu_subsets modules are not ported yet.
"""

from dm_control_tpu_torch.locomotion import arenas  # noqa: F401
from dm_control_tpu_torch.locomotion import props  # noqa: F401
from dm_control_tpu_torch.locomotion import tasks  # noqa: F401
from dm_control_tpu_torch.locomotion import walkers  # noqa: F401
