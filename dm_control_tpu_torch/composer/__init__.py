"""Composer: compositional task construction (reference L6).

The port of `dm_control_tpu/composer/`, the functional re-design of
dm_control.composer:

  * `Entity` is a build-time object: an MJCF fragment plus observable
    definitions and batched lifecycle hooks.  `attach()` merges fragments
    with name prefixing at build time (replacing PyMJCF attachment
    frames, dm_control/mjcf/element.py:903-1046).
  * The observation pipeline (Observable update_interval / buffer_size /
    delay / aggregator / corruptor, reference composer/observation/)
    becomes per-lane ring buffers advanced on every physics substep.
  * `BatchedEnvironment` steps B lanes on the card, `Environment` one
    lane with the dm_env interface (`rl.specs`).

`initializers` (PropPlacer, ToolCenterPointInitializer) and `colors`
serve the manipulation tier.
"""

from dm_control_tpu_torch.composer.entity import Entity, attach  # noqa: F401
from dm_control_tpu_torch.composer.observation import (  # noqa: F401
    ObservableSpec, ObservationPipeline)
from dm_control_tpu_torch.composer.task import ComposerTask  # noqa: F401
from dm_control_tpu_torch.composer.environment import (  # noqa: F401
    BatchedEnvironment, Carry, Environment)
