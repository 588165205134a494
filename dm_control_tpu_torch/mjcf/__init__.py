"""MJCF-subset model compiler (host-side numpy)."""

from dm_control_tpu_torch.mjcf.compiler import compile_path, compile_string  # noqa: F401
