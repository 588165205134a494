"""dm_control_tpu_torch: the PyTorch/CUDA port of dm_control_tpu.

A batched continuous-control engine for one NVIDIA H100: the same Model
compiler, physics pipeline, tasks and batched runner as the JAX package
(`dm_control_tpu`, which stays the reference), written in PyTorch with
hand-written Hopper kernels (`ops/`, sources in `csrc/`) where the JAX
package used Pallas TPU kernels.

Float32 matrix products run at full float32 precision: the JAX package's
`math.f32_dots` records the solver's Newton direction landing 2.8e2
(scaled qacc) off the float64 optimum when its matmuls ran in bf16 on the
TPU, and TF32 on Hopper is the same hazard.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision('highest')
