"""cl_ica_tpu_torch — the PyTorch + CUDA port of cl_ica_tpu.

The JAX package ``cl_ica_tpu`` stays beside this one as the reference
each ported module is tested against. This package imports ``torch`` and
never ``jax``, ``flax``, ``optax`` or ``orbax``, and nothing of the JAX
package: it keeps its own copy of what it needs from there.

Sub-packages mirror the JAX package's names:
  spaces/  ← cl_ica_tpu/spaces   samplers on explicit torch.Generators
  models/  ← cl_ica_tpu/models   frozen mixing g, MLP encoder f, ResNet, heads,
                                 and the Flax <-> torch parameter converter
  ops/     ← cl_ica_tpu/ops      hand-written Hopper kernels (CUDA C++
                                 under ops/csrc) with plain-torch versions
  losses/  ← cl_ica_tpu/losses   Lp-InfoNCE, SimCLR, alignment/uniformity,
                                 the combinators
  train/   ← cl_ica_tpu/train    the synthetic training step, telemetry,
                                 resume checkpoints
  evaluation/ ← cl_ica_tpu/evaluation   linear R², permutation MCC (numpy)
  data/    ← cl_ica_tpu/data     the 3DIdent sampler and image store
  tools/   ← cl_ica_tpu/tools    the synthetic 3DIdent fixture (numpy)
  cli/     ← cl_ica_tpu/cli      main_mlp, main_3dident, flag for flag
"""

__version__ = "0.1.0"
