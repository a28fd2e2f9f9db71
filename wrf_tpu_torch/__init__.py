"""wrf_tpu_torch — the PyTorch/CUDA port of wrf_tpu for one NVIDIA H100.

The port mirrors the JAX package's layout (``ops``, ``models``,
``parallel``, ``io``, ``run_sim``) and is held against it: both read the
same fixtures (``wrf_tpu.io.fixtures``) and are judged by the same
comparators (``wrf_tpu.compare``).  It imports ``torch`` and the jax-free
foundation modules of ``wrf_tpu`` (``grid``, ``config``, ``compare``,
``io``, ``ops.reference_numpy``), never ``jax``.

Layers of the slice ported so far (``python -m wrf_tpu_torch.run_sim``):

  run_sim     CLI: fixture + namelist -> host-stepped RK3 large steps
  models.rk3  RK3Integrator: three stage loops per large step
  models.small_step  SmallStepLoop: the coupled acoustic substep loop
  ops.advance_mu_t_cuda  K1, the fused substep: a hand-written CUDA
              kernel (csrc/advance_mu_t.cu) and its plain PyTorch version
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
