"""wrf_tpu_torch — the PyTorch/CUDA port of wrf_tpu for one NVIDIA H100.

The port mirrors the JAX package's layout (``grid``, ``compare``,
``config``, ``io``, ``native``, ``ops``, ``models``, ``parallel``,
``utils``, ``tools``, ``run_sim``, ``driver``) under the same names and
stands alone: it imports ``torch`` and numpy, never ``jax`` and nothing of ``wrf_tpu``.
The foundation modules (grid bounds, comparators, the namelist record, the
binary codec, fixtures, checkpoints, the numpy golden path and the C++
scalar oracle) are its own copies, with the same file formats, so a
fixture or checkpoint written by one package reads in the other; the tests
hold each against its original.

Layers (``python -m wrf_tpu_torch.run_sim``, ``python -m
wrf_tpu_torch.driver``):

  run_sim     CLI: fixture + namelist -> host-stepped RK3 large steps
  driver      CLI: a fixture through a tier, diffed against its goldens
  models.rk3  RK3Integrator: three stage loops per large step
  models.small_step  SmallStepLoop: the coupled acoustic substep loop
              (``with_w``: plus the vertically-implicit w/pp substep)
  models.stage_memo  StageMemo: the pads, lean constants and Thomas
              K-vectors the three stage loops share
  parallel.sharded   ShardedAdvanceMuT: the mu/t loop; ring-shaped glue
  ops.advance_mu_t_cuda  K1, the fused substep (csrc/advance_mu_t_kernel.cuh)
  ops.advance_mu_t_msteps_cuda  K2, S mu/t substeps per pass
  ops.advance_mu_t_coupled_cuda  K3/K4, S coupled substeps per pass
  ops.thomas, csrc/w_solve.cuh  the w/pp Thomas solve inside K1 and K3
  ops.advance_uv, ops.advance_w, ops.advance_mu_t_eager  the eager tier
  utils.copy_ceiling  K6, the copy kernel that sets the card's ceiling
  utils.timing  best-of-N and marginal (two-count) timing, profiler traces,
              the program's spans (span, span_totals)
  tools.probe_2d, tools.probe_2d_bisect  K7 and K8, the tiling probes
              (``python -m wrf_tpu_torch.tools.<probe>``)
  native      the C++ scalar oracle (g++, built at first use)

Every kernel is hand-written CUDA beside a plain PyTorch version; CUDA
tensors launch the kernel, CPU tensors run the plain version, and there is
no fallback from one to the other.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
