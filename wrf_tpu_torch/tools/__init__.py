"""The port's tools (``python -m wrf_tpu_torch.tools.<tool>``).

  probe_2d         K7: one thread per column against shared-memory-staged
                   (j, i) tiles, on a stencil plus a k scan
  probe_2d_bisect  K8: the feature ladder from K7's stencil to K3's tile
                   shape, one launch per rung
  multihost_check  the loops across processes, bit for bit against one
  bench_halo       the in-loop exchange's cost per substep and backend
  weak_scaling     the weak-scaling ladder over every visible card
  scaling_report   what the exchanges send per substep and shard
  ab_trees         one card's A/B of two trees' chip_smoke phases

Ports of the JAX package's ``tools/`` of the same names (but
``ab_trees``); they run on the card by default (``--device cpu``, or
``weak_scaling --dryrun``: the plain PyTorch versions on the CPU;
``scaling_report`` counts on the CPU unless ``--device cuda``).
"""
