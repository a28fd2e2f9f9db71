"""The port's probe entry points (``python -m wrf_tpu_torch.tools.<probe>``).

  probe_2d         K7: one thread per column against shared-memory-staged
                   (j, i) tiles, on a stencil plus a k scan
  probe_2d_bisect  K8: the feature ladder from K7's stencil to K3's tile
                   shape, one launch per rung

Ports of the JAX package's ``tools/probe_2d.py`` and
``tools/probe_2d_bisect.py``; they run on the card by default (``--device
cpu``: the plain PyTorch versions).
"""
