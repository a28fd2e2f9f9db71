"""K6: the copy-ceiling kernel, the card's own bandwidth yardstick.

Port of ``bench.py::measure_copy_gbps`` / ``measure_copy_ceiling``.  A
streaming kernel cannot move bytes faster than a bare copy of the same
array does on the same card, so the port's memory-bound kernels (K1-K4)
are read against the rate measured here, not against a data-sheet number
alone.

:func:`copy_probe` is the kernel's wrapper (``csrc/copy.cu``): one
hand-written CUDA copy of a contiguous float32 array, in the three forms
of the JAX probe family —

* ``ab``: ``out = x`` into a fresh output;
* ``ab_plus1``: ``out = x + 1`` (the arithmetic arm, no aliasing);
* ``aliased``: ``x += 1`` in place (``out is x``), the access pattern of
  the kernels that update their state in place.

:func:`launch_plan` sizes the kernel's grid: one contiguous chunk of
``WORDS * THREADS`` 16-byte words per block.  CUDA tensors launch the
kernel and count one in :data:`LAUNCHES`; CPU tensors run the plain
versions (``out.copy_(x)``, ``x + 1``).  There is no fallback from one to
the other.

:func:`measure_copy_gbps` times a chain of such copies with CUDA events by
the marginal two-count method (the time of ``n2`` launches minus the time
of ``n1``, over ``n2 - n1``: launch overhead and the first touch cancel),
and :func:`measure_copy_ceiling` takes the best plausible probe.  Both run
on the card only: a rate taken on the CPU is not a device metric.

One array of the port's usual size (516x50x516 float32, 53 MB) is about the
size of an H100's 50 MB L2 cache, so part of what a short ping-pong chain
reads it has just written and still finds in L2: such a reading can exceed
what device memory gives.  A reading above :data:`HBM_SPEC_GBPS` is
discarded; the 308 MB shape cannot sit in L2 and is the one to quote as the
ceiling.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

#: CUDA kernel launches since import (one per launch, and only there)
LAUNCHES = 0

#: the H100 SXM's data-sheet HBM3 bandwidth; a probe reading above it is an
#: L2 artifact, not device-memory bandwidth
HBM_SPEC_GBPS = 3350.0

#: probe name -> (plus1, in place)
PROBES = {"ab": (False, False), "ab_plus1": (True, False),
          "aliased": (True, True)}

#: the JAX package's two bench shapes and the port's padded 512x512x50 block
SHAPES = ((512, 50, 514), (1024, 50, 1502), (516, 50, 516))

THREADS = 256   # threads per block (csrc: kThreads)
WORDS = 4       # 16-byte words a thread loads before it stores (kWords)
_kernel_fn = None


def _kernel():
    """The C entry of csrc/copy.cu (library built on first use)."""
    global _kernel_fn
    if _kernel_fn is None:
        fn = _build.load().wrf_tpu_torch_copy_probe
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


def launch_plan(n: int, aligned: bool) -> tuple[int, int, int]:
    """The grid of one launch over ``n`` floats: ``(n4, vec_blocks,
    blocks)``.  With both pointers 16-byte ``aligned`` the first ``n4 = n //
    4`` words go as float4 words, the rest (at most 3 floats) as floats;
    otherwise all ``n`` as floats.  A block copies one chunk of ``WORDS *
    THREADS`` words (floats past the words): ``vec_blocks`` blocks of
    words, then enough blocks for the floats."""
    n4 = n // 4 if aligned else 0
    chunk = WORDS * THREADS
    vec_blocks = -(-n4 // chunk)
    return n4, vec_blocks, vec_blocks + -(-(n - 4 * n4) // chunk)


def copy_probe(x: torch.Tensor, out: torch.Tensor,
               plus1: bool = False) -> torch.Tensor:
    """``out = x`` (``+ 1`` with ``plus1``) for contiguous float32 tensors of
    one shape on one device; returns ``out``.  ``out is x`` is the in-place
    probe and requires ``plus1`` (an in-place identity moves nothing)."""
    global LAUNCHES
    for name, a in (("x", x), ("out", out)):
        if a.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if x.shape != out.shape or x.device != out.device:
        raise ValueError(f"x {tuple(x.shape)} on {x.device} and out "
                         f"{tuple(out.shape)} on {out.device} must match")
    in_place = out.data_ptr() == x.data_ptr()
    if in_place and not plus1:
        raise ValueError("the in-place probe is x += 1: pass plus1=True")
    if x.device.type == "cpu":
        return copy_probe_plain(x, out, plus1)
    if x.device.type != "cuda":
        raise ValueError(f"copy_probe: unsupported device {x.device}")
    dev = x.device
    aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    n4, vec_blocks, blocks = launch_plan(x.numel(), aligned)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(), n4, vec_blocks,
                 blocks, int(plus1), stream)
    if err != 0:
        raise RuntimeError(f"copy_probe kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out


def copy_probe_plain(x: torch.Tensor, out: torch.Tensor,
                     plus1: bool = False) -> torch.Tensor:
    """The plain PyTorch versions of the probes, on any device."""
    if out.data_ptr() == x.data_ptr():
        return x.add_(1.0)
    return out.copy_(x + 1.0 if plus1 else x)


def _chain_ms(a, b, plus1: bool, in_place: bool, n: int) -> float:
    """Milliseconds (CUDA events) of ``n`` chained probe launches."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    src, dst = a, b
    for _ in range(n):
        if in_place:
            copy_probe(a, a, True)
        else:
            copy_probe(src, dst, plus1)
            src, dst = dst, src
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)


def measure_copy_gbps(shape=(516, 50, 516), probe: str = "ab", n1: int = 20,
                      n2: int = 100, repeats: int = 12,
                      device="cuda") -> float:
    """Measured bare read+write rate of device memory in GB/s (2*J*K*I*4
    bytes per copy): a ping-pong chain of :func:`copy_probe` launches
    between two buffers (one buffer for ``aliased``), the best of
    ``repeats`` timings at each of two chain lengths, and the marginal
    time per launch between them."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(
            f"measure_copy_gbps: device {device} — the copy ceiling is a "
            "device metric and is measured on a CUDA device only")
    if probe not in PROBES:
        raise ValueError(f"bad probe {probe!r}; one of {sorted(PROBES)}")
    plus1, in_place = PROBES[probe]
    J, K, I = shape
    a = torch.ones(shape, dtype=torch.float32, device=device)
    b = a if in_place else torch.empty_like(a)
    _chain_ms(a, b, plus1, in_place, 2)   # build + first touch
    times = {}
    for n in (n1, n2):
        times[n] = min(_chain_ms(a, b, plus1, in_place, n)
                       for _ in range(repeats))
    per_ms = (times[n2] - times[n1]) / (n2 - n1)
    return 2 * J * K * I * 4 / (per_ms * 1e-3) / 1e9


def measure_copy_ceiling(shape, readings: dict | None = None,
                         **kw) -> tuple[float, str, str]:
    """Best PLAUSIBLE bare-copy rate over the probe family at ``shape``.
    Taking the max is what makes the number a ceiling: each probe is only
    a lower bound on attainable bandwidth.  Readings above
    :data:`HBM_SPEC_GBPS` are discarded.  Returns ``(gbps, probe_name,
    last_error)``; a probe that raises makes the call raise unless every
    other probe succeeded, and then its error is returned (and printed by
    the caller) rather than swallowed.  ``readings``, when given, is
    filled with every probe's GB/s, discarded ones included."""
    best, src, err = 0.0, "none", ""
    failures = []
    for name in PROBES:
        try:
            g = measure_copy_gbps(shape=shape, probe=name, **kw)
        except Exception as e:   # reported below, never dropped
            err = f"{name}: {type(e).__name__}: {e}"[:200]
            failures.append(e)
            continue
        if readings is not None:
            readings[name] = g
        if g <= HBM_SPEC_GBPS and g > best:
            best, src = g, name
    if len(failures) > 1:
        raise failures[-1]
    return best, src, err
