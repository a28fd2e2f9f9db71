"""The yardstick of the rooflines: the card's peaks and the work of a large step.

Every count here comes from the configuration's grid and the cell's path
options, through the frozen traffic model (:mod:`wrfbench.traffic`), never
from what the program launched:

* :func:`k1_work`: the bytes and float32 operations of the K1 launches a
  closed large step makes on the host-stepped path: per RK3 stage, the
  substeps before the last run K1's lean scan form (or, when
  ``inner_steps`` blocks them, K3 for whole blocks and K1 for the rest),
  and the last substep K1's final form, which re-materializes ww and
  writes t_ave.  The final form is not in the traffic model; its streams
  are counted here from the kernel's operands (:data:`FINAL_STREAMS`).
* :func:`step_work`: the algorithmic work of one large step, whatever the
  program fuses or skips: every substep of the three stages as the leanest
  fused substep the model knows (the scan form, with divergence damping
  and the w/pp solve as the configuration states), plus the closure's
  fields (``ft`` from ``t`` and its reference, the damped winds).  A
  change that fuses, adds or removes a kernel leaves it unchanged.

Peaks: one NVIDIA H100 SXM, dense, as published (data sheet): 3.35 TB/s of
HBM3 and 67 TFLOP/s in float32 outside the tensor cores, at the full
700 W.  A roofline share is the least time, the larger of bytes over the
bandwidth and operations over the rate, over the measured time.
"""

from __future__ import annotations

from . import traffic
from .inputs import grid
from .reference import rk3_stages

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = 67e12

#: K1's final substep (``ww_mode="final"``, ``with_tave``, fused winds, not
#: lean): reads ww_1, u, u_1, v, v_1, t, t_1 and ft and writes ww, t,
#: t_ave, u and v (13 3-D passes); reads mu, mut, muu, muv, mu_tend, the
#: four map factors and the scan-seed row, and writes mu, muave, muts and
#: mudf (14 2-D fields; 15 with damping's mudf_in); the 4 vertical vectors
FINAL_STREAMS = (13, 14, 4)
#: the final form's 3-D streams that bf16 constant streams narrow
#: (t_1, ww_1, u_1, v_1, ft)
FINAL_BF16_NARROWED = 5
#: the closure per large step: ft = (t_ref - t)*rate (2 reads, 1 write),
#: u, v *= 1-r (2 reads, 2 writes); mu_tend from mu and its reference
#: (3 2-D fields); and the float32 operations per cell of both
CLOSURE_STREAMS = (7, 3, 0)
CLOSURE_OPS_PER_CELL = 4


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time for ``n_bytes`` and ``n_ops`` on the card."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_FLOP_PER_S)


def _block(cfg):
    nx, ny, nz = grid(cfg)
    return traffic.padded_block(nx, ny, nz)


def _scan_form(cfg) -> str:
    return "k1 smdiv" if cfg["smdiv"] else "k1 scan"


def _substep_ops(cfg, traffic_mix) -> int:
    J, K, I = _block(cfg)
    per_cell = traffic.OPS_PER_CELL["k1"]
    if traffic_mix["with_w"]:
        per_cell += traffic.OPS_PER_CELL["w"]
    return per_cell * J * K * I


def k1_forms(cfg, traffic_mix) -> dict[str, int]:
    """K1 launches per large step, by form: ``{"scan": n, "final": n}``."""
    S = traffic_mix.get("inner_steps", 1)
    scan = final = 0
    for _, n_sub in rk3_stages(cfg["time_step_sound"]):
        rem = n_sub - 1
        if S > 1 and rem >= S:
            rem -= rem // S * S
        scan += rem
        final += 1
    return {"scan": scan, "final": final}


def k1_work(cfg, traffic_mix) -> tuple[float, float]:
    """(bytes, float32 operations) of one large step's K1 launches."""
    with_w = traffic_mix["with_w"]
    bf16 = traffic_mix.get("const_dtype", "f32") == "bf16"
    block = _block(cfg)
    forms = k1_forms(cfg, traffic_mix)
    n3, n2, n1 = traffic.streams("k1 scan", with_w=with_w, bf16=bf16)
    if cfg["smdiv"]:
        n2 += 1
    scan_bytes = traffic.field_bytes(block, n3, n2, n1)
    f3, f2, f1 = FINAL_STREAMS
    if with_w:
        f3, f2, f1 = (f3 + traffic.W_STREAMS[0], f2 + traffic.W_STREAMS[1],
                      f1 + traffic.W_STREAMS[2])
    if cfg["smdiv"]:
        f2 += 1
    if bf16:
        f3 -= 0.5 * FINAL_BF16_NARROWED
    final_bytes = traffic.field_bytes(block, f3, f2, f1)
    n_bytes = forms["scan"] * scan_bytes + forms["final"] * final_bytes
    n_ops = (forms["scan"] + forms["final"]) * _substep_ops(cfg, traffic_mix)
    return n_bytes, n_ops


def step_work(cfg, traffic_mix) -> tuple[float, float]:
    """(bytes, float32 operations) of one large step's algorithmic work."""
    block = _block(cfg)
    n_sub = sum(n for _, n in rk3_stages(cfg["time_step_sound"]))
    sub_bytes = traffic.stream_bytes(_scan_form(cfg), block,
                                     with_w=traffic_mix["with_w"])
    J, K, I = block
    n_bytes = (n_sub * sub_bytes
               + traffic.field_bytes(block, *CLOSURE_STREAMS))
    n_ops = (n_sub * _substep_ops(cfg, traffic_mix)
             + CLOSURE_OPS_PER_CELL * J * K * I)
    return n_bytes, n_ops
