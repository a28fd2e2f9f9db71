"""The acoustic small-step loop over a mesh of shards: advance_uv + advance_mu_t per substep.

Port of ``wrf_tpu/models/small_step.py::SmallStepLoop``.  Every substep
is ONE launch per shard of the fused K1 kernel
(``advance_mu_t_fused(fuse_uv=True)``): the wind update runs inside it from
mu's neighbours, so u and v stream once per substep.  K1 writes every
field it updates to a fresh buffer, which the loop carries into the next
substep, so the padded blocks a call starts from (the memo's) are never
written.  The loop pads every
block by a 1-cell halo (the neighbours' edge cells on sharded axes, zeros
elsewhere) and takes the lean constants and the Thomas K-vectors through
its memo (``models/stage_memo.py``, shared by the three stages of an RK3
step: each built once per distinct input), runs ``n_steps-1`` lean "lite"
substeps that carry only ww's scan-seed row, then one final substep that
re-materializes ww and writes t_ave, and trims the halo and the boundary
ring.  The substeps are a Python loop over "for each shard".  With
``with_w`` every substep also runs the vertically-implicit w/pp substep
inside the kernel (``fuse_w``), and w and pp join the carried state.

On a mesh the fields a substep changes and a neighbour reads are
exchanged before every substep: mu in j and i and v in j (u's halo lanes
self-maintain: the kernel recomputes them from the fresh mu halo).
With ``smdiv`` (divergence damping) the previous substep's ``mudf`` joins
the carried state, zero on the first substep, is refreshed wherever mu is
and feeds the wind update's pressure as ``mudf_in``.
``halo_backend="ppermute"`` copies the rows between the blocks
(``parallel/halo.py``); ``"rdma"`` moves every j-halo row of a substep
with one launch per device of the hand-written exchange kernel (K5,
``ops/halo_rdma_cuda.py``), i halos staying on the ppermute form;
``"rdma_overlap"`` puts the j exchange inside the substep kernel: only the
i halos of mu (and mudf) are refreshed, and every shard's K1 launch reads
its ring neighbours' edge rows itself (``advance_mu_t_fused(overlap=)``),
so the j leg costs no launch and no copy.

With ``inner_steps`` = S > 1 the scan substeps are temporally blocked:
``(n_steps-1)//S`` launches of K3 (the coupled trapezoid,
``coupled_multistep``) on ring-S copies of the state and constants, then
the remaining lite substeps and the final one on K1 as above.  On sharded
axes the ring-S cells hold the neighbours' data, and mu, u and v are
refreshed with one width-S exchange per block of S substeps; under
``"rdma_overlap"`` the j leg of that exchange is inside K3 too.

While a ``torch.profiler`` records, a call is three spans
(``utils/timing.py::span``): ``wrf.loop.pad`` (``pad_local`` through the
memo; its count is the bytes of the blocks the call built),
``wrf.loop.inputs`` (from after the pad to the first launch: the carried
state's start, the lean constants, the blocked path's widened inputs, the
bf16 casts; on the fused path its count is the bytes of the 3-D
lean-constant blocks the call built) and ``wrf.loop.substeps`` (every
launch with its halo refreshes, the final one included).

``const_dtype=torch.bfloat16`` narrows the never-written 3-D bases (u_1,
v_1, ww_1, ft, t_1 and the 3-D lean constants; on the blocked path t_1,
tconst and dvdxi_const of the widened constants) once per call, outside
the substeps; the kernels widen them on load, and the state, u and v
included, stays float32.

``kernel="eager"`` is the counterpart of the JAX loop's ``kernel="xla"``:
each substep is three whole-array calls, ``advance_uv`` ->
``advance_mu_t_impl`` -> ``advance_w``, with no hand-written kernel.

:func:`small_step_golden` is the numpy golden loop, the reference the
driver's coupled tiers are verified against.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid import ConfigFlags
from ..ops.advance_mu_t_coupled_cuda import (
    coupled_lean_kwargs, coupled_multistep, coupled_multistep_plain,
)
from ..ops.advance_mu_t_cuda import (
    advance_mu_t_fused, advance_mu_t_fused_plain, lean_kwargs,
)
from ..ops.advance_mu_t_eager import advance_mu_t_impl
from ..ops.advance_uv import DEFAULT_CS2, advance_uv, advance_uv_numpy
from ..ops.advance_w import DEFAULT_CW, DEFAULT_GW, advance_w, advance_w_numpy
from ..ops.reference_numpy import advance_mu_t_numpy
from ..ops.halo_rdma_cuda import (
    Mailbox, remote_refresh_multi, remote_refresh_multi_plain,
)
from ..parallel import halo
from ..parallel.mesh import Mesh
from ..parallel.sharded import (
    FIELDS_1D, FIELDS_2D, FIELDS_3D, RING, as_blocks, domain_window, gather,
    local_mesh, prepare_arrays, shard_offsets, strip_local,
)
from ..utils.timing import span
from .stage_memo import StageMemo

#: what the scan substeps carry: ww only as its 2-D scan-seed row
CARRY_KEYS = ("ww_row", "mu", "t", "u", "v")

OUT_NAMES = ("ww", "mu", "muave", "muts", "mudf", "t", "t_ave", "u", "v")

#: fields the golden loop carries (and updates) across substeps
STATE_KEYS = ("ww", "mu", "t", "t_ave", "u", "v")

#: the vertical-acoustics state and its vertical vector (``with_w``)
W_STATE = ("w", "pp")
W_FIELDS_1D = ("rdn",)

HALO_BACKENDS = ("ppermute", "rdma", "rdma_overlap")


def small_step_golden(case, steps: int, cs2: float = DEFAULT_CS2,
                      with_w: bool = False,
                      cw: float = DEFAULT_CW, gw: float = DEFAULT_GW,
                      smdiv: float = 0.0):
    """Golden-path acoustic loop on memory-window arrays (single tile):
    each substep the numpy wind update, then ``advance_mu_t_numpy`` and,
    with ``with_w``, the vertically-implicit w/pp substep
    (``advance_w_numpy``) on the theta field the mu/t substep just
    produced.  With ``smdiv`` the wind update applies divergence damping
    from the previous substep's mudf (zero on the first substep).  The
    port of ``wrf_tpu.models.small_step.small_step_golden``."""
    kw = case.kernel_kwargs()
    i0, i1, j0, j1, k0, k1 = case.bounds.loop_bounds(case.flags)
    window = (i0, i1, j0, j1)
    state = {k: np.asarray(kw[k]) for k in STATE_KEYS}
    out = dict(state)
    if with_w:
        f = case.fields
        wst = {"w": np.asarray(f["grid_w"]), "pp": np.asarray(f["grid_pp"])}
        rdn = np.asarray(f["grid_rdn"])
    mudf_prev = np.zeros_like(np.asarray(kw["mu"])) if smdiv else None
    for _ in range(steps):
        u, v = advance_uv_numpy(
            u=state["u"], v=state["v"], mu=state["mu"], muu=kw["muu"],
            muv=kw["muv"], msfuy=kw["msfuy"], msfvx_inv=kw["msfvx_inv"],
            rdx=kw["rdx"], rdy=kw["rdy"], dts=kw["dts"],
            window=window, cs2=cs2, mudf=mudf_prev, smdiv=smdiv)
        out = advance_mu_t_numpy(**{**kw, **state, "u": u, "v": v})
        if with_w:
            wst["w"], wst["pp"] = advance_w_numpy(
                w=wst["w"], pp=wst["pp"], t=out["t"], rdn=rdn,
                rdnw=kw["rdnw"], dts=kw["dts"], epssm=kw["epssm"],
                window=window, k0=k0, k1=k1, cw=cw, gw=gw)
        if smdiv:
            mudf_prev = out["mudf"]
        state = {**{k: out[k] for k in ("ww", "mu", "t", "t_ave")},
                 "u": u, "v": v}
    res = {**out, "u": state["u"], "v": state["v"]}
    if with_w:
        res.update(wst)
    return res


class SmallStepLoop:
    """The coupled acoustic small-step loop over a mesh of shards.

    Same array contract as the JAX loop: ring-shaped inputs, ``prepare`` ->
    ``__call__``; returns the domain-shaped outputs, final winds included
    (and ``w``/``pp`` with ``with_w``), on the first shard's device.
    ``mesh`` None means one shard on ``device``, and then ``prepare``
    returns plain tensors; on a mesh it returns every field as its local
    blocks on their devices (``parallel/sharded.py::scatter``).

    ``kernel="cuda"`` runs :func:`advance_mu_t_fused` and, when blocked,
    :func:`coupled_multistep` (the CUDA kernels on CUDA tensors, their
    plain versions on CPU tensors); ``kernel="plain"`` always runs the
    plain versions, the exchange kernel's included, for comparisons;
    ``kernel="eager"`` runs the three whole-array ops per substep (no
    kernel; it cannot block).  ``inner_steps`` = S blocks S scan substeps
    per K3 launch; ``fast`` runs those launches in K3's fast mode (a
    tolerance, not bits).  ``with_w`` adds the vertically-implicit w/pp
    substep to every substep (``fuse_w`` in the kernels), with the
    linearized coefficients ``cw`` and ``gw``.  ``smdiv`` turns on
    divergence damping in the wind update (K1's ``mudf_in``; the eager
    ``advance_uv``'s ``mudf``); the blocked path does not carry it, so
    ``inner_steps > 1`` with ``smdiv`` raises.

    ``halo_backend``:

    * "ppermute" (copies between the blocks; default);
    * "rdma" — the hand-written ring exchange along the j mesh axis as its
      own kernel BEFORE the substep kernel (exchange-then-compute), one
      launch per device per substep; i-axis refreshes stay on ppermute.
      The blocked (``inner_steps``) path has no width-S exchange kernel:
      it runs on ppermute or not at all;
    * "rdma_overlap" — the j exchange fused INTO the substep kernel (K1's
      and K3's ``overlap``): the kernel's edge rows load the ring
      neighbours' rows through device pointers, so a substep (a block) is
      ONE launch per shard, with no K5 launch and no row copy; i-axis
      refreshes stay on ppermute and run before any shard's launch, so a
      corner cell arrives through the neighbour's refreshed i halo.  Same
      bits as the other two backends.  Requires the fused kernel;
      composes with ``smdiv``, ``with_w`` and ``inner_steps``.  On a TPU
      the point is to hide the transfer behind the interior tiles; with
      every shard on one card there is no transfer to hide, and what is
      left is the launches and copies it saves the host.

    On a mesh whose shards sit in several processes
    (``parallel/distributed.py``) "ppermute" reaches a neighbour on another
    rank through ``torch.distributed``; "rdma" and "rdma_overlap" reach a j
    neighbour in another process on the same host through its mailbox
    (``ops/halo_rdma_cuda.py::Mailbox``: a signalled put and a wait kernel,
    CUDA IPC): under "rdma" the wait scatters the rows into the halo rows,
    under "rdma_overlap" K1 and K3 read them in the mailbox.  Neighbours on
    two hosts raise (``Mesh.require_one_host``).

    ``const_dtype`` (``torch.bfloat16`` or None): reduced-precision
    constant streams, see the module docstring; requires the fused kernel.

    ``force_exchange`` runs the per-substep halo refreshes even on 1-shard
    axes (a ring of one: self-exchange).  This corrupts the boundary-ring
    rows, so it is NOT for production — it exists so a single shard can
    execute the exact in-loop exchange code path of a multi-shard run and
    the backends can be diffed on one card.

    ``memo``: the :class:`~wrf_tpu_torch.models.stage_memo.StageMemo` to
    keep the loop's pads, lean constants and Thomas K-vectors in (an RK3
    integrator's stages share one); None builds one that keeps nothing
    under ``force_exchange`` or on a mesh over processes.
    """

    def __init__(self, nx: int, ny: int, nz: int, flags: ConfigFlags,
                 n_steps: int = 1, kernel: str = "cuda", device="cuda",
                 inner_steps: int = 1, fast: bool = False,
                 smdiv: float = 0.0, cs2: float = DEFAULT_CS2,
                 with_w: bool = False,
                 cw: float = DEFAULT_CW, gw: float = DEFAULT_GW, *,
                 mesh: Mesh | None = None, halo_backend: str = "ppermute",
                 force_exchange: bool = False, const_dtype=None,
                 memo: StageMemo | None = None):
        if kernel not in ("cuda", "plain", "eager"):
            raise ValueError(f"bad kernel {kernel!r}")
        if halo_backend not in HALO_BACKENDS:
            raise ValueError(f"bad halo_backend {halo_backend!r}")
        if halo_backend == "rdma_overlap" and kernel == "eager":
            raise ValueError("rdma_overlap requires the fused kernel "
                             "(the exchange lives inside it)")
        if const_dtype is not None and kernel == "eager":
            raise ValueError("const_dtype requires the fused kernel "
                             "(kernel='cuda' or 'plain'; the JAX loop's "
                             "'pallas')")
        if const_dtype not in (None, torch.bfloat16):
            raise ValueError(f"const_dtype must be torch.bfloat16 or None, "
                             f"got {const_dtype!r}")
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        if not isinstance(inner_steps, int) or inner_steps < 1:
            raise ValueError("inner_steps must be a positive integer")
        if fast and inner_steps == 1:
            raise ValueError("fast re-associates the BLOCKED pass: it "
                             "requires inner_steps > 1 (alone it would "
                             "silently no-op)")
        if inner_steps > 1 and kernel == "eager":
            raise ValueError("inner_steps requires the fused kernel "
                             "(kernel='cuda' or 'plain')")
        if smdiv and inner_steps > 1:
            raise ValueError("inner_steps>1 does not support smdiv yet "
                             "(mudf would need its own extended rows)")
        self.device = torch.device(device)
        self._blocks = mesh is not None
        self.mesh = local_mesh(mesh, self.device)
        if halo_backend != "ppermute":
            self.mesh.require_one_host(f"halo_backend={halo_backend!r}")
        nj, ni = self.mesh.shape
        if (inner_steps > 1 and halo_backend == "rdma"
                and n_steps - 1 >= inner_steps
                and (nj > 1 or force_exchange)):
            # only rejected when the blocked path actually engages (rem >=
            # S); with fewer substeps every exchange runs on the supported
            # per-substep rdma kernel
            raise ValueError("blocked substeps (n_steps-1 >= inner_steps) "
                             "use the width-S ppermute exchange or the "
                             "overlapped in-kernel exchange (rdma_overlap); "
                             "the plain rdma backend covers the single-step "
                             "loop")
        self.domain = (nx, ny, nz)
        #: the device the spans time: the first local shard's
        self.span_device = self.mesh.device(self.mesh.local_coords()[0])
        self.n_steps = n_steps
        self.kernel = kernel
        self.inner_steps = inner_steps
        self.fast = fast
        self.cs2 = cs2
        self.smdiv = smdiv
        self.with_w = with_w
        self.cw, self.gw = cw, gw
        self.halo_backend = halo_backend
        self.const_dtype = const_dtype
        self._j_sh = nj > 1 or force_exchange
        self._i_sh = ni > 1 or force_exchange
        # the j exchange inside the kernels, where there is one to make
        self._overlap = halo_backend == "rdma_overlap" and self._j_sh
        self.window = domain_window(nx, ny, nz, flags)
        plain = kernel == "plain"
        self._step = advance_mu_t_fused_plain if plain else advance_mu_t_fused
        self._block = coupled_multistep_plain if plain else coupled_multistep
        self._rdma = (remote_refresh_multi_plain if plain
                      else remote_refresh_multi)
        self._extra = W_STATE + W_FIELDS_1D if with_w else ()
        self._names = FIELDS_3D + FIELDS_2D + FIELDS_1D + self._extra
        self._damp = ("mudf",) if smdiv else ()
        self.carry_keys = (CARRY_KEYS + (W_STATE if with_w else ())
                           + self._damp)
        self.out_names = OUT_NAMES + (W_STATE if with_w else ())
        self.memo = memo if memo is not None else StageMemo(
            keep=not (force_exchange or self.mesh.spans_processes))

    def prepare(self, arrays) -> dict:
        """Ring-shaped arrays (numpy) -> float32 tensors on the device(s),
        padded to the mesh.  With ``with_w`` the host copies of ``rdn`` and
        ``rdnw`` are kept beside their tensors (``self.memo.thomas``), so no
        call reads them back from the card."""
        out = prepare_arrays(arrays, self.mesh, extra=self._extra,
                             blocks=self._blocks)
        if self.with_w:
            blocks = as_blocks(out, self.mesh, self._blocks)
            for n in W_FIELDS_1D + ("rdnw",):
                for t in blocks[n].values():
                    self.memo.thomas.register(t, arrays[n])
        return out

    def unprepare(self, arrays, names) -> dict[str, torch.Tensor]:
        """The inverse of ``prepare`` for ``names``: ring-shaped global
        tensors on the first local shard's device (on every rank of a mesh
        that spans processes), the mesh padding dropped."""
        nx, ny, _ = self.domain
        blocks = as_blocks({n: arrays[n] for n in names}, self.mesh,
                           self._blocks)
        return {n: gather(b, self.mesh)[:ny + 2 * RING, ..., :nx + 2 * RING]
                for n, b in blocks.items()}

    def __call__(self, arrays, rdx, rdy, dts, epssm) -> dict[str, torch.Tensor]:
        mesh = self.mesh
        arrays = as_blocks({n: arrays[n] for n in self._names}, mesh,
                           self._blocks)
        nj_loc, _, ni_loc = next(iter(arrays["t"].values())).shape
        n_loc = (nj_loc, ni_loc)
        with span("wrf.loop.pad", device=self.span_device) as sp:
            local, built = self.memo.pad(arrays, mesh, self._j_sh,
                                         self._i_sh)
            if sp is not None:      # the blocks built (a reused one is free)
                sp.count = built
        # every shard's padded-local row/column 0 in ring coordinates
        offs = {c: shard_offsets(c, nj_loc, ni_loc) for c in local}
        scalars = {"rdx": rdx, "rdy": rdy, "dts": dts, "epssm": epssm}
        if self.kernel == "eager":
            outs = self._run_eager(local, scalars, offs, n_loc)
        else:
            outs = self._run_fused(local, scalars, offs, n_loc)
        return strip_local(outs, self.out_names, self.domain, mesh)

    # ------------------------------------------------------------------
    # halo refreshes between substeps (nothing on an unsharded axis)
    # ------------------------------------------------------------------
    def _refresh_j(self, fields, nj_loc, recv_only=()):
        """j-axis halo refresh of several fields' blocks on the selected
        backend (axis 0 for both 2-D and 3-D blocks)."""
        if self.halo_backend == "rdma":
            # ONE launch per device for every j halo of the substep
            self._rdma(fields, "j", self.mesh, nj_loc, recv_only=recv_only)
        else:
            for blocks in fields:
                halo.refresh_axis(blocks, 0, "j", self.mesh, nj_loc)

    def _refresh_i(self, fields, ni_loc):
        for blocks in fields:
            ndim = next(iter(blocks.values())).ndim
            halo.refresh_axis(blocks, ndim - 1, "i", self.mesh, ni_loc)

    def _refresh_fused(self, state, n_loc):
        """Before a K1 launch: mu changed in the previous substep, and the
        in-kernel wind update reads its i-1/j-1/j+1 neighbours; v's high
        halo row feeds the last row's j+1 mass flux (its low halo is never
        read).  Under damping mudf is read at the same points as mu: it
        rides the same exchange (a third field of the one rdma launch).
        Under ``rdma_overlap`` the j leg is the kernel's: only the i halos
        are refreshed here, and the result is every shard's ``overlap``
        rows (else no keyword)."""
        if not (self._j_sh or self._i_sh):
            return {c: {} for c in state}
        mu = [{c: st[k] for c, st in state.items()}
              for k in ("mu",) + self._damp]
        if self._j_sh and not self._overlap:
            v = {c: st["v"] for c, st in state.items()}
            self._refresh_j([mu[0], v] + mu[1:], n_loc[0],
                            recv_only=("", "hi") + ("",) * len(self._damp))
        if self._i_sh:
            self._refresh_i(mu, n_loc[1])
        if not self._overlap:
            return {c: {} for c in state}
        return {c: {"overlap": rows}
                for c, rows in self._k1_overlap_rows(state, n_loc[0]).items()}

    def _overlap_rows(self, state, to_next, to_prev):
        """Every shard's ``overlap`` rows: ``to_next`` lists ``(name, field,
        row, nrows)``, the rows of its previous neighbour's ``field`` that a
        shard reads as ``name``, ``to_prev`` those of its next neighbour.
        A neighbour of this process is read where its rows lie, as views of
        its state of BEFORE this launch (kept alive through it); one in
        another process sends them into this rank's mailbox first
        (``Mailbox.neighbour_rows``).  Take them after every shard's i
        refresh."""
        mesh = self.mesh
        remote = {}
        if mesh.spans_processes:
            def spec(lst):
                return [(name, {c: st[f] for c, st in state.items()}, r, n)
                        for name, f, r, n in lst]
            remote = Mailbox.neighbour_rows(
                mesh, "j", spec(to_next), spec(to_prev),
                plain=self.kernel == "plain")
        rows = {}
        for c in state:
            rows[c] = {}
            for shift, lst in ((-1, to_next), (+1, to_prev)):
                nb = mesh.neighbour(c, "j", shift)
                for name, f, r, n in lst:
                    rows[c][name] = (state[nb][f][r:r + n] if nb in state
                                     else remote[c][name])
        return rows

    def _k1_overlap_rows(self, state, nj_loc):
        """Every shard's K1 ``overlap`` rows: the rows the rdma refresh
        would have moved (a row, not a slab: the first of one-row
        views)."""
        damp = (("mudf_lo", "mudf", nj_loc, 1),) if self.smdiv else ()
        to_prev = (("mu_hi", "mu", 1, 1), ("v_hi", "v", 1, 1)) + (
            (("mudf_hi", "mudf", 1, 1),) if self.smdiv else ())
        rows = self._overlap_rows(state, (("mu_lo", "mu", nj_loc, 1),)
                                  + damp, to_prev)
        return {c: {k: v[0] for k, v in r.items()} for c, r in rows.items()}

    def _k3_overlap_rows(self, st, nj_loc):
        """Every shard's K3 ``overlap`` slabs on ring-S blocks: the ring
        rows ``refresh_axis_w`` would have filled, named where they lie in
        the neighbours' state of BEFORE this block's launches (or, across
        processes, in the mailbox)."""
        S = self.inner_steps
        names = ("mu", "u", "v")
        return self._overlap_rows(
            st, [(n + "_lo", n, nj_loc, S) for n in names],
            [(n + "_hi", n, S, S) for n in names])

    def _launch_all(self, launch, shards):
        """One kernel launch per shard.  Under ``rdma_overlap`` a launch
        reads its neighbours' blocks, so shards on several cards order their
        streams around the launches (``Mesh.join_streams``: nothing on one
        card, whose stream orders them)."""
        if self._overlap:
            self.mesh.join_streams()
        out = {c: launch(c) for c in shards}
        if self._overlap:
            self.mesh.join_streams()
        return out

    # ------------------------------------------------------------------
    # the fused path: K1 per substep, K3 per block of S
    # ------------------------------------------------------------------
    def _fused_inputs(self, local, scalars, offs):
        """What every K1 and K3 launch of a call shares, per shard: the
        common keywords (window, offsets, vertical bounds, scalars, and with
        ``with_w`` the Thomas K-vectors of this dts, built once per device
        and vector and kept across calls; fast: with the cumsum scale
        vectors), and the carried state
        at the start (``ww_row`` from ww's seed level, a zero ``mudf`` under
        damping: no divergence tendency before the first substep)."""
        _, _, nz = self.domain
        i0, i1, j0, j1, k0, k1 = self.window
        common, thomas = {}, {}
        for c, padded in local.items():
            common[c] = dict(window=(i0, i1, j0, j1), offsets=offs[c], k0=k0,
                             k1=k1, kde=nz - 1, cs2=self.cs2, **scalars)
            if self.with_w:
                dev = padded["rdn"].device
                if dev not in thomas:
                    thomas[dev] = self.memo.thomas.get(
                        rdn=padded["rdn"], rdnw=padded["rdnw"],
                        dts=scalars["dts"], epssm=scalars["epssm"],
                        cw=self.cw, gw=self.gw, k0=k0, k1=k1, fast=self.fast)
                common[c].update(fuse_w=True, cw=self.cw, gw=self.gw,
                                 thomas=thomas[dev])
            padded["ww_row"] = padded["ww"][:, k0, :].contiguous()
            if self.smdiv:
                padded["mudf"] = torch.zeros_like(padded["mu"])
        state = {c: {k: p[k] for k in self.carry_keys}
                 for c, p in local.items()}
        return common, state

    def _run_fused(self, local, scalars, offs, n_loc):
        k0, k1 = self.window[4:]
        rdx, rdy, dts = (scalars[k] for k in ("rdx", "rdy", "dts"))
        carry = self.carry_keys
        S = self.inner_steps
        n_blocks = (self.n_steps - 1) // S if S > 1 else 0
        rem = self.n_steps - 1 - n_blocks * S

        with span("wrf.loop.inputs", device=self.span_device) as sp:
            common, state = self._fused_inputs(local, scalars, offs)
            if n_blocks:
                blocked = self._block_inputs(local, state, common, n_loc)
            built = 0
            if rem:
                lean_kw, built = self.memo.lean(local, rdx, rdy, dts, k0,
                                                k1)
            if sp is not None:      # the constants built (reuse is free)
                sp.count = built
            if self.const_dtype is not None:
                # reduced-precision constant streams: cast ONCE per call,
                # outside the substeps, after every constant was computed
                # from the float32 fields.  u and v are carried state here
                # and stay float32; only the never-written 3-D bases narrow.
                cd = self.const_dtype
                for p in local.values():
                    for n in ("u_1", "v_1", "ww_1", "ft", "t_1"):
                        p[n] = p[n].to(cd)
                if rem:
                    lean_kw = {c: {k: (x.to(cd) if x.ndim == 3 else x)
                                   for k, x in kw.items()}
                               for c, kw in lean_kw.items()}
            const = {c: {k: v for k, v in p.items() if k not in carry}
                     for c, p in local.items()}

        def ins(c):
            # the carried mudf is the kernel's mudf_in; its mudf output, a
            # fresh buffer, is the next substep's (nothing is copied)
            st = dict(state[c])
            if self.smdiv:
                st.update(mudf_in=st.pop("mudf"), smdiv=self.smdiv)
            return st

        with span("wrf.loop.substeps", device=self.span_device):
            if n_blocks:
                state = self._run_blocks(*blocked, n_blocks, n_loc)
            for _ in range(rem):
                ov = self._refresh_fused(state, n_loc)
                outs = self._launch_all(
                    lambda c: self._step(**const[c], **ins(c), **lean_kw[c],
                                         **common[c], **ov[c], fuse_uv=True,
                                         with_tave=False, ww_mode="lite",
                                         lean=True), local)
                state = {c: {k: out[k] for k in carry}
                         for c, out in outs.items()}
            ov = self._refresh_fused(state, n_loc)
            return self._launch_all(
                lambda c: self._step(**const[c], **ins(c), **common[c],
                                     **ov[c], fuse_uv=True, with_tave=True,
                                     ww_mode="final"), local)

    def _block_inputs(self, local, state, common, n_loc):
        """What the K3 launches of the blocked path take, per shard: the
        constants on ring-S blocks, the carried state widened to ring S and
        the launches' common keywords (:meth:`_run_blocks` runs them).  The
        ring-S layout is built ONCE: j is widened and, when i is sharded, i
        too (an unsharded i keeps its ring-1 layout and wraps); on sharded
        axes the outer cells hold the neighbours' data.  The constants are
        computed ON the widened inputs, in the JAX loop's order (computed
        first and widened after, dvdxi_const's rolls would leave wrapped
        values in ring cells the trapezoid reads).  With ``const_dtype``
        the three 3-D constants K3 streams are narrowed after they were
        computed in float32."""
        S = self.inner_steps
        mesh = self.mesh
        nj_loc, ni_loc = n_loc
        jn = "j" if self._j_sh else None

        def widen(name, src):
            blocks = {c: src[c][name] for c in src}
            ndim = next(iter(blocks.values())).ndim
            blocks = halo.widen_ring_to(blocks, 0, S, jn, mesh, nj_loc)
            if self._i_sh:
                blocks = halo.widen_ring_to(blocks, ndim - 1, S, "i", mesh,
                                            ni_loc)
            return blocks

        wide_f = {k: widen(k, local)
                  for k in ("ww_1", "u_1", "v_1", "ft", "t_1", "muu", "muv",
                            "msfuy", "msfvx_inv", "msftx", "msfty",
                            "mu_tend")}
        wide_s = {k: widen(k, state) for k in self.carry_keys}
        const, st, com = {}, {}, {}
        for c, padded in local.items():
            wide = {k: b[c] for k, b in wide_f.items()}
            vert = {k: padded[k] for k in ("fnm", "fnp", "rdnw", "dnw")}
            wide.update(vert)
            rdx, rdy, dts = (common[c][k] for k in ("rdx", "rdy", "dts"))
            lean = lean_kwargs(wide, rdx, rdy, dts, common[c]["k0"],
                               common[c]["k1"])
            const[c] = {"t_1": wide["t_1"], "mu_tend": wide["mu_tend"],
                        "msftx": wide["msftx"], "msfty": wide["msfty"],
                        **vert, **lean,
                        **coupled_lean_kwargs(wide, rdx, rdy, dts)}
            if self.const_dtype is not None:
                for n in ("t_1", "tconst", "dvdxi_const"):
                    const[c][n] = const[c][n].to(self.const_dtype)
            if self.with_w:
                const[c]["rdn"] = padded["rdn"]
            st[c] = {k: b[c] for k, b in wide_s.items()}
            j_off, i_off = common[c]["offsets"]
            com[c] = dict(common[c], offsets=(
                j_off, i_off - (S - 1 if self._i_sh else 0)))
        return const, st, com

    def _run_blocks(self, const, st, com, n_blocks, n_loc):
        """``n_blocks`` K3 launches per shard of S substeps on the ring-S
        inputs of :meth:`_block_inputs` (the constants, the widened state
        and the launches' keywords); returns the state back in the ring-1
        layout.  On sharded axes the block-carried mu, u and v halos are
        refreshed per block with a width-S exchange.  Under
        ``rdma_overlap`` the j leg of that exchange is K3's own
        (``coupled_multistep(overlap=)``): only the i leg runs here."""
        S = self.inner_steps
        mesh = self.mesh
        nj_loc, ni_loc = n_loc

        for _ in range(n_blocks):
            if self._j_sh or self._i_sh:
                # mu, u and v changed last block: refresh their ring-S halos
                # (mu is read S cells deep by the trapezoid; u and v S-1 —
                # the width-S exchange covers all)
                for name in ("mu", "u", "v"):
                    blocks = {c: s[name] for c, s in st.items()}
                    ndim = next(iter(blocks.values())).ndim
                    if self._j_sh and not self._overlap:
                        halo.refresh_axis_w(blocks, 0, "j", mesh, nj_loc, S)
                    if self._i_sh:
                        halo.refresh_axis_w(blocks, ndim - 1, "i", mesh,
                                            ni_loc, S)
            ov = {c: {} for c in st}
            if self._overlap:   # after every shard's i refresh
                ov = {c: {"overlap": rows} for c, rows in
                      self._k3_overlap_rows(st, nj_loc).items()}
            st = self._launch_all(
                lambda c: self._block(**const[c], **st[c], **com[c], **ov[c],
                                      n_inner=S, fast=self.fast), st)

        def strip(x):
            x = halo.strip_ring(x, 0, S)
            if self._i_sh:
                x = halo.strip_ring(x, x.ndim - 1, S).contiguous()
            return x

        return {c: {k: strip(s[k]) for k in self.carry_keys}
                for c, s in st.items()}

    # ------------------------------------------------------------------
    # the eager path: three whole-array calls per substep
    # ------------------------------------------------------------------
    def _run_eager(self, local, scalars, offs, n_loc):
        """Every substep as three whole-array calls per shard: the wind
        update, the mu/t substep and, with ``with_w``, the w/pp substep on
        its new theta (the JAX loop's ``kernel="xla"`` substep).  On a
        mesh mu (and mudf under damping) is refreshed before the wind
        update reads its neighbours, and u and v after it (advance_mu_t
        reads u(i+1) and v(j+1))."""
        _, _, nz = self.domain
        i0, i1, j0, j1, k0, k1 = self.window
        nj_loc, ni_loc = n_loc
        carry = STATE_KEYS + (W_STATE if self.with_w else ()) + self._damp
        with span("wrf.loop.inputs", device=self.span_device):
            masks, const, state = {}, {}, {}
            for c, padded in local.items():
                if self.smdiv:
                    padded["mudf"] = torch.zeros_like(padded["mu"])
                J, _, I = padded["t"].shape
                dev = padded["t"].device
                i_idx = torch.arange(I, device=dev) + offs[c][1]
                j_idx = torch.arange(J, device=dev) + offs[c][0]
                masks[c] = dict(i_mask=(i_idx >= i0) & (i_idx <= i1),
                                j_mask=(j_idx >= j0) & (j_idx <= j1))
                const[c] = {k: v for k, v in padded.items()
                            if k not in carry + W_FIELDS_1D}
                state[c] = {k: padded[k] for k in carry}
        with span("wrf.loop.substeps", device=self.span_device):
            outs = {c: dict(s) for c, s in state.items()}
            for _ in range(self.n_steps):
                mu = [{c: s[k] for c, s in state.items()}
                      for k in ("mu",) + self._damp]
                if self._j_sh:
                    self._refresh_j(mu, nj_loc)
                if self._i_sh:
                    self._refresh_i(mu, ni_loc)
                u, v = {}, {}
                for c, s in state.items():
                    u[c], v[c] = advance_uv(
                        u=s["u"], v=s["v"], mu=s["mu"], muu=const[c]["muu"],
                        muv=const[c]["muv"], msfuy=const[c]["msfuy"],
                        msfvx_inv=const[c]["msfvx_inv"], rdx=scalars["rdx"],
                        rdy=scalars["rdy"], dts=scalars["dts"],
                        window=(i0, i1, j0, j1), offsets=offs[c], cs2=self.cs2,
                        mudf=s.get("mudf"), smdiv=self.smdiv)
                if self._j_sh:
                    self._refresh_j([u, v], nj_loc)
                if self._i_sh:
                    self._refresh_i([u, v], ni_loc)
                for c, s in state.items():
                    ins = {k: s[k] for k in ("ww", "mu", "t", "t_ave")}
                    out = advance_mu_t_impl(
                        **const[c], **ins, u=u[c], v=v[c], **scalars,
                        **masks[c], k0=k0, k1=k1, kde=nz - 1)
                    out = {**out, "u": u[c], "v": v[c]}
                    if self.with_w:
                        out["w"], out["pp"] = advance_w(
                            w=s["w"], pp=s["pp"], t=out["t"],
                            rdn=local[c]["rdn"], rdnw=local[c]["rdnw"],
                            dts=scalars["dts"], epssm=scalars["epssm"],
                            window=(i0, i1, j0, j1), offsets=offs[c], k0=k0,
                            k1=k1, cw=self.cw, gw=self.gw)
                    outs[c] = out
                    state[c] = {k: out[k] for k in carry}
            return outs
