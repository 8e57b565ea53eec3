"""Device-resident iteration state: accumulate, flip, and update on device.

The classic ``Driver.iterate`` kept per-iteration accumulators
(``haplobase``/``haplocount``/``infprobs``/coherence) in host numpy and
moved [NI, M]-shaped tensors across the host link several times per
iteration — readbacks after every scan chunk, re-uploads into the
capped-gradient update programs, one dispatch per coherence slot.

This module keeps the whole accumulate -> flip -> update chain on
device; per iteration only small control tensors cross the link:

* scan partials are added into persistent [NI, Mtot] device buffers with
  donated-buffer slice-add programs (no readback);
* adjacent-phase coherence runs as ONE program for all family slots
  (serialised internally so only one slot's temporaries are live — the
  concurrent all-slot form exceeded HBM at B=1000) and scatters straight
  into device num/den buffers;
* phase flips (negshifter, cnF2freq.cpp:3437-3460) mirror the host
  haploweight inversion onto the device accumulators;
* the capped-gradient updates (updatehaploweights / processinfprobs,
  cnF2freq.cpp:4179-4323, 4533-4734) consume the device buffers directly
  and return the new per-individual state, which is read back once per
  iteration to keep the host ``Pedigree`` authoritative between
  iterations.

Exactness: every program reuses the same jitted kernels as the host
path (collective merges, relskew ratio, cappedgd), and f64 accumulation
adds the same values in the same order — the resident path is pinned
equal to the classic path by tests/test_resident.py.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import ModelConfig, RuntimeParams

MAX_FLIPS = 64   # padded per-(chromosome, winner) flip capacity


def _donate(*argnums):
    """Buffer donation for the accumulate programs (in-place updates on
    device); the CPU backend does not implement donation and would warn
    on every call."""
    return argnums if jax.default_backend() != "cpu" else ()


def _poison(tree, scalar):
    """Attach a zero-valued data dependency on ``scalar`` to every float
    leaf of ``tree`` — forces XLA to schedule the consumer after the
    producer of ``scalar`` (bounds peak memory of the slot loop)."""
    z = (scalar * 0).astype(jnp.float32)

    def leaf(x):
        if isinstance(x, jnp.ndarray) and jnp.issubdtype(x.dtype,
                                                        jnp.floating):
            return x + z.astype(x.dtype)
        return x
    return jax.tree_util.tree_map(leaf, tree)


class ResidentAccum:
    """Per-iteration accumulators living on device.

    Buffers: hb/hc [NI, Mtot], inf [NI, Mtot, 2, 2], cnum/cden
    [NI, Mtot].  ``add`` folds one chunk's merged scan partials in at a
    chromosome offset; ``flip_rows`` applies the phase-flip inversion to
    hb; ``rows_slice`` hands the flip scorer device views."""

    def __init__(self, NI: int, Mtot: int, dtype, with_coh: bool,
                 progs: Dict = None, sharding=None):
        self.NI, self.Mtot = NI, Mtot
        self.dtype = dtype
        self.with_coh = with_coh
        self.sharding = sharding

        def place(arr):
            return jax.device_put(arr, sharding) \
                if sharding is not None else arr

        def z():
            # distinct buffers: donation forbids passing one device
            # buffer as two donated operands
            return place(jnp.zeros((NI, Mtot), dtype=dtype))
        self.hb = z()
        self.hc = z()
        self.inf = place(jnp.zeros((NI, Mtot, 2, 2), dtype=dtype))
        self.cnum = z() if with_coh else None
        self.cden = z() if with_coh else None
        # program cache OWNED BY THE CALLER (Driver._scan_cache): a
        # fresh accum is built every iteration, and per-instance jits
        # would retrace (and on a remote toolchain re-lower) every call
        self._progs: Dict = progs if progs is not None else {}

    # -- slice-add ----------------------------------------------------
    def _add_prog(self, Mc: int):
        key = ("resident_add", self.NI, self.Mtot, str(self.dtype), Mc)
        if key not in self._progs:
            @partial(jax.jit, donate_argnums=_donate(0, 1, 2))
            def add(hb, hc, inf, hb_p, hc_p, inf_p, lo):
                def upd(buf, part):
                    cur = jax.lax.dynamic_slice_in_dim(
                        buf, lo, Mc, axis=1)
                    return jax.lax.dynamic_update_slice_in_dim(
                        buf, cur + part[:, :Mc].astype(buf.dtype), lo,
                        axis=1)
                return upd(hb, hb_p), upd(hc, hc_p), upd(inf, inf_p)
            self._progs[key] = add
        return self._progs[key]

    def add(self, lo: int, Mc: int, hb_p, hc_p, inf_p):
        self.hb, self.hc, self.inf = self._add_prog(Mc)(
            self.hb, self.hc, self.inf, hb_p, hc_p, inf_p, lo)

    def _add_coh_prog(self, Mc: int):
        key = ("resident_addcoh", self.NI, self.Mtot, str(self.dtype), Mc)
        if key not in self._progs:
            @partial(jax.jit, donate_argnums=_donate(0, 1))
            def add(cnum, cden, num_p, den_p, lo):
                def upd(buf, part):
                    cur = jax.lax.dynamic_slice_in_dim(
                        buf, lo, Mc, axis=1)
                    return jax.lax.dynamic_update_slice_in_dim(
                        buf, cur + part[:, :Mc].astype(buf.dtype), lo,
                        axis=1)
                return upd(cnum, num_p), upd(cden, den_p)
            self._progs[key] = add
        return self._progs[key]

    def add_coh(self, lo: int, Mc: int, num_p, den_p):
        self.cnum, self.cden = self._add_coh_prog(Mc)(
            self.cnum, self.cden, num_p, den_p, lo)

    # -- phase-flip mirror --------------------------------------------
    def _flip_prog(self):
        key = ("resident_flip", self.NI, self.Mtot, str(self.dtype))
        if key not in self._progs:
            Mtot = self.Mtot

            @partial(jax.jit, donate_argnums=_donate(0))
            def flip(hb, hc, rows, starts, hi, k):
                m = jnp.arange(Mtot)

                def body(i, hb):
                    r = rows[i]
                    sel = (m > starts[i]) & (m < hi) & (i < k)
                    row = jnp.where(sel, hc[r] - hb[r], hb[r])
                    return hb.at[r].set(row)
                return jax.lax.fori_loop(0, MAX_FLIPS, body, hb)
            self._progs[key] = flip
        return self._progs[key]

    def flip_rows(self, flips: List[Tuple[int, int]], hi: int):
        """flips: [(accumulator row, flip marker m)]; inverts
        hb[row, m+1:hi] about hc (apply_flips' accumulator mirror)."""
        if not flips:
            return
        for at in range(0, len(flips), MAX_FLIPS):
            part = flips[at:at + MAX_FLIPS]
            rows = np.zeros(MAX_FLIPS, dtype=np.int32)
            starts = np.full(MAX_FLIPS, self.Mtot, dtype=np.int32)
            for i, (r, mm) in enumerate(part):
                rows[i], starts[i] = r, mm
            self.hb = self._flip_prog()(
                self.hb, self.hc, jnp.asarray(rows), jnp.asarray(starts),
                hi, len(part))

    # -- haploweight mirror flip --------------------------------------
    def _flip_hw_prog(self):
        key = ("resident_fliphw", self.NI, self.Mtot, str(self.dtype))
        if key not in self._progs:
            Mtot = self.Mtot

            @partial(jax.jit, donate_argnums=_donate(0))
            def flip(hw, rows, starts, hi, k):
                m = jnp.arange(Mtot)

                def body(i, hw):
                    r = rows[i]
                    sel = (m > starts[i]) & (m < hi) & (i < k)
                    row = jnp.where(sel, 1.0 - hw[r], hw[r])
                    return hw.at[r].set(row)
                return jax.lax.fori_loop(0, MAX_FLIPS, body, hw)
            self._progs[key] = flip
        return self._progs[key]

    def flip_hw(self, hwj, flips: List[Tuple[int, int]], hi: int):
        """The device haploweight-mirror form of apply_flips
        (negshifter, cnF2freq.cpp:3437-3460): hw[row, m+1:hi] ->
        1 - hw[row, m+1:hi].  Returns the flipped [NI, Mtot] array."""
        for at in range(0, len(flips), MAX_FLIPS):
            part = flips[at:at + MAX_FLIPS]
            rows = np.zeros(MAX_FLIPS, dtype=np.int32)
            starts = np.full(MAX_FLIPS, self.Mtot, dtype=np.int32)
            for i, (r, mm) in enumerate(part):
                rows[i], starts[i] = r, mm
            hwj = self._flip_hw_prog()(
                hwj, jnp.asarray(rows), jnp.asarray(starts), hi,
                len(part))
        return hwj

    # -- scorer views -------------------------------------------------
    def _rows_prog(self, s0: int, span: int):
        key = ("resident_rows", self.NI, self.Mtot, str(self.dtype), s0, span)
        if key not in self._progs:
            @jax.jit
            def take(hb, hc, rows):
                return (hb[rows, s0:s0 + span], hc[rows, s0:s0 + span])
            self._progs[key] = take
        return self._progs[key]

    def rows_slice(self, rows: np.ndarray, s0: int, span: int):
        return self._rows_prog(s0, span)(self.hb, self.hc,
                                         jnp.asarray(rows))


def make_coherence_all(cfg: ModelConfig, params: RuntimeParams,
                       num_individuals: int):
    """One program: per-slot adjacent-phase coherence for EVERY family
    slot, scattered onto per-individual num/den partials [NI, Mp].

    Slots are chained through a zero-valued scalar dependency so XLA
    schedules them serially — one slot's [B, M, 2, NS, S] temporaries
    live at a time (the naive all-slot program exceeded 16 GiB HBM at
    B=1000, M=192).  Replaces numslots separate dispatches."""
    from .hmm.forward_backward import FBResult
    from .hmm.transition import interval_recomb, transition_eigenvalues

    @partial(jax.jit, static_argnames=("Mc",))
    def run(fb, dists, fw_pre, bw, fw_pre_f, bw_f, ratemat, lut,
            Mc: int):
        dtype = fw_pre.dtype
        B, Mp = fb.md.shape[0], fb.md.shape[2]
        lam = transition_eigenvalues(
            cfg, interval_recomb(cfg, params, dists,
                                 ratemat=ratemat)).astype(dtype)
        fbres = FBResult(fw_pre=fw_pre, fw_post=fw_pre, bw=bw,
                         fw_pre_f=fw_pre_f, fw_post_f=fw_pre_f, bw_f=bw_f)
        cols = []
        prev = jnp.zeros((), dtype=dtype)
        pair_acc = jnp.zeros((), dtype=dtype)
        tot = None
        if cfg.numgen != 2:
            # slot-independent pair total, shared by every column
            from .hmm.emission import build_blocks
            from .hmm.probes import phase_pair_total
            tot = phase_pair_total(fbres,
                                   build_blocks(fb, cfg, dtype=dtype),
                                   fb, cfg, lam)
        for slot in range(cfg.numslots):
            # serialise in PAIRS: two slots' temporaries fit HBM
            # concurrently (one chain is ~3 GiB at B=1000, M=192 f32;
            # the free-for-all 7-slot program did not fit), halving the
            # serial depth of the single-slot chain
            fb_s = _poison(fb, prev) if slot >= 2 else fb
            if cfg.numgen == 2:
                from .engine_ng2 import coherence_slot_ng2
                c = coherence_slot_ng2(fb_s, dists, fw_pre, bw, fw_pre_f,
                                       bw_f, cfg, params, slot,
                                       ratemat=ratemat)
            else:
                from .hmm.emission import build_blocks
                from .hmm.probes import phase_coherence_slot
                blocks = build_blocks(fb_s, cfg, dtype=dtype)
                c = phase_coherence_slot(fbres, blocks, fb_s, cfg, lam,
                                         slot, tot=tot)
            pair_acc = pair_acc + c[0, 0]
            if slot % 2 == 1:
                prev, pair_acc = prev + pair_acc, jnp.zeros((),
                                                           dtype=dtype)
            cols.append(c)
        coh = jnp.stack(cols, axis=-1)              # [B, Mp, numslots]
        # the last real marker has no right neighbour: neutral 0.5;
        # padding markers must not contribute at all
        m = jnp.arange(Mp)[None, :, None]
        coh = jnp.where(m == Mc - 1, 0.5, coh)
        return scatter_coh(coh, fb.slot_ind, fb.descendants, lut,
                           num_individuals, Mc)

    return run


def scatter_coh(coh, slot_ind, descendants, lut, num_individuals: int,
                Mc: int, axis_name: str = None):
    """Device form of updates/scatter.scatter_coherence: every occupied
    slot contributes desc-weighted coherence (duplicates add twice).
    axis_name completes the per-individual sum over a data-sharded
    batch axis (the mesh form)."""
    B, Mp, S = coh.shape
    dtype = coh.dtype
    desc = descendants.astype(dtype)
    rows = jnp.where(slot_ind > 0, lut[slot_ind], num_individuals)
    valid = (jnp.arange(Mp) < Mc)[None, :]           # [1, Mp]
    w = jnp.where(valid, 1.0, 0.0).astype(dtype)
    num = jnp.moveaxis(coh, 2, 1) * (desc[:, None, None] * w[:, None, :])
    den = jnp.broadcast_to((desc[:, None] * w)[:, None, :],
                           (B, S, Mp))
    num = jax.ops.segment_sum(num.reshape(B * S, Mp),
                              rows.reshape(B * S),
                              num_segments=num_individuals + 1)[:-1]
    den = jax.ops.segment_sum(den.reshape(B * S, Mp),
                              rows.reshape(B * S),
                              num_segments=num_individuals + 1)[:-1]
    if axis_name is not None:
        num = jax.lax.psum(num, axis_name)
        den = jax.lax.psum(den, axis_name)
    return num, den


def make_scatter_coh_ext(cfg: ModelConfig, num_individuals: int,
                         n_slots: int):
    """Scatter-only program for state spaces whose scan already delivers
    coherence (extended spaces / mesh): neutralise the last real column,
    scatter onto [NI, Mp] partials."""
    @partial(jax.jit, static_argnames=("Mc",))
    def run(coh, slot_ind, descendants, lut, Mc: int):
        Mp = coh.shape[1]
        m = jnp.arange(Mp)[None, :, None]
        coh = jnp.where(m == Mc - 1, 0.5, coh[:, :, :n_slots])
        return scatter_coh(coh, slot_ind[:, :n_slots], descendants, lut,
                           num_individuals, Mc)

    return run


def make_scatter_coh_sharded(num_individuals: int, n_slots: int, mesh,
                             Mc: int):
    """Mesh form of the coherence scatter: the sharded scan already
    returned per-unit coherence sharded over "data"; each shard
    segment-sums its slice onto [NI, Mp] partials and a psum completes
    the per-individual merge (replicated output for the resident
    add_coh fold)."""
    from jax.sharding import PartitionSpec as P

    def step(coh, slot_ind, descendants, lut):
        Mp = coh.shape[1]
        m = jnp.arange(Mp)[None, :, None]
        coh = jnp.where(m == Mc - 1, 0.5, coh[:, :, :n_slots])
        return scatter_coh(coh, slot_ind[:, :n_slots], descendants, lut,
                           num_individuals, Mc, axis_name="data")

    sharded = jax.shard_map(
        step, mesh=mesh,
        in_specs=(P("data"), P("data"), P("data"), P()),
        out_specs=(P(), P()), check_vma=False)
    return jax.jit(sharded)





def make_resident_updates(cfg: ModelConfig, params: RuntimeParams,
                          chrom_ranges: Tuple[Tuple[int, int], ...],
                          num_individuals: int, Mtot: int,
                          with_coh: bool = False):
    """Jitted whole-cohort update programs consuming device buffers.

    run_haplo: updatehaploweights (cnF2freq.cpp:4533-4734) including the
    in-program relskew ratio per chromosome and the active-lane mask.
    run_inf: processinfprobs (cnF2freq.cpp:4179-4323) including the
    best-candidate genotype pick (cnF2freq.cpp:4298-4306), returning the
    new markerdata/markersure so only final state crosses the link.

    with_coh: the adaptive-relhaplo refresh runs IN-PROGRAM from the
    resident coherence partials (cnum/cden) before the relskew ratio
    consumes rh — same arithmetic as the host block in Driver.iterate
    (relhaplo = clip(num/max(den,1)) on measured lanes, untouched
    elsewhere), so the classic and resident paths stay pinned equal."""
    from .updates import relskew_ratio
    from .updates.parameter_updates import (update_haploweights,
                                            update_infprobs)

    @jax.jit
    def run_updates(inf, md, ms, prior, priorsure, has_prior, children,
                    eligible, hw, hb, hc, rh, desc, lastinv_c, sf,
                    cnum=None, cden=None, has_rh=None, elig_idx=None):
        dtype = hw.dtype
        if with_coh:
            got = cden > 0
            vals = jnp.where(got, cnum / jnp.maximum(cden, 1), 0.5)
            rh = jnp.where(got & has_rh[:, None],
                           jnp.clip(vals, 1e-4, 1 - 1e-4), rh)
        else:
            got = jnp.zeros_like(hw, dtype=bool)
        # processinfprobs first: the haploweight similarity damping
        # reads the genotypes it just updated (call order,
        # cnF2freq.cpp:6344-6368)
        ires = update_infprobs(inf, md, ms.astype(dtype), prior,
                               priorsure.astype(dtype), has_prior,
                               children, params, sf)
        # best-candidate pick (cnF2freq.cpp:4298-4306): the side-1
        # epsilon reproduces the reference's effective allele-1
        # tie-breaking (see Driver._process_infprobs)
        live = inf > 0
        pick = jnp.where(live, ires.newprob, -jnp.inf)
        eps = jnp.asarray([0.0, 1e-30], dtype=dtype)[None, None, :]
        best = jnp.where(pick[..., 1] > pick[..., 0] - eps, 1, 0)
        bestp = jnp.take_along_axis(pick, best[..., None],
                                    axis=-1)[..., 0]
        take = (live.any(axis=-1) & jnp.isfinite(bestp)
                & eligible[:, None, None])
        newmd = jnp.where(take, best + 1, md)
        newms = jnp.where(take, (1.0 - bestp).astype(ms.dtype), ms)

        if cfg.relskews:
            parts = [relskew_ratio(hw[:, lo:hi], rh[:, lo:hi])
                     for lo, hi in chrom_ranges]
            relterm = jnp.concatenate(parts, axis=1)
        else:
            relterm = jnp.full_like(hw, 0.5)
        active = (hw > 0) & (hw < 1)
        cols = [jnp.broadcast_to(
            (hc[:, lo:hi] > 0).any(axis=1, keepdims=True),
            (hw.shape[0], hi - lo)) for lo, hi in chrom_ranges]
        active = active & jnp.concatenate(cols, axis=1)
        li = jnp.concatenate(
            [jnp.broadcast_to(lastinv_c[:, c:c + 1],
                              (hw.shape[0], hi - lo))
             for c, (lo, hi) in enumerate(chrom_ranges)], axis=1)
        hres = update_haploweights(hw, hb, hc, newmd,
                                   newms.astype(dtype), relterm, desc,
                                   children, li, active, params, sf)
        # hw_full: the merged next-iteration haploweight (inactive lanes
        # keep their input value) — stays on device as the mirror
        hw_full = jnp.where(active, hres.haploweight, hw)
        # newmd8: the compact readback copy (alleles fit int8); the
        # int32 newmd stays on device as next iteration's input.
        # elig_idx compacts the imputation outputs to the eligible rows
        # only (take is gated on eligibility, so other rows never
        # change) — at typical cohorts the F1/founder rows are the
        # majority and their md/ms readbacks were pure transfer waste.
        newmd8 = newmd.astype(jnp.int8)
        newms_out = newms
        take_out = take
        if elig_idx is not None:
            newmd8 = newmd8[elig_idx]
            newms_out = newms[elig_idx]
            take_out = take[elig_idx]
        return (newmd, newms, newmd8, take_out,
                hres.haploweight, active, ires.hits + hres.hits,
                hw_full, rh, got, newms_out)

    return run_updates


@dataclasses.dataclass
class CohortStatic:
    """Per-run device tensors for the update programs (uploaded once)."""

    prior: jnp.ndarray       # [NI, Mt, 2] int32
    priorsure: jnp.ndarray   # [NI, Mt, 2]
    has_prior: jnp.ndarray   # [NI] bool
    eligible: jnp.ndarray    # [NI] bool  (has_prior & ~empty)
    children: jnp.ndarray    # [NI]
    descendants: jnp.ndarray  # [NI]
    has_rh: jnp.ndarray      # [NI] bool  (relhaplo allocated)


def gather_cohort_static(ped, ids, dtype, ni_eff: int = None,
                         sharding=None) -> CohortStatic:
    M = ped.num_markers
    NI = ni_eff if ni_eff is not None else len(ids)
    prior = np.zeros((NI, M, 2), dtype=np.int32)
    psure = np.zeros((NI, M, 2), dtype=dtype)
    hasp = np.zeros(NI, dtype=bool)
    elig = np.zeros(NI, dtype=bool)
    children = np.zeros(NI, dtype=dtype)
    desc = np.zeros(NI, dtype=dtype)
    hasrh = np.zeros(NI, dtype=bool)
    for i, n in enumerate(ids):
        ind = ped.by_id(n)
        hasp[i] = ind.has_prior
        elig[i] = ind.has_prior and not ind.empty
        children[i] = ind.children
        desc[i] = ind.descendants
        hasrh[i] = ind.relhaplo is not None
        if ind.has_prior:
            prior[i] = ind.priormarkerdata
            psure[i] = ind.priormarkersure
    def place(x):
        x = jnp.asarray(x)
        return jax.device_put(x, sharding) if sharding is not None \
            else x
    return CohortStatic(prior=place(prior), priorsure=place(psure),
                        has_prior=place(hasp), eligible=place(elig),
                        children=place(children),
                        descendants=place(desc), has_rh=place(hasrh))


class ScanCohort:
    """Device cohort tensors for the in-program family gather: one
    upload per iteration replaces the per-(chromosome, chunk) host
    stacking + upload of [B, slots, Mc]-shaped md/ms/hw (the dominant
    remaining transfer of the resident path).

    Markers live in a PADDED layout: chromosome c occupies columns
    [plo_c, plo_c + Mp_c) with its bucketed length, so an in-program
    slice of length Mp_c never reads a neighbouring chromosome's real
    markers — pad columns carry the inert dummy-marker values
    (md=0, ms=0, hw=0.5, relh=0.5; parallel/mesh.pad_markers).  Row NI
    is the vacant-slot sentinel with the same inert values."""

    def __init__(self, ped, ids, dtype, layout, with_rh: bool,
                 dev_md=None, dev_ms=None, progs: Dict = None,
                 dev_hw=None, dev_rh=None):
        NI = len(ids)
        MP = sum(mp for _, _, _, mp in layout)
        if dev_hw is not None:
            # hw (and relh) already live on device in the real marker
            # layout (the update-program mirrors); transform in-program
            p2 = _layout_prog_2d(tuple(layout), dev_hw.shape,
                                 str(dtype),
                                 progs if progs is not None else {})
            self.hw = p2(dev_hw)
            self.rh = p2(dev_rh) if (with_rh and dev_rh is not None) \
                else None
            hw = rh = None
        else:
            hw = np.full((NI + 1, MP), 0.5, dtype=dtype)
            rh = np.full((NI + 1, MP), 0.5, dtype=dtype) if with_rh \
                else None
            for (lo, hi, plo, mp) in layout:
                sl = slice(plo, plo + (hi - lo))
                for i, n in enumerate(ids):
                    ind = ped.by_id(n)
                    hw[i, sl] = ind.haploweight[lo:hi]
                    if rh is not None and ind.relhaplo is not None:
                        rh[i, sl] = ind.relhaplo[lo:hi]
        if dev_md is not None:
            # md/ms already live on device in the real marker layout
            # (the update programs' outputs); transform in-program
            self.md, self.ms = _layout_prog(
                tuple(layout), dev_md.shape, str(dtype),
                progs if progs is not None else {})(dev_md, dev_ms)
        else:
            md = np.zeros((NI + 1, MP, 2), dtype=np.int32)
            ms = np.zeros((NI + 1, MP, 2), dtype=dtype)
            for (lo, hi, plo, mp) in layout:
                sl = slice(plo, plo + (hi - lo))
                for i, n in enumerate(ids):
                    ind = ped.by_id(n)
                    md[i, sl] = ind.markerdata[lo:hi]
                    ms[i, sl] = ind.markersure[lo:hi]
            self.md = jnp.asarray(md)
            self.ms = jnp.asarray(ms)
        if hw is not None:
            self.hw = jnp.asarray(hw)
            self.rh = jnp.asarray(rh) if rh is not None else None
        self.layout = {lo: (plo, mp) for lo, hi, plo, mp in layout}


def _layout_prog(layout, shape, dtkey, progs: Dict):
    """Real [NI, Mtot, 2] -> padded [NI+1, MPtot, 2] marker-layout
    transform on device (pad columns inert, sentinel row appended)."""
    key = ("resident_layout", layout, shape, dtkey)
    if key not in progs:
        @jax.jit
        def run(md, ms):
            def padded(x):
                parts = []
                for (lo, hi, plo, mp) in layout:
                    seg = x[:, lo:hi]
                    if mp > hi - lo:
                        seg = jnp.pad(
                            seg, [(0, 0), (0, mp - (hi - lo)), (0, 0)])
                    parts.append(seg)
                out = jnp.concatenate(parts, axis=1)
                return jnp.pad(out, [(0, 1), (0, 0), (0, 0)])
            return padded(md), padded(ms)
        progs[key] = run
    return progs[key]


def _layout_prog_2d(layout, shape, dtkey, progs: Dict):
    """Real [NI, Mtot] -> padded [NI+1, MPtot] layout transform for the
    weight tensors (hw/relh): pad columns and the sentinel row carry the
    inert value 0.5."""
    key = ("resident_layout2d", layout, shape, dtkey)
    if key not in progs:
        @jax.jit
        def run(x):
            parts = []
            for (lo, hi, plo, mp) in layout:
                seg = x[:, lo:hi]
                if mp > hi - lo:
                    seg = jnp.pad(seg, [(0, 0), (0, mp - (hi - lo))],
                                  constant_values=0.5)
                parts.append(seg)
            out = jnp.concatenate(parts, axis=1)
            return jnp.pad(out, [(0, 1), (0, 0)], constant_values=0.5)
        progs[key] = run
    return progs[key]


def make_gather_dev(Mp: int, with_rh: bool):
    """One-dispatch family gather: marker slice then row gather."""
    @jax.jit
    def run(mdC, msC, hwC, rhC, rows, plo):
        md = jax.lax.dynamic_slice_in_dim(mdC, plo, Mp, axis=1)
        ms = jax.lax.dynamic_slice_in_dim(msC, plo, Mp, axis=1)
        hw = jax.lax.dynamic_slice_in_dim(hwC, plo, Mp, axis=1)
        out_md = md[rows]               # [B, S, Mp, 2]
        out_ms = ms[rows]
        out_hw = hw[rows]
        if with_rh:
            rh = jax.lax.dynamic_slice_in_dim(rhC, plo, Mp, axis=1)
            out_rh = rh[rows[:, 0]]     # focal rows [B, Mp]
        else:
            out_rh = None
        return out_md, out_ms, out_hw, out_rh

    return run


def stack_cohort_state(ped, ids, dtype, with_rh: bool):
    """Host-side stack of the mutable cohort state (md/ms/hw/rh) for one
    upload into the update programs."""
    md = np.stack([ped.by_id(n).markerdata for n in ids]).astype(np.int32)
    ms = np.stack([ped.by_id(n).markersure for n in ids]).astype(dtype)
    hw = np.stack([ped.by_id(n).haploweight for n in ids]).astype(dtype)
    if with_rh:
        rh = np.stack([ped.by_id(n).relhaplo if ped.by_id(n).relhaplo
                       is not None else np.full(ped.num_markers, 0.5)
                       for n in ids]).astype(dtype)
    else:
        rh = np.zeros_like(hw)
    return md, ms, hw, rh
