"""Dedicated numgen==2 (4-state) engine.

The reference's small-model builds (QTLMAS15 block, settings.h:76-91:
NUMGEN=2, NUMTYPES=4, NUMPATHS=8, NUMSHIFTS=2 with haplotyping) make
two-generation analysis units cheap by shrinking every compile-time
dimension.  The embedded fallback (a numgen==3 unit with vacant
grandparent slots, tests/test_numgen2.py) is exact but does 16x the
state work and 4x the shift work.  This module runs the hot path in the
native 4-state space:

* emission blocks come from the validated numgen==3 factored builders
  (hmm/emission.py) applied to a 7-slot embedding of the 3-slot family,
  then REDUCED: the vacant-grandparent axes collapse, leaving per-parent
  leaf tensors [b, m, r0, p(2), rp(2)] — so the trackpossible semantics
  are inherited, not re-derived;
* sweeps, posteriors and turn scores run on [B, M, NS=2, S=4] tensors
  through the generic machinery (forward_backward, turn_weights_fast are
  config-driven);
* update statistics are the three-slot specializations of the probes
  contractions (focal phase bit r0^s0; parent k phase bit rp_k^g_k —
  two-generation units give parents shift 0, upflagit maths
  cnF2freq.cpp:321-329).

Scope: haplotyping configs (the QTLMAS15 shape).  The no-haplotyping
NUMGEN==2 block walks one extra pedigree level by pointer
(genwidth 0 leaves, cnF2freq.cpp:1075-1120) and keeps running through
the embedded path instead.

Validated against the golden full-iteration spec run at numgen==2
(tests/test_engine_ng2.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .config import MINFACTOR, ModelConfig, RuntimeParams
from .hmm.family import FamilyBatch

# static indicator tables ----------------------------------------------------
_J = np.arange(2)
# focal phase bit: r0 ^ s0
_IND_FOCAL = ((np.arange(2)[:, None, None] ^ np.arange(2)[None, :, None])
              == _J[None, None, :])
# parent phase bit: rp ^ g_k (no shift at two-generation parents)
_IND_PAR = ((np.arange(2)[:, None, None] ^ np.arange(2)[None, :, None])
            == _J[None, None, :])          # [g, rp, j]


def ng3_equiv(cfg: ModelConfig) -> ModelConfig:
    """The numgen==3 config whose emission builders evaluate the embedded
    two-generation family."""
    return ModelConfig(numgen=3, haplotyping=cfg.haplotyping,
                       selfing=False, relskews=cfg.relskews,
                       relskewstates=False,
                       do_infprobs=cfg.do_infprobs,
                       correction_inference=cfg.correction_inference)


def embed7(fb: FamilyBatch) -> FamilyBatch:
    """7-slot view of a 3-slot numgen==2 batch: vacant grandparent slots,
    parents as recursion tops, flag2/shift masks remapped to the
    numgen==3 bit layout (parent0 bit 1 -> 1, parent1 bit 2 -> 4; vacant
    grandparent path bits pinned; parent shift bits disabled)."""
    def put(x, fill=0):
        z = jnp.full_like(x[:, 0:1], fill)
        return jnp.concatenate([x[:, 0:1], x[:, 1:2], z, z, x[:, 2:3],
                                z, z], axis=1)

    f2 = fb.flag2ignore
    f2ig7 = ((f2 & 1) | ((f2 >> 1) & 1) << 1 | ((f2 >> 2) & 1) << 4
             | 0b1101100)
    shig7 = fb.shiftignore | 0b110
    exists7 = put(fb.exists.astype(jnp.int32)).astype(bool)
    # parents are recursion tops in a two-generation unit
    attop3 = jnp.stack([fb.attop[:, 0],
                        jnp.ones_like(fb.attop[:, 1]),
                        jnp.ones_like(fb.attop[:, 2])], axis=1)
    attop7 = put(attop3.astype(jnp.int32)).astype(bool)
    dup7 = None
    if fb.dup_flip is not None:
        z = jnp.zeros_like(fb.dup_flip[:, :, 0:1])
        dup7 = jnp.concatenate([fb.dup_flip[:, :, 0:1],
                                fb.dup_flip[:, :, 1:2], z, z,
                                fb.dup_flip[:, :, 2:3], z, z], axis=2)
    empty7 = None
    if fb.emptyslot is not None:
        empty7 = put(fb.emptyslot.astype(jnp.int32)).astype(bool)
    return dataclasses.replace(
        fb, md=put(fb.md), ms=put(fb.ms), hw=put(fb.hw, fill=0.5),
        exists=exists7, attop=attop7, flag2ignore=f2ig7,
        shiftignore=shig7, slot_ind=put(fb.slot_ind),
        emptyslot=empty7, dup_flip=dup7)


def _leaf_block(par, v, sv, ci: bool, haplotyping: bool, dtype):
    """[..., r0(2), p0(2), rp(2)] leaf term of a two-generation parent:
    matched value with the second channel absorbed (attopnow at
    genwidth 1, cnF2freq.cpp:1095, 1213-1217) times the phase factor
    rp ^ p0 (parents carry no shift bit, upflagit cnF2freq.cpp:321-329);
    1 + sv with the path bit canonically pinned when vacant."""
    from .config import ZP_NONE
    from .hmm.emission import _match_raw

    def ex3(x):
        x = jnp.asarray(x)
        return x.reshape(x.shape + (1, 1, 1))

    def pick3(pair, idx):
        return jnp.where(idx == 1, ex3(pair[..., 1]), ex3(pair[..., 0]))

    R0 = np.arange(2).reshape(2, 1, 1)
    P0 = np.arange(2).reshape(1, 2, 1)
    RP = np.arange(2).reshape(1, 1, 2)
    vb = pick3(v, R0)
    svb = pick3(sv, R0)
    md_rp = pick3(par.md, RP)
    ms_rp = pick3(par.ms, RP)
    bv, pre, _ = _match_raw(vb, svb, md_rp, ms_rp, ZP_NONE)
    f2n = RP ^ P0
    collapse = ex3((par.md[..., 0] == par.md[..., 1]) &
                   (ci | (par.ms[..., 0] == par.ms[..., 1])))
    if haplotyping:
        w = jnp.abs(f2n - ex3(par.hw))
    else:
        w = jnp.full_like(ex3(par.hw) + f2n, 0.5)
    ph = jnp.where(collapse, f2n.astype(dtype), w)
    term = (bv + pre) * ph
    term = jnp.where(ex3(par.exists), term, 1.0 + svb)
    return term * jnp.where(ex3(par.exists), True, RP == 0)


def ng2_blocks(fb: FamilyBatch, cfg: ModelConfig, ci: bool = False,
               dtype=jnp.float64, update: int = 0, inval=None, insv=None,
               side: int = 0):
    """(froot [b,m,r,t], P2 [k][b,m,r,p,rp], top, focal_attop): the
    4-state factored emission — the focal term from the shared
    root_block, each parent as a direct leaf tensor (equivalent to the
    numgen==3 parent block with vacant grandparents: fp axis collapses
    to p0, fpath to rp, sk pinned 0 — pinned against the golden spec by
    tests/test_engine_ng2.py)."""
    from .hmm.emission import root_block, slot_data
    focal = slot_data(fb, 0)
    rb = root_block(focal, update=update, zp=0, ci=ci,
                    haplotyping=cfg.haplotyping, inval=inval, insv=insv,
                    side=side, dtype=dtype)
    P2 = []
    for k in range(2):
        par = slot_data(fb, 1 + k)
        first = (k == side)
        vk, svk = (rb.vA, rb.svA) if first else (rb.vB, rb.svB)
        P2.append(_leaf_block(par, vk, svk, ci, cfg.haplotyping, dtype))
    return rb.froot, P2, rb.top, fb.attop[:, 0]


def _valid_paths2(flag2ignore: jnp.ndarray, k: int) -> jnp.ndarray:
    """[b, rp(2)] canonical-path mask for parent k's path bit."""
    f2 = (flag2ignore[:, None] >> (1 + k)) & 1
    return (np.arange(2)[None, :] & f2) == 0


def assemble_e_ng2(froot, P2, top, focal_attop, fb: FamilyBatch,
                   cfg: ModelConfig) -> jnp.ndarray:
    """E[b, m, NS(2), S(4)] summed over paths; state g = g1*2 + g0."""
    V = [_valid_paths2(fb.flag2ignore, k).astype(froot.dtype)
         for k in range(2)]
    ps = [jnp.einsum("zmrap,zp->zmra", P2[k], V[k]) for k in range(2)]
    e = jnp.einsum("zmrt,zmra,zmrb->zmtba", froot, ps[0], ps[1])
    B, M = e.shape[:2]
    e = e.reshape(B, M, 2, 4)
    tops = top.sum(axis=-2)                         # sum over r0
    tops = jnp.broadcast_to(tops[:, :, :, None], (B, M, 2, 4))
    return jnp.where(focal_attop[:, None, None, None], tops, e)


def phase_resolved_emission_ng2(froot, P2, top, focal_attop,
                                fb: FamilyBatch, cfg: ModelConfig,
                                slot: int) -> jnp.ndarray:
    """E_j[b, m, j(2), NS(2), S(4)]: emission restricted to the slot's
    phase-interpretation bit == j (focal: r0^s0; parent k: rp_k^g_k)."""
    dtype = froot.dtype
    V = [_valid_paths2(fb.flag2ignore, k).astype(dtype) for k in range(2)]
    PV = [P2[k] * V[k][:, None, None, None, :] for k in range(2)]
    ps = [PV[k].sum(axis=-1) for k in range(2)]          # [b,m,r,g]
    INDF = jnp.asarray(_IND_FOCAL, dtype=dtype)
    INDP = jnp.asarray(_IND_PAR, dtype=dtype)
    if slot == 0:
        e = jnp.einsum("zmrt,zmra,zmrb,rtj->zmjtba",
                       froot, ps[0], ps[1], INDF)
    elif slot == 1:
        ph = jnp.einsum("zmrap,apj->zmraj", PV[0], INDP)
        e = jnp.einsum("zmrt,zmraj,zmrb->zmjtba", froot, ph, ps[1])
    else:
        ph = jnp.einsum("zmrbq,bqj->zmrbj", PV[1], INDP)
        e = jnp.einsum("zmrt,zmrbj,zmra->zmjtba", froot, ph, ps[0])
    B, M = e.shape[:2]
    return e.reshape(B, M, 2, 2, 4)


def coherence_slot_ng2(fb: FamilyBatch, dists, fw_pre, bw, fw_pre_f,
                       bw_f, cfg: ModelConfig, params: RuntimeParams,
                       slot: int, ratemat=None) -> jnp.ndarray:
    """Adjacent-phase coherence for one slot of the 4-state engine."""
    from .hmm.forward_backward import FBResult
    from .hmm.probes import pair_coherence_from_ej
    from .hmm.transition import interval_recomb, transition_eigenvalues
    froot, P2, top, focal_attop = ng2_blocks(fb, cfg, dtype=fw_pre.dtype)
    lam = transition_eigenvalues(
        cfg, interval_recomb(cfg, params, dists,
                             ratemat=ratemat)).astype(fw_pre.dtype)
    e_j = phase_resolved_emission_ng2(froot, P2, top, focal_attop, fb,
                                      cfg, slot)
    fbres = FBResult(fw_pre=fw_pre, fw_post=fw_pre, bw=bw,
                     fw_pre_f=fw_pre_f, fw_post_f=fw_pre_f, bw_f=bw_f)
    return pair_coherence_from_ej(fbres, e_j, lam)


def haplo_update_mask_ng2(fb: FamilyBatch, cfg: ModelConfig,
                          ci: bool = False) -> jnp.ndarray:
    """[b, m, 3] bool — visited, existing, not duplicate-allele
    collapsed (doupdatehaplo, cnF2freq.cpp:1224-1252)."""
    collapse = (fb.md[..., 0] == fb.md[..., 1]) & \
        (ci | (fb.ms[..., 0] == fb.ms[..., 1]))     # [b, slot, m]
    collapse = jnp.moveaxis(collapse, 1, 2)
    exists = fb.exists[:, None, :]
    focal_attop = fb.attop[:, 0][:, None, None]
    par_vis = exists & ~focal_attop
    vis = jnp.concatenate([jnp.ones_like(par_vis[..., 0:1], dtype=bool),
                           par_vis[..., 1:2], par_vis[..., 2:3]], axis=-1)
    return vis & exists & ~collapse


def haplo_stats_ng2(W, froot, P2, fb, cfg):
    """[b, m, 3, 2] posterior phase-interpretation counts (updatehaplo,
    cnF2freq.cpp:1561-1575)."""
    dtype = W.dtype
    B, M = W.shape[:2]
    Wr = W.reshape(B, M, 2, 2, 2)           # [b, m, s0, g1, g0]
    V = [_valid_paths2(fb.flag2ignore, k).astype(dtype) for k in range(2)]
    PV = [P2[k] * V[k][:, None, None, None, :] for k in range(2)]
    INDF = jnp.asarray(_IND_FOCAL, dtype=dtype)
    INDP = jnp.asarray(_IND_PAR, dtype=dtype)

    # T1 folds parent 1 away: [b, m, r, g0, s0]
    T1 = jnp.einsum("zmrb,zmtba->zmrat", PV[1].sum(axis=-1), Wr)
    T0 = jnp.einsum("zmra,zmtba->zmrbt", PV[0].sum(axis=-1), Wr)

    # focal: [b, m, j]
    F = jnp.einsum("zmra,zmrat->zmrt", PV[0].sum(axis=-1), T1)
    b_focal = jnp.einsum("zmrt,zmrt,rtj->zmj", froot, F, INDF)
    # parent 0: fold froot + T1, project (g0, rp0) on the phase bit
    Y0 = jnp.einsum("zmrt,zmrap,zmrat->zmap", froot, PV[0], T1)
    b_p0 = jnp.einsum("zmap,apj->zmj", Y0, INDP)
    Y1 = jnp.einsum("zmrt,zmrbq,zmrbt->zmbq", froot, PV[1], T0)
    b_p1 = jnp.einsum("zmbq,bqj->zmj", Y1, INDP)
    return jnp.stack([b_focal, b_p0, b_p1], axis=2)


def _share_blocks_ng2(fb, cfg, side, mv, ci, dtype):
    """U[b, m, r', p, rp, s0]: the traced side-branch of a GENOSPROBE
    with root value mv (sideval, cnF2freq.cpp:5517-5527).  Only the
    traced parent's leaf is built — the untraced branch cancels in the
    share ratio."""
    from .hmm.emission import root_block, slot_data
    B, M = fb.md.shape[0], fb.md.shape[2]
    inval = jnp.full((B, M), mv, dtype=jnp.int32)
    focal = slot_data(fb, 0)
    rb = root_block(focal, ci=ci, haplotyping=cfg.haplotyping,
                    inval=inval, side=side, dtype=dtype)
    leaf = _leaf_block(slot_data(fb, 1 + side), rb.vA, rb.svA, ci,
                       cfg.haplotyping, dtype)
    # U axes: [b, m, r', p, rp, s0]
    return rb.froot[:, :, :, None, None, :] * leaf[..., None]


def infprob_stats_ng2(W, froot, P2, fb, cfg, ci: bool = False):
    """(accum [b, m, 3, 2, 2], pair [b, m, 2, 2]): GENOS accumulator
    additions per slot/allele-slot/candidate plus the ordered-genotype
    posterior."""
    dtype = W.dtype
    B, M = W.shape[:2]
    Wr = W.reshape(B, M, 2, 2, 2)
    V = [_valid_paths2(fb.flag2ignore, k).astype(dtype) for k in range(2)]
    PV = [P2[k] * V[k][:, None, None, None, :] for k in range(2)]
    T1 = jnp.einsum("zmrb,zmtba->zmrat", PV[1].sum(axis=-1), Wr)
    T0 = jnp.einsum("zmra,zmtba->zmrbt", PV[0].sum(axis=-1), Wr)

    shares = {}
    for side in range(2):
        us = [_share_blocks_ng2(fb, cfg, side, mv, ci, dtype)
              for mv in (1, 2)]
        den = us[0] + us[1]
        for i, mv in enumerate((1, 2)):
            sh = jnp.where(den > 0, us[i] / jnp.where(den > 0, den, 1.0),
                           0.0)
            if side == 1:
                sh = sh[:, :, ::-1]     # align r' = 1 - r to the r axis
            shares[(side, mv)] = sh

    RP = jnp.asarray((np.arange(2)[:, None] == np.arange(2)[None, :])
                     .astype(np.float64), dtype=dtype)   # [rp, w]
    out = jnp.zeros((B, M, 3, 2, 2), dtype=dtype)
    for mvi, mv in enumerate((1, 2)):
        X0 = jnp.einsum("zmrt,zmrap,zmrapt,zmrat->zmrap",
                        froot, PV[0], shares[(0, mv)], T1)
        nf0 = X0.sum(axis=(-1, -2))                    # [z, m, r]
        np0 = jnp.einsum("zmrap,pw->zmw", X0, RP)
        out = out.at[:, :, 0, :, mvi].add(
            jnp.stack([nf0[..., 0], nf0[..., 1]], axis=-1))
        out = out.at[:, :, 1, :, mvi].add(np0)

        X1 = jnp.einsum("zmrt,zmrbq,zmrbqt,zmrbt->zmrbq",
                        froot, PV[1], shares[(1, mv)], T0)
        nf1 = X1.sum(axis=(-1, -2))
        np1 = jnp.einsum("zmrbq,qw->zmw", X1, RP)
        out = out.at[:, :, 0, :, mvi].add(
            jnp.stack([nf1[..., 1], nf1[..., 0]], axis=-1))
        out = out.at[:, :, 2, :, mvi].add(np1)

    # ordered-genotype posterior
    P0mv = jnp.stack([jnp.einsum("zmrap,zmrapt->zmrat", PV[0],
                                 shares[(0, mv)]) for mv in (1, 2)],
                     axis=2)
    P1mv = jnp.stack([jnp.einsum("zmrbq,zmrbqt->zmrbt", PV[1],
                                 shares[(1, mv)]) for mv in (1, 2)],
                     axis=2)
    T1mv = jnp.einsum("zmjrbt,zmtba->zmjrat", P1mv, Wr)
    pair = jnp.einsum("zmrt,zmirat,zmjrat->zmij", froot, P0mv, T1mv)
    return out, pair


def chromosome_scan_ng2(fb: FamilyBatch, dists: jnp.ndarray,
                        cfg: ModelConfig, params: RuntimeParams,
                        with_infprobs: bool = True, ratemat=None,
                        with_coherence: bool = False):
    """One 4-state chromosome scan with the full ScanResult contract."""
    from .engine import ScanResult
    from .hmm.forward_backward import combined_loglik, forward_backward
    from .hmm.probes import posterior_weight, turn_weights_fast

    if not cfg.haplotyping:
        raise NotImplementedError(
            "the dedicated numgen==2 engine covers haplotyping configs "
            "(QTLMAS15 block, settings.h:76-91); the no-haplotyping "
            "block walks one extra pedigree level by pointer "
            "(cnF2freq.cpp:1075-1120) and is not tensorized")
    dtype = fb.ms.dtype
    B, M = fb.md.shape[0], fb.md.shape[2]
    froot, P2, top, focal_attop = ng2_blocks(fb, cfg, dtype=dtype)
    e = assemble_e_ng2(froot, P2, top, focal_attop, fb, cfg)
    # the standard [B, M, NS, S] layout on every backend (ops/dispatch.py)
    fbres = forward_backward(e, dists, cfg, params, ratemat=ratemat)
    total = combined_loglik(fbres, fb.shiftignore)
    W = posterior_weight(fbres, total, fb.shiftignore)

    b12 = haplo_stats_ng2(W, froot, P2, fb, cfg)
    mask = haplo_update_mask_ng2(fb, cfg)
    if with_infprobs:
        inf, pair = infprob_stats_ng2(W, froot, P2, fb, cfg)
    else:
        inf = jnp.zeros((B, M, 3, 2, 2), dtype=dtype)
        pair = jnp.zeros((B, M, 2, 2), dtype=dtype)
    turn_w = turn_weights_fast(fbres, fb, cfg)
    if with_coherence:
        # in-scan per-slot coherence (the mesh program consumes
        # res.coherence; single-device drivers dispatch
        # coherence_slot_ng2 per slot instead — same math)
        from .hmm.probes import pair_coherence_from_ej
        from .hmm.transition import (interval_recomb,
                                     transition_eigenvalues)
        lam = transition_eigenvalues(
            cfg, interval_recomb(cfg, params, dists,
                                 ratemat=ratemat)).astype(dtype)
        cols = []
        for slot in range(cfg.numslots):
            e_j = phase_resolved_emission_ng2(froot, P2, top,
                                              focal_attop, fb, cfg, slot)
            cols.append(pair_coherence_from_ej(fbres, e_j, lam))
        coh = jnp.stack(cols, axis=-1)
    else:
        coh = jnp.full((B, M, cfg.numslots), 0.5, dtype=dtype)
    return ScanResult(total=total, haplo_b12=b12, haplo_mask=mask,
                      inf_accum=inf, pair=pair, turn_weight=turn_w,
                      coherence=coh, fw_pre=fbres.fw_pre, bw=fbres.bw,
                      fw_pre_f=fbres.fw_pre_f, bw_f=fbres.bw_f)


def make_jitted_scan_merged_ng2(cfg: ModelConfig, params: RuntimeParams,
                                num_individuals: int):
    """The numgen==2 form of engine.make_jitted_scan_merged, split into
    TWO compiled programs at the sweep/statistics boundary.

    XLA's fusion search over the combined program (the M-step scan
    feeding four statistics consumers) is far slower than over the two
    halves; the split costs one extra dispatch per chunk."""
    from .engine import ScanResult
    from .hmm.forward_backward import combined_loglik, forward_backward
    from .hmm.probes import posterior_weight, turn_weights_fast
    from .parallel.collective import merge_haplos, merge_infprobs

    if not cfg.haplotyping:
        raise NotImplementedError(
            "the dedicated numgen==2 engine covers haplotyping configs")

    @jax.jit
    def part1(fb, dists, lut, ratemat):
        dtype = fb.ms.dtype
        froot, P2, top, focal_attop = ng2_blocks(fb, cfg, dtype=dtype)
        e = assemble_e_ng2(froot, P2, top, focal_attop, fb, cfg)
        fbres = forward_backward(e, dists, cfg, params, ratemat=ratemat)
        total = combined_loglik(fbres, fb.shiftignore)
        W = posterior_weight(fbres, total, fb.shiftignore)
        b12 = haplo_stats_ng2(W, froot, P2, fb, cfg)
        mask = haplo_update_mask_ng2(fb, cfg)
        hb, hc = merge_haplos(b12, mask, fb.hw, fb.slot_ind,
                              fb.descendants, lut, num_individuals)
        turn_w = turn_weights_fast(fbres, fb, cfg)
        return froot, P2, fbres, total, W, b12, mask, turn_w, hb, hc

    @jax.jit
    def part2(fb, W, froot, P2, lut):
        inf, pair = infprob_stats_ng2(W, froot, P2, fb, cfg)
        infm = merge_infprobs(inf, fb.slot_ind, fb.descendants, lut,
                              num_individuals)
        return inf, pair, infm

    def run(fb, dists, lut, ratemat):
        (froot, P2, fbres, total, W, b12, mask, turn_w,
         hb, hc) = part1(fb, dists, lut, ratemat)
        inf, pair, infm = part2(fb, W, froot, P2, lut)
        B, M = fb.md.shape[0], fb.md.shape[2]
        coh = jnp.full((B, M, cfg.numslots), 0.5, dtype=W.dtype)
        res = ScanResult(total=total, haplo_b12=b12, haplo_mask=mask,
                         inf_accum=inf, pair=pair, turn_weight=turn_w,
                         coherence=coh, fw_pre=fbres.fw_pre,
                         bw=fbres.bw, fw_pre_f=fbres.fw_pre_f,
                         bw_f=fbres.bw_f)
        return res, hb, hc, infm

    return run
