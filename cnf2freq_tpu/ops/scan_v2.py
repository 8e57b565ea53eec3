"""Feature-leading chromosome scan: the F2 scan on the GPU.

The standard path (engine.chromosome_scan) keeps the state axis minor,
[B, M, NS, S].  This module keeps the batch minor instead, so every
sweep tensor is [M, X = NS * S, R] with R the batch padded to a whole
number of kernel lane blocks (ops/dispatch.LANE_BLOCK).  A warp then
reads 32 consecutive units of one (marker, state) row — coalesced — and
each (shift block, unit) chain of the forward-backward recursion is an
independent column:

    slot tensors [7, ..., M, R]
      | emissions_v2 (XLA): the factored emission blocks evaluated on
      |   whole arrays from ~50 scalars per (unit, marker)
      v
    e  [M, X, R]
      | fb_sweeps_v2_triton (Pallas/Triton, float32 on the GPU): one
      |   program per (shift block, lane block), the [S, lanes] carry
      |   in registers across a loop over markers; fb_scan_v2 (lax.scan)
      |   is the XLA form and the specification
      v
    fw_pre / fw_post / bw [M, X, R], log factors [M, NS, R]
      | stats_from_v2 (XLA): update statistics, enum axes leading
      | turn_weights_v2 (XLA): posterior-weighted xor-correlation at
      |   the turn offsets
      v
    b12 / infprob accum / pair / turn weights

Same update statistics as engine.chromosome_scan (pinned by
tests/test_scan_v2.py).  Which form each stage takes is decided in
ops/dispatch.py.  Every float32 contraction here asks for full float32
precision (no TF32).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..config import MINFACTOR, ModelConfig, RuntimeParams
from ..hmm.family import FamilyBatch
from ..hmm.transition import hadamard, interval_recomb, transition_eigenvalues
from . import dispatch
from . import enum_stats as sp

_HIGHEST = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# Input prep: FamilyBatch -> feature-leading slot tensors
# ---------------------------------------------------------------------------
class SlotTensors(NamedTuple):
    md: jnp.ndarray    # [7, 2, M, R] int32
    ms: jnp.ndarray    # [7, 2, M, R]
    hw: jnp.ndarray    # [7, M, R]
    ex: jnp.ndarray    # [7, R] int32
    at: jnp.ndarray    # [7, R] int32
    f2: jnp.ndarray    # [R] int32
    sh: jnp.ndarray    # [R] int32
    em: jnp.ndarray    # [7, R] int32 (emptyslot)
    df: jnp.ndarray    # [NV, 7, R] int32 (dup_flip variants)

    @property
    def R(self) -> int:
        return self.f2.shape[0]


def prep_slots(fb: FamilyBatch, dtype) -> SlotTensors:
    B = fb.md.shape[0]
    R = dispatch.pad_lanes(B)

    def padb(x):  # pad batch axis 0 to R
        pad = [(0, R - B)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, pad)

    return SlotTensors(
        md=jnp.transpose(padb(fb.md), (1, 3, 2, 0)),
        ms=jnp.transpose(padb(fb.ms.astype(dtype)), (1, 3, 2, 0)),
        hw=jnp.transpose(padb(fb.hw.astype(dtype)), (1, 2, 0)),
        ex=padb(fb.exists.astype(jnp.int32)).T,
        at=padb(fb.attop.astype(jnp.int32)).T,
        f2=padb(fb.flag2ignore),
        sh=padb(fb.shiftignore),
        em=padb(fb.emptyslot.astype(jnp.int32)).T,
        df=jnp.transpose(padb(fb.dup_flip.astype(jnp.int32)), (1, 2, 0)))


def _unit_row(x):
    """[..., R] per-unit operand -> [..., 1, R], broadcasting over M."""
    return x[..., None, :]


# ---------------------------------------------------------------------------
# Emissions: e[m, X, r] from slot data
# ---------------------------------------------------------------------------
def _e_tile(md, ms, hw, exists, attop, cfg: ModelConfig, dtype):
    """E [2(s2), 2(s1), 2(s0), 8(fp1), 8(fp0), *T] over data axes T:
    assemble_e_all semantics with the enum axes leading."""
    def slotL(s):
        return sp.SlotL(md=md[s], ms=ms[s], hw=hw[s], exists=exists[s],
                        attop=attop[s])

    focal = slotL(0)
    par = [slotL(cfg.parent_slot(k)) for k in range(2)]
    gps = [[slotL(cfg.grandparent_slot(k, j)) for j in range(2)]
           for k in range(2)]
    hap = cfg.haplotyping
    froot, vA, svA, vB, svB = sp.root_block_L(focal, haplotyping=hap,
                                              dtype=dtype)
    pbs = []
    for k in range(2):
        vk, svk = (vA, svA) if k == 0 else (vB, svB)
        pb = sp.parent_block_L(par[k], gps[k][0], gps[k][1], vk, svk,
                               haplotyping=hap)      # [r, f, p, sk, *T]
        # no flag2ignore mask here: assemble_e_all sums all paths, and
        # parent_block_L's canonical-path weights already zero every
        # path bit a vacant/attop-pruned slot cannot consume (pinned by
        # test_emission_tiles_match_assemble_e incl. vacant-slot
        # families)
        pbs.append(pb.sum(axis=2))                   # [r, f, sk, *T]

    T = md.shape[2:]
    # e[v,u,t,b,a] = sum_r froot[r,t] * pbs0[r,a,u] * pbs1[r,b,v]
    planes = []
    for v in range(2):
        for u in range(2):
            for t in range(2):
                acc = jnp.zeros((8, 8) + T, dtype=dtype)
                for r in range(2):
                    acc = acc + (froot[r, t] * pbs[0][r][:, u])[None, :] * \
                        pbs[1][r][:, v][:, None]
                planes.append(acc)
    e = jnp.stack(planes, axis=0).reshape((2, 2, 2, 8, 8) + T)
    # focal attop: E is the root term alone, constant over states and the
    # upper shift bits (assemble_e_all tops path)
    tops = froot.sum(axis=0)                          # [t(2), *T]
    tops_e = jnp.broadcast_to(tops[None, None, :, None, None],
                              (2, 2, 2, 8, 8) + T)
    return jnp.where(focal.attop, tops_e, e)


@functools.partial(jax.jit, static_argnames=("cfg", "dtype"))
def emissions_v2(st: SlotTensors, cfg: ModelConfig, dtype) -> jnp.ndarray:
    """e [M, X, R]: _e_tile on the whole [M, R] data plane (XLA fuses
    the elementwise chain into a single pass that writes e)."""
    M, R = st.md.shape[2], st.R
    e = _e_tile(st.md, st.ms, st.hw, _unit_row(st.ex) != 0,
                _unit_row(st.at) != 0, cfg, dtype)
    return jnp.transpose(e.reshape(512, M, R), (1, 0, 2))


# ---------------------------------------------------------------------------
# Feature-leading forward-backward scan (XLA form)
# ---------------------------------------------------------------------------
class FBv2(NamedTuple):
    fw_pre: jnp.ndarray    # [M, X, R]
    fw_post: jnp.ndarray   # [M, X, R]
    bw: jnp.ndarray        # [M, X, R]
    fw_pre_f: jnp.ndarray  # [M, NS, R]
    fw_post_f: jnp.ndarray
    bw_f: jnp.ndarray


def _emit_norm_v2(p, e, logf, NS, S):
    """p, e: [X, R]; logf [NS, R]."""
    p = jnp.where(p < 1e-300, 0.0, p)
    pe = (p * e).reshape(NS, S, -1)
    s = pe.sum(axis=1, keepdims=True)                 # [NS, 1, R]
    ok = s > 0
    pn = jnp.where(ok, pe / jnp.where(ok, s, 1.0), 0.0)
    logf = jnp.where(ok[:, 0], logf + jnp.log(jnp.where(ok[:, 0], s[:, 0],
                                                        1.0)), MINFACTOR)
    return pn.reshape(p.shape), logf


def _transition_v2(p, lam_row, H, NS, S):
    """p [X, R] -> H diag(lam) H p / S per shift block."""
    ph = jnp.einsum("gh,nhr->ngr", H, p.reshape(NS, S, -1),
                    precision=_HIGHEST)
    ph = ph * lam_row[None, :, None]
    q = jnp.einsum("gh,nhr->ngr", H, ph, precision=_HIGHEST) / S
    return q.reshape(p.shape)


def _lam_pad(cfg, params, dists, ratemat, dtype):
    """[M, S] eigenvalue rows: row j = interval leaving marker j; the
    last row (no interval) is the identity."""
    r = interval_recomb(cfg, params, dists, ratemat=ratemat)
    lam = transition_eigenvalues(cfg, r).astype(dtype)      # [M-1, S]
    return jnp.concatenate([lam, jnp.ones((1, cfg.numtypes), dtype=dtype)],
                           0)


def fb_scan_v2(e: jnp.ndarray, dists: jnp.ndarray, cfg: ModelConfig,
               params: RuntimeParams, ratemat=None) -> FBv2:
    """e: [M, X, R] from emissions_v2."""
    M, X, R = e.shape
    S, NS = cfg.numtypes, cfg.numshifts
    dtype = e.dtype
    lam_pad = _lam_pad(cfg, params, dists, ratemat, dtype)
    p0 = jnp.full((X, R), cfg.evengen, dtype=dtype)
    f0 = jnp.zeros((NS, R), dtype=dtype)
    return fb_scan_v2_block(e, lam_pad, p0, f0, jnp.ones((X, R), dtype=dtype),
                            f0, cfg)


# ---------------------------------------------------------------------------
# Marker-blocked (checkpointed) forward-backward: O(block) device memory
# for arbitrarily long chromosomes.  Phase A/B carry-only sweeps store
# only block-boundary carries; phase C recomputes each block's sweep
# tensors from its boundaries (the lax.scan analogue of the reference's
# fillortake binary-tree block cache, cnF2freq.cpp:1675-1776, and the
# linear-memory fb literature in PAPERS.md).
# ---------------------------------------------------------------------------
def _wht_matrix(cfg, dtype):
    return jnp.asarray(hadamard(int(cfg.numtypes).bit_length() - 1,
                                str(dtype)))


def fb_carry_fwd(e: jnp.ndarray, lam_pad: jnp.ndarray, p0, f0,
                 cfg: ModelConfig):
    """Carry-only forward over one block: e [K, X, R], lam_pad [K, S]
    (row j = interval leaving marker j; last row crosses the block
    boundary, identity for the final block).  Returns the pre-emission
    carry entering the next block."""
    S, NS = cfg.numtypes, cfg.numshifts
    H = _wht_matrix(cfg, e.dtype)

    def step(carry, xs):
        p, logf = carry
        ei, w = xs
        pn, logf = _emit_norm_v2(p, ei, logf, NS, S)
        return (_transition_v2(pn, w, H, NS, S), logf), None

    (p, f), _ = jax.lax.scan(step, (p0, f0), (e, lam_pad), unroll=8)
    return p, f


def fb_carry_bwd(e: jnp.ndarray, lam_pad: jnp.ndarray, lam_below,
                 bT, bfT, cfg: ModelConfig):
    """Carry-only backward over one block: from the carry at the block's
    last marker (bT = bw[last], bfT) consume markers K-1..0; the final
    step's transition crosses the boundary below via lam_below [S]
    (unused output for block 0).  Returns bw at the previous block's
    last marker."""
    S, NS = cfg.numtypes, cfg.numshifts
    H = _wht_matrix(cfg, e.dtype)
    lam_rows = jnp.concatenate([lam_below[None], lam_pad[:-1]], axis=0)

    def step(carry, xs):
        p, logf = carry
        ei, w = xs
        pn, logf = _emit_norm_v2(p, ei, logf, NS, S)
        return (_transition_v2(pn, w, H, NS, S), logf), None

    (p, f), _ = jax.lax.scan(step, (bT, bfT), (e, lam_rows), unroll=8,
                             reverse=True)
    return p, f


def fb_scan_v2_block(e: jnp.ndarray, lam_pad: jnp.ndarray, p0, f0, bT,
                     bfT, cfg: ModelConfig) -> FBv2:
    """Full sweep tensors for one block from its boundary carries —
    exactly the slice [iK:(i+1)K] of the whole-chromosome fb_scan_v2
    (pinned by tests/test_blocked.py)."""
    K, X, R = e.shape
    S, NS = cfg.numtypes, cfg.numshifts
    H = _wht_matrix(cfg, e.dtype)

    def fwd_step(carry, xs):
        p, logf = carry
        ei, w = xs
        pre, pre_f = p, logf
        pn, logf = _emit_norm_v2(p, ei, logf, NS, S)
        return (_transition_v2(pn, w, H, NS, S), logf), (pre, pre_f, pn,
                                                         logf)

    _, (fw_pre, fw_pre_f, fw_post, fw_post_f) = jax.lax.scan(
        fwd_step, (p0, f0), (e, lam_pad), unroll=8)

    def bwd_step(carry, xs):
        p, logf = carry
        ei, w = xs
        pn, logf = _emit_norm_v2(p, ei, logf, NS, S)
        pprev = _transition_v2(pn, w, H, NS, S)
        return (pprev, logf), (pprev, logf)

    _, (bw_rest, bw_rest_f) = jax.lax.scan(
        bwd_step, (bT, bfT), (e[1:], lam_pad[:-1]), unroll=8,
        reverse=True)
    bw = jnp.concatenate([bw_rest, bT[None]], axis=0)
    bw_f = jnp.concatenate([bw_rest_f, bfT[None]], axis=0)
    return FBv2(fw_pre=fw_pre, fw_post=fw_post, bw=bw, fw_pre_f=fw_pre_f,
                fw_post_f=fw_post_f, bw_f=bw_f)


def make_blocked_pieces(cfg: ModelConfig, params: RuntimeParams, dtype,
                        num_individuals: int, probe_rules: bool = False,
                        n_variants: int = 1):
    """Jitted building blocks for the marker-blocked scan, shared across
    blocks/chunks/iterations (one compile per block shape).  The sweep
    stage takes the dispatch table's implementation."""
    from ..hmm.probes import haplo_update_mask
    from ..parallel.collective import merge_haplos, merge_infprobs

    plan = dispatch.scan_plan(dtype)
    prep = jax.jit(lambda f: prep_slots(f, dtype))
    emis = jax.jit(lambda st: emissions_v2(st, cfg, dtype))
    lamfn = jax.jit(lambda d, rm: transition_eigenvalues(
        cfg, interval_recomb(cfg, params, d, ratemat=rm)).astype(dtype))
    carry_f = jax.jit(lambda e, lp, p, f: fb_carry_fwd(e, lp, p, f, cfg))
    carry_b = jax.jit(lambda e, lp, lb, p, f:
                      fb_carry_bwd(e, lp, lb, p, f, cfg))
    if plan.fb == "triton":
        blockfb = jax.jit(lambda e, lp, p0, f0, bT, bfT: fb_sweeps_v2_triton(
            e, None, cfg, params, lam_pad=lp, init_fwd=(p0, f0),
            init_bwd=(bT, bfT)))
    else:
        blockfb = jax.jit(lambda e, lp, p0, f0, bT, bfT:
                          fb_scan_v2_block(e, lp, p0, f0, bT, bfT, cfg))
    total_fn = jax.jit(loglik_from_factors)

    @functools.partial(jax.jit, static_argnames=("K", "B"))
    def block_stats(st, fb2, total_r, lut, fb_blk, K: int, B: int):
        b12, accum, pair = stats_from_v2(st, fb2, total_r, K, B, cfg,
                                         dtype, probe_rules=probe_rules,
                                         n_variants=n_variants)
        hmask = haplo_update_mask(fb_blk, cfg)
        hb, hc = merge_haplos(b12, hmask, fb_blk.hw, fb_blk.slot_ind,
                              fb_blk.descendants, lut, num_individuals)
        inf = merge_infprobs(accum, fb_blk.slot_ind, fb_blk.descendants,
                             lut, num_individuals,
                             emptyslot=fb_blk.emptyslot if probe_rules
                             else None)
        return pair, hb, hc, inf

    return dict(prep=prep, emissions=emis, lam=lamfn, carry_f=carry_f,
                carry_b=carry_b, blockfb=blockfb, total=total_fn,
                block_stats=block_stats,
                turn=jax.jit(lambda fb2, sh, desc, B: turn_weights_v2(
                    fb2, sh, desc, cfg, B), static_argnames=("B",)))


def blocked_slice(fb_np, i: int, block: int):
    """Host FamilyBatch restricted to block i's markers."""
    import dataclasses
    sl = slice(i * block, (i + 1) * block)
    relh = fb_np.relh
    if relh is not None:
        relh = relh[:, sl]
    return dataclasses.replace(fb_np, md=fb_np.md[:, :, sl],
                               ms=fb_np.ms[:, :, sl],
                               hw=fb_np.hw[:, :, sl], relh=relh)


def _blk_inputs(fb_np, i, block, cfg, dt, pieces):
    fb_blk = blocked_slice(fb_np, i, block).map(jnp.asarray)
    st = pieces["prep"](fb_blk)
    return fb_blk, st, pieces["emissions"](st)


def blocked_carries(fb_np, dists, ratemat, cfg: ModelConfig, block: int,
                    pieces):
    """Phases A/B of the marker-blocked scan for one batch chunk:
    carry-only forward and backward sweeps storing only block-boundary
    carries (O(M/block) of them).  Returns
    (total_np [B], total_r [R] device, lam_pad [M, S] device,
    fbound, bbound)."""
    B, _, M, _ = fb_np.md.shape
    assert M % block == 0, (M, block)
    nblk = M // block
    S, NS = cfg.numtypes, cfg.numshifts

    lam = pieces["lam"](jnp.asarray(dists), None if ratemat is None
                        else jnp.asarray(ratemat))          # [M-1, S]
    dt = lam.dtype
    lam_pad = jnp.concatenate([lam, jnp.ones((1, S), dtype=dt)], 0)

    R = dispatch.pad_lanes(B)
    p = jnp.full((NS * S, R), cfg.evengen, dtype=dt)
    f = jnp.zeros((NS, R), dtype=dt)
    fbound = []
    for i in range(nblk):
        fbound.append((p, f))
        _, _, e = _blk_inputs(fb_np, i, block, cfg, dt, pieces)
        p, f = pieces["carry_f"](e, lam_pad[i * block:(i + 1) * block],
                                 p, f)

    st0 = pieces["prep"](blocked_slice(fb_np, 0, block).map(jnp.asarray))
    total_r = pieces["total"](f, st0.sh)

    bT = jnp.ones((NS * S, R), dtype=dt)
    bfT = jnp.zeros((NS, R), dtype=dt)
    bbound = [None] * nblk
    for i in range(nblk - 1, -1, -1):
        bbound[i] = (bT, bfT)
        below = lam_pad[i * block - 1] if i > 0 else \
            jnp.ones(S, dtype=dt)
        _, _, e = _blk_inputs(fb_np, i, block, cfg, dt, pieces)
        bT, bfT = pieces["carry_b"](e, lam_pad[i * block:(i + 1) * block],
                                    below, *bbound[i])
    return np.asarray(total_r)[:B], total_r, lam_pad, fbound, bbound


def blocked_block_pass(fb_np, i: int, block: int, lam_pad, fbound_i,
                       bbound_i, total_r, lut, cfg: ModelConfig, pieces,
                       with_turn: bool = True):
    """Phase C for one (batch chunk, marker block): recompute the
    block's sweep tensors from its boundary carries and run the fused
    statistics (+ turn weights).  Returns
    (fb_blk, st, fb2, pair_i, hb_i, hc_i, inf_i, w-or-None) — pair/hb/
    hc/inf as device arrays for the block's marker span."""
    B = fb_np.md.shape[0]
    dt = lam_pad.dtype
    fb_blk, st, e = _blk_inputs(fb_np, i, block, cfg, dt, pieces)
    fb2 = pieces["blockfb"](e, lam_pad[i * block:(i + 1) * block],
                            *fbound_i, *bbound_i)
    pair_i, hb_i, hc_i, inf_i = pieces["block_stats"](
        st, fb2, total_r, lut, fb_blk, K=block, B=B)
    w = None
    if with_turn:
        w = pieces["turn"](fb2, st.sh, fb_blk.descendants.astype(dt), B=B)
    return fb_blk, st, fb2, pair_i, hb_i, hc_i, inf_i, w


def blocked_scan_chunk(fb_np, dists, ratemat, lut, cfg: ModelConfig,
                       params: RuntimeParams, block: int, pieces,
                       turn_consumer=None):
    """O(block)-device-memory scan + merge over one batch chunk.

    fb_np: host FamilyBatch (marker axis a multiple of ``block``);
    pieces: make_blocked_pieces output.  Three passes per chromosome
    (blocked_carries + per-block blocked_block_pass);
    turn_consumer(offset, w_dev) is called per block so turn weights
    never accumulate across blocks.  Returns
    (total [B], pair [B, M, 2, 2] np, hb, hc [NI, M] np,
    inf [NI, M, 2, 2] np)."""
    B, _, M, _ = fb_np.md.shape
    nblk = M // block
    total_np, total_r, lam_pad, fbound, bbound = blocked_carries(
        fb_np, dists, ratemat, cfg, block, pieces)

    pair = np.zeros((B, M, 2, 2))
    hb = hc = inf = None
    for i in range(nblk):
        _, _, _, pair_i, hb_i, hc_i, inf_i, w = blocked_block_pass(
            fb_np, i, block, lam_pad, fbound[i], bbound[i], total_r, lut,
            cfg, pieces, with_turn=turn_consumer is not None)
        sl = slice(i * block, (i + 1) * block)
        pair[:, sl] = np.asarray(pair_i)
        if hb is None:
            NI = hb_i.shape[0]
            hb = np.zeros((NI, M))
            hc = np.zeros((NI, M))
            inf = np.zeros((NI, M, 2, 2))
        hb[:, sl] = np.asarray(hb_i)
        hc[:, sl] = np.asarray(hc_i)
        inf[:, sl] = np.asarray(inf_i)
        if turn_consumer is not None:
            # consumer sees the block's turn weights plus the full
            # in-progress accumulators (filled through this block):
            # enough for exact relskew clause adjustment of the
            # PREVIOUS block including its right-boundary halo column
            turn_consumer(i * block, w, hb, hc)
    return total_np, pair, hb, hc, inf


def loglik_from_factors(f: jnp.ndarray, sh: jnp.ndarray) -> jnp.ndarray:
    """total [R] from final post-emission factors f [NS, R]."""
    NS, R = f.shape
    allowed = (jnp.arange(NS)[:, None] & sh.reshape(1, R)) == 0
    f = jnp.where(allowed, f, MINFACTOR)
    fmax = f.max(axis=0)
    return fmax + jnp.log(jnp.sum(jnp.where(allowed,
                                            jnp.exp(f - fmax[None]), 0.0),
                                  axis=0))


def combined_loglik_v2(fb2: FBv2, sh: jnp.ndarray) -> jnp.ndarray:
    """total [R] from fw_post_f [M, NS, R]; sh [R] shiftignore."""
    return loglik_from_factors(fb2.fw_post_f[-1], sh)


def _turn_offsets(cfg: ModelConfig) -> np.ndarray:
    """Joint index (shift-major, x = s*S + g) of each turn's WHT offset."""
    S = cfg.numtypes
    return np.array([cfg.turn_shift_flip(t) * S + (t & cfg.turn_state_mask)
                     for t in range(cfg.numturns)])


def _turn_finish(vals, B, descendants, total_desc_scale):
    """[M, T, R] correlation values -> [B, M, T] clause weights."""
    dtype = vals.dtype
    tiny = jnp.asarray(np.finfo(str(dtype)).tiny, dtype=dtype)
    logv = jnp.log(jnp.maximum(vals, tiny))
    ok = vals > 0
    w = jnp.where(ok & ok[:, 0:1], logv - logv[:, 0:1], MINFACTOR)
    w = jnp.transpose(w[:, :, :B], (2, 0, 1))               # [B, M, T]
    if total_desc_scale:
        w = w * descendants[:, None, None]
    return w


def turn_weights_v2(fb2: FBv2, sh: jnp.ndarray, descendants: jnp.ndarray,
                    cfg: ModelConfig, B: int,
                    total_desc_scale: bool = True) -> jnp.ndarray:
    """[B, M, T] clause weights (turn_weights_fast on v2 layout).

    The joint index in the [M, X, R] layout is already shift-major
    (x = s*S + g), matching the WHT offset flip(t)*S + state_mask(t)."""
    M, X, R = fb2.fw_post.shape
    S, NS = cfg.numtypes, cfg.numshifts
    dtype = fb2.fw_post.dtype
    allowed = ((jnp.arange(NS)[:, None] & sh.reshape(1, R)) == 0)

    ff = jnp.where(allowed[None], fb2.fw_post_f, -jnp.inf)
    ffm = ff.max(axis=1)                                    # [M, R]
    fexp = jnp.where(allowed[None], jnp.exp(ff - ffm[:, None]), 0.0)
    bf = fb2.bw_f
    bfm = bf.max(axis=1)
    bexp = jnp.exp(bf - bfm[:, None])

    fwp = (fb2.fw_post.reshape(M, NS, S, R) * fexp[:, :, None]).reshape(
        M, X, R)
    bwp = (fb2.bw.reshape(M, NS, S, R) * bexp[:, :, None]).reshape(M, X, R)

    # factored 512-point WHT: H_X = H_NS (x) H_S, applied as one [S, S]
    # and one [NS, NS] contraction
    Hs = jnp.asarray(hadamard(int(S).bit_length() - 1, str(dtype)))
    Hn = jnp.asarray(hadamard(int(NS).bit_length() - 1, str(dtype)))

    def wht_x(x):
        x = x.reshape(M, NS, S, R)
        x = jnp.einsum("nt,mtgr->mngr", Hn, x, precision=_HIGHEST)
        x = jnp.einsum("gh,mnhr->mngr", Hs, x, precision=_HIGHEST)
        return x.reshape(M, X, R)

    fh = wht_x(fwp)
    bh = wht_x(bwp)
    D = wht_x(fh * bh) / X                                  # [M, X, R]
    vals = D[:, _turn_offsets(cfg)]                         # [M, T, R]
    return _turn_finish(vals, B, descendants, total_desc_scale)


# ---------------------------------------------------------------------------
# The sweeps as a Pallas kernel through Triton.  Each program owns one
# shift block of LANE_BLOCK consecutive units; the arithmetic matches
# fb_scan_v2 (tests/test_scan_v2.py runs both in interpret mode).  It is
# a float32 kernel on the GPU; the interpreter runs it in any dtype.
# ---------------------------------------------------------------------------
# Warps per program: with 32-unit lane blocks the fastest of the tiles
# measured on an H100 (PERF.md); other tiles ran up to 14x slower.
_FB_WARPS = 4


def _emit_norm_block(p, e, f):
    """adjustprobs on one shift block: p, e [S, L]; f [L]."""
    p = jnp.where(p < jnp.asarray(1e-300, p.dtype), 0.0, p)
    pe = p * e
    s = jnp.sum(pe, axis=0)
    ok = s > 0
    sden = jnp.where(ok, s, 1.0)
    pn = jnp.where(ok[None, :], pe / sden[None, :], 0.0)
    f = jnp.where(ok, f + jnp.log(sden), MINFACTOR)
    return pn, f


def _fb_fwd_kernel(e_ref, tm_ref, p0_ref, f0_ref, pre_ref, pref_ref,
                   post_ref, postf_ref):
    def step(m, carry):
        p, f = carry
        pre_ref[m] = p
        pref_ref[m] = f
        pn, f = _emit_norm_block(p, e_ref[m], f)
        post_ref[m] = pn
        postf_ref[m] = f
        return jnp.dot(tm_ref[m], pn, precision=_HIGHEST), f

    jax.lax.fori_loop(0, e_ref.shape[0], step, (p0_ref[...], f0_ref[...]))


def _fb_bwd_kernel(e_ref, tm_ref, bT_ref, bfT_ref, bw_ref, bwf_ref):
    M = e_ref.shape[0]

    def step(i, carry):
        p, f = carry
        m = M - 1 - i
        bw_ref[m] = p
        bwf_ref[m] = f
        pn, f = _emit_norm_block(p, e_ref[m], f)
        return jnp.dot(tm_ref[m - 1], pn, precision=_HIGHEST), f

    p, f = jax.lax.fori_loop(0, M - 1, step, (bT_ref[...], bfT_ref[...]))
    bw_ref[0] = p
    bwf_ref[0] = f


def transition_operators(lam_pad: jnp.ndarray, S: int) -> jnp.ndarray:
    """[M, S, S] dense per-interval transition H diag(lam) H / S (one
    [S, S] x [S, lanes] product per marker step in the sweep kernel)."""
    H = jnp.asarray(hadamard(int(S).bit_length() - 1, str(lam_pad.dtype)))
    return jnp.einsum("gk,mk,kh->mgh", H, lam_pad, H,
                      precision=_HIGHEST) / S


def fb_sweeps_v2_triton(e: jnp.ndarray, dists: jnp.ndarray,
                        cfg: ModelConfig, params: RuntimeParams,
                        ratemat=None, interpret: bool = False,
                        lam_pad=None, init_fwd=None,
                        init_bwd=None) -> FBv2:
    """fb_scan_v2 as two Pallas sweeps through Triton.  e: [M, X, R].

    The grid is (shift block, lane block): every (shift, unit) chain is
    independent, because the emission normalisation and the transition
    both act within one shift block of S states.  Each program keeps its
    [S, lanes] carry in registers and loops over the markers; only the
    stored sweep tensors touch device memory.

    Boundary carries (the kernel form of fb_scan_v2_block): ``lam_pad``
    [M, S] gives the eigenvalue rows directly, ``init_fwd=(p0 [X, R],
    f0 [NS, R])`` seeds the forward carry and ``init_bwd=(bT, bfT)`` the
    backward carry at the last marker; the defaults reproduce the whole
    chromosome (evengen prior, all-ones backward)."""
    M, X, R = e.shape
    S, NS = cfg.numtypes, cfg.numshifts
    dtype = e.dtype
    if lam_pad is None:
        lam_pad = _lam_pad(cfg, params, dists, ratemat, dtype)
    tm = transition_operators(lam_pad.astype(dtype), S)
    if init_fwd is None:
        init_fwd = (jnp.full((X, R), cfg.evengen, dtype=dtype),
                    jnp.zeros((NS, R), dtype=dtype))
    if init_bwd is None:
        init_bwd = (jnp.ones((X, R), dtype=dtype),
                    jnp.zeros((NS, R), dtype=dtype))
    lanes = dispatch.LANE_BLOCK
    assert R % lanes == 0, (R, lanes)

    sweep = pl.BlockSpec((M, S, lanes), lambda n, b: (0, n, b))
    factors = pl.BlockSpec((M, None, lanes), lambda n, b: (0, n, b))
    ops = pl.BlockSpec((M, S, S), lambda n, b: (0, 0, 0))
    carry = pl.BlockSpec((S, lanes), lambda n, b: (n, b))
    carry_f = pl.BlockSpec((None, lanes), lambda n, b: (n, b))
    shape_x = jax.ShapeDtypeStruct((M, X, R), dtype)
    shape_f = jax.ShapeDtypeStruct((M, NS, R), dtype)
    call = functools.partial(
        pl.pallas_call, grid=(NS, R // lanes), backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_FB_WARPS,
                                                num_stages=2),
        interpret=interpret)

    fw_pre, fw_pre_f, fw_post, fw_post_f = call(
        _fb_fwd_kernel, name="fb_fwd_v2",
        in_specs=[sweep, ops, carry, carry_f],
        out_specs=(sweep, factors, sweep, factors),
        out_shape=(shape_x, shape_f, shape_x, shape_f),
    )(e, tm, *init_fwd)
    bw, bw_f = call(
        _fb_bwd_kernel, name="fb_bwd_v2",
        in_specs=[sweep, ops, carry, carry_f],
        out_specs=(sweep, factors),
        out_shape=(shape_x, shape_f),
    )(e, tm, *init_bwd)
    return FBv2(fw_pre=fw_pre, fw_post=fw_post, bw=bw, fw_pre_f=fw_pre_f,
                fw_post_f=fw_post_f, bw_f=bw_f)


def fb_sweeps(plan: dispatch.ScanPlan):
    """The sweep implementation ``plan`` names (fb_scan_v2's signature)."""
    return fb_sweeps_v2_triton if plan.fb == "triton" else fb_scan_v2


# ---------------------------------------------------------------------------
# Posterior update statistics on v2 tensors (XLA form)
# ---------------------------------------------------------------------------
@functools.partial(jax.jit, static_argnames=("M", "B", "cfg", "dtype",
                                             "probe_rules", "n_variants"))
def stats_from_v2(st: SlotTensors, fb2: FBv2, total: jnp.ndarray,
                  M: int, B: int, cfg: ModelConfig, dtype,
                  probe_rules: bool = False, n_variants: int = 1):
    """(b12 [B,M,7,2], accum [B,M,7,2,2], pair [B,M,2,2]):
    ops.enum_stats.stats_tile on the whole [M, R] data plane, the
    sweep tensors relabelled to its flag-major enum order.
    probe_rules/n_variants: the ignoreflag2 rule 2-3 probe-dedup factors
    (cnF2freq.cpp:3462-3496), averaged over the duplicate-member sign
    variants (hmm.probes.probe_rule_factors)."""
    R = st.R
    # feature index is shift-major (ns*64 + g); stats_tile wants
    # [fp1, fp0, s2, s1, s0, M, R]
    def sweep(x):
        return jnp.transpose(x.reshape(M, 2, 2, 2, 8, 8, R),
                             (4, 5, 1, 2, 3, 0, 6))

    def factors(x):
        return jnp.transpose(x.reshape(M, 2, 2, 2, R), (1, 2, 3, 0, 4))

    outs = []
    for v in range(n_variants if probe_rules else 1):
        outs.append(sp.stats_tile(
            st.md, st.ms, st.hw, _unit_row(st.ex) != 0,
            _unit_row(st.at) != 0, _unit_row(st.f2), _unit_row(st.sh),
            sweep(fb2.fw_pre), sweep(fb2.bw), factors(fb2.fw_pre_f),
            factors(fb2.bw_f), _unit_row(total), cfg,
            empty=_unit_row(st.em) if probe_rules else None,
            dupf=_unit_row(st.df[v]) if probe_rules else None))
    nv = len(outs)
    b12, acc, pair = (sum(parts) / nv for parts in zip(*outs))

    def back(x):        # [*enum, M, R] -> [B, M, *enum]
        nl = x.ndim - 2
        return jnp.transpose(x[..., :B], (nl + 1, nl) + tuple(range(nl)))

    return back(b12), back(acc), back(pair)


# ---------------------------------------------------------------------------
# Full per-iteration scan in v2 layout
# ---------------------------------------------------------------------------
def chromosome_scan_v2(fb: FamilyBatch, dists: jnp.ndarray,
                       cfg: ModelConfig, params: RuntimeParams,
                       ratemat=None, probe_rules: bool = False,
                       n_variants: int = 1, with_coherence: bool = False,
                       plan=None):
    """engine.chromosome_scan on the feature-leading pipeline.

    ``plan`` (ops.dispatch.ScanPlan) names the sweep implementation; by
    default the dispatch table's choice for the backend.  Returns an
    engine.ScanResult; the fw/bw sweep tensors are converted back to the
    standard [B, M, NS, S] layout for the follow-up passes (coherence,
    map re-estimation) — when a caller's jit doesn't use them, XLA
    dead-code-eliminates the transposes."""
    from ..engine import ScanResult
    from ..hmm.emission import build_blocks
    from ..hmm.forward_backward import FBResult
    from ..hmm.probes import haplo_update_mask, phase_coherence

    dtype = fb.ms.dtype
    if plan is None:
        plan = dispatch.scan_plan(dtype)
    B, _, M, _ = fb.md.shape
    S, NS = cfg.numtypes, cfg.numshifts
    st = prep_slots(fb, dtype)
    e = emissions_v2(st, cfg, dtype)
    fb2 = fb_sweeps(plan)(e, dists, cfg, params, ratemat=ratemat)
    total_r = combined_loglik_v2(fb2, st.sh)
    b12, accum, pair = stats_from_v2(st, fb2, total_r, M, B, cfg, dtype,
                                     probe_rules=probe_rules,
                                     n_variants=n_variants)
    turn_w = turn_weights_v2(fb2, st.sh, fb.descendants.astype(dtype), cfg,
                             B)
    hmask = haplo_update_mask(fb, cfg)

    def to_std(x):      # [M, X, R] -> [B, M, NS, S]
        return jnp.transpose(x[:, :, :B], (2, 0, 1)).reshape(B, M, NS, S)

    def to_std_f(x):    # [M, NS, R] -> [B, M, NS]
        return jnp.transpose(x[:, :, :B], (2, 0, 1))

    fw_pre, bw = to_std(fb2.fw_pre), to_std(fb2.bw)
    fw_pre_f, bw_f = to_std_f(fb2.fw_pre_f), to_std_f(fb2.bw_f)
    if with_coherence:
        # the pairwise chain reads only the pre-emission forward tensors
        lam = transition_eigenvalues(
            cfg, interval_recomb(cfg, params, dists,
                                 ratemat=ratemat)).astype(dtype)
        fbres = FBResult(fw_pre=fw_pre, fw_post=fw_pre, bw=bw,
                         fw_pre_f=fw_pre_f, fw_post_f=fw_pre_f, bw_f=bw_f)
        coh = phase_coherence(fbres, build_blocks(fb, cfg, dtype=dtype), fb,
                              cfg, lam)
    else:
        coh = jnp.full((B, M, cfg.numslots), 0.5, dtype=dtype)
    return ScanResult(total=total_r[:B], haplo_b12=b12, haplo_mask=hmask,
                      inf_accum=accum, pair=pair, turn_weight=turn_w,
                      coherence=coh, fw_pre=fw_pre, bw=bw,
                      fw_pre_f=fw_pre_f, bw_f=bw_f)
