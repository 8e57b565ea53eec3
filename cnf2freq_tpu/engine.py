"""Fused device engine: one chromosome scan as a single jittable function.

Everything the reference computes per (chromosome, iteration) with its
OpenMP probe loops — total likelihoods, haplotype/genotype update
statistics, turn scores, genotype-pair posteriors — as one XLA program
over [B, M, ...] tensors.  This is the unit that gets jit-compiled,
sharded over a device mesh, and benchmarked.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .config import ModelConfig, RuntimeParams
from .hmm.emission import assemble_e_all, build_blocks
from .hmm.family import FamilyBatch
from .hmm.forward_backward import combined_loglik, forward_backward
from .hmm.probes import (haplo_stats, infprob_stats, phase_coherence,
                         posterior_weight, turn_weights_fast)
from .hmm.transition import interval_recomb, transition_eigenvalues
from .ops.dispatch import ScanPlan, full_f32, scan_plan


class ScanResult(NamedTuple):
    total: jnp.ndarray        # [B] combined log-likelihoods
    haplo_b12: jnp.ndarray    # [B, M, 7, 2]
    haplo_mask: jnp.ndarray   # [B, M, 7] bool
    inf_accum: jnp.ndarray    # [B, M, 7, 2, 2]
    pair: jnp.ndarray         # [B, M, 2, 2]
    turn_weight: jnp.ndarray  # [B, M, T]
    coherence: jnp.ndarray    # [B, M, 7] adjacent-phase coherence
    fw_pre: jnp.ndarray       # [B, M, S, NS] (for follow-up passes)
    bw: jnp.ndarray
    fw_pre_f: jnp.ndarray     # [B, M, NS]
    bw_f: jnp.ndarray


@full_f32
def chromosome_scan(fb: FamilyBatch, dists: jnp.ndarray, cfg: ModelConfig,
                    params: RuntimeParams, with_infprobs: bool = True,
                    with_coherence: bool = False, ratemat=None,
                    n_variants: int = 1, probe_rules: bool = False,
                    plan: ScanPlan = None) -> ScanResult:
    """One chromosome scan.  ``plan`` overrides the dispatch table's
    choice of layout and kernels (ops/dispatch.py)."""
    if cfg.selfing or cfg.relskewstates:
        # extended state spaces run the dedicated (V, state)-factored
        # pipeline; probe-dedup rules don't apply there (the reference
        # disables ignoreflag2 rules 2-3 for the extended builds,
        # cnF2freq.cpp:3480-3487)
        if probe_rules:
            raise NotImplementedError(
                "probe dedup rules are standard-space only")
        from .engine_ext import chromosome_scan_ext
        return chromosome_scan_ext(fb, dists, cfg, params,
                                   with_infprobs=with_infprobs,
                                   ratemat=ratemat,
                                   n_variants=n_variants,
                                   with_coherence=with_coherence)
    if cfg.numgen == 2:
        if not cfg.haplotyping:
            # no-haplotyping family: 4 states, deep 7-slot walk
            # (engine_nohaplo.py; settings.h:60-73)
            from .engine_nohaplo import chromosome_scan_nohaplo
            return chromosome_scan_nohaplo(fb, dists, cfg, params,
                                           with_infprobs=with_infprobs,
                                           ratemat=ratemat)
        # dedicated 4-state engine (QTLMAS15-shape small models)
        from .engine_ng2 import chromosome_scan_ng2
        return chromosome_scan_ng2(fb, dists, cfg, params,
                                   with_infprobs=with_infprobs,
                                   ratemat=ratemat,
                                   with_coherence=with_coherence)
    if plan is None:
        plan = scan_plan(fb.ms.dtype)
    if plan.layout == "v2" and with_infprobs and cfg.numslots == 7 \
            and cfg.numtypes == 64 and cfg.numshifts == 8:
        # feature-leading layout pipeline (ops/scan_v2.py)
        from .ops.scan_v2 import chromosome_scan_v2
        return chromosome_scan_v2(fb, dists, cfg, params, ratemat=ratemat,
                                  probe_rules=probe_rules,
                                  n_variants=n_variants,
                                  with_coherence=with_coherence, plan=plan)
    blocks = build_blocks(fb, cfg, dtype=fb.ms.dtype)
    e = assemble_e_all(blocks, cfg)
    fbres = forward_backward(e, dists, cfg, params, ratemat=ratemat)
    total = combined_loglik(fbres, fb.shiftignore)
    B, M = fb.md.shape[0], fb.md.shape[2]
    W = posterior_weight(fbres, total, fb.shiftignore)
    # collapse each parent branch against the posterior once per probe
    # dedup variant; shared by the haplo and infprob contractions.
    # Variants implement ignoreflag2's duplicate-member rule (probes.
    # probe_rule_factors): their average is the exact constrained sum.
    from .hmm.probes import (_valid_paths, _w_bits, probe_rule_factors,
                             side_collapse)
    V = [_valid_paths(fb.flag2ignore, k).astype(W.dtype) for k in range(2)]
    PBm = [blocks.pb[k] * V[k][:, None, None, None, :, None]
           for k in range(2)]
    Wr = _w_bits(W, cfg)
    b12s, infs, pairs = [], [], []
    hmask = None
    for v in range(n_variants if probe_rules else 1):
        if probe_rules:
            F0, FPs = probe_rule_factors(fb, cfg, e.dtype, v)
            frootv = blocks.froot * F0
            PBv = [PBm[k] * FPs[k] for k in range(2)]
        else:
            frootv, PBv = blocks.froot, PBm
        t01 = side_collapse(PBv, Wr)
        hs = haplo_stats(W, blocks, fb, cfg, t01=t01, froot=frootv, PB=PBv)
        hmask = hs.mask
        b12s.append(hs.b12)
        if with_infprobs:
            ist = infprob_stats(W, blocks, fb, cfg, t01=t01, froot=frootv,
                                PB=PBv)
            infs.append(ist.accum)
            pairs.append(ist.pair)
    nv = len(b12s)
    hs = hs._replace(b12=sum(b12s) / nv)
    if with_infprobs:
        inf_accum, pair = sum(infs) / nv, sum(pairs) / nv
    else:
        inf_accum = jnp.zeros((B, M, cfg.numslots, 2, 2), dtype=e.dtype)
        pair = jnp.zeros((B, M, 2, 2), dtype=e.dtype)
    turn_w = turn_weights_fast(fbres, fb, cfg)
    if with_coherence:
        lam = transition_eigenvalues(
            cfg, interval_recomb(cfg, params, dists,
                                 ratemat=ratemat)).astype(e.dtype)
        coh = phase_coherence(fbres, blocks, fb, cfg, lam)
    else:
        coh = jnp.full((B, M, cfg.numslots), 0.5, dtype=e.dtype)
    return ScanResult(total=total, haplo_b12=hs.b12, haplo_mask=hs.mask,
                      inf_accum=inf_accum, pair=pair,
                      turn_weight=turn_w, coherence=coh,
                      fw_pre=fbres.fw_pre, bw=fbres.bw,
                      fw_pre_f=fbres.fw_pre_f, bw_f=fbres.bw_f)


def make_jitted_scan(cfg: ModelConfig, params: RuntimeParams,
                     with_infprobs: bool = True, n_variants: int = 1,
                     probe_rules: bool = False):
    @jax.jit
    def run(fb: FamilyBatch, dists):
        return chromosome_scan(fb, dists, cfg, params, with_infprobs,
                               n_variants=n_variants,
                               probe_rules=probe_rules)

    return run


def make_jitted_scan_merged(cfg: ModelConfig, params: RuntimeParams,
                            num_individuals: int, n_variants: int = 1,
                            probe_rules: bool = False,
                            with_coherence: bool = False):
    """Scan + on-device accumulator merge: the per-family statistics are
    segment-summed onto per-individual accumulator rows before leaving
    the device, so [NI, M]-shaped merged tensors cross the host link
    instead of [B, M, slots, ...] per-family ones (7-25x less transfer;
    the merge itself replaces the host scatter loops)."""
    if cfg.numgen == 2:
        if not cfg.haplotyping:
            from .engine_nohaplo import make_jitted_scan_merged_nohaplo
            return make_jitted_scan_merged_nohaplo(cfg, params,
                                                   num_individuals)
        # two compiled programs: the combined graph's XLA fusion search
        # is pathologically slow (engine_ng2.make_jitted_scan_merged_ng2)
        from .engine_ng2 import make_jitted_scan_merged_ng2
        return make_jitted_scan_merged_ng2(cfg, params, num_individuals)
    from .parallel.collective import merge_haplos, merge_infprobs

    @jax.jit
    def run(fb: FamilyBatch, dists, lut, ratemat):
        res = chromosome_scan(fb, dists, cfg, params, ratemat=ratemat,
                              n_variants=n_variants,
                              probe_rules=probe_rules,
                              with_coherence=with_coherence)
        hb, hc = merge_haplos(res.haplo_b12, res.haplo_mask, fb.hw,
                              fb.slot_ind, fb.descendants, lut,
                              num_individuals)
        # duplicate-slot damping counts non-empty occurrences only
        # (reltreeordered, cnF2freq.cpp:3127-3152); relevant whenever the
        # dedup rules run — parity mode and the extended state spaces
        empty = fb.emptyslot if (probe_rules or cfg.selfing or
                                 cfg.relskewstates) else None
        inf = merge_infprobs(res.inf_accum, fb.slot_ind, fb.descendants,
                             lut, num_individuals, emptyslot=empty)
        return res, hb, hc, inf

    return run


def make_jitted_coherence(cfg: ModelConfig, params: RuntimeParams):
    """Per-slot adjacent-phase coherence as its own pass: bounded peak
    memory at large B*M (one slot's chain live at a time)."""
    from functools import partial

    from .hmm.emission import build_blocks
    from .hmm.forward_backward import FBResult
    from .hmm.probes import phase_coherence_slot

    @partial(jax.jit, static_argnames=("slot",))
    def run(fb: FamilyBatch, dists, fw_pre, bw, fw_pre_f, bw_f, slot: int,
            ratemat=None):
        if cfg.numgen == 2:
            from .engine_ng2 import coherence_slot_ng2
            return coherence_slot_ng2(fb, dists, fw_pre, bw, fw_pre_f,
                                      bw_f, cfg, params, slot,
                                      ratemat=ratemat)
        blocks = build_blocks(fb, cfg, dtype=fb.ms.dtype)
        lam = transition_eigenvalues(
            cfg, interval_recomb(cfg, params, dists,
                                 ratemat=ratemat)).astype(fw_pre.dtype)
        fbres = FBResult(fw_pre=fw_pre, fw_post=fw_pre, bw=bw,
                         fw_pre_f=fw_pre_f, fw_post_f=fw_pre_f, bw_f=bw_f)
        return phase_coherence_slot(fbres, blocks, fb, cfg, lam, slot)

    return run


def make_jitted_line_origin(cfg: ModelConfig, params: RuntimeParams):
    """Line-origin class posteriors [B, M, 3] for a chromosome: the
    zeropropagate gstr reporter (probes.line_origin_posterior; the
    deep-walk form engine_nohaplo.nohaplo_line_origin for the
    no-haplotyping family) on a fresh forward-backward."""
    from .hmm.probes import line_origin_posterior, posterior_weight

    if cfg.numgen == 2 and not cfg.haplotyping:
        from .engine_nohaplo import (nohaplo_emission,
                                     nohaplo_line_origin)

        @jax.jit
        def run_nohaplo(fb: FamilyBatch, dists, ratemat):
            dtype = fb.ms.dtype
            e = nohaplo_emission(fb, cfg, ci=cfg.correction_inference,
                                 dtype=dtype)
            fbres = forward_backward(e, dists, cfg, params,
                                     ratemat=ratemat)
            total = combined_loglik(fbres, fb.shiftignore)
            post = posterior_weight(fbres, total, fb.shiftignore) * e
            return nohaplo_line_origin(fb, cfg, post[:, :, 0])

        return run_nohaplo

    @jax.jit
    def run(fb: FamilyBatch, dists, ratemat):
        blocks = build_blocks(fb, cfg, dtype=fb.ms.dtype)
        e = assemble_e_all(blocks, cfg)
        fbres = forward_backward(e, dists, cfg, params, ratemat=ratemat)
        total = combined_loglik(fbres, fb.shiftignore)
        W = posterior_weight(fbres, total, fb.shiftignore)
        return line_origin_posterior(W, blocks, fb, cfg)

    return run


def make_jitted_recomb(cfg: ModelConfig, params: RuntimeParams):
    """Posterior per-interval, per-meiosis-bit recombination expectations
    as their own pass (genetic-map re-estimation)."""
    from .hmm.emission import assemble_e_all, build_blocks
    from .hmm.forward_backward import FBResult
    from .hmm.probes import recombination_expectations

    @jax.jit
    def run(fb: FamilyBatch, dists, fw_pre, bw, fw_pre_f, bw_f,
            ratemat=None):
        blocks = build_blocks(fb, cfg, dtype=fw_pre.dtype)
        e = assemble_e_all(blocks, cfg)
        lam = transition_eigenvalues(
            cfg, interval_recomb(cfg, params, dists,
                                 ratemat=ratemat)).astype(fw_pre.dtype)
        pe = fw_pre * e
        s = pe.sum(axis=-1, keepdims=True)
        fw_post = jnp.where(s > 0, pe / jnp.where(s > 0, s, 1.0), 0.0)
        fw_post_f = fw_pre_f + jnp.log(jnp.maximum(s[..., 0], 1e-300))
        fbres = FBResult(fw_pre=fw_pre, fw_post=fw_post, bw=bw,
                         fw_pre_f=fw_pre_f, fw_post_f=fw_post_f, bw_f=bw_f)
        return recombination_expectations(fbres, e, cfg, lam)

    return run
