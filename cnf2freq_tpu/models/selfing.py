"""Selfed-line model family: the SELFING state-space extension.

The reference's ``SELFING`` build (settings.h:8,14,25-46) adds two state
bits tracking whether the focal individual is homozygous-by-descent (HBD)
after repeated selfing: ``selfval`` 0 = ordinary F2 inheritance state,
1 / 2 = both strands are copies of a single parental strand, carried on
interpretation slot 0 / 1.  The double-bit value 3 is invalid
(``VALIDSELFNUMTYPES``, settings.h:46), so the full space is
``3 * numtypes`` states.

Design: the self axis is a *separate* tensor axis of size 3 — the
base-state transition stays the shared Walsh-Hadamard xor convolution
(transition.py) and the HBD transition is one tiny 3x3 matmul per step,
i.e. a Kronecker-factored transition instead of the reference's dense
``VALIDSELFNUMTYPES**2`` loop (cnF2freq.cpp:2352-2364).  Emissions for the
two HBD states reuse the factored block machinery with the focal's marker
pair replaced by the collapsed HBD pair (``selfmarker``/``selfsure``,
cnF2freq.cpp:1131-1189) via ``root_override``.

Semantics are validated 1:1 against the golden scalar engine with
``selfing=True`` (tests/test_selfing.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MINFACTOR, ModelConfig, RuntimeParams, SEXMARKER, UNKNOWN
from ..hmm.emission import assemble_e_all, build_blocks
from ..hmm.family import FamilyBatch
from ..hmm.transition import (apply_transition_sn as apply_transition,
                              interval_recomb,
                              transition_eigenvalues)


def collapse_focal(md: jnp.ndarray, ms: jnp.ndarray):
    """The HBD-collapsed observed genotype (cnF2freq.cpp:1173-1189).

    md, ms: [B, M, 2] focal marker pair / error probabilities.
    Returns (collapsed [B, M], csure [B, M], dead [B, M]): the single
    allele consistent with homozygosity-by-descent, its error
    probability, and the marker-is-impossible flag (heterozygous with a
    certain first allele)."""
    first, second = md[..., 0], md[..., 1]
    ms0, ms1 = ms[..., 0], ms[..., 1]
    bound = jnp.where(first == UNKNOWN, second, first)
    miss = (first != UNKNOWN) \
        & ~((second == UNKNOWN) & (first != SEXMARKER)) \
        & (first != second)
    collapsed = jnp.where(miss, second, bound)
    csure = jnp.where(miss, 1.0 - ms0 * (1.0 - ms1),
                      1.0 - (1.0 - ms0) * (1.0 - ms1))
    dead = miss & (ms0 == 0)
    return collapsed, csure, dead


def selfing_emission(fb: FamilyBatch, cfg: ModelConfig, ci: bool = False,
                     dtype=jnp.float64) -> jnp.ndarray:
    """E[b, m, selfval(3), S, NS]: per-state emissions for all three HBD
    statuses.  selfval 0 is the ordinary emission; selfval 1/2 swap in the
    collapsed pair on interpretation slot 0/1 (selfindex = (selfval>>1)^f2n,
    cnF2freq.cpp:1131)."""
    assert cfg.selfing
    # assemble_e_all is state-minor [B, M, NS, S]; this sweep keeps the
    # legacy [S, NS] order
    def _sn(e):
        return jnp.moveaxis(e, -1, -2)

    e0 = _sn(assemble_e_all(build_blocks(fb, cfg, ci=ci, dtype=dtype), cfg))

    md, ms = fb.md[:, 0], fb.ms[:, 0]
    collapsed, csure, dead = collapse_focal(md, ms)
    unk = jnp.zeros_like(collapsed)
    zero = jnp.zeros_like(csure)
    # a selfing-collapsed root ALWAYS canonicalises the interpretation
    # (``|| selfingNOW`` in the duplicate-allele collapse branch,
    # cnF2freq.cpp:1235) — pinned against the recompiled SELFING
    # reference binary (tests/test_refparity_ext.py)
    coll_cond = jnp.ones_like(collapsed, dtype=bool)
    alive = (~dead)[:, :, None, None].astype(dtype)

    es = [e0]
    for selfval in (1, 2):
        if selfval == 1:
            ov = (collapsed, csure, unk, zero, coll_cond)
        else:
            ov = (unk, zero, collapsed, csure, coll_cond)
        blocks = build_blocks(fb, cfg, ci=ci, dtype=dtype, root_override=ov)
        es.append(_sn(assemble_e_all(blocks, cfg)) * alive)
    return jnp.stack(es, axis=2)


def selfing_factors(selfgen: jnp.ndarray, dtype=jnp.float64) -> jnp.ndarray:
    """[B, 3] initial HBD-status distribution (selfingfactors,
    cnF2freq.cpp:2050-2063): P(not HBD) halves per selfing generation."""
    f0 = (0.5 ** selfgen).astype(dtype)
    rest = (1.0 - f0) * 0.5
    return jnp.stack([f0, rest, rest], axis=-1)


def selfprec_tensor(selfgen: jnp.ndarray, dists: jnp.ndarray,
                    rate: float, dtype=jnp.float64) -> jnp.ndarray:
    """[B, I, 3, 3] HBD-status transition factors per individual and
    marker interval (selfprec, cnF2freq.cpp:2316-2327); row = from,
    column = to."""
    selfgen = jnp.asarray(selfgen)
    dists = jnp.asarray(dists, dtype=dtype)
    sg = selfgen[:, None].astype(dtype)
    r2 = 0.5 * (1.0 - jnp.exp(sg * rate * dists[None, :]))     # [B, I]
    denom = jnp.maximum(2.0 ** sg - 1.0, 1.0)
    sp10 = jnp.where(sg > 0, r2 * 2.0 / denom, 1.0)
    sp12 = sp10 * r2
    sp11 = 1.0 - sp10 - sp12
    row0 = jnp.stack([1.0 - 2.0 * r2, r2, r2], axis=-1)
    row1 = jnp.stack([sp10, sp11, sp12], axis=-1)
    row2 = jnp.stack([sp10, sp12, sp11], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)              # [B, I, 3, 3]


class SelfingFBResult(NamedTuple):
    fw_pre: jnp.ndarray    # [B, M, 3, S, NS]
    fw_post: jnp.ndarray
    bw: jnp.ndarray
    fw_pre_f: jnp.ndarray  # [B, M, NS]
    fw_post_f: jnp.ndarray
    bw_f: jnp.ndarray

    @property
    def total_loglik(self) -> jnp.ndarray:
        return self.fw_post_f[:, -1, :]


def _emit_normalise_self(p, e, logf):
    """adjustprobs over the (selfval, state) axes jointly
    (cnF2freq.cpp:1579-1670)."""
    p = jnp.where(p < 1e-300, 0.0, p)
    pe = p * e
    s = pe.sum(axis=(-3, -2), keepdims=True)
    ok = s > 0
    pn = jnp.where(ok, pe / jnp.where(ok, s, 1.0), 0.0)
    s0 = s[..., 0, 0, :]
    logf = jnp.where(ok[..., 0, 0, :],
                     logf + jnp.log(jnp.where(ok[..., 0, 0, :], s0, 1.0)),
                     MINFACTOR)
    return pn, logf


def selfing_forward_backward(e_self: jnp.ndarray, dists: jnp.ndarray,
                             selfgen: jnp.ndarray, cfg: ModelConfig,
                             params: RuntimeParams) -> SelfingFBResult:
    """Batched fb sweeps over the extended (selfval, state) space.

    e_self: [B, M, 3, S, NS]; dists: [M-1]; selfgen: [B] selfing
    generations per focal individual (ind.gen - 2)."""
    B, M, _, S, NS = e_self.shape
    dtype = e_self.dtype
    r = interval_recomb(cfg, params, dists)
    lam = transition_eigenvalues(cfg, r).astype(dtype)          # [M-1, S]
    lam_pad = jnp.concatenate([lam, jnp.ones((1, S), dtype=dtype)], axis=0)
    sp = selfprec_tensor(selfgen, dists, params.genrec[2], dtype)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (B, 1, 3, 3))
    sp_pad = jnp.concatenate([sp, eye], axis=1)                 # [B, M, 3, 3]

    e_scan = jnp.moveaxis(e_self, 1, 0)                         # [M, B, ...]
    sp_scan = jnp.moveaxis(sp_pad, 1, 0)                        # [M, B, 3, 3]

    p0 = (cfg.evengen *
          selfing_factors(selfgen, dtype)[:, :, None, None]
          ) * jnp.ones((B, 3, S, NS), dtype=dtype)
    f0 = jnp.zeros((B, NS), dtype=dtype)

    def step(transpose_sp):
        def go(carry, xs):
            p, logf = carry
            e, w, spm = xs
            pre, pre_f = p, logf
            pn, logf = _emit_normalise_self(p, e, logf)
            pc = apply_transition(pn, w[None, None, :])
            if transpose_sp:
                pnext = jnp.einsum("bgf,bfsn->bgsn", spm, pc)
            else:
                pnext = jnp.einsum("bfg,bfsn->bgsn", spm, pc)
            return (pnext, logf), (pre, pre_f, pn, logf)
        return go

    _, (fw_pre, fw_pre_f, fw_post, fw_post_f) = jax.lax.scan(
        step(False), (p0, f0), (e_scan, lam_pad, sp_scan))

    ones = jnp.ones((B, 3, S, NS), dtype=dtype)

    def bwd(carry, xs):
        p, logf = carry
        e, w, spm = xs
        pn, logf = _emit_normalise_self(p, e, logf)
        pc = apply_transition(pn, w[None, None, :])
        # the reference's backward sweep applies the SAME from->to
        # kernel as the forward one (probs2[to] += probs[from] *
        # selfprec[from][to] with the suffix carry in the "from" role,
        # realanalyze cnF2freq.cpp:2352-2364) — not the adjoint; the
        # distinction only matters for the non-symmetric selfprec
        pprev = jnp.einsum("bfg,bfsn->bgsn", spm, pc)
        return (pprev, logf), (pprev, logf)

    e_rev = e_scan[1:][::-1]
    lam_rev = lam[::-1]
    sp_rev = jnp.moveaxis(sp, 1, 0)[::-1]
    _, (bw_rest, bw_rest_f) = jax.lax.scan(
        bwd, (ones, f0), (e_rev, lam_rev, sp_rev))
    bw = jnp.concatenate([bw_rest[::-1], ones[None]], axis=0)
    bw_f = jnp.concatenate([bw_rest_f[::-1], f0[None]], axis=0)

    def arrange(x):
        return jnp.moveaxis(x, 0, 1)

    return SelfingFBResult(
        fw_pre=arrange(fw_pre), fw_post=arrange(fw_post), bw=arrange(bw),
        fw_pre_f=arrange(fw_pre_f), fw_post_f=arrange(fw_post_f),
        bw_f=arrange(bw_f))


def combined_loglik_self(fbres: SelfingFBResult,
                         shiftignore: jnp.ndarray) -> jnp.ndarray:
    """Log-sum-exp of per-shift totals over allowed shift modes
    (doit, cnF2freq.cpp:5373-5401)."""
    NS = fbres.fw_post_f.shape[-1]
    allowed = (jnp.arange(NS)[None, :] & shiftignore[:, None]) == 0
    f = jnp.where(allowed, fbres.total_loglik, MINFACTOR)
    fmax = f.max(axis=-1, keepdims=True)
    return (fmax[..., 0] +
            jnp.log(jnp.sum(jnp.where(allowed, jnp.exp(f - fmax), 0.0),
                            axis=-1)))


def selfing_state_posterior(fbres: SelfingFBResult, total: jnp.ndarray,
                            shiftignore: jnp.ndarray) -> jnp.ndarray:
    """P[b, m, selfval, g, s] posterior over the extended state space."""
    NS = fbres.fw_post_f.shape[-1]
    allowed = (jnp.arange(NS)[None, :] & shiftignore[:, None]) == 0
    logw = fbres.fw_post_f + fbres.bw_f - total[:, None, None]
    w = jnp.where(allowed[:, None, :], jnp.exp(logw), 0.0)
    return fbres.fw_post * fbres.bw * w[:, :, None, None, :]


def hbd_posterior(post: jnp.ndarray) -> jnp.ndarray:
    """P(HBD)[b, m]: posterior probability that the focal individual is
    homozygous-by-descent at each marker — the selfing-specific output
    (marginal over selfval in {1, 2})."""
    return post[:, :, 1:].sum(axis=(2, 3, 4))


def selfing_scan(fb: FamilyBatch, dists: jnp.ndarray, selfgen: jnp.ndarray,
                 cfg: ModelConfig, params: RuntimeParams):
    """One full selfed-line chromosome pass: (total loglik [B],
    state posterior [B, M, 3, S, NS], P(HBD) [B, M])."""
    e = selfing_emission(fb, cfg, dtype=fb.ms.dtype)
    fbres = selfing_forward_backward(e, dists, selfgen, cfg, params)
    total = combined_loglik_self(fbres, fb.shiftignore)
    post = selfing_state_posterior(fbres, total, fb.shiftignore)
    norm = post.sum(axis=(2, 3, 4), keepdims=True)
    post = jnp.where(norm > 0, post / jnp.where(norm > 0, norm, 1.0), 0.0)
    return total, post, hbd_posterior(post)
