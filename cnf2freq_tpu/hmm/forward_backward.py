"""Batched forward-backward sweeps.

Replaces the reference's per-individual, per-shift-mode ``initfwbw``
(cnF2freq.cpp:2074-2120) with one ``lax.scan`` over markers carrying
[B, S, NS] probability tensors — every individual and every shift mode
rides a batch axis, every marker step is a fused emission-multiply +
normalise + Hadamard transition.

Outputs mirror the reference's three stored vectors per marker
(pre-emission forward, post-emission forward, backward;
cnF2freq.cpp:392-393) with per-marker log normalisers.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import MINFACTOR, ModelConfig, RuntimeParams
from .transition import (apply_transition, interval_recomb,
                         transition_eigenvalues)


class FBResult(NamedTuple):
    fw_pre: jnp.ndarray    # [B, M, NS, S] (state minor)
    fw_post: jnp.ndarray   # [B, M, NS, S]
    bw: jnp.ndarray        # [B, M, NS, S]
    fw_pre_f: jnp.ndarray  # [B, M, NS] log normalisers
    fw_post_f: jnp.ndarray
    bw_f: jnp.ndarray

    @property
    def total_loglik(self) -> jnp.ndarray:
        """Per (individual, shift) total log-likelihood."""
        return self.fw_post_f[:, -1, :]


def _emit_normalise(p, e, logf):
    """adjustprobs semantics (cnF2freq.cpp:1579-1670): zero-clip, multiply
    emission, renormalise, accumulate log; impossible -> MINFACTOR.
    p, e: [..., NS, S] (state minor); logf: [..., NS]."""
    p = jnp.where(p < 1e-300, 0.0, p)
    pe = p * e
    s = pe.sum(axis=-1, keepdims=True)           # [..., NS, 1]
    ok = s > 0
    pn = jnp.where(ok, pe / jnp.where(ok, s, 1.0), 0.0)
    logf = jnp.where(ok[..., 0], logf + jnp.log(jnp.where(
        ok[..., 0], s[..., 0], 1.0)), MINFACTOR)
    return pn, logf


def forward_backward(e_all: jnp.ndarray, dists: jnp.ndarray,
                     cfg: ModelConfig, params: RuntimeParams,
                     ratemat=None) -> FBResult:
    """e_all: [B, M, NS, S] emission tensors; dists: [M-1] interval cM.

    ratemat: optional [M-1, typebits] map rates (transition.rate_matrix)."""
    B, M, NS, S = e_all.shape
    dtype = e_all.dtype
    r = interval_recomb(cfg, params, dists, ratemat=ratemat)
    lam = transition_eigenvalues(cfg, r).astype(dtype)      # [M-1, S]
    lam_pad = jnp.concatenate([lam, jnp.ones((1, S), dtype=dtype)], axis=0)

    e_scan = jnp.moveaxis(e_all, 1, 0)                      # [M, B, S, NS]

    p0 = jnp.full((B, NS, S), cfg.evengen, dtype=dtype)
    f0 = jnp.zeros((B, NS), dtype=dtype)

    def fwd_step(carry, xs):
        p, logf = carry
        e, w = xs
        pre, pre_f = p, logf
        pn, logf = _emit_normalise(p, e, logf)
        pnext = apply_transition(pn, w[None, None, :])
        return (pnext, logf), (pre, pre_f, pn, logf)

    _, (fw_pre, fw_pre_f, fw_post, fw_post_f) = jax.lax.scan(
        fwd_step, (p0, f0), (e_scan, lam_pad), unroll=8)

    # Backward: at marker m the stored vector folds in emissions at
    # m+1..M-1 and the interval transitions (realanalyze backward sweep,
    # cnF2freq.cpp:2181-2397)
    ones = jnp.ones((B, NS, S), dtype=dtype)

    def bwd_step(carry, xs):
        p, logf = carry
        e, w = xs
        pn, logf = _emit_normalise(p, e, logf)
        pprev = apply_transition(pn, w[None, None, :])
        return (pprev, logf), (pprev, logf)

    # reverse=True walks markers M-1..1 while stacking outputs in natural
    # order: no [::-1] materialisations of the [M, B, NS, S] tensors
    _, (bw_rest, bw_rest_f) = jax.lax.scan(
        bwd_step, (ones, f0), (e_scan[1:], lam), unroll=8, reverse=True)
    bw = jnp.concatenate([bw_rest, ones[None]], axis=0)
    bw_f = jnp.concatenate([bw_rest_f, f0[None]], axis=0)

    def arrange(x):
        return jnp.moveaxis(x, 0, 1)

    return FBResult(fw_pre=arrange(fw_pre), fw_post=arrange(fw_post),
                    bw=arrange(bw), fw_pre_f=arrange(fw_pre_f),
                    fw_post_f=arrange(fw_post_f), bw_f=arrange(bw_f))


def combined_loglik(fb: FBResult, shiftignore: jnp.ndarray) -> jnp.ndarray:
    """Log-sum-exp of per-shift total likelihoods over allowed shift modes
    (doit, cnF2freq.cpp:5373-5401)."""
    NS = fb.fw_post_f.shape[-1]
    shifts = jnp.arange(NS)
    allowed = (shifts[None, :] & shiftignore[:, None]) == 0
    f = jnp.where(allowed, fb.total_loglik, MINFACTOR)
    fmax = f.max(axis=-1, keepdims=True)
    return (fmax[..., 0] +
            jnp.log(jnp.sum(jnp.where(allowed, jnp.exp(f - fmax), 0.0),
                            axis=-1)))


def state_posterior(fb: FBResult, total: jnp.ndarray,
                    shiftignore: jnp.ndarray) -> jnp.ndarray:
    """P[b, m, s, g]: posterior over (shift, state) at each marker —
    fw_post * bw weighted by the log normalisers against the combined
    total; disallowed shift modes carry zero mass."""
    NS = fb.fw_post_f.shape[-1]
    allowed = (jnp.arange(NS)[None, :] & shiftignore[:, None]) == 0
    logw = (fb.fw_post_f + fb.bw_f - total[:, None, None])  # [B, M, NS]
    w = jnp.where(allowed[:, None, :], jnp.exp(logw), 0.0)
    return fb.fw_post * fb.bw * w[:, :, :, None]
