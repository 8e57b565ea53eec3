"""RELSKEWSTATES model family: phase coherence as an extra HMM state bit.

The reference's ``RELSKEWSTATES`` build (settings.h:16,26) extends the
hidden state with one bit that *pins the focal individual's root
interpretation slot* (trackpossible, cnF2freq.cpp:1127,1148-1154): instead
of summing both phase interpretations at every marker, the interpretation
becomes part of the state and switches between adjacent markers pay a
coherence factor ``relscore = (relhaplo, 1 - relhaplo)`` keyed on the
bit's xor (realanalyze, cnF2freq.cpp:2343-2362).

Design: the coherence factor is an xor kernel on one extra bit, so
the whole extended transition stays one Walsh-Hadamard diagonalised
convolution over ``2 * numtypes`` states — the extra bit's eigenvalue is
``2*relhaplo - 1``, per individual and per interval.  Emissions are the
ordinary factored tensors with the root term masked to the pinned
interpretation.

Validated 1:1 against the golden scalar engine with
``relskewstates=True`` (tests/test_relskewstates.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MINFACTOR, ModelConfig, RuntimeParams
from ..hmm.emission import assemble_e_all, build_blocks
from ..hmm.family import FamilyBatch
from ..hmm.transition import (apply_transition_sn as apply_transition,
                              interval_recomb,
                              transition_eigenvalues)


def relstate_emission(fb: FamilyBatch, cfg: ModelConfig, ci: bool = False,
                      dtype=jnp.float64) -> jnp.ndarray:
    """E[b, m, rel(2), S, NS]: per-state emissions with the focal's root
    interpretation pinned to the coherence bit."""
    assert cfg.relskewstates
    blocks = build_blocks(fb, cfg, ci=ci, dtype=dtype)
    es = []
    for rel in range(2):
        mask = jnp.asarray(np.arange(2) == rel, dtype=dtype)
        froot = blocks.froot * mask[None, None, :, None]
        top = blocks.top * mask[None, None, :, None]
        # assemble_e_all is state-minor [B, M, NS, S]; legacy order here
        es.append(jnp.moveaxis(
            assemble_e_all(blocks._replace(froot=froot, top=top), cfg),
            -1, -2))
    return jnp.stack(es, axis=2)


def relstate_eigenvalues(cfg: ModelConfig, dists, relh: jnp.ndarray,
                         params: RuntimeParams, dtype=jnp.float64
                         ) -> jnp.ndarray:
    """what[b, interval, 2*S] WHT eigenvalues of the extended kernel:
    base-bit factors times the coherence bit's ``2*relhaplo - 1``.

    relh: [B, M-1] per-individual relhaplo at the interval's left marker
    (cnF2freq.cpp:2345-2346)."""
    r = interval_recomb(cfg, params, jnp.asarray(dists))
    lam = transition_eigenvalues(cfg, r).astype(dtype)       # [I, S]
    rel_eig = (2.0 * jnp.asarray(relh, dtype=dtype) - 1.0)   # [B, I]
    ones = jnp.ones_like(rel_eig)
    # extended state index: rel * S + base  -> eigenvalue
    #   lam[base] * (rel_eig if rel-bit set else 1)
    lo = lam[None] * ones[..., None]                         # [B, I, S]
    hi = lam[None] * rel_eig[..., None]
    return jnp.concatenate([lo, hi], axis=-1)                # [B, I, 2S]


class RelFBResult(NamedTuple):
    fw_pre: jnp.ndarray    # [B, M, 2S, NS]
    fw_post: jnp.ndarray
    bw: jnp.ndarray
    fw_pre_f: jnp.ndarray  # [B, M, NS]
    fw_post_f: jnp.ndarray
    bw_f: jnp.ndarray

    @property
    def total_loglik(self) -> jnp.ndarray:
        return self.fw_post_f[:, -1, :]


def _emit_normalise(p, e, logf):
    p = jnp.where(p < 1e-300, 0.0, p)
    pe = p * e
    s = pe.sum(axis=-2, keepdims=True)
    ok = s > 0
    pn = jnp.where(ok, pe / jnp.where(ok, s, 1.0), 0.0)
    logf = jnp.where(ok[..., 0, :],
                     logf + jnp.log(jnp.where(ok[..., 0, :],
                                              s[..., 0, :], 1.0)),
                     MINFACTOR)
    return pn, logf


def relstate_forward_backward(e_rel: jnp.ndarray, dists: jnp.ndarray,
                              relh: jnp.ndarray, cfg: ModelConfig,
                              params: RuntimeParams) -> RelFBResult:
    """Batched fb sweeps over the extended space; e_rel [B, M, 2, S, NS]
    is flattened to [B, M, 2S, NS] (state index rel * S + base)."""
    B, M, _, S, NS = e_rel.shape
    dtype = e_rel.dtype
    e_flat = e_rel.reshape(B, M, 2 * S, NS)
    what = relstate_eigenvalues(cfg, dists, relh, params, dtype)
    wpad = jnp.concatenate([what, jnp.ones((B, 1, 2 * S), dtype=dtype)],
                           axis=1)

    e_scan = jnp.moveaxis(e_flat, 1, 0)
    w_scan = jnp.moveaxis(wpad, 1, 0)                        # [M, B, 2S]

    p0 = jnp.full((B, 2 * S, NS), cfg.evengen, dtype=dtype)
    f0 = jnp.zeros((B, NS), dtype=dtype)

    def fwd(carry, xs):
        p, logf = carry
        e, w = xs
        pre, pre_f = p, logf
        pn, logf = _emit_normalise(p, e, logf)
        pnext = apply_transition(pn, w)
        return (pnext, logf), (pre, pre_f, pn, logf)

    _, (fw_pre, fw_pre_f, fw_post, fw_post_f) = jax.lax.scan(
        fwd, (p0, f0), (e_scan, w_scan))

    ones = jnp.ones((B, 2 * S, NS), dtype=dtype)

    def bwd(carry, xs):
        p, logf = carry
        e, w = xs
        pn, logf = _emit_normalise(p, e, logf)
        pprev = apply_transition(pn, w)
        return (pprev, logf), (pprev, logf)

    _, (bw_rest, bw_rest_f) = jax.lax.scan(
        bwd, (ones, f0),
        (e_scan[1:][::-1], jnp.moveaxis(what, 1, 0)[::-1]))
    bw = jnp.concatenate([bw_rest[::-1], ones[None]], axis=0)
    bw_f = jnp.concatenate([bw_rest_f[::-1], f0[None]], axis=0)

    def arrange(x):
        return jnp.moveaxis(x, 0, 1)

    return RelFBResult(fw_pre=arrange(fw_pre), fw_post=arrange(fw_post),
                       bw=arrange(bw), fw_pre_f=arrange(fw_pre_f),
                       fw_post_f=arrange(fw_post_f), bw_f=arrange(bw_f))


def combined_loglik_rel(fbres: RelFBResult,
                        shiftignore: jnp.ndarray) -> jnp.ndarray:
    NS = fbres.fw_post_f.shape[-1]
    allowed = (jnp.arange(NS)[None, :] & shiftignore[:, None]) == 0
    f = jnp.where(allowed, fbres.total_loglik, MINFACTOR)
    fmax = f.max(axis=-1, keepdims=True)
    return (fmax[..., 0] +
            jnp.log(jnp.sum(jnp.where(allowed, jnp.exp(f - fmax), 0.0),
                            axis=-1)))


def relstate_scan(fb: FamilyBatch, dists: jnp.ndarray, relh: jnp.ndarray,
                  cfg: ModelConfig, params: RuntimeParams):
    """One full coherence-state chromosome pass: (total loglik [B],
    posterior [B, M, 2, S, NS], P(coherence bit = 1) [B, M])."""
    e = relstate_emission(fb, cfg, dtype=fb.ms.dtype)
    fbres = relstate_forward_backward(e, dists, relh, cfg, params)
    total = combined_loglik_rel(fbres, fb.shiftignore)
    NS = fbres.fw_post_f.shape[-1]
    allowed = (jnp.arange(NS)[None, :] & fb.shiftignore[:, None]) == 0
    logw = fbres.fw_post_f + fbres.bw_f - total[:, None, None]
    w = jnp.where(allowed[:, None, :], jnp.exp(logw), 0.0)
    post = fbres.fw_post * fbres.bw * w[:, :, None, :]
    B, M = post.shape[:2]
    S = post.shape[2] // 2
    post = post.reshape(B, M, 2, S, -1)
    norm = post.sum(axis=(2, 3, 4), keepdims=True)
    post = jnp.where(norm > 0, post / jnp.where(norm > 0, norm, 1.0), 0.0)
    return total, post, post[:, :, 1].sum(axis=(2, 3))
