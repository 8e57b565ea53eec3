"""Posterior probes and update statistics.

The reference's dominant cost is its probe loop: for every (marker, state,
path, shift) it re-runs a forward-backward combine plus emission recursions
to accumulate update statistics (doit, cnF2freq.cpp:5406-5577).  With the
emission factored into per-slot blocks (emission.py) every one of those
statistics is a small tensor contraction against a posterior weight tensor

    W[b, m, g, s] = fw_pre * bw * exp(fw_pre_f + bw_f - total)

so the whole loop collapses into a handful of einsums per chromosome.

Conventions: the flattened state axis g decomposes into (fp1, fp0) and the
shift axis s into (s2, s1, s0); path bits are summed inside blocks with
canonical masks from flag2ignore.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MINFACTOR, ModelConfig
from .emission import EmissionBlocks
from .family import FamilyBatch
from .forward_backward import FBResult

# static indicator tables ----------------------------------------------------
_FP = np.arange(8)
_FPATH = np.arange(8)
_SK = np.arange(2)
_J = np.arange(2)

# parent phase bit: rp ^ p0 ^ sk  (rp = fpath bit0, p0 = fp bit0)
_IND_PARENT = ((( _FPATH[None, :, None, None] & 1)
                ^ (_FP[:, None, None, None] & 1)
                ^ _SK[None, None, :, None]) == _J[None, None, None, :])
# grandparent j phase bit: rg_j ^ gb_j (fpath bit 1+j, fp bit 1+j)
_IND_GP = [((((_FPATH[None, :, None, None] >> (1 + j)) & 1)
             ^ ((_FP[:, None, None, None] >> (1 + j)) & 1))
            == _J[None, None, None, :]) & (_SK[None, None, :, None] >= 0)
           for j in range(2)]
# focal phase bit: r0 ^ s0
_R0 = np.arange(2)
_S0 = np.arange(2)
_IND_FOCAL = ((_R0[:, None, None] ^ _S0[None, :, None]) == _J[None, None, :])


def posterior_weight(fbres: FBResult, total: jnp.ndarray,
                     shiftignore: jnp.ndarray) -> jnp.ndarray:
    """W[b, m, s, g]: the per-(shift, state) weight that multiplies E_f[g]
    to give the posterior of a (state, path, shift) probe (state minor,
    matching the sweep layout)."""
    NS = fbres.fw_pre_f.shape[-1]
    allowed = (jnp.arange(NS)[None, :] & shiftignore[:, None]) == 0
    logw = fbres.fw_pre_f + fbres.bw_f - total[:, None, None]
    logw = jnp.where(allowed[:, None, :], logw, MINFACTOR)
    return fbres.fw_pre * fbres.bw * jnp.exp(logw)[:, :, :, None]


def _w_bits(W: jnp.ndarray, cfg: ModelConfig) -> jnp.ndarray:
    """Reshape W[b,m,8,64] to bit axes [b,m,s2,s1,s0,fp1,fp0]."""
    B, M = W.shape[:2]
    return W.reshape(B, M, 2, 2, 2, 8, 8)


def _valid_paths(flag2ignore: jnp.ndarray, k: int) -> jnp.ndarray:
    """[b, fpath(8)] canonical-path mask for parent k's local path bits
    (flag2 bits 1+3k .. 3+3k)."""
    f2 = (flag2ignore[:, None] >> (1 + 3 * k)) & 7
    return (np.arange(8)[None, :] & f2) == 0


def probe_rule_factors(fb: FamilyBatch, cfg: ModelConfig, dtype,
                       variant: int = 0, tied_rule: bool = True):
    """Multiplicative probe-survival factors for ignoreflag2 rules 2-3
    (cnF2freq.cpp:3462-3496), applied to the stats contractions.

    tied_rule=False applies rule 2 (duplicate-member consistency) only —
    the SELFING build disables rule 3 in the reference (the ``!SELFING``
    gate); tied_rule="nonfocal" keeps rule 3 for every member EXCEPT
    the focal — the RELSKEWSTATES gate is per-member:
    ``(!RELSKEWSTATES || currfilter != 1)`` (cnF2freq.cpp:3488-3489).

    Rule 3 (shift-tied dedup): a relmap member whose genotype is a
    duplicate pair with equal error values admits a probe only when its
    phase-interpretation bit disagrees with its shift bit — focal:
    r0 != s0; parent k: (rp ^ p0) != s_{1+k}; grandparent: phase bit == 1.

    Rule 2 (duplicate-member consistency): an individual occupying two
    slots requires equal phase bits across them.  The equality indicator
    is the average of the four sign variants encoded in fb.dup_flip
    ((1 + (-1)^(x_i + x_j)) / 2 per pair); callers average the stats of
    `variant` = 0..3 (or just variant 0 when no duplicates exist).

    Returns (F0 [b, m, r0, s0], [FPk [b, m, 1, fp, fpath, sk] for k])."""
    ones = np.ones((), dtype=np.dtype(str(dtype)))
    md, ms = fb.md, fb.ms
    tied = fb.exists[:, :, None] & ~fb.emptyslot[:, :, None] & \
        (md[..., 0] == md[..., 1]) & (ms[..., 0] == ms[..., 1])
    tied = jnp.moveaxis(tied, 1, 2)                    # [b, m, slot]

    if tied_rule == "nonfocal":
        tied = jnp.concatenate([tied[..., :1] & False, tied[..., 1:]],
                               axis=-1)
    elif not tied_rule:
        tied = jnp.zeros_like(tied)
    r0 = np.arange(2)[:, None]
    s0 = np.arange(2)[None, :]
    f_allow = jnp.asarray((r0 ^ s0) * ones)            # [r0, s0]
    F0 = jnp.where(tied[:, :, 0, None, None], f_allow, 1.0)
    if fb.dup_flip is not None:
        sgn0 = jnp.asarray(((-1.0) ** r0[:, 0]) * ones)
        F0 = F0 * jnp.where(fb.dup_flip[:, variant, 0, None, None, None],
                            sgn0[None, None, :, None], 1.0)

    fp = np.arange(8)[:, None, None]
    fpath = np.arange(8)[None, :, None]
    sk = np.arange(2)[None, None, :]
    xp = (fp & 1) ^ (fpath & 1)                        # parent phase bit
    p_allow = jnp.asarray((xp ^ sk) * ones)            # [fp, fpath, sk]
    p_sign = jnp.asarray((-1.0) ** xp * ones)
    FPs = []
    for k in range(2):
        f = jnp.ones((fb.md.shape[0], fb.md.shape[2], 8, 8, 2),
                     dtype=dtype)
        ps = cfg.parent_slot(k)
        f = f * jnp.where(tied[:, :, ps, None, None, None], p_allow, 1.0)
        if fb.dup_flip is not None:
            f = f * jnp.where(
                fb.dup_flip[:, variant, ps, None, None, None, None],
                p_sign, 1.0)
        for j in range(2):
            gs = cfg.grandparent_slot(k, j)
            xg = jnp.asarray((((fp >> (1 + j)) & 1) ^
                              ((fpath >> (1 + j)) & 1)) * ones)
            f = f * jnp.where(tied[:, :, gs, None, None, None], xg, 1.0)
            if fb.dup_flip is not None:
                f = f * jnp.where(
                    fb.dup_flip[:, variant, gs, None, None, None, None],
                    (-1.0) ** xg, 1.0)
        FPs.append(f[:, :, None])                      # add r0 axis
    return F0, FPs


class HaploStats(NamedTuple):
    """b1/b2 accumulations per family slot (the threadprivate ``haplos``
    store, cnF2freq.cpp:379, 1347-1350) plus the per-slot mask of slots
    that actually receive updates."""

    b12: jnp.ndarray    # [b, m, slot(7), 2]
    mask: jnp.ndarray   # [b, m, slot(7)] bool


def side_collapse(PB, Wr):
    """(T1, T0): the posterior tensor with one parent branch absorbed.

    T1[z,m,r,a,u,t] folds branch 1 (and Wr) away for probes resolved on
    branch 0; T0[z,m,r,b,v,t] vice versa.  Wr — by far the largest
    operand — is read once here instead of once per downstream einsum."""
    T1 = jnp.einsum("zmrbqv,zmvutba->zmraut", PB[1], Wr)
    T0 = jnp.einsum("zmrapu,zmvutba->zmrbvt", PB[0], Wr)
    return T1, T0


def haplo_stats(W: jnp.ndarray, blocks: EmissionBlocks, fb: FamilyBatch,
                cfg: ModelConfig, ci: bool = False,
                t01=None, froot=None, PB=None) -> HaploStats:
    """Posterior-weighted phase-interpretation counts per slot: the exact
    tensor form of summing updatehaplo over all (q, g, flag2, shift) probes
    (cnF2freq.cpp:5556, 1561-1575).

    t01: optional precomputed side_collapse result (shared with
    infprob_stats by the engine).  froot/PB: optional pre-decorated
    tensors (canonical-path masks + probe_rule_factors applied)."""
    Wr = _w_bits(W, cfg)
    if froot is None:
        froot = blocks.froot
    if PB is None:
        V = [_valid_paths(fb.flag2ignore, k).astype(W.dtype)
             for k in range(2)]
        PB = [blocks.pb[k] * V[k][:, None, None, None, :, None]
              for k in range(2)]
    IND_P = jnp.asarray(_IND_PARENT, dtype=W.dtype)
    IND_G = [jnp.asarray(x, dtype=W.dtype) for x in _IND_GP]

    # path-summed blocks (canonical mask already applied)
    pbs = [PB[k].sum(axis=-2) for k in range(2)]
    if t01 is None:
        t01 = side_collapse(PB, Wr)
    T1, T0 = t01

    stats = []
    # focal (slot 0): keep (r, t) for the focal-phase indicator
    INDF = jnp.asarray(_IND_FOCAL, dtype=W.dtype)
    F = jnp.einsum("zmrau,zmraut->zmrt", pbs[0], T1)
    stats.append(jnp.einsum("zmrt,zmrt,rtj->zmj", froot, F, INDF))
    for k in range(2):
        # one moment tensor per side — each big operand read once; every
        # slot stat is then a tiny indicator projection of Y
        if k == 0:
            Y = jnp.einsum("zmrt,zmrapu,zmraut->zmapu", froot, PB[0], T1)
        else:
            Y = jnp.einsum("zmrt,zmrbqv,zmrbvt->zmbqv", froot, PB[1], T0)
        stats.append(jnp.einsum("zmfps,fpsj->zmj", Y, IND_P))
        for j in range(2):
            stats.append(jnp.einsum("zmfps,fpsj->zmj", Y, IND_G[j]))
    # reorder from [focal, p0, gp00, gp01, p1, gp10, gp11] — already the
    # slot layout
    b12 = jnp.stack(stats, axis=2)  # [b, m, 7, 2]

    return HaploStats(b12=b12, mask=haplo_update_mask(fb, cfg, ci))


def haplo_update_mask(fb: FamilyBatch, cfg: ModelConfig,
                      ci: bool = False) -> jnp.ndarray:
    """[b, m, slot] bool: which slots actually receive haplo updates —
    visited, existing, and not in the duplicate-allele collapse branch
    (doupdatehaplo, cnF2freq.cpp:1224-1252).  Shared by the XLA and
    Pallas stats paths."""
    collapse = (fb.md[..., 0] == fb.md[..., 1]) & \
        (ci | (fb.ms[..., 0] == fb.ms[..., 1]))     # [b, slot, m]
    collapse = jnp.moveaxis(collapse, 1, 2)          # [b, m, slot]
    if cfg.relskewstates:
        # no duplicate-allele collapse at the root under RELSKEWSTATES
        # (``!relskewingNOW``, cnF2freq.cpp:1235): the focal's haplo
        # update fires at homozygous markers too
        collapse = jnp.concatenate(
            [collapse[..., :1] & False, collapse[..., 1:]], axis=-1)
    exists = fb.exists[:, None, :]
    focal_attop = fb.attop[:, 0][:, None, None]
    par_vis = exists & ~focal_attop
    slot_vis = [jnp.ones_like(par_vis[..., 0:1], dtype=bool)]
    for k in range(2):
        ps = cfg.parent_slot(k)
        pv = par_vis[..., ps:ps + 1]
        slot_vis.append(pv)
        pat = fb.attop[:, ps][:, None, None]
        for j in range(2):
            gs = cfg.grandparent_slot(k, j)
            slot_vis.append(pv & ~pat & exists[..., gs:gs + 1])
    vis = jnp.concatenate(slot_vis, axis=-1)
    return vis & exists & ~collapse


class TurnScores(NamedTuple):
    """Per-marker log-likelihoods of tail phase-flip hypotheses."""

    raw: jnp.ndarray      # [b, m, turns(128), NS] log-domain
    weight: jnp.ndarray   # [b, m, turns(128)] clause weights (pre-clamp)


def turn_scores(fbres: FBResult, fb: FamilyBatch, cfg: ModelConfig,
                total_desc_scale: bool = True) -> TurnScores:
    """aroundturner probes for all turn masks at once
    (cnF2freq.cpp:5686-5752, evaluation semantics of aroundturner at
    cnF2freq.cpp:498-554): the probability of XOR-ing grandparent state
    bits and flipping shift modes from marker m to the chromosome end.

    raw[b,m,t,s] = log sum_g fw_post[b,m,g,s] * bw[b,m,g^ts(t), s^flip(t)]
                   + fw_post_f[b,m,s] + bw_f[b,m,s^flip(t)]
    """
    B, M, NS, S = fbres.fw_post.shape
    masks = []
    for t in range(cfg.numturns):
        masks.append((t & cfg.turn_state_mask, cfg.turn_shift_flip(t)))
    uniq_x = sorted({x for x, _ in masks})
    xinv = {x: i for i, x in enumerate(uniq_x)}
    # per unique xor mask: contract fw_post against the state-permuted
    # backward vector (one [B,M,NS,NS] slab at a time to bound memory)
    C_parts = []
    for x in uniq_x:
        bw_x = fbres.bw[:, :, :, np.arange(S) ^ x]
        C_parts.append(jnp.einsum("bmsg,bmtg->bmst", fbres.fw_post, bw_x))
    C = jnp.stack(C_parts, axis=2)                            # [B,M,X,S,S']
    # assemble per turn: value + factors, log domain
    tiny = jnp.asarray(1e-300, dtype=C.dtype)
    out = []
    for t, (x, flip) in enumerate(masks):
        c = C[:, :, xinv[x], :, :]                            # [B,M,NS,NS']
        s = np.arange(NS)
        c_t = c[:, :, s, s ^ flip]                            # [B,M,NS]
        val = jnp.log(jnp.maximum(c_t, tiny)) + fbres.fw_post_f \
            + fbres.bw_f[:, :, s ^ flip]
        val = jnp.where(c_t > 0, val, MINFACTOR)
        out.append(val)
    raw = jnp.stack(out, axis=2)                              # [B,M,T,NS]

    # clause weights: per-turn log-sum-exp over allowed shifts minus the
    # no-flip normaliser, scaled by descendants (computew,
    # cnF2freq.cpp:5791-5809)
    shifts = jnp.arange(NS)
    allowed = ((shifts[None, :] & fb.shiftignore[:, None]) == 0)
    rawm = jnp.where(allowed[:, None, None, :], raw, MINFACTOR)
    mx = rawm.max(axis=-1)
    lse = mx + jnp.log(jnp.sum(jnp.exp(rawm - mx[..., None]), axis=-1))
    w = lse - lse[:, :, 0:1]
    if total_desc_scale:
        w = w * fb.descendants[:, None, None]
    return TurnScores(raw=raw, weight=w)


def line_origin_posterior(W: jnp.ndarray, blocks: EmissionBlocks,
                          fb: FamilyBatch, cfg: ModelConfig) -> jnp.ndarray:
    """P[b, m, c(3)]: posterior distribution of the line-origin class —
    how many of the focal's two strands trace to a founder allele '2'.

    The tensor form of the reference's zeropropagate gstr probe
    (trackpossible<false, true> at cnF2freq.cpp:5512; the counting hook
    at cnF2freq.cpp:1264-1266): under zero-propagation the inheritance
    path of every (state, path, shift) probe is deterministic, so the
    count is a pure function of the path bits and each branch's top
    slot — parent's grandparent ``p0`` read at interpretation ``rg``,
    the parent itself when it is a founder or its ancestor slot is
    vacant (the recursion's ``par is None`` stop), or the focal for a
    vacant first-branch parent.  The reference computes the value per
    probe and leaves it unreported (reporter.addval commented out,
    cnF2freq.cpp:5553); here it becomes a posterior reporter."""
    if cfg.selfing or cfg.relskewstates:
        raise ValueError("line-origin reporter supports the standard "
                         "state space only")
    dtype = W.dtype
    Wr = _w_bits(W, cfg)
    froot, pb = blocks.froot, blocks.pb
    V = [_valid_paths(fb.flag2ignore, k).astype(dtype) for k in range(2)]
    PB = [pb[k] * V[k][:, None, None, None, :, None] for k in range(2)]

    fp = np.arange(8)
    fpath = np.arange(8)
    p0 = jnp.asarray(fp & 1)                  # gp fed by the bound allele
    rp = jnp.asarray(fpath & 1)               # parent interpretation bit

    def pick_m(md2, bit):
        """md2 [B, M, 2] indexed by a [len]-bit array -> [B, M, len]."""
        return jnp.where(bit[None, None, :] == 1, md2[:, :, 1:2],
                         md2[:, :, 0:1])

    sides = []
    for k in range(2):
        ps = cfg.parent_slot(k)
        par2 = fb.md[:, ps] == 2                       # [B, M, 2]
        par_rp2 = pick_m(par2, rp)                     # [B, M, fpath]
        gp2 = []
        gpex = []
        for j in range(2):
            gs = cfg.grandparent_slot(k, j)
            rgj = jnp.asarray((fpath >> (1 + j)) & 1)
            gp2.append(pick_m(fb.md[:, gs] == 2, rgj))  # [B, M, fpath]
            gpex.append(fb.exists[:, gs])
        gpj2 = jnp.where(p0[None, None, :, None] == 1,
                         gp2[1][:, :, None, :], gp2[0][:, :, None, :])
        gpjex = jnp.where(p0[None, :] == 1, gpex[1][:, None],
                          gpex[0][:, None])            # [B, fp]
        deep = jnp.where(gpjex[:, None, :, None], gpj2,
                         par_rp2[:, :, None, :])       # [B, M, fp, fpath]
        topv = jnp.broadcast_to(par_rp2[:, :, None, :], deep.shape)
        par_at = fb.attop[:, ps][:, None, None, None]
        par_ex = fb.exists[:, ps][:, None, None, None]
        ind_fp = jnp.where(par_at, topv, deep)         # [B, M, fp, fpath]
        ind_fp = jnp.broadcast_to(ind_fp[:, :, None], ind_fp.shape[:2] +
                                  (2,) + ind_fp.shape[2:])
        if k == blocks.side:
            # vacant first-branch parent: count at the focal, md[r0]
            focal2 = (fb.md[:, 0] == 2)                # [B, M, 2(r0)]
            vac = jnp.broadcast_to(focal2[:, :, :, None, None],
                                   ind_fp.shape)
            ind_k = jnp.where(par_ex[:, :, None], ind_fp, vac)
        else:
            # the recursion never counts a vacant second-branch parent
            # (subtrack returns without the gstr hook)
            ind_k = jnp.where(par_ex[:, :, None], ind_fp,
                              jnp.zeros_like(ind_fp))
        sides.append(ind_k.astype(dtype))              # [B, M, r, fp, fpath]

    PBc = []
    for k in range(2):
        PBc.append((PB[k] * (1.0 - sides[k])[..., None],
                    PB[k] * sides[k][..., None]))
    T1c = [jnp.einsum("zmrbqv,zmvutba->zmraut", PBc[1][c1], Wr)
           for c1 in range(2)]
    P = [[jnp.einsum("zmrapu,zmraut,zmrt->zm", PBc[0][c0], T1c[c1], froot)
          for c1 in range(2)] for c0 in range(2)]
    out = jnp.stack([P[0][0], P[0][1] + P[1][0], P[1][1]], axis=-1)

    # founder focal: the walk stops at the root; class = [md[r0] == 2]
    Wt = Wr.sum(axis=(2, 3, 5, 6))                     # [B, M, t]
    focal2 = (fb.md[:, 0] == 2).astype(dtype)          # [B, M, r]
    pf1 = jnp.einsum("zmrt,zmr,zmt->zm", blocks.top, focal2, Wt)
    pf0 = jnp.einsum("zmrt,zmr,zmt->zm", blocks.top, 1.0 - focal2, Wt)
    pf = jnp.stack([pf0, pf1, jnp.zeros_like(pf0)], axis=-1)
    out = jnp.where(blocks.focal_attop[:, None, None], pf, out)

    tot = out.sum(axis=-1, keepdims=True)
    return jnp.where(tot > 0, out / jnp.where(tot > 0, tot, 1.0), 0.0)


def turn_weights_fast(fbres: FBResult, fb: FamilyBatch, cfg: ModelConfig,
                      total_desc_scale: bool = True) -> jnp.ndarray:
    """Turn clause weights via one joint Walsh-Hadamard correlation.

    The per-turn shift-summed likelihood is an xor-correlation over the
    joint (state, shift) group Z2^typebits x Z2^3:

        sum_s exp(raw[t, s]) = D[x(t), flip(t)],
        D[x, f] = sum_{g,s} fw'[g, s] * bw'[g^x, s^f]

    with fw' = fw_post * exp(fw_post_f - max), bw' = bw * exp(bw_f - max)
    (the per-(b, m) max factors cancel in the weight ratio against the
    no-flip turn).  An xor-correlation diagonalises under the WHT, so all
    NUMTYPES*NS offsets cost three matmuls — replacing the per-mask
    gathers and the [B, M, T, NS] raw materialisation of ``turn_scores``
    (numerically equal where weights are finite; tests/test_probes.py).
    """
    from .transition import hadamard
    B, M, NS, S = fbres.fw_post.shape
    dtype = fbres.fw_post.dtype
    X = S * NS
    allowed = ((jnp.arange(NS)[None, :] & fb.shiftignore[:, None]) == 0)

    ff = jnp.where(allowed[:, None, :], fbres.fw_post_f, -jnp.inf)
    ffm = ff.max(axis=-1)                                  # [B, M]
    fexp = jnp.where(allowed[:, None, :],
                     jnp.exp(ff - ffm[..., None]), 0.0)
    bf = fbres.bw_f
    bfm = bf.max(axis=-1)
    bexp = jnp.exp(bf - bfm[..., None])

    # joint index: shift-major (s*S + g), matching the [.., NS, S] layout
    fwp = (fbres.fw_post * fexp[:, :, :, None]).reshape(B, M, X)
    bwp = (fbres.bw * bexp[:, :, :, None]).reshape(B, M, X)

    H = jnp.asarray(hadamard(int(X).bit_length() - 1, str(dtype)))
    fh = jnp.einsum("jk,bmk->bmj", H, fwp)
    bh = jnp.einsum("jk,bmk->bmj", H, bwp)
    D = jnp.einsum("jk,bmk->bmj", H, fh * bh) / X          # [B, M, X]

    idx = np.array([cfg.turn_shift_flip(t) * S + (t & cfg.turn_state_mask)
                    for t in range(cfg.numturns)])
    vals = D[..., idx]                                     # [B, M, T]
    tiny = jnp.asarray(np.finfo(str(dtype)).tiny, dtype=dtype)
    logv = jnp.log(jnp.maximum(vals, tiny))
    ok = vals > 0
    w = jnp.where(ok & ok[..., 0:1], logv - logv[..., 0:1],
                  MINFACTOR)
    if total_desc_scale:
        w = w * fb.descendants[:, None, None]
    return w


# ---------------------------------------------------------------------------
# Genotype-probability probes (GENOSPROBE / GENOS machinery)
# ---------------------------------------------------------------------------
class InfprobStats(NamedTuple):
    """Posterior-weighted candidate-allele statistics: the tensor form of
    the GENOSPROBE sideval probes plus GENOS accumulation along the traced
    branch (doit, cnF2freq.cpp:5517-5568; hooks cnF2freq.cpp:1351-1354)."""

    accum: jnp.ndarray   # [b, m, slot(7), allele-slot(2), mv(2)]
    pair: jnp.ndarray    # [b, m, 2, 2] joint P(slot0=mv0, slot1=mv1)


def _share_blocks(fb: FamilyBatch, cfg: ModelConfig, side: int, mv: int,
                  ci: bool, dtype, root_override=None):
    """U[b,m,r',fp,fpath,s0,sk] for the side-branch of a GENOSPROBE with
    root value mv; factors common to both mv cancel in the share ratio.

    root_override: the selfing HBD-collapsed focal pair (the GENOSPROBE
    recursion applies the same root collapse as the plain probes,
    cnF2freq.cpp:1131-1189)."""
    from .emission import parent_block, root_block, slot_data
    focal = slot_data(fb, 0)
    B, M = fb.md.shape[0], fb.md.shape[2]
    inval = jnp.full((B, M), mv, dtype=jnp.int32)
    rb = root_block(focal, ci=ci, haplotyping=cfg.haplotyping, inval=inval,
                    side=side, dtype=dtype, root_override=root_override,
                    no_root_collapse=cfg.relskewstates)
    par = slot_data(fb, cfg.parent_slot(side))
    gps = [slot_data(fb, cfg.grandparent_slot(side, j)) for j in range(2)]
    pbp = parent_block(par, gps[0], gps[1], rb.vA, rb.svA, ci=ci,
                       haplotyping=cfg.haplotyping, pathful=True)
    # U axes: [b, m, r', fp, fpath, s0, sk]
    return rb.froot[:, :, :, None, None, :, None] * \
        pbp[:, :, :, :, :, None, :]


def infprob_stats(W: jnp.ndarray, blocks: EmissionBlocks, fb: FamilyBatch,
                  cfg: ModelConfig, ci: bool = False,
                  t01=None, froot=None, PB=None,
                  root_override=None,
                  drop_side1: bool = False) -> InfprobStats:
    """For every (b, m): the GENOS accumulator additions per family slot,
    allele slot and candidate allele, plus the joint ordered-genotype
    posterior.

    The share ratio sideval/sidevalsum depends only on the probed branch's
    own enum bits (the untraced branch cancels), so it is a small tensor
    U_mv / sum_mv U_mv over [r, fp, fpath, s0, sk] — no (g, f, s)
    materialisation."""
    dtype = W.dtype
    Wr = _w_bits(W, cfg)
    if froot is None:
        froot = blocks.froot
    if PB is None:
        V = [_valid_paths(fb.flag2ignore, k).astype(dtype)
             for k in range(2)]
        PB = [blocks.pb[k] * V[k][:, None, None, None, :, None]
              for k in range(2)]

    # share tensors per (side, mv), aligned to the standard probe's r axis
    shares = {}
    for side in range(2):
        us = [_share_blocks(fb, cfg, side, mv, ci, dtype,
                            root_override=root_override) for mv in (1, 2)]
        den = us[0] + us[1]
        for i, mv in enumerate((1, 2)):
            sh = jnp.where(den > 0, us[i] / jnp.where(den > 0, den, 1.0),
                           0.0)
            if side == 1:
                sh = sh[:, :, ::-1]      # align r' = 1 - r to the r axis
            shares[(side, mv)] = sh

    bits = np.arange(8)
    w2 = np.arange(2)
    RP = ((bits[:, None] & 1) == w2[None, :]).astype(np.float64)  # [p, w]
    RGSEL = []   # [j][a(fp bits), p(fpath bits), w] target for gp (side,j)
    for j in range(2):
        psel = ((bits[:, None, None] & 1) == j)          # p0 == j on fp
        tgt = (((bits[None, :, None] >> (1 + j)) & 1) == w2[None, None, :])
        RGSEL.append((psel & tgt).astype(np.float64))
    RP = jnp.asarray(RP, dtype=dtype)
    RGSEL = [jnp.asarray(x, dtype=dtype) for x in RGSEL]

    # Pre-contract the big posterior tensor ONCE per side: the untraced
    # branch and Wr collapse into small [z,m,r,fp,sk,s0] tensors, so the
    # per-(side, mv) einsums below never touch Wr again (HBM-traffic
    # optimisation: Wr is the largest operand by far).
    # letters: a=fp0, p=fpath0, u=s1; b=fp1, q=fpath1, v=s2; t=s0
    if t01 is None:
        t01 = side_collapse(PB, Wr)
    T1, T0 = t01

    # per-slot, per-allele-slot, per-mv accumulations: one moment tensor
    # X[z,m,r,fp,fpath] per (side, mv) — the share tensor (the largest
    # operand) is read exactly once; every slot stat is a projection of X
    out = {s: jnp.zeros(W.shape[:2] + (2, 2), dtype=dtype)
           for s in range(cfg.numslots)}
    for mvi, mv in enumerate((1, 2)):
        # side 0: traced branch is parent 0
        X0 = jnp.einsum("zmrt,zmrapu,zmraptu,zmraut->zmrap",
                        froot, PB[0], shares[(0, mv)], T1)
        nf0 = X0.sum(axis=(-1, -2))                       # [z,m,r]
        np0 = jnp.einsum("zmrap,pw->zmw", X0, RP)
        ng = [jnp.einsum("zmrap,apw->zmw", X0, RGSEL[j]) for j in range(2)]
        out[0] = out[0].at[..., :, mvi].add(
            jnp.stack([nf0[..., 0], nf0[..., 1]], axis=-1))
        out[cfg.parent_slot(0)] = \
            out[cfg.parent_slot(0)].at[..., :, mvi].add(np0)
        for j in range(2):
            out[cfg.grandparent_slot(0, j)] = \
                out[cfg.grandparent_slot(0, j)].at[..., :, mvi].add(ng[j])

        # side 1: traced branch is parent 1.  Under RELSKEWSTATES this
        # probe is structurally dead: its flag99 = flag2 ^ 1 flips the
        # root path bit out of the state pin's admissible range
        # (cnF2freq.cpp:1148-1154), so the reference's sideval loop
        # returns 0 and its GENOS walk never fires (the 0/0 updateval at
        # cnF2freq.cpp:5566 lands on an impossible walk).
        if not drop_side1:
            X1 = jnp.einsum("zmrt,zmrbqv,zmrbqtv,zmrbvt->zmrbq",
                            froot, PB[1], shares[(1, mv)], T0)
            nf1 = X1.sum(axis=(-1, -2))
            np1 = jnp.einsum("zmrbq,qw->zmw", X1, RP)
            ng1 = [jnp.einsum("zmrbq,bqw->zmw", X1, RGSEL[j])
                   for j in range(2)]
            # focal allele-slot for side 1 is 1 - r
            out[0] = out[0].at[..., :, mvi].add(
                jnp.stack([nf1[..., 1], nf1[..., 0]], axis=-1))
            out[cfg.parent_slot(1)] = \
                out[cfg.parent_slot(1)].at[..., :, mvi].add(np1)
            for j in range(2):
                out[cfg.grandparent_slot(1, j)] = \
                    out[cfg.grandparent_slot(1, j)].at[..., :, mvi].add(
                        ng1[j])

    accum = jnp.stack([out[s] for s in range(cfg.numslots)], axis=2)

    # joint ordered-genotype posterior (the PlantImpute output table rows,
    # demo.sh:30-31): both sides' shares applied to the same posterior
    # mass.  Branch 1 (share-resolved, mv1-stacked) folds against the full
    # posterior Wr in ONE side_collapse-style contraction; the pair table
    # is then a contraction of small [.,64]-scale tensors only.
    P0 = jnp.stack([jnp.einsum("zmrapu,zmraptu->zmraut", PB[0],
                               shares[(0, mv)]) for mv in (1, 2)], axis=2)
    P1 = jnp.stack([jnp.einsum("zmrbqv,zmrbqtv->zmrbvt", PB[1],
                               shares[(1, mv)]) for mv in (1, 2)], axis=2)
    T1mv = jnp.einsum("zmjrbvt,zmvutba->zmjraut", P1, Wr)
    pair = jnp.einsum("zmrt,zmiraut,zmjraut->zmij",
                      froot, P0, T1mv)   # [b, m, mv0, mv1]
    return InfprobStats(accum=accum, pair=pair)


# ---------------------------------------------------------------------------
# Adjacent-marker phase coherence
# ---------------------------------------------------------------------------
def _phase_resolved_emission(blocks: EmissionBlocks, fb: FamilyBatch,
                             cfg: ModelConfig, slot: int) -> jnp.ndarray:
    """E_j[b, m, j(2), s, g]: emission restricted to the given slot's
    phase-interpretation bit == j, summed over all other path freedom
    (state minor)."""
    dtype = blocks.froot.dtype
    V = [_valid_paths(fb.flag2ignore, k).astype(dtype) for k in range(2)]
    froot, pb = blocks.froot, blocks.pb
    pbs = [jnp.einsum("zmrfps,zp->zmrfs", pb[k], V[k]) for k in range(2)]
    INDF = jnp.asarray(_IND_FOCAL, dtype=dtype)
    IND_P = jnp.asarray(_IND_PARENT, dtype=dtype)
    IND_G = [jnp.asarray(x, dtype=dtype) for x in _IND_GP]

    if slot == 0:
        e = jnp.einsum("zmrt,zmrau,zmrbv,rtj->zmjvutba",
                       froot, pbs[0], pbs[1], INDF)
    else:
        k = 0 if slot < cfg.parent_slot(1) else 1
        local = slot - cfg.parent_slot(k)
        IND = IND_P if local == 0 else IND_G[local - 1]
        ph = jnp.einsum("zmrfps,zp,fpsj->zmrfsj", pb[k], V[k], IND)
        if k == 0:
            e = jnp.einsum("zmrt,zmrauj,zmrbv->zmjvutba",
                           froot, ph, pbs[1])
        else:
            e = jnp.einsum("zmrt,zmrbvj,zmrau->zmjvutba",
                           froot, ph, pbs[0])
    B, M = e.shape[:2]
    return e.reshape(B, M, 2, cfg.numshifts, cfg.numtypes)


def pair_coherence_from_ej(fbres: FBResult, e_j: jnp.ndarray,
                           lam: jnp.ndarray) -> jnp.ndarray:
    """C[b, m] from a phase-resolved emission tensor e_j
    [B, M, j(2), NS, S]; last column is 0.5 padding.  Generic over the
    state space (used by the numgen==3 and numgen==2 engines)."""
    from .transition import apply_transition
    B, M, NS, S = fbres.fw_pre.shape
    dtype = fbres.fw_pre.dtype
    logw = fbres.fw_pre_f[:, :-1, :] + fbres.bw_f[:, 1:, :]
    logw = logw - logw.max(axis=-1, keepdims=True)
    w = jnp.exp(logw)                                   # [B, M-1, NS]

    x = fbres.fw_pre[:, :-1, None] * e_j[:, :-1]        # [B,M-1,j,NS,S]
    xt = apply_transition(x, lam[:, None, None, :])
    y = e_j[:, 1:] * fbres.bw[:, 1:, None]              # [B,M-1,j',NS,S]
    jmat = jnp.einsum("zmiag,zmjag,zma->zmij", xt, y, w)
    tot = jmat.sum(axis=(-1, -2))
    same = jmat[..., 0, 0] + jmat[..., 1, 1]
    c = jnp.where(tot > 0, same / jnp.where(tot > 0, tot, 1.0), 0.5)
    pad = jnp.full((B, 1), 0.5, dtype=dtype)
    return jnp.concatenate([c, pad], axis=1)


def pair_chain(fbres: FBResult, e: jnp.ndarray,
               lam: jnp.ndarray) -> jnp.ndarray:
    """<(fw_pre . e)[m], T_m ((e . bw)[m+1])> with shift-mode weights:
    the pairwise-joint contraction underlying coherence, for ONE signed
    emission tensor e [B, M, NS, S].  Returns [B, M-1]."""
    from .transition import apply_transition
    logw = fbres.fw_pre_f[:, :-1, :] + fbres.bw_f[:, 1:, :]
    logw = logw - logw.max(axis=-1, keepdims=True)
    w = jnp.exp(logw)                                   # [B, M-1, NS]
    x = fbres.fw_pre[:, :-1] * e[:, :-1]                # [B,M-1,NS,S]
    xt = apply_transition(x, lam[:, None, :])
    y = e[:, 1:] * fbres.bw[:, 1:]
    return jnp.einsum("zmag,zmag,zma->zm", xt, y, w)


def pair_coherence_from_parity(fbres: FBResult, e_par: jnp.ndarray,
                               lam: jnp.ndarray,
                               tot: jnp.ndarray) -> jnp.ndarray:
    """C[b, m] from the PARITY-signed emission e_par = e_{j=0} - e_{j=1}
    and the (slot-independent, shared) pair total ``tot`` =
    pair_chain(e_all).

    Same statistic as pair_coherence_from_ej at half the big-tensor
    traffic: with corr = <par_m, T par_{m+1}> = same - diff and
    tot = same + diff, C = same/tot = (tot + corr) / (2 tot)."""
    B = e_par.shape[0]
    dtype = e_par.dtype
    corr = pair_chain(fbres, e_par, lam)
    c = jnp.where(tot > 0,
                  0.5 + 0.5 * corr / jnp.where(tot > 0, tot, 1.0), 0.5)
    pad = jnp.full((B, 1), 0.5, dtype=dtype)
    return jnp.concatenate([c, pad], axis=1)


def _phase_parity_emission(blocks: EmissionBlocks, fb: FamilyBatch,
                           cfg: ModelConfig, slot: int) -> jnp.ndarray:
    """E_par[b, m, s]: the parity-signed emission
    e_{j=0} - e_{j=1} of the given slot's phase-interpretation bit,
    summed over all other path freedom — half the tensor traffic of the
    j-resolved form (the indicator is one-hot over j, so the signed
    contraction carries the same information)."""
    dtype = blocks.froot.dtype
    V = [_valid_paths(fb.flag2ignore, k).astype(dtype) for k in range(2)]
    froot, pb = blocks.froot, blocks.pb
    pbs = [jnp.einsum("zmrfps,zp->zmrfs", pb[k], V[k]) for k in range(2)]

    if slot == 0:
        PARF = jnp.asarray(_IND_FOCAL[..., 0].astype(np.int8)
                           - _IND_FOCAL[..., 1].astype(np.int8), dtype)
        e = jnp.einsum("zmrt,zmrau,zmrbv,rt->zmvutba",
                       froot, pbs[0], pbs[1], PARF)
    else:
        k = 0 if slot < cfg.parent_slot(1) else 1
        local = slot - cfg.parent_slot(k)
        IND = _IND_PARENT if local == 0 else _IND_GP[local - 1]
        PAR = jnp.asarray(IND[..., 0].astype(np.int8)
                          - IND[..., 1].astype(np.int8), dtype)
        ph = jnp.einsum("zmrfps,zp,fps->zmrfs", pb[k], V[k], PAR)
        if k == 0:
            e = jnp.einsum("zmrt,zmrau,zmrbv->zmvutba",
                           froot, ph, pbs[1])
        else:
            e = jnp.einsum("zmrt,zmrbv,zmrau->zmvutba",
                           froot, ph, pbs[0])
    B, M = e.shape[:2]
    return e.reshape(B, M, cfg.numshifts, cfg.numtypes)


def phase_pair_total(fbres: FBResult, blocks: EmissionBlocks,
                     fb: FamilyBatch, cfg: ModelConfig,
                     lam: jnp.ndarray) -> jnp.ndarray:
    """The slot-independent pair total: pair_chain over the plain
    path-summed emission (what every slot's jmat sums to).  Computed
    once and shared across the numslots coherence columns."""
    dtype = blocks.froot.dtype
    V = [_valid_paths(fb.flag2ignore, k).astype(dtype) for k in range(2)]
    froot, pb = blocks.froot, blocks.pb
    pbs = [jnp.einsum("zmrfps,zp->zmrfs", pb[k], V[k]) for k in range(2)]
    e = jnp.einsum("zmrt,zmrau,zmrbv->zmvutba", froot, pbs[0], pbs[1])
    B, M = e.shape[:2]
    e = e.reshape(B, M, cfg.numshifts, cfg.numtypes)
    return pair_chain(fbres, e, lam)


def phase_coherence_slot(fbres: FBResult, blocks: EmissionBlocks,
                         fb: FamilyBatch, cfg: ModelConfig,
                         lam: jnp.ndarray, slot: int,
                         tot: jnp.ndarray = None) -> jnp.ndarray:
    """C[b, m]: posterior P(phase bit of `slot` equal at markers m, m+1);
    the last column is 0.5 padding.

    This is the statistic ``relhaplo`` is designed to carry (the
    reference's ShapeIT ensemble path fills it from sampled phase
    switches, cnF2freq.cpp:7029-7067; the PlantImpute path leaves it at
    0.5).  Computed from the pairwise joint
    fw_pre[m] * E_par[m] * T_m * E_par[m+1] * bw[m+1] per shift mode in
    parity (signed) form; ``tot`` optionally supplies the shared
    phase_pair_total (recomputed here when absent).  One slot per call
    keeps peak memory bounded at large B*M."""
    if tot is None:
        tot = phase_pair_total(fbres, blocks, fb, cfg, lam)
    e_par = _phase_parity_emission(blocks, fb, cfg, slot)
    return pair_coherence_from_parity(fbres, e_par, lam, tot)


def phase_coherence(fbres: FBResult, blocks: EmissionBlocks,
                    fb: FamilyBatch, cfg: ModelConfig,
                    lam: jnp.ndarray) -> jnp.ndarray:
    """All-slot coherence [b, m, slot] (shared pair total)."""
    tot = phase_pair_total(fbres, blocks, fb, cfg, lam)
    cols = [phase_coherence_slot(fbres, blocks, fb, cfg, lam, slot,
                                 tot=tot)
            for slot in range(cfg.numslots)]
    return jnp.stack(cols, axis=-1)


# ---------------------------------------------------------------------------
# Recombination expectations (genetic-map re-estimation)
# ---------------------------------------------------------------------------
def recombination_expectations(fbres: FBResult, e_all: jnp.ndarray,
                               cfg: ModelConfig,
                               lam: jnp.ndarray) -> jnp.ndarray:
    """P[b, m, t]: posterior probability that meiosis bit t recombined in
    interval (m, m+1).

    The reference estimates this with per-(state, state) double-locked
    probes (twicestop + calcdistancecolrowsums, cnF2freq.cpp:3618-3638,
    5586-5664; default-off).  The direct form is the pairwise state joint
    fw_post[m] * R * (E[m+1] . bw[m+1]), whose xor marginal comes out of
    one Walsh-Hadamard correlation per interval."""
    from .transition import hadamard
    B, M, NS, S = fbres.fw_post.shape
    dtype = fbres.fw_post.dtype
    H = jnp.asarray(hadamard(int(S).bit_length() - 1, str(dtype)))

    x_ = fbres.fw_post[:, :-1]                        # [B,M-1,NS,S]
    y_ = e_all[:, 1:] * fbres.bw[:, 1:]
    # xor-correlation Z[x] = sum_g X[g] Y[g^x] = H( H(X) * H(Y) ) / S
    # (H symmetric, state minor: plain matmuls on the last axis)
    z = (((x_ @ H) * (y_ @ H)) @ H) / S               # [B,M-1,NS,S]
    # weight each shift mode by its posterior factor share
    logw = fbres.fw_post_f[:, :-1] + fbres.bw_f[:, 1:]
    logw = logw - logw.max(axis=-1, keepdims=True)
    z = (z * jnp.exp(logw)[:, :, :, None]).sum(axis=2)    # [B,M-1,S]
    p = jnp.maximum(z, 0.0) * lam_to_kernel(lam, cfg)      # [B,M-1,S]
    tot = p.sum(axis=-1, keepdims=True)
    p = jnp.where(tot > 0, p / jnp.where(tot > 0, tot, 1.0), 0.0)
    bits = ((np.arange(S)[:, None] >> np.arange(cfg.typebits)[None, :])
            & 1).astype(np.float64)
    return jnp.einsum("bmx,xt->bmt", p, jnp.asarray(bits, dtype=dtype))


def lam_to_kernel(lam: jnp.ndarray, cfg: ModelConfig) -> jnp.ndarray:
    """Invert the WHT: kernel R[interval, xor] from eigenvalues."""
    from .transition import hadamard
    S = lam.shape[-1]
    H = jnp.asarray(hadamard(int(S).bit_length() - 1, str(lam.dtype)))
    return jnp.einsum("gh,mh->mg", H, lam) / S
