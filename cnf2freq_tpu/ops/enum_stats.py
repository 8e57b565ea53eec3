"""Posterior update statistics with the enum axes leading.

The statistics stage of the standard path (posterior_weight ->
side_collapse -> haplo_stats / infprob_stats in hmm/probes.py) keeps the
enumeration axes trailing.  ``stats_tile`` computes the same quantities
with every enumeration axis LEADING and the data axes trailing:

    slot data (md/ms/hw/exists/attop: ~50 scalars per unit and marker)
    fw_pre, bw, log factors (512 + 512 + 16 per unit and marker)
      |
      v  emission blocks -> posterior weight -> side collapses ->
    haplo b12 [7,2] + infprob accum [7,2,2] + pair [2,2] per data point

so it reads the feature-leading sweep tensors of ops/scan_v2.py without
transposing their data axes.  The emission-block math mirrors
hmm/emission.py (reference semantics: trackpossible,
cnF2freq.cpp:1075-1359), specialised to the engine's standard probe
configuration (zp == ZP_NONE, ci == False, update == 0);
tests/test_stats_pallas.py pins the two implementations together.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from ..config import SEXMARKER, UNKNOWN, ModelConfig

# ---------------------------------------------------------------------------
# Enum-leading broadcasting helpers.  Axis order matches emission.py:
# (r0, gb1, gb0, p0, rg1, rg0, rp, sk), then DATA_ND trailing data dims.
# ---------------------------------------------------------------------------
_NAX = 8
_AXL = {name: i for i, name in enumerate(
    ["r0", "gb1", "gb0", "p0", "rg1", "rg0", "rp", "sk"])}
DATA_ND = 2


def _eL(name: str):
    """Enum index array along one enum axis."""
    shape = [1] * (_NAX + DATA_ND)
    shape[_AXL[name]] = 2
    return jax.lax.broadcasted_iota(jnp.int32, tuple(shape), _AXL[name])


def _iota(shape, dim):
    return jax.lax.broadcasted_iota(jnp.int32, shape, dim)


def _safe_div(a, b):
    return jnp.where(b > 0, a / jnp.where(b > 0, b, 1.0), 0.0)


def _pickL(pair, idx):
    """pair: [2, data...] selected by enum-index array idx (0/1)."""
    return jnp.where(idx == 1, pair[1], pair[0])


def _match_raw_L(v, sv, mdj, msj):
    """markermiss + base-value arithmetic (cnF2freq.cpp:303-316,
    1196-1221), zp == ZP_NONE path; all args broadcast together."""
    unknown_v = v == UNKNOWN
    bound = jnp.where(unknown_v, mdj, v)
    miss = (~unknown_v) & ~((mdj == UNKNOWN) & (v != SEXMARKER)) \
        & (v != mdj)
    bv_match = 1.0 - msj
    effsecond = jnp.where(unknown_v & (bound != UNKNOWN),
                          jnp.ones_like(sv), sv)
    effms = jnp.where(mdj == UNKNOWN, 1.0, msj)
    pre_match = effms * effsecond
    pre_miss = jnp.where((msj != 0) & (sv != 0), (1.0 - msj) * sv, 0.0)
    bv = jnp.where(miss, msj, bv_match)
    pre = jnp.where(miss, pre_miss, pre_match)
    return bv, pre, bound


def _phase_L(md, ms, hw, f2n, haplotyping: bool):
    """Phase-interpretation factor (cnF2freq.cpp:1229-1252); md/ms carry
    the allele-pair axis LEADING."""
    f2nf = jnp.asarray(f2n, dtype=hw.dtype)
    collapse = (md[0] == md[1]) & (ms[0] == ms[1])
    weight = jnp.abs(f2nf - hw) if haplotyping \
        else jnp.full_like(f2nf + hw, 0.5)
    return jnp.where(collapse, f2nf + 0.0 * hw, weight), collapse


class SlotL:
    __slots__ = ("md", "ms", "hw", "exists", "attop")

    def __init__(self, md, ms, hw, exists, attop):
        self.md, self.ms, self.hw = md, ms, hw
        self.exists, self.attop = exists, attop


def _gp_term_L(gp: SlotL, w, sw, gb, rg, haplotyping: bool):
    """Grandparent slot term (attopnow, cnF2freq.cpp:1213-1217,
    1043-1046)."""
    md_rg = _pickL(gp.md, rg)
    ms_rg = _pickL(gp.ms, rg)
    bv, pre, _ = _match_raw_L(w, sw, md_rg, ms_rg)
    ph, _ = _phase_L(gp.md, gp.ms, gp.hw, rg ^ gb, haplotyping)
    term = (bv + pre) * ph
    return jnp.where(gp.exists, term, 1.0 + sw)


def parent_block_L(par: SlotL, gp0: SlotL, gp1: SlotL, v, sv,
                   haplotyping: bool = True, trace_second: bool = True):
    """One parent branch (parent_block in emission.py, enum-leading).

    v, sv: [2, data...] value/second-channel per focal interpretation r0.
    Returns [r0(2), fp(8), fpath(8), sk(2), data...]."""
    _R0, _P0, _SK = _eL("r0"), _eL("p0"), _eL("sk")
    _GB0, _GB1, _RG0, _RG1, _RP = (_eL("gb0"), _eL("gb1"), _eL("rg0"),
                                   _eL("rg1"), _eL("rp"))
    vb = _pickL(v, _R0)
    svb = _pickL(sv, _R0)

    md_rp = _pickL(par.md, _RP)
    ms_rp = _pickL(par.ms, _RP)
    md_o = _pickL(par.md, 1 - _RP)
    ms_o = _pickL(par.ms, 1 - _RP)

    bv_raw, pre, bound = _match_raw_L(vb, svb, md_rp, ms_rp)
    bv_abs = bv_raw + pre
    ms_nab = _safe_div(pre, bv_raw)
    ph, _ = _phase_L(par.md, par.ms, par.hw, _RP ^ _P0 ^ _SK, haplotyping)

    sec_f = jnp.where(ms_o != 0, 1.0 - ms_o, 1.0)
    secsec = jnp.where(ms_o != 0, _safe_div(ms_o, 1.0 - ms_o), 0.0)

    w1, sw1 = bound, ms_nab
    w2, sw2 = md_o, secsec

    g0_first = _gp_term_L(gp0, w1, sw1, _GB0, _RG0, haplotyping)
    g1_first = _gp_term_L(gp1, w1, sw1, _GB1, _RG1, haplotyping)
    if trace_second:
        g0_second = _gp_term_L(gp0, w2, sw2, _GB0, _RG0, haplotyping)
        g1_second = _gp_term_L(gp1, w2, sw2, _GB1, _RG1, haplotyping)
        deep = bv_raw * ph * sec_f * jnp.where(
            _P0 == 0, g0_first * g1_second, g1_first * g0_second)
    else:
        deep = bv_raw * ph * jnp.where(_P0 == 0, g0_first, g1_first)

    top = bv_abs * ph
    term = jnp.where(par.attop, top, deep)
    term = jnp.where(par.exists, term, 1.0 + svb)

    # canonical-path weights (see parent_block in emission.py)
    ex_p = par.exists
    at_p = par.attop
    cons = []
    for j, (gp, rg) in enumerate(((gp0, _RG0), (gp1, _RG1))):
        c = ex_p & ~at_p & gp.exists
        if not trace_second:
            c = c & (_P0 == j)
        cons.append(c | (rg == 0))
    weight = (ex_p | (_RP == 0)) & cons[0] & cons[1]
    term = term * weight

    data_shape = term.shape[_NAX:]
    term = jnp.broadcast_to(term, (2,) * _NAX + data_shape)
    return term.reshape((2, 8, 8, 2) + data_shape)


def root_block_L(focal: SlotL, haplotyping: bool = True, inval=None,
                 side: int = 0, dtype=jnp.float32):
    """Focal term (root_block in emission.py, enum-leading; update == 0,
    zp == ZP_NONE, ci == False): returns (froot [2(r0), 2(s0), data...],
    vA [2(r0), data...], svA, vB, svB)."""
    R0 = _iota((2, 1) + (1,) * DATA_ND, 0)
    S0 = _iota((1, 2) + (1,) * DATA_ND, 1)

    if inval is None:
        iv = jnp.zeros((1, 1) + (1,) * DATA_ND, dtype=jnp.int32)
    else:
        iv = jnp.asarray(inval)
        iv = iv.reshape((1, 1) + iv.shape)
    sv = jnp.zeros((1, 1) + (1,) * DATA_ND, dtype=dtype)

    def pick2(pair, idx):
        return jnp.where(idx == 1, pair[1], pair[0])

    md_r = pick2(focal.md, R0)
    ms_r = pick2(focal.ms, R0)
    md_o = pick2(focal.md, 1 - R0)
    ms_o = pick2(focal.ms, 1 - R0)

    unknown_v = iv == UNKNOWN
    bound = jnp.where(unknown_v, md_r, iv)
    miss = (~unknown_v) & ~((md_r == UNKNOWN) & (iv != SEXMARKER)) \
        & (iv != md_r)
    bv_match = 1.0 - ms_r
    effsecond = jnp.where(unknown_v & (bound != UNKNOWN), 1.0, sv)
    effms = jnp.where(md_r == UNKNOWN, 1.0, ms_r)
    pre = jnp.where(miss,
                    jnp.where((ms_r != 0) & (sv != 0), (1.0 - ms_r) * sv,
                              0.0),
                    effms * effsecond)
    bv_raw = jnp.where(miss, ms_r, bv_match)

    bv_abs = bv_raw + pre
    ms_nab = _safe_div(pre, bv_raw)

    collapse = (focal.md[0] == focal.md[1]) & (focal.ms[0] == focal.ms[1])
    f2n = R0 ^ side ^ S0
    if haplotyping:
        w = jnp.abs(f2n - focal.hw)
    else:
        w = jnp.full_like(focal.hw + 0.0 * f2n, 0.5)
    ph = jnp.where(collapse, f2n.astype(dtype) + 0.0 * w, w)

    attop = focal.attop
    bv = jnp.where(attop, bv_abs, bv_raw)
    msA = jnp.where(attop, jnp.zeros_like(ms_nab), ms_nab)

    vB = md_o
    secfac = jnp.where(ms_o != 0, 1.0 - ms_o, 1.0)
    svB = jnp.where(ms_o != 0, _safe_div(ms_o, 1.0 - ms_o), 0.0)

    froot = jnp.where(attop, bv_abs * ph, bv * ph * secfac)

    data_shape = jnp.broadcast_shapes(
        focal.hw.shape, focal.md.shape[1:], (1,) * DATA_ND)

    def up(x):
        """Broadcast to [2(r0), data...], dropping the s0 axis."""
        x = jnp.broadcast_to(x, (2, x.shape[1]) + data_shape)
        return x[:, 0]

    froot = jnp.broadcast_to(froot, (2, 2) + data_shape)
    return froot, up(bound), up(msA), up(vB), up(svB)


def _rule_factors_tile(md, ms, exists, empty, dupf, cfg: ModelConfig,
                       dtype):
    """Probe-survival factors for ignoreflag2 rules 2-3
    (cnF2freq.cpp:3462-3496): hmm.probes.probe_rule_factors with the
    enum axes leading (same algebra).

    empty [7,*T] int32 (1 = genotype-less member outside fixtrees'
    relmap); dupf [7,*T] int32 (this variant's duplicate-pair sign
    slots) or None.
    Returns (F0 [2(r0),2(s0),*T], [FPk [8(f),8(p),2(sk),*T)] for k])."""
    def tied(s):
        return (exists[s] & (empty[s] == 0) & (md[s, 0] == md[s, 1])
                & (ms[s, 0] == ms[s, 1]))

    ri = _iota((2, 1) + (1,) * DATA_ND, 0)
    ti = _iota((1, 2) + (1,) * DATA_ND, 1)
    F0 = jnp.where(tied(0)[None, None], (ri ^ ti).astype(dtype), 1.0)
    if dupf is not None:
        F0 = F0 * jnp.where(dupf[0][None, None] != 0,
                            1.0 - 2.0 * ri.astype(dtype), 1.0)
    fi = _iota((8, 1, 1) + (1,) * DATA_ND, 0)
    pi = _iota((1, 8, 1) + (1,) * DATA_ND, 1)
    si = _iota((1, 1, 2) + (1,) * DATA_ND, 2)
    FPs = []
    for k in range(2):
        xp = (fi & 1) ^ (pi & 1)
        ps = cfg.parent_slot(k)
        f = jnp.where(tied(ps)[None, None, None],
                      (xp ^ si).astype(dtype), 1.0)
        if dupf is not None:
            f = f * jnp.where(dupf[ps][None, None, None] != 0,
                              1.0 - 2.0 * xp.astype(dtype), 1.0)
        for j in range(2):
            gs = cfg.grandparent_slot(k, j)
            xg = ((fi >> (1 + j)) & 1) ^ ((pi >> (1 + j)) & 1)
            f = f * jnp.where(tied(gs)[None, None, None],
                              xg.astype(dtype), 1.0)
            if dupf is not None:
                f = f * jnp.where(dupf[gs][None, None, None] != 0,
                                  1.0 - 2.0 * xg.astype(dtype), 1.0)
        FPs.append(f)
    return F0, FPs


# ---------------------------------------------------------------------------
# The statistics over any trailing data axes
# ---------------------------------------------------------------------------
def stats_tile(md, ms, hw, exists, attop, f2ig, shig, fw_pre, bw,
               fw_pre_f, bw_f, total, cfg: ModelConfig,
               empty=None, dupf=None):
    """All update statistics for one tile of bm pairs.

    md [7,2,*T] int32; ms [7,2,*T]; hw [7,*T]; exists/attop [7,*T] bool;
    f2ig/shig [*T] int32; fw_pre/bw [8,8,2,2,2,*T] (fp1,fp0,s2,s1,s0);
    fw_pre_f/bw_f [2,2,2,*T]; total [*T]; empty/dupf [7,*T] int32 or
    None (probe-dedup inputs — when empty is given, the ignoreflag2
    rule 2-3 factors decorate froot and the parent blocks exactly as in
    engine.chromosome_scan's XLA path).
    Returns (b12 [7,2,*T], accum [7,2,2,*T], pair [2,2,*T]).
    """
    dtype = hw.dtype
    T = md.shape[2:]
    hap = cfg.haplotyping

    def slotL(s):
        return SlotL(md=md[s], ms=ms[s], hw=hw[s], exists=exists[s],
                     attop=attop[s])

    focal = slotL(0)
    par = [slotL(cfg.parent_slot(k)) for k in range(2)]
    gps = [[slotL(cfg.grandparent_slot(k, j)) for j in range(2)]
           for k in range(2)]

    froot, vA, svA, vB, svB = root_block_L(focal, haplotyping=hap,
                                           dtype=dtype)
    pb = []
    for k in range(2):
        vk, svk = (vA, svA) if k == 0 else (vB, svB)
        pb.append(parent_block_L(par[k], gps[k][0], gps[k][1], vk, svk,
                                 haplotyping=hap))

    # canonical-path masks V[k][p] and masked blocks
    PBm = []
    for k in range(2):
        bits = (f2ig >> (1 + 3 * k)) & 7
        V = jnp.stack([((bits & p) == 0).astype(dtype)
                       for p in range(8)], axis=0)           # [8, *T]
        PBm.append(pb[k] * V[None, None, :, None])

    if empty is not None:
        # ignoreflag2 rule 2-3 probe-dedup factors (same decoration as
        # the engine's XLA contraction path; the undecorated share
        # tensors below match _share_blocks there)
        F0, FPs = _rule_factors_tile(md, ms, exists, empty, dupf, cfg,
                                     dtype)
        froot = froot * F0
        PBm = [PBm[k] * FPs[k][None] for k in range(2)]

    # posterior weight W[b(fp1), a(fp0), v(s2), u(s1), t(s0)]
    s2 = _iota((2, 1, 1) + (1,) * DATA_ND, 0)
    s1 = _iota((1, 2, 1) + (1,) * DATA_ND, 1)
    s0 = _iota((1, 1, 2) + (1,) * DATA_ND, 2)
    sidx = s2 * 4 + s1 * 2 + s0
    allowed = ((sidx & shig) == 0).astype(dtype)             # [2,2,2,*T]
    wexp = jnp.exp(fw_pre_f + bw_f - total) * allowed
    W = fw_pre * bw * wexp[None, None]                       # [8,8,2,2,2,*T]

    # side collapses: T1[r,a,u,t] folds branch 1; T0[r,b,v,t] branch 0
    PBq = [PBm[k].sum(axis=2) for k in range(2)]             # [r,f,sk,*T]
    T1 = jnp.zeros((2, 8, 2, 2) + T, dtype=dtype)
    T0 = jnp.zeros((2, 8, 2, 2) + T, dtype=dtype)
    for b in range(8):
        for v in range(2):
            T1 = T1 + PBq[1][:, b, v][:, None, None, None] * \
                W[b, :, v][None]
    for a in range(8):
        for u in range(2):
            T0 = T0 + PBq[0][:, a, u][:, None, None, None] * \
                W[:, a, :, u][None]

    # ---- haplo stats --------------------------------------------------
    pbs0 = PBm[0].sum(axis=2)                                # [r,a,u,*T]
    F = jnp.zeros((2, 2) + T, dtype=dtype)                   # [r,t,*T]
    for a in range(8):
        for u in range(2):
            F = F + pbs0[:, a, u][:, None] * T1[:, a, u]
    fF = froot * F                                           # [r,t,*T]
    ri = _iota((2, 1) + (1,) * DATA_ND, 0)
    ti = _iota((1, 2) + (1,) * DATA_ND, 1)
    indf = ri ^ ti                                           # focal j bit
    foc = jnp.stack([(fF * (indf == j).astype(dtype)).sum(axis=(0, 1))
                     for j in range(2)], axis=0)

    b12_list = [None] * cfg.numslots
    b12_list[0] = foc
    for k in range(2):
        Y = jnp.zeros((8, 8, 2) + T, dtype=dtype)            # [f,p,s,*T]
        Tk = T1 if k == 0 else T0
        for r in range(2):
            for t in range(2):
                # PBm[k][r]: [f,p,s,*T]; Tk[r, :, :, t]: [f,s,*T]
                Y = Y + froot[r, t] * PBm[k][r] * Tk[r, :, :, t][:, None]
        fi = _iota((8, 1, 1) + (1,) * DATA_ND, 0)
        pi = _iota((1, 8, 1) + (1,) * DATA_ND, 1)
        si = _iota((1, 1, 2) + (1,) * DATA_ND, 2)
        # parent: rp ^ p0 ^ sk; grandparent jg: rg_jg ^ gb_jg
        jbits = [(pi & 1) ^ (fi & 1) ^ si,
                 ((pi >> 1) & 1) ^ ((fi >> 1) & 1),
                 ((pi >> 2) & 1) ^ ((fi >> 2) & 1)]
        for i, jb in enumerate(jbits):
            st = jnp.stack([(Y * (jb == j).astype(dtype)).sum(
                axis=(0, 1, 2)) for j in range(2)], axis=0)
            slot = cfg.parent_slot(k) if i == 0 else \
                cfg.grandparent_slot(k, i - 1)
            b12_list[slot] = st
    b12 = jnp.stack(b12_list, axis=0)                        # [7, 2, *T]

    # ---- infprob stats ------------------------------------------------
    # accumulate into a Python grid and stack at the end
    zero = jnp.zeros(T, dtype=dtype)
    acc_g = [[[zero, zero], [zero, zero]] for _ in range(cfg.numslots)]
    P0mv, P1mv = [], []
    for side in range(2):
        us = []
        for mv in (1, 2):
            iv = jnp.full(T, mv, dtype=jnp.int32)
            fr_mv, vA_mv, svA_mv, _, _ = root_block_L(
                focal, haplotyping=hap, inval=iv, side=side, dtype=dtype)
            pbp = parent_block_L(par[side], gps[side][0], gps[side][1],
                                 vA_mv, svA_mv, haplotyping=hap)
            # U[r, a, p, t, u] = froot_mv[r, t] * pbp[r, a, p, u]
            us.append(fr_mv[:, None, None, :, None] *
                      pbp[:, :, :, None, :])
        den = us[0] + us[1]
        for mvi in range(2):
            sh = _safe_div(us[mvi], den)
            if side == 1:
                # align r' = 1 - r to the r axis
                sh = jnp.stack([sh[1], sh[0]], axis=0)

            Tk = T1 if side == 0 else T0
            PBk = PBm[side]
            X = jnp.zeros((2, 8, 8) + T, dtype=dtype)        # [r,a,p,*T]
            for t in range(2):
                for u in range(2):
                    ft = froot[:, t][:, None] * Tk[:, :, u, t]  # [r,a,*T]
                    X = X + ft[:, :, None] * PBk[:, :, :, u] * \
                        sh[:, :, :, t, u]
            nf = X.sum(axis=(1, 2))                          # [r,*T]
            acc_g[0][0][mvi] = acc_g[0][0][mvi] + \
                nf[0 if side == 0 else 1]
            acc_g[0][1][mvi] = acc_g[0][1][mvi] + \
                nf[1 if side == 0 else 0]
            Xr = X.sum(axis=0)                               # [a,p,*T]
            ps = cfg.parent_slot(side)
            ai = _iota((8, 1) + (1,) * DATA_ND, 0)
            pi2 = _iota((1, 8) + (1,) * DATA_ND, 1)
            for w in range(2):
                acc_g[ps][w][mvi] = acc_g[ps][w][mvi] + \
                    (Xr * ((pi2 & 1) == w).astype(dtype)).sum(axis=(0, 1))
                for j in range(2):
                    gs = cfg.grandparent_slot(side, j)
                    sel = ((ai & 1) == j) & (((pi2 >> (1 + j)) & 1) == w)
                    acc_g[gs][w][mvi] = acc_g[gs][w][mvi] + \
                        (Xr * sel.astype(dtype)).sum(axis=(0, 1))

            # branch collapsed with its share, for the pair table
            if side == 0:
                # P0[r,a,u,t] = sum_p PB0[r,a,p,u] * sh[r,a,p,t,u]
                P = jnp.zeros((2, 8, 2, 2) + T, dtype=dtype)
                for p in range(8):
                    P = P + PBk[:, :, p][:, :, :, None] * \
                        jnp.swapaxes(sh[:, :, p], 2, 3)
                P0mv.append(P)
            else:
                # P1[r,b,t,v] = sum_q PB1[r,b,q,v] * sh[r,b,q,t,v]
                P = jnp.zeros((2, 8, 2, 2) + T, dtype=dtype)
                for q in range(8):
                    P = P + PBk[:, :, q][:, :, None] * sh[:, :, q]
                P1mv.append(jnp.swapaxes(P, 2, 3))           # [r,b,v,t]

    # pair: fold each P1[mv1] against W once, then contract with P0[mv0]
    T1mv = []
    for j in range(2):
        T1j = jnp.zeros((2, 8, 2, 2) + T, dtype=dtype)       # [r,a,u,t]
        for b in range(8):
            for v in range(2):
                T1j = T1j + P1mv[j][:, b, v][:, None, None] * \
                    W[b, :, v][None]
        T1mv.append(T1j)
    pair_rows = []
    for i in range(2):
        row = []
        for j in range(2):
            acc = jnp.zeros(T, dtype=dtype)
            for r in range(2):
                for t in range(2):
                    acc = acc + froot[r, t] * (
                        P0mv[i][r, :, :, t] * T1mv[j][r, :, :, t]
                    ).sum(axis=(0, 1))
            row.append(acc)
        pair_rows.append(jnp.stack(row, axis=0))
    pair = jnp.stack(pair_rows, axis=0)                      # [mv0, mv1,*T]

    accum = jnp.stack([jnp.stack([jnp.stack(wrow, axis=0)
                                  for wrow in slotrow], axis=0)
                       for slotrow in acc_g], axis=0)        # [7, 2, 2,*T]
    return b12, accum, pair
