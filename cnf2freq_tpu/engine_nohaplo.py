"""Dedicated no-haplotyping engine (the reference's "F2 with no
haplotyping" build, settings.h:60-73).

The state space is NUMGEN=2 / TYPEBITS=2: four states g = (g1<<1)|g0,
one bit per parent selecting which grandparental strand fed that
parent's transmitted allele.  NUMSHIFTS=1 (no shift modes), NUMPATHS=2
but every production probe passes flag2=-1 (doit sets f2s=-1/f2end=0
under !HAPLOTYPING, cnF2freq.cpp:5318-5323), and there are no haplotype
weights: the per-interpretation factor is a flat 0.5
(cnF2freq.cpp:1242-1251).

What makes this family structurally different from the haplotyping
numgen==2 block (engine_ng2.py) is the recursion depth:
``attopnow = (genwidth == HAPLOTYPING) || founder`` evaluates to
``genwidth == 0`` when HAPLOTYPING is false (cnF2freq.cpp:1120), and
``fixtrees`` never sets founder flags outside its HAPLOTYPING block
(cnF2freq.cpp:3116-3176) — so the emission walk descends one level
further than the haplotyping two-generation build, through the parents
(genwidth 1) into the *grandparents* by pointer (genwidth 0), where the
0.5 leaf rule ``zeropropagate || !genwidth`` applies
(cnF2freq.cpp:1229-1233).  The analysis unit is therefore the full
7-slot family [focal, p0, gp00, gp01, p1, gp10, gp11] even though the
state space only spans two meioses.

A second !HAPLOTYPING specific: the interpretation loop short-circuits —
``flag2 < f2end && (HAPLOTYPING || !ok)`` (cnF2freq.cpp:1166) — so each
node contributes its FIRST feasible interpretation only, not the sum.
Tensorized as ``where(branch0 > 0, branch0, branch1)`` at every level.

Under !HAPLOTYPING the reference's doit performs no parameter updates at
all (every update hook sits behind ``if (!full && HAPLOTYPING)``,
cnF2freq.cpp:5554), so an iteration is a pure posterior computation:
per-shift likelihoods, state posteriors, and the GENOSPROBE genotype
shares that feed the output table.  The scan contract reflects that —
haplo/infprob accumulators and turn weights are structurally zero.

Validated against the golden scalar spec run at the F2_NOHAPLO config
(tests/test_nohaplo.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .config import ModelConfig, RuntimeParams, SEXMARKER, UNKNOWN
from .hmm.family import FamilyBatch


def _match(v, sv, b, s, dtype):
    """markermiss(ZP_NONE) + the baseval/mainsecond split
    (cnF2freq.cpp:1195-1222; golden/engine.py markermiss + hit/miss
    branches).  v [B,M] int inflow (UNKNOWN allowed), sv [B,M] float
    secondary weight; (b, s) one stored channel.  Returns
    (bound value, baseval, mainsecond)."""
    unknown_in = v == UNKNOWN
    bound = jnp.where(unknown_in, b, v)
    miss = (~unknown_in) & ~((b == UNKNOWN) & (v != SEXMARKER)) & (v != b)
    base_miss = s
    msec_miss = jnp.where((s > 0) & (sv > 0), (1.0 - s) * sv, 0.0)
    eff2 = jnp.where(unknown_in & (bound != UNKNOWN),
                     jnp.ones_like(sv), sv)
    base_hit = 1.0 - s
    effms = jnp.where(b == UNKNOWN, 1.0, s)
    msec_hit = effms * eff2
    base = jnp.where(miss, base_miss, base_hit).astype(dtype)
    msec = jnp.where(miss, msec_miss, msec_hit).astype(dtype)
    return bound, base, msec


def _collapse(md, ms, ci):
    """Duplicate-allele canonicalisation (cnF2freq.cpp:1235-1240)."""
    return (md[..., 0] == md[..., 1]) & (ci | (ms[..., 0] == ms[..., 1]))


def _slot(fb: FamilyBatch, s: int):
    return fb.md[:, s], fb.ms[:, s], fb.exists[:, s]


def _gp_eval(gp, v, sv, dtype):
    """genwidth-0 leaf: first-feasible interpretation, attop fold, the
    0.5 depth rule (cnF2freq.cpp:1166, 1213-1217, 1229-1233); a missing
    grandparent contributes 1 + secondval (cnF2freq.cpp:1044-1046)."""
    md, ms, exists = gp
    outs = []
    for fp in range(2):
        _, base, msec = _match(v, sv, md[..., fp], ms[..., fp], dtype)
        outs.append((base + msec) * 0.5)
    val = jnp.where(outs[0] > 0, outs[0], outs[1])
    return jnp.where(exists[:, None], val, 1.0 + sv)


def _par_eval(par, gp0, gp1, v, sv, ci, dtype):
    """genwidth-1 node -> [B, M, 2] over the parent's state bit g: match
    each interpretation fp, weight by the duplicate collapse or the flat
    0.5 (no haploweights, cnF2freq.cpp:1242-1251), descend into BOTH
    grandparents (matched value to gp[g], second channel to gp[1-g],
    cnF2freq.cpp:1277-1336), first-feasible select over fp; a missing
    parent is 1 + sv."""
    md, ms, exists = par
    coll = _collapse(md, ms, ci)
    gps = (gp0, gp1)
    branches = []
    for fp in range(2):
        bound, base, msec = _match(v, sv, md[..., fp], ms[..., fp], dtype)
        msec2 = jnp.where(base > 0, msec / jnp.where(base > 0, base, 1.0),
                          0.0)
        s2 = ms[..., 1 - fp]
        secfac = jnp.where(s2 > 0, 1.0 - s2, 1.0).astype(dtype)
        secsec = jnp.where(s2 > 0,
                           s2 / jnp.maximum(1.0 - s2, 1e-30), 0.0)
        secmark = md[..., 1 - fp]
        e1 = [_gp_eval(g, bound, msec2, dtype) for g in gps]
        e2 = [_gp_eval(g, secmark, secsec, dtype) for g in gps]
        per_g = []
        for g in range(2):
            w = jnp.where(coll, jnp.asarray(float(fp ^ g), dtype=dtype),
                          jnp.asarray(0.5, dtype=dtype))
            per_g.append(base * w * secfac * e1[g] * e2[1 - g])
        branches.append(jnp.stack(per_g, axis=-1))
    val = jnp.where(branches[0] > 0, branches[0], branches[1])
    return jnp.where(exists[:, None, None], val, 1.0 + sv[..., None])


_G = np.arange(4)
_GBIT = [(_G >> 0) & 1, (_G >> 1) & 1]     # parent0 bit, parent1 bit


def nohaplo_branches(fb: FamilyBatch, cfg: ModelConfig,
                     ci: bool = False, dtype=jnp.float64, inval=None,
                     side: int = 0):
    """Per-interpretation emission branches [B, M, r, 4] BEFORE the
    first-feasible select, plus the allowed r range.

    inval=None is the production probe (inmarkerval UnknownMarkerVal,
    flag2=-1); an integer inval with ``side`` builds the GENOSPROBE
    sideval chain (flag = g*2 + side, flag99 = -1 ^ side,
    cnF2freq.cpp:5557-5566) — note -1^1 == -2 restricts the focal to
    interpretation 0 through the f2s/f2end decode
    (cnF2freq.cpp:1144-1149)."""
    md_f, ms_f = fb.md[:, 0], fb.ms[:, 0]
    B, M = md_f.shape[:2]
    pars = (_slot(fb, 1), _slot(fb, 4))
    gps = ((_slot(fb, 2), _slot(fb, 3)), (_slot(fb, 5), _slot(fb, 6)))
    coll_f = _collapse(md_f, ms_f, ci)

    if inval is None:
        v_in = jnp.full((B, M), UNKNOWN, dtype=md_f.dtype)
        r_range = (0, 1)
    else:
        v_in = jnp.full((B, M), inval, dtype=md_f.dtype)
        r_range = (0, 1) if side == 0 else (0,)
    sv_in = jnp.zeros((B, M), dtype=dtype)

    branches = []
    for r in r_range:
        bound, base, msec = _match(v_in, sv_in, md_f[..., r],
                                   ms_f[..., r], dtype)
        msec2 = jnp.where(base > 0, msec / jnp.where(base > 0, base, 1.0),
                          0.0)
        s2 = ms_f[..., 1 - r]
        secfac = jnp.where(s2 > 0, 1.0 - s2, 1.0).astype(dtype)
        secsec = jnp.where(s2 > 0,
                           s2 / jnp.maximum(1.0 - s2, 1e-30), 0.0)
        secmark = md_f[..., 1 - r]
        x = r ^ side                       # f2n ^ (firstpar ^ shift)
        w = jnp.where(coll_f, jnp.asarray(float(x), dtype=dtype),
                      jnp.asarray(0.5, dtype=dtype))
        p_first = _par_eval(pars[side], *gps[side], bound, msec2, ci,
                            dtype)
        p_second = _par_eval(pars[1 - side], *gps[1 - side], secmark,
                             secsec, ci, dtype)
        sub1 = p_first[..., _GBIT[side]]           # [B, M, 4]
        sub2 = p_second[..., _GBIT[1 - side]]
        branches.append((base * w * secfac)[..., None] * sub1 * sub2)
    return jnp.stack(branches, axis=2), r_range


def nohaplo_emission(fb: FamilyBatch, cfg: ModelConfig,
                     ci: bool = False, dtype=jnp.float64, inval=None,
                     side: int = 0) -> jnp.ndarray:
    """E[B, M, NS=1, 4]: first-feasible select over the focal
    interpretation (cnF2freq.cpp:1166 with HAPLOTYPING=false)."""
    br, r_range = nohaplo_branches(fb, cfg, ci=ci, dtype=dtype,
                                   inval=inval, side=side)
    if len(r_range) == 1:
        e = br[:, :, 0]
    else:
        e = jnp.where(br[:, :, 0] > 0, br[:, :, 0], br[:, :, 1])
    return e[:, :, None, :]


def nohaplo_feasibility(fb: FamilyBatch, cfg: ModelConfig,
                        ci: bool = False, dtype=jnp.float64):
    """ok[B, M, r]: is interpretation r feasible for the focal under any
    state (the fixparents okvals check: flag2 in {0, 1} pins r at the
    focal, cnF2freq.cpp:1409-1428)."""
    br, _ = nohaplo_branches(fb, cfg, ci=ci, dtype=dtype)
    return (br > 0).any(axis=-1)


def nohaplo_pair(fb: FamilyBatch, cfg: ModelConfig, W: jnp.ndarray,
                 ci: bool = False, dtype=jnp.float64):
    """Ordered-genotype posterior [B, M, 2, 2] via GENOSPROBE shares
    (sidevals, cnF2freq.cpp:5557-5566): share of allele mv on side i,
    contracted against the state posterior W [B, M, 1, 4]."""
    us = {}
    for side in range(2):
        for mv in (1, 2):
            us[(side, mv)] = nohaplo_emission(
                fb, cfg, ci=ci, dtype=dtype, inval=mv,
                side=side)[:, :, 0]              # [B, M, 4]
    shares = {}
    for side in range(2):
        den = us[(side, 1)] + us[(side, 2)]
        for mv in (1, 2):
            shares[(side, mv)] = jnp.where(
                den > 0, us[(side, mv)] / jnp.where(den > 0, den, 1.0),
                0.0)
    Wg = W[:, :, 0]                              # [B, M, 4]
    pair = jnp.stack(
        [jnp.stack([(Wg * shares[(0, i)] * shares[(1, j)]).sum(-1)
                    for j in (1, 2)], axis=-1) for i in (1, 2)], axis=-2)
    return pair


def chromosome_scan_nohaplo(fb: FamilyBatch, dists: jnp.ndarray,
                            cfg: ModelConfig, params: RuntimeParams,
                            with_infprobs: bool = True, ratemat=None,
                            with_coherence: bool = False):
    """One 4-state no-haplotyping chromosome scan with the ScanResult
    contract.  Update statistics are structurally zero (the reference
    performs no updates under !HAPLOTYPING, cnF2freq.cpp:5554); the scan
    is a posterior computation: likelihoods + genotype shares."""
    from .engine import ScanResult
    from .hmm.forward_backward import combined_loglik, forward_backward
    from .hmm.probes import posterior_weight

    dtype = fb.ms.dtype
    B, M = fb.md.shape[0], fb.md.shape[2]
    ci = cfg.correction_inference
    e = nohaplo_emission(fb, cfg, ci=ci, dtype=dtype)
    fbres = forward_backward(e, dists, cfg, params, ratemat=ratemat)
    total = combined_loglik(fbres, fb.shiftignore)
    # state posterior: the probe value exp(probe - factor) equals
    # W[g] * E[g] (posterior_weight is the emission multiplier)
    post = posterior_weight(fbres, total, fb.shiftignore) * e
    if with_infprobs:
        pair = nohaplo_pair(fb, cfg, post, ci=ci, dtype=dtype)
    else:
        pair = jnp.zeros((B, M, 2, 2), dtype=dtype)
    ns = cfg.numslots
    return ScanResult(
        total=total,
        haplo_b12=jnp.zeros((B, M, ns, 2), dtype=dtype),
        haplo_mask=jnp.zeros((B, M, ns), dtype=bool),
        inf_accum=jnp.zeros((B, M, ns, 2, 2), dtype=dtype),
        pair=pair,
        turn_weight=jnp.zeros((B, M, cfg.numturns), dtype=dtype),
        coherence=jnp.full((B, M, ns), 0.5, dtype=dtype),
        fw_pre=fbres.fw_pre, bw=fbres.bw,
        fw_pre_f=fbres.fw_pre_f, bw_f=fbres.bw_f)


def make_jitted_scan_merged_nohaplo(cfg: ModelConfig,
                                    params: RuntimeParams,
                                    num_individuals: int):
    """The no-haplotyping form of engine.make_jitted_scan_merged: the
    merged accumulators are zeros [NI, M]-shaped (no updates exist in
    this family), so the program returns the scan result plus inert
    merge outputs, keeping Driver.iterate's contract."""
    @jax.jit
    def run(fb: FamilyBatch, dists, lut, ratemat):
        res = chromosome_scan_nohaplo(fb, dists, cfg, params,
                                      ratemat=ratemat)
        M = fb.md.shape[2]
        dtype = fb.ms.dtype
        hb = jnp.zeros((num_individuals, M), dtype=dtype)
        hc = jnp.zeros((num_individuals, M), dtype=dtype)
        inf = jnp.zeros((num_individuals, M, 2, 2), dtype=dtype)
        return res, hb, hc, inf

    return run


def nohaplo_line_origin(fb: FamilyBatch, cfg: ModelConfig,
                        Wg: jnp.ndarray) -> jnp.ndarray:
    """P[b, m, c(3)]: line-origin class posterior for the deep-walk
    no-haplotyping family — the zeropropagate gstr probe
    (cnF2freq.cpp:5512; counting hook cnF2freq.cpp:1264-1266) under
    ``attopnow == (genwidth == 0)`` (cnF2freq.cpp:1120 with
    HAPLOTYPING=false), i.e. counting happens one pedigree level DEEPER
    than the haplotyping families: at the grandparent leaves, at a
    parent whose indexed grandparent is vacant, or at the focal when
    its first-branch parent is vacant (a vacant second-branch parent
    contributes no count — recursetrackpossible returns without the
    hook, cnF2freq.cpp:1044-1046).

    Under zero-propagation the walk is value-unconstrained, so each
    node's first-feasible interpretation (the !HAPLOTYPING
    short-circuit, cnF2freq.cpp:1166) reduces to its LOCAL feasibility
    baseval = 1 - markersure[f2n] > 0; interpretation 0 wins whenever
    markersure[0] < 1 — exact for every dataset this framework
    produces (markersure is an error probability < 1).

    Wg: [B, M, 4] posterior state mass (posterior_weight * emission,
    the probe value exp(probe - total))."""
    md_f, ms_f = fb.md[:, 0], fb.ms[:, 0]
    dtype = Wg.dtype

    def sel(ms):
        """First-feasible raw interpretation of one node."""
        return jnp.where(ms[..., 0] < 1.0, 0, 1)

    def picked2(md, ms):
        r = sel(ms)
        return jnp.take_along_axis(md, r[..., None],
                                   axis=-1)[..., 0] == 2   # [B, M]

    sides = []
    for k in range(2):
        ps = cfg.parent_slot(k)
        md_p, ms_p = fb.md[:, ps], fb.ms[:, ps]
        ex_p = fb.exists[:, ps]
        p_cnt = picked2(md_p, ms_p)
        per_bit = []
        for j in range(2):
            gs = cfg.grandparent_slot(k, j)
            g_cnt = picked2(fb.md[:, gs], fb.ms[:, gs])
            cj = jnp.where(fb.exists[:, gs][:, None], g_cnt, p_cnt)
            per_bit.append(cj)
        side_cnt = jnp.stack(per_bit, axis=-1)             # [B, M, 2]
        if k == 0:
            # vacant first-branch parent: the focal itself counts
            focal_cnt = picked2(md_f, ms_f)
            side_cnt = jnp.where(ex_p[:, None, None], side_cnt,
                                 focal_cnt[..., None])
        else:
            side_cnt = jnp.where(ex_p[:, None, None], side_cnt, False)
        sides.append(side_cnt)

    # state g = (g1 << 1) | g0: parent k's strand follows state bit k
    c = sides[0][..., _GBIT[0]].astype(jnp.int32) + \
        sides[1][..., _GBIT[1]].astype(jnp.int32)          # [B, M, 4]
    classes = jax.nn.one_hot(jnp.minimum(c, 2), 3, dtype=dtype)
    P = jnp.einsum("bmg,bmgc->bmc", Wg, classes)
    tot = P.sum(axis=-1, keepdims=True)
    return jnp.where(tot > 0, P / jnp.where(tot > 0, tot, 1.0), 0.0)
