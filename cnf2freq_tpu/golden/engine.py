"""Golden scalar engine: an executable specification of the reference HMM.

This is a deliberately *slow, plain-Python* re-statement of the semantics of
the reference's compute core — the ``trackpossible`` emission recursion
(cnF2freq.cpp:1075-1359), ``adjustprobs`` (cnF2freq.cpp:1579-1670), the
forward–backward sweeps of ``realanalyze``/``initfwbw``
(cnF2freq.cpp:2074-2418) and the probe evaluation of the fb ``quickanalyze``
(cnF2freq.cpp:1936-2032).  The production engine is validated against
this module; this module is validated against hand-computed cases and
invariants in ``tests/``.

It is NOT a port of the C++ (no caches, no threading, no extended-exponent
plumbing) — just the mathematical content, written for clarity.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import (GENOS, GENOSPROBE, HAPLOS, HOMOZYGOUS, MINFACTOR,
                      ModelConfig, RuntimeParams, SEXMARKER, UNKNOWN,
                      ZP_NO_EQUIVALENCE, ZP_NONE, ZP_PROPAGATE)
from ..pedigree import Individual, Pedigree


def upflagit(flag: int, parnum: int, genwidth: int) -> int:
    """Extract the sub-flag for one parental branch (cnF2freq.cpp:321-329)."""
    if flag < 0:
        return flag
    if genwidth < 1:
        return 0
    flag >>= parnum * (genwidth - 1)
    flag &= (1 << (genwidth - 1)) - 1
    return flag


def markermiss(zeroprop: int, a: int, b: int) -> Tuple[bool, int]:
    """Admissibility of value ``a`` against stored allele ``b``
    (cnF2freq.cpp:303-316).  Returns (miss, possibly-bound a)."""
    if zeroprop == ZP_PROPAGATE:
        return False, a
    if a == UNKNOWN:
        if zeroprop == ZP_NONE:
            a = b
        return False, a
    if b == UNKNOWN and a != SEXMARKER:
        return False, a
    return a != b, a


@dataclasses.dataclass
class Hooks:
    """Accumulators filled by update-mode emission walks; the golden
    equivalent of the threadprivate ``haplos``/``infprobs`` stores
    (cnF2freq.cpp:379-380)."""

    haplos: Dict[int, List[float]] = dataclasses.field(default_factory=dict)
    infprobs: Dict[Tuple[int, int, int], float] = \
        dataclasses.field(default_factory=dict)

    def add_haplo(self, n: int, f2n: int, v: float):
        self.haplos.setdefault(n, [0.0, 0.0])[f2n] += v

    def add_infprob(self, n: int, side: int, markerval: int, v: float):
        key = (n, side, markerval)
        self.infprobs[key] = self.infprobs.get(key, 0.0) + v


class GoldenEngine:
    """Scalar emission + forward-backward evaluation for one pedigree."""

    def __init__(self, ped: Pedigree, params: Optional[RuntimeParams] = None):
        self.ped = ped
        self.cfg: ModelConfig = ped.config
        self.params = params or RuntimeParams()
        self.correction_inference = False
        # RELSKEWSTATES transition replay switch.  False (default):
        # relscore = (relhaplo, 1-relhaplo) on every interval — which
        # round 5's re-reading of the reference shows IS its behavior
        # on whole intervals (``iter == tofind`` compares the
        # intra-interval segment index against the split flag: 0 == 0
        # on every ordinary interval, cnF2freq.cpp:2255-2265,
        # 2343-2346).  True: free mixing (factor 1, the hypothetical
        # never-fires reading round 4 recorded) — kept as a replay
        # probe for the trace experiments in docs/ROUND5_NOTES.md.
        self.relskew_reference_transition = False
        self.hooks = Hooks()
        self._ecache = {}

    def clear_cache(self):
        """Invalidate cached emissions after mutating pedigree data."""
        self._ecache.clear()

    # ------------------------------------------------------------------
    # Emission recursion
    # ------------------------------------------------------------------
    def trackpossible(self, ind: Individual, update: int, zeroprop: int,
                      inval: int, secondval: float, marker: int, flag: int,
                      flag99: int, localshift: int, genwidth: int,
                      updateval: float = 0.0,
                      gstr: Optional[List[int]] = None) -> float:
        cfg = self.cfg
        rootgen = genwidth == (1 << (cfg.numgen - 1))
        attopnow = (not (update & HOMOZYGOUS)) and \
            ((genwidth == int(cfg.haplotyping)) or ind.founder)

        upflag = flag >> 1
        upshift = localshift >> 1
        upflag2 = -1
        f2s, f2end = 0, 2
        numflag2gen = cfg.numgen if cfg.haplotyping else 1
        if flag99 != -1 and (genwidth >> (cfg.numgen - numflag2gen)) > 0:
            upflag2 = flag99 >> 1
            f2s = flag99 & 1
            f2end = f2s + 1

        firstpar = flag & 1
        md = ind.markerdata[marker]
        ms = ind.markersure[marker]
        ok = 0.0

        # Selfing: at the root generation a nonzero selfval collapses the
        # observed genotype into a synthetic homozygous-by-descent pair
        # carried on interpretation slot (selfval>>1)^f2n
        # (cnF2freq.cpp:1122-1189)
        selfval = (flag >> (cfg.typebits + 1)) & 3
        selfing_now = cfg.selfing and rootgen and selfval != 0

        # RELSKEWSTATES: the extra state bit pins the focal's root
        # interpretation slot (cnF2freq.cpp:1127, 1148-1154)
        if cfg.relskewstates and rootgen:
            relskewval = flag >> (cfg.typebits + cfg.selfbits + 1)
            f2s = max(f2s, relskewval)
            f2end = min(f2end, relskewval + 1)

        for flag2 in range(f2s, f2end):
            if not cfg.haplotyping and ok:
                break
            f2n = flag2 & 1

            if selfing_now:
                selfindex = (selfval >> 1) ^ f2n
                selfmarker = [UNKNOWN, UNKNOWN]
                selfsure = [0.0, 0.0]
                miss_fs, bound_first = markermiss(ZP_NONE, int(md[0]),
                                                  int(md[1]))
                if not miss_fs:
                    selfmarker[selfindex] = bound_first
                    selfsure[selfindex] = \
                        1.0 - (1.0 - ms[0]) * (1.0 - ms[1])
                else:
                    selfmarker[selfindex] = int(md[1])
                    if ms[0] == 0:
                        return 0.0
                    selfsure[selfindex] = 1.0 - ms[0] * (1.0 - ms[1])
                the_md, the_ms = selfmarker, selfsure
            else:
                the_md, the_ms = md, ms

            allthesame = the_md[0] == the_md[1]
            realf2n = f2n

            miss, markerval = markermiss(zeroprop, inval, int(the_md[f2n]))
            if miss:
                baseval = the_ms[f2n]
                mainsecond = (1.0 - the_ms[f2n]) * secondval \
                    if (the_ms[f2n] and secondval) else 0.0
            else:
                effsecond = 1.0 if (inval == UNKNOWN and
                                    markerval != UNKNOWN) else secondval
                baseval = 1.0 - the_ms[f2n]
                effmarkersure = 1.0 if the_md[f2n] == UNKNOWN \
                    else the_ms[f2n]
                mainsecond = effmarkersure * effsecond

            # NOTE: the reference writes `update & (GENOS || GENOSPROBE)`,
            # which in C++ collapses to `update & 1` == `update & HAPLOS`
            # (cnF2freq.cpp:1213).  Preserved faithfully.
            if attopnow or (update & HAPLOS):
                baseval += mainsecond
                mainsecond = 0.0
            elif mainsecond:
                mainsecond /= baseval

            doupdatehaplo = True
            f2n ^= (firstpar ^ localshift) & 1

            # duplicate-allele collapse (cnF2freq.cpp:1229-1240): a
            # selfing-collapsed root ALWAYS canonicalises
            # (``|| selfingNOW``), and RELSKEWSTATES disables the
            # collapse at the root (``!relskewingNOW``) — the coherence
            # bit needs both interpretations reachable
            relskewing_now = cfg.relskewstates and rootgen
            if zeroprop or not genwidth:
                baseval *= 0.5
                doupdatehaplo = False
            elif ((not relskewing_now) and allthesame and
                  (self.correction_inference or
                   the_ms[0] == the_ms[1])) or selfing_now:
                baseval *= 1.0 if f2n else 0.0
                doupdatehaplo = False
            else:
                if cfg.haplotyping:
                    baseval *= abs((1.0 if f2n else 0.0) -
                                   ind.haploweight[marker])
                else:
                    baseval *= 0.5

            par = self.ped.by_id(ind.pars[firstpar]) if ind.pars[firstpar] \
                else None
            if baseval and (attopnow or par is None):
                if zeroprop and gstr is not None:
                    gstr[0] += int(the_md[realf2n] == 2)

            if baseval and not attopnow:
                numshiftgen = cfg.numshiftgen
                gw_shift = genwidth >> (cfg.numgen - numshiftgen) \
                    if numshiftgen else 0
                gw_flag2 = genwidth >> (cfg.numgen - numflag2gen)

                def subtrack(pnum: int, val: int, sval: float) -> float:
                    p = self.ped.by_id(ind.pars[pnum]) if ind.pars[pnum] \
                        else None
                    if p is None:
                        return 1.0 + sval
                    return self.trackpossible(
                        p, update & ~HOMOZYGOUS, zeroprop, val, sval, marker,
                        upflagit(upflag, pnum, genwidth),
                        upflagit(upflag2, pnum, gw_flag2),
                        upflagit(upshift, pnum, gw_shift),
                        genwidth >> 1, updateval, gstr)

                sub1 = subtrack(firstpar, markerval, mainsecond)

                if (not zeroprop or rootgen) and not (update & GENOS):
                    secmark = int(the_md[1 - realf2n])
                    secsecond = 0.0
                    if not (update & HOMOZYGOUS):
                        if the_ms[1 - realf2n]:
                            baseval *= 1.0 - the_ms[1 - realf2n]
                            secsecond = the_ms[1 - realf2n] / \
                                (1.0 - the_ms[1 - realf2n])
                    else:
                        if markerval != secmark:
                            if secmark != UNKNOWN:
                                baseval *= the_ms[1 - realf2n]
                            secmark = markerval
                        else:
                            baseval *= 1.0 - the_ms[1 - realf2n]
                    baseval *= subtrack(1 - firstpar, secmark, secsecond)
                baseval *= sub1

            if baseval:
                ok += baseval
                if (update & HAPLOS) and doupdatehaplo:
                    self.hooks.add_haplo(ind.n, f2n, updateval)
                if update & GENOS:
                    self.hooks.add_infprob(ind.n, realf2n, markerval,
                                           updateval)
        return ok

    def calltrackpossible(self, ind: Individual, marker: int, genotype: int,
                          flag2: int, shift: int, update: int = 0,
                          updateval: float = 0.0) -> float:
        """cnF2freq.cpp:1380-1385."""
        return self.trackpossible(ind, update, ZP_NONE, UNKNOWN, 0.0, marker,
                                  genotype * 2, flag2, shift,
                                  1 << (self.cfg.numgen - 1), updateval)

    # ------------------------------------------------------------------
    # Emission vectors / adjustprobs
    # ------------------------------------------------------------------
    def emission(self, ind: Individual, marker: int, shift: int,
                 flag2: int = -1) -> np.ndarray:
        """Per-state emission weights; flag2==-1 sums over all paths."""
        key = (ind.n, marker, shift, flag2, self.correction_inference)
        hit = self._ecache.get(key)
        if hit is not None:
            return hit
        cfg = self.cfg
        # flattened states: selfval * numtypes + base — identical to the
        # reference's packed layout (self bits above TYPEBITS, settings.h:25)
        out = np.array([
            self.calltrackpossible(ind, marker, g, flag2, shift)
            for g in range(cfg.numstates)])
        self._ecache[key] = out
        return out

    def adjustprobs(self, ind: Individual, probs: np.ndarray, marker: int,
                    factor: float, shift: int, flag2: int = -1
                    ) -> Tuple[np.ndarray, float]:
        """cnF2freq.cpp:1579-1670 (always ruleout=true at HEAD)."""
        probs = np.where(probs < 1e-300, 0.0, probs)
        probs = probs * self.emission(ind, marker, shift, flag2)
        s = probs.sum()
        if s <= 0:
            return probs, MINFACTOR
        return probs / s, factor + math.log(s)

    # ------------------------------------------------------------------
    # Transition
    # ------------------------------------------------------------------
    def recombprec(self, dist: float) -> np.ndarray:
        """Per-xor-mask multi-bit transition weights
        (cnF2freq.cpp:2276-2340)."""
        cfg = self.cfg
        genrec = self.params.genrec
        rec = [[0.5 * (1.0 - math.exp(genrec[g] * dist)) for _ in range(2)]
               for g in range(2)]
        out = np.ones(cfg.numtypes)
        for t in range(cfg.typebits):
            sex = cfg.typesexes[t]
            gen = cfg.typegens[t]
            for idx in range(cfg.numtypes):
                stay = not ((idx >> t) & 1)
                out[idx] *= (1.0 - rec[gen][sex]) if stay else rec[gen][sex]
        return out

    def selfprec(self, dist: float, selfgen: int) -> np.ndarray:
        """3x3 HBD-status transition factor (cnF2freq.cpp:2316-2327):
        row = from-selfval, column = to-selfval."""
        r2 = 0.5 * (1.0 - math.exp(selfgen * self.params.genrec[2] * dist))
        sp = np.zeros((3, 3))
        sp[0][1] = sp[0][2] = r2
        sp[0][0] = 1.0 - 2.0 * r2
        sp[1][0] = sp[0][1] * 2.0 / ((1 << selfgen) - 1) if selfgen else 1.0
        sp[1][2] = sp[1][0] * sp[0][1]
        sp[2][0] = sp[1][0]
        sp[2][1] = sp[1][2]
        sp[2][2] = sp[1][1] = 1.0 - sp[1][0] - sp[1][2]
        return sp

    def transition(self, probs: np.ndarray, dist: float,
                   selfgen: int = 0, relh: float = 0.5) -> np.ndarray:
        if dist <= 0:
            return probs
        rp = self.recombprec(dist)
        cfg = self.cfg
        S = cfg.numstates
        base = cfg.numtypes
        out = np.zeros_like(probs)
        if cfg.selfing:
            sp = self.selfprec(dist, selfgen)
            for frm in range(S):
                if probs[frm] <= 0:
                    continue
                for to in range(S):
                    out[to] += probs[frm] * rp[(frm ^ to) & (base - 1)] \
                        * sp[frm // base][to // base]
            return out
        if cfg.relskewstates:
            # relscore factor on the coherence bit (cnF2freq.cpp:2343-2362)
            relscore = (1.0, 1.0) if self.relskew_reference_transition \
                else (relh, 1.0 - relh)
            for frm in range(S):
                if probs[frm] <= 0:
                    continue
                for to in range(S):
                    x = frm ^ to
                    out[to] += probs[frm] * rp[x & (base - 1)] \
                        * relscore[(x >> cfg.typebits) & 1]
            return out
        for frm in range(S):
            if probs[frm] <= 0:
                continue
            for to in range(S):
                out[to] += probs[frm] * rp[frm ^ to]
        return out

    def selfing_prior(self, ind: Individual) -> np.ndarray:
        """Initial state distribution for a selfed individual
        (selfingfactors, cnF2freq.cpp:2050-2063): HBD probability
        1 - 1/2**selfgen split over the two HBD-carrier states."""
        cfg = self.cfg
        selfgen = max(ind.gen - 2, 0)
        f0 = 1.0 / (1 << selfgen)
        factors = np.array([f0, (1.0 - f0) * 0.5, (1.0 - f0) * 0.5])
        return cfg.evengen * np.repeat(factors, cfg.numtypes)

    # ------------------------------------------------------------------
    # Forward-backward store (initfwbw, cnF2freq.cpp:2074-2120)
    # ------------------------------------------------------------------
    def fwbw(self, ind: Individual, startmark: int, endmark: int, shift: int):
        """Returns dict with fw_pre, fw_post, bw arrays [M, S] plus factor
        arrays [M] for markers startmark..endmark inclusive."""
        cfg = self.cfg
        M = endmark - startmark + 1
        S = cfg.numstates
        selfgen = max(ind.gen - 2, 0) if cfg.selfing else 0
        fw_pre = np.zeros((M, S))
        fw_post = np.zeros((M, S))
        bw = np.zeros((M, S))
        fw_pre_f = np.zeros(M)
        fw_post_f = np.zeros(M)
        bw_f = np.zeros(M)

        def relh(j):
            """relhaplo at the left marker of interval (j, j+1)
            (relscore, cnF2freq.cpp:2345-2346)."""
            if not cfg.relskewstates or ind.relhaplo is None:
                return 0.5
            return float(ind.relhaplo[j])

        probs = self.selfing_prior(ind) if cfg.selfing \
            else np.full(S, cfg.evengen)
        factor = 0.0
        for j in range(startmark, endmark + 1):
            i = j - startmark
            fw_pre[i], fw_pre_f[i] = probs, factor
            probs, factor = self.adjustprobs(ind, probs, j, factor, shift)
            fw_post[i], fw_post_f[i] = probs, factor
            if j < endmark:
                dist = self.ped.markerposes[j + 1] - self.ped.markerposes[j]
                probs = self.transition(probs, dist, selfgen, relh(j))

        probs = np.ones(S)
        factor = 0.0
        bw[M - 1], bw_f[M - 1] = probs, factor
        for j in range(endmark - 1, startmark - 1, -1):
            i = j - startmark
            probs, factor = self.adjustprobs(ind, probs, j + 1, factor, shift)
            dist = self.ped.markerposes[j + 1] - self.ped.markerposes[j]
            probs = self.transition(probs, dist, selfgen, relh(j))
            bw[i], bw_f[i] = probs, factor
        return dict(fw_pre=fw_pre, fw_post=fw_post, bw=bw,
                    fw_pre_f=fw_pre_f, fw_post_f=fw_post_f, bw_f=bw_f)

    def total_loglik(self, ind: Individual, startmark: int, endmark: int,
                     shift: int) -> float:
        """NONESTOP doanalyze value == final forward factor
        (cnF2freq.cpp:1959-2018 with nonestop)."""
        fb = self.fwbw(ind, startmark, endmark, shift)
        return fb["fw_post_f"][-1]

    def probe(self, ind: Individual, fb: dict, startmark: int, q: int, g: int,
              flag2: int, shift: int) -> float:
        """classicstop probe at marker q, state g, path flag2
        (quickanalyze fb combine, cnF2freq.cpp:1936-2018)."""
        i = q - startmark
        probs = fb["fw_pre"][i].copy()
        factor = fb["fw_pre_f"][i]
        probs, factor = self.adjustprobs(ind, probs, q, factor, shift, flag2)
        if factor <= MINFACTOR:
            return MINFACTOR
        val = probs[g] * fb["bw"][i][g]
        if val <= 0:
            return MINFACTOR
        return factor + fb["bw_f"][i] + math.log(val)

    def turn_probe(self, ind: Individual, fbs: dict, startmark: int, q: int,
                   turn: int, shift: int) -> float:
        """aroundturner probe: likelihood of flipping the turn-masked
        family members' phases from marker q on (cnF2freq.cpp:5708-5724
        evaluation path; see aroundturner cnF2freq.cpp:498-554)."""
        cfg = self.cfg
        tstate = turn & cfg.turn_state_mask
        sflip = cfg.turn_shift_flip(turn)
        fb_here = fbs[shift]
        fb_flip = fbs[shift ^ sflip]
        i = q - startmark
        val = 0.0
        # turn masks only touch base-state bits (aroundturner keeps the
        # selfing/relskew bits fixed: turn & 54, cnF2freq.cpp:504-515),
        # so the xor walks within each extended-value block
        for gg in range(cfg.numstates):
            val += fb_here["fw_post"][i][gg] * fb_flip["bw"][i][gg ^ tstate]
        if val <= 0:
            return MINFACTOR
        return fb_here["fw_post_f"][i] + fb_flip["bw_f"][i] + math.log(val)
