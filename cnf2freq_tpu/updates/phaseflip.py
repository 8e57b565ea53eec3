"""Native phase-flip optimiser.

The reference encodes, per marker, one weighted clause per family flip
pattern and ships the lot to an external toulbar2 MaxSAT subprocess, then
extracts flip cliques and applies the best candidate per chromosome
(cnF2freq.cpp:4742-5183, 5759-6181).  Here the same objective — pick a set
of individuals whose phase is inverted from some marker onward, maximising
the summed per-family turn log-likelihood gains — is solved natively:

* per-family pattern scores come straight from the on-device turn tensors
  (probes.turn_scores);
* the per-marker joint optimisation over shared individuals is solved
  exactly by enumeration on small connected components and by iterated
  conditional modes on large ones;
* candidate cliques across markers keep the reference's dominance/merge
  semantics in simplified form (disjoint covers combine, best total wins).

No subprocesses, no temp files; everything here is host-side numpy on tiny
arrays (the heavy likelihood work already happened on device).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..config import ModelConfig
from ..pedigree import Pedigree

WEIGHT_CLAMP_LO = -1_000_000.0
WEIGHT_CLAMP_HI = 25_000.0


@dataclasses.dataclass
class FamilyClauses:
    """One focal individual's clause table at one chromosome."""

    focal: int
    members: Tuple[int, ...]     # variable ids per turn bit (0 = unused)
    exists: Tuple[bool, ...]     # turn bit participates (dedup'd)
    turn_allowed: np.ndarray     # [T] canonical turn masks
    weights: np.ndarray          # [M, T] clause weights (log-gain units)


def family_variables(ped: Pedigree, focal: int) -> Tuple[Tuple[int, ...],
                                                         Tuple[bool, ...]]:
    """Turn-bit -> individual mapping with first-occurrence dedup
    (fillcandsexists, cnF2freq.cpp:4753-4822).  Bit order for numgen==3:
    parent0, gp00, gp01, parent1, gp10, gp11, focal; for numgen==2:
    parent0, parent1, focal (the last turn bit is always the focal,
    aroundturner cnF2freq.cpp:504-521)."""
    cfg = ped.config
    slots = ped.family_slots(focal)
    if cfg.numgen == 3:
        order = [cfg.parent_slot(0), cfg.grandparent_slot(0, 0),
                 cfg.grandparent_slot(0, 1), cfg.parent_slot(1),
                 cfg.grandparent_slot(1, 0), cfg.grandparent_slot(1, 1)]
    else:
        order = [cfg.parent_slot(0), cfg.parent_slot(1)]
    nbits = cfg.turnbits
    seen = {focal}
    members = [0] * nbits
    exists = [False] * nbits
    members[nbits - 1] = focal
    exists[nbits - 1] = True
    for bit, slot in enumerate(order):
        sid = slots[slot]
        if sid and sid not in seen:
            seen.add(sid)
            members[bit] = sid
            exists[bit] = True
        elif sid:
            members[bit] = sid   # present but deduplicated
    return tuple(members), tuple(exists)


def pattern_scores(clauses: FamilyClauses) -> Tuple[np.ndarray, np.ndarray,
                                                    List[int]]:
    """Collapse turn masks to existing-bit patterns.

    Returns (S[M, P], patterns[P] -> bit masks over the family's variable
    list, varlist).  Multiple turn masks sharing an existing-bit pattern
    sum their weights — the reference's multi-clause falsification
    behaviour (computesumweight, cnF2freq.cpp:4824-4861)."""
    varbits = [b for b in range(len(clauses.exists))
               if clauses.exists[b]]
    varlist = [clauses.members[b] for b in varbits]
    P = 1 << len(varbits)
    M, T = clauses.weights.shape
    t_ = np.arange(T)
    pat_of_turn = np.zeros(T, dtype=np.int64)
    for i, b in enumerate(varbits):
        pat_of_turn |= ((t_ >> b) & 1) << i
    S = np.zeros((M, P))
    np.add.at(S.T, pat_of_turn[clauses.turn_allowed],
              clauses.weights[:, clauses.turn_allowed].T)
    # patterns no canonical turn mask can produce (they would flip an
    # empty/ignored member) are infeasible, not zero-cost
    reachable = np.zeros(P, dtype=bool)
    reachable[pat_of_turn[clauses.turn_allowed]] = True
    S = np.where(reachable[None, :], S, -np.inf)
    return S, np.arange(P), varlist


def pattern_scores_batched(exists: Tuple[bool, ...],
                           turn_allowed_mask: np.ndarray,
                           weights: np.ndarray
                           ) -> Tuple[np.ndarray, List[int]]:
    """pattern_scores for every family sharing an (exists, turn-mask)
    configuration at once: one [T, P] one-hot matmul over the stacked
    clause weights instead of per-family np.add.at loops.

    weights: [Bg, M, T].  Returns (S [Bg, M, P] with unreachable
    patterns at -inf, varbits)."""
    varbits = [b for b in range(len(exists)) if exists[b]]
    T = weights.shape[-1]
    P = 1 << len(varbits)
    t_ = np.arange(T)
    pat = np.zeros(T, dtype=np.int64)
    for i, b in enumerate(varbits):
        pat |= ((t_ >> b) & 1) << i
    tmat = np.zeros((T, P), dtype=weights.dtype)
    tmat[t_[turn_allowed_mask], pat[turn_allowed_mask]] = 1.0
    S = weights @ tmat
    reachable = np.zeros(P, dtype=bool)
    reachable[pat[turn_allowed_mask]] = True
    return np.where(reachable[None, None, :], S, -np.inf), varbits


def make_flip_scorer():
    """Device-side clause scoring: clamp + relskew adjustment + pattern
    sums + top-k marker selection in one jitted program, so only [B, k]
    score slices cross the host link instead of the [B, M, T] turn-weight
    tensor.

    Math parity with the host forms (apply_skewterms in updates/scatter,
    pattern_scores_batched) is pinned by tests/test_scatter.py."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    @partial(jax.jit, static_argnames=("k", "with_skew", "halo",
                                       "compress"))
    def score(parts, pat, allowed, hw, rh, hb, hc, desc, tsel,
              k: int, with_skew: bool, halo: bool = False,
              compress: bool = False):
        """parts: tuple of [Bi, M, T] turn-weight chunks; pat [B, T]
        per-family pattern index of each turn; allowed [B, T];
        hw/rh/hb/hc [B, M] skew inputs — or [B, M+1] with halo=True,
        where the extra right column supplies the cross-boundary
        neighbor so every one of the M markers gets its exact skew term
        (marker-blocked scoring of interior blocks); desc [B]; tsel [T].
        Returns (idx [k] marker indices, mg [k] total gains,
        gains [B, k], S [B, k, P])."""
        W = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)
        dtype = W.dtype
        W = jnp.clip(jnp.nan_to_num(W, nan=WEIGHT_CLAMP_LO,
                                    posinf=WEIGHT_CLAMP_HI,
                                    neginf=WEIGHT_CLAMP_LO),
                     WEIGHT_CLAMP_LO, WEIGHT_CLAMP_HI)
        B, M, T = W.shape

        if with_skew:
            # calcskewterms clause adjustment (cnF2freq.cpp:4469-4531,
            # 5929-5959); same arithmetic as scatter.apply_skewterms
            Mi = M if halo else M - 1
            tiny = jnp.asarray(1e-323 if dtype == jnp.float64 else 1e-38,
                               dtype=dtype)

            def slog(x):
                return jnp.log(jnp.maximum(x, tiny))

            skew = jnp.zeros((B, Mi), dtype=dtype)
            rhs = rh[:, :Mi]
            lrh, l1rh = slog(rhs), slog(1 - rhs)
            for ix in range(2):
                w_ = hw[:, 1 - ix:Mi + 1 - ix]
                wo = hw[:, ix:Mi + ix]
                lw, l1w = slog(w_), slog(1 - w_)
                lo_, l1o = slog(wo), slog(1 - wo)
                val = wo
                now = (w_ * val * (lrh + lw + lo_) +
                       (1 - w_) * (1 - val) * (lrh + l1w + l1o) +
                       w_ * (1 - val) * (l1rh + lw + l1o) +
                       (1 - w_) * val * (l1rh + l1w + lo_))
                then = ((1 - w_) * val * (lrh + l1w + lo_) +
                        w_ * (1 - val) * (lrh + lw + l1o) +
                        (1 - w_) * (1 - val) * (l1rh + l1w + l1o) +
                        w_ * val * (l1rh + lw + lo_))
                skew = skew - (then - now)
                hcx = hc[:, ix:Mi + ix]
                hbx = hb[:, ix:Mi + ix]
                gonext = jnp.where(hcx > 0,
                                   hbx / jnp.maximum(hcx, tiny), 0.0)
                skew = skew + jnp.where(
                    (hcx > 0) & ((gonext - w_) * (w_ - 0.5) < 0),
                    25000.0, 0.0)
            w = skew * 0.5
            w = jnp.where(jnp.isfinite(w), w, jnp.sign(w) * 25000.0)
            w = jnp.clip(w, -25000.0, 25000.0) * desc[:, None]
            wpad = w if Mi == M else jnp.concatenate(
                [w, jnp.zeros((B, M - Mi), dtype=dtype)], axis=1)
            W = W - wpad[:, :, None] * tsel[None, None, :].astype(dtype)

        onehot = jax.nn.one_hot(pat, T, dtype=dtype) * \
            allowed[..., None].astype(dtype)                  # [B, T, P]
        S = jnp.einsum("bmt,btp->bmp", W, onehot)
        reach = onehot.sum(axis=1) > 0                        # [B, P]
        neginf = jnp.asarray(-jnp.inf, dtype=dtype)
        S = jnp.where(reach[:, None, :], S, neginf)
        gains = S.max(axis=2) - S[:, :, 0]                    # [B, M]
        mg = jnp.where(gains > 1e-12, gains, 0.0).sum(axis=0)
        mg_top, idx = jax.lax.top_k(mg, k)
        S_top = jnp.take(S, idx, axis=1)
        g_top = jnp.take(gains, idx, axis=1)
        if compress:
            # halve the [B, k, P] readback over slow host links: the
            # pattern sums only rank flip candidates, bf16's ~3 decimal
            # digits keep the component solve's decisions (f32-path
            # drivers only; the f64 CPU path stays exact)
            S_top = S_top.astype(jnp.bfloat16)
            g_top = g_top.astype(jnp.bfloat16)
        return idx, mg_top, g_top, S_top

    return score


def _components(fams: Sequence[Tuple[List[int], np.ndarray]]
                ) -> List[List[int]]:
    """Connected components of families sharing variables."""
    parent: Dict[int, int] = {}

    def find(x):
        while parent.setdefault(x, x) != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for fi, (vars_, _) in enumerate(fams):
        for v in vars_[1:]:
            union(vars_[0], v)
    groups: Dict[int, List[int]] = {}
    for fi, (vars_, _) in enumerate(fams):
        groups.setdefault(find(vars_[0]), []).append(fi)
    return list(groups.values())


def _solve_component_native(lib, fam_masks, n: int,
                            exhaustive_limit: int, icm_restarts: int
                            ) -> Optional[np.ndarray]:
    """One component through the C++ core (native/flipsolve.cc, v2 ABI —
    byte-vector assignment, no component-size limit).  Returns a bool[n]
    assignment, or None when inputs exceed the ABI."""
    import ctypes
    fam_nv = np.array([len(pos) for pos, _ in fam_masks], dtype=np.int32)
    if (fam_nv > 16).any():
        return None
    vpos = np.concatenate([pos for pos, _ in fam_masks]).astype(np.int32) \
        if fam_masks else np.zeros(0, np.int32)
    scores = np.concatenate([np.ascontiguousarray(S, dtype=np.float64)
                             for _, S in fam_masks])
    lens = np.array([len(S) for _, S in fam_masks], dtype=np.int64)
    s_off = np.zeros(len(fam_masks), dtype=np.int64)
    if len(lens) > 1:
        s_off[1:] = np.cumsum(lens[:-1])
    out_vec = np.zeros(n, dtype=np.uint8)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    lib.flip_solve_component_v2(
        np.int32(n), np.int32(len(fam_masks)),
        ptr(fam_nv, ctypes.c_int32), ptr(vpos, ctypes.c_int32),
        ptr(s_off, ctypes.c_int64), ptr(scores, ctypes.c_double),
        np.int32(exhaustive_limit), np.int32(icm_restarts), np.int32(12),
        ctypes.c_uint64(0x9E3779B97F4A7C15), ptr(out_vec, ctypes.c_uint8))
    return out_vec.astype(bool)


def solve_marker(fams: Sequence[Tuple[List[int], np.ndarray]],
                 exhaustive_limit: int = 13, icm_restarts: int = 2,
                 rng: Optional[np.random.Generator] = None,
                 use_native: bool = True) -> Dict[int, bool]:
    """Best joint flip assignment for one marker.

    fams: per family (variable ids, score-per-pattern vector S[P]).
    Returns {individual: flipped} for flipped individuals only.

    The search runs in the C++ core when the toolchain is available
    (native/flipsolve.cc; wider exhaustive window), with this function's
    pure-Python body as the fallback."""
    rng = rng or np.random.default_rng(0)
    assign: Dict[int, bool] = {}
    lib = None
    if use_native:
        from ..native import load_flipsolve
        lib = load_flipsolve()
    for comp in _components(fams):
        vset = sorted({v for fi in comp for v in fams[fi][0]})
        vidx = {v: i for i, v in enumerate(vset)}
        n = len(vset)
        fam_masks = []
        for fi in comp:
            vars_, S = fams[fi]
            fam_masks.append((np.array([vidx[v] for v in vars_]), S))
        vec = solve_component(fam_masks, n, exhaustive_limit=exhaustive_limit,
                              icm_restarts=icm_restarts, rng=rng, lib=lib,
                              use_native=use_native)
        for v, i in vidx.items():
            if vec[i]:
                assign[v] = True
    return assign


def solve_component(fam_masks, n: int, exhaustive_limit: int = 13,
                    icm_restarts: int = 2,
                    rng: Optional[np.random.Generator] = None,
                    lib=None, use_native: bool = True) -> np.ndarray:
    """Best joint assignment for one connected component.

    fam_masks: per family (component-local variable positions, score
    vector S[P]).  Returns bool[n]."""
    rng = rng or np.random.default_rng(0)
    if lib is None and use_native:
        from ..native import load_flipsolve
        lib = load_flipsolve()
    if lib is not None:
        vec = _solve_component_native(
            lib, fam_masks, n, max(exhaustive_limit, 20), icm_restarts)
        if vec is not None:
            return vec
    if n <= exhaustive_limit:
        best_a, best_score = 0, -np.inf
        for a in range(1 << n):
            sc = 0.0
            for pos, S in fam_masks:
                p = 0
                for i, vp in enumerate(pos):
                    if (a >> vp) & 1:
                        p |= 1 << i
                sc += S[p]
            if sc > best_score:
                best_score, best_a = sc, a
        return np.array([(best_a >> i) & 1 for i in range(n)], dtype=bool)
    # ICM with a var -> families index so each coordinate update only
    # touches its own families
    byvar = [[] for _ in range(n)]
    for fi2, (pos, S) in enumerate(fam_masks):
        for vp in set(pos.tolist()):
            byvar[vp].append(fi2)

    def fam_score(fi2, vec):
        pos, S = fam_masks[fi2]
        p = 0
        for k, vp in enumerate(pos):
            if vec[vp]:
                p |= 1 << k
        return S[p]

    # "flip nothing" is always feasible: the all-false assignment backs
    # up restarts that land on mutually infeasible (-inf) patterns
    best_vec, best_score = np.zeros(n, dtype=bool), -np.inf
    for r in range(icm_restarts):
        vec = np.zeros(n, dtype=bool) if r == 0 else \
            rng.random(n) < 0.3
        for _ in range(12):
            changed = False
            for i in range(n):
                have = bool(vec[i])
                sc = [0.0, 0.0]
                for flip in (False, True):
                    vec[i] = flip
                    for fi2 in byvar[i]:
                        sc[flip] += fam_score(fi2, vec)
                better = sc[1] > sc[0]
                if better != have:
                    changed = True
                vec[i] = better
            if not changed:
                break
        total = sum(fam_score(fi2, vec)
                    for fi2 in range(len(fam_masks)))
        if total > best_score:
            best_score, best_vec = total, vec.copy()
    return best_vec


@dataclasses.dataclass
class FlipCandidate:
    score: float                       # total log-gain (positive = good)
    cover: Set[int]                    # individuals involved
    flips: List[Tuple[int, int]]       # (individual, marker) pairs


def extract_candidates(fams, assign: Dict[int, bool], marker: int
                       ) -> List[FlipCandidate]:
    """Group the marker solution into connected flip cliques and score each
    (computecandcliques, cnF2freq.cpp:4880-4969)."""
    # only families with at least one flipped member join a clique and
    # contribute their matched-pattern weight (anyswitch,
    # cnF2freq.cpp:4901-4958)
    flipped = []
    for fi, (vars_, S) in enumerate(fams):
        p = 0
        for i, v in enumerate(vars_):
            if assign.get(v, False):
                p |= 1 << i
        if p:
            flipped.append((vars_, S, p))
    out: List[FlipCandidate] = []
    for comp in _components([(v, S) for v, S, _ in flipped]):
        score = 0.0
        cover: Set[int] = set()
        for fi in comp:
            vars_, S, p = flipped[fi]
            score += S[p]
            cover.update(vars_)
        flips = [(v, marker) for v in sorted(cover) if assign.get(v, False)]
        out.append(FlipCandidate(score=score, cover=cover, flips=flips))
    return out


def select_winner(cands: List[FlipCandidate],
                  min_gain: float = 1e-3) -> Optional[FlipCandidate]:
    """Across-marker selection: combine disjoint-cover candidates (the
    mergebestcands idea, cnF2freq.cpp:5097-5183) and return the best
    combined candidate with positive gain."""
    cands = [c for c in cands if c.score > min_gain]
    if not cands:
        return None
    cands.sort(key=lambda c: -c.score)
    chosen: List[FlipCandidate] = []
    used: Set[int] = set()
    for c in cands:
        if used & c.cover:
            continue
        chosen.append(c)
        used |= c.cover
    return FlipCandidate(score=sum(c.score for c in chosen),
                         cover=set().union(*(c.cover for c in chosen)),
                         flips=[f for c in chosen for f in c.flips])


def apply_flips(ped: Pedigree, winner: FlipCandidate, chrom: int,
                haplobase=None, haplocount=None,
                ind_index: Optional[Dict[int, int]] = None):
    """negshifter (cnF2freq.cpp:3437-3460): invert haplotype weights (and
    the accumulated statistics) from the flip marker + 1 to the chromosome
    end."""
    lo, hi = ped.chromosome_range(chrom)
    for n, m in winner.flips:
        ind = ped.by_id(n)
        ind.lastinved[chrom] = m
        sl = slice(m + 1, hi)
        ind.haploweight[sl] = 1.0 - ind.haploweight[sl]
        if haplobase is not None and ind_index is not None \
                and n in ind_index:
            i = ind_index[n]
            haplobase[i, sl] = haplocount[i, sl] - haplobase[i, sl]
