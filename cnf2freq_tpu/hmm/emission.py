"""Tensorized emission model.

The reference computes emission weights by a per-probe recursive pedigree
walk (``trackpossible``, cnF2freq.cpp:1075-1359).  Because the analysis
unit has fixed depth (``numgen`` generations) and a tiny state space, that
recursion unrolls into a *closed-form factored product* over the family
slots, evaluated for all (state, path, shift) combinations at once:

    E[g, f, s] = sum_{r0} F(r0, s0) * PB_0(g_{0:3}, f_{1:4}, s1; r0)
                                     * PB_1(g_{3:6}, f_{4:7}, s2; r0)

where ``F`` is the focal-individual term and ``PB_k`` the "parent block"
of parent k (parent + its two ancestors).  Each block depends only on the
slot's own bits of (g, f, s) and on which focal allele ``r0`` feeds the
branch — so blocks are tiny tensors over [r0(2), fp(8), fpath(8), sk(2)]
per (individual, marker), and full emission tensors are broadcast products
of them.  This turns the reference's innermost hot recursion (called
markers x 64 x 128 x 8 times per individual per iteration) into a handful
of fused elementwise ops on [B, M, ...] arrays.

Semantics are validated 1:1 against the golden scalar engine
(tests/test_emission.py).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (GENOS, HAPLOS, HOMOZYGOUS, ModelConfig, SEXMARKER,
                      UNKNOWN, ZP_NONE, ZP_NO_EQUIVALENCE, ZP_PROPAGATE)
from .family import FamilyBatch

# Enumeration axis helpers: the 8 trailing axes of a fully-expanded parent
# block, in order (r0, gb1, gb0, p0, rg1, rg0, rp, sk) — each of size 2.
# Reshaping then merges (gb1, gb0, p0) -> fp and (rg1, rg0, rp) -> fpath so
# that flattened indices carry the bits in the reference's layout
# (fp bit0 = firstpar, bits 1,2 = grandparent state bits; fpath likewise).
_NAX = 8
_AX = {name: i for i, name in enumerate(
    ["r0", "gb1", "gb0", "p0", "rg1", "rg0", "rp", "sk"])}


def _enum(name: str) -> np.ndarray:
    shape = [1] * _NAX
    shape[_AX[name]] = 2
    return np.arange(2).reshape(shape)


_R0, _GB1, _GB0, _P0 = _enum("r0"), _enum("gb1"), _enum("gb0"), _enum("p0")
_RG1, _RG0, _RP, _SK = _enum("rg1"), _enum("rg0"), _enum("rp"), _enum("sk")


def _ex(x, n: int = _NAX):
    """Append n singleton enum axes to a data array."""
    x = jnp.asarray(x)
    return x.reshape(x.shape + (1,) * n)


def _pick(pair, idx):
    """pair[..., 2] selected by enum-index array idx (values 0/1)."""
    return jnp.where(idx == 1, _ex(pair[..., 1]), _ex(pair[..., 0]))


def _safe_div(a, b):
    return jnp.where(b > 0, a / jnp.where(b > 0, b, 1.0), 0.0)


def _match_raw(v, sv, mdj, msj, zp: int):
    """The markermiss + base-value arithmetic of one slot test
    (cnF2freq.cpp:303-316, 1196-1221).  All args broadcast together.

    Returns (bv, pre, bound): raw base value, un-normalised second-channel
    weight, and the value that continues up the branch."""
    unknown_v = v == UNKNOWN
    if zp == ZP_NONE:
        bound = jnp.where(unknown_v, mdj, v)
    else:
        bound = v
    if zp == ZP_PROPAGATE:
        miss = jnp.zeros(jnp.broadcast_shapes(v.shape, mdj.shape), dtype=bool)
    else:
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


def _phase(md, ms, hw, f2n, zp: int, ci: bool, haplotyping: bool):
    """Phase-interpretation factor (cnF2freq.cpp:1229-1252).

    Returns (factor, collapse) where collapse marks the duplicate-allele
    branch that never updates haplotype accumulators."""
    f2nf = f2n.astype(hw.dtype) if hasattr(f2n, "astype") else \
        jnp.asarray(f2n, dtype=hw.dtype)
    collapse = _ex((md[..., 0] == md[..., 1]) &
                   (ci | (ms[..., 0] == ms[..., 1])))
    if zp != ZP_NONE:
        return jnp.full_like(f2nf + _ex(hw), 0.5), collapse & False
    weight = jnp.abs(f2nf - _ex(hw)) if haplotyping \
        else jnp.full_like(f2nf + _ex(hw), 0.5)
    return jnp.where(collapse, f2nf, weight), collapse


class SlotData(NamedTuple):
    md: jnp.ndarray      # [..., 2]
    ms: jnp.ndarray      # [..., 2]
    hw: jnp.ndarray      # [...]
    exists: jnp.ndarray  # [...] bool (broadcastable)
    attop: jnp.ndarray   # [...] bool


def slot_data(fb: FamilyBatch, slot: int) -> SlotData:
    """Slot arrays with [B, M] prefix (exists/attop broadcast over M)."""
    return SlotData(md=fb.md[:, slot], ms=fb.ms[:, slot], hw=fb.hw[:, slot],
                    exists=fb.exists[:, slot][:, None],
                    attop=fb.attop[:, slot][:, None])


def _gp_term(gp: SlotData, w, sw, gb, rg, zp: int, ci: bool,
             haplotyping: bool):
    """Grandparent (top-of-recursion) slot term: matched value with the
    second channel absorbed additively (attopnow, cnF2freq.cpp:1213-1217)
    times its phase factor; 1 + sw when the slot is vacant
    (cnF2freq.cpp:1043-1046)."""
    md_rg = _pick(gp.md, rg)
    ms_rg = _pick(gp.ms, rg)
    bv, pre, _ = _match_raw(w, sw, md_rg, ms_rg, zp)
    ph, collapse = _phase(gp.md, gp.ms, gp.hw, rg ^ gb, zp, ci, haplotyping)
    term = (bv + pre) * ph
    return jnp.where(_ex(gp.exists), term, 1.0 + sw), collapse


def parent_block(par: SlotData, gp0: SlotData, gp1: SlotData,
                 v, sv, zp: int = ZP_NONE, ci: bool = False,
                 haplotyping: bool = True, trace_second: bool = True,
                 pathful: bool = False):
    """One parent branch of the emission product.

    v, sv: [..., 2] value/second-channel per focal interpretation r0.
    Returns [..., r0(2), fp(8), fpath(8), sk(2)] if pathful, else summed
    over fpath -> [..., r0(2), fp(8), sk(2)].
    """
    vb = _ex(v[..., 0]) * 0 + _pick(v, _R0)      # v indexed by r0 axis
    svb = _pick(sv, _R0)

    md_rp = _pick(par.md, _RP)
    ms_rp = _pick(par.ms, _RP)
    md_o = _pick(par.md, 1 - _RP)
    ms_o = _pick(par.ms, 1 - _RP)

    bv_raw, pre, bound = _match_raw(vb, svb, md_rp, ms_rp, zp)
    bv_abs = bv_raw + pre
    ms_nab = _safe_div(pre, bv_raw)
    ph, _ = _phase(par.md, par.ms, par.hw, _RP ^ _P0 ^ _SK, zp, ci,
                   haplotyping)

    # second-branch bookkeeping at the parent (cnF2freq.cpp:1291-1332);
    # only traced when the walk continues past the parent and zp == 0
    sec_f = jnp.where(ms_o != 0, 1.0 - ms_o, 1.0)
    secsec = jnp.where(ms_o != 0, _safe_div(ms_o, 1.0 - ms_o), 0.0)

    w1, sw1 = bound, ms_nab          # continuing (first) branch value
    w2, sw2 = md_o, secsec           # second-branch value

    trace2 = trace_second and zp == ZP_NONE
    g0_first, _ = _gp_term(gp0, w1, sw1, _GB0, _RG0, zp, ci, haplotyping)
    g1_first, _ = _gp_term(gp1, w1, sw1, _GB1, _RG1, zp, ci, haplotyping)
    if trace2:
        g0_second, _ = _gp_term(gp0, w2, sw2, _GB0, _RG0, zp, ci,
                                haplotyping)
        g1_second, _ = _gp_term(gp1, w2, sw2, _GB1, _RG1, zp, ci,
                                haplotyping)
        deep = bv_raw * ph * sec_f * jnp.where(
            _P0 == 0, g0_first * g1_second, g1_first * g0_second)
    else:
        deep = bv_raw * ph * jnp.where(_P0 == 0, g0_first, g1_first)

    top = bv_abs * ph
    term = jnp.where(_ex(par.attop), top, deep)
    term = jnp.where(_ex(par.exists), term, 1.0 + svb)

    # Canonical-path weights: a local path bit only carries meaning when the
    # recursion actually consumes it.  The reference's flag2 == -1 walk sums
    # each *visited* node over its two interpretations exactly once; a
    # vacant grandparent slot, an attop (founder) parent or an untraced
    # second branch never visits the bit, so only the bit==0 assignment may
    # count — otherwise path-sums would double relative to the reference.
    ex_p = _ex(par.exists)
    at_p = _ex(par.attop)
    cons = []
    for j, (gp, rg) in enumerate(((gp0, _RG0), (gp1, _RG1))):
        c = ex_p & ~at_p & _ex(gp.exists)
        if trace2:
            pass
        else:
            c = c & (_P0 == j)
        cons.append(jnp.where(c, True, rg == 0))
    weight = jnp.where(ex_p, True, _RP == 0) & cons[0] & cons[1]
    term = term * weight

    # merge enum axes: (gb1, gb0, p0) -> fp, (rg1, rg0, rp) -> fpath
    term = jnp.broadcast_to(
        term, term.shape[:-_NAX] + (2,) * _NAX)
    shp = term.shape[:-_NAX]
    term = term.reshape(shp + (2, 8, 8, 2))
    if pathful:
        return term
    return term.sum(axis=-2)


class RootBlock(NamedTuple):
    froot: jnp.ndarray   # [..., r0(2), s0(2)]
    vA: jnp.ndarray      # [..., r0(2)] value into the first-branch parent
    svA: jnp.ndarray
    vB: jnp.ndarray      # [..., r0(2)] value into the second-branch parent
    svB: jnp.ndarray
    top: jnp.ndarray     # [..., r0(2), s0(2)] focal-as-top term


def root_block(focal: SlotData, update: int = 0, zp: int = ZP_NONE,
               ci: bool = False, haplotyping: bool = True, inval=None,
               insv=None, side: int = 0, dtype=jnp.float64,
               root_override=None,
               no_root_collapse: bool = False) -> RootBlock:
    """Focal-individual factor plus the per-branch values it feeds upward.

    side: the root's firstpar bit (flag = g*2 + side); side=1 swaps which
    parent receives the continuing branch (GENOSPROBE/GENOS probes,
    cnF2freq.cpp:5525, 5566).

    root_override: optional (md_r, ms_r, md_o, ms_o, collapse) [B, M]
    arrays replacing the focal's own marker pair — the selfing extension's
    collapsed HBD pair (selfmarker/selfsure, cnF2freq.cpp:1131-1189),
    independent of the interpretation slot r0."""
    n = 2  # trailing enum axes here: (r0, s0)
    R0 = np.arange(2).reshape(2, 1)
    S0 = np.arange(2).reshape(1, 2)

    def ex2(x):
        return jnp.asarray(x).reshape(jnp.asarray(x).shape + (1, 1))

    def pick2(pair, idx):
        return jnp.where(idx == 1, ex2(pair[..., 1]), ex2(pair[..., 0]))

    if inval is None:
        inval = jnp.zeros(focal.hw.shape, dtype=jnp.int32)
    if insv is None:
        insv = jnp.zeros(focal.hw.shape, dtype=dtype)
    iv = ex2(inval)
    sv = ex2(insv)

    if root_override is None:
        md_r = pick2(focal.md, R0)
        ms_r = pick2(focal.ms, R0)
        md_o = pick2(focal.md, 1 - R0)
        ms_o = pick2(focal.ms, 1 - R0)
    else:
        # r0-independent overrides, broadcast over the (r0, s0) enum axes
        md_r, ms_r, md_o, ms_o = (
            jnp.broadcast_to(ex2(jnp.asarray(x)), jnp.asarray(x).shape + (2, 1))
            for x in root_override[:4])

    unknown_v = iv == UNKNOWN
    if zp == ZP_NONE:
        bound = jnp.where(unknown_v, md_r, iv)
    else:
        bound = iv + md_r * 0
    if zp == ZP_PROPAGATE:
        miss = jnp.zeros(bound.shape, dtype=bool)
    else:
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

    absorb_static = bool(update & HAPLOS)
    bv_abs = bv_raw + pre
    ms_nab = _safe_div(pre, bv_raw)

    if root_override is None:
        collapse = ex2((focal.md[..., 0] == focal.md[..., 1]) &
                       (ci | (focal.ms[..., 0] == focal.ms[..., 1])))
    else:
        collapse = ex2(root_override[4])
    if no_root_collapse:
        # RELSKEWSTATES disables the duplicate-allele collapse at the
        # root (``!relskewingNOW``, cnF2freq.cpp:1235): the coherence
        # bit must keep both interpretations reachable
        collapse = collapse & False
    f2n = R0 ^ side ^ S0
    if zp != ZP_NONE:
        ph = jnp.full(jnp.broadcast_shapes(collapse.shape, f2n.shape,
                                           ex2(focal.hw).shape), 0.5,
                      dtype=dtype)
    else:
        w = jnp.abs(f2n - ex2(focal.hw)) if haplotyping else 0.5
        ph = jnp.where(collapse, f2n.astype(dtype), w)

    genos = bool(update & GENOS)
    homoz = bool(update & HOMOZYGOUS)
    # attopnow at the root: founder focal (never HOMOZYGOUS probes)
    attop = ex2(focal.attop) & (not homoz)

    bv = jnp.where(attop | absorb_static, bv_abs, bv_raw)
    msA = jnp.where(attop | absorb_static, jnp.zeros_like(ms_nab), ms_nab)

    # second branch at the root (cnF2freq.cpp:1291-1334)
    vB = md_o
    svB = jnp.zeros_like(ms_o)
    secfac = jnp.ones_like(ms_o)
    if not genos:
        if not homoz:
            secfac = jnp.where(ms_o != 0, 1.0 - ms_o, 1.0)
            svB = jnp.where(ms_o != 0, _safe_div(ms_o, 1.0 - ms_o), 0.0)
        else:
            neq = bound != md_o
            secfac = jnp.where(neq,
                               jnp.where(md_o != UNKNOWN, ms_o,
                                         jnp.ones_like(ms_o)),
                               1.0 - ms_o)
            vB = jnp.where(neq, bound, md_o)

    froot = jnp.where(attop, bv_abs * ph, bv * ph * secfac)
    top = bv_abs * ph

    # values flowing upward are s0-independent; drop the s0 axis
    return RootBlock(froot=froot, vA=bound[..., 0], svA=msA[..., 0],
                     vB=vB[..., 0], svB=svB[..., 0], top=top)


# ---------------------------------------------------------------------------
# Assembly
# ---------------------------------------------------------------------------
class EmissionBlocks(NamedTuple):
    """Factored emission: everything needed to assemble E tensors or to run
    posterior contractions without materialising the path axis."""

    froot: jnp.ndarray       # [b, m, r0(2), s0(2)]
    top: jnp.ndarray         # [b, m, r0(2), s0(2)] focal-as-top variant
    pb: Tuple[jnp.ndarray, jnp.ndarray]  # [b, m, r0, fp(8), fpath(8), sk(2)]
    focal_attop: jnp.ndarray  # [b] bool
    side: int = 0


def build_blocks(fb: FamilyBatch, cfg: ModelConfig, ci: bool = False,
                 update: int = 0, zp: int = ZP_NONE, inval=None, insv=None,
                 side: int = 0, dtype=jnp.float64,
                 root_override=None,
                 no_root_collapse: bool = None) -> EmissionBlocks:
    """Compute the factored emission blocks for one probe variant."""
    assert cfg.numgen == 3, "numgen==2 engine lands with the config matrix"
    if no_root_collapse is None:
        no_root_collapse = cfg.relskewstates
    focal = slot_data(fb, 0)
    rb = root_block(focal, update=update, zp=zp, ci=ci,
                    haplotyping=cfg.haplotyping, inval=inval, insv=insv,
                    side=side, dtype=dtype, root_override=root_override,
                    no_root_collapse=no_root_collapse)
    genos = bool(update & GENOS)
    pbs = []
    for k in range(2):
        par = slot_data(fb, cfg.parent_slot(k))
        gps = [slot_data(fb, cfg.grandparent_slot(k, j)) for j in range(2)]
        # the continuing branch (bound focal value) feeds parent `side`,
        # the second branch the other parent; vA/svA etc. carry the r0 axis
        first = (k == side)
        vk, svk = (rb.vA, rb.svA) if first else (rb.vB, rb.svB)
        if genos and not first:
            # GENOS updates never trace the second branch at the root
            # (cnF2freq.cpp:1291): that parent contributes factor 1
            B, M = fb.md.shape[0], fb.md.shape[2]
            pbs.append(jnp.ones((B, M, 2, 8, 8, 2), dtype=dtype) *
                       _canonical_only(dtype))
            continue
        pbs.append(parent_block(par, gps[0], gps[1], vk, svk, zp=zp, ci=ci,
                                haplotyping=cfg.haplotyping,
                                trace_second=not genos, pathful=True))
    return EmissionBlocks(froot=rb.froot, top=rb.top, pb=tuple(pbs),
                          focal_attop=fb.attop[:, 0], side=side)


def _canonical_only(dtype):
    """[8]->broadcastable fpath weight keeping only the all-zero path for a
    branch the recursion never enters."""
    w = np.zeros((8,), dtype=np.dtype(str(dtype)))
    w[0] = 1.0
    return jnp.asarray(w)[None, None, None, None, :, None]


def assemble_e_all(blocks: EmissionBlocks, cfg: ModelConfig) -> jnp.ndarray:
    """E_all[b, m, s, g] from factored blocks (path axes summed) — shift
    second-minor, state g minor."""
    s0 = blocks.pb[0].sum(axis=-2)
    s1 = blocks.pb[1].sum(axis=-2)
    e = jnp.einsum("...rt,...rau,...rbv->...vutba", blocks.froot, s0, s1)
    B, M = e.shape[:2]
    e = e.reshape(B, M, cfg.numshifts, cfg.numtypes)
    tops = blocks.top.sum(axis=-2)  # sum over r0 -> [b, m, s0]
    tops = jnp.tile(tops, (1, 1, cfg.numshifts // 2))    # [b, m, s]
    tops = jnp.broadcast_to(tops[:, :, :, None],
                            (B, M, cfg.numshifts, cfg.numtypes))
    focal_attop = blocks.focal_attop[:, None, None, None]
    return jnp.where(focal_attop, tops, e)


def emission_all(fb: FamilyBatch, cfg: ModelConfig, ci: bool = False,
                 dtype=jnp.float64) -> jnp.ndarray:
    """E_all[b, m, g, s]: per-state, per-shift emission summed over all
    interpretation paths — the quantity the forward-backward sweeps use
    (adjustprobs with flag2 == -1, cnF2freq.cpp:1579-1670)."""
    return assemble_e_all(build_blocks(fb, cfg, ci=ci, dtype=dtype), cfg)
