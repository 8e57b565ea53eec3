"""Cross-shard accumulator merging.

The reference merges per-thread statistics into shared parent accumulators
under per-marker OpenMP locks (cnF2freq.cpp:5265-5270, 5893-5902) and, in
its vestigial MPI path, with elementwise vector reduce
(cnF2freq.cpp:6245-6255).  Sharded over a device mesh the same merge is a
segment-sum from family slots onto target individuals followed by a psum
over the data axis — deterministic, lock-free.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..hmm.family import FamilyBatch


def merge_slot_stats(values: jnp.ndarray, slot_ind: jnp.ndarray,
                     num_individuals: int, axis_name: str = None
                     ) -> jnp.ndarray:
    """Fold [B, M, slot, ...] per-family statistics onto per-individual
    accumulators [num_individuals, M, ...].

    slot_ind: [B, slot] global individual ids (0 = vacant).  Inside
    shard_map pass axis_name to psum the partial sums across the data
    axis; under plain jit/NamedSharding XLA handles the reduction of the
    segment-sum automatically."""
    B, M, S = values.shape[:3]
    tail = values.shape[3:]
    # [B, M, S, ...] -> [B, S, M, ...] so rows align with slot_ind[B, S]
    flat = jnp.moveaxis(values, 2, 1).reshape(B * S, M, *tail)
    ids = slot_ind.reshape(B * S)
    out = jax.ops.segment_sum(flat, ids, num_segments=num_individuals + 1)
    out = out[1:]  # drop the vacant-slot bucket
    if axis_name is not None:
        out = jax.lax.psum(out, axis_name)
    return out


def _dup_masks_j(slot_ind):
    """slot_ind [B, S] -> (eq [B,S,S], first [B,S]) same-individual and
    first-occurrence masks (device form of updates/scatter._dup_masks)."""
    ids = slot_ind
    occ = ids > 0
    eq = (ids[:, :, None] == ids[:, None, :]) & occ[:, :, None] \
        & occ[:, None, :]
    S = ids.shape[1]
    tri = jnp.tril(jnp.ones((S, S), dtype=bool), -1)
    first = occ & ~(eq & tri[None]).any(axis=2)
    return eq, first


def merge_haplos(b12, mask, hw, slot_ind, descendants, lut,
                 num_individuals: int, axis_name: str = None):
    """Device-side movehaplos (cnF2freq.cpp:3599-3616): per-family b12
    statistics [B, M, S, 2] merged onto per-individual accumulators.

    hw: [B, S, M] gathered haploweights; lut: [max_id+1] individual id ->
    accumulator row (vacant id 0 -> num_individuals, dropped).
    Returns (haplobase [NI, M], haplocount [NI, M]).  Exact parity with
    updates/scatter.scatter_haplos pinned by tests/test_scatter.py."""
    from ..updates.scatter import _MOVEHAPLO_TINY
    B, M, S = b12.shape[:3]
    dtype = b12.dtype
    eq, first = _dup_masks_j(slot_ind)
    eqf = eq.astype(dtype)

    masked = jnp.where(mask[..., None], b12, 0.0)
    tot = jnp.einsum("bst,bmtk->bmsk", eqf, masked)
    used_slot = (mask & (b12.sum(axis=-1) > 0)).astype(dtype)
    used = jnp.einsum("bst,bmt->bms", eqf, used_slot) > 0

    unlocked = jnp.abs(hw - 0.5) < 0.5 - 1e-12          # [B, S, M]
    take = used & jnp.transpose(unlocked, (0, 2, 1))
    b1 = tot[..., 0] + _MOVEHAPLO_TINY
    b2 = tot[..., 1] + _MOVEHAPLO_TINY
    den = b1 + b2
    safe = take & jnp.isfinite(den) & (den > 0)
    contrib = jnp.where(safe, b1 / jnp.where(safe, den, 1.0), 0.0) * \
        descendants[:, None, None].astype(dtype)
    count = jnp.where(safe, 1.0, 0.0) * \
        descendants[:, None, None].astype(dtype)

    rows = jnp.where(first, lut[slot_ind], num_individuals)  # [B, S]
    rows_flat = rows.reshape(B * S)
    cflat = jnp.moveaxis(contrib, 2, 1).reshape(B * S, M)
    nflat = jnp.moveaxis(count, 2, 1).reshape(B * S, M)
    hb = jax.ops.segment_sum(cflat, rows_flat,
                             num_segments=num_individuals + 1)[:-1]
    hc = jax.ops.segment_sum(nflat, rows_flat,
                             num_segments=num_individuals + 1)[:-1]
    if axis_name is not None:
        hb = jax.lax.psum(hb, axis_name)
        hc = jax.lax.psum(hc, axis_name)
    return hb, hc


def merge_infprobs(accum, slot_ind, descendants, lut,
                   num_individuals: int, axis_name: str = None,
                   emptyslot=None):
    """Device-side moveinfprobs (cnF2freq.cpp:3577-3597): normalise by
    the focal's slot-0 mass, fold duplicate slots with 2/2^cnt damping,
    scale by descendants, segment-sum onto [NI, M, 2, 2].

    cnt counts occurrences in the reference's reltreeordered, which only
    holds non-empty members (cnF2freq.cpp:3127-3152) — an empty member
    counts 0 and so gets the undamped factor 2."""
    B, M, S = accum.shape[:3]
    dtype = accum.dtype
    eq, first = _dup_masks_j(slot_ind)
    eqf = eq.astype(dtype)
    cnt_in = eq if emptyslot is None else eq & ~emptyslot[:, None, :]
    cnt = cnt_in.sum(axis=2).astype(dtype)              # [B, S]

    fsum = accum[:, :, 0, 0, :].sum(axis=-1)            # [B, M]
    inv = jnp.where(fsum > 0, 1.0 / jnp.where(fsum > 0, fsum, 1.0), 0.0)
    tot = jnp.einsum("bst,bmtjk->bmsjk", eqf, accum)
    norm = 2.0 / jnp.exp2(cnt) * descendants[:, None].astype(dtype)
    contrib = tot * inv[:, :, None, None, None] * \
        norm[:, None, :, None, None]

    rows = jnp.where(first, lut[slot_ind], num_individuals)
    flat = jnp.moveaxis(contrib, 2, 1).reshape(B * S, M, 2, 2)
    out = jax.ops.segment_sum(flat, rows.reshape(B * S),
                              num_segments=num_individuals + 1)[:-1]
    if axis_name is not None:
        out = jax.lax.psum(out, axis_name)
    return out


def sharded_scan_and_merge(fb: FamilyBatch, dists, cfg, params, mesh: Mesh,
                           num_individuals: int):
    """One sharded chromosome scan plus on-device accumulator merge: the
    multi-chip equivalent of the scatter stage of Driver.iterate."""
    from ..engine import chromosome_scan

    @jax.jit
    def step(batch, d):
        res = chromosome_scan(batch, d, cfg, params)
        masked = jnp.where(res.haplo_mask[..., None], res.haplo_b12, 0.0)
        hb12 = merge_slot_stats(masked, batch.slot_ind, num_individuals)
        inf = merge_slot_stats(res.inf_accum, batch.slot_ind,
                               num_individuals)
        return res.total, hb12, inf

    with mesh:
        return step(fb, jax.device_put(jnp.asarray(dists),
                                       NamedSharding(mesh, P())))


def make_sharded_scan_merged(cfg, params, mesh: Mesh,
                             num_individuals: int,
                             probe_rules: bool = False,
                             n_variants: int = 1,
                             with_coherence: bool = False,
                             with_recomb: bool = False):
    """The production scan+merge step under shard_map: each shard runs
    the full single-device program (including its Pallas kernels —
    legal per shard, unlike Pallas under bare GSPMD) on its slice of the
    cohort, then psum completes the per-individual accumulator merge
    over the data axis.  The multi-chip form of
    engine.make_jitted_scan_merged; per-shard parity pinned by
    tests/test_scatter.py.

    with_recomb additionally returns the cohort-summed posterior
    recombination expectations [M-1, typebits] (psum over the data
    axis) — genetic-map re-estimation under a mesh needs only this
    cohort aggregate, never the per-unit tensors."""
    from ..engine import chromosome_scan
    from ..hmm.emission import assemble_e_all, build_blocks
    from ..hmm.forward_backward import FBResult
    from ..hmm.probes import recombination_expectations
    from ..hmm.transition import interval_recomb, transition_eigenvalues

    def step(fb, dists, lut, ratemat):
        res = chromosome_scan(fb, dists, cfg, params, ratemat=ratemat,
                              probe_rules=probe_rules,
                              n_variants=n_variants,
                              with_coherence=with_coherence)
        hb, hc = merge_haplos(res.haplo_b12, res.haplo_mask, fb.hw,
                              fb.slot_ind, fb.descendants, lut,
                              num_individuals, axis_name="data")
        inf = merge_infprobs(res.inf_accum, fb.slot_ind, fb.descendants,
                             lut, num_individuals, axis_name="data",
                             emptyslot=fb.emptyslot if probe_rules
                             else None)
        if with_recomb:
            blocks = build_blocks(fb, cfg, dtype=res.fw_pre.dtype)
            e = assemble_e_all(blocks, cfg)
            lam = transition_eigenvalues(
                cfg, interval_recomb(cfg, params, dists,
                                     ratemat=ratemat)).astype(e.dtype)
            pe = res.fw_pre * e
            s = pe.sum(axis=-1, keepdims=True)
            fw_post = jnp.where(s > 0, pe / jnp.where(s > 0, s, 1.0),
                                0.0)
            fw_post_f = res.fw_pre_f + jnp.log(
                jnp.maximum(s[..., 0], 1e-300))
            fbres = FBResult(fw_pre=res.fw_pre, fw_post=fw_post,
                             bw=res.bw, fw_pre_f=res.fw_pre_f,
                             fw_post_f=fw_post_f, bw_f=res.bw_f)
            p = recombination_expectations(fbres, e, cfg, lam)
            # padded batch rows carry all-unknown genotypes: their
            # posterior expectations are real numbers but the host
            # divisor counts real units only, so sum ALL rows the same
            # way the unmeshed accumulate does (it slices [:nb]; here
            # mask via slot_ind's focal row: vacant focal == padding)
            real = (fb.slot_ind[:, 0] > 0).astype(p.dtype)
            psum_p = jax.lax.psum((p * real[:, None, None]).sum(axis=0),
                                  "data")
            nreal = jax.lax.psum(real.sum(), "data")
        else:
            psum_p = jnp.zeros((res.turn_weight.shape[1] - 1,
                                cfg.typebits), dtype=res.total.dtype)
            nreal = jnp.zeros((), dtype=res.total.dtype)
        return (res.total, res.pair, res.turn_weight, hb, hc, inf,
                res.coherence, psum_p, nreal)

    fb_spec = P("data")
    sharded = jax.shard_map(
        step, mesh=mesh,
        in_specs=(fb_spec, P(), P(), P()),
        out_specs=(P("data"), P("data"), P("data"), P(), P(), P(),
                   P("data"), P(), P()),
        check_vma=False)
    return jax.jit(sharded)
