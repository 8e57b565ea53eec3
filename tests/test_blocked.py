"""Marker-blocked (checkpointed) forward-backward: block-boundary
carries plus per-block recompute reproduce the whole-chromosome sweep
exactly."""
import jax.numpy as jnp
import numpy as np

from cnf2freq_tpu.config import ModelConfig, RuntimeParams
from cnf2freq_tpu.hmm.family import gather_family
from cnf2freq_tpu.hmm.transition import (interval_recomb,
                                         transition_eigenvalues)
from cnf2freq_tpu.ops import scan_v2 as v2
from cnf2freq_tpu.utils import simulate_f2


def _setup(B=4, M=12, seed=5):
    ped = simulate_f2(n_f2=B, n_markers=M, missing_rate=0.1,
                      error_rate=0.02, seed=seed)
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_descendants()
    fb = gather_family(ped, ped.dous, 0, M - 1)
    dists = jnp.asarray(np.diff(ped.markerposes))
    cfg, params = ModelConfig(), RuntimeParams()
    fbj = fb.map(jnp.asarray)
    st = v2.prep_slots(fbj, jnp.float64)
    e = v2.emissions_v2(st, cfg, jnp.float64)
    return e, dists, cfg, params, st


def test_blocked_chunk_matches_merged():
    """blocked_scan_chunk (O(block) device memory) reproduces the
    whole-chromosome merged scan: totals, pair tables, merged
    accumulators, and per-block turn weights."""
    from cnf2freq_tpu.engine import make_jitted_scan_merged
    from cnf2freq_tpu.hmm.transition import rate_matrix

    ped = simulate_f2(n_f2=5, n_markers=16, missing_rate=0.1,
                      error_rate=0.02, seed=9)
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_descendants()
    cfg, params = ModelConfig(), RuntimeParams()
    ids = [ind.n for ind in ped.inds[1:]]
    NI = len(ids)
    lut = np.full(max(ids) + 1, NI, dtype=np.int32)
    for i, n in enumerate(ids):
        lut[n] = i
    M = ped.num_markers
    fb = gather_family(ped, ped.dous, 0, M - 1)
    dists = np.diff(ped.markerposes)
    rm = rate_matrix(cfg, params, M - 1)

    pieces = v2.make_blocked_pieces(cfg, params, jnp.float64, NI)
    turns = {}

    def consumer(off, w, hb_full, hc_full):
        turns[off] = np.asarray(w)
        # in-progress accumulators are filled through this block
        assert np.abs(hb_full[:, off:off + 4]).sum() >= 0
        assert hb_full.shape[1] == M

    total, pair, hb, hc, inf = v2.blocked_scan_chunk(
        fb, dists, rm, jnp.asarray(lut), cfg, params, block=4,
        pieces=pieces, turn_consumer=consumer)

    fbj = fb.map(jnp.asarray)
    res, rhb, rhc, rinf = make_jitted_scan_merged(cfg, params, NI)(
        fbj, jnp.asarray(dists), jnp.asarray(lut), jnp.asarray(rm))

    np.testing.assert_allclose(total, np.asarray(res.total), rtol=1e-9)
    np.testing.assert_allclose(pair, np.asarray(res.pair), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(hb, np.asarray(rhb), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(hc, np.asarray(rhc), rtol=1e-9, atol=0)
    np.testing.assert_allclose(inf, np.asarray(rinf), rtol=1e-9,
                               atol=1e-12)

    tw = np.concatenate([turns[off] for off in sorted(turns)], axis=1)
    rtw = np.asarray(res.turn_weight)
    finite = rtw > -1e14
    np.testing.assert_allclose(tw[finite], rtw[finite], rtol=1e-7,
                               atol=1e-9)
    assert np.array_equal(finite, tw > -1e14)


def test_blocked_fb_matches_full():
    e, dists, cfg, params, st = _setup()
    M, X, R = e.shape
    K = 4
    nblk = M // K
    dtype = e.dtype
    S, NS = cfg.numtypes, cfg.numshifts

    full = v2.fb_scan_v2(e, dists, cfg, params)
    total_full = v2.combined_loglik_v2(full, st.sh)

    lam = transition_eigenvalues(
        cfg, interval_recomb(cfg, params, dists)).astype(dtype)
    lam_pad = jnp.concatenate([lam, jnp.ones((1, S), dtype=dtype)], 0)

    # phase A: forward boundary carries
    p = jnp.full((X, R), cfg.evengen, dtype=dtype)
    f = jnp.zeros((NS, R), dtype=dtype)
    fbound = []
    for i in range(nblk):
        fbound.append((p, f))
        p, f = v2.fb_carry_fwd(e[i * K:(i + 1) * K],
                               lam_pad[i * K:(i + 1) * K], p, f, cfg)
    total_blocked = v2.loglik_from_factors(f, st.sh)
    np.testing.assert_allclose(np.asarray(total_blocked),
                               np.asarray(total_full), rtol=1e-12)

    # phase B: backward boundary carries (b[i] = bw at block i's last
    # marker)
    bT = jnp.ones((X, R), dtype=dtype)
    bfT = jnp.zeros((NS, R), dtype=dtype)
    bbound = [None] * nblk
    for i in range(nblk - 1, -1, -1):
        bbound[i] = (bT, bfT)
        below = lam_pad[i * K - 1] if i > 0 else jnp.ones(S, dtype=dtype)
        bT, bfT = v2.fb_carry_bwd(e[i * K:(i + 1) * K],
                                  lam_pad[i * K:(i + 1) * K], below,
                                  *bbound[i], cfg=cfg)

    # phase C: per-block recompute equals the full sweep's slice
    for i in range(nblk):
        blk = v2.fb_scan_v2_block(e[i * K:(i + 1) * K],
                                  lam_pad[i * K:(i + 1) * K],
                                  *fbound[i], *bbound[i], cfg=cfg)
        sl = slice(i * K, (i + 1) * K)
        for name in blk._fields:
            np.testing.assert_allclose(
                np.asarray(getattr(blk, name)),
                np.asarray(getattr(full, name))[sl],
                rtol=1e-12, atol=1e-300, err_msg=f"block {i} {name}")


def test_driver_marker_blocked_matches_unblocked():
    """A full driver iteration in marker-blocked mode equals the
    standard path on every parameter (coherence measurement disabled on
    both to exercise the plain path; coherence parity has its own
    test)."""
    from cnf2freq_tpu.driver import Driver

    peds = [simulate_f2(n_f2=5, n_markers=16, missing_rate=0.2,
                        error_rate=0.02, seed=21) for _ in range(2)]
    drvs = [Driver(peds[0]), Driver(peds[1])]
    drvs[0].marker_block = 4
    # single full iteration: both paths scan identical state, so every
    # output is comparable (a longer trajectory diverges legitimately
    # once a ~0.5/0.5 imputation tie flips on summation reordering)
    for d in drvs:
        d.adaptive_relhaplo = False
        d.preprocess()
        d.iterate(early=False)
    for a, b in zip(peds[0].inds[1:], peds[1].inds[1:]):
        np.testing.assert_allclose(a.haploweight, b.haploweight,
                                   rtol=1e-8, atol=1e-11, err_msg=a.name)
        # imputed calls agree except where the posterior is a near-tie
        # (1e-12-level summation reordering flips argmax at ~0.5/0.5)
        mism = a.markerdata != b.markerdata
        if mism.any():
            sure = np.minimum(a.markersure[mism], b.markersure[mism])
            assert (sure > 0.4).all(), (a.name, a.markerdata[mism],
                                        a.markersure[mism])
    for n in peds[0].dous:
        np.testing.assert_allclose(drvs[0].pair_tables[n],
                                   drvs[1].pair_tables[n],
                                   rtol=1e-8, atol=1e-11)


def test_driver_blocked_chunked_matches_unblocked():
    """Blocked mode composed with batch chunking: tiny batch_size forces
    several chunks per block, and the deferred relskew-halo scoring
    still sees every chunk's accumulator rows — one full iteration
    equals the unchunked, unblocked path."""
    from cnf2freq_tpu.driver import Driver

    peds = [simulate_f2(n_f2=7, n_markers=16, missing_rate=0.2,
                        error_rate=0.02, seed=23) for _ in range(2)]
    drvs = [Driver(peds[0]), Driver(peds[1])]
    drvs[0].marker_block = 4
    drvs[0].batch_size = 3          # 7 dous -> 3 chunks
    for d in drvs:
        d.adaptive_relhaplo = False
        d.preprocess()
        d.iterate(early=False)
    for a, b in zip(peds[0].inds[1:], peds[1].inds[1:]):
        np.testing.assert_allclose(a.haploweight, b.haploweight,
                                   rtol=1e-8, atol=1e-11, err_msg=a.name)
    for n in peds[0].dous:
        np.testing.assert_allclose(drvs[0].pair_tables[n],
                                   drvs[1].pair_tables[n],
                                   rtol=1e-8, atol=1e-11)


def test_driver_blocked_coherence_matches_unblocked():
    """Adjacent-phase coherence (adaptive relhaplo) per block, with the
    cross-boundary interval stitched from the previous block's last
    forward column: relhaplo after one iteration equals the
    whole-chromosome measurement exactly."""
    from cnf2freq_tpu.driver import Driver

    peds = [simulate_f2(n_f2=5, n_markers=16, missing_rate=0.2,
                        error_rate=0.02, seed=29) for _ in range(2)]
    drvs = [Driver(peds[0]), Driver(peds[1])]
    drvs[0].marker_block = 4
    for d in drvs:
        assert d.adaptive_relhaplo
        d.preprocess()
        d.iterate(early=False)
    for a, b in zip(peds[0].inds[1:], peds[1].inds[1:]):
        if a.relhaplo is not None:
            np.testing.assert_allclose(a.relhaplo, b.relhaplo,
                                       rtol=1e-7, atol=1e-9,
                                       err_msg=a.name)
        np.testing.assert_allclose(a.haploweight, b.haploweight,
                                   rtol=1e-7, atol=1e-10, err_msg=a.name)


def test_driver_blocked_remap_matches_unblocked():
    """Genetic-map re-estimation per block (boundary interval stitched):
    the re-estimated actrec after one iteration equals the
    whole-chromosome EM update."""
    from cnf2freq_tpu.driver import Driver

    peds = [simulate_f2(n_f2=5, n_markers=16, missing_rate=0.2,
                        error_rate=0.02, seed=31) for _ in range(2)]
    drvs = [Driver(peds[0]), Driver(peds[1])]
    drvs[0].marker_block = 4
    for d in drvs:
        d.adaptive_relhaplo = False
        d.remap_distances = True
        d.preprocess()
        d.iterate(early=False)
    np.testing.assert_allclose(peds[0].actrec, peds[1].actrec,
                               rtol=1e-7, atol=1e-10)


def test_driver_blocked_negshift_matches_unblocked():
    """Blocked mode under the legacy negshift flip path: per-block turn
    weights are staged to host and concatenated, so the whole-chromosome
    negshift pass sees exactly the unblocked weights — one full
    iteration equals the unblocked run."""
    from cnf2freq_tpu.driver import Driver

    peds = [simulate_f2(n_f2=8, n_markers=16, missing_rate=0.2,
                        error_rate=0.02, seed=31) for _ in range(2)]
    drvs = [Driver(peds[0]), Driver(peds[1])]
    drvs[0].marker_block = 4
    for d in drvs:
        d.flip_mode = "negshift"
        d.adaptive_relhaplo = False
        d.preprocess()
        d.iterate(early=False)
    for a, b in zip(peds[0].inds[1:], peds[1].inds[1:]):
        np.testing.assert_allclose(a.haploweight, b.haploweight,
                                   rtol=1e-8, atol=1e-11, err_msg=a.name)
        np.testing.assert_array_equal(a.lastinved, b.lastinved,
                                      err_msg=a.name)


def _blocked_vs_whole_family(make_ped, block=4):
    """Marker-blocked vs whole-chromosome full iteration on a non-
    standard model family (blocked_families.py): every updated
    parameter and pair table must agree."""
    from cnf2freq_tpu.driver import Driver

    peds = [make_ped(), make_ped()]
    drvs = [Driver(peds[0]), Driver(peds[1])]
    drvs[0].marker_block = block
    for d in drvs:
        d.adaptive_relhaplo = False
        d.preprocess()
        d.iterate(early=False)
    for a, b in zip(peds[0].inds[1:], peds[1].inds[1:]):
        np.testing.assert_allclose(a.haploweight, b.haploweight,
                                   rtol=1e-8, atol=1e-11, err_msg=a.name)
        mism = a.markerdata != b.markerdata
        if mism.any():
            sure = np.minimum(a.markersure[mism], b.markersure[mism])
            assert (sure > 0.4).all(), (a.name, a.markerdata[mism])
    for n in peds[0].dous:
        np.testing.assert_allclose(drvs[0].pair_tables[n],
                                   drvs[1].pair_tables[n],
                                   rtol=1e-8, atol=1e-11)


def test_driver_blocked_ng2_matches_whole():
    """Blocked mode on the dedicated 4-state numgen==2 engine (the
    reference's fillortake tree works under every settings.h config,
    cnF2freq.cpp:1675-1776)."""
    import dataclasses

    from cnf2freq_tpu.config import ModelConfig

    def make():
        ped = simulate_f2(n_f2=5, n_markers=16, missing_rate=0.2,
                          error_rate=0.02, seed=21)
        ped.config = ModelConfig(numgen=2)
        return ped

    _blocked_vs_whole_family(make)


def test_driver_blocked_selfing_matches_whole():
    """Blocked mode on the SELFING extended state space."""
    from cnf2freq_tpu.utils.simulate import simulate_selfed

    def make():
        return simulate_selfed(n_lines=5, n_markers=16, generations=4,
                               marker_spacing_cm=2.0, seed=11)

    _blocked_vs_whole_family(make)


def test_driver_blocked_relskewstates_matches_whole():
    """Blocked mode on the RELSKEWSTATES extended state space."""
    from cnf2freq_tpu.config import ModelConfig

    def make():
        ped = simulate_f2(n_f2=5, n_markers=16, missing_rate=0.2,
                          error_rate=0.02, seed=25)
        ped.config = ModelConfig(relskewstates=True)
        return ped

    _blocked_vs_whole_family(make)


def test_driver_blocked_parity_matches_unblocked():
    """parity x blocked: the reference-exact DOTOULBAR flip pipeline
    consumes whole-chromosome turn weights staged from the per-block
    device tensors — one parity iteration equals the unblocked parity
    path exactly."""
    from cnf2freq_tpu.driver import Driver

    peds = [simulate_f2(n_f2=5, n_markers=16, missing_rate=0.2,
                        error_rate=0.02, seed=29) for _ in range(2)]
    drvs = [Driver(peds[0], parity=True), Driver(peds[1], parity=True)]
    drvs[0].marker_block = 4
    for d in drvs:
        d.preprocess()
        d.iterate(early=True)
        d.iterate(early=False)
    for a, b in zip(peds[0].inds[1:], peds[1].inds[1:]):
        np.testing.assert_allclose(a.haploweight, b.haploweight,
                                   rtol=1e-8, atol=1e-11, err_msg=a.name)
    for n in peds[0].dous:
        np.testing.assert_allclose(drvs[0].pair_tables[n],
                                   drvs[1].pair_tables[n],
                                   rtol=1e-8, atol=1e-11)
