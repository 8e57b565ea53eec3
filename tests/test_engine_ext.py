"""Extended-state full-iteration scans (engine_ext.py) against the golden
doit spec run on the SELFING / RELSKEWSTATES state spaces.

The golden engine's extended-space semantics are themselves validated
1:1 against the reference's trackpossible/realanalyze extension branches
(tests/test_selfing.py, tests/test_relskewstates.py)."""

import math

import numpy as np
import pytest

from cnf2freq_tpu import ModelConfig, Pedigree
from cnf2freq_tpu.golden.doit import GoldenDoit

CFG_SELF = ModelConfig(selfing=True)
CFG_REL = ModelConfig(relskewstates=True)


def make_selfed_ped(M=7, seed=1):
    """A, B founders -> C (F1) -> D (F2, selfed C) -> E, F (F3, selfed D):
    the canonical selfing chain; dous are the two F3 sibs."""
    rng = np.random.default_rng(seed)
    ped = Pedigree(CFG_SELF)
    ped.markerposes = np.linspace(0, 60, M)
    ped.chromstarts = [0, M]
    A, B = ped.getind("A"), ped.getind("B")
    C = ped.getind("C")
    C.pars = (A.n, B.n)
    C.gen = 1
    D = ped.getind("D")
    D.pars = (C.n, C.n)
    D.gen = 2
    E, F = ped.getind("E"), ped.getind("F")
    for x in (E, F):
        x.pars = (D.n, D.n)
        x.gen = 3
    ped.dous = [E.n, F.n]
    ped.freeze()
    for ind in ped.inds[1:]:
        ind.empty = False
        ind.markersure[:] = 0.02
        ind.haploweight[:] = rng.uniform(0.25, 0.75, M)
    A.markerdata[:] = 1
    B.markerdata[:] = 2
    C.markerdata[:, 0] = 1
    C.markerdata[:, 1] = 2
    D.markerdata[:] = rng.integers(1, 3, (M, 2))
    E.markerdata[:] = rng.integers(1, 3, (M, 2))
    F.markerdata[:] = rng.integers(1, 3, (M, 2))
    # a couple of missing genotypes exercise imputation statistics
    E.markerdata[2] = 0
    E.markersure[2] = 0.0
    F.markerdata[4, 1] = 0
    F.markersure[4, 1] = 0.0
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_children()
    ped.count_descendants()
    return ped


def make_relskew_ped(M=7, seed=3):
    """Standard F2 trio family under the RELSKEWSTATES config, with a
    non-uniform relhaplo on every member."""
    rng = np.random.default_rng(seed)
    ped = Pedigree(CFG_REL)
    ped.markerposes = np.linspace(0, 60, M)
    ped.chromstarts = [0, M]
    names = ["g00", "g01", "g10", "g11", "p0", "p1", "k0", "k1"]
    by = {nm: ped.getind(nm) for nm in names}
    by["p0"].pars = (by["g00"].n, by["g01"].n)
    by["p0"].gen = 1
    by["p1"].pars = (by["g10"].n, by["g11"].n)
    by["p1"].gen = 1
    for kid in ("k0", "k1"):
        by[kid].pars = (by["p0"].n, by["p1"].n)
        by[kid].gen = 2
    ped.dous = [by["k0"].n, by["k1"].n]
    ped.freeze()
    for ind in ped.inds[1:]:
        ind.empty = False
        ind.markerdata[:] = rng.integers(1, 3, (M, 2))
        ind.markersure[:] = 0.02
        ind.haploweight[:] = rng.uniform(0.25, 0.75, M)
        ind.relhaplo[:] = rng.uniform(0.2, 0.8, M)
    by["k0"].markerdata[3] = 0
    by["k0"].markersure[3] = 0.0
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_children()
    ped.count_descendants()
    return ped


def _merged_scan(ped, dtype=np.float64):
    import jax.numpy as jnp

    from cnf2freq_tpu.config import RuntimeParams
    from cnf2freq_tpu.driver import Driver
    from cnf2freq_tpu.engine import make_jitted_scan_merged
    from cnf2freq_tpu.hmm.family import gather_family

    drv = Driver(ped)
    nv = drv._n_variants()
    ids = [ind.n for ind in ped.inds[1:]]
    ind_index = {n: i for i, n in enumerate(ids)}
    NI = len(ids)
    lut = np.full(max(ids) + 1, NI, dtype=np.int32)
    for n, i in ind_index.items():
        lut[n] = i
    M = ped.num_markers
    fb = gather_family(ped, list(ped.dous), 0, M - 1, dtype=dtype,
                       mask_mode="reference", n_variants=nv)
    dists = jnp.asarray(np.diff(ped.markerposes).astype(dtype))
    from cnf2freq_tpu.hmm.transition import rate_matrix
    rm = jnp.asarray(rate_matrix(ped.config, RuntimeParams(), M - 1,
                                 dtype=dtype))
    scan_fn = make_jitted_scan_merged(ped.config, RuntimeParams(), NI,
                                      n_variants=nv)
    res, hb, hc, inf = scan_fn(fb.map(jnp.asarray), dists,
                               jnp.asarray(lut), rm)
    return (fb, res, np.asarray(hb), np.asarray(hc), np.asarray(inf),
            ind_index, NI)


def _golden_arrays(ped, acc, ind_index, NI):
    M = ped.num_markers
    ghb = np.zeros((NI, M))
    ghc = np.zeros((NI, M))
    ginf = np.zeros((NI, M, 2, 2))
    for k, v in acc.haplobase.items():
        ghb[ind_index[k]] = v
    for k, v in acc.haplocount.items():
        ghc[ind_index[k]] = v
    for k, tab in acc.infprobs.items():
        for m in range(M):
            for side in range(2):
                for mv, val in tab[m][side].items():
                    ginf[ind_index[k], m, side, mv - 1] = val
    return ghb, ghc, ginf


@pytest.mark.parametrize("make,cfg", [(make_selfed_ped, CFG_SELF),
                                      (make_relskew_ped, CFG_REL)])
def test_ext_scan_matches_golden_doit(make, cfg):
    ped = make()
    doit = GoldenDoit(ped)
    acc = doit.scan()
    fb, res, hb, hc, inf, ind_index, NI = _merged_scan(ped)

    # per-dous combined totals
    for b, n in enumerate(ped.dous):
        f = acc.factors[n]
        allowed = [s for s in range(cfg.numshifts)
                   if not (s & fb.shiftignore[b])]
        fmax = max(f[s] for s in allowed)
        tot = fmax + math.log(sum(math.exp(f[s] - fmax) for s in allowed))
        np.testing.assert_allclose(float(res.total[b]), tot, rtol=1e-9)

    ghb, ghc, ginf = _golden_arrays(ped, acc, ind_index, NI)
    np.testing.assert_allclose(hb, ghb, atol=1e-10)
    np.testing.assert_allclose(hc, ghc, atol=1e-10)
    np.testing.assert_allclose(inf, ginf, atol=1e-10)


@pytest.mark.parametrize("make,cfg", [(make_selfed_ped, CFG_SELF),
                                      (make_relskew_ped, CFG_REL)])
def test_ext_turn_weights_match_golden(make, cfg):
    ped = make()
    eng = GoldenDoit(ped).eng
    fb, res, *_ = _merged_scan(ped)
    M = ped.num_markers
    tw = np.asarray(res.turn_weight)

    for b, n in enumerate(ped.dous):
        ind = ped.by_id(n)
        shiftignore = int(fb.shiftignore[b])
        fbs = {s: eng.fwbw(ind, 0, M - 1, s)
               for s in range(cfg.numshifts)}
        desc = max(ind.descendants, 1)
        for q in (1, M // 2):
            vals = []
            for t in range(cfg.numturns):
                raws = [eng.turn_probe(ind, fbs, 0, q, t, s)
                        for s in range(cfg.numshifts)
                        if not (s & shiftignore)]
                mx = max(raws)
                vals.append(mx + math.log(sum(math.exp(r - mx)
                                              for r in raws)))
            want = (np.array(vals) - vals[0]) * desc
            np.testing.assert_allclose(tw[b, q], want, atol=1e-8)


def test_driver_full_iteration_selfed_cohort():
    """The full iteration loop (scan -> flips -> capped-GD updates ->
    imputation) runs end-to-end on a selfed cohort and recovers masked
    genotypes — the extended-space form of the reference's complete doit
    under the SELFING build (settings.h:33-46)."""
    from cnf2freq_tpu.utils.harness import run_experiment
    from cnf2freq_tpu.utils.simulate import simulate_selfed

    ped = simulate_selfed(n_lines=6, n_markers=16, generations=4,
                          missing_rate=0.1, error_rate=0.01, seed=5)
    out = run_experiment(ped, every=5, iterations=10)
    assert out["total"] >= 5
    # selfed lines are near-homozygous: recovery should be easy
    # (measured: 22/24 majority-called correct = 92%; priors at held-out
    # sites are blanked per the reference's masking semantics)
    assert out["majority_call_rate"] >= 0.9, out
    assert out["majority_accuracy"] >= 0.85, out


def test_driver_full_iteration_relskewstates():
    """Full iteration under the RELSKEWSTATES config (coherence bit in
    the hidden state): runs, stays finite, keeps weights in bounds."""
    import dataclasses

    from cnf2freq_tpu.driver import Driver

    ped = make_relskew_ped(M=10)
    drv = Driver(ped)
    drv.preprocess()
    drv.iterate(early=True)
    info = drv.iterate()
    assert np.isfinite(info["hitnnn"])
    for ind in ped.inds[1:]:
        if ind.haploweight is not None:
            assert ((ind.haploweight >= 0) & (ind.haploweight <= 1)).all()


def test_ext_pair_posterior_normalised():
    """The genotype-pair posterior sums to the focal's own infprob mass
    share and normalises to a proper distribution per marker."""
    ped = make_selfed_ped()
    fb, res, *_ = _merged_scan(ped)
    pair = np.asarray(res.pair)
    tot = pair.sum(axis=(-1, -2))
    assert (tot > 0).all()
    p = pair / tot[..., None, None]
    assert np.isfinite(p).all()
    assert ((p >= 0) & (p <= 1)).all()


def test_relskew_coherence_ext_matches_bruteforce():
    """The coherence-bit xor-marginal (relhaplo EM statistic) vs direct
    enumeration over the extended state pairs with golden quantities."""
    import jax.numpy as jnp

    from cnf2freq_tpu.config import RuntimeParams
    from cnf2freq_tpu.engine_ext import (ext_blocks,
                                         extended_forward_backward,
                                         relskew_coherence_ext)
    from cnf2freq_tpu.golden import GoldenEngine
    from cnf2freq_tpu.hmm.family import gather_family

    ped = make_relskew_ped(M=6, seed=9)
    cfg, params = CFG_REL, RuntimeParams()
    eng = GoldenEngine(ped)
    M = ped.num_markers
    fb = gather_family(ped, list(ped.dous), 0, M - 1,
                       mask_mode="reference")
    fbj = fb.map(jnp.asarray)
    dists = jnp.asarray(np.diff(ped.markerposes))
    blocks, e_ext, _, _ = ext_blocks(fbj, cfg)
    fbres = extended_forward_backward(e_ext, dists, fbj, cfg, params)
    c_fast = np.asarray(relskew_coherence_ext(fbres, e_ext, fbj, cfg,
                                              params, dists))

    b = 0
    n = ped.dous[b]
    ind = ped.by_id(n)
    S = cfg.numtypes
    fbs = {s: eng.fwbw(ind, 0, M - 1, s) for s in range(cfg.numshifts)}
    for m in (1, 3):
        dist = ped.markerposes[m + 1] - ped.markerposes[m]
        rp = eng.recombprec(dist)
        relh = float(ind.relhaplo[m])
        relscore = np.array([[relh, 1 - relh], [1 - relh, relh]])
        J = np.zeros((2, 2))
        fmax = max(fbs[s]["fw_post_f"][m] + fbs[s]["bw_f"][m + 1]
                   for s in range(cfg.numshifts))
        for s in range(cfg.numshifts):
            w = np.exp(fbs[s]["fw_post_f"][m] + fbs[s]["bw_f"][m + 1]
                       - fmax)
            fwp = fbs[s]["fw_post"][m]
            bwv = fbs[s]["bw"][m + 1]
            E2 = eng.emission(ind, m + 1, s)
            for vf in range(2):
                for vt in range(2):
                    acc = 0.0
                    for g in range(S):
                        for g2 in range(S):
                            acc += (fwp[vf * S + g] * rp[g ^ g2] *
                                    E2[vt * S + g2] * bwv[vt * S + g2])
                    J[vf, vt] += w * acc * relscore[vf, vt]
        want = (J[0, 0] + J[1, 1]) / J.sum()
        np.testing.assert_allclose(c_fast[b, m], want, rtol=1e-9)


def test_driver_relskewstates_adaptive_relhaplo():
    """Full iterations under RELSKEWSTATES with the coherence-bit EM
    update of relhaplo: runs finite and moves relhaplo off its
    initial values for the analysis individuals."""
    from cnf2freq_tpu.driver import Driver

    ped = make_relskew_ped(M=10)
    before = {n: ped.by_id(n).relhaplo.copy() for n in ped.dous}
    drv = Driver(ped)
    assert drv.adaptive_relhaplo
    drv.preprocess()
    drv.iterate(early=True)
    info = drv.iterate()
    assert np.isfinite(info["hitnnn"])
    moved = any(np.abs(ped.by_id(n).relhaplo - before[n]).max() > 1e-6
                for n in ped.dous)
    assert moved
    for n in ped.dous:
        rh = ped.by_id(n).relhaplo
        assert ((rh > 0) & (rh < 1)).all()


def test_selfing_coherence_selfgen0_reduces_to_standard():
    """coherence_slot_ext at selfgen=0 (HBD unreachable: the coupling
    funnels all mass to selfval 0) equals the standard-space per-slot
    coherence on the same family."""
    import dataclasses

    import jax.numpy as jnp

    from cnf2freq_tpu.config import RuntimeParams
    from cnf2freq_tpu.engine_ext import (coherence_slot_ext, ext_blocks,
                                         extended_forward_backward)
    from cnf2freq_tpu.hmm.emission import build_blocks
    from cnf2freq_tpu.hmm.family import gather_family
    from cnf2freq_tpu.hmm.forward_backward import forward_backward
    from cnf2freq_tpu.hmm.probes import phase_coherence_slot
    from cnf2freq_tpu.hmm.transition import (interval_recomb,
                                             transition_eigenvalues)
    from cnf2freq_tpu.hmm.emission import assemble_e_all

    params = RuntimeParams()
    ped = make_selfed_ped(M=6, seed=11)
    # make the focal units selfgen 0 (gen=2) so HBD mass vanishes
    for n in ped.dous:
        ped.by_id(n).gen = 2
    M = ped.num_markers
    fb = gather_family(ped, list(ped.dous), 0, M - 1,
                       mask_mode="reference")
    fbj = fb.map(jnp.asarray)
    dists = jnp.asarray(np.diff(ped.markerposes))
    blocks_v, e_ext, _, _ = ext_blocks(fbj, CFG_SELF)
    fbres = extended_forward_backward(e_ext, dists, fbj, CFG_SELF,
                                      params)

    # standard-space reference on the equivalent plain config
    cfg_std = ModelConfig()
    ped2 = make_selfed_ped(M=6, seed=11)
    for n in ped2.dous:
        ped2.by_id(n).gen = 2
    ped2.config = cfg_std
    fb2 = gather_family(ped2, list(ped2.dous), 0, M - 1,
                        mask_mode="reference")
    fb2j = fb2.map(jnp.asarray)
    blocks_std = build_blocks(fb2j, cfg_std)
    e_std = assemble_e_all(blocks_std, cfg_std)
    fbres_std = forward_backward(e_std, dists, cfg_std, params)
    lam = transition_eigenvalues(
        cfg_std, interval_recomb(cfg_std, params, dists))
    for slot in (0, 1, 4):
        got = np.asarray(coherence_slot_ext(fbres, blocks_v, fbj,
                                            CFG_SELF, params, dists,
                                            slot))
        want = np.asarray(phase_coherence_slot(fbres_std, blocks_std,
                                               fb2j, cfg_std, lam, slot))
        # near-reduction, not exact: even at selfgen=0 the HBD states
        # carry backward mass (the reference's extended build
        # normalises adjustprobs over the full state vector too,
        # cnF2freq.cpp:1602-1668), which reweights the per-shift
        # factors at the 1e-4 level
        np.testing.assert_allclose(got, want, atol=2e-3,
                                   err_msg=f"slot {slot}")


def test_driver_selfing_adaptive_relhaplo():
    """Selfed-cohort iterations with per-slot extended-space coherence:
    finite, in-bounds, relhaplo moves."""
    from cnf2freq_tpu.driver import Driver
    from cnf2freq_tpu.utils.simulate import simulate_selfed

    ped = simulate_selfed(n_lines=4, n_markers=12, generations=4, seed=2)
    before = {n: ped.by_id(n).relhaplo.copy() for n in ped.dous}
    drv = Driver(ped)
    assert drv.adaptive_relhaplo
    drv.preprocess()
    drv.iterate(early=True)
    info = drv.iterate()
    assert np.isfinite(info["hitnnn"])
    moved = any(np.abs(ped.by_id(n).relhaplo - before[n]).max() > 1e-6
                for n in ped.dous)
    assert moved
    for n in ped.dous:
        rh = ped.by_id(n).relhaplo
        assert ((rh > 0) & (rh < 1)).all()


@pytest.mark.parametrize("model", ["selfing", "relskewstates"])
def test_cli_extended_models_demo(model, tmp_path):
    """--model selfing / relskewstates drive the extended-state engines
    end-to-end through the CLI on the demo dataset."""
    from cnf2freq_tpu.cli import main

    out = tmp_path / "out.txt"
    rc = main(["--mapfile", "/root/reference/demoplantimpute.map",
               "--pedfile", "/root/reference/demoplantimpute.ped",
               "--genfile", "/root/reference/demoplantimpute.gen",
               "--model", model, "--count", "1",
               "--output", str(out),
               "--dump", str(tmp_path / "dump.txt")])
    assert rc == 0
    assert out.read_text().strip()


@pytest.mark.parametrize("make_ped,cfg", [(make_selfed_ped, CFG_SELF),
                                          (make_relskew_ped, CFG_REL)])
def test_ext_recomb_expectations_match_dense(make_ped, cfg):
    """Extended-space recombination expectations (map re-estimation)
    vs a dense golden joint: P(bit t recombined in interval) from the
    explicit pairwise state joint with the golden transition."""
    import jax.numpy as jnp

    from cnf2freq_tpu.engine_ext import (chromosome_scan_ext,
                                         make_jitted_recomb_ext)
    from cnf2freq_tpu.golden.engine import GoldenEngine
    from cnf2freq_tpu.hmm.family import gather_family

    ped = make_ped()
    eng = GoldenEngine(ped)
    eng.correction_inference = False
    M = ped.num_markers
    dous = list(ped.dous)
    fb = gather_family(ped, dous, 0, M - 1, dtype=np.float64)
    fbj = fb.map(jnp.asarray)
    dists = jnp.asarray(np.diff(ped.markerposes))
    from cnf2freq_tpu.config import RuntimeParams
    params = RuntimeParams()
    res = chromosome_scan_ext(fbj, dists, cfg, params)
    run = make_jitted_recomb_ext(cfg, params)
    P = np.asarray(run(fbj, dists, res.fw_pre, res.bw, res.fw_pre_f,
                       res.bw_f))

    S = cfg.numstates
    base = cfg.numtypes
    for b, n in enumerate(dous):
        ind = ped.by_id(n)
        selfgen = max(ind.gen - 2, 0) if cfg.selfing else 0
        shiftend = cfg.numshifts
        fbs = {s: eng.fwbw(ind, 0, M - 1, s) for s in range(shiftend)}
        for j in range(M - 1):
            dist = ped.markerposes[j + 1] - ped.markerposes[j]
            relh = 0.5 if not cfg.relskewstates else \
                float(ind.relhaplo[j])
            # dense transition columns
            T = np.zeros((S, S))
            for frm in range(S):
                e_i = np.zeros(S)
                e_i[frm] = 1.0
                T[frm] = eng.transition(e_i, dist, selfgen, relh)
            pxor = np.zeros(base)
            for s in range(shiftend):
                fbd = fbs[s]
                w = math.exp(fbd["fw_post_f"][j] + fbd["bw_f"][j + 1])
                e1 = eng.emission(ind, j + 1, s, -1)
                joint = (fbd["fw_post"][j][:, None] * T *
                         (e1 * fbd["bw"][j + 1])[None, :]) * w
                for frm in range(S):
                    for to in range(S):
                        pxor[(frm ^ to) & (base - 1)] += joint[frm, to]
            tot = pxor.sum()
            if tot <= 0:
                continue
            pxor /= tot
            for t in range(cfg.typebits):
                want = sum(pxor[x] for x in range(base)
                           if (x >> t) & 1)
                np.testing.assert_allclose(P[b, j, t], want, atol=1e-9,
                                           err_msg=f"{n} {j} {t}")


def test_ext_driver_remap_distances_runs():
    """Map re-estimation on the extended spaces through the full driver:
    the re-estimated ped.actrec moves and stays in range, and the next
    iteration consumes it without error."""
    from cnf2freq_tpu.driver import Driver
    from cnf2freq_tpu.utils.simulate import simulate_selfed

    ped = simulate_selfed(n_lines=6, n_markers=10, generations=4, seed=2)
    drv = Driver(ped, dtype=np.float64)
    drv.remap_distances = True
    drv.adaptive_relhaplo = False
    drv.preprocess()
    drv.iterate(early=True)
    assert ped.actrec is not None
    before = ped.actrec.copy()
    drv.iterate(early=False)
    assert np.isfinite(ped.actrec).all()
    assert (ped.actrec <= 0).all()          # rates are negative logs
    assert np.abs(ped.actrec - before).max() > 0
