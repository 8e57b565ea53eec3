"""Selfed-line model family (SELFING state-space extension) vs golden.

The golden scalar engine implements the reference's SELFING semantics
(collapsed HBD pair cnF2freq.cpp:1122-1189, selfprec transitions
cnF2freq.cpp:2316-2364, selfingfactors prior cnF2freq.cpp:2050-2063); the
tensorised module (models/selfing.py) must agree to near machine
precision.
"""

import numpy as np
import pytest

from cnf2freq_tpu import ModelConfig, Pedigree
from cnf2freq_tpu.config import MINFACTOR, RuntimeParams
from cnf2freq_tpu.golden import GoldenEngine
from cnf2freq_tpu.hmm import gather_family
from cnf2freq_tpu.models.selfing import (
    combined_loglik_self, selfing_emission, selfing_forward_backward,
    selfing_scan)

CFG = ModelConfig(selfing=True)


def selfed_pedigree(seed=0, M=6, gen=4, with_errors=True, selfed=True):
    rng = np.random.default_rng(seed)
    ped = Pedigree(CFG)
    ped.markerposes = np.linspace(0.0, 50.0, M)
    ped.chromstarts = [0, M]
    names = ["gp00", "gp01", "gp10", "gp11", "par0", "par1", "kid"]
    by = {nm: ped.getind(nm) for nm in names}
    ped.freeze()
    by["par0"].pars = (by["gp00"].n, by["gp01"].n)
    by["par1"].pars = (by["gp10"].n, by["gp11"].n)
    if selfed:
        by["kid"].pars = (by["par0"].n, by["par0"].n)
    else:
        by["kid"].pars = (by["par0"].n, by["par1"].n)
    for nm, ind in by.items():
        ind.empty = False
        ind.markerdata[:] = rng.integers(0, 3, size=(M, 2))
        if with_errors:
            ind.markersure[:] = np.where(
                ind.markerdata == 0, 0.0,
                rng.uniform(0.0, 0.3, size=(M, 2)))
        else:
            ind.markersure[:] = 0.0
        ind.haploweight[:] = rng.uniform(0.05, 0.95, size=M)
    by["kid"].gen = gen
    ped.dous = [by["kid"].n]
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    return ped, by["kid"]


def golden_run(ped, kid):
    """Per-shift fwbw over the extended state space."""
    eng = GoldenEngine(ped)
    M = ped.num_markers
    return eng, {s: eng.fwbw(kid, 0, M - 1, s)
                 for s in range(ped.config.numshifts)}


@pytest.mark.parametrize("seed,gen,selfed", [
    (0, 4, True), (1, 3, True), (2, 6, True), (3, 2, True), (4, 5, False),
])
def test_selfing_fb_matches_golden(seed, gen, selfed):
    import jax.numpy as jnp
    ped, kid = selfed_pedigree(seed=seed, gen=gen, selfed=selfed)
    cfg, params = ped.config, RuntimeParams()
    M = ped.num_markers
    eng, gold = golden_run(ped, kid)

    fb = gather_family(ped, ped.dous, 0, M - 1)
    dists = np.diff(ped.markerposes)
    selfgen = np.array([max(kid.gen - 2, 0)])
    e = selfing_emission(fb, cfg)
    fbres = selfing_forward_backward(e, jnp.asarray(dists), selfgen, cfg,
                                     params)
    S = cfg.numtypes
    for s in range(cfg.numshifts):
        got = np.asarray(fbres.fw_post_f[0, -1, s])
        want = gold[s]["fw_post_f"][-1]
        if want <= MINFACTOR:
            assert got <= MINFACTOR / 2
            continue
        np.testing.assert_allclose(got, want, rtol=1e-9,
                                   err_msg=f"shift {s}")
        # posterior state vectors at every marker
        for m in range(M):
            ours = np.asarray(fbres.fw_post[0, m, :, :, s]).reshape(3 * S)
            g_post = gold[s]["fw_post"][m]
            np.testing.assert_allclose(ours, g_post, rtol=1e-9,
                                       atol=1e-12,
                                       err_msg=f"shift {s} marker {m}")
        # backward store too: the reference applies the UNtransposed
        # selfprec in the backward sweep (cnF2freq.cpp:2352-2364), which
        # differs from the adjoint for selfgen > 0
        for m in range(M):
            ours = np.asarray(fbres.bw[0, m, :, :, s]).reshape(3 * S)
            g_bw = gold[s]["bw"][m]
            scale = np.exp(gold[s]["bw_f"][m]
                           - np.asarray(fbres.bw_f[0, m, s]))
            np.testing.assert_allclose(ours, g_bw * scale, rtol=1e-9,
                                       atol=1e-12,
                                       err_msg=f"bw shift {s} marker {m}")


def test_selfgen0_reduces_to_base_model():
    """gen==2 (selfgen 0): no HBD mass, loglik == base engine up to the
    EVENGEN prior-padding constant log(1/4) (settings.h:27-28,46)."""
    import jax.numpy as jnp
    from cnf2freq_tpu.hmm import emission_all
    from cnf2freq_tpu.hmm.forward_backward import (combined_loglik,
                                                   forward_backward)

    ped, kid = selfed_pedigree(seed=7, gen=2)
    params = RuntimeParams()
    M = ped.num_markers
    fb = gather_family(ped, ped.dous, 0, M - 1)
    dists = jnp.asarray(np.diff(ped.markerposes))

    total_self, post, hbd = selfing_scan(fb, dists, np.array([0]),
                                         ped.config, params)

    base_cfg = ModelConfig()
    e = emission_all(fb, base_cfg)
    fbres = forward_backward(e, dists, base_cfg, params)
    total_base = combined_loglik(fbres, fb.shiftignore)

    np.testing.assert_allclose(np.asarray(total_self),
                               np.asarray(total_base) + np.log(0.25),
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(hbd), 0.0, atol=1e-12)


def test_hbd_posterior_behaviour():
    """A deeply selfed, fully homozygous individual is called HBD with
    high probability; a certain heterozygous marker forces P(HBD)=0."""
    import jax.numpy as jnp
    ped, kid = selfed_pedigree(seed=3, gen=8, with_errors=False)
    M = ped.num_markers
    # heterozygous ancestry, homozygous kid — except a certain het at
    # marker 2, only explainable by a non-HBD state
    for ind in ped.inds[1:]:
        ind.markerdata[:] = (1, 2)
    kid.markerdata[:] = 1
    kid.markerdata[2] = (1, 2)
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)

    fb = gather_family(ped, ped.dous, 0, M - 1)
    dists = jnp.asarray(np.diff(ped.markerposes))
    total, post, hbd = selfing_scan(fb, dists, np.array([6]), ped.config,
                                    RuntimeParams())
    hbd = np.asarray(hbd)[0]
    assert hbd[2] < 1e-12, "certain het cannot be HBD"
    far = [m for m in range(M) if abs(m - 2) >= 2]
    assert (hbd[far] > 0.5).all(), f"selfgen=6 should favour HBD: {hbd}"
