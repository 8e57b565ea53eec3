"""Dedicated numgen==2 (4-state) engine vs the golden doit spec run at
the numgen==2 config (the QTLMAS15 shape: 4 states, 8 paths, 2 shifts,
settings.h:76-91)."""

import math

import numpy as np
import pytest

from cnf2freq_tpu import ModelConfig, Pedigree
from cnf2freq_tpu.golden.doit import GoldenDoit

CFG2 = ModelConfig(numgen=2)


def make_ng2_ped(M=8, seed=2):
    """Two half-sib trio families sharing parent 'pB': kids k0, k1 from
    (pA, pB); k2 from (pC, pB)."""
    rng = np.random.default_rng(seed)
    ped = Pedigree(CFG2)
    ped.markerposes = np.linspace(0, 70, M)
    ped.chromstarts = [0, M]
    names = ["pA", "pB", "pC", "k0", "k1", "k2"]
    by = {nm: ped.getind(nm) for nm in names}
    by["k0"].pars = (by["pA"].n, by["pB"].n)
    by["k1"].pars = (by["pA"].n, by["pB"].n)
    by["k2"].pars = (by["pC"].n, by["pB"].n)
    for k in ("k0", "k1", "k2"):
        by[k].gen = 2
    ped.dous = [by["k0"].n, by["k1"].n, by["k2"].n]
    ped.freeze()
    for ind in ped.inds[1:]:
        ind.empty = False
        ind.markerdata[:] = rng.integers(1, 3, (M, 2))
        ind.markersure[:] = 0.02
        ind.haploweight[:] = rng.uniform(0.25, 0.75, M)
    by["k0"].markerdata[3] = 0
    by["k0"].markersure[3] = 0.0
    by["k2"].markerdata[5, 1] = 0
    by["k2"].markersure[5, 1] = 0.0
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_children()
    ped.count_descendants()
    return ped


def _merged_scan(ped, dtype=np.float64):
    import jax.numpy as jnp

    from cnf2freq_tpu.config import RuntimeParams
    from cnf2freq_tpu.engine import make_jitted_scan_merged
    from cnf2freq_tpu.hmm.family import gather_family
    from cnf2freq_tpu.hmm.transition import rate_matrix

    ids = [ind.n for ind in ped.inds[1:]]
    ind_index = {n: i for i, n in enumerate(ids)}
    NI = len(ids)
    lut = np.full(max(ids) + 1, NI, dtype=np.int32)
    for n, i in ind_index.items():
        lut[n] = i
    M = ped.num_markers
    fb = gather_family(ped, list(ped.dous), 0, M - 1, dtype=dtype,
                       mask_mode="reference")
    dists = jnp.asarray(np.diff(ped.markerposes).astype(dtype))
    rm = jnp.asarray(rate_matrix(ped.config, RuntimeParams(), M - 1,
                                 dtype=dtype))
    scan_fn = make_jitted_scan_merged(ped.config, RuntimeParams(), NI)
    res, hb, hc, inf = scan_fn(fb.map(jnp.asarray), dists,
                               jnp.asarray(lut), rm)
    return (fb, res, np.asarray(hb), np.asarray(hc), np.asarray(inf),
            ind_index, NI)


def test_ng2_scan_matches_golden_doit():
    ped = make_ng2_ped()
    acc = GoldenDoit(ped).scan()
    fb, res, hb, hc, inf, ind_index, NI = _merged_scan(ped)
    M = ped.num_markers

    for b, n in enumerate(ped.dous):
        f = acc.factors[n]
        allowed = [s for s in range(CFG2.numshifts)
                   if not (s & fb.shiftignore[b])]
        fmax = max(f[s] for s in allowed)
        tot = fmax + math.log(sum(math.exp(f[s] - fmax) for s in allowed))
        np.testing.assert_allclose(float(res.total[b]), tot, rtol=1e-9)

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
    np.testing.assert_allclose(hb, ghb, atol=1e-10)
    np.testing.assert_allclose(hc, ghc, atol=1e-10)
    np.testing.assert_allclose(inf, ginf, atol=1e-10)


def test_ng2_turn_weights_match_golden():
    ped = make_ng2_ped()
    eng = GoldenDoit(ped).eng
    fb, res, *_ = _merged_scan(ped)
    M = ped.num_markers
    tw = np.asarray(res.turn_weight)

    for b, n in enumerate(ped.dous):
        ind = ped.by_id(n)
        shiftignore = int(fb.shiftignore[b])
        fbs = {s: eng.fwbw(ind, 0, M - 1, s)
               for s in range(CFG2.numshifts)}
        desc = max(ind.descendants, 1)
        for q in (1, M // 2):
            vals = []
            for t in range(CFG2.numturns):
                raws = [eng.turn_probe(ind, fbs, 0, q, t, s)
                        for s in range(CFG2.numshifts)
                        if not (s & shiftignore)]
                mx = max(raws)
                vals.append(mx + math.log(sum(math.exp(r - mx)
                                              for r in raws)))
            want = (np.array(vals) - vals[0]) * desc
            np.testing.assert_allclose(tw[b, q], want, atol=1e-8)


def test_driver_full_iteration_ng2():
    """The full iteration loop runs on the 4-state config and recovers
    masked genotypes on a half-sib cohort."""
    from cnf2freq_tpu.driver import Driver
    from cnf2freq_tpu.utils.harness import mask_markers, score_recovery

    rng = np.random.default_rng(7)
    M, K = 24, 10
    ped = Pedigree(CFG2)
    ped.markerposes = np.arange(M) * 1.0
    ped.chromstarts = [0, M]
    names = ["sire", "damA", "damB"] + [f"kid{i}" for i in range(K)]
    by = {nm: ped.getind(nm) for nm in names}
    for i in range(K):
        by[f"kid{i}"].pars = (by["sire"].n,
                              by["damA" if i % 2 else "damB"].n)
        by[f"kid{i}"].gen = 2
        ped.dous.append(by[f"kid{i}"].n)
    ped.freeze()

    def meiosis(geno):
        d = np.diff(ped.markerposes)
        rec = 0.5 * (1 - np.exp(-2 * d / 100.0))
        strand = rng.integers(0, 2)
        idx = [strand]
        for r in rec:
            if rng.random() < r:
                strand ^= 1
            idx.append(strand)
        return geno[np.arange(M), idx]

    truth = {}
    for ind in ped.inds[1:4]:
        ind.empty = False
        t = rng.integers(1, 3, (M, 2)).astype(np.int32)
        truth[ind.n] = t
        ind.markerdata[:] = t
        ind.markersure[:] = 0.01
        ind.haploweight[:] = 0.5
    # kids inherit one LINKED gamete from each parent (the imputation
    # signal is the recombination structure)
    for i in range(K):
        kid = by[f"kid{i}"]
        kid.empty = False
        pa = truth[kid.pars[0]]
        pb = truth[kid.pars[1]]
        t = np.stack([meiosis(pa), meiosis(pb)], axis=1)
        truth[kid.n] = t
        kid.markerdata[:] = t
        kid.markersure[:] = 0.01
        kid.haploweight[:] = 0.5
    for ind in ped.inds[1:]:
        # the imputation write-back follows the reference's prior flow
        # (processinfprobs prior term, cnF2freq.cpp:4232-4260)
        ind.priormarkerdata = ind.markerdata.copy()
        ind.priormarkersure = ind.markersure.copy()
        ind.has_prior = True
        ped.fixtrees(ind.n)

    res = mask_markers(ped, every=6)
    drv = Driver(ped)
    drv.preprocess()
    drv.iterate(early=True)
    for _ in range(9):
        info = drv.iterate()
        assert np.isfinite(info["hitnnn"])
    # regression bar, not a phasing-quality claim: founder phase on a
    # small random half-sib cohort converges slowly (the reference's
    # fixed point under the same updates — the scans are pinned
    # exactly against the golden doit above); measured: 21/40 at
    # majority confidence, all sites called
    out = score_recovery(ped, res, sure_threshold=0.5)
    assert out["total"] >= 5
    assert out["called"] >= out["total"] * 0.8
    assert out["accuracy"] >= 0.45, out
    for ind in ped.inds[1:]:
        if ind.haploweight is not None:
            assert ((ind.haploweight >= 0) & (ind.haploweight <= 1)).all()


def test_ng2_routes_no_haplotyping_to_dedicated_engine():
    """numgen==2 without haplotyping routes to the deep-walk engine
    (engine_nohaplo.py) — functional coverage in tests/test_nohaplo.py."""
    import jax.numpy as jnp

    from cnf2freq_tpu.config import RuntimeParams
    from cnf2freq_tpu.engine import chromosome_scan
    from cnf2freq_tpu.hmm.family import gather_family

    cfg = ModelConfig(numgen=2, haplotyping=False, relskews=False,
                      do_infprobs=False)
    ped = make_ng2_ped()
    ped.config = cfg
    for ind in ped.inds[1:]:
        ind.founder = False
    fb = gather_family(ped, list(ped.dous), 0, ped.num_markers - 1)
    res = chromosome_scan(fb.map(jnp.asarray),
                          jnp.asarray(np.diff(ped.markerposes)), cfg,
                          RuntimeParams())
    assert res.total.shape == (fb.num_units,)
    assert res.pair.shape[-2:] == (2, 2)
    assert np.isfinite(np.asarray(res.total)).all()


def test_ng2_coherence_matches_bruteforce():
    """Adjacent-phase coherence on the 4-state engine vs direct
    enumeration over (shift, state, path) pairs with golden emissions."""
    import jax.numpy as jnp

    from cnf2freq_tpu.config import RuntimeParams
    from cnf2freq_tpu.engine import make_jitted_coherence
    from cnf2freq_tpu.golden import GoldenEngine
    from cnf2freq_tpu.hmm.family import gather_family
    from cnf2freq_tpu.hmm.forward_backward import (combined_loglik,
                                                   forward_backward)
    from cnf2freq_tpu.engine_ng2 import assemble_e_ng2, ng2_blocks

    ped = make_ng2_ped(M=7, seed=4)
    eng = GoldenEngine(ped)
    params = RuntimeParams()
    M = ped.num_markers
    fb = gather_family(ped, list(ped.dous), 0, M - 1,
                       mask_mode="reference")
    fbj = fb.map(jnp.asarray)
    dists = jnp.asarray(np.diff(ped.markerposes))
    froot, P2, top, fat = ng2_blocks(fbj, CFG2)
    e = assemble_e_ng2(froot, P2, top, fat, fbj, CFG2)
    fbres = forward_backward(e, dists, CFG2, params)
    coh_fn = make_jitted_coherence(CFG2, params)

    def phase_bit(slot, g, f2, s):
        if slot == 0:
            return (f2 & 1) ^ (s & 1)
        k = slot - 1
        return ((f2 >> (1 + k)) & 1) ^ ((g >> k) & 1)

    b = 0
    n = ped.dous[b]
    ind = ped.by_id(n)
    f2ig = int(fb.flag2ignore[b])
    m = 2
    dist = ped.markerposes[m + 1] - ped.markerposes[m]
    fw_pre = np.asarray(fbres.fw_pre)[b]
    bw = np.asarray(fbres.bw)[b]
    fw_pre_f = np.asarray(fbres.fw_pre_f)[b]
    bw_f = np.asarray(fbres.bw_f)[b]
    for slot in range(3):
        c_fast = np.asarray(coh_fn(fbj, dists, fbres.fw_pre, fbres.bw,
                                   fbres.fw_pre_f, fbres.bw_f, slot))
        jmat = np.zeros((2, 2))
        for s in range(CFG2.numshifts):
            w = np.exp(fw_pre_f[m, s] + bw_f[m + 1, s])
            for g in range(4):
                for f2 in range(CFG2.numpaths):
                    if f2 & f2ig:
                        continue
                    e1 = eng.emission(ind, m, s, f2)[g]
                    if e1 == 0:
                        continue
                    for g2 in range(4):
                        T = eng.recombprec(dist)[g ^ g2]
                        for f22 in range(CFG2.numpaths):
                            if f22 & f2ig:
                                continue
                            e2 = eng.emission(ind, m + 1, s, f22)[g2]
                            j1 = phase_bit(slot, g, f2, s)
                            j2 = phase_bit(slot, g2, f22, s)
                            jmat[j1, j2] += (fw_pre[m, s, g] * e1 * T *
                                             e2 * bw[m + 1, s, g2] * w)
        want = (jmat[0, 0] + jmat[1, 1]) / jmat.sum()
        np.testing.assert_allclose(c_fast[b, m], want, rtol=1e-9,
                                   err_msg=f"slot {slot}")


def test_cli_ng2_halfsib_demo(tmp_path):
    """--model ng2 runs the reference's half-sib MERLIN fixture through
    the 4-state engine end-to-end (the runtime form of recompiling
    settings.h with the NUMGEN==2 block)."""
    from cnf2freq_tpu.cli import main

    out = tmp_path / "out.txt"
    rc = main(["--merlinmap", "/root/reference/halfsibdemo.map",
               "--merlinped", "/root/reference/halfsibdemo.ped",
               "--model", "ng2", "--count", "2",
               "--allblocks",
               "--output", str(out),
               "--dump", str(tmp_path / "dump.txt")])
    assert rc == 0
    text = out.read_text()
    assert text.strip(), "genotype table written"


def test_ng2_driver_under_mesh_matches_single_device():
    """The 4-state driver under a virtual device mesh (shard_map scan +
    psum merges, in-scan coherence) equals single-device exactly."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs the multi-device CPU mesh")
    from cnf2freq_tpu.driver import Driver
    from cnf2freq_tpu.parallel import make_mesh

    def build():
        rng = np.random.default_rng(7)
        M, K = 12, 8
        ped = Pedigree(CFG2)
        ped.markerposes = np.arange(M) * 2.0
        ped.chromstarts = [0, M]
        names = ["s", "dA"] + [f"k{i}" for i in range(K)]
        by = {nm: ped.getind(nm) for nm in names}
        for i in range(K):
            by[f"k{i}"].pars = (by["s"].n, by["dA"].n)
            by[f"k{i}"].gen = 2
            ped.dous.append(by[f"k{i}"].n)
        ped.freeze()
        for ind in ped.inds[1:]:
            ind.empty = False
            ind.markerdata[:] = rng.integers(1, 3, (M, 2))
            ind.markersure[:] = 0.01
            ind.haploweight[:] = 0.5
        for ind in ped.inds[1:]:
            ped.fixtrees(ind.n)
        return ped

    def run(mesh):
        ped = build()
        drv = Driver(ped, mesh=mesh)
        drv.preprocess()
        info = drv.iterate(early=False)
        return info, np.stack([ped.by_id(n).haploweight
                               for n in ped.dous])

    n = min(len(jax.devices()), 8)
    i0, h0 = run(make_mesh(n))
    i1, h1 = run(None)
    np.testing.assert_allclose(h0, h1, rtol=1e-9, atol=1e-11)
    assert i0["hitnnn"] == i1["hitnnn"]
