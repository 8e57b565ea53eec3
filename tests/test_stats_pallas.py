"""The enum-leading statistics (ops/enum_stats.stats_tile, the XLA form
of the statistics stage on the GPU) agree exactly with the probes path."""
import jax.numpy as jnp
import numpy as np

from cnf2freq_tpu.config import ModelConfig, RuntimeParams
from cnf2freq_tpu.hmm import probes as pr
from cnf2freq_tpu.hmm.emission import assemble_e_all, build_blocks
from cnf2freq_tpu.hmm.family import gather_family
from cnf2freq_tpu.hmm.forward_backward import (combined_loglik,
                                               forward_backward)
from cnf2freq_tpu.ops import dispatch
from cnf2freq_tpu.ops.enum_stats import stats_tile
from cnf2freq_tpu.utils import simulate_f2


def _setup(B=6, M=9, dtype=np.float64, seed=3):
    ped = simulate_f2(n_f2=B, n_markers=M, n_founder_pairs=2, seed=seed)
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_descendants()
    fb = gather_family(ped, ped.dous, 0, ped.num_markers - 1, dtype=dtype)
    # de-degenerate: random phase weights and some error probability
    rng = np.random.default_rng(seed)
    fb.hw = rng.uniform(0.05, 0.95, fb.hw.shape)
    fb.ms = np.where(fb.md > 0, rng.uniform(0.0, 0.3, fb.ms.shape), fb.ms)
    dists = np.diff(ped.markerposes).astype(dtype)
    cfg = ModelConfig()
    params = RuntimeParams()
    fbj = fb.map(jnp.asarray)
    blocks = build_blocks(fbj, cfg, dtype=jnp.float64)
    e = assemble_e_all(blocks, cfg)
    fbres = forward_backward(e, jnp.asarray(dists), cfg, params)
    total = combined_loglik(fbres, fbj.shiftignore)
    return fbj, blocks, fbres, total, cfg


def _stats_std(fb, fbres, total, cfg):
    """stats_tile on standard-layout [B, M, ...] tensors: enum axes moved
    to the front, data axes (B, M) trailing."""
    B, _, M, _ = fb.md.shape

    def per_unit(x):        # [B, 7] -> [7, B, 1]
        return jnp.transpose(x)[:, :, None]

    fw = jnp.transpose(fbres.fw_pre.reshape(B, M, 2, 2, 2, 8, 8),
                       (5, 6, 2, 3, 4, 0, 1))
    bw = jnp.transpose(fbres.bw.reshape(B, M, 2, 2, 2, 8, 8),
                       (5, 6, 2, 3, 4, 0, 1))
    fwf = jnp.transpose(fbres.fw_pre_f.reshape(B, M, 2, 2, 2),
                        (2, 3, 4, 0, 1))
    bwf = jnp.transpose(fbres.bw_f.reshape(B, M, 2, 2, 2), (2, 3, 4, 0, 1))
    b12, acc, pair = stats_tile(
        jnp.transpose(fb.md, (1, 3, 0, 2)), jnp.transpose(fb.ms, (1, 3, 0, 2)),
        jnp.transpose(fb.hw, (1, 0, 2)), per_unit(fb.exists),
        per_unit(fb.attop), fb.flag2ignore[:, None],
        fb.shiftignore[:, None], fw, bw, fwf, bwf, total[:, None], cfg)

    def back(x):            # [*enum, B, M] -> [B, M, *enum]
        nl = x.ndim - 2
        return jnp.transpose(x, (nl, nl + 1) + tuple(range(nl)))

    return back(b12), back(acc), back(pair)


def test_stats_kernel_matches_xla_probes():
    fbj, blocks, fbres, total, cfg = _setup()
    W = pr.posterior_weight(fbres, total, fbj.shiftignore)
    hs = pr.haplo_stats(W, blocks, fbj, cfg)
    ist = pr.infprob_stats(W, blocks, fbj, cfg)

    b12, accum, pair = _stats_std(fbj, fbres, total, cfg)

    np.testing.assert_allclose(np.asarray(b12), np.asarray(hs.b12),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(accum), np.asarray(ist.accum),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(pair), np.asarray(ist.pair),
                               rtol=1e-9, atol=1e-12)


def test_engine_stats_pallas_path_matches():
    """chromosome_scan's feature-leading stats stage with the probe-dedup
    rules on (parity mode) agrees with the standard path's contraction
    form, variant for variant."""
    from cnf2freq_tpu.engine import chromosome_scan

    cfg, params = ModelConfig(), RuntimeParams()
    ped = simulate_f2(n_f2=4, n_markers=7, n_founder_pairs=2, seed=5)
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_descendants()
    fbj = gather_family(ped, ped.dous, 0, ped.num_markers - 1,
                        mask_mode="reference", parity=True,
                        n_variants=4).map(jnp.asarray)
    dists = jnp.asarray(np.diff(ped.markerposes).astype(np.float64))

    kw = dict(probe_rules=True, n_variants=4)
    ref = chromosome_scan(fbj, dists, cfg, params,
                          plan=dispatch.ScanPlan("std", "xla"), **kw)
    out = chromosome_scan(fbj, dists, cfg, params,
                          plan=dispatch.ScanPlan("v2", "xla"), **kw)
    np.testing.assert_allclose(np.asarray(out.haplo_b12),
                               np.asarray(ref.haplo_b12),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(out.inf_accum),
                               np.asarray(ref.inf_accum),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(out.pair), np.asarray(ref.pair),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(out.haplo_mask),
                                  np.asarray(ref.haplo_mask))


def test_stats_kernel_nonaligned_batch():
    # B and M far from any power of two: the statistics must not depend
    # on the data-axis shape
    fbj, blocks, fbres, total, cfg = _setup(B=3, M=5, seed=11)
    W = pr.posterior_weight(fbres, total, fbj.shiftignore)
    hs = pr.haplo_stats(W, blocks, fbj, cfg)
    b12, _, _ = _stats_std(fbj, fbres, total, cfg)
    np.testing.assert_allclose(np.asarray(b12), np.asarray(hs.b12),
                               rtol=1e-9, atol=1e-12)
