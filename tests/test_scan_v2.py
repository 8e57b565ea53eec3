"""The feature-leading v2 scan path agrees with engine.chromosome_scan.

Pins the [M, X, R] layout pipeline (ops/scan_v2.py) — emissions,
feature-leading fb scan, enum-leading stats, WHT turn weights — against
the standard [B, M, NS, S] path to f32/f64 accumulation order, and the
Triton kernels (interpret mode) against the XLA forms.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cnf2freq_tpu.config import ModelConfig, RuntimeParams
from cnf2freq_tpu.hmm import probes as pr
from cnf2freq_tpu.hmm.emission import assemble_e_all, build_blocks
from cnf2freq_tpu.hmm.family import gather_family
from cnf2freq_tpu.hmm.forward_backward import (combined_loglik,
                                               forward_backward)
from cnf2freq_tpu.ops import dispatch
from cnf2freq_tpu.ops import scan_v2 as v2
from cnf2freq_tpu.utils import simulate_f2

XLA_V2 = dispatch.ScanPlan(layout="v2", fb="xla")
TRITON_V2 = dispatch.ScanPlan(layout="v2", fb="triton")
STD = dispatch.ScanPlan(layout="std", fb="xla")


def _setup(B=6, M=9, dtype=np.float64, seed=3, with_vacant=False):
    ped = simulate_f2(n_f2=B, n_markers=M, n_founder_pairs=2, seed=seed)
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_descendants()
    focals = list(ped.dous)
    if with_vacant:
        # F1 focals: founder parents, vacant grandparent slots
        f1s = [i.n for i in ped.inds[1:]
               if i.pars[0] and ped.by_id(i.pars[0]).founder][:2]
        focals = focals + f1s
    fb = gather_family(ped, focals, 0, ped.num_markers - 1, dtype=dtype)
    rng = np.random.default_rng(seed)
    fb.hw = rng.uniform(0.05, 0.95, fb.hw.shape).astype(dtype)
    fb.ms = np.where(fb.md > 0, rng.uniform(0.0, 0.3, fb.ms.shape),
                     fb.ms).astype(dtype)
    dists = jnp.asarray(np.diff(ped.markerposes).astype(dtype))
    cfg = ModelConfig()
    params = RuntimeParams()
    return fb.map(jnp.asarray), dists, cfg, params


def _v2_pipeline(fbj, dists, cfg, params, dtype):
    st = v2.prep_slots(fbj, dtype)
    e = v2.emissions_v2(st, cfg, dtype)
    fb2 = v2.fb_scan_v2(e, dists, cfg, params)
    total = v2.combined_loglik_v2(fb2, st.sh)
    return st, e, fb2, total


def test_emission_tiles_match_assemble_e():
    # with_vacant: F1 focals with empty grandparent slots pin the
    # no-flag2ignore-mask form of the emissions against assemble_e_all
    fbj, dists, cfg, params = _setup(with_vacant=True)
    dtype = jnp.float64
    B, _, M, _ = fbj.md.shape
    st, e, _, _ = _v2_pipeline(fbj, dists, cfg, params, dtype)
    assert e.shape == (M, 512, st.R)
    e_v2 = np.transpose(np.asarray(e[:, :, :B]), (2, 0, 1)).reshape(
        B, M, cfg.numshifts, cfg.numtypes)

    blocks = build_blocks(fbj, cfg, dtype=dtype)
    e_std = np.asarray(assemble_e_all(blocks, cfg))         # [B, M, NS, S]
    np.testing.assert_allclose(e_v2, e_std, rtol=1e-9, atol=1e-12)


def _to_std(x, B, cfg):  # [M, X, R] -> [B, M, NS, S]
    x = np.asarray(x[:, :, :B])
    return np.transpose(x, (2, 0, 1)).reshape(
        B, x.shape[0], cfg.numshifts, cfg.numtypes)


def _to_std_f(x, B):  # [M, NS, R] -> [B, M, NS]
    return np.transpose(np.asarray(x[:, :, :B]), (2, 0, 1))


def test_fb_scan_v2_matches_forward_backward():
    fbj, dists, cfg, params = _setup(B=5, M=8, seed=7)
    dtype = jnp.float64
    B = fbj.md.shape[0]
    st, _, fb2, total = _v2_pipeline(fbj, dists, cfg, params, dtype)

    blocks = build_blocks(fbj, cfg, dtype=dtype)
    e_std = assemble_e_all(blocks, cfg)
    ref = forward_backward(e_std, dists, cfg, params)
    ref_total = combined_loglik(ref, fbj.shiftignore)

    for name in ("fw_pre", "fw_post", "bw"):
        np.testing.assert_allclose(_to_std(getattr(fb2, name), B, cfg),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-12, err_msg=name)
    for name in ("fw_pre_f", "bw_f"):
        np.testing.assert_allclose(_to_std_f(getattr(fb2, name), B),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(np.asarray(total)[:B], np.asarray(ref_total),
                               rtol=1e-9, atol=1e-12)


def test_stats_and_turns_v2_match_probes():
    fbj, dists, cfg, params = _setup(B=6, M=9, seed=3)
    dtype = jnp.float64
    B, _, M, _ = fbj.md.shape
    st, _, fb2, total = _v2_pipeline(fbj, dists, cfg, params, dtype)

    b12, accum, pair = v2.stats_from_v2(st, fb2, total, M, B, cfg, dtype)
    turn_w = v2.turn_weights_v2(fb2, st.sh, fbj.descendants.astype(dtype),
                                cfg, B)

    blocks = build_blocks(fbj, cfg, dtype=dtype)
    e_std = assemble_e_all(blocks, cfg)
    ref = forward_backward(e_std, dists, cfg, params)
    ref_total = combined_loglik(ref, fbj.shiftignore)
    W = pr.posterior_weight(ref, ref_total, fbj.shiftignore)
    hs = pr.haplo_stats(W, blocks, fbj, cfg)
    ist = pr.infprob_stats(W, blocks, fbj, cfg)
    ref_turn = pr.turn_weights_fast(ref, fbj, cfg)

    np.testing.assert_allclose(np.asarray(b12), np.asarray(hs.b12),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(accum), np.asarray(ist.accum),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(pair), np.asarray(ist.pair),
                               rtol=1e-9, atol=1e-12)
    tw, rtw = np.asarray(turn_w), np.asarray(ref_turn)
    finite = np.isfinite(rtw) & (rtw > -1e14)
    np.testing.assert_allclose(tw[finite], rtw[finite], rtol=1e-7,
                               atol=1e-9)
    assert np.array_equal(finite, np.isfinite(tw) & (tw > -1e14))


def _kernel_inputs(B, M, seed, dtype):
    fbj, dists, cfg, params = _setup(B=B, M=M, seed=seed, dtype=dtype)
    st = v2.prep_slots(fbj, dtype)
    return v2.emissions_v2(st, cfg, dtype), dists, cfg, params, st, fbj


def test_fb_sweeps_pallas_matches():
    """The Triton sweep kernel (interpret mode) == fb_scan_v2 (XLA)."""
    e, dists, cfg, params, _, _ = _kernel_inputs(5, 8, 7, np.float64)
    ref = v2.fb_scan_v2(e, dists, cfg, params)
    got = v2.fb_sweeps_v2_triton(e, dists, cfg, params, interpret=True)
    for name in ref._fields:
        np.testing.assert_allclose(np.asarray(getattr(got, name)),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-12, err_msg=name)


def test_turn_weights_pallas_matches():
    """Turn weights from the Pallas sweep kernel's tensors (the GPU plan)
    == turn weights from the XLA sweeps, impossible entries included."""
    e, dists, cfg, params, st, fbj = _kernel_inputs(6, 9, 3, np.float64)
    B = fbj.md.shape[0]
    desc = fbj.descendants.astype(jnp.float64)
    ref = np.asarray(v2.turn_weights_v2(v2.fb_scan_v2(e, dists, cfg, params),
                                        st.sh, desc, cfg, B))
    fb2 = v2.fb_sweeps_v2_triton(e, dists, cfg, params, interpret=True)
    got = np.asarray(v2.turn_weights_v2(fb2, st.sh, desc, cfg, B))
    finite = ref > -1e14
    np.testing.assert_allclose(got[finite], ref[finite], rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_array_equal(finite, got > -1e14)


def test_fb_sweeps_triton_float32():
    """The kernel in float32 against the float32 XLA scan: the two
    differ only in the order of the transition's sums."""
    e, dists, cfg, params, _, _ = _kernel_inputs(5, 8, 7, np.float32)
    ref = v2.fb_scan_v2(e, dists, cfg, params)
    got = v2.fb_sweeps_v2_triton(e, dists, cfg, params, interpret=True)
    for name in ref._fields:
        assert getattr(got, name).dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(getattr(got, name)),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_fb_sweeps_pallas_single_marker():
    """M=1 edge: the backward sweep is pure initial state, the forward
    transition uses the padded identity eigenvalues."""
    import dataclasses

    fbj, dists, cfg, params = _setup(B=4, M=7, seed=5)
    dtype = jnp.float64
    fb1 = dataclasses.replace(fbj, md=fbj.md[:, :, :1],
                              ms=fbj.ms[:, :, :1], hw=fbj.hw[:, :, :1])
    e = v2.emissions_v2(v2.prep_slots(fb1, dtype), cfg, dtype)
    d1 = dists[:0]
    ref = v2.fb_scan_v2(e, d1, cfg, params)
    got = v2.fb_sweeps_v2_triton(e, d1, cfg, params, interpret=True)
    for name in ref._fields:
        np.testing.assert_allclose(np.asarray(getattr(got, name)),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-12, atol=1e-15, err_msg=name)


def test_fb_sweeps_triton_boundary_carries():
    """The kernel's boundary-carry form reproduces fb_scan_v2_block (the
    marker-blocked recompute)."""
    e, dists, cfg, params, _, _ = _kernel_inputs(4, 8, 9, np.float64)
    M, X, R = e.shape
    rng = np.random.default_rng(0)
    p0 = jnp.asarray(rng.uniform(0.1, 1.0, (X, R)))
    f0 = jnp.asarray(rng.uniform(-3.0, 0.0, (cfg.numshifts, R)))
    bT = jnp.asarray(rng.uniform(0.1, 1.0, (X, R)))
    bfT = jnp.asarray(rng.uniform(-3.0, 0.0, (cfg.numshifts, R)))
    lam_pad = v2._lam_pad(cfg, params, dists, None, jnp.float64)
    ref = v2.fb_scan_v2_block(e, lam_pad, p0, f0, bT, bfT, cfg)
    got = v2.fb_sweeps_v2_triton(e, None, cfg, params, interpret=True,
                                 lam_pad=lam_pad, init_fwd=(p0, f0),
                                 init_bwd=(bT, bfT))
    for name in ref._fields:
        np.testing.assert_allclose(np.asarray(getattr(got, name)),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-12, err_msg=name)


def test_engine_scan_v2_path_matches():
    """chromosome_scan on the v2 plan agrees with the standard path."""
    from cnf2freq_tpu.engine import chromosome_scan

    fbj, dists, cfg, params = _setup(B=4, M=7, seed=5)
    ref = chromosome_scan(fbj, dists, cfg, params, plan=STD)
    out = chromosome_scan(fbj, dists, cfg, params, plan=XLA_V2)
    for name in ("total", "haplo_b12", "inf_accum", "pair", "fw_pre",
                 "bw", "fw_pre_f", "bw_f"):
        np.testing.assert_allclose(np.asarray(getattr(out, name)),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-12, err_msg=name)
    np.testing.assert_array_equal(np.asarray(out.haplo_mask),
                                  np.asarray(ref.haplo_mask))
    tw, rtw = np.asarray(out.turn_weight), np.asarray(ref.turn_weight)
    finite = np.isfinite(rtw) & (rtw > -1e14)
    np.testing.assert_allclose(tw[finite], rtw[finite], rtol=1e-7,
                               atol=1e-9)


def test_engine_scan_triton_plan_interpret(monkeypatch):
    """The GPU plan's wiring, with the sweep kernel in interpret mode."""
    from cnf2freq_tpu.engine import chromosome_scan

    monkeypatch.setattr(v2, "fb_sweeps_v2_triton", functools.partial(
        v2.fb_sweeps_v2_triton, interpret=True))
    fbj, dists, cfg, params = _setup(B=4, M=7, seed=5)
    ref = chromosome_scan(fbj, dists, cfg, params, plan=STD)
    out = chromosome_scan(fbj, dists, cfg, params, plan=TRITON_V2)
    for name in ("total", "haplo_b12", "inf_accum", "pair", "bw"):
        np.testing.assert_allclose(np.asarray(getattr(out, name)),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-12, err_msg=name)
    finite = np.asarray(ref.turn_weight) > -1e14
    np.testing.assert_allclose(np.asarray(out.turn_weight)[finite],
                               np.asarray(ref.turn_weight)[finite],
                               rtol=1e-7, atol=1e-9)


def test_nonaligned_batch_padding():
    # B far from a lane-block multiple: padded rows must not perturb
    # real ones
    fbj, dists, cfg, params = _setup(B=3, M=5, seed=11)
    dtype = jnp.float64
    B, _, M, _ = fbj.md.shape
    st, _, fb2, total = _v2_pipeline(fbj, dists, cfg, params, dtype)
    b12, _, _ = v2.stats_from_v2(st, fb2, total, M, B, cfg, dtype)

    blocks = build_blocks(fbj, cfg, dtype=dtype)
    ref = forward_backward(assemble_e_all(blocks, cfg), dists, cfg, params)
    ref_total = combined_loglik(ref, fbj.shiftignore)
    W = pr.posterior_weight(ref, ref_total, fbj.shiftignore)
    hs = pr.haplo_stats(W, blocks, fbj, cfg)
    np.testing.assert_allclose(np.asarray(b12), np.asarray(hs.b12),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("B", [1, 31, 33])
def test_batch_padded_to_lane_block(B):
    """prep_slots pads the batch to whole kernel lane blocks, with inert
    (non-existent) padding units, and the kernel agrees with the XLA
    scan on the real units."""
    fbj, dists, cfg, params = _setup(B=B, M=4, seed=2)
    st = v2.prep_slots(fbj, jnp.float64)
    assert st.R == dispatch.pad_lanes(B)
    assert st.R % dispatch.LANE_BLOCK == 0 and B <= st.R < B + \
        dispatch.LANE_BLOCK
    assert not np.asarray(st.ex)[:, B:].any()
    e = v2.emissions_v2(st, cfg, jnp.float64)
    ref = v2.fb_scan_v2(e, dists, cfg, params)
    got = v2.fb_sweeps_v2_triton(e, dists, cfg, params, interpret=True)
    np.testing.assert_allclose(np.asarray(got.bw)[..., :B],
                               np.asarray(ref.bw)[..., :B], rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("backend,dtype,want", [
    ("cpu", np.float32, STD),
    ("cpu", np.float64, STD),
    ("METAL", np.float32, STD),
    ("gpu", np.float32, TRITON_V2),
    ("gpu", np.float64, STD),
])
def test_dispatch_plan(monkeypatch, backend, dtype, want):
    monkeypatch.setattr(dispatch, "backend", lambda: backend)
    assert dispatch.scan_plan(dtype) == want


@pytest.mark.parametrize("dtype,want", [(np.float32, [TRITON_V2]),
                                         (np.float64, [])])
def test_dispatch_routes_engine(monkeypatch, dtype, want):
    """engine.chromosome_scan follows the table: on a (patched) GPU
    backend float32 takes the feature-leading scan with the Triton
    sweeps, float64 the standard layout."""
    from cnf2freq_tpu import engine
    from cnf2freq_tpu.ops import scan_v2

    seen = []

    def spy(*args, **kwargs):
        seen.append(kwargs["plan"])
        return "v2"

    monkeypatch.setattr(dispatch, "backend", lambda: "gpu")
    monkeypatch.setattr(scan_v2, "chromosome_scan_v2", spy)
    fbj, dists, cfg, params = _setup(B=3, M=4, seed=1, dtype=dtype)
    out = engine.chromosome_scan(fbj, dists, cfg, params)
    assert seen == want
    if not want:
        assert out.total.dtype == dtype


def _dot_precisions(jaxpr):
    """(operand dtype, precision) of every dot_general in ``jaxpr`` and
    its sub-jaxprs (scan bodies, jitted calls, Pallas kernels)."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append((eqn.invars[0].aval.dtype, eqn.params["precision"]))
        for v in eqn.params.values():
            for j in (v if isinstance(v, (list, tuple)) else [v]):
                j = getattr(j, "jaxpr", j)          # ClosedJaxpr -> Jaxpr
                if hasattr(j, "eqns"):
                    out.extend(_dot_precisions(j))
    return out


def test_gpu_scan_contractions_full_f32(monkeypatch):
    """Every float32 matrix product of the GPU-path scan, the Triton
    kernels' included, asks for full float32 precision (never TF32)."""
    from cnf2freq_tpu.engine import chromosome_scan

    monkeypatch.setattr(dispatch, "backend", lambda: "gpu")
    fbj, dists, cfg, params = _setup(B=3, M=4, seed=1, dtype=np.float32)
    jaxpr = jax.make_jaxpr(
        lambda f, d: chromosome_scan(f, d, cfg, params))(fbj, dists)
    dots = [(dt, p) for dt, p in _dot_precisions(jaxpr.jaxpr)
            if dt == jnp.float32]
    # sweep kernels (2), transition operators, XLA forms
    assert len(dots) >= 4
    full = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert all(p == full for _, p in dots), dots


def test_gpu_scan_lowers_for_cuda(monkeypatch):
    """The GPU-path scan, the Pallas sweep kernels included, lowers for
    CUDA: every kernel primitive has a Triton lowering (the GPU compiler's own
    checks run only on the card)."""
    from cnf2freq_tpu.engine import chromosome_scan

    monkeypatch.setattr(dispatch, "backend", lambda: "gpu")
    fbj, dists, cfg, params = _setup(B=3, M=4, seed=1, dtype=np.float32)
    lowered = jax.jit(lambda f, d: chromosome_scan(f, d, cfg, params)).trace(
        fbj, dists).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert text.count("__gpu$xla.gpu.triton") == 2


def test_engine_scan_v2_coherence_matches():
    """with_coherence on the v2 plan (the mesh path's program) gives the
    standard path's adjacent-phase coherence."""
    from cnf2freq_tpu.engine import chromosome_scan

    fbj, dists, cfg, params = _setup(B=4, M=7, seed=5)
    ref = chromosome_scan(fbj, dists, cfg, params, plan=STD,
                          with_coherence=True)
    out = chromosome_scan(fbj, dists, cfg, params, plan=XLA_V2,
                          with_coherence=True)
    assert not np.allclose(np.asarray(ref.coherence), 0.5)
    for name in ("coherence", "total", "pair"):
        np.testing.assert_allclose(np.asarray(getattr(out, name)),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-12, err_msg=name)
