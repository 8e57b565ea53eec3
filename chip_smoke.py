#!/usr/bin/env python
"""Smoke test of cnf2freq_tpu on NVIDIA GPUs.

    python chip_smoke.py             # one GPU: phases 1-3
    python chip_smoke.py --cards 4   # the four-GPU mesh path only

One process drives the card(s).  The float64 references run in a child
process held to the CPU (JAX_PLATFORMS=cpu), which never opens a card.

1. Device: JAX must report a GPU.  Prints the card's name and power
   limit as nvidia-smi reports them.
2. Kernel parity, at full widths (S=64 states x NS=8 shift modes, 128
   turns, M=192 markers) on a PARITY_B-unit float32 batch: every stage of
   the GPU scan (emissions, the Triton sweep kernel, the statistics, the
   turn weights) and the whole chromosome_scan on the GPU plan against
   the float64 XLA forms computed on the CPU.  Each
   deviation is printed beside its tolerance (TOLERANCES).  Also prints
   compiled.memory_analysis() of the scan.
3. Main path: the command line (cnf2freq_tpu.cli.main) on a simulated
   PlantImpute cohort of 1,000 F2 units x 192 markers with --count 3,
   float32, on the device-resident path.  Checks that every output row is
   finite and sums to 1, and that the genotype calls agree with the
   simulation's truth.  Prints preprocess time, per-iteration wall time
   and peak device memory (informational, not a benchmark).

With --cards 4 the script runs only Driver(mesh=make_mesh(4)) against
Driver(mesh=None) on the same 1,000 x 192 cohort, one EM iteration each
(MESH_TOL).

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}},
printed only when every phase passed.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

PARITY_B = 256
MAIN_B, MAIN_M = 1000, 192

# Float32 on the GPU against the float64 reference: max |got - ref| over
# max |ref| for each tensor ("scaled error"), with every matrix product
# at full float32 precision (no TF32).  A float32 rounding is 6e-8; the
# bounds below leave room for its growth through each stage:
TOLERANCES = {
    # a product of ~20 rounded factors per entry
    "emissions": 1e-6,
    # probabilities renormalised at each of 2x192 dependent steps
    "fb_sweeps": 1e-4,
    # log factors: a running sum of 192 logs, so the error is absolute
    "fb_log_factors": 1e-4,
    # log ratios of 512-term correlations; small correlations lose digits
    "turn_weights": 1e-3,
    # posterior expectations, sums over ~2^14 weighted paths
    "stats": 1e-3,
    # per-unit total log-likelihood
    "total": 1e-5,
}
# Four cards against one after one EM iteration (scan, merges, flips,
# updates): the same float32 programs, with the accumulator merge summed
# in another order (psum over the data axis).  One iteration only: the
# genotype imputation takes an argmax that can meet exact ties on
# simulated data, and a tie broken the other way by a last-bit difference
# changes every later iteration.
MESH_TOL = 1e-4


def card_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()


def phase_device(cards: int):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devs[0].platform}")
    if len(devs) < cards:
        raise SystemExit(f"need {cards} GPUs, JAX found {len(devs)}")
    for line in card_lines()[:cards]:
        print(f"card: {line}", flush=True)
    return devs


def parity_batch():
    """Host FamilyBatch (float64) and interval lengths of a simulated F2
    cohort, with de-degenerated phase weights and error rates."""
    from cnf2freq_tpu.hmm.family import gather_family
    from cnf2freq_tpu.utils import simulate_f2

    ped = simulate_f2(n_f2=PARITY_B, n_markers=MAIN_M, n_founder_pairs=8,
                      missing_rate=0.1, error_rate=0.02, seed=11)
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_descendants()
    fb = gather_family(ped, ped.dous, 0, ped.num_markers - 1)
    rng = np.random.default_rng(11)
    fb.hw = rng.uniform(0.05, 0.95, fb.hw.shape)
    fb.ms = np.where(fb.md > 0, rng.uniform(0.0, 0.05, fb.ms.shape), fb.ms)
    return fb, np.diff(ped.markerposes)


def stage_outputs(fb, dists, cfg, params, fb_sweeps):
    """{name: array} of every stage of the feature-leading scan."""
    import jax
    import jax.numpy as jnp

    from cnf2freq_tpu.engine import chromosome_scan
    from cnf2freq_tpu.ops import scan_v2 as v2

    dt = fb.ms.dtype
    B, _, M, _ = fb.md.shape
    st = v2.prep_slots(fb, dt)
    e = v2.emissions_v2(st, cfg, dt)
    fb2 = jax.jit(lambda e, d: fb_sweeps(e, d, cfg, params))(e, dists)
    total = v2.combined_loglik_v2(fb2, st.sh)
    turn = jax.jit(lambda f, s, w: v2.turn_weights_v2(f, s, w, cfg, B))(
        fb2, st.sh, fb.descendants.astype(dt))
    b12, acc, pair = v2.stats_from_v2(st, fb2, total, M, B, cfg, dt)
    scan = jax.jit(lambda f, d: chromosome_scan(f, d, cfg, params))(
        fb, dists)
    out = dict(e=e[..., :B], fw_post=fb2.fw_post[..., :B],
               bw=fb2.bw[..., :B], fw_post_f=fb2.fw_post_f[..., :B],
               bw_f=fb2.bw_f[..., :B], total=total[:B], turn=turn,
               b12=b12, acc=acc, pair=pair, scan_total=scan.total,
               scan_b12=scan.haplo_b12, scan_acc=scan.inf_accum,
               scan_pair=scan.pair, scan_turn=scan.turn_weight)
    return {k: np.asarray(jnp.asarray(v)) for k, v in out.items()}


def reference_child(inp: str, outp: str):
    """Float64 XLA forms on the CPU (run as a child process)."""
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from cnf2freq_tpu.config import ModelConfig, RuntimeParams
    from cnf2freq_tpu.hmm.family import FamilyBatch
    from cnf2freq_tpu.ops import scan_v2 as v2

    assert jax.default_backend() == "cpu"
    z = np.load(inp)
    fb = FamilyBatch(**{k[3:]: z[k] for k in z.files if k.startswith("fb_")})
    ref = stage_outputs(fb.map(jnp.asarray), jnp.asarray(z["dists"]),
                        ModelConfig(), RuntimeParams(), v2.fb_scan_v2)
    np.savez(outp, **ref)


def scaled_error(got, ref, mask=None):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if mask is not None:
        got, ref = got[mask], ref[mask]
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                  1e-300))


def phase_parity():
    import dataclasses

    import jax
    import jax.numpy as jnp

    from cnf2freq_tpu.config import ModelConfig, RuntimeParams
    from cnf2freq_tpu.engine import chromosome_scan
    from cnf2freq_tpu.ops import dispatch
    from cnf2freq_tpu.ops import scan_v2 as v2

    fb, dists = parity_batch()
    cfg, params = ModelConfig(), RuntimeParams()
    plan = dispatch.scan_plan(np.float32)
    if plan != dispatch.ScanPlan("v2", "triton"):
        raise SystemExit(f"float32 on the GPU should take the Triton sweeps; "
                         f"the dispatch table gave {plan}")
    with tempfile.TemporaryDirectory() as tmp:
        inp, outp = os.path.join(tmp, "in.npz"), os.path.join(tmp, "ref.npz")
        np.savez(inp, dists=dists, **{f"fb_{f.name}": getattr(fb, f.name)
                                      for f in dataclasses.fields(fb)
                                      if getattr(fb, f.name) is not None})
        # no persistent cache for the CPU child: CPU code cached on
        # another host may use instructions this one lacks
        env = {k: v for k, v in os.environ.items()
               if k != "JAX_COMPILATION_CACHE_DIR"}
        env.update(JAX_PLATFORMS="cpu", CNF2FREQ_NO_COMPILE_CACHE="1")
        child = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                  "--reference", inp, outp], env=env)
        fb32 = dataclasses.replace(
            fb, ms=fb.ms.astype(np.float32), hw=fb.hw.astype(np.float32)
        ).map(jnp.asarray)
        d32 = jnp.asarray(dists.astype(np.float32))
        got = stage_outputs(fb32, d32, cfg, params, v2.fb_sweeps(plan))
        compiled = jax.jit(lambda f, d: chromosome_scan(
            f, d, cfg, params)).lower(fb32, d32).compile()
        print(f"scan memory_analysis (B={PARITY_B}, M={MAIN_M}): "
              f"{compiled.memory_analysis()}", flush=True)
        if child.wait() != 0:
            raise SystemExit("float64 reference process failed")
        ref = dict(np.load(outp))

    # MINFACTOR (-1e15) marks impossible entries of the log-domain
    # tensors: compare the possible ones, and require the same entries to
    # be impossible in both
    masks = {k: ref[k] > -1e14 for k in ("fw_post_f", "bw_f", "turn",
                                         "scan_turn")}
    checks = {
        "emissions": scaled_error(got["e"], ref["e"]),
        "fb_sweeps": max(scaled_error(got[k], ref[k])
                         for k in ("fw_post", "bw")),
        "fb_log_factors": max(scaled_error(got[k], ref[k], masks[k])
                              for k in ("fw_post_f", "bw_f")),
        "turn_weights": max(scaled_error(got[k], ref[k], masks[k])
                            for k in ("turn", "scan_turn")),
        "stats": max(scaled_error(got[k], ref[k]) for k in
                     ("b12", "acc", "pair", "scan_b12", "scan_acc",
                      "scan_pair")),
        "total": max(scaled_error(got[k], ref[k])
                     for k in ("total", "scan_total")),
    }
    mism = sum(int(np.sum(m != (got[k] > -1e14))) for k, m in masks.items())
    ok = mism == 0
    for name, dev in checks.items():
        good = dev <= TOLERANCES[name]
        ok &= good
        print(f"parity {name}: scaled error {dev:.3e} "
              f"(tolerance {TOLERANCES[name]:.0e}) "
              f"{'ok' if good else 'FAIL'}", flush=True)
    print(f"parity impossible-entry mismatches: {mism}", flush=True)
    if not ok:
        raise SystemExit("kernel parity failed")


def phase_main():
    import jax

    from cnf2freq_tpu import cli
    from cnf2freq_tpu.driver import Driver
    from cnf2freq_tpu.utils.simulate import simulate_plantimpute_files

    timings = {"preprocess": [], "iterate": []}
    resident = []

    def timed(name, fn):
        def run(self, *args, **kwargs):
            resident.append(self._use_resident())
            t0 = time.perf_counter()
            out = fn(self, *args, **kwargs)
            jax.block_until_ready(jax.live_arrays())
            timings[name].append(time.perf_counter() - t0)
            return out
        return run

    Driver.preprocess = timed("preprocess", Driver.preprocess)
    Driver.iterate = timed("iterate", Driver.iterate)
    with tempfile.TemporaryDirectory() as tmp:
        mapf, pedf, genf, truths = simulate_plantimpute_files(
            tmp, n_f2=MAIN_B, n_markers=MAIN_M, seed=5)
        outf = os.path.join(tmp, "genotypes.txt")
        t0 = time.perf_counter()
        rc = cli.main(["--mapfile", mapf, "--pedfile", pedf, "--genfile",
                       genf, "--count", "3", "--output", outf,
                       "--dump", os.path.join(tmp, "haplotypes.txt")])
        wall = time.perf_counter() - t0
        if rc != 0:
            raise SystemExit(f"cli exited {rc}")
        blocks, cur = {}, None
        with open(outf) as f:
            for line in f:
                if not line.strip():
                    continue
                if "\t" not in line:
                    cur = line.strip().split(":")[0]
                    blocks[cur] = []
                else:
                    blocks[cur].append([float(v) for v in line.split()])
    stats = jax.devices()[0].memory_stats() or {}
    print(f"main path: cli wall {wall:.1f} s; preprocess "
          f"{timings['preprocess'][0]:.2f} s; iterations "
          + ", ".join(f"{t:.3f} s" for t in timings["iterate"])
          + f"; peak_bytes_in_use {stats.get('peak_bytes_in_use')}",
          flush=True)
    if not all(resident):
        raise SystemExit("the main path left the device-resident path")
    if len(blocks) != MAIN_B:
        raise SystemExit(f"{len(blocks)} genotype blocks, want {MAIN_B}")
    rows = np.array([r for b in blocks.values() for r in b])
    if not np.isfinite(rows).all():
        raise SystemExit("non-finite genotype posteriors")
    if np.abs(rows.sum(axis=1) - 1).max() > 5e-5:
        raise SystemExit("genotype posteriors do not sum to 1")
    calls = np.concatenate([np.argmax(np.array(b)[:MAIN_M, :3], axis=1)
                            for b in blocks.values()])
    truth = np.concatenate([(truths[n] == 2).sum(axis=1) for n in blocks])
    agree = float(np.mean(calls == truth))
    print(f"main path: genotype calls agree with the simulated truth at "
          f"{agree:.4f} of {calls.size} (unit, marker) pairs", flush=True)
    # calls from a broken scan agree at chance (about 0.4); a working
    # one misses only where the data cannot tell (missing and
    # mistyped markers)
    if agree < 0.9:
        raise SystemExit("genotype calls disagree with the truth")


def phase_mesh(cards: int):
    import jax

    from cnf2freq_tpu.driver import Driver
    from cnf2freq_tpu.parallel import make_mesh
    from cnf2freq_tpu.utils import simulate_f2

    def run(mesh):
        ped = simulate_f2(n_f2=MAIN_B, n_markers=MAIN_M,
                          n_founder_pairs=MAIN_B // 50, seed=7)
        drv = Driver(ped, dtype=np.float32, mesh=mesh)
        if not drv._use_resident():
            raise SystemExit("the mesh cohort left the resident path")
        t0 = time.perf_counter()
        drv.preprocess()
        info = drv.iterate(early=True)
        jax.block_until_ready(jax.live_arrays())
        out = {"haploweight": [ped.by_id(n).haploweight for n in ped.dous],
               "markersure": [ped.by_id(n).markersure for n in ped.dous],
               "pair tables": [drv.pair_tables[n] for n in ped.dous]}
        print(f"mesh={'none' if mesh is None else dict(mesh.shape)}: "
              f"{time.perf_counter() - t0:.1f} s, hitnnn {info['hitnnn']}",
              flush=True)
        return info["hitnnn"], {k: np.stack(v) for k, v in out.items()}

    hits4, out4 = run(make_mesh(cards))
    hits1, out1 = run(None)
    devs = {k: float(np.abs(out4[k] - out1[k]).max()) for k in out1}
    print("mesh vs single: " + ", ".join(f"{k} {d:.3e}"
                                         for k, d in devs.items())
          + f" (tolerance {MESH_TOL:.0e})", flush=True)
    if hits4 != hits1:
        raise SystemExit("mesh and single-device flip counts differ")
    if max(devs.values()) > MESH_TOL:
        raise SystemExit("mesh and single-device results differ")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    ap.add_argument("--reference", nargs=2, metavar=("IN", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.reference:
        reference_child(*args.reference)
        return
    devs = phase_device(args.cards)
    if args.cards == 1:
        phase_parity()
        phase_main()
    else:
        phase_mesh(args.cards)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
