#!/usr/bin/env python
"""Benchmark of the F2 EM loop on one GPU.

Prints one JSON line per result as it goes.  Every line names the device
as JAX reports it (platform, device_kind, count) and the card's name and
power limit as nvidia-smi reports them:

  1. ``stages``: each stage of the feature-leading scan — the sweeps'
     Pallas kernel (Triton route) beside their XLA form — and the whole
     chromosome scan under the GPU plan, the all-XLA feature-leading plan
     and the standard layout (ops/dispatch.py);
  2. ``scan``: one F2 chromosome scan under the default plan;
  3. ``full_iteration``: one complete Driver.iterate (scan, coherence,
     flips, capped-GD updates), re-printed after every timed iteration.

Times are host wall clock around work that ends in block_until_ready,
median over BENCH_REPS calls after a warm-up call; the warm-up's time
(compile included) is reported as set-up.  The reference binary's
measured single-core rate (bench/ref_rate.json) is the denominator of
``vs_reference``.  Workload: BENCH_B F2 units (default 1000) x BENCH_M
markers (default 192), float32.  Refuses to run without a GPU.

    python bench.py [--stages-only]
"""

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

B = int(os.environ.get("BENCH_B", 1000))
M = int(os.environ.get("BENCH_M", 192))
REPS = int(os.environ.get("BENCH_REPS", 5))
FULL_ITERS = int(os.environ.get("BENCH_FULL_ITERS", 5))


def card() -> str:
    """'name, power limit' of the first GPU as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_info() -> dict:
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found "
                         f"{devs[0].platform}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card()}


def reference_rate():
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "bench", "ref_rate.json")) as f:
        return float(json.load(f)["ind_markers_per_s"])


def timed(fn, *args, reps=REPS):
    """(median seconds per call, seconds of the first call)."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times), first


def f2_batch(dtype):
    """(FamilyBatch on device, dists) of a simulated F2 cohort."""
    import jax.numpy as jnp
    import numpy as np

    from cnf2freq_tpu.hmm.family import gather_family
    from cnf2freq_tpu.utils import simulate_f2

    ped = simulate_f2(n_f2=B, n_markers=M, n_founder_pairs=max(1, B // 50),
                      seed=7)
    for ind in ped.inds[1:]:
        ped.fixtrees(ind.n)
    ped.count_descendants()
    fb = gather_family(ped, ped.dous, 0, ped.num_markers - 1, dtype=dtype)
    dists = np.diff(ped.markerposes).astype(dtype)
    return fb.map(jnp.asarray), jnp.asarray(dists)


def stage_times(fbj, dists):
    """{stage: {form: (median s, first-call s)}} at the batch's shape."""
    import jax
    import jax.numpy as jnp

    from cnf2freq_tpu.config import ModelConfig, RuntimeParams
    from cnf2freq_tpu.engine import chromosome_scan
    from cnf2freq_tpu.ops import dispatch
    from cnf2freq_tpu.ops import scan_v2 as v2

    cfg, params = ModelConfig(), RuntimeParams()
    dt = jnp.float32
    Bn, _, Mn, _ = fbj.md.shape
    st = jax.jit(lambda f: v2.prep_slots(f, dt))(fbj)
    e = v2.emissions_v2(st, cfg, dt)
    fb2 = jax.jit(lambda e, d: v2.fb_scan_v2(e, d, cfg, params))(e, dists)
    total = v2.combined_loglik_v2(fb2, st.sh)
    desc = fbj.descendants.astype(dt)
    out = {
        "emissions": {"xla": timed(v2.emissions_v2, st, cfg, dt)},
        "fb_sweeps": {
            "triton": timed(jax.jit(lambda e, d: v2.fb_sweeps_v2_triton(
                e, d, cfg, params)), e, dists),
            "xla": timed(jax.jit(lambda e, d: v2.fb_scan_v2(
                e, d, cfg, params)), e, dists)},
        "turn_weights": {"xla": timed(jax.jit(
            lambda f, s, w: v2.turn_weights_v2(f, s, w, cfg, Bn)),
            fb2, st.sh, desc)},
        "stats": {"xla": timed(
            lambda s, f, t: v2.stats_from_v2(s, f, t, Mn, Bn, cfg, dt),
            st, fb2, total)},
    }
    plans = {"gpu": dispatch.scan_plan(dt),
             "xla_v2": dispatch.ScanPlan("v2", "xla"),
             "std": dispatch.ScanPlan("std", "xla")}
    out["chromosome_scan"] = {
        name: timed(jax.jit(lambda f, d, p=p: chromosome_scan(
            f, d, cfg, params, plan=p)), fbj, dists)
        for name, p in plans.items()}
    return out


def emit(result: dict):
    print(json.dumps(result), flush=True)


def main():
    import numpy as np

    dev = device_info()
    base = reference_rate()
    common = {"device": dev, "B": B, "M": M, "dtype": "float32"}

    fbj, dists = f2_batch(np.float32)
    stages = stage_times(fbj, dists)
    emit(dict(common, metric="stages", unit="s", value={
        st: {form: {"median_s": t, "first_call_s": c}
             for form, (t, c) in forms.items()}
        for st, forms in stages.items()}))
    scan_s = stages["chromosome_scan"]["gpu"][0]
    emit(dict(common, metric="scan", unit="individual-markers/s",
              value=B * M / scan_s, seconds=scan_s,
              vs_reference=B * M / scan_s / base))
    if "--stages-only" in sys.argv:
        return

    import jax

    from cnf2freq_tpu.driver import Driver
    from cnf2freq_tpu.utils import simulate_f2

    ped = simulate_f2(n_f2=B, n_markers=M,
                      n_founder_pairs=max(1, B // 50), seed=7)
    drv = Driver(ped, dtype=np.float32)
    if not drv._use_resident():
        raise SystemExit("the benchmark cohort left the resident path")
    t0 = time.perf_counter()
    drv.preprocess()
    drv.iterate(early=True)
    drv.iterate(early=False)      # compiles the non-early stages
    jax.block_until_ready(jax.live_arrays())
    setup_s = time.perf_counter() - t0
    times = []
    for _ in range(FULL_ITERS):
        t0 = time.perf_counter()
        drv.iterate(early=False)
        jax.block_until_ready(jax.live_arrays())
        times.append(time.perf_counter() - t0)
        dt = statistics.median(times)
        emit(dict(common, metric="full_iteration",
                  unit="individual-markers/s", value=B * M / dt,
                  seconds=dt, iterations_timed=len(times),
                  setup_seconds=setup_s, vs_reference=B * M / dt / base))


if __name__ == "__main__":
    main()
