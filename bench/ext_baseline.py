#!/usr/bin/env python
"""Measure the SELFING / RELSKEWSTATES reference builds' doit throughput.

The reference's extended-state-space builds (refbaseline/build_ref.py
patch_settings; state spaces at settings.h:14-16,25-46) are slower than
its default build, so a like-for-like denominator for those families
needs their own rates.  This runs the already-compiled variant binaries
(.refbuild_selfing/, .refbuild_relskewstates/) on these cohorts:

  selfing        1000 selfed lines x 192 markers (generations=4)
  relskewstates  1000 F2 x 192 markers (the default-protocol cohort)

Protocol matches bench/ref_baseline.py: rate = units * markers * N /
(t(count=1+N) - t(count=1)), single OMP thread.  Writes
bench/ext_rates.json.

Usage: python bench/ext_baseline.py [variant ...]   (default: both)
"""

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

B = int(os.environ.get("BENCH_B", 1000))
M = int(os.environ.get("BENCH_M", 192))
N = int(os.environ.get("BENCH_DOITS", 1))


def run_ref(binary, mapf, pedf, genf, count, workdir):
    from cnf2freq_tpu.utils.refparity import REFBUILD
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["OMP_STACKSIZE"] = "128M"
    env["PATH"] = REFBUILD + os.pathsep + env.get("PATH", "")
    t0 = time.perf_counter()
    subprocess.run(
        [binary, "--mapfile", mapf, "--pedfile", pedf,
         "--genfile", genf, "--output", os.path.join(workdir, "out.txt"),
         "--count", str(count), "--tmppath", workdir],
        env=env, check=True, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    return time.perf_counter() - t0


def measure(variant: str) -> dict:
    from cnf2freq_tpu.utils import refparity as rp
    from cnf2freq_tpu.utils.simulate import (
        simulate_plantimpute_files, simulate_plantimpute_selfed_files)
    if not rp.have_variant(variant):
        rp.build_variant(variant)
    binary = rp.variant_binary(variant)

    work = tempfile.mkdtemp(prefix=f"refbench_{variant}_")
    if variant == "selfing":
        mapf, pedf, genf, _ = simulate_plantimpute_selfed_files(
            work, n_lines=B, n_markers=M, generations=4,
            spacing_cm=1.0, missing_rate=0.2, error_rate=0.01, seed=3)
        units = B
    else:
        mapf, pedf, genf, _ = simulate_plantimpute_files(
            work, n_f2=B, n_markers=M, spacing_cm=1.0,
            missing_rate=0.3, error_rate=0.02, seed=11)
        units = B

    t_setup = run_ref(binary, mapf, pedf, genf, 1, work)
    t_full = run_ref(binary, mapf, pedf, genf, 1 + N, work)
    per_doit = (t_full - t_setup) / N
    return {
        "ind_markers_per_s": round(units * M / per_doit, 1),
        "seconds_per_doit": round(per_doit, 2),
        "setup_seconds": round(t_setup, 2),
        "units": units, "n_markers": M, "doits": N, "omp_threads": 1,
        "binary": os.path.basename(binary),
    }


def main():
    variants = sys.argv[1:] or ["selfing", "relskewstates"]
    path = os.path.join(HERE, "ext_rates.json")
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    for v in variants:
        out[v] = measure(v)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps({v: out[v]}), flush=True)


if __name__ == "__main__":
    main()
