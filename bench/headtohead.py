#!/usr/bin/env python
"""Head-to-head held-out imputation accuracy: reference binary vs this
framework, same masked cohort, same iteration count.

The experiment the reference's own tooling implies
(--clear/--impoutput, cnF2freq.cpp:7551-7623): synthesize an F2 cohort
in the PlantImpute format, blank every k-th marker of every F2 in the
.gen file (the file both sides read — no in-memory masking asymmetry),
run N iterations of

  (a) the compiled reference binary (refbaseline oracle),
  (b) Driver(parity=True)  — the reference-faithful mode,
  (c) Driver()             — the redesigned default mode,

and score the final genotype state against the held-back truth at the
masked sites with the same caller (majority-confidence unordered match).

Writes JSON to stdout; docs/HEADTOHEAD.md records the reference run.

Usage:  python bench/headtohead.py [--nf2 200] [--markers 30]
        [--iters 10] [--every 7]
CPU-only (runs the reference binary and the f64 driver); set
JAX_PLATFORMS=cpu.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def masked_fixture(workdir, n_f2, n_markers, every, seed):
    """Write the cohort, then blank every `every`-th marker of each F2
    in the .gen file; returns (mapf, pedf, genf, held) with
    held[(name, m)] = (a, b) truth pairs."""
    from cnf2freq_tpu.utils.simulate import simulate_plantimpute_files
    mapf, pedf, genf, truths = simulate_plantimpute_files(
        workdir, n_f2=n_f2, n_markers=n_markers, seed=seed,
        missing_rate=0.05, error_rate=0.02)
    held = {}
    lines = open(genf).read().splitlines()
    out = []
    for line in lines:
        parts = line.split()
        name = parts[0]
        if not name.startswith("F2_"):
            out.append(line)
            continue
        codes = parts[1:]
        for m in range((hash(name) % every), n_markers, every):
            if codes[m] == "9":
                continue
            held[(name, m)] = tuple(int(x) for x in truths[name][m])
            codes[m] = "9"
        out.append(name + " " + " ".join(codes))
    with open(genf, "w") as f:
        f.write("\n".join(out) + "\n")
    return mapf, pedf, genf, held


def score(state_md, state_ms, held, sure_threshold=0.5):
    called = correct = 0
    for (name, m), (ta, tb) in held.items():
        md, ms = state_md[name], state_ms[name]
        a, b = int(md[m, 0]), int(md[m, 1])
        is_called = (a != 0 and b != 0 and
                     max(float(ms[m, 0]), float(ms[m, 1])) < sure_threshold)
        called += is_called
        correct += is_called and sorted((a, b)) == sorted((ta, tb))
    total = len(held)
    return dict(total=total, called=called, correct=correct,
                call_rate=round(called / total, 4) if total else 0.0,
                accuracy=round(correct / called, 4) if called else 0.0)


def run_reference(mapf, pedf, genf, iters, workdir, n_markers, held):
    from cnf2freq_tpu.utils import refparity as rp
    if not rp.have_reference():
        return None
    t0 = time.perf_counter()
    ref_iters = rp.run_reference(mapf, pedf, genf, iters, workdir,
                                 n_markers + 1)
    dt = time.perf_counter() - t0
    final = ref_iters[-1]
    md = {n: s.markerdata for n, s in final.items()}
    ms = {n: s.markersure for n, s in final.items()}
    out = score(md, ms, held)
    out["wall_s"] = round(dt, 1)
    out["blocks"] = len(ref_iters)
    return out


def run_driver(mapf, pedf, genf, iters, held, parity):
    from cnf2freq_tpu.driver import Driver
    from cnf2freq_tpu.io.alpha import load_plantimpute
    ped = load_plantimpute(mapf, pedf, genf)
    drv = Driver(ped, dtype=np.float64, parity=parity)
    t0 = time.perf_counter()
    drv.preprocess()
    if parity:
        # the reference main loop runs iters-1 doit calls (block 0 is
        # the initial dump, cnF2freq.cpp:8131-8132)
        for _ in range(iters - 1):
            drv.iterate(early=False)
    else:
        for i in range(iters):
            drv.iterate(early=(i == 0))
    dt = time.perf_counter() - t0
    md = {ind.name: ind.markerdata for ind in ped.inds[1:]}
    ms = {ind.name: ind.markersure for ind in ped.inds[1:]}
    out = score(md, ms, held)
    out["wall_s"] = round(dt, 1)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nf2", type=int, default=200)
    ap.add_argument("--markers", type=int, default=30)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--every", type=int, default=7)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--workdir", default="/tmp/headtohead")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_enable_x64", True)

    mapf, pedf, genf, held = masked_fixture(
        args.workdir, args.nf2, args.markers, args.every, args.seed)
    result = {"config": vars(args), "held_sites": len(held)}
    result["reference_binary"] = run_reference(
        mapf, pedf, genf, args.iters, args.workdir + "/ref",
        args.markers, held)
    result["driver_parity"] = run_driver(mapf, pedf, genf, args.iters,
                                         held, parity=True)
    result["driver_default"] = run_driver(mapf, pedf, genf, args.iters,
                                          held, parity=False)
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
