#!/usr/bin/env python
"""Flip-optimizer convergence experiment: native solver vs the
reference's WCNF pipeline vs the legacy negshift path on a phase-hard
cohort.

The round-1 verdict asked for a measured comparison ("flip-optimizer
quality vs toulbar2 is unmeasured"): this synthesizes a genotyped-F1
cohort (the family shape whose WCNF stage can act), converges it a few
iterations, seeds deliberately phase-inverted tails in several
individuals, then reruns from the same seed state under each flip
strategy and tracks the phase switch-error rate against the simulation
truth per iteration.

On this cohort every flip component is <= 20 variables, so the native
C++ solver enumerates exhaustively — its decisions ARE the per-marker
optimum of the clause model; the question measured here is whether the
full pipelines (scoring + candidate selection + application order)
converge as fast as the reference's.

Run on CPU (f64):
    JAX_PLATFORMS=cpu python bench/flip_parity.py
Writes docs/FLIP_PARITY.md and prints JSON lines.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ITER_SEED = 3      # iterations before seeding the inversions
ITER_RUN = 6       # iterations measured after seeding
INVERT = ("F2_0", "F2_3", "F2_7")
TAIL = 10


def switch_error(ped, truths):
    """Mean per-individual phase switch-error rate vs simulation truth.

    At markers where the unordered observed pair equals the unordered
    truth and the truth is heterozygous, the orientation bit is
    (md == truth ordering) XOR (haploweight > 0.5); a correctly phased
    segment keeps it constant, so state changes across consecutive
    informative markers are switch errors (global per-chromosome flips
    cancel)."""
    errs, tots = 0, 0
    for n in ped.dous:
        ind = ped.by_id(n)
        truth = truths.get(ind.name)
        if truth is None or ind.haploweight is None:
            continue
        bits = []
        for m in range(ped.num_markers - 1):   # skip the dummy column
            t = truth[m] if m < len(truth) else None
            if t is None or t[0] == t[1]:
                continue
            a, b = int(ind.markerdata[m, 0]), int(ind.markerdata[m, 1])
            if sorted((a, b)) != sorted((int(t[0]), int(t[1]))) or a == b:
                continue
            orient = 0 if (a, b) == (int(t[0]), int(t[1])) else 1
            bits.append(orient ^ int(ind.haploweight[m] > 0.5))
        for x, y in zip(bits, bits[1:]):
            errs += x != y
            tots += 1
    return errs / tots if tots else 0.0


def run_condition(name, make_driver, seed_file, mapf, pedf, genf, truths):
    from cnf2freq_tpu.io import load_plantimpute
    from cnf2freq_tpu.io.outputs import deserialize

    ped = load_plantimpute(mapf, pedf, genf)
    drv = make_driver(ped)
    drv.preprocess()
    with open(seed_file) as f:
        deserialize(ped, f)
    traj = [switch_error(ped, truths)]
    inverted = []
    for _ in range(ITER_RUN):
        info = drv.iterate(early=False)
        inverted.append(bool(info["inverted"]))
        traj.append(switch_error(ped, truths))
    rec = {"condition": name, "switch_error": [round(x, 4) for x in traj],
           "inversions": inverted,
           "iters_to_best": int(np.argmin(traj)),
           "final": round(traj[-1], 4)}
    print(json.dumps(rec))
    return rec


def main():
    import tempfile

    from cnf2freq_tpu.driver import Driver
    from cnf2freq_tpu.io import load_plantimpute
    from cnf2freq_tpu.io.outputs import write_haplotype_dump
    from cnf2freq_tpu.utils.simulate import simulate_plantimpute_files

    td = tempfile.mkdtemp(prefix="flip_parity_")
    mapf, pedf, genf, truths = simulate_plantimpute_files(
        td, n_f2=12, n_markers=24, seed=0, genotyped_f1=4)

    # converge a few iterations, then seed inverted tails
    ped = load_plantimpute(mapf, pedf, genf)
    drv = Driver(ped, parity=True)
    drv.preprocess()
    for _ in range(ITER_SEED):
        drv.iterate(early=False)
    for nm in INVERT:
        ind = ped.getind(nm, create=False)
        ind.haploweight[TAIL:] = 1.0 - ind.haploweight[TAIL:]
    for ind in ped.inds[1:]:
        if ind.haploweight is not None:
            np.clip(ind.haploweight, 1e-3, 1 - 1e-3, out=ind.haploweight)
    seed_file = os.path.join(td, "seed.txt")
    with open(seed_file, "w") as f:
        write_haplotype_dump(ped, f)
    base = {"seeded_switch_error": round(switch_error(ped, truths), 4)}
    print(json.dumps(base))

    def parity_driver(p):
        return Driver(p, parity=True)

    def native_driver(p):
        return Driver(p)

    def native_noadapt_driver(p):
        d = Driver(p)
        d.adaptive_relhaplo = False
        return d

    def negshift_driver(p):
        d = Driver(p)
        d.adaptive_relhaplo = False
        d.flip_mode = "negshift"
        return d

    recs = [run_condition("reference WCNF pipeline (parity)",
                          parity_driver, seed_file, mapf, pedf, genf,
                          truths),
            run_condition("native solver (default driver)",
                          native_driver, seed_file, mapf, pedf, genf,
                          truths),
            run_condition("native solver (inert relhaplo)",
                          native_noadapt_driver, seed_file, mapf, pedf,
                          genf, truths),
            run_condition("legacy negshift", negshift_driver, seed_file,
                          mapf, pedf, genf, truths)]

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "docs", "FLIP_PARITY.md"), "w") as f:
        f.write(
            "# Flip-optimizer convergence: native solver vs the "
            "reference pipeline\n\n"
            "Experiment: bench/flip_parity.py — a genotyped-F1 "
            "PlantImpute cohort (12 F2, 4 F1, 24+1 markers) is "
            f"converged {ITER_SEED} iterations with the reference-exact "
            f"pipeline, then {len(INVERT)} individuals get their phase "
            f"inverted from marker {TAIL} on, and each flip strategy "
            "reruns from that seed state.  Metric: phase switch-error "
            "rate vs simulation truth (consecutive informative markers; "
            "global flips cancel).  Components here are <= 20 variables,"
            " so the native solver's per-marker decisions are "
            "exhaustive-exact.\n\n"
            f"Seeded switch-error: {base['seeded_switch_error']}\n\n"
            "| condition | switch-error by iteration | final |\n"
            "|---|---|---|\n")
        for r in recs:
            f.write(f"| {r['condition']} | "
                    f"{' '.join(str(x) for x in r['switch_error'])} | "
                    f"{r['final']} |\n")
        nat = recs[1]["final"]
        refv = recs[0]["final"]
        f.write(
            f"\nNative-final {nat} vs reference-final {refv}: the "
            + ("native pipeline converges at least as well as the "
               "reference's WCNF pipeline on this cohort."
               if nat <= refv + 1e-9 else
               "reference pipeline ends lower on this cohort — "
               "investigate.") + "\n")
    ok = recs[1]["final"] <= recs[0]["final"] + 1e-9
    print(json.dumps({"experiment": "flip_parity", "native_final":
                      recs[1]["final"], "reference_final":
                      recs[0]["final"], "native_not_worse": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
