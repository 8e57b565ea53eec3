"""Iteration driver: the outer EM-like loop.

Orchestrates one full iteration of the reference's ``doit``
(cnF2freq.cpp:5189-6410) and the ``postmarkerdata`` preprocessing
(cnF2freq.cpp:3191-3412) on top of the tensorized engine: batched
forward-backward over all focal individuals, contraction-based update
statistics, native phase-flip optimisation, vectorized capped-gradient
parameter updates.

Device work happens per chromosome on [B, M, ...] tensors; the residual
host work is bookkeeping over small per-individual structures.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from .config import ModelConfig, RuntimeParams, SEXMARKER, UNKNOWN
from .hmm.emission import build_blocks
from .hmm.family import gather_family
from .ops import dispatch
from .ops.dispatch import full_f32
from .pedigree import Pedigree
from .updates import relskew_ratio
from .updates.phaseflip import (FlipCandidate, apply_flips,
                                extract_candidates, family_variables,
                                select_winner)

_MOVEHAPLO_TINY = math.exp(-400) * 5e-6 * 5e-6 * 0.5  # cnF2freq.cpp:3605


def _host_value(x) -> np.ndarray:
    """Device array -> host numpy, valid under multi-controller runs:
    per-analysis-unit outputs are sharded over processes and must be
    all-gathered before the host stages can read them (the replicated
    merged accumulators go through plain np.asarray)."""
    import jax
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(x,
                                                            tiled=True))
    return np.asarray(x)


@dataclasses.dataclass
class DriverState:
    """Mutable cross-iteration knobs (the reference's globals)."""

    scalefactor: float = 0.013
    oldhitnnn: int = 0
    oldhitnnn2: int = 0
    iter: int = 0


class Driver:
    def __init__(self, ped: Pedigree, params: Optional[RuntimeParams] = None,
                 dtype=np.float64, parity: bool = False, mesh=None):
        self.ped = ped
        self.cfg: ModelConfig = ped.config
        # Multi-chip execution: a jax.sharding.Mesh with a "data" axis.
        # Every chromosome scan runs under shard_map with the analysis
        # units sharded over "data" and the accumulator merge completed
        # by a psum over the mesh (parallel/collective.py) — the
        # replacement for the reference's MPI
        # broadcast/reduce loop (cnF2freq.cpp:5197-5242, 6245-6255).
        # Host-side stages (flips, capped-GD updates) consume the
        # replicated merged accumulators unchanged.
        self.mesh = mesh
        # Extended state spaces (SELFING / RELSKEWSTATES) run the full
        # iteration loop through engine_ext.chromosome_scan_ext; the
        # standard-space-only extras (parity trajectory emulation,
        # coherence measurement, map re-estimation, blocked scans,
        # line-origin reporting) stay gated.
        self.ext = self.cfg.selfing or self.cfg.relskewstates
        if parity and (self.ext or self.cfg.numgen != 3):
            raise NotImplementedError(
                "parity mode emulates the reference's default build "
                "(numgen==3, standard state space)")
        self.params = params or RuntimeParams()
        self.state = DriverState(scalefactor=self.params.scalefactor)
        self.dtype = dtype
        self._pair_tables: Dict[int, np.ndarray] = {}
        # pair tables produced by the resident fast path stay on device
        # until someone reads them (they are reporters, not iteration
        # state); entries: (ids, lo, Mc, device pair tensor)
        self._pair_pending: list = []
        self._scan_cache = {}
        # Device-resident iteration (resident.py): accumulate, flip and
        # update on device; only final state crosses the host link.
        # None = auto (on for the native-flip, unmeshed, unblocked,
        # non-parity path — the production default); True/False force.
        self.resident = None
        # Strict reference-parity mode: reproduce the compiled reference
        # binary's trajectory (refbaseline/) — reference fixtrees path
        # masks, inert relhaplo, and run() skipping iteration 0 the way
        # the reference main loop does (cnF2freq.cpp:8131-8132).
        self.parity = parity
        # Canonical-path masks for probes/variances: "reference" = the
        # fixtrees mask, which also pins *empty* members
        # (cnF2freq.cpp:3099-3187) — required for trajectory parity but
        # it collapses path resolution through genotype-less parents;
        # "missing" pins only vacant slots (the correct restriction,
        # round-1 default — see tests/test_driver.py hidden-marker
        # recovery).
        self.mask_mode = "reference" if parity else "missing"
        # Feed the relskew machinery with measured adjacent-phase
        # coherence each iteration (the statistic relhaplo is designed to
        # carry; the reference's PlantImpute path leaves it inert at 0.5).
        # Dramatically speeds phase convergence; disabled in parity
        # mode.  Under RELSKEWSTATES the coherence bit is part of the
        # hidden state and its posterior xor-marginal is the exact EM
        # statistic for relhaplo (engine_ext.relskew_coherence_ext);
        # SELFING runs per-slot coherence over the extended space.
        self.adaptive_relhaplo = not parity
        # Genetic-map re-estimation (the reference's default-off
        # DOREMAPDISTANCES, redesigned as a direct posterior EM update of
        # per-sex per-interval rates).
        self.remap_distances = False
        # Stream analysis units through the device in chunks of this size
        # ("auto" = size chunks to the device's memory, _memory_budget;
        # None = whole cohort in one scan); bounds device memory for
        # large cohorts.
        self.batch_size = "auto"
        # Pad each chromosome's marker axis up to a multiple of this, so
        # chromosomes of similar length share one compiled scan (inert
        # trailing markers — the reference's dummy-marker trick,
        # demo.sh:22-23 — cost nothing but avoid a multi-minute compile
        # per distinct length).  None disables.
        self.marker_bucket = 64
        # Marker-blocked (checkpointed) scan: chromosomes longer than
        # this run in O(marker_block) device memory via boundary-carry
        # recompute (ops/scan_v2.blocked_scan_chunk).  None disables.
        self.marker_block = None
        # Flip-solver budget: at most this many top-gain markers get a
        # joint solve per chromosome per iteration.
        self.max_flip_markers = 16
        # "native" = joint per-marker flip optimizer (the DOTOULBAR=1
        # replacement); "negshift" = legacy single-member inversion path
        # (DOTOULBAR=0, updates/negshift.py)
        self.flip_mode = "native"
        # Parent-pair swap moves after the legacy negshift pass
        # (parentswapnegshifts, cnF2freq.cpp:5004-5084 — dead at
        # reference HEAD; see updates/negshift.py).  negshift mode only.
        self.parent_swap = False
        # structured tracing/metrics (utils/tracing.py); NullTracer is a
        # no-op — swap in a Tracer(sink=...) for JSONL telemetry
        from .utils.tracing import NullTracer
        self.tracer = NullTracer()

    def export_state(self) -> dict:
        """Cross-iteration driver knobs for checkpoint manifests (the
        reference keeps these in globals that a --deserialize resume
        silently resets; carrying them makes a resumed run continue the
        exact trajectory)."""
        return dict(scalefactor=self.state.scalefactor,
                    oldhitnnn=self.state.oldhitnnn,
                    oldhitnnn2=self.state.oldhitnnn2,
                    iter=self.state.iter)

    def import_state(self, d: dict) -> None:
        self.state.scalefactor = float(d.get("scalefactor",
                                             self.state.scalefactor))
        self.state.oldhitnnn = int(d.get("oldhitnnn",
                                         self.state.oldhitnnn))
        self.state.oldhitnnn2 = int(d.get("oldhitnnn2",
                                          self.state.oldhitnnn2))
        self.state.iter = int(d.get("iter", self.state.iter))

    @property
    def pair_tables(self) -> Dict[int, np.ndarray]:
        """Ordered-genotype posterior tables {focal id: [M, 2, 2]}.

        Reading materialises any device-pending tables from the
        resident fast path (one readback per pending chunk)."""
        self._flush_pair_tables()
        return self._pair_tables

    def _flush_pair_tables(self):
        for ids, lo, Mc, pair_dev in self._pair_pending:
            pair = _host_value(pair_dev)
            for b, n in enumerate(ids):
                tab = self._pair_tables.setdefault(
                    n, np.zeros((self.ped.num_markers, 2, 2)))
                tab[lo:lo + Mc] = pair[b, :Mc]
        self._pair_pending.clear()

    def _use_resident(self) -> bool:
        if self.resident is not None:
            return bool(self.resident)
        return (self.marker_block is None and
                not self.parity and self.flip_mode == "native")

    def _fast_layout(self, NI: int):
        """(NI_eff, row_sharding) for the resident device state: under a
        mesh the per-individual axis is padded to the data-axis size and
        row-sharded, so the accumulate/flip/update stages scale over the
        mesh instead of replicating host work (the round-4 verdict's
        mesh-scaling flaw)."""
        if self.mesh is None:
            return NI, None
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P
        nd = self.mesh.shape["data"]
        return -(-NI // nd) * nd, NamedSharding(self.mesh, P("data"))

    @staticmethod
    def _pad_rows(arr: np.ndarray, n: int, fill=0):
        if arr.shape[0] == n:
            return arr
        pad = np.full((n - arr.shape[0],) + arr.shape[1:], fill,
                      dtype=arr.dtype)
        return np.concatenate([arr, pad], axis=0)

    def _jitted_scan(self):
        key = self.dtype
        if key not in self._scan_cache:
            from .engine import make_jitted_coherence, make_jitted_scan
            self._scan_cache[key] = (
                make_jitted_scan(self.cfg, self.params),
                make_jitted_coherence(self.cfg, self.params))
        return self._scan_cache[key]

    def _n_variants(self) -> int:
        """Probe-dedup sign variants: 2**(pair constraints) of the
        deepest duplicate-member family in the cohort (a member in k
        slots needs k-1 constraints; ignoreflag2 rule 2,
        cnF2freq.cpp:3478).  Applied in parity mode (all dedup rules)
        and on the extended state spaces (rule 2 stays active there —
        and selfed units hold their parent in both parent slots);
        plain non-parity standard runs use 1."""
        if not (self.parity or self.ext):
            return 1
        key = ("n_variants",)
        if key not in self._scan_cache:
            n = 1
            for d in self.ped.dous:
                slots = self.ped.family_slots(d)
                groups = {}
                for s, sid in enumerate(slots):
                    if sid and not self.ped.by_id(sid).empty:
                        groups.setdefault(sid, []).append(s)
                cons = sum(len(g) - 1 for g in groups.values()
                           if len(g) > 1)
                n = max(n, 1 << cons)
            self._scan_cache[key] = n
        return self._scan_cache[key]

    def _jitted_scan_merged(self, num_individuals: int):
        # extended spaces deliver coherence from inside the scan
        wc = self.ext and self.adaptive_relhaplo
        key = ("scan_merged", self.dtype, num_individuals, wc)
        if key not in self._scan_cache:
            from .engine import (make_jitted_coherence,
                                 make_jitted_scan_merged)
            self._scan_cache[key] = (
                make_jitted_scan_merged(self.cfg, self.params,
                                        num_individuals,
                                        n_variants=self._n_variants(),
                                        probe_rules=self.parity,
                                        with_coherence=wc),
                make_jitted_coherence(self.cfg, self.params)
                if not self.ext else None)
        return self._scan_cache[key]

    def _jitted_scan_sharded(self, num_individuals: int):
        """The mesh form of _jitted_scan_merged: one shard_map program
        returning (total, pair, turn_weight, hb, hc, inf, coherence,
        recomb_sum, recomb_count)."""
        key = ("scan_sharded", self.dtype, num_individuals,
               self.remap_distances)
        if key not in self._scan_cache:
            from .parallel.collective import make_sharded_scan_merged
            self._scan_cache[key] = make_sharded_scan_merged(
                self.cfg, self.params, self.mesh, num_individuals,
                probe_rules=self.parity,
                n_variants=self._n_variants(),
                with_coherence=self.adaptive_relhaplo and
                (self.cfg.relskews or self.cfg.relskewstates),
                with_recomb=self.remap_distances)
        return self._scan_cache[key]

    @staticmethod
    def _memory_budget() -> int:
        """Bytes the auto chunk size may give the scan's working set: half
        of what the device lets one process allocate (the other half
        covers the update programs and XLA's temporaries), or 8 GiB where
        the backend reports no limit (the CPU)."""
        limit = dispatch.device_memory_bytes()
        return limit // 2 if limit else 8 * 1024 ** 3

    def _chunk_size(self, n_units: int, m_markers: int) -> int:
        """Resolve batch_size: explicit int, None (whole cohort), or
        "auto" — the largest multiple of the lane block
        (ops/dispatch.LANE_BLOCK) of units whose scan working set
        (~10 x [B, M, 512] tensors at the driver dtype: the GPU scan's
        compiled memory_analysis, 1.0 GB at B=256, M=192, float32) fits
        _memory_budget().  The feature-leading layout pads the batch to
        whole lane blocks, so a chunk between two multiples costs the
        memory of the larger one.  For chromosomes long enough that even
        one lane block exceeds the budget, set marker_block — the
        blocked scan bounds memory by block length instead."""
        if self.batch_size is None:
            return n_units
        if self.batch_size != "auto":
            return int(self.batch_size)
        itemsize = np.dtype(self.dtype).itemsize
        vmult = 1
        if self.ext:
            # extended spaces carry the V axis on every sweep tensor,
            # evaluate the probe-dedup variants' stats in one program,
            # and their stats temporaries are several times the sweep
            # tensors.  The max(6, ...) floor covers low-variant configs
            # whose live-tensor count still exceeds the 10-tensor model.
            V = 3 if self.cfg.selfing else 2
            vmult = V * max(6, self._n_variants() // 2)
        per_unit = 10 * m_markers * 512 * itemsize * vmult
        bs = int(self._memory_budget() // per_unit)
        if bs >= n_units:
            return n_units
        q = dispatch.LANE_BLOCK
        return max(q, (bs // q) * q)

    def _jitted_updates(self):
        key = ("param_updates",)
        if key not in self._scan_cache:
            from .updates.parameter_updates import make_jitted_updates
            self._scan_cache[key] = make_jitted_updates(self.params)
        return self._scan_cache[key]

    def _update_rows(self, M: int, lanes: int) -> int:
        """Row-chunk size for the capped-GD update programs: their
        51-step bisection with 15-point quadrature keeps ~15 unrolled
        gradient evaluations of [rows, M, lanes] live concurrently (each
        with a few temporaries), so an unchunked cohort x whole-genome
        call can exceed device memory.  Bound the live set, at 64
        dtype-sized words per (row, marker, lane), to a quarter of the
        memory budget."""
        per_row = max(M * lanes, 1) * 64 * np.dtype(self.dtype).itemsize
        return max(256, min(1 << 20, self._memory_budget() // 4 // per_row))

    def _jitted_relskew(self):
        key = ("relskew_ratio",)
        if key not in self._scan_cache:
            import jax
            self._scan_cache[key] = jax.jit(relskew_ratio)
        return self._scan_cache[key]

    # ------------------------------------------------------------------
    # Preprocessing (postmarkerdata)
    # ------------------------------------------------------------------
    @full_f32
    def preprocess(self):
        ped = self.ped
        with self.tracer.span("preprocess"):
            with self.tracer.span("correction_inference"):
                self._correction_inference_loop()
            if not self.parity:
                ped.count_descendants()
            for ind in ped.inds[1:]:
                ped.fixtrees(ind.n)       # sets founder flags
            if self.cfg.haplotyping:
                # variances feed the phase-anchor choice (lockhaplos);
                # the no-haplotyping family has no phases to anchor
                with self.tracer.span("variances"):
                    self._compute_variances()
            with self.tracer.span("lockhaplos"):
                for ind in ped.inds[1:]:
                    if self.cfg.haplotyping and ind.haploweight is not None:
                        for c in range(ped.num_chromosomes):
                            self._lockhaplos(ind, c)

    def _correction_inference_loop(self):
        ped = self.ped
        if self.parity:
            # the reference accumulates descendants across rounds (see
            # Pedigree.count_descendants reset=False); start from zero
            for ind in ped.inds[1:]:
                ind.descendants = 0
        while True:
            ped.count_children(dous_only=False)
            for ind in ped.inds[1:]:
                self._fixkid(ind)
            ped.count_descendants(reset=not self.parity)
            any_corr = self._fixparents_round()
            if not any_corr:
                break

    def _fixkid(self, ind):
        """Fill a fully-missing genotype from homozygous parents
        (cnF2freq.cpp:1469-1487)."""
        ped = self.ped
        md, ms = ind.markerdata, ind.markersure
        both_unknown = (md[:, 0] == UNKNOWN) & (md[:, 1] == UNKNOWN)
        for p in range(2):
            par = ped.by_id(ind.pars[p]) if ind.pars[p] else None
            if par is None or par.markerdata is None:
                continue
            pm = par.markerdata
            hom = (pm[:, 0] != UNKNOWN) & (pm[:, 0] == pm[:, 1])
            take = both_unknown & hom
            md[take, p] = pm[take, 0]
            ms[take, p] = 0.5

    def _feasibility_fn(self):
        import jax
        import jax.numpy as jnp

        @jax.jit
        def run(fb):
            cfg = self.cfg
            if cfg.deep_walk:
                # fixparents okvals with flag2 in {0,1} pinning the focal
                # interpretation (cnF2freq.cpp:1409-1428)
                from .engine_nohaplo import nohaplo_feasibility
                return nohaplo_feasibility(fb, cfg, ci=True,
                                           dtype=fb.ms.dtype)
            if cfg.numgen == 2:
                # the block builders evaluate the embedded 7-slot view
                from .engine_ng2 import embed7, ng3_equiv
                fb = embed7(fb)
                cfg = ng3_equiv(cfg)
            blocks = build_blocks(fb, cfg, ci=True,
                                  dtype=fb.ms.dtype)
            pb0 = blocks.pb[0].sum(axis=-2)   # [B, M, r, fp, sk]
            pb1 = blocks.pb[1].sum(axis=-2)
            e = (blocks.froot[:, :, :, None, None, 0]
                 * pb0[:, :, :, :, None, 0]
                 * pb1[:, :, :, None, :, 0])
            ok = (e > 0).any(axis=(3, 4))
            ok_top = blocks.top[:, :, :, 0] > 0
            attop = blocks.focal_attop[:, None, None]
            return jnp.where(attop, ok_top, ok)

        return run

    def _feasibility(self, chunk: int = 1024):
        """okvals[ind, m, r]: is any inheritance path with the focal's
        allele slot r as primary interpretation feasible (fixparents check,
        cnF2freq.cpp:1412-1428).  Evaluated at shift 0, all paths; jitted
        and chunked over individuals."""
        import jax.numpy as jnp
        ped = self.ped
        ids = [ind.n for ind in ped.inds[1:]]
        if "feas" not in self._scan_cache:
            self._scan_cache["feas"] = self._feasibility_fn()
        run = self._scan_cache["feas"]
        parts = []
        from .parallel.mesh import pad_batch
        for b0 in range(0, len(ids), chunk):
            sub = ids[b0:b0 + chunk]
            fb = gather_family(ped, sub, 0, ped.num_markers - 1,
                               dtype=self.dtype, mask_mode=self.mask_mode)
            if len(sub) < chunk and len(ids) > chunk:
                fb = pad_batch(fb, chunk)
            parts.append(np.asarray(run(fb.map(jnp.asarray)))[:len(sub)])
        return ids, np.concatenate(parts, axis=0)

    def _fixparents_round(self) -> int:
        """One correction round: propagate child genotypes to parents and
        resolve (cnF2freq.cpp:1392-1467, 3282-3357).

        Vectorized over the cohort: proposal aggregation is a
        ufunc.at scatter per (parent row, marker, allele) and the
        resolution a per-(row, marker) case select over the small allele
        alphabet.  Loop-form parity pinned by tests/test_preprocess_vec."""
        ped = self.ped
        ids, ok = self._feasibility()
        NI = len(ids)
        M = ped.num_markers
        lut = np.zeros(max(ids) + 1, dtype=np.int64)
        for i, n in enumerate(ids):
            lut[n] = i

        md = np.stack([ped.by_id(n).markerdata for n in ids])   # [NI,M,2]
        msu = np.stack([ped.by_id(n).markersure for n in ids])
        pars = np.array([[ped.by_id(n).pars[k] for k in range(2)]
                         for n in ids], dtype=np.int64)
        children = np.array([ped.by_id(n).children for n in ids])

        ok0, ok1 = ok[:, :, 0], ok[:, :, 1]
        # neither interpretation feasible: blank the genotype
        clear = ~ok0 & ~ok1 & ((md[..., 0] != UNKNOWN) |
                               (md[..., 1] != UNKNOWN))
        md[clear] = UNKNOWN
        msu[clear] = 0.0

        # exactly-one interpretation survives: propagate (1437)
        one = ok0 ^ ok1
        r = ok1.astype(np.int64)                                # [NI, M]
        probit = msu[..., 0] + msu[..., 1]
        odds = np.where(probit < 1.0,
                        probit / np.where(probit < 1.0, 1.0 - probit, 1.0),
                        1e300)

        # contributions: (parent row, marker, allele value, odds)
        rows_l, ms_l, vals_l, odds_l = [], [], [], []
        mi = np.broadcast_to(np.arange(M)[None, :], (NI, M))
        for k in range(2):
            u = k ^ r                                           # [NI, M]
            val = np.take_along_axis(md, u[..., None],
                                     axis=2)[..., 0]
            has_par = (pars[:, k] != 0)[:, None]
            send = one & has_par & (val != UNKNOWN)
            bi, mm = np.nonzero(send)
            rows_l.append(lut[pars[bi, k]])
            ms_l.append(mm)
            vals_l.append(val[bi, mm])
            odds_l.append(odds[bi, mm])
        rows = np.concatenate(rows_l)
        mms = np.concatenate(ms_l)
        vals = np.concatenate(vals_l)
        oddsv = np.concatenate(odds_l)

        # allele alphabet: proposed values plus the parents' own alleles
        alpha = np.unique(np.concatenate(
            [vals, md[md != UNKNOWN].ravel()]))
        alpha = alpha[alpha != UNKNOWN]
        A = len(alpha)
        if A == 0 or len(rows) == 0:
            any_corr = 0
        else:
            aidx = np.searchsorted(alpha, vals)
            cnt = np.zeros((NI, M, A), dtype=np.int64)
            prod = np.ones((NI, M, A))
            np.add.at(cnt, (rows, mms, aidx), 1)
            with np.errstate(over="ignore"):   # saturated odds products
                np.multiply.at(prod, (rows, mms, aidx), oddsv)
            prop = cnt > 0

            # seed the parent's own known alleles (setdefault semantics:
            # only where no proposal for that value exists)
            scnt = np.zeros_like(cnt)
            sprob = np.zeros((NI, M, A))
            seed = np.zeros((NI, M, A), dtype=bool)
            for side in range(2):
                v = md[..., side]
                kn = v != UNKNOWN
                ai = np.searchsorted(alpha, np.where(kn, v, alpha[0]))
                ai = np.clip(ai, 0, A - 1)
                hit = kn & (np.take_along_axis(
                    np.broadcast_to(alpha[None, None, :], (NI, M, A)),
                    ai[..., None], axis=2)[..., 0] == v)
                put = hit & ~np.take_along_axis(
                    prop, ai[..., None], axis=2)[..., 0]
                # side 0 wins over side 1 (setdefault order)
                put = put & ~np.take_along_axis(
                    seed, ai[..., None], axis=2)[..., 0]
                bi, mm = np.nonzero(put)
                seed[bi, mm, ai[bi, mm]] = True
                scnt[bi, mm, ai[bi, mm]] = children[bi]
                sprob[bi, mm, ai[bi, mm]] = msu[bi, mm, side]

            present = prop | seed
            ecnt = np.where(prop, cnt, scnt)
            eprob = np.where(prop, prod, sprob)

            known = ((md[..., 0] != UNKNOWN).astype(np.int64) +
                     (md[..., 1] != UNKNOWN).astype(np.int64))
            nvals = present.sum(axis=2)
            active = (known < 2) & prop.any(axis=2)

            ar = np.arange(A)
            first = np.argmax(present, axis=2)
            later = present & (ar[None, None, :] > first[..., None])
            second = np.argmax(later, axis=2)

            def take(x, idx):
                return np.take_along_axis(x, idx[..., None],
                                          axis=2)[..., 0]

            c0, c1 = take(ecnt, first), take(ecnt, second)
            p0, p1 = take(eprob, first), take(eprob, second)
            v0 = alpha[first]
            v1 = alpha[second]

            def dosure(what, prob):
                w = np.maximum(what, 1)
                logv = np.log(np.maximum(prob, 1e-320)) / w * 4.0
                with np.errstate(over="ignore", invalid="ignore"):
                    v = np.exp(logv)
                    out = np.where(np.isinf(v), 1.0, v / (1.0 + v))
                return np.where(prob == 0, 0.0, out)

            case2 = active & (nvals == 2)
            case1 = active & (nvals == 1) & (known == 0)
            bi, mm = np.nonzero(case2)
            md[bi, mm, 0] = v0[bi, mm]
            md[bi, mm, 1] = v1[bi, mm]
            ctot = c0 + c1
            msu[bi, mm, 0] = dosure(ctot, p0)[bi, mm]
            msu[bi, mm, 1] = dosure(ctot, p1)[bi, mm]
            bi, mm = np.nonzero(case1)
            md[bi, mm, 0] = v0[bi, mm]
            md[bi, mm, 1] = UNKNOWN
            msu[bi, mm, 0] = dosure(c0, p0)[bi, mm]
            msu[bi, mm, 1] = 0.0
            any_corr = int(case2.sum() + case1.sum())

        # sex-marker normalisation (cnF2freq.cpp:3350-3356)
        swap = md[..., 0] == SEXMARKER
        md[swap] = md[swap][:, ::-1]

        for i, n in enumerate(ids):
            ind = ped.by_id(n)
            ind.markerdata[:] = md[i]
            ind.markersure[:] = msu[i]
        return any_corr

    def _variance_fn(self):
        import jax
        import jax.numpy as jnp
        from .config import ZP_NO_EQUIVALENCE

        @jax.jit
        def run(fb):
            cfg = self.cfg
            if cfg.numgen == 2:
                from .engine_ng2 import embed7, ng3_equiv
                fb = embed7(fb)
                cfg = ng3_equiv(cfg)
            V = [(((fb.flag2ignore[:, None] >> (1 + 3 * k)) & 7)
                  & np.arange(8)[None, :] == 0).astype(fb.ms.dtype)
                 for k in range(2)]
            sq = jnp.zeros(fb.hw.shape[0::2], dtype=fb.ms.dtype)
            for side in range(2):
                terms = []
                for a in range(2):
                    blocks = build_blocks(
                        fb, cfg, ci=True, zp=ZP_NO_EQUIVALENCE,
                        inval=fb.md[:, 0, :, a], insv=fb.ms[:, 0, :, a],
                        side=side, dtype=fb.ms.dtype)
                    p0 = jnp.einsum("zmrfps,zp->zmrs", blocks.pb[0], V[0])
                    p1 = jnp.einsum("zmrfps,zp->zmrs", blocks.pb[1], V[1])
                    t = jnp.einsum("zmrt,zmru,zmrv->zmrtuv",
                                   blocks.froot, p0, p1)
                    ttop = jnp.broadcast_to(
                        blocks.top[:, :, :, :, None, None], t.shape)
                    att = blocks.focal_attop[:, None, None, None, None,
                                             None]
                    terms.append(jnp.where(att, ttop, t))
                # one squared allele-difference sum per addvariance
                # group (shiftflagmode, majori, majorflag2): the group
                # sums ALL upper state/path combinations
                # (cnF2freq.cpp:1510-1545).  In the factored blocks a
                # DEEP branch (recursion past the parent) spreads that
                # state mass over its shift axis — sum it; a branch
                # whose parent is a recursion top (or missing)
                # replicates over the axis — pin it to 0.  Pinned
                # against the binary's AVGRP trace on both an all-aux
                # and a genotyped-F1 cohort (the old u=v=0 form
                # undercounted deep branches 4x).
                deep = []
                for k in range(2):
                    ps = cfg.parent_slot(k)
                    deep.append(jnp.asarray(
                        fb.exists[:, ps] & ~fb.attop[:, ps]))
                sel0 = jnp.asarray(np.arange(2) == 0, dtype=fb.ms.dtype)
                wu = jnp.where(deep[0][:, None], 1.0, sel0[None, :])
                wv = jnp.where(deep[1][:, None], 1.0, sel0[None, :])
                d = terms[1] - terms[0]
                dg = jnp.einsum("zmrtuv,zu,zv->zmrt", d, wu, wv)
                sq = sq + (dg ** 2).sum(axis=(2, 3))
            return sq

        return run

    def _compute_variances(self, chunk: int = 1024):
        """addvariance for every individual (cnF2freq.cpp:1489-1558):
        per-marker informativeness from NO_EQUIVALENCE allele-difference
        probes, feeding the phase-anchor choice.  Jitted + chunked."""
        import jax.numpy as jnp
        from .parallel.mesh import pad_batch
        ped = self.ped
        ids = [ind.n for ind in ped.inds[1:]
               if ind.haploweight is not None]
        if "var" not in self._scan_cache:
            self._scan_cache["var"] = self._variance_fn()
        run = self._scan_cache["var"]
        for b0 in range(0, len(ids), chunk):
            sub = ids[b0:b0 + chunk]
            fb = gather_family(ped, sub, 0, ped.num_markers - 1,
                               dtype=self.dtype, mask_mode=self.mask_mode)
            if len(sub) < chunk and len(ids) > chunk:
                fb = pad_batch(fb, chunk)
            sq = np.asarray(run(fb.map(jnp.asarray)))
            for bi, n in enumerate(sub):
                ped.by_id(n).variances[:] = sq[bi]

    def _lockhaplos(self, ind, c: int):
        """Anchor the phase at the most informative marker
        (cnF2freq.cpp:3045-3079)."""
        lo, hi = self.ped.chromosome_range(c)
        if ind.lockstart[c] >= hi:
            ind.lockstart[c] = 0
        start = max(lo, ind.lockstart[c])
        seg = ind.variances[start:hi]
        if seg.size == 0 or (seg <= 0).all():
            return
        j = start + int(np.argmax(seg))
        ind.haploweight[j] = 0.0 if ind.haploweight[j] <= 0.5 else 1.0
        ind.lockstart[c] = j + 1

    # ------------------------------------------------------------------
    # One iteration (doit)
    # ------------------------------------------------------------------
    @full_f32
    def iterate(self, early: bool = False):
        import jax.numpy as jnp
        if self.marker_block is not None and self.cfg.numgen == 2 \
                and not self.cfg.haplotyping:
            raise NotImplementedError(
                "marker-blocked scans: the no-haplotyping deep-walk "
                "engine is whole-chromosome only")
        ped, cfg, params = self.ped, self.cfg, self.params
        st = self.state
        st.iter += 1
        dous = list(ped.dous)
        ped.count_children(dous_only=True)

        ids = [ind.n for ind in ped.inds[1:]]
        ind_index = {n: i for i, n in enumerate(ids)}
        M = ped.num_markers
        NI = len(ids)
        need_coh = self.adaptive_relhaplo and (cfg.relskews or
                                               cfg.relskewstates)
        fast = self._use_resident()
        if fast:
            # device-resident accumulators (resident.py): scan partials,
            # flips and parameter updates never leave the device; under
            # a mesh the individual axis is padded + row-sharded so the
            # whole accumulate/flip/update chain scales over "data"
            from .resident import ResidentAccum
            NI_eff, row_sh = self._fast_layout(NI)
            accum = ResidentAccum(NI_eff, M, self.dtype,
                                  with_coh=need_coh,
                                  progs=self._scan_cache,
                                  sharding=row_sh)
            self._pair_pending.clear()
            haplobase = haplocount = infacc = None
        else:
            NI_eff = NI
            accum = None
            haplobase = np.zeros((NI, M))
            haplocount = np.zeros((NI, M))
            infacc = np.zeros((NI, M, 2, 2))
        coh_num = np.zeros((NI, M))
        coh_den = np.zeros((NI, M))
        winners: List[Optional[FlipCandidate]] = []
        swap_cands: list = []  # parent-pair swap hypotheses, all chroms

        # missing/vacant slots map to the sentinel row NI_eff (dropped
        # by the segment-sum merges)
        lut = np.full(max(ids) + 1, NI_eff, dtype=np.int32)
        for n, i in ind_index.items():
            lut[n] = i
        lutj = jnp.asarray(lut)

        for c in range(ped.num_chromosomes):
            lo, hi = ped.chromosome_range(c)
            for n in dous:
                ped.by_id(n).lastinved[c] = -1
            Mc = hi - lo
            if self.marker_block is not None and Mc > self.marker_block:
                if self.ext or cfg.numgen == 2:
                    winner = self._chromosome_blocked_family(
                        c, lo, hi, dous, haplobase, haplocount, infacc,
                        ind_index, lut, early)
                else:
                    winner = self._chromosome_blocked(
                        c, lo, hi, dous, haplobase, haplocount, infacc,
                        ind_index, lut, early, coh_num=coh_num,
                        coh_den=coh_den)
                winners.append(winner)
                if winner is not None:
                    apply_flips(ped, winner, c, haplobase, haplocount,
                                ind_index)
                continue
            if self.mesh is not None:
                scan_fn, coh_fn = self._jitted_scan_sharded(NI_eff), None
            else:
                scan_fn, coh_fn = self._jitted_scan_merged(NI_eff)
            Mp = Mc if not self.marker_bucket else \
                -(-Mc // self.marker_bucket) * self.marker_bucket
            dists = np.diff(ped.markerposes[lo:hi]).astype(self.dtype)
            dj = jnp.asarray(np.pad(dists, (0, Mp - Mc)))
            # per-interval per-bit map rates: carries re-estimated
            # genetic-map rates (remap_distances -> ped.actrec) into
            # every subsequent scan
            from .hmm.transition import rate_matrix
            rm = rate_matrix(self.cfg, self.params, Mc - 1, ped.actrec,
                             lo, dtype=self.dtype)
            rj = jnp.asarray(np.pad(rm, ((0, Mp - Mc), (0, 0))))

            # analysis units stream through the device in fixed-size
            # chunks: one compiled program, bounded HBM at any cohort size
            bs = self._chunk_size(len(dous), Mp)
            if self.mesh is not None:
                nd = self.mesh.shape["data"]
                bs = max(nd, -(-bs // nd) * nd)
            weight_parts = []
            remap_acc = (np.zeros((2, Mc - 1)), np.zeros(2, dtype=np.int64))
            for b0 in range(0, len(dous), bs):
                chunk = dous[b0:b0 + bs]
                with self.tracer.span("gather"):
                    # the light batch skeleton (slot indices, masks,
                    # descendants) is pedigree structure — static across
                    # iterations; cache it (and its device upload) per
                    # (chromosome, chunk)
                    fbkey = ("fb_light", c, b0, bs, self.mask_mode)
                    cached = self._scan_cache.get(fbkey) if fast else None
                    if cached is not None and cached[0] == chunk:
                        fbatch, fb_skel = cached[1], cached[2]
                    else:
                        fbatch = gather_family(
                            ped, chunk, lo, hi - 1, dtype=self.dtype,
                            mask_mode=self.mask_mode, parity=self.parity,
                            n_variants=self._n_variants(), light=fast)
                        if not fast and Mp > Mc:
                            from .parallel.mesh import pad_markers
                            fbatch = pad_markers(fbatch, Mp)
                        if len(chunk) < bs:
                            from .parallel.mesh import pad_batch
                            fbatch = pad_batch(fbatch, bs)
                        fb_skel = fbatch.map(jnp.asarray) if fast \
                            else None
                        if fast:
                            self._scan_cache[fbkey] = (list(chunk),
                                                       fbatch, fb_skel)
                    if fast:
                        # md/ms/hw gathered ON DEVICE from the per-
                        # iteration ScanCohort upload (resident.py) —
                        # replaces the dominant per-chunk host transfer
                        fbj = self._fill_family_dev(
                            fb_skel, fbatch.slot_ind,
                            lut, lo, Mp, ids)
                        if self.mesh is not None:
                            from .parallel.mesh import shard_batch
                            fbj = shard_batch(fbj, self.mesh)
                    elif self.mesh is not None:
                        from .parallel.mesh import shard_batch
                        fbj = shard_batch(fbatch, self.mesh)
                    else:
                        fbj = fbatch.map(jnp.asarray)
                with self.tracer.span("scan"):
                    if self.mesh is not None:
                        (total, pair_t, turn_w, hb_p, hc_p, inf_p,
                         coh_t, rec_p, rec_n) = scan_fn(fbj, dj, lutj,
                                                        rj)
                        res = None
                    else:
                        res, hb_p, hc_p, inf_p = scan_fn(fbj, dj, lutj,
                                                         rj)
                        total, pair_t = res.total, res.pair
                        turn_w, coh_t = res.turn_weight, None
                    # tiny readback as the sync point: attributes device
                    # time here rather than to the first big transfer
                    # (a replicated scalar under a mesh: per-unit totals
                    # are process-sharded on multi-controller runs)
                    if self.mesh is not None:
                        _ = np.asarray(hb_p[0, 0])
                    else:
                        _ = np.asarray(total)
                nb = len(chunk)
                with self.tracer.span("scatter"):
                    sb = fbatch.slot_ind[:nb]
                    desc = fbatch.descendants[:nb].astype(np.float64)
                    if fast:
                        # partials fold into device buffers; pair tables
                        # stay on device until a reporter reads them
                        self._pair_pending.append(
                            (list(chunk), lo, Mc, pair_t))
                        accum.add(lo, Mc, hb_p, hc_p, inf_p)
                    else:
                        self._store_pair_tables(
                            chunk, lo, _host_value(pair_t)[:nb, :Mc])
                        # accumulators were merged on device (segment-sum
                        # per individual row, make_jitted_scan_merged);
                        # only [NI, M] partials cross the host link
                        haplobase[:, lo:hi] += np.asarray(
                            hb_p, dtype=np.float64)[:, :Mc]
                        haplocount[:, lo:hi] += np.asarray(
                            hc_p, dtype=np.float64)[:, :Mc]
                        infacc[:, lo:hi] += np.asarray(
                            inf_p, dtype=np.float64)[:, :Mc]
                if self.remap_distances:
                    if self.mesh is not None:
                        # cohort-aggregated expectations came out of the
                        # sharded program (psum over the data axis)
                        sexes = np.asarray(self.cfg.typesexes)
                        sums, counts = remap_acc
                        p_sum = np.asarray(rec_p)[:Mc - 1]
                        n_real = float(np.asarray(rec_n))
                        for sex in range(2):
                            sel = sexes == sex
                            sums[sex] += p_sum[:, sel].sum(axis=1)
                            counts[sex] += int(round(n_real *
                                                     int(sel.sum())))
                    else:
                        self._accumulate_recomb(nb, Mc, fbj, dj, res,
                                                rj, remap_acc)
                if need_coh and fast:
                    with self.tracer.span("coherence"):
                        num_p, den_p = self._coherence_partials(
                            fbj, dj, rj, res, lutj, Mc, NI_eff,
                            coh_t=coh_t if self.mesh is not None
                            else None)
                        accum.add_coh(lo, Mc, num_p, den_p)
                elif need_coh:
                    with self.tracer.span("coherence"):
                        from .updates.scatter import scatter_coherence
                        if self.ext:
                            # extended spaces deliver coherence from the
                            # scan itself.  RELSKEWSTATES: the
                            # coherence-bit xor-marginal lives in slot 0
                            # (other slots stay neutral and must not be
                            # scattered); SELFING: per-slot coherence
                            # like the standard space.
                            coh = np.asarray(res.coherence
                                             if coh_t is None else coh_t)
                            ns = 1 if self.cfg.relskewstates \
                                else self.cfg.numslots
                            cohr = np.array(coh[:nb, :Mc, :ns])
                            cohr[:, Mc - 1] = 0.5
                            scatter_coherence(sb[:, :ns], desc, lo, cohr,
                                              coh_num, coh_den,
                                              ind_index)
                            coh = None
                        elif coh_t is not None:
                            # mesh path: coherence came out of the
                            # sharded scan program
                            coh = _host_value(coh_t)
                        else:
                            # one dispatch per slot: an all-slot program
                            # was tried and exceeds HBM at B=1000 (XLA
                            # schedules the slot chains' temporaries
                            # concurrently)
                            coh = np.stack([
                                np.asarray(coh_fn(fbj, dj, res.fw_pre,
                                                  res.bw, res.fw_pre_f,
                                                  res.bw_f, slot,
                                                  ratemat=rj))
                                for slot in range(self.cfg.numslots)],
                                axis=-1)
                        if coh is not None:
                            cohr = np.array(coh[:nb, :Mc])
                            # the last marker has no right neighbor:
                            # keep its interval coherence neutral (with
                            # marker bucketing the raw column holds the
                            # real-to-pad-marker value, an artifact)
                            cohr[:, Mc - 1] = 0.5
                            scatter_coherence(sb, desc, lo, cohr,
                                              coh_num, coh_den,
                                              ind_index)
                if not early and cfg.haplotyping:
                    # native mode keeps the [nb, M, T] chunks ON DEVICE:
                    # the flip scorer consumes them there and only [B, k]
                    # top-marker slices cross the host link
                    weight_parts.append(turn_w[:nb, :Mc])

            if not early and cfg.haplotyping:
                with self.tracer.span("flips"):
                    if self.parity:
                        # reference-exact DOTOULBAR pipeline
                        # (updates/refflips.py)
                        from .updates.refflips import reference_flips
                        weights = np.concatenate(
                            [_host_value(p).astype(np.float64)
                             for p in weight_parts], axis=0)
                        winner = reference_flips(
                            ped, cfg, dous, lo, hi, weights,
                            haplobase, haplocount, ind_index)
                    elif self.flip_mode == "negshift":
                        # legacy DOTOULBAR=0 path: unscale the descendant
                        # factor baked into turn weights, then
                        # single-member negshift inversion
                        # (updates/negshift.py)
                        from .updates.negshift import negshift_flips
                        weights = np.concatenate(
                            [_host_value(p) for p in weight_parts], axis=0)
                        desc = np.array(
                            [max(ped.by_id(n).descendants, 1)
                             for n in dous], dtype=float)
                        unscaled = weights / desc[:, None, None]
                        winner = negshift_flips(
                            ped, dous, lo, hi, unscaled, cfg)
                        if self.parent_swap:
                            # score now; dominance + execution happen
                            # once, genome-wide, after the parameter
                            # updates — the reference calls
                            # parentswapnegshifts after negshifter AND
                            # after updatehaploweights
                            # (cnF2freq.cpp:6335-6371), and swap moves
                            # flip haploweight without mirroring
                            # haplobase, so applying them before the
                            # haploweight blend would let stale
                            # haplobase/haplocount partially revert
                            # them whenever scalefactor is nonzero.
                            from .updates.negshift import \
                                parent_swap_candidates
                            swap_cands += parent_swap_candidates(
                                ped, dous, lo, hi, unscaled, cfg)
                    else:
                        with self.tracer.span("optimise"):
                            winner = self._optimise_flips(
                                dous, lo, hi, weight_parts, haplobase,
                                haplocount, ind_index, c, accum=accum)
                    winners.append(winner)
                    if winner is not None:
                        apply_flips(ped, winner, c, haplobase, haplocount,
                                    ind_index)
                        if fast:
                            rows_flips = [(ind_index[n], m)
                                          for n, m in winner.flips
                                          if n in ind_index]
                            accum.flip_rows(rows_flips, hi)
                            self._flip_param(accum, rows_flips, hi)
            else:
                winners.append(None)
            if self.remap_distances:
                self._apply_recomb(lo, hi, remap_acc)

        # fast path with haplotyping: the adaptive-relhaplo refresh runs
        # inside the resident update program (straight from the device
        # cnum/cden partials, same arithmetic) — no separate readback
        rh_in_updates = fast and need_coh and cfg.haplotyping
        if need_coh and not rh_in_updates:
            if fast:
                import jax
                coh_num, coh_den = jax.device_get((accum.cnum,
                                                   accum.cden))
                coh_num = coh_num.astype(np.float64)
                coh_den = coh_den.astype(np.float64)
            got = coh_den > 0
            vals = np.where(got, coh_num / np.maximum(coh_den, 1), 0.5)
            for n, i in ind_index.items():
                ind = ped.by_id(n)
                if ind.relhaplo is not None and got[i].any():
                    ind.relhaplo[got[i]] = np.clip(vals[i, got[i]], 1e-4,
                                                   1 - 1e-4)

        any_inv = any(w is not None for w in winners)
        sf = 0.0 if any_inv else st.scalefactor
        hits = 0
        if cfg.haplotyping:
            with self.tracer.span("updates"):
                if fast:
                    hits += self._updates_resident(ids, accum, sf)
                else:
                    with self.tracer.span("infprobs"):
                        hits += self._process_infprobs(ids, infacc, sf)
                    with self.tracer.span("haploweights"):
                        hits += self._update_haploweights(
                            ids, haplobase, haplocount, sf)
        # (no-haplotyping: every update hook in the reference sits behind
        # `if (!full && HAPLOTYPING)` — an iteration is pure posterior
        # computation, cnF2freq.cpp:5554)
        if swap_cands:
            # one genome-wide dominance pass, after the updates — the
            # reference's parentswapnegshifts placement
            # (cnF2freq.cpp:6369-6371)
            from .updates.negshift import apply_parent_swaps
            apply_parent_swaps(ped, swap_cands)
        self._adapt_scalefactor(any_inv, hits, len(dous))
        self.tracer.metric(event="iteration", iter=st.iter, hitnnn=hits,
                           inverted=any_inv,
                           scalefactor=st.scalefactor,
                           flips=sum(len(w.flips) for w in winners
                                     if w is not None and
                                     hasattr(w, "flips")))
        return dict(hitnnn=hits, inverted=any_inv,
                    scalefactor=st.scalefactor)

    # -- scatter helpers ------------------------------------------------
    def _store_pair_tables(self, dous, lo, pair):
        for b, n in enumerate(dous):
            tab = self._pair_tables.setdefault(
                n, np.zeros((self.ped.num_markers, 2, 2)))
            tab[lo:lo + pair.shape[1]] = pair[b]

    # (movehaplos/moveinfprobs scatter live in updates/scatter.py as
    # batched numpy; loop-form parity pinned by tests/test_scatter.py)

    # -- resident fast path --------------------------------------------
    def _md_ms_dev(self, ids):
        """Device md/ms for this iteration, reusing last iteration's
        update outputs when the pedigree still matches the host mirror
        (exact array comparison — external mutations like deserialize or
        masking force a fresh upload automatically)."""
        import jax.numpy as jnp
        st = self.state
        cur = getattr(self, "_md_ms_cache", None)
        if cur is not None and cur[0] == st.iter:
            return cur[1]
        dtype = np.dtype(self.dtype)
        ped = self.ped
        NI_eff, row_sh = self._fast_layout(len(ids))
        md = self._pad_rows(np.stack([ped.by_id(n).markerdata
                                      for n in ids]).astype(np.int32),
                            NI_eff)
        ms = self._pad_rows(np.stack([ped.by_id(n).markersure
                                      for n in ids]).astype(dtype),
                            NI_eff)
        mirror = getattr(self, "_update_mirror", None)
        if mirror is not None and np.array_equal(mirror["md"], md) \
                and np.array_equal(mirror["ms"], ms):
            out = (mirror["mdj"], mirror["msj"])
        else:
            out = (self._place(jnp.asarray(md), row_sh),
                   self._place(jnp.asarray(ms), row_sh))
        self._md_ms_cache = (st.iter, out)
        return out

    @staticmethod
    def _place(arr, sharding):
        if sharding is None:
            return arr
        import jax
        return jax.device_put(arr, sharding)

    def _param_dev(self, ids):
        """Device haploweight/relhaplo mirrors for the resident path.

        Like _md_ms_dev: the f64 host copies are compared exactly
        against the pedigree each iteration, so last iteration's
        update-program outputs are reused without an upload unless
        something external (deserialize, masking, preprocess) mutated
        the host state.  Mid-iteration phase flips go through
        _flip_param, which applies the identical inversion to the host
        copy and the device mirror."""
        import jax.numpy as jnp
        st = self.state
        cur = getattr(self, "_param_cache", None)
        if cur is not None and cur[0] == st.iter:
            return cur[1]
        ped = self.ped
        M = ped.num_markers
        NI_eff, row_sh = self._fast_layout(len(ids))
        hw = self._pad_rows(np.stack([ped.by_id(n).haploweight
                                      for n in ids]), NI_eff, 0.5)
        if self.cfg.relskews or self.cfg.relskewstates:
            rh = np.stack([ped.by_id(n).relhaplo
                           if ped.by_id(n).relhaplo is not None
                           else np.full(M, 0.5) for n in ids])
            rh = self._pad_rows(rh, NI_eff, 0.5)
        else:
            rh = np.zeros_like(hw)
        mirror = getattr(self, "_param_mirror", None)
        dtype = np.dtype(self.dtype)
        if mirror is not None and np.array_equal(mirror["hw"], hw) \
                and np.array_equal(mirror["rh"], rh):
            out = (mirror["hwj"], mirror["rhj"])
        else:
            out = (self._place(jnp.asarray(hw.astype(dtype)), row_sh),
                   self._place(jnp.asarray(rh.astype(dtype)), row_sh))
            self._param_mirror = dict(hw=hw, rh=rh, hwj=out[0],
                                      rhj=out[1])
        self._param_cache = (st.iter, out)
        return out

    def _flip_param(self, accum, flips, hi):
        """Mirror apply_flips' haploweight inversion onto the device hw
        mirror and its host copy (exact same arithmetic, so the
        host-equality fast path in _param_dev keeps holding)."""
        if not flips:
            return
        hwj, rhj = self._param_cache[1]
        hwj = accum.flip_hw(hwj, flips, hi)
        mirror = self._param_mirror
        for r, m in flips:
            mirror["hw"][r, m + 1:hi] = 1.0 - mirror["hw"][r, m + 1:hi]
        mirror["hwj"] = hwj
        self._param_cache = (self.state.iter, (hwj, rhj))

    def _scan_cohort(self, ids):
        """Per-iteration device cohort tensors in the padded marker
        layout (resident.ScanCohort); rebuilt each iteration (hw/md/ms
        change between iterations, never within the scan stage)."""
        from .resident import ScanCohort
        st = self.state
        cur = getattr(self, "_scan_cohort_cache", None)
        if cur is not None and cur[0] == st.iter:
            return cur[1]
        ped = self.ped
        layout = []
        plo = 0
        for c in range(ped.num_chromosomes):
            lo, hi = ped.chromosome_range(c)
            Mc = hi - lo
            Mp = Mc if not self.marker_bucket else \
                -(-Mc // self.marker_bucket) * self.marker_bucket
            layout.append((lo, hi, plo, Mp))
            plo += Mp
        mdj, msj = self._md_ms_dev(ids)
        hwj, rhj = self._param_dev(ids)
        cohort = ScanCohort(ped, ids, np.dtype(self.dtype), layout,
                            with_rh=self.cfg.relskewstates,
                            dev_md=mdj, dev_ms=msj,
                            dev_hw=hwj,
                            dev_rh=rhj if self.cfg.relskewstates
                            else None,
                            progs=self._scan_cache)
        self._scan_cohort_cache = (st.iter, cohort)
        return cohort

    def _fill_family_dev(self, fbj, slot_ind, lut, lo, Mp, ids):
        """Replace a light FamilyBatch's md/ms/hw (and relh) with
        device gathers from the ScanCohort."""
        import dataclasses

        import jax.numpy as jnp

        from .resident import make_gather_dev
        cohort = self._scan_cohort(ids)
        plo, mp = cohort.layout[lo]
        assert mp == Mp, (mp, Mp)
        NI_eff, _ = self._fast_layout(len(ids))
        rows = np.where(slot_ind > 0, lut[slot_ind], NI_eff)
        key = ("gather_dev", rows.shape, Mp,
               self.cfg.relskewstates, str(np.dtype(self.dtype)))
        if key not in self._scan_cache:
            self._scan_cache[key] = make_gather_dev(
                Mp, self.cfg.relskewstates)
        md, ms, hw, rh = self._scan_cache[key](
            cohort.md, cohort.ms, cohort.hw, cohort.rh,
            jnp.asarray(rows), plo)
        return dataclasses.replace(fbj, md=md, ms=ms, hw=hw, relh=rh)

    def _coherence_partials(self, fbj, dj, rj, res, lutj, Mc, NI,
                            coh_t=None):
        """One dispatch: all-slot adjacent-phase coherence scattered onto
        [NI, Mp] num/den partials on device (resident.py).  coh_t: the
        mesh path supplies per-unit coherence already computed inside
        the sharded scan program; only the psum'd scatter remains."""
        if coh_t is not None:
            from .resident import make_scatter_coh_sharded
            ns = 1 if self.cfg.relskewstates else self.cfg.numslots
            key = ("coh_scatter_sh", NI, ns, Mc)
            if key not in self._scan_cache:
                self._scan_cache[key] = make_scatter_coh_sharded(
                    NI, ns, self.mesh, Mc)
            return self._scan_cache[key](coh_t, fbj.slot_ind,
                                         fbj.descendants, lutj)
        if self.ext:
            from .resident import make_scatter_coh_ext
            ns = 1 if self.cfg.relskewstates else self.cfg.numslots
            key = ("coh_scatter_ext", NI, ns)
            if key not in self._scan_cache:
                self._scan_cache[key] = make_scatter_coh_ext(
                    self.cfg, NI, ns)
            return self._scan_cache[key](res.coherence, fbj.slot_ind,
                                         fbj.descendants, lutj, Mc=Mc)
        from .resident import make_coherence_all
        key = ("coh_all", NI)
        if key not in self._scan_cache:
            self._scan_cache[key] = make_coherence_all(self.cfg,
                                                       self.params, NI)
        return self._scan_cache[key](fbj, dj, res.fw_pre, res.bw,
                                     res.fw_pre_f, res.bw_f, rj, lutj,
                                     Mc=Mc)

    def _updates_resident(self, ids, accum, scalefactor) -> int:
        """Device-path parameter updates: processinfprobs then
        updatehaploweights straight from the resident accumulators
        (cnF2freq.cpp:4179-4323, 4533-4734), plus — when measured
        coherence is on — the adaptive-relhaplo refresh, all in one
        program.  hw/rh come from the device mirrors (_param_dev, flips
        already applied on device), so no per-iteration upload; the
        final per-individual state crosses the link in ONE batched
        transfer."""
        import jax
        import jax.numpy as jnp

        from .resident import gather_cohort_static, make_resident_updates
        ped, cfg = self.ped, self.cfg
        NI, M = accum.NI, accum.Mtot
        C = ped.num_chromosomes
        ranges = tuple(ped.chromosome_range(c) for c in range(C))
        with_coh = bool(accum.with_coh and self.adaptive_relhaplo)
        _, row_sh = self._fast_layout(len(ids))
        skey = ("resident_static", NI)
        if skey not in self._scan_cache:
            self._scan_cache[skey] = gather_cohort_static(
                ped, ids, self.dtype, ni_eff=NI, sharding=row_sh)
        static = self._scan_cache[skey]
        ukey = ("resident_updates", NI, M, ranges, with_coh)
        if ukey not in self._scan_cache:
            self._scan_cache[ukey] = make_resident_updates(
                cfg, self.params, ranges, NI, M, with_coh=with_coh)
        run_updates = self._scan_cache[ukey]

        dtype = np.dtype(self.dtype)
        with self.tracer.span("stack"):
            lastinv_c = self._pad_rows(np.stack(
                [[ped.by_id(n).lastinved[c] != -1 for c in range(C)]
                 for n in ids]).astype(bool), NI, False)
        # compact imputation readbacks: only eligible rows can change
        # md/ms (take is gated on eligibility), so their outputs are
        # gathered to [NE, ...] before crossing the link
        ekey = ("elig_rows", NI)
        if ekey not in self._scan_cache:
            elig_h = np.zeros(NI, dtype=bool)
            for i, n in enumerate(ids):
                ind = ped.by_id(n)
                elig_h[i] = ind.has_prior and not ind.empty
            rows_e = np.where(elig_h)[0].astype(np.int32)
            self._scan_cache[ekey] = (
                rows_e, jnp.asarray(rows_e) if len(rows_e) < NI
                else None)
        elig_rows, elig_idx = self._scan_cache[ekey]
        sfj = jnp.asarray(dtype.type(scalefactor))
        with self.tracer.span("device"):
            mdj, msj = self._md_ms_dev(ids)
            hwj, rhj = self._param_dev(ids)   # post-flip device mirrors
            coh_args = dict(cnum=accum.cnum, cden=accum.cden,
                            has_rh=static.has_rh) if with_coh else {}
            (newmd, newms, newmd8, take, newhw, active, hits_dev,
             hw_full, rh_new, got, newms_c) = run_updates(
                accum.inf, mdj, msj, static.prior, static.priorsure,
                static.has_prior, static.children, static.eligible,
                hwj, accum.hb, accum.hc, rhj,
                static.descendants, jnp.asarray(lastinv_c), sfj,
                elig_idx=elig_idx, **coh_args)
            # one batched host transfer: device_get issues every copy
            # async before blocking (vs one serialized round trip per
            # np.asarray)
            pulls = [newmd8, newms_c, take, newhw, active, hits_dev]
            if with_coh:
                pulls += [rh_new, got]
            if jax.process_count() > 1:
                # multi-controller: the row-sharded outputs span
                # processes; all-gather them (device_get would raise on
                # non-fully-addressable arrays)
                host = tuple(_host_value(x) for x in pulls)
            else:
                host = jax.device_get(tuple(pulls))
            newmd_h, newms_h, take_h, newhw_h, act_h, hits_h = host[:6]
            newhw_h = newhw_h.astype(np.float64)
            hits = int(hits_h)
            newms_h = newms_h.astype(np.float64)
            row_ids = ids if elig_idx is None else \
                [ids[r] for r in elig_rows]
        with self.tracer.span("writeback"):
            # masked writeback: untouched lanes keep their full-precision
            # host values (the device pipeline may run at f32)
            mirror = self._param_mirror
            for i, n in enumerate(row_ids):
                ind = ped.by_id(n)
                t = take_h[i]
                if t.any():
                    ind.markerdata[t] = newmd_h[i][t]
                    ind.markersure[t] = newms_h[i][t]
            for i, n in enumerate(ids):
                ind = ped.by_id(n)
                a = act_h[i]
                ind.haploweight[a] = newhw_h[i][a]
            # next iteration reuses the device outputs as its inputs
            # when the pedigree still matches the host mirrors; the
            # host copies are re-stacked post-writeback (the compact
            # readback no longer carries the full arrays)
            md_m = self._pad_rows(np.stack(
                [ped.by_id(n).markerdata for n in ids]).astype(np.int32),
                NI)
            ms_m = self._pad_rows(np.stack(
                [ped.by_id(n).markersure for n in ids]).astype(dtype),
                NI)
            self._update_mirror = dict(md=md_m, ms=ms_m,
                                       mdj=newmd, msj=newms)
            mirror["hw"][act_h] = newhw_h[act_h]
            mirror["hwj"] = hw_full
            if with_coh:
                rh_h = host[6].astype(np.float64)
                got_h = host[7]
                for i, n in enumerate(ids):
                    ind = ped.by_id(n)
                    g = got_h[i]
                    if ind.relhaplo is not None and g.any():
                        ind.relhaplo[g] = rh_h[i][g]
                        mirror["rh"][i][g] = rh_h[i][g]
                mirror["rhj"] = rh_new
        return hits

    def _accumulate_recomb(self, nb, Mc, fbj, dj, res, rj, acc):
        """Per-chunk accumulation of posterior recombination expectations
        (real rows and real intervals only): acc = (sum [2, Mc-1],
        count [2])."""
        if self.ext:
            from .engine_ext import make_jitted_recomb_ext
            key = ("recomb_ext", self.dtype)
            if key not in self._scan_cache:
                self._scan_cache[key] = make_jitted_recomb_ext(
                    self.cfg, self.params)
        else:
            from .engine import make_jitted_recomb
            key = ("recomb", self.dtype)
            if key not in self._scan_cache:
                self._scan_cache[key] = make_jitted_recomb(self.cfg,
                                                           self.params)
        p = _host_value(self._scan_cache[key](
            fbj, dj, res.fw_pre, res.bw, res.fw_pre_f, res.bw_f,
            ratemat=rj))[:nb, :Mc - 1]   # drop batch + marker padding
        sexes = np.asarray(self.cfg.typesexes)
        sums, counts = acc
        for sex in range(2):
            sel = sexes == sex
            sums[sex] += p[:, :, sel].sum(axis=(0, 2))
            counts[sex] += nb * int(sel.sum())

    def _apply_recomb(self, lo, hi, acc):
        """Once per chromosome per iteration: EM update of per-sex
        per-interval recombination rates from the accumulated
        expectations (replaces the reference's twicestop-probe
        machinery, cnF2freq.cpp:5586-5664, 6196-6230).  The updated
        ped.actrec feeds back into every later scan through the
        rate_matrix argument of the jitted scan."""
        ped = self.ped
        sums, counts = acc
        if ped.actrec is None:
            ped.actrec = np.full((2, ped.num_markers),
                                 self.params.baserec)
        dists = np.diff(ped.markerposes[lo:hi])
        for sex in range(2):
            if counts[sex] == 0:
                continue
            rhat = np.clip(sums[sex] / counts[sex], 1e-8, 0.49)
            rate = np.log(1.0 - 2.0 * rhat) / np.maximum(dists, 1e-9)
            rate = np.clip(rate, -20.0, -1e-4)
            old = ped.actrec[sex, lo + 1:hi]
            ped.actrec[sex, lo + 1:hi] = 0.5 * old + 0.5 * rate

    def _flip_static(self, dous, chrom):
        """Marker-independent flip-problem structure, cached per
        chromosome: per-family variable lists, turn->pattern index maps,
        allowed-turn masks, and the connected components of the
        family/variable graph with component-local position arrays."""
        key = ("flip_static", chrom, len(dous), dous[0], dous[-1])
        if key in self._scan_cache:
            return self._scan_cache[key]
        ped = self.ped
        T = self.cfg.numturns
        B = len(dous)
        t_ = np.arange(T)
        pat = np.zeros((B, T), dtype=np.int32)
        allowed = np.zeros((B, T), dtype=bool)
        varlists: List[List[int]] = [None] * B
        for b, n in enumerate(dous):
            members, exists = family_variables(ped, n)
            f2i = int(ped.missing_flag2_mask(n))
            varbits = [bit for bit in range(len(exists))
                       if exists[bit]]
            p = np.zeros(T, dtype=np.int32)
            for i, bit in enumerate(varbits):
                p |= ((t_ >> bit) & 1) << i
            pat[b] = p
            allowed[b] = (t_ & (f2i >> 1)) == 0
            varlists[b] = [members[bit] for bit in varbits]

        from .updates.phaseflip import _components
        comps = _components([(vl, None) for vl in varlists])
        comp_of_fam = np.zeros(B, dtype=np.int64)
        comp_struct = []
        for ci, comp in enumerate(comps):
            vset = sorted({v for fi in comp for v in varlists[fi]})
            vidx = {v: i for i, v in enumerate(vset)}
            pos = [np.array([vidx[v] for v in varlists[fi]])
                   for fi in comp]
            comp_struct.append((comp, vidx, pos, len(vset)))
            for fi in comp:
                comp_of_fam[fi] = ci
        out = (varlists, pat, allowed, comp_struct, comp_of_fam)
        self._scan_cache[key] = out
        return out

    def _jitted_flip_scorer(self):
        key = ("flip_scorer",)
        if key not in self._scan_cache:
            from .updates.phaseflip import make_flip_scorer
            self._scan_cache[key] = make_flip_scorer()
        return self._scan_cache[key]

    # -- flip optimisation ----------------------------------------------
    def _optimise_flips(self, dous, lo, hi, weight_parts, haplobase,
                        haplocount, ind_index, chrom, accum=None
                        ) -> Optional[FlipCandidate]:
        """Native phase-flip optimisation (the DOTOULBAR=1 replacement).

        Scoring runs on device (phaseflip.make_flip_scorer): clamp,
        relskew clause adjustment, per-family pattern sums over the turn
        axis, and top-k marker selection; only the [B, k] winners cross
        the host link.  Per hot marker, every connected component of the
        family/variable graph containing a gainful family is solved in
        full — the reference solves the complete per-marker WCNF over
        all families (cnF2freq.cpp:5978-6084)."""
        scored = self._score_turns(dous, lo, hi, weight_parts, haplobase,
                                   haplocount, ind_index, chrom,
                                   accum=accum)
        return self._solve_scored(dous, lo, hi, scored, chrom)

    def _score_turns(self, dous, lo, hi, weight_parts, haplobase,
                     haplocount, ind_index, chrom, marker_offset=0,
                     m_span=None, skew_rows=None, halo=False,
                     accum=None):
        """Device scoring of one marker span: returns host
        (idx_global, mg, gains [B, k], S_top [B, k, P]).  weight_parts:
        device [Bi, m_span, T] chunks (batch chunks); marker_offset maps
        span-local indices back to chromosome-local ones (blocked
        mode); skew_rows optionally supplies pre-sliced (hb, hc)
        [B, m_span] rows (blocked mode scores against in-progress
        accumulators)."""
        import jax.numpy as jnp
        ped = self.ped
        B = len(dous)
        M = m_span if m_span is not None else hi - lo
        s0 = lo + marker_offset
        Mh = M + (1 if halo else 0)   # skew inputs carry a right halo

        with_skew = bool(self.cfg.relskews)
        dt = weight_parts[0].dtype
        if with_skew:
            if accum is not None:
                # device views: hb/hc from the resident accumulators,
                # hw/rh from the parameter mirrors (pre-flip at scoring
                # time, exactly like the host stacks they replace)
                rows = np.array([ind_index[n] for n in dous])
                hb, hc = accum.rows_slice(rows, s0, M)
                hwj, rhj = self._param_cache[1]
                rk = ("param_rows", s0, Mh, hwj.shape)
                if rk not in self._scan_cache:
                    import jax

                    @jax.jit
                    def take_rows(hwj, rhj, rows):
                        return (hwj[rows, s0:s0 + Mh],
                                rhj[rows, s0:s0 + Mh])
                    self._scan_cache[rk] = take_rows
                import jax.numpy as jnp
                hw, rh = self._scan_cache[rk](hwj, rhj,
                                              jnp.asarray(rows))
            else:
                hw = np.stack([ped.by_id(n).haploweight[s0:s0 + Mh]
                               for n in dous])
                rh = np.stack([ped.by_id(n).relhaplo[s0:s0 + Mh]
                               for n in dous])
                if skew_rows is not None:
                    hb, hc = skew_rows
                else:
                    rows = np.array([ind_index[n] for n in dous])
                    hb = haplobase[rows][:, s0:s0 + M]
                    hc = haplocount[rows][:, s0:s0 + M]
        else:
            hw = rh = hb = hc = np.zeros((B, Mh))
        varlists, pat, allowed, comp_struct, comp_of_fam = \
            self._flip_static(dous, chrom)
        desc = np.array([ped.by_id(n).descendants for n in dous],
                        dtype=np.float64)
        focal_bit = 1 << (self.cfg.turnbits - 1)
        tsel = (np.arange(self.cfg.numturns) & focal_bit) > 0
        k = min(self.max_flip_markers, M)

        with self.tracer.span("score"):
            idx, mg, gains, S_top = self._jitted_flip_scorer()(
                tuple(weight_parts), jnp.asarray(pat), jnp.asarray(allowed),
                jnp.asarray(hw.astype(dt)), jnp.asarray(rh.astype(dt)),
                jnp.asarray(hb.astype(dt)), jnp.asarray(hc.astype(dt)),
                jnp.asarray(desc.astype(dt)), jnp.asarray(tsel),
                k=k, with_skew=with_skew, halo=halo,
                compress=dt == np.float32)
            import jax
            if jax.process_count() > 1:
                idx = np.asarray(idx) + marker_offset
                mg = np.asarray(mg)
                gains = _host_value(gains).astype(np.float64)  # [B, k]
                S_top = _host_value(S_top).astype(np.float64)  # [B, k, P]
            else:
                # one batched transfer (parallel async copies)
                idx, mg, gains, S_top = jax.device_get(
                    (idx, mg, gains, S_top))
                idx = idx + marker_offset
                gains = gains.astype(np.float64)
                S_top = S_top.astype(np.float64)
        return idx, mg, gains, S_top

    def _chromosome_blocked(self, c, lo, hi, dous, haplobase, haplocount,
                            infacc, ind_index, lut, early,
                            coh_num=None, coh_den=None
                            ) -> Optional[FlipCandidate]:
        """One chromosome in marker-blocked (checkpointed) mode:
        O(marker_block) device memory at any chromosome length, plus
        O(M/block) boundary carries per batch chunk
        (ops/scan_v2.blocked_carries / blocked_block_pass).

        Composes with batch chunking (blocks outer, chunks inner — so
        the deferred relskew-halo scoring of a block sees every chunk's
        accumulator contributions, exactly like the unblocked path),
        and runs adjacent-phase coherence and map re-estimation per
        block with the cross-boundary interval stitched from the
        previous block's last forward column (the same one-block
        pattern as the relskew halo)."""
        import dataclasses

        import jax
        import jax.numpy as jnp

        from .hmm.transition import rate_matrix
        from .ops import scan_v2 as v2
        from .parallel.mesh import pad_markers
        ped, cfg = self.ped, self.cfg
        if self.parent_swap and not early:
            raise NotImplementedError(
                "parent-pair swap moves are unblocked-only")
        # negshift/parity under blocking: both passes consume the whole
        # chromosome's turn weights at once (the reference's WCNF stage
        # is per-chromosome, cnF2freq.cpp:5978-6084), so the per-block
        # device tensors are staged to HOST memory (RAM, not HBM — the
        # memory bound blocking exists for) and concatenated after the
        # loop
        negshift = (self.flip_mode == "negshift" or self.parity) \
            and not early
        block = self.marker_block
        Mc = hi - lo
        Mp = -(-Mc // block) * block
        nblk = Mp // block
        dists = np.pad(np.diff(ped.markerposes[lo:hi]).astype(self.dtype),
                       (0, Mp - Mc))
        rm = np.pad(rate_matrix(cfg, self.params, Mc - 1, ped.actrec,
                                lo, dtype=self.dtype),
                    ((0, Mp - Mc), (0, 0)))
        NI = haplobase.shape[0]
        key = ("blocked", self.dtype, NI, block)
        if key not in self._scan_cache:
            dt = jnp.float32 if np.dtype(self.dtype) == np.float32 \
                else jnp.float64
            self._scan_cache[key] = v2.make_blocked_pieces(
                cfg, self.params, dt, NI, probe_rules=self.parity,
                n_variants=self._n_variants())
        pieces = self._scan_cache[key]
        with_coh = (self.adaptive_relhaplo and cfg.relskews and
                    coh_num is not None)
        S, NS = cfg.numtypes, cfg.numshifts
        lutj = jnp.asarray(lut)

        # batch chunks: block tensors plus the per-chunk boundary
        # carries (~2*(S*NS+NS)*nblk floats per unit) must fit
        m_eff = block + (2 * (S * NS + NS) * nblk) // (6 * 512) + 1
        bs = self._chunk_size(len(dous), m_eff)
        chunk_list = [dous[j:j + bs] for j in range(0, len(dous), bs)]

        states = []
        lam_pad = None
        with self.tracer.span("carries"):
            for chunk in chunk_list:
                fbatch = gather_family(ped, chunk, lo, hi - 1,
                                       dtype=self.dtype,
                                       mask_mode=self.mask_mode,
                                       parity=self.parity,
                                       n_variants=self._n_variants())
                if Mp > Mc:
                    fbatch = pad_markers(fbatch, Mp)
                _, total_r, lam_pad, fbound, bbound = v2.blocked_carries(
                    fbatch, dists, rm, cfg, block, pieces)
                states.append(dict(chunk=chunk, fb=fbatch,
                                   total_r=total_r, fbound=fbound,
                                   bbound=bbound, prev=None))

        rows = np.array([ind_index[n] for n in dous])
        remap_acc = (np.zeros((2, Mc - 1)), np.zeros(2, dtype=np.int64)) \
            if self.remap_distances else None
        coh_cols = [np.full((len(st["chunk"]), Mc, cfg.numslots), 0.5)
                    for st in states] if with_coh else None
        neg_parts = [[] for _ in range(nblk)]
        scored = []
        pending = None   # (offset, wparts): blocks score one step
        # deferred so the NEXT block's merged accumulators (all chunks)
        # supply the right-halo column for the exact cross-boundary
        # relskew term

        def score_block(off, wparts):
            span = min(block, Mc - off)
            if span <= 0:
                return
            halo = off + span < Mc
            ext = span + (1 if halo else 0)
            scored.append(self._score_turns(
                dous, lo, hi, tuple(w[:, :span] for w in wparts),
                None, None, ind_index, c, marker_offset=off, m_span=span,
                halo=halo,
                skew_rows=(haplobase[rows][:, lo + off:lo + off + ext],
                           haplocount[rows][:, lo + off:lo + off + ext])))

        def to_std(x, B, K):
            return jnp.transpose(x[:, :, :B], (2, 0, 1)).reshape(
                B, K, NS, S)

        def to_std_f(x, B):
            return jnp.transpose(x[:, :, :B], (2, 0, 1))

        for i in range(nblk):
            off = i * block
            span = min(block, Mc - off)
            wparts = []
            if span <= 0:
                continue          # wholly padded trailing block
            for ci, st in enumerate(states):
                chunk = st["chunk"]
                B = len(chunk)
                with self.tracer.span("block"):
                    fb_blk, _, fb2, pair_i, hb_i, hc_i, inf_i, w = \
                        v2.blocked_block_pass(
                            st["fb"], i, block, lam_pad, st["fbound"][i],
                            st["bbound"][i], st["total_r"], lutj, cfg,
                            pieces, with_turn=not early)
                sl = slice(lo + off, lo + off + span)
                with self.tracer.span("scatter"):
                    self._store_pair_tables(
                        chunk, lo + off, np.asarray(pair_i)[:, :span])
                    haplobase[:, sl] += np.asarray(hb_i)[:, :span]
                    haplocount[:, sl] += np.asarray(hc_i)[:, :span]
                    infacc[:, sl] += np.asarray(inf_i)[:, :span]
                if not early:
                    if negshift:
                        neg_parts[i].append(np.asarray(w)[:, :span])
                    else:
                        wparts.append(w)
                if with_coh or self.remap_distances:
                    fw_pre = to_std(fb2.fw_pre, B, block)
                    bw = to_std(fb2.bw, B, block)
                    fw_pre_f = to_std_f(fb2.fw_pre_f, B)
                    bw_f = to_std_f(fb2.bw_f, B)
                    d_blk = jnp.asarray(dists[off:off + block - 1])
                    rm_blk = jnp.asarray(rm[off:off + block - 1])
                    self._blocked_followups(
                        st, fb_blk, fw_pre, bw, fw_pre_f, bw_f, d_blk,
                        rm_blk, i, off, span, block, Mc, dists, rm,
                        coh_cols[ci] if with_coh else None, remap_acc,
                        lam_pad)
                    # keep this block's last forward column for the
                    # next block's boundary stitch
                    st["prev"] = (fw_pre[:, -1], fw_pre_f[:, -1])
            if not early and wparts:
                if pending is not None:
                    score_block(*pending)
                pending = (off, wparts)
        if pending is not None and not early:
            score_block(*pending)

        if with_coh:
            from .updates.scatter import scatter_coherence
            for st, coh in zip(states, coh_cols):
                fbatch = st["fb"]
                B = len(st["chunk"])
                scatter_coherence(fbatch.slot_ind[:B],
                                  fbatch.descendants[:B].astype(
                                      np.float64),
                                  lo, coh, coh_num, coh_den, ind_index)
        if self.remap_distances:
            self._apply_recomb(lo, hi, remap_acc)
        if negshift:
            weights = np.concatenate(
                [np.concatenate(p, axis=0) for p in neg_parts if p],
                axis=1)
            if self.parity:
                # reference-exact DOTOULBAR pipeline over the staged
                # whole-chromosome weights (updates/refflips.py)
                from .updates.refflips import reference_flips
                return reference_flips(ped, cfg, dous, lo, hi,
                                       weights.astype(np.float64),
                                       haplobase, haplocount, ind_index)
            from .updates.negshift import negshift_flips
            desc = np.array([max(ped.by_id(n).descendants, 1)
                             for n in dous], dtype=float)
            return negshift_flips(ped, dous, lo, hi,
                                  weights / desc[:, None, None], cfg)
        if early or not scored:
            return None
        # merge per-block top-k hot markers; keep the global top
        idx = np.concatenate([s[0] for s in scored])
        mg = np.concatenate([s[1] for s in scored])
        gains = np.concatenate([s[2] for s in scored], axis=1)
        S_top = np.concatenate([s[3] for s in scored], axis=1)
        order = np.argsort(mg)[::-1][:self.max_flip_markers]
        merged = (idx[order], mg[order], gains[:, order], S_top[:, order])
        with self.tracer.span("flips"):
            return self._solve_scored(dous, lo, hi, merged, c)

    def _blocked_followups(self, st, fb_blk, fw_pre, bw, fw_pre_f, bw_f,
                           d_blk, rm_blk, i, off, span, block, Mc, dists,
                           rm, coh, remap_acc, lam_pad):
        """Per-(chunk, block) coherence + recombination expectations:
        intra-block intervals from the block's own sweep tensors, the
        cross-boundary interval (off-1, off) stitched from the previous
        block's last forward column against this block's first backward
        column."""
        import dataclasses

        import jax.numpy as jnp

        from .ops import scan_v2 as v2
        cfg = self.cfg
        B = fw_pre.shape[0]
        chunk = st["chunk"]
        with_coh = coh is not None

        def run_coh(fbx, d, fp, bwx, fpf, bwf, rmx, K):
            _, coh_fn = self._jitted_scan()
            cols = [np.asarray(coh_fn(fbx, d, fp, bwx, fpf, bwf, slot,
                                      ratemat=rmx))
                    for slot in range(cfg.numslots)]
            return np.stack(cols, axis=-1)[:, :K]   # drop 0.5 pad col

        def run_recomb(fbx, d, fp, bwx, fpf, bwf, rmx):
            from .engine import make_jitted_recomb
            key = ("recomb", self.dtype)
            if key not in self._scan_cache:
                self._scan_cache[key] = make_jitted_recomb(cfg,
                                                           self.params)
            return np.asarray(self._scan_cache[key](
                fbx, d, fp, bwx, fpf, bwf, ratemat=rmx))

        # intra-block intervals: (off + j, off + j + 1), j < span - 1
        fbx = fb_blk
        n_real = max(span - 1, 0)
        if n_real > 0:
            if with_coh:
                cblk = run_coh(fbx, d_blk, fw_pre, bw, fw_pre_f, bw_f,
                               rm_blk, block - 1)
                coh[:, off:off + n_real] = cblk[:, :n_real]
            if self.remap_distances:
                p = run_recomb(fbx, d_blk, fw_pre, bw, fw_pre_f, bw_f,
                               rm_blk)[:, :n_real]
                sexes = np.asarray(cfg.typesexes)
                sums, counts = remap_acc
                for sex in range(2):
                    sel = sexes == sex
                    sums[sex][off:off + n_real] += \
                        p[:, :, sel].sum(axis=(0, 2))

        # boundary interval (off - 1, off) from the previous block's
        # last forward column
        if i > 0 and st["prev"] is not None and off - 1 < Mc - 1:
            pfp, pff = st["prev"]
            zero = jnp.zeros_like(pfp)
            fp2 = jnp.stack([pfp, zero], axis=1)
            bw2 = jnp.stack([jnp.ones_like(pfp), bw[:, 0]], axis=1)
            fpf2 = jnp.stack([pff, jnp.zeros_like(pff)], axis=1)
            bwf2 = jnp.stack([jnp.zeros_like(pff), bw_f[:, 0]], axis=1)
            mb = slice(i * block - 1, i * block + 1)
            relh2 = st["fb"].relh
            if relh2 is not None:
                relh2 = relh2[:, mb]
            fb2cols = dataclasses.replace(
                st["fb"], md=st["fb"].md[:, :, mb],
                ms=st["fb"].ms[:, :, mb], hw=st["fb"].hw[:, :, mb],
                relh=relh2).map(jnp.asarray)
            d2 = jnp.asarray(dists[i * block - 1:i * block])
            rm2 = jnp.asarray(rm[i * block - 1:i * block])
            if with_coh:
                cbnd = run_coh(fb2cols, d2, fp2, bw2, fpf2, bwf2, rm2, 1)
                coh[:, off - 1] = cbnd[:, 0]
            if self.remap_distances:
                p = run_recomb(fb2cols, d2, fp2, bw2, fpf2, bwf2,
                               rm2)[:, 0]
                sexes = np.asarray(cfg.typesexes)
                sums, counts = remap_acc
                for sex in range(2):
                    sel = sexes == sex
                    sums[sex][off - 1] += p[:, sel].sum()
        # per-interval divisor: every unit contributes once per real
        # interval and sex-matched bit; fold into counts once per chunk
        # at the first block
        if i == 0 and self.remap_distances:
            sexes = np.asarray(cfg.typesexes)
            sums, counts = remap_acc
            for sex in range(2):
                counts[sex] += B * int((sexes == sex).sum())

    def _chromosome_blocked_family(self, c, lo, hi, dous, haplobase,
                                   haplocount, infacc, ind_index, lut,
                                   early) -> Optional[FlipCandidate]:
        """Marker-blocked mode for the ng2 and extended (SELFING /
        RELSKEWSTATES) model families (blocked_families.py): O(block)
        device memory at any chromosome length — the fillortake property
        under every model config (cnF2freq.cpp:1675-1776).

        Blocks iterate OUTER, chunks inner, with the same one-block
        scoring deferral as the standard blocked path so the relskew
        halo column sees every chunk's accumulator contributions.
        Adaptive-relhaplo coherence and map re-estimation stay
        whole-chromosome features here (the standard space supports
        both under blocking)."""
        import jax.numpy as jnp

        from .blocked_families import (blocked_family_chunk,
                                       make_blocked_family_pieces)
        from .hmm.transition import rate_matrix
        from .parallel.mesh import pad_markers
        ped, cfg = self.ped, self.cfg
        if self.flip_mode == "negshift" and not early:
            raise NotImplementedError(
                "negshift x blocked runs on the standard space only")
        if self.parent_swap and not early:
            raise NotImplementedError(
                "parent-pair swap moves are unblocked-only")
        if self.remap_distances:
            raise NotImplementedError(
                "map re-estimation under blocked scans is "
                "standard-space only")
        need_coh = self.adaptive_relhaplo and (cfg.relskews or
                                               cfg.relskewstates)
        if need_coh and not getattr(self, "_warned_blocked_coh", False):
            import sys
            print("# blocked mode (ng2/ext): adaptive-relhaplo "
                  "coherence is a whole-chromosome feature; relhaplo "
                  "keeps its current values", file=sys.stderr)
            self._warned_blocked_coh = True

        block = self.marker_block
        Mc = hi - lo
        Mp = -(-Mc // block) * block
        nblk = Mp // block
        dists = np.pad(np.diff(
            ped.markerposes[lo:hi]).astype(self.dtype), (0, Mp - Mc))
        rm = np.pad(rate_matrix(cfg, self.params, Mc - 1, ped.actrec,
                                lo, dtype=self.dtype),
                    ((0, Mp - Mc), (0, 0)))
        NI = haplobase.shape[0]
        dt = np.dtype(self.dtype)
        key = ("blocked_fam", self.dtype, NI, block)
        if key not in self._scan_cache:
            self._scan_cache[key] = make_blocked_family_pieces(
                cfg, self.params, dt, NI,
                n_variants=self._n_variants())
        pieces = self._scan_cache[key]
        lutj = jnp.asarray(lut)
        bs = self._chunk_size(len(dous), 2 * block)
        chunk_list = [dous[j:j + bs]
                      for j in range(0, len(dous), bs)]
        rows = np.array([ind_index[n] for n in dous])

        fbs = []
        for chunk in chunk_list:
            fbatch = gather_family(ped, chunk, lo, hi - 1,
                                   dtype=self.dtype,
                                   mask_mode=self.mask_mode,
                                   parity=self.parity,
                                   n_variants=self._n_variants())
            if Mp > Mc:
                fbatch = pad_markers(fbatch, Mp)
            fbs.append(fbatch)
        gens = [blocked_family_chunk(fb, dists, rm, cfg, self.params,
                                     block, lutj, pieces,
                                     with_turn=not early)
                for fb in fbs]

        scored = []
        pending = None

        def score_block(off, wparts):
            span = min(block, Mc - off)
            if span <= 0:
                return
            halo = off + span < Mc
            ext = span + (1 if halo else 0)
            scored.append(self._score_turns(
                dous, lo, hi, tuple(w[:, :span] for w in wparts),
                None, None, ind_index, c, marker_offset=off,
                m_span=span, halo=halo,
                skew_rows=(haplobase[rows][:, lo + off:lo + off + ext],
                           haplocount[rows][:, lo + off:lo + off + ext])))

        for i in range(nblk):
            off = i * block
            span = min(block, Mc - off)
            outs = [next(g) for g in gens]
            if span <= 0:
                continue
            wparts = []
            for chunk, (bi, pair_i, hb_i, hc_i, inf_i, w) in \
                    zip(chunk_list, outs):
                sl = slice(lo + off, lo + off + span)
                with self.tracer.span("scatter"):
                    self._store_pair_tables(
                        chunk, lo + off, np.asarray(pair_i)[:, :span])
                    haplobase[:, sl] += np.asarray(
                        hb_i, dtype=np.float64)[:, :span]
                    haplocount[:, sl] += np.asarray(
                        hc_i, dtype=np.float64)[:, :span]
                    infacc[:, sl] += np.asarray(
                        inf_i, dtype=np.float64)[:, :span]
                if not early:
                    wparts.append(w)
            if not early and wparts:
                if pending is not None:
                    score_block(*pending)
                pending = (off, wparts)
        if pending is not None and not early:
            score_block(*pending)
        if early or not scored:
            return None
        idx = np.concatenate([s[0] for s in scored])
        mg = np.concatenate([s[1] for s in scored])
        gains = np.concatenate([s[2] for s in scored], axis=1)
        S_top = np.concatenate([s[3] for s in scored], axis=1)
        order = np.argsort(mg)[::-1][:self.max_flip_markers]
        merged = (idx[order], mg[order], gains[:, order],
                  S_top[:, order])
        with self.tracer.span("flips"):
            return self._solve_scored(dous, lo, hi, merged, c)

    def _solve_scored(self, dous, lo, hi, scored, chrom
                      ) -> Optional[FlipCandidate]:
        """Joint flip solve over the scored hot markers (idx may span
        multiple blocks; entries are chromosome-local indices)."""
        ped = self.ped
        idx, mg, gains, S_top = scored
        varlists, pat, allowed, comp_struct, comp_of_fam = \
            self._flip_static(dous, chrom)
        from .native import load_flipsolve
        from .updates.phaseflip import solve_component
        lib = load_flipsolve()
        plen = [1 << len(vl) for vl in varlists]

        cands: List[FlipCandidate] = []
        with self.tracer.span("solve"):
            for j in range(len(idx)):
                if mg[j] <= 1e-12:
                    continue
                m = int(idx[j])
                hot_comps = sorted(set(
                    comp_of_fam[np.where(gains[:, j] > 1e-12)[0]]))
                assign = {}
                fams_m = []
                for ci in hot_comps:
                    comp, vidx, pos, n = comp_struct[ci]
                    fam_masks = [(pos[jj], S_top[fi, j, :plen[fi]])
                                 for jj, fi in enumerate(comp)]
                    vec = solve_component(fam_masks, n, lib=lib)
                    for v, i in vidx.items():
                        if vec[i]:
                            assign[v] = True
                    fams_m.extend((varlists[fi], S_top[fi, j, :plen[fi]])
                                  for fi in comp)
                if not assign:
                    continue
                cands.extend(extract_candidates(fams_m, assign, lo + m))
        # a flip of an all-0.5 tail is the identity on every parameter:
        # applying it would only trip the inversion freeze (scalefactor=0,
        # cnF2freq.cpp:6341-6342) without changing state — drop such flips
        with self.tracer.span("filter"):
            for c_ in cands:
                c_.flips = [
                    (n, m) for n, m in c_.flips
                    if np.abs(ped.by_id(n).haploweight[m + 1:hi] - 0.5).max(
                        initial=0.0) > 1e-9]
            cands = [c_ for c_ in cands if c_.flips]
        return select_winner(cands)

    # -- parameter updates ----------------------------------------------
    def _process_infprobs(self, ids, infacc, scalefactor) -> int:
        """processinfprobs over all individuals (cnF2freq.cpp:4179-4323,
        call site 6344-6368)."""
        import jax.numpy as jnp
        ped = self.ped
        NI, M = infacc.shape[:2]
        with self.tracer.span("stack"):
            md = np.stack([ped.by_id(n).markerdata for n in ids])
            msu = np.stack([ped.by_id(n).markersure for n in ids])
            prior = np.stack([ped.by_id(n).priormarkerdata
                              if ped.by_id(n).has_prior else
                              np.zeros((M, 2), dtype=np.int32)
                              for n in ids])
            priorsure = np.stack([ped.by_id(n).priormarkersure
                                  if ped.by_id(n).has_prior else
                                  np.zeros((M, 2)) for n in ids])
            has_prior = np.array([ped.by_id(n).has_prior for n in ids])
            children = np.array([ped.by_id(n).children for n in ids])

        _, ui = self._jitted_updates()
        with self.tracer.span("device"):
            newp = np.empty_like(infacc)
            hits_total = 0
            rows = min(self._update_rows(M, lanes=4), NI)
            sfj = jnp.asarray(float(scalefactor))
            for b0 in range(0, NI, rows):
                sl = slice(b0, min(b0 + rows, NI))

                def pad(x):
                    n = sl.stop - sl.start
                    if n == rows:
                        return jnp.asarray(x[sl])
                    return jnp.asarray(np.pad(
                        x[sl], [(0, rows - n)] + [(0, 0)] * (x.ndim - 1)))

                res = ui(pad(infacc), pad(md), pad(msu), pad(prior),
                         pad(priorsure), pad(has_prior), pad(children),
                         sfj)
                n = sl.stop - sl.start
                newp[sl] = np.asarray(res.newprob)[:n]
                hits_total += int(res.hits)
        live = infacc > 0
        for i, n in enumerate(ids):
            ind = ped.by_id(n)
            if ind.empty or not ind.has_prior:
                continue
            for side in range(2):
                probs = newp[i, :, side, :]
                lv = live[i, :, side, :]
                anym = lv.any(axis=-1)
                if not anym.any():
                    continue
                # best candidate (cnF2freq.cpp:4298-4306).  The
                # reference's side-1 epsilon (bestprob - 1e-30) is
                # absorbed by f64 rounding at any realistic bestprob, so
                # computing it literally reproduces the reference's
                # effective first-key (allele-1) tie-breaking
                pick = np.where(lv, probs, -np.inf)
                eps = 1e-30 if side == 1 else 0.0
                best = np.where(pick[:, 1] > pick[:, 0] - eps, 1, 0)
                bestp = pick[np.arange(M), best]
                take = anym & np.isfinite(bestp)
                ind.markerdata[take, side] = best[take] + 1
                ind.markersure[take, side] = 1.0 - bestp[take]
        return hits_total

    def _update_haploweights(self, ids, haplobase, haplocount,
                             scalefactor) -> int:
        import jax.numpy as jnp
        ped = self.ped
        NI, M = haplobase.shape
        hw = np.stack([ped.by_id(n).haploweight for n in ids])
        md = np.stack([ped.by_id(n).markerdata for n in ids])
        msu = np.stack([ped.by_id(n).markersure for n in ids])
        desc = np.array([ped.by_id(n).descendants for n in ids])
        children = np.array([ped.by_id(n).children for n in ids])
        lastinv = np.zeros((NI, M), dtype=bool)
        for c in range(ped.num_chromosomes):
            lo, hi = ped.chromosome_range(c)
            lastinv[:, lo:hi] = np.array(
                [ped.by_id(n).lastinved[c] != -1 for n in ids])[:, None]
        if self.cfg.relskews:
            rh = np.stack([ped.by_id(n).relhaplo for n in ids])
            relterm = np.zeros_like(hw)
            for c in range(ped.num_chromosomes):
                lo, hi = ped.chromosome_range(c)
                relterm[:, lo:hi] = np.asarray(
                    self._jitted_relskew()(jnp.asarray(hw[:, lo:hi]),
                                           jnp.asarray(rh[:, lo:hi])))
        else:
            relterm = np.full_like(hw, 0.5)

        active = (hw > 0) & (hw < 1)
        anyinfo = np.zeros_like(active)
        for c in range(ped.num_chromosomes):
            lo, hi = ped.chromosome_range(c)
            anyinfo[:, lo:hi] = (haplocount[:, lo:hi] > 0).any(
                axis=1, keepdims=True)
        active &= anyinfo

        uh, _ = self._jitted_updates()
        newhw = np.empty_like(hw)
        hits_total = 0
        rows = min(self._update_rows(M, lanes=1), NI)
        sfj = jnp.asarray(float(scalefactor))
        for b0 in range(0, NI, rows):
            sl = slice(b0, min(b0 + rows, NI))

            def pad(x):
                n = sl.stop - sl.start
                if n == rows:
                    return jnp.asarray(x[sl])
                return jnp.asarray(np.pad(
                    x[sl], [(0, rows - n)] + [(0, 0)] * (x.ndim - 1)))

            res = uh(pad(hw), pad(haplobase), pad(haplocount), pad(md),
                     pad(msu), pad(relterm), pad(desc), pad(children),
                     pad(lastinv), pad(active), sfj)
            n = sl.stop - sl.start
            newhw[sl] = np.asarray(res.haploweight)[:n]
            hits_total += int(res.hits)
        for i, n in enumerate(ids):
            ped.by_id(n).haploweight[:] = newhw[i]
        return hits_total

    @full_f32
    def line_origin_tables(self) -> Dict[int, np.ndarray]:
        """{focal id: [Mtot, 3]} posterior line-origin class tables (the
        reference's zeropropagate gstr probe as a reporter,
        cnF2freq.cpp:5512) for every analysis individual."""
        import jax.numpy as jnp

        from .engine import make_jitted_line_origin
        from .hmm.transition import rate_matrix
        key = ("line_origin", self.dtype)
        if key not in self._scan_cache:
            self._scan_cache[key] = make_jitted_line_origin(self.cfg,
                                                            self.params)
        fn = self._scan_cache[key]
        ped = self.ped
        dous = list(ped.dous)
        M = ped.num_markers
        tabs = {n: np.zeros((M, 3)) for n in dous}
        for c in range(ped.num_chromosomes):
            lo, hi = ped.chromosome_range(c)
            Mc = hi - lo
            Mp = Mc if not self.marker_bucket else \
                -(-Mc // self.marker_bucket) * self.marker_bucket
            dists = np.pad(np.diff(ped.markerposes[lo:hi]).astype(
                self.dtype), (0, Mp - Mc))
            rm = np.pad(rate_matrix(self.cfg, self.params, Mc - 1,
                                    ped.actrec, lo, dtype=self.dtype),
                        ((0, Mp - Mc), (0, 0)))
            bs = self._chunk_size(len(dous), Mp)
            for b0 in range(0, len(dous), bs):
                chunk = dous[b0:b0 + bs]
                fbatch = gather_family(ped, chunk, lo, hi - 1,
                                       dtype=self.dtype,
                                       mask_mode=self.mask_mode)
                if Mp > Mc:
                    from .parallel.mesh import pad_markers
                    fbatch = pad_markers(fbatch, Mp)
                if len(chunk) < bs:
                    from .parallel.mesh import pad_batch
                    fbatch = pad_batch(fbatch, bs)
                P = np.asarray(fn(fbatch.map(jnp.asarray),
                                  jnp.asarray(dists), jnp.asarray(rm)))
                for i, n in enumerate(chunk):
                    tabs[n][lo:hi] = P[i, :Mc]
        return tabs

    def _adapt_scalefactor(self, any_inv: bool, hitnnn: int, ndous: int):
        """cnF2freq.cpp:6333-6392."""
        st = self.state
        old_sf = st.scalefactor
        badhit = hitnnn > max(st.oldhitnnn, st.oldhitnnn2)
        if badhit:
            st.scalefactor /= 1.1
        goodhit = hitnnn < max(min(st.oldhitnnn, st.oldhitnnn2),
                               ndous // self.cfg.turnbits) * 0.99
        if goodhit:
            st.scalefactor *= 1.21
        st.scalefactor *= 0.997
        if any_inv:
            st.scalefactor = old_sf
        else:
            st.oldhitnnn2 = st.oldhitnnn
            st.oldhitnnn = hitnnn

    # ------------------------------------------------------------------
    def run(self, iterations: int):
        """The reference main loop (cnF2freq.cpp:8127-8195).

        At reference HEAD, ``early = (i < 1); if (!early) doit(...)``
        (cnF2freq.cpp:8131-8132) — iteration 0 runs NO doit at all (the
        first dump is the initial state) and ``early`` is never true
        inside doit.  Parity mode reproduces that: iterations-1 full
        doit calls.  Non-parity keeps the round-1 behavior of a useful
        first pass without phase flips."""
        if self.parity:
            return [None] + [self.iterate(early=False)
                             for _ in range(iterations - 1)]
        return [self.iterate(early=(i == 0)) for i in range(iterations)]


def _dosureval(what, entry):
    """cnF2freq.cpp:3082-3097."""
    count, prob = entry
    if prob == 0:
        return 0.0
    v = math.log(prob) / what * 4.0
    v = math.exp(v)
    return v / (1.0 + v)


def _safe_log(x):
    return math.log(x) if x > 0 else -745.0
