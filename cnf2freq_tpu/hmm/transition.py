"""Transition model: recombination over (Z_2)^typebits.

The reference builds, per marker interval, a per-xor-mask weight table and
applies a dense S x S update ``probs2[to] += probs[from] * R[from ^ to]``
(cnF2freq.cpp:2276-2364).  An xor-kernel convolution diagonalises under the
Walsh-Hadamard transform, so we apply it as two S x S matmuls with a
*shared* Hadamard matrix (no per-interval matrices) around a per-interval
elementwise scale:

    p' = H ( (H p) * what ) / S,   what[idx] = prod_t (1 - 2 r_t)^bit_t(idx)

which is exact (the kernel's WHT has the closed form above because each bit
contributes an independent stay/switch factor).
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from ..config import ModelConfig, RuntimeParams


@lru_cache(maxsize=8)
def hadamard(nbits: int, dtype_name: str = "float64") -> np.ndarray:
    h = np.array([[1.0]], dtype=np.dtype(dtype_name))
    one = np.array([[1, 1], [1, -1]], dtype=np.dtype(dtype_name))
    for _ in range(nbits):
        h = np.kron(h, one)
    return h


def interval_recomb(cfg: ModelConfig, params: RuntimeParams,
                    dists, rates=None, ratemat=None) -> jnp.ndarray:
    """Per-interval, per-meiosis-bit recombination probabilities
    r[interval, typebits] = 0.5 (1 - exp(rate * dist))
    (cnF2freq.cpp:2286).

    ratemat: optional per-interval per-bit rate matrix
    [intervals, typebits] (see ``rate_matrix``) — the jit-friendly form
    that carries re-estimated genetic-map rates into the scan.
    rates: optional per-sex per-interval map rates [2, intervals] (the
    actrec / PERMARKERACTREC mechanism, cnF2freq.cpp:771-790); default is
    the global per-generation base rate."""
    dists = jnp.asarray(dists)
    if ratemat is not None:
        rate = jnp.asarray(ratemat) * dists[:, None]
    elif rates is None:
        genrec = jnp.asarray([params.genrec[g] for g in cfg.typegens],
                             dtype=dists.dtype)
        rate = genrec[None, :] * dists[:, None]
    else:
        rates = jnp.asarray(rates)
        sexes = np.asarray(cfg.typesexes)
        rate = rates[sexes, :].T * dists[:, None]
    return 0.5 * (1.0 - jnp.exp(rate))


def rate_matrix(cfg: ModelConfig, params: RuntimeParams, n_intervals: int,
                actrec=None, lo: int = 0, dtype=np.float64) -> np.ndarray:
    """Host-side per-interval per-bit rate matrix [n, typebits].

    Default: the per-generation base rates (genrec, cnF2freq.cpp:295)
    broadcast over intervals.  With ``actrec`` (re-estimated per-sex
    per-marker rates, driver.remap_distances): actrec[sex, lo+1+i] for
    interval i — the getactrec convention (cnF2freq.cpp:771-790), rates
    stored at the interval's right marker."""
    if actrec is None:
        genrec = np.asarray([params.genrec[g] for g in cfg.typegens],
                            dtype=dtype)
        return np.broadcast_to(genrec[None, :],
                               (n_intervals, len(cfg.typegens))).copy()
    sexes = np.asarray(cfg.typesexes)
    return np.asarray(actrec, dtype=dtype)[sexes,
                                           lo + 1:lo + 1 + n_intervals].T


def transition_eigenvalues(cfg: ModelConfig, r: jnp.ndarray) -> jnp.ndarray:
    """WHT eigenvalues what[interval, S] of the xor transition kernel."""
    S = cfg.numtypes
    idx = np.arange(S)
    bits = ((idx[:, None] >> np.arange(cfg.typebits)[None, :]) & 1)  # [S, T]
    lam = jnp.prod(jnp.where(bits[None, :, :] == 1,
                             1.0 - 2.0 * r[:, None, :], 1.0), axis=-1)
    return lam  # [intervals, S]


def apply_transition(probs: jnp.ndarray, what: jnp.ndarray) -> jnp.ndarray:
    """probs [..., S] (state minor, so the two Hadamard contractions are
    plain [rows, S] @ [S, S] matmuls) convolved with the kernel whose WHT
    is what [..., S] (broadcast over leading axes)."""
    S = probs.shape[-1]
    H = jnp.asarray(hadamard(int(S).bit_length() - 1,
                             str(probs.dtype)))
    ph = probs @ H
    ph = ph * what
    return (ph @ H) / S


def apply_transition_sn(probs: jnp.ndarray, what: jnp.ndarray) -> jnp.ndarray:
    """Legacy layout shim: probs [..., S, NS] with a trailing shift axis
    (model-family sweeps that keep state second-minor);
    what [..., S] broadcast over the shift axis."""
    S = probs.shape[-2]
    H = jnp.asarray(hadamard(int(S).bit_length() - 1,
                             str(probs.dtype)))
    ph = jnp.einsum("gh,...hs->...gs", H, probs)
    ph = ph * what[..., :, None]
    return jnp.einsum("gh,...hs->...gs", H, ph) / S


def transition_matrix(cfg: ModelConfig, r_row: jnp.ndarray) -> jnp.ndarray:
    """Dense S x S matrix for one interval (reference-layout check path)."""
    S = cfg.numtypes
    idx = np.arange(S)
    xor = idx[:, None] ^ idx[None, :]
    bits = ((xor[..., None] >> np.arange(cfg.typebits)) & 1)
    return jnp.prod(jnp.where(bits == 1, r_row, 1.0 - r_row), axis=-1)
