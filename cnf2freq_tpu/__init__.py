"""cnf2freq_tpu: a pedigree-HMM framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
cnettel/cnF2freq (PlantImpute): genotype/haplotype probability computation
and imputation in experimental-cross pedigrees via a hidden Markov model
over inheritance states of a three-generation analysis unit.
"""

from .config import (F2_HAPLO, F2_NOHAPLO, ModelConfig, RuntimeParams,
                     SEXMARKER, UNKNOWN)
from .pedigree import Individual, Pedigree

__version__ = "0.1.0"


def _enable_compilation_cache():
    """Persistent jax compilation cache, on by default: the scan programs
    take tens of seconds to compile, and the cache reuses them across
    processes.  JAX_COMPILATION_CACHE_DIR (or a cache directory already
    set in jax's config) wins; otherwise the cache lives at the fixed
    path .jax_cache/ at the root of the checkout.  Opt out with
    CNF2FREQ_NO_COMPILE_CACHE=1."""
    import os
    if os.environ.get("CNF2FREQ_NO_COMPILE_CACHE"):
        return
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax
    if jax.config.jax_compilation_cache_dir:
        return
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)


_enable_compilation_cache()

__all__ = [
    "F2_HAPLO", "F2_NOHAPLO", "ModelConfig", "RuntimeParams",
    "SEXMARKER", "UNKNOWN", "Individual", "Pedigree",
]
