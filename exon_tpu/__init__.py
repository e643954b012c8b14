"""exon-tpu: a vectorized JAX query engine for bioinformatics data.

Brand-new engine with the capabilities of wheretrue/exon (SQL access to
FASTA/FASTQ/VCF/BAM/GFF/mzML/… data), redesigned for an accelerator: host
decoders stage fixed-shape device columns; filter / aggregate / sort / join
execute as JAX/XLA programs; multi-device scaling uses jax.sharding meshes
with all_to_all shuffles (see exon_tpu.parallel).
"""

import os as _os

import jax as _jax

# Engine-wide requirement: schemas carry Int64 positions/counts (Arrow
# parity); enable 64-bit types before any jnp use. Hot kernels still use
# int32 internally where it halves the bytes they move.
_jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache, so every query shape compiles once per
# machine, not once per process. JAX itself honours
# JAX_COMPILATION_CACHE_DIR; otherwise the cache sits at one fixed path in
# the checkout, where every later process finds it.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache"))
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from . import tracing  # EXON_LOG-configured logger
from .batch import Batch, Schema, DEFAULT_BATCH_SIZE
from .config import SessionConfig, new_exon_config
from .dataframe import DataFrame
from .errors import ExonError
from .plan.expressions import AggregateCall, col, lit

__version__ = "0.1.0"


def count(child=None):
    return AggregateCall("count", child)


def sum_(child):
    return AggregateCall("sum", child)


def min_(child):
    return AggregateCall("min", child)


def max_(child):
    return AggregateCall("max", child)


def avg(child):
    return AggregateCall("avg", child)


from .session import ExonSession  # noqa: E402  (after helpers to avoid cycles)

__all__ = [
    "ExonSession", "DataFrame", "SessionConfig", "new_exon_config",
    "Batch", "Schema", "col", "lit", "count", "sum_", "min_", "max_", "avg",
    "ExonError", "DEFAULT_BATCH_SIZE",
]
