"""ExonSession: the engine entry point.

Mirrors the reference ExonSession (exon-core/src/session_context/
exon_context_ext.rs:103-721): table registry, ``read_*`` helpers for every
format, ``sql()`` with the Exon COPY/CREATE EXTERNAL TABLE surface, UDF/UDTF
registries, and object-store registration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .config import SessionConfig, new_exon_config
from .dataframe import DataFrame
from .errors import PlanError
from .io.object_store import ObjectStore, register_store
from .plan import logical as L
from .tables import FileTable, get_format, registered_formats


class ExonSession:
    def __init__(self, config: Optional[SessionConfig] = None):
        # multi-host: bring up jax.distributed first (no-op single-process);
        # in a multi-process runtime, distributed execution is the default
        # so scans shard ingest across hosts
        from .parallel.mesh import init_distributed

        multi = init_distributed()
        self.config = config or new_exon_config()
        if multi and config is None:
            self.config.distributed = True
        self.tables: dict[str, object] = {}
        # ensure UDFs and indexed providers are registered
        from . import udfs  # noqa: F401
        from .ops import sqlfuncs  # noqa: F401
        from .providers import register_indexed_providers

        register_indexed_providers()

    # -- constructors (parity names) ---------------------------------------

    @staticmethod
    def new_exon() -> "ExonSession":
        return ExonSession()

    @staticmethod
    def with_config_exon(config: SessionConfig) -> "ExonSession":
        return ExonSession(config)

    # -- registration -------------------------------------------------------

    def register_object_store(self, url_prefix: str, store: ObjectStore) -> None:
        register_store(url_prefix, store)

    def register_table(self, name: str, provider) -> None:
        self.tables[name.lower()] = provider

    def deregister_table(self, name: str) -> None:
        self.tables.pop(name.lower(), None)

    def table(self, name: str) -> DataFrame:
        provider = self.tables.get(name.lower())
        if provider is None:
            raise PlanError(f"table {name!r} not found")
        return DataFrame(self, L.Scan(provider, name))

    # -- generic read -------------------------------------------------------

    def _read(self, fmt_name: str, url: str, options=None, **kwargs) -> DataFrame:
        spec = get_format(fmt_name)
        if options is None:
            options = spec.default_options()
        if kwargs:
            options = dataclasses.replace(options, **kwargs)
        if hasattr(options, "batch_size"):
            options = dataclasses.replace(
                options, batch_size=self.config.device_batch_size)
        provider = self._make_provider(spec, url, options)
        return DataFrame(self, L.Scan(provider, f"{fmt_name.lower()}:{url}"))

    def _make_provider(self, spec, url: str, options):
        # formats with dedicated providers (indexes, regions) override here
        from .tables import FileTable

        factory = getattr(spec, "provider_factory", None)
        if factory is None:
            factory = _PROVIDER_FACTORIES.get(spec.name.upper())
        if factory is not None:
            return factory(url, options, self.config)
        return FileTable(url, spec, options)

    # -- per-format read_* API (exon_context_ext.rs:591-721) ---------------

    def read_fasta(self, url: str, options=None, **kw) -> DataFrame:
        return self._read("FASTA", url, options, **kw)

    def read_fastq(self, url: str, options=None, **kw) -> DataFrame:
        return self._read("FASTQ", url, options, **kw)

    def read_vcf(self, url: str, options=None, **kw) -> DataFrame:
        return self._read("VCF", url, options, **kw)

    def read_bcf(self, url: str, options=None, **kw) -> DataFrame:
        return self._read("BCF", url, options, **kw)

    def read_sam(self, url: str, options=None, **kw) -> DataFrame:
        return self._read("SAM", url, options, **kw)

    def read_bam(self, url: str, options=None, **kw) -> DataFrame:
        return self._read("BAM", url, options, **kw)

    def read_cram(self, url: str, options=None, **kw) -> DataFrame:
        return self._read("CRAM", url, options, **kw)

    def read_bed(self, url: str, options=None, **kw) -> DataFrame:
        return self._read("BED", url, options, **kw)

    def read_gff(self, url: str, options=None, **kw) -> DataFrame:
        return self._read("GFF", url, options, **kw)

    def read_gtf(self, url: str, options=None, **kw) -> DataFrame:
        return self._read("GTF", url, options, **kw)

    def read_genbank(self, url: str, options=None, **kw) -> DataFrame:
        return self._read("GENBANK", url, options, **kw)

    def read_fcs(self, url: str, options=None, **kw) -> DataFrame:
        return self._read("FCS", url, options, **kw)

    def read_mzml(self, url: str, options=None, **kw) -> DataFrame:
        return self._read("MZML", url, options, **kw)

    def read_sdf(self, url: str, options=None, **kw) -> DataFrame:
        return self._read("SDF", url, options, **kw)

    def read_bigwig_view(self, url: str, options=None, **kw) -> DataFrame:
        return self._read("BIGWIG_VALUE", url, options, **kw)

    def read_bigwig_zoom(self, url: str, options=None, **kw) -> DataFrame:
        return self._read("BIGWIG_ZOOM", url, options, **kw)

    def read_hmm_dom_tab(self, url: str, options=None, **kw) -> DataFrame:
        return self._read("HMMDOMTAB", url, options, **kw)

    def read_parquet(self, url: str) -> DataFrame:
        from .plan import logical as _L
        from .providers import make_parquet_provider

        return DataFrame(self, L.Scan(
            make_parquet_provider(url, None, self.config), f"parquet:{url}"))

    def read_delta(self, url: str) -> DataFrame:
        """Delta Lake table read (exon_context_ext.rs:579-588)."""
        from .providers import make_delta_provider

        return DataFrame(self, L.Scan(
            make_delta_provider(url, None, self.config), f"delta:{url}"))

    def read_inferred_exon_table(self, url: str) -> DataFrame:
        """Infer format + compression from the extension
        (reference: exon_file_type.rs:217-237, ffi/mod.rs:40)."""
        from .io.compression import infer_compression

        stem, _comp = infer_compression(url)
        ext = stem.rsplit(".", 1)[-1].lower() if "." in stem else ""
        fmt = _EXTENSION_FORMATS.get(ext)
        if fmt is None:
            raise PlanError(f"cannot infer exon file type from {url!r}")
        return self._read(fmt, url)

    # -- SQL ----------------------------------------------------------------

    def sql(self, query: str) -> DataFrame:
        from .sql.frontend import execute_sql

        return execute_sql(self, query)


# Per-format provider factories (populated as formats land richer providers)
_PROVIDER_FACTORIES: dict[str, object] = {}


def register_provider_factory(fmt: str, factory) -> None:
    _PROVIDER_FACTORIES[fmt.upper()] = factory


# extension → format name (exon_file_type.rs:25-118)
_EXTENSION_FORMATS = {
    "fasta": "FASTA", "fa": "FASTA", "fna": "FASTA", "faa": "FASTA",
    "fastq": "FASTQ", "fq": "FASTQ",
    "vcf": "VCF", "bcf": "BCF",
    "sam": "SAM", "bam": "BAM", "cram": "CRAM",
    "bed": "BED", "gff": "GFF", "gff3": "GFF", "gtf": "GTF",
    "gb": "GENBANK", "gbk": "GENBANK", "genbank": "GENBANK",
    "fcs": "FCS", "mzml": "MZML", "sdf": "SDF",
    "bw": "BIGWIG_VALUE", "bigwig": "BIGWIG_VALUE",
    "hmmdomtab": "HMMDOMTAB",
}
