"""Session configuration (reference: exon-core/src/config/mod.rs:24-78).

``SessionConfig`` carries the engine knobs; the ``exon.``-prefixed flags are
settable at runtime through ``SET exon.<flag> = <bool>`` in SQL, mirroring
ExonConfigExtension (config/mod.rs:65-78,130-137).
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class SessionConfig:
    batch_size: int = 8192                     # DEFAULT_BATCH_SIZE (output granularity)
    # rows per *device* batch on the scan path: large batches amortize
    # host→device transfer + dispatch latency (the device analog of the
    # reference's 8192-row Arrow batches; results are identical either way)
    device_batch_size: int = 1 << 17
    target_partitions: int = 0                 # 0 → device/host-parallel default
    catalog: str = "public"
    schema: str = "exon"

    # exon.* extension flags (config/mod.rs:65-78)
    vcf_parse_info: bool = False
    vcf_parse_formats: bool = False
    sam_parse_tags: bool = False
    bam_parse_tags: bool = False
    cram_parse_tags: bool = False

    # distributed execution over a jax.sharding.Mesh (the device analog
    # of the reference's repartitioned operators, config/mod.rs:31,40-43):
    # when enabled, aggregates over scan pipelines execute data-parallel on
    # the mesh's 'shard' axis with an all_to_all partial exchange.
    distributed: bool = False
    n_shards: int = 0                          # 0 → all visible devices
    # joins: partition BOTH sides by key hash over the mesh (all_to_all)
    # instead of broadcasting the build side — for large⋈large joins
    partitioned_join: bool = False

    def __post_init__(self):
        if self.target_partitions <= 0:
            self.target_partitions = os.cpu_count() or 1
        if os.environ.get("EXON_TPU_DISTRIBUTED"):
            self.distributed = True

    _EXON_FLAGS = ("vcf_parse_info", "vcf_parse_formats", "sam_parse_tags",
                   "bam_parse_tags", "cram_parse_tags", "distributed",
                   "partitioned_join")

    def set_option(self, key: str, value: str) -> None:
        if key.startswith("exon."):
            flag = key[len("exon."):]
            if flag not in self._EXON_FLAGS:
                raise KeyError(f"unknown exon option {key}")
            setattr(self, flag, str(value).lower() in ("true", "1", "yes"))
        elif key in ("batch_size", "target_partitions", "n_shards"):
            setattr(self, key, int(value))
        else:
            raise KeyError(f"unknown option {key}")


def new_exon_config(**kwargs) -> SessionConfig:
    return SessionConfig(**kwargs)
