"""Distributed execution over a device mesh.

Shows the engine's distributed axis (absent in the reference — SURVEY
§2e): the same SQL runs single-device and data-parallel over a
`jax.sharding.Mesh` (`SET exon.distributed = true`), with identical
results. The mesh spans every device JAX finds (all GPUs of the host);
with --cpu-mesh it runs on 8 virtual CPU devices instead, so the example
works on a machine without an accelerator.

Covered: sharded GROUP BY (the all_to_all group-state exchange),
PARTITION BY window over the mesh, a partitioned (both-sides-sharded)
join, and TopK.

Run: python examples/distributed_mesh.py [--cpu-mesh]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np


def make_fasta(path: str, n: int = 20_000) -> None:
    rng = np.random.default_rng(11)
    with open(path, "w") as f:
        for i in range(n):
            seq = "".join(rng.choice(list("ACGT"), size=60))
            f.write(f">read{i:06d} sample{i % 7}\n{seq}\n")


def main() -> None:
    from exon_tpu import ExonSession
    from exon_tpu.config import new_exon_config

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    os.makedirs(d, exist_ok=True)
    fa = os.path.join(d, "mesh_demo.fasta")
    if not os.path.exists(fa):
        make_fasta(fa)

    single = ExonSession.new_exon()
    dist = ExonSession.with_config_exon(new_exon_config(distributed=True))
    for ctx in (single, dist):
        ctx.sql(f"CREATE EXTERNAL TABLE reads STORED AS FASTA "
                f"LOCATION '{fa}'")

    queries = [
        ("sharded GROUP BY",
         "SELECT description, COUNT(*) AS n, "
         "AVG(LENGTH(sequence)) AS mean_len "
         "FROM reads GROUP BY description ORDER BY description"),
        ("windows over the mesh",
         "SELECT id, ROW_NUMBER() OVER "
         "(PARTITION BY description ORDER BY id) AS rn "
         "FROM reads ORDER BY id LIMIT 5"),
        ("distributed TopK",
         "SELECT id, description FROM reads "
         "ORDER BY description, id LIMIT 5"),
    ]
    for name, q in queries:
        a = single.sql(q).to_pandas()
        b = dist.sql(q).to_pandas()
        assert a.equals(b), f"{name}: distributed != single-device"
        print(f"-- {name} (parity OK, {len(jax.devices())} devices)")
        print(b.to_string(index=False))

    # partitioned join: both sides hash-partitioned over the mesh
    dist.sql("SET exon.partitioned_join = true")
    q = ("SELECT a.description, COUNT(*) AS pairs FROM reads a "
         "JOIN reads b ON a.id = b.id GROUP BY a.description "
         "ORDER BY a.description")
    a = single.sql(q).to_pandas()
    b = dist.sql(q).to_pandas()
    assert a.equals(b)
    print("-- partitioned join (parity OK)")
    print(b.to_string(index=False))


if __name__ == "__main__":
    if "--cpu-mesh" in sys.argv[1:]:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
    main()
