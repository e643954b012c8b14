"""Find repeat units within CRISPR arrays via a GFF self-join.

Port of the reference example (exon-examples/examples/
gff_annotation_join.rs:36-94): CREATE EXTERNAL TABLE over a GFF, self-join
CRISPR arrays with contained repeat_units, ordered LIMIT 10. The
reference's data file is not shipped, so a structurally-identical CRISPR
GFF is synthesized next to this script on first run.

Run: python examples/gff_annotation_join.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from exon_tpu import ExonSession  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data", "crispr_arrays.gff")


def make_data() -> str:
    if os.path.exists(DATA):
        return DATA
    os.makedirs(os.path.dirname(DATA), exist_ok=True)
    lines = []
    # two contigs, each with a CRISPR array + its repeat units (the shape of
    # Ga0604745_crt.gff in the reference example)
    for c, (lo, hi) in (("Ga0604745_000026", (1, 3473)),
                        ("Ga0604745_000031", (5, 2041))):
        lines.append(f"{c}\tcrt\tCRISPR\t{lo}\t{hi}\t.\t.\t.\tID={c}_arr")
        start = lo
        i = 0
        while start + 36 <= hi:
            lines.append(f"{c}\tcrt\trepeat_unit\t{start}\t{start + 36}"
                         f"\t.\t.\t.\tParent={c}_arr;ID=ru{i}")
            start += 72
            i += 1
    with open(DATA, "w") as f:
        f.write("\n".join(lines) + "\n")
    return DATA


def main() -> None:
    ctx = ExonSession.new_exon()
    path = make_data()
    ctx.sql(f"CREATE EXTERNAL TABLE gff STORED AS GFF LOCATION '{path}'")

    df = ctx.sql("""
        SELECT crispr.seqname, crispr.start, crispr."end",
               repeat.start, repeat."end"
        FROM (SELECT * FROM gff WHERE type = 'CRISPR') AS crispr
            JOIN (SELECT * FROM gff WHERE type = 'repeat_unit') AS repeat
                ON crispr.seqname = repeat.seqname
                AND crispr.start <= repeat.start
                AND crispr."end" >= repeat."end"
        ORDER BY crispr.seqname, crispr.start, crispr."end",
                 repeat.start, repeat."end"
        LIMIT 10""")

    print(df.explain())
    print(df.to_pandas().to_string(index=False))


if __name__ == "__main__":
    main()
