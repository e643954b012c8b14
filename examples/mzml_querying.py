"""Query an mzML mass-spec file for spectra containing a peak of interest.

Port of the reference example (exon-examples/examples/mzml_querying.rs):
CREATE EXTERNAL TABLE over mzML, then filter scans with
contains_peak(mz.mz, 100.0, 0.1).

Run: python examples/mzml_querying.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from exon_tpu import ExonSession  # noqa: E402

REFERENCE_MZML = "/root/reference/exon-examples/data/GNPS00002_A3_p.mzML"


def main() -> None:
    ctx = ExonSession.new_exon()
    path = os.environ.get("MZML_PATH", REFERENCE_MZML)
    if not os.path.exists(path):
        raise SystemExit(f"set MZML_PATH to an mzML file (missing: {path})")
    ctx.sql(f"CREATE EXTERNAL TABLE mzml STORED AS MZML LOCATION '{path}'")
    df = ctx.sql("""
        SELECT id
        FROM mzml
        WHERE contains_peak(mz.mz, 100.0, 0.1) = true""")
    print(df.to_pandas().to_string(index=False))


if __name__ == "__main__":
    main()
