"""exon-tpu CLI: SQL REPL / batch runner.

Parity with exon-cli (exon-cli/src/main.rs:78-146): ``-c`` command list,
``-f`` file list, ``--format`` (table/csv/json), ``--maxrows``, ``--quiet``;
interactive REPL otherwise. ``EXON_LOG`` controls engine logging.

Usage: python -m exon_tpu.cli [-c "SELECT 1;"] [-f script.sql] ...
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time


def _print_result(df, fmt: str, maxrows: int, quiet: bool, elapsed: float) -> None:
    table = df.collect_arrow()
    if fmt == "csv":
        import io

        import pyarrow.csv as pacsv

        buf = io.BytesIO()
        pacsv.write_csv(table, buf)
        sys.stdout.write(buf.getvalue().decode())
    elif fmt == "json":
        import json

        for row in table.to_pylist():
            sys.stdout.write(json.dumps(row, default=str) + "\n")
    else:
        pdf = table.to_pandas()
        if maxrows >= 0 and len(pdf) > maxrows:
            shown = pdf.head(maxrows)
            sys.stdout.write(shown.to_string(index=False) + "\n")
            sys.stdout.write(f"... {len(pdf) - maxrows} more rows\n")
        else:
            sys.stdout.write(pdf.to_string(index=False) + "\n")
    if not quiet:
        sys.stdout.write(f"{table.num_rows} rows in set. "
                         f"Query took {elapsed:.3f} seconds.\n")


def run_statement(session, sql: str, args) -> None:
    t0 = time.perf_counter()
    try:
        df = session.sql(sql)
        if df is None:
            return
        _print_result(df, args.format, args.maxrows, args.quiet,
                      time.perf_counter() - t0)
    except Exception as e:  # surface engine errors like datafusion-cli
        sys.stdout.write(f"Error: {e}\n")
        if args.debug:
            raise


def repl(session, args) -> None:
    try:
        import readline  # noqa: F401 (history/editing)
    except ImportError:
        pass
    sys.stdout.write("exon-tpu SQL REPL — type SQL terminated by ';', "
                     "\\q to quit\n")
    buf = ""
    while True:
        try:
            prompt = "exon> " if not buf else "   -> "
            line = input(prompt)
        except (EOFError, KeyboardInterrupt):
            sys.stdout.write("\n")
            return
        if line.strip() in ("\\q", "quit", "exit"):
            return
        buf += line + "\n"
        if line.rstrip().endswith(";"):
            run_statement(session, buf, args)
            buf = ""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="exon-tpu",
                                description="SQL for bio data on JAX")
    p.add_argument("-c", "--command", action="append", default=[],
                   help="run the given SQL command (repeatable)")
    p.add_argument("-f", "--file", action="append", default=[],
                   help="run SQL from file (repeatable)")
    p.add_argument("--format", default="table",
                   choices=["table", "csv", "json"])
    p.add_argument("--maxrows", type=int, default=40)
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("-d", "--debug", action="store_true")
    args = p.parse_args(argv)

    level = os.environ.get("EXON_LOG", "").upper()
    if level:
        logging.basicConfig(level=getattr(logging, level, logging.INFO))

    from .session import ExonSession

    session = ExonSession.new_exon()

    ran = False
    for f in args.file:
        with open(f) as fh:
            content = fh.read()
        for stmt in _split_statements(content):
            run_statement(session, stmt, args)
        ran = True
    for c in args.command:
        run_statement(session, c, args)
        ran = True
    if not ran:
        repl(session, args)
    return 0


def _split_statements(text: str) -> list[str]:
    out, buf, in_str = [], [], False
    for ch in text:
        if ch == "'":
            in_str = not in_str
        if ch == ";" and not in_str:
            stmt = "".join(buf).strip()
            if stmt:
                out.append(stmt + ";")
            buf = []
        else:
            buf.append(ch)
    tail = "".join(buf).strip()
    if tail:
        out.append(tail)
    return out


if __name__ == "__main__":
    sys.exit(main())
