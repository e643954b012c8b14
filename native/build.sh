#!/bin/sh
# Build the native ingest library for a portable x86-64 target.
# Without libdeflate and libzstd to link against, the library is built
# without its gzip/BGZF/zstd inflate; those paths then fall back to zlib.
# Concurrent builds are safe: each links a private file, then renames it.
set -e
cd "$(dirname "$0")"
CXX="g++ -O3 -march=x86-64-v2 -fPIC -shared -pthread"
tmp=".libexon_native.$$.so"
err=".build.$$.err"
trap 'rm -f "$tmp" "$err"' EXIT
if ! $CXX -o "$tmp" fasta_scan.cpp decomp.cpp tsv_scan.cpp \
        arrow_consume.cpp -ldeflate -lzstd 2>"$err"; then
    echo "libdeflate/libzstd not linkable; building without native inflate:" >&2
    cat "$err" >&2
    $CXX -o "$tmp" fasta_scan.cpp tsv_scan.cpp arrow_consume.cpp
fi
mv -f "$tmp" libexon_native.so
echo "built $(pwd)/libexon_native.so"
