"""Test harness: force CPU with 8 virtual devices so multi-device sharding
paths compile and execute without an accelerator (the reference's
LocalStack analog for 'distributed without a cluster')."""

import os

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest

REFERENCE_TEST_DATA = "/root/reference/exon/exon-core/test-data/datasources"


def reference_path(*parts: str) -> str:
    p = os.path.join(REFERENCE_TEST_DATA, *parts)
    if not os.path.exists(p):
        pytest.skip(f"reference fixture not available: {p}")
    return p


@pytest.fixture
def ref_data():
    return reference_path


@pytest.fixture
def session():
    from exon_tpu import ExonSession

    return ExonSession.new_exon()


@pytest.fixture
def tmp_fasta(tmp_path):
    """Small synthetic FASTA file."""
    content = (
        ">seq1 first sequence\n"
        "MKVL\nAC\n"
        ">seq2\n"
        "ACGTACGT\n"
        ">seq3 third one\n"
        "MMMM\n"
    )
    p = tmp_path / "test.fasta"
    p.write_text(content)
    return str(p)
