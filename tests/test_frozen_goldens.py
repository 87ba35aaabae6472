"""Frozen v=1..3 real-data goldens (BASELINE.md plan; VERDICT r1 item 5).

tests/goldens/cn32_zmo_ngnc_v{1,2,3}.tsv were generated ONCE by the numpy
oracle backend on the bundled SnapGene contigs (experiments/freeze_goldens.py)
and committed. run_targets must reproduce each byte-for-byte on the jax and
pallas backends — a regression on any mismatch-budget path fails a golden,
not just a fuzz seed. The subset library (all spacers with >=1
plasmid hit at v<=3 plus 50 non-targeting) is committed alongside.
"""

import os

import pytest

from barcoder_tpu.core.genome import Genome
from barcoder_tpu.pipeline.targets import run_targets
from barcoder_tpu.seqio.library import BarcodeLibrary

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture(scope="module")
def genome():
    return Genome.from_snapgene("/root/reference/GCA_003054575.1")


@pytest.fixture(scope="module")
def subset_lib():
    with open(os.path.join(GOLDENS, "cn32_subset_spacers.txt")) as f:
        spacers = [line.strip() for line in f if line.strip()]
    assert len(spacers) > 700
    return BarcodeLibrary.from_list(spacers)


def _golden(v: int) -> str:
    with open(os.path.join(GOLDENS, f"cn32_zmo_ngnc_v{v}.tsv")) as f:
        return f.read()


@pytest.mark.parametrize("v", [1, 2, 3])
def test_jax_backend_reproduces_golden(genome, subset_lib, v):
    res = run_targets(subset_lib, genome, "NGNC", v, backend="jax")
    assert res.table.to_csv(sep="\t", index=False) == _golden(v)


@pytest.mark.parametrize("v", [1, 3])
@pytest.mark.slow
def test_pallas_interpret_reproduces_golden(genome, subset_lib, v):
    res = run_targets(subset_lib, genome, "NGNC", v, backend="pallas")
    assert res.table.to_csv(sep="\t", index=False) == _golden(v)
