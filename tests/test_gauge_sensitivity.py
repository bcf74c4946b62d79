"""Prove the bench accuracy gauge can FAIL (a gauge row that has never
been shown able to fail proves nothing).  A one-part-
in-10^4 perturbation of a CELT constant must flip the CELT row's ok flag;
reverting the constant must restore it.  Runs the gauge exactly as
bench.py does (same fixtures, same bounds)."""

import numpy as np
import pytest

import bench
from audio_formats_tpu.utils.tables import celt_tables as CT

from golden import opus_oracle

needs_oracle = pytest.mark.skipif(opus_oracle.get_lib() is None,
                                  reason="libopus oracle unavailable")


@needs_oracle
def test_celt_gauge_detects_table_perturbation(monkeypatch):
    clean = bench._opus_mode_gauge(only=("celt",))
    row = clean["opus_celt_rel_vs_libopus"]
    assert isinstance(row, dict), row
    assert row["ok"], row

    # MDCT window off by 1e-4 relative — far below audibility, far above
    # the gauge's 1e-5 bound (perturbs the overlap-add region of every
    # synthesized frame)
    monkeypatch.setattr(CT, "WINDOW", CT.WINDOW * (1.0 + 1e-4))
    bad = bench._opus_mode_gauge(only=("celt",))
    brow = bad["opus_celt_rel_vs_libopus"]
    assert isinstance(brow, dict), brow
    assert not brow["ok"], ("gauge failed to detect a perturbed CELT "
                            f"constant: {brow}")
    assert brow["value"] > row["value"]

    # monkeypatch reverts on exit; re-check to guard against sticky state
    monkeypatch.undo()
    again = bench._opus_mode_gauge(only=("celt",))
    assert again["opus_celt_rel_vs_libopus"]["ok"]
