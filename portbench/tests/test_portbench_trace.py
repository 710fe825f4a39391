"""The traced window's reduction: busy time as the union of device
intervals inside the span, annotations left out, idle gaps labelled by
the host op running across them."""

import pytest
import torch

from portbench import trace


def test_summarize_unions_device_time_inside_the_span():
    rows = [(trace.SPAN, False, 100.0, 1100.0, False),
            ("k1", True, 50.0, 300.0, False),       # clipped at the span's start
            ("k2", True, 250.0, 400.0, False),      # overlaps k1
            ("k3", True, 900.0, 1200.0, False),     # clipped at its end
            ("note", True, 100.0, 1100.0, True),    # a device annotation
            ("aten::copy_", False, 450.0, 850.0, False)]
    s = trace.summarize(rows)
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx((400 - 100 + 1100 - 900) * 1e-6)
    assert dict(s.device_ops)["k1"] == pytest.approx(200e-6)
    label, seconds = s.idle_gaps[0]
    assert label == "aten::copy_ x1" and seconds == pytest.approx(500e-6)


def test_rows_read_a_profile():
    out, prof = trace.traced(lambda: torch.ones(64).sum())
    names = {r[0] for r in trace._rows(prof)}
    assert trace.SPAN in names and float(out) == 64.0
