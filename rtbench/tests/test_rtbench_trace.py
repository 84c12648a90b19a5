"""The reduction of a profiler trace: busy time as the union of the device
operations, the idle share, idle gaps named by the host's span, and time by
kernel, on a synthetic trace."""

import pytest

from rtbench.lib import trace


def test_busy_idle_and_gaps_on_a_synthetic_trace():
    ops = [("k_a", 0.0, 1.0), ("k_b", 0.5, 2.0), ("fwd_tiled_kernel", 3.0, 4.0),
           ("k_a", 6.0, 7.0), ("k_a", 9.5, 12.0)]
    spans = [("rtbench.window", 0.0, 10.0), ("rtbench.frame.issue", 1.5, 5.0),
             ("rtbench.frame.fence", 5.5, 8.0)]
    red = trace.reduce(ops, spans, (0.0, 10.0), units=2)
    assert red["busy_s"] == pytest.approx(2.0 + 1.0 + 1.0 + 0.5)
    assert red["window_s"] == 10.0 and red["n_ops"] == 5
    assert 100.0 * (1.0 - red["busy_s"] / red["window_s"]) == pytest.approx(55.0)
    # gaps: (2, 3) in issue, (4, 6) mid 5.0 -> issue (shorter than window),
    # (7, 9.5) mid 8.25 -> window
    assert red["idle_by_span"] == pytest.approx({"frame.issue": 3.0, "window": 2.5})
    assert red["by_name"]["k_a"] == pytest.approx(1.0 + 1.0 + 0.5)
    assert trace.kernel(red, "fwd_tiled_kernel") == (1.0, 1)
    assert trace.kernel(red, "fwd_tiled") == (0.0, 0)
    bd = trace.breakdown(red, top=2)
    assert bd["device_ops"][0][0] == "k_a" and len(bd["device_ops"]) == 2
    assert bd["idle_gaps"][0] == ["frame.issue", 3.0]


def test_kernel_names_match_whole_identifiers():
    red = trace.reduce([("void (anonymous namespace)::soft_fwd_kernel<false, 1>(Args)", 0, 1),
                        ("void soft_fwd_kernel_x()", 1, 2),
                        ("_Z15soft_bwd_kernelILb0ELi1EEv", 2, 4)], [], (0, 4), 1)
    assert trace.kernel(red, "soft_fwd_kernel") == (1, 1)
    assert trace.kernel(red, "soft_bwd_kernel") == (2, 1)


def test_host_span_outside_every_span_is_harness():
    assert trace.host_span([("rtbench.a", 0, 1)], 2.0) == "harness"
