"""The traced window's arithmetic: busy time as the union of device
operations, idle gaps named by the host stage at their middle."""
import pytest

import benchtiny  # noqa: F401  (puts gpubench on the path)
from harness import readers
from harness.trace import KernelCalls, StageLog, Trace, TraceLost


def test_busy_idle_and_names():
    t = Trace(ops=[("a", 10, 20), ("b", 15, 30), ("c", 50, 60)], start_ns=0, end_ns=100,
              offset_ns=0, stages=[("x", 0, 40), ("y", 41, 70), ("z", 71, 100)])
    assert t.window_s == 1e-7 and t.busy_s == 3e-8
    assert t.idle_gaps() == [["z", 4e-8], ["x", 3e-8]]
    assert t.top_ops() == [["b", 1.5e-8], ["a", 1e-8], ["c", 1e-8]]
    assert t.device_ms(lambda n: n in ("a", "b")) == (2.5e-5, 2)


def test_host_clock_offset_and_unnamed_gaps():
    t = Trace(ops=[("a", 1000, 1010)], start_ns=990, end_ns=1030, offset_ns=1000,
              stages=[("x", 0, 30)])
    # gap 990-1000: host -5, before every stage; gap 1010-1030: host 20, in x
    assert t.idle_gaps() == [["x", 2e-8], ["harness", 1e-8]]


def test_stage_log_off_records_nothing():
    log = StageLog(on=False)
    with log.stage("x"):
        pass
    assert log.entries == []
    log.on = True
    with log.stage("y"):
        pass
    assert [e[0] for e in log.entries] == ["y"]


def _roofline_run(launched):
    calls = KernelCalls()
    calls.calls = [("gemm", 4096, 1280, 1280, 2, False)] * 2
    trace = Trace(ops=[("gemm_wgmma_kernel", 0, 1_000_000), ("gemm_wgmma_kernel", 0, 1_000_000)],
                  start_ns=0, end_ns=2_000_000, offset_ns=0)
    return {"calls": calls, "trace": trace, "launches": {"gemm": launched}}


def test_roofline_reads_the_trace_and_refuses_one_that_lost_kernels():
    share = readers.roofline(_roofline_run(2), "gemm", ("gemm_wgmma_kernel",))
    assert 0 < share < 100
    with pytest.raises(TraceLost):
        readers.roofline(_roofline_run(3), "gemm", ("gemm_wgmma_kernel",))
