"""``program_trace.py``: ``split``, ``identity`` and ``clock`` on a recorder
and a trace made by hand, with known answers (and nothing with the recorder
off), and a run of the small configuration on the CPU through the harness
with the recorder on."""

import io
import json
import time

import pytest
import torch

from conftest import TINY

from pmarlo_tpu_torch.utils.profiling import Count, Recorder, Span

MS = 1_000_000   # ns


def _recorder():
    """Set-up, then two segments of 10 ms: prepare [0, 2) with its launch at
    [1.5, 1.8), finish [2.2, 10) with to_host [2.2, 9), result [9, 9.5) and
    stamps [9.5, 9.8); the step kernel of segment k runs [1.7, 8) ms after
    its start (launched by the call at [1.6, 1.7)). 6 copies and 1,000
    bytes a segment;
    the stamps: 100 sampled steps of 40 pairs, 20 folds, 30 barriers, 0 bias
    and 10 other cycles."""
    rec = Recorder()
    sp = rec.spans
    sp.append(Span("remd.init", 0, 5_000 * MS))
    sp.append(Span("kernels.load", 0, 100 * MS, parent=0, attrs={"library": "cache"}))
    sp.append(Span("remd.minimize", 200 * MS, 2_200 * MS, parent=0))
    kernels, calls = [], []
    for seg in range(2):
        t = 10_000 * MS + seg * 10 * MS
        r = len(sp)
        sp.append(Span("remd.run_fused", t, t + 10 * MS, segment=seg))
        sp.append(Span("remd.prepare", t, t + 2 * MS, parent=r, segment=seg))
        sp.append(Span("remd.launch", t + 15 * MS // 10, t + 18 * MS // 10, parent=r + 1,
                       segment=seg))
        f = len(sp)
        sp.append(Span("remd.finish", t + 22 * MS // 10, t + 10 * MS, parent=r, segment=seg))
        sp.append(Span("remd.to_host", t + 22 * MS // 10, t + 9 * MS, parent=f, segment=seg))
        sp.append(Span("remd.result", t + 9 * MS, t + 95 * MS // 10, parent=f, segment=seg))
        sp.append(Span("remd.stamps", t + 95 * MS // 10, t + 98 * MS // 10, parent=f,
                       segment=seg))
        for _ in range(6):
            rec.counts.append(Count("remd.host_syncs", 1, seg, f + 1))
        rec.counts.append(Count("remd.host_bytes", 1000, seg, f + 1))
        for name, v in (("pairs", 40), ("folds", 20), ("barriers", 30), ("bias", 0),
                        ("other", 10)):
            rec.counts.append(Count(f"md_step.cycles.{name}", torch.tensor(100 * v), seg, f + 3))
        rec.counts.append(Count("md_step.sampled_steps", 100, seg, f + 3))
        kernels.append((t + 17 * MS // 10, t + 8 * MS))
        calls.append((t + 16 * MS // 10, t + 17 * MS // 10))
    rec._segments = 2
    return rec, kernels, calls


def _trace(kernels, calls, md_kernel_s):
    return {"kernels": kernels, "calls": calls, "md_kernel_s": md_kernel_s}


WINDOW = (10_000 * MS - 1 * MS, 10_020 * MS + 1 * MS)     # 22 ms


def test_split_reads_nothing_with_the_recorder_off():
    from portbench.program_trace import split

    assert split(Recorder()) == {}
    assert split(Recorder(), (0, 10), _trace([(1, 2)], [None], 0.5), 10) == {}


def test_split_known_answers():
    from portbench.program_trace import READINGS, split

    rec, kernels, calls = _recorder()
    kernel_s = 2 * 6.3e-3
    out = split(rec, WINDOW, _trace(kernels, calls, kernel_s), 1000)
    assert set(out) == set(READINGS)
    assert out["setup_minimize_s"] == pytest.approx(2.0)
    assert out["runner_host_syncs.segment"] == 6
    # prepare [0, 2) less the kernel from 1.7; finish [2.2, 10) less the kernel to 8
    assert out["runner_prepare_ms.segment"] == pytest.approx(1.7)
    assert out["runner_finish_ms.segment"] == pytest.approx(2.0)
    step_us = kernel_s / 1000 * 1e6
    assert out["md_step_us.pairs"] == pytest.approx(0.4 * step_us)
    assert out["md_step_us.folds"] == pytest.approx(0.2 * step_us)
    assert out["md_step_us.barriers"] == pytest.approx(0.3 * step_us)
    assert out["md_step_us.bias"] == 0.0
    assert out["md_step_us.other"] == pytest.approx(0.1 * step_us)


def test_identity_adds_the_runner_and_the_rest_of_the_window():
    """The two 1 ms edges of the window lie outside every span, and the
    kernels, ``remd.prepare`` and ``remd.finish`` cover the segments' spans,
    so the identity holds. Kernels of 0.2 ms leave [2, 2.2) of each segment,
    between prepare and finish, unaccounted for: a gap of that much."""
    from portbench.program_trace import identity

    rec, kernels, calls = _recorder()
    ident = identity(rec, WINDOW, 22e-3, _trace(kernels, calls, 2 * 6.3e-3))
    assert ident["segments"] == 2
    assert ident["outside_spans_ms.segment"] == pytest.approx(1.0)
    assert ident["spans_ms.segment"] == pytest.approx(1.7 + 2.0 + 1.0)
    assert ident["window_less_kernels_ms.segment"] == pytest.approx(4.7)
    assert ident["gap"] == pytest.approx(0.0, abs=1e-12)
    short = [(a, a + MS // 5) for a, _ in kernels]
    off = identity(rec, WINDOW, 22e-3, _trace(short, calls, 2 * 0.2e-3))
    assert off["spans_ms.segment"] == pytest.approx(1.8 + 7.8 + 1.0)
    assert off["window_less_kernels_ms.segment"] == pytest.approx(10.8)
    assert off["gap"] == pytest.approx(-0.2 / 10.8)


def test_kernels_are_placed_by_the_hosts_calls():
    """A kernel the trace's device clock puts 3 ms early, before its own
    launch call, is placed from the call's end for its duration, and the
    runner's split is the same as with a true device clock; the clock check
    counts it as the trace's own stray."""
    from portbench.program_trace import clock, place_kernels, split

    rec, kernels, calls = _recorder()
    assert place_kernels(kernels, calls) == kernels
    early = [(a - 3 * MS, b - 3 * MS) for a, b in kernels]
    out = split(rec, WINDOW, _trace(early, calls, 2 * 6.3e-3), 1000)
    assert out["runner_prepare_ms.segment"] == pytest.approx(1.7)
    assert out["runner_finish_ms.segment"] == pytest.approx(2.0)
    assert clock(rec, WINDOW, _trace(kernels, calls, 0.0)) == {
        "kernels": 2, "calls_held_by_a_launch_span": 2, "kernels_before_their_span": 0,
        "of_which_before_their_own_call": 0, "kernel_start_less_call_start_us": [100.0, 100.0]}
    ck = clock(rec, WINDOW, _trace(early, calls, 0.0))
    assert ck["kernels_before_their_span"] == ck["of_which_before_their_own_call"] == 2
    assert ck["kernel_start_less_call_start_us"] == pytest.approx([-2900.0, -2900.0])


def test_split_keeps_to_the_window():
    from portbench.program_trace import identity, split

    rec, kernels, calls = _recorder()
    window = (10_010 * MS, 10_020 * MS)       # the second segment alone
    trace = _trace(kernels, calls, 6.3e-3)
    out = split(rec, window, trace, 500)
    assert out["runner_prepare_ms.segment"] == pytest.approx(1.7)
    ident = identity(rec, window, 10e-3, trace)
    assert ident["segments"] == 1
    assert ident["gap"] == pytest.approx(0.0, abs=1e-12)


def test_a_cpu_run_through_the_harness_with_the_recorder_on(checkout):
    from portbench import program_trace

    err = io.StringIO()
    rc, line, program, checks = program_trace.run(TINY + ".fused", 2147483711, 0.1, False,
                                                  time.perf_counter(), device="cpu", err=err)
    assert rc == 0, err.getvalue()[-2000:]
    assert json.loads(line)["correct"] is True
    assert program["setup_minimize_s"] > 0.0
    assert program["runner_host_syncs.segment"] == 0      # nothing crossed from a device
    assert "runner_prepare_ms.segment" not in program     # no device trace
    assert checks == {}
    rc, line, program, checks = program_trace.run(TINY + ".fused", 2147483711, 0.1, False,
                                                  time.perf_counter(), recorder=False,
                                                  device="cpu", err=io.StringIO())
    assert rc == 0 and program == {} and checks == {}
