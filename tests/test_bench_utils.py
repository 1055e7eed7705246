"""Bench harness plumbing + utils tests (CPU-safe parts only; device
timing itself needs the card and is exercised by bench.py)."""
import numpy as np

from shared_simd_scan_tpu.bench import harness
from shared_simd_scan_tpu.bench.cli import _parse_size
from shared_simd_scan_tpu.utils import debug, profiling


def test_synth_corpora_match_reference_formulas():
    n = 1000
    ramp = np.asarray(harness.synth_ramp(n, 9))
    np.testing.assert_array_equal(ramp, np.arange(n) & 0x1FF)
    mod5 = np.asarray(harness.synth_mod5(n))
    np.testing.assert_array_equal(mod5, np.arange(n) % 5)
    modk = np.asarray(harness.synth_modk(n, 8, 9))
    np.testing.assert_array_equal(modk, np.arange(n) % 8 % 512)


def test_values_for_inverts_packed_size():
    from shared_simd_scan_tpu.layout import packed_nbytes

    n = harness.values_for(500 * 1024 * 1024, 9)
    assert abs(packed_nbytes(9, n) - 500 * 1024 * 1024) < 16


def test_result_line_format_parsable():
    import re

    from shared_simd_scan_tpu.bench.timing import Measurement

    res = harness.BenchResult(
        "shared scan k=8", Measurement(0.00123, [0.0012, 0.0013]), 10**9
    )
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        harness.print_result(res, roofline=harness.hbm_peak_bytes_per_s(
            "NVIDIA H100 80GB HBM3"))
    out = buf.getvalue().splitlines()
    m = re.match(r"^\* (.+?): ([\d.]+) ms; \[([^\]]*)\] ms$", out[0])
    assert m and m.group(1) == "shared scan k=8"
    assert "GB/s" in out[1] and "3350 GB/s peak" in out[1]


def test_hbm_peak_unknown_device_kind_raises():
    # no peak is assumed: a device missing from the table is an error
    import pytest

    assert harness.hbm_peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    with pytest.raises(KeyError, match="no published memory bandwidth"):
        harness.hbm_peak_bytes_per_s("cpu")


def test_measure_times_each_call():
    from shared_simd_scan_tpu.bench.timing import measure

    calls = []

    def fn(x):
        calls.append(x)
        return x

    m = measure(fn, 3, reps=4)
    assert len(calls) == 5  # warm-up + 4 timed calls
    assert len(m.samples) == 4 and m.seconds >= 0


def test_cli_parse_size():
    assert _parse_size("512m") == 512 * 1024 * 1024
    assert _parse_size("4k") == 4096
    assert _parse_size("1g") == 1 << 30
    assert _parse_size("12345") == 12345


def test_dump_byte_lsb_first():
    assert debug.dump_byte(5) == "10100000"
    assert debug.dump_byte(0x80) == "00000001"


def test_dump_memory_bytes():
    out = debug.dump_memory(bytes([5, 5]))
    assert "10100000 10100000" in out


def test_profile_sample_registry():
    profiling.reset_samples()
    with profiling.ProfileSample("unit"):
        pass
    with profiling.ProfileSample("unit"):
        pass
    s = profiling.get_sample("unit")
    assert s.count == 2 and s.total_ns > 0


def test_clock_ns_delta():
    profiling.clock_ns()
    assert profiling.clock_ns() >= 0
