"""bench.py's corridor-certificate fallback (fresh-process re-exec)."""

import os
import sys

import pytest


@pytest.fixture()
def bench_module(monkeypatch):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench

    # Record execv instead of exec'ing.
    calls = []
    monkeypatch.setattr(os, "execv", lambda exe, argv: calls.append((exe, argv)))
    return bench, calls


def test_cert_failure_default_falls_back_to_fast(bench_module, monkeypatch):
    """A tripped corridor certificate on the DEFAULT config must re-exec
    with BENCH_PIPELINE=fast (a slower exact capture beats a voided one)
    rather than report nothing."""
    bench, calls = bench_module
    # setenv first so that teardown restores the variable's absence even
    # though _corridor_fallback writes os.environ directly.
    monkeypatch.setenv("BENCH_PIPELINE", "unset")
    monkeypatch.delenv("BENCH_PIPELINE")
    bench._corridor_fallback(3)
    assert len(calls) == 1
    assert os.environ["BENCH_PIPELINE"] == "fast"


def test_cert_failure_explicit_corridor_asserts(bench_module, monkeypatch):
    """An EXPLICIT BENCH_PIPELINE=corridor run keeps the hard assert so
    the certificate stays testable."""
    bench, calls = bench_module
    monkeypatch.setenv("BENCH_PIPELINE", "corridor")
    with pytest.raises(AssertionError, match="corridor certificate"):
        bench._corridor_fallback(2)
    assert not calls
