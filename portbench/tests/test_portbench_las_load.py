"""las_load_ms on synthetic windows: the whole LAS read a tile, whether the
program decodes natively (las.load over a short las.read and the las.xyz
decode), reads the records (las.load over a long las.xyz), or has no
las.load (las.read and las.xyz)."""

import pytest

from portbench import progspans
from portbench.metrics import las_load_ms
from portbench.tests.test_portbench_progspans import _span, _window

NATIVE = [_span(2, "las.read", 1, 1, 100.0, 100.001, 0.001),
          _span(3, "las.xyz", 1, 1, 100.001, 100.1, 0.099),
          _span(1, "las.load", None, 1, 100.0, 100.1, 0.1)]
FALLBACK = [_span(2, "las.read", 1, 1, 100.05, 100.051, 0.001),
            _span(3, "las.xyz", 1, 1, 100.051, 100.55, 0.499),
            _span(1, "las.load", None, 1, 100.0, 100.6, 0.6)]
PARENT = [_span(1, "las.read", None, 1, 100.0, 100.3, 0.3),
          _span(2, "las.xyz", None, 1, 100.3, 100.5, 0.2)]


@pytest.mark.parametrize("buffer,ms", [(NATIVE, 50.0), (FALLBACK, 300.0), (PARENT, 250.0),
                                       ([_span(1, "stream", None, 1, 100.0, 100.5, 0.5)], None)],
                         ids=["native", "fallback", "parent", "no-read"])
def test_las_load_ms_reads_the_whole_read_a_tile(monkeypatch, buffer, ms):
    monkeypatch.setattr(progspans, "program_buffer", lambda: list(buffer))
    got = las_load_ms.read(_window())  # two tiles
    assert got == pytest.approx(ms) if ms is not None else got is None
