"""The plain reference that decides ``correct``.

``av1/`` is an AV1 decoder on NumPy alone. Its inverse transforms
(``av1/ops/itx.py``) are written from the AV1 specification's text (7.13.2,
7.13.3) and use nothing of the program. The rest is a frozen copy of the
port's bundled decoder and of the host modules it reads (constant tables,
entropy reader, prediction, loop filters), with every import rewritten to
the copies and the native library left out (``av1/native.py`` has none), so
it shares no module, build or state with the program under test. The
coefficient contexts read a flat list (``decoder/reader.py``), for speed and
with the port's results.
"""
