"""The part of the reference's ``repro.sim`` that serving needs: the
JSON-lines ``MetricsStream`` (``report.py``)."""
