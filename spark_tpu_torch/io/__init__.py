"""File datasources: the reader and writer surface (``readwriter.py``)
over a pyarrow.dataset scan with projection and predicate pushdown
(``datasource.py``), whose batches land on the session's device."""
