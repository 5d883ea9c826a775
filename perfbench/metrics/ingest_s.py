"""Seconds of the set-up's bulk adds (HostIndex.add_bulk_arrays: term
registration, per-document sort, journal appends), on the host clock."""


def read(run):
    return run.setup.get("ingest_s") or None
