"""Dispatch per ``search_many`` request: the engine's ``batch.submit``
spans (search._submit_plans: group, chunk, pack, upload, launch), in
milliseconds a request."""


def read(run):
    return run.per_unit_ms({"batch.submit"}, "requests")
