"""Fetch and response building per ``search_many`` request: the
engine's ``batch.fetch`` spans (the wait for the batch's one pinned copy
and its split) and ``batch.respond`` spans (unpacking and
_to_responses_group), a fallback sub-batch's own included, in
milliseconds a request.  The fallback's planning and dispatch are its
``batch.plan`` and ``batch.submit``, which plan_ms and submit_ms read."""


def read(run):
    return run.per_unit_ms({"batch.fetch", "batch.respond"}, "requests")
