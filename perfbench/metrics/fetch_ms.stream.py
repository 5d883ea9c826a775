"""Fetch and response building per batch of a pipelined stream: the
engine's ``batch.fetch`` spans (the wait for the batch's one pinned copy
and its split) and ``batch.respond`` spans (unpacking and
_to_responses_group), a fallback sub-batch's own included, in
milliseconds a batch."""


def read(run):
    return run.per_unit_ms({"batch.fetch", "batch.respond"}, "pipelined")
