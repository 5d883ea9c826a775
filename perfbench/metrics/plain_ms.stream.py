"""The candidate and dense dispatch groups per batch of a pipelined
stream: the engine's ``submit.plain`` spans (search._dispatch_plain:
packing, upload and the executor's launches), in milliseconds a batch.
None where the engine has no such span."""


def read(run):
    return run.per_unit_ms({"submit.plain"}, "pipelined")
